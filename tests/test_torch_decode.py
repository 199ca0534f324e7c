"""The port's dense LM decode (``init_cache``, ``decode_step``, the serve
loop) against the JAX package's on the four dense archs'
``reduced()`` configs (float32, 2 layers, d_model 256, B = 2, T = 10
steps), fed JAX's ``init(PRNGKey(1))`` weights through
``convert.lm_params_from_jax``, on the ``ref`` route
(``decode_attention_ref``) and the ``kernel`` route (kernel 7's plain
version on the CPU).

Bounds, float32: logits and caches within ``rtol 1e-5, atol 1e-4`` of
JAX's and of the port's own full-sequence forward.  The arithmetic is the
reference's, but each matrix product and reduction sums in another order
(PyTorch's CPU BLAS against XLA's dot, a blocked online softmax against
one softmax), about 1e-7 relative per operation over 2 layers and a
512-way head, where logits are of order 1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import ARCHS, DENSE_ARCHS, get_config
from repro_torch.kernels import decode_attention as kda
from repro_torch.launch import serve
from repro_torch.models import build_model, lm
from repro_torch.models.config import MoEConfig

TOL = dict(rtol=1e-5, atol=1e-4)
B, T = 2, 10
RESUME = 5  # the port resumes from JAX's cache after this many steps


def _tokens(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_decode(cfg, tokens, cache_len, *, window_override=None,
                use_window=None, keep=()):
    """JAX's params (numpy leaves) and per-step logits ``[B, T, V]`` of
    ``decode_step`` jitted once, with the caches after the steps in
    ``keep`` (numpy trees)."""
    bundle = jax_build_model(cfg, window_override=window_override)
    params = bundle.init(jax.random.PRNGKey(1))
    step = jax.jit(bundle.decode_step)
    cache = bundle.init_cache(tokens.shape[0], cache_len,
                              use_window=use_window)
    logits, kept = [], {}
    for t in range(tokens.shape[1]):
        if t in keep:
            kept[t] = _np_tree(cache)
        lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.int32(t))
        logits.append(np.asarray(lg[:, 0], np.float32))
    kept["final"] = _np_tree(cache)
    return _np_tree(params), np.stack(logits, axis=1), kept


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    cfg = jax_config(arch).reduced()
    tokens = _tokens(cfg, B, T, seed=3)
    return (tokens,) + _jax_decode(cfg, tokens, T + 2, keep=(RESUME,))


def _port_decode(bundle, params, cache, tokens, start=0):
    """The port's per-step logits ``[B, T - start, V]`` (numpy) from
    ``start``, and the cache it updated."""
    out = []
    tt = torch.as_tensor(tokens.astype(np.int64))
    for t in range(start, tokens.shape[1]):
        lg, cache = bundle.decode_step(params, cache, tt[:, t:t + 1], t)
        out.append(lg[:, 0].numpy())
    return np.stack(out, axis=1), cache


def _assert_cache(got, want):
    """The port's cache tree against JAX's numpy tree."""
    assert len(got["prelude"]) == len(want["prelude"])
    for slot, c in want["groups"].items():
        for name in ("k", "v"):
            g = getattr(got["groups"][slot], name).to(torch.float32).numpy()
            np.testing.assert_allclose(g, np.asarray(getattr(c, name),
                                                     np.float32), **TOL)


def _cache_shapes(cache):
    """``{"prelude": [...], "groups": {slot: [(shape, type) of k, v]}}``
    of a JAX or a port cache."""
    def entries(group):
        return {slot: [(tuple(x.shape), str(x.dtype).split(".")[-1])
                       for x in c] for slot, c in group.items()}
    return {"prelude": [entries(g) for g in cache["prelude"]],
            "groups": entries(cache["groups"])}


@pytest.mark.parametrize("use_window", [None, 4, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_cache_matches_jax_tree(arch, dtype, use_window):
    """The same tree of zero caches, shapes and types: a window's ring
    (L = min(window, cache_len)) and the config's own 8,192 window."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jb = jax_build_model(jax_config(arch).reduced(**kw))
    want = jax.eval_shape(lambda: jb.init_cache(2, 12, use_window=use_window))
    got = build_model(get_config(arch).reduced(**kw), device="cpu")\
        .init_cache(2, 12, use_window=use_window)
    assert _cache_shapes(got) == _cache_shapes(want)
    leaf = got["groups"]["slot0"].k
    assert leaf.shape[2] == min(use_window or 8192, 12)
    assert bool((leaf == 0).all())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_step_matches_jax(arch, impl):
    """T = 10 steps from a zero cache: every step's logits and the final
    cache.  The ``kernel`` route runs kernel 7's plain version here and
    never launches."""
    tokens, params, want, kept = _jax_run(arch)
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, attention_impl=impl, device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    before = kda.decode_attention.launches
    got, cache = _port_decode(bundle, tp, bundle.init_cache(B, T + 2), tokens)
    assert kda.decode_attention.launches == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    _assert_cache(cache, kept["final"])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_resumes_from_jax_cache(arch):
    """JAX's cache after 5 steps, carried over by ``lm_cache_from_jax``:
    the port's next 5 steps equal JAX's, and so does the final cache."""
    tokens, params, want, kept = _jax_run(arch)
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg, attention_impl="kernel", device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    cache = convert.lm_cache_from_jax(cfg, kept[RESUME], device="cpu")
    assert cache["groups"]["slot0"].k.dtype == torch.float32
    got, cache = _port_decode(bundle, tp, cache, tokens, start=RESUME)
    np.testing.assert_allclose(got, want[:, RESUME:], **TOL)
    _assert_cache(cache, kept["final"])


@pytest.mark.parametrize("window", ["config", None])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_own_forward(arch, window):
    """Token-by-token decode reproduces the port's teacher-forced forward,
    as ``tests/test_archs.py`` checks the reference: with the config's
    8,192 window (the ring path) and with no window (the write slot is the
    position)."""
    kw = {} if window == "config" else dict(sliding_window=None)
    cfg = get_config(arch).reduced(**kw)
    tokens, params, _, _ = _jax_run(arch)
    bundle = build_model(cfg, attention_impl="kernel", device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    full = lm.lm_forward(tp, cfg, torch.as_tensor(tokens.astype(np.int64)))
    got, _ = _port_decode(bundle, tp, bundle.init_cache(B, T + 2), tokens)
    np.testing.assert_allclose(got, full.logits.numpy(), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_ring():
    cfg = jax_config("internlm2-1.8b").reduced(sliding_window=None)
    tokens = _tokens(cfg, 1, 9, seed=0)
    return (tokens,) + _jax_decode(cfg, tokens, 9, window_override=4,
                                   use_window=4)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_sliding_window_ring_buffer(impl):
    """``window_override=4`` with a ring cache of 4 entries over T = 9
    steps (the ring wraps twice) equals the forward restricted to the
    window, and JAX's ring decode, as ``tests/test_archs.py`` checks the
    reference."""
    tokens, params, want, kept = _jax_ring()
    cfg = get_config("internlm2-1.8b").reduced(sliding_window=None)
    bundle = build_model(cfg, attention_impl=impl, window_override=4,
                         device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    cache = bundle.init_cache(1, 9, use_window=4)
    assert cache["groups"]["slot0"].k.shape[2] == 4
    got, cache = _port_decode(bundle, tp, cache, tokens)
    full = lm.lm_forward(tp, cfg, torch.as_tensor(tokens.astype(np.int64)),
                         window=4)
    np.testing.assert_allclose(got, full.logits.numpy(), **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_cache(cache, kept["final"])


def test_no_window_past_the_cache_clamps_like_jax():
    """Without a window, steps past ``S_cache`` write the last entry, as
    the reference's ``dynamic_update_slice`` clamps its start: 7 steps into
    a cache of 4."""
    jcfg = jax_config("internlm2-1.8b").reduced(sliding_window=None)
    tokens = _tokens(jcfg, 2, 7, seed=6)
    params, want, kept = _jax_decode(jcfg, tokens, 4)
    cfg = get_config("internlm2-1.8b").reduced(sliding_window=None)
    bundle = build_model(cfg, attention_impl="kernel", device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    got, cache = _port_decode(bundle, tp, bundle.init_cache(2, 4), tokens)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_cache(cache, kept["final"])


def test_cache_is_updated_in_place():
    """``decode_step`` writes the new K/V row into the caller's cache and
    returns that cache; on a ring of 3 entries position 3 writes slot 0
    and no other."""
    cfg = get_config("qwen3-8b").reduced()
    bundle = build_model(cfg, attention_impl="kernel", device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    cache = bundle.init_cache(2, 3)
    k = cache["groups"]["slot0"].k
    tok = torch.ones((2, 1), dtype=torch.int64)
    for pos in range(3):
        _, out = bundle.decode_step(params, cache, tok, pos)
        assert out is cache and out["groups"]["slot0"].k is k
    before = k.clone()
    bundle.decode_step(params, cache, tok, 3)
    assert (k != before).any(4).any(3).any(1).any(0).tolist() == [True,
                                                                   False,
                                                                   False]


def test_bfloat16_decode_tracks_float32():
    """qwen3 reduced in bfloat16 (the same weights rounded once) against
    float32, T = 10 steps: bf16 rounds every product and the cache (2^-9
    relative) after sums in another order, so the logits stay within 2e-2
    relative L2."""
    tokens, params, want, _ = _jax_run("qwen3-8b")
    got = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("qwen3-8b").reduced(dtype=dtype, param_dtype=dtype)
        bundle = build_model(cfg, attention_impl="kernel", device="cpu")
        tp = convert.lm_params_from_jax(cfg, params, device="cpu")
        got[dtype], cache = _port_decode(bundle, tp,
                                         bundle.init_cache(B, T + 2), tokens)
        assert cache["groups"]["slot0"].k.dtype == getattr(torch, dtype)
    rel = (np.linalg.norm(got["bfloat16"] - got["float32"])
           / np.linalg.norm(got["float32"]))
    assert rel < 2e-2, rel
    np.testing.assert_allclose(got["float32"], want, **TOL)


def test_serve_loop_teacher_forced_matches_jax():
    """The serve loop (``serve.generate``) on reduced qwen3,
    teacher-forced on JAX's tokens (P = 6 prompt steps, then the 4 fed
    continuation tokens): every step's logits equal JAX's ``decode_step``
    loop; greedy generation picks the argmax of each step."""
    tokens, params, want, _ = _jax_run("qwen3-8b")
    cfg = get_config("qwen3-8b").reduced(vocab=512, n_layers=2)
    bundle = build_model(cfg, attention_impl="kernel", device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    tt = torch.as_tensor(tokens.astype(np.int64))
    P, N = 6, T - 6 + 1
    forced = torch.cat([tt[:, P:], tt[:, :1]], dim=1)  # the last is not fed
    gen = serve.generate(bundle, tp, tt[:, :P], N, forced=forced,
                         keep_logits=True)
    assert torch.equal(gen.tokens, forced)
    np.testing.assert_allclose(gen.step_logits.numpy(), want, **TOL)
    np.testing.assert_allclose(gen.prompt_logits.numpy(), want[:, P - 1],
                               **TOL)
    greedy = serve.generate(bundle, tp, tt[:, :P], N, keep_logits=True)
    assert greedy.tokens.shape == (B, N)
    assert torch.equal(greedy.tokens,
                       greedy.step_logits[:, P - 1:].argmax(-1))


def test_serve_main_tiny_preset(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` at a small size:
    the reference's printed lines, P + N - 1 decode steps."""
    gen = serve.main(["--arch", "qwen3-8b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "5", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[serve] qwen3-8b: batch=2 prompt=5 new=3"
    assert out[1].startswith("  prefill ") and "tok/s" in out[1]
    assert out[2].startswith("  sample continuation: [")
    assert gen.tokens.shape == (2, 3)
    assert bool(torch.isfinite(gen.prompt_logits).all())


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(DENSE_ARCHS)))
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_unported_mixers_raise_in_decode():
    cfg = get_config("qwen3-8b").reduced()
    for bad, match in ((dict(block_pattern=("attn", "mamba"), n_layers=2),
                        "mixers"),
                       (dict(moe=MoEConfig(num_experts=4, top_k=2,
                                           expert_ff=128)), "MoE")):
        other = cfg.reduced(**bad)
        with pytest.raises(NotImplementedError, match=match):
            lm.init_cache(other, 2, 8, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            lm.lm_decode_step({}, other, {}, torch.zeros((2, 1)), 0)
