"""The port's dense LM (``repro_torch.models``) against the JAX package's on
the four dense archs' ``reduced()`` configs (float32, 2 layers, d_model
256, B = 2, S = 16, as ``tests/test_archs.py`` runs them), fed JAX's
``init(PRNGKey(0))`` weights through ``convert.lm_params_from_jax``.

Bounds, float32: the loss within ``rtol 1e-5``; logits and the KV cache
within ``rtol 1e-4, atol 1e-5``.  The arithmetic is the reference's, but
each matrix product and reduction sums in another order (PyTorch's CPU
BLAS against XLA's dot), about 1e-7 relative per operation, over 2 layers
of a dozen products and a 512-way head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import ARCHS, DENSE_ARCHS, get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import build_model
from repro_torch.models.config import MoEConfig

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _jax_run(cfg, batch, impl):
    """JAX's params (numpy leaves), loss, prefill logits and cache k/v
    (``[n_groups, B, S, KV, D]``), from one jitted program."""
    bundle = jax_build_model(cfg, attention_impl=impl)
    params = bundle.init(jax.random.PRNGKey(0))

    def run(p, b):
        loss, _ = bundle.loss_fn(p, b)
        logits, cache = bundle.prefill(p, {"tokens": b["tokens"]})
        c = cache["groups"]["slot0"]
        return loss, logits, c.k, c.v

    out = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree_util.tree_map(np.asarray, params),
            *[np.asarray(x, np.float32) for x in out])


def _port_run(cfg, params, batch, impl):
    bundle = build_model(cfg, attention_impl=impl, device="cpu")
    tp = convert.lm_params_from_jax(cfg, params, device="cpu")
    tb = {k: torch.as_tensor(v.astype(np.int64)) for k, v in batch.items()}
    loss, metrics = bundle.loss_fn(tp, tb)
    logits, cache = bundle.prefill(tp, {"tokens": tb["tokens"]})
    c = cache["groups"]["slot0"]
    assert float(metrics["aux_loss"]) == 0.0 and cache["prelude"] == []
    return (float(loss), logits.numpy(), c.k.to(torch.float32).numpy(),
            c.v.to(torch.float32).numpy())


def _assert_same(got, want):
    loss, logits, k, v = got
    assert loss == pytest.approx(float(want[0]), rel=1e-5)
    for g, w in zip((logits, k, v), want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **LOGIT_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_match_jax(arch):
    for cfg, ref in ((get_config(arch), jax_config(arch)),
                     (get_config(arch).reduced(), jax_config(arch).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(DENSE_ARCHS)))
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        get_config(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_tree(arch, dtype):
    """``init`` draws the reference's tree: the same keys, shapes and types
    (the numbers differ: the PRNG is not ported)."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg, cfg = jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), jnp.dtype(str(t.dtype).split(".")[-1])), got))[0]
    assert [(p, (s.shape, s.dtype)) for p, s in flat_g] == \
        [(p, (s.shape, s.dtype)) for p, s in flat_w]
    emb = got["embed"].to(torch.float32)
    assert 0.015 < float(emb.std()) < 0.025  # 0.02 * N(0, 1)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_prefill_match_jax(arch):
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, 2, 16)
    params, *want = _jax_run(jax_config(arch).reduced(), batch, "ref")
    _assert_same(_port_run(cfg, params, batch, "ref"), want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-34b"])
def test_kernel_route_matches_pallas(arch):
    """The port's ``"kernel"`` route (kernel 6's plain version on the CPU)
    against JAX's ``"pallas"`` route (interpret mode): qk-norm (qwen3) and
    MQA (granite)."""
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, 2, 16, seed=1)
    params, *want = _jax_run(jax_config(arch).reduced(), batch, "pallas")
    before = kfa.flash_attention.launches
    _assert_same(_port_run(cfg, params, batch, "kernel"), want)
    assert kfa.flash_attention.launches == before


def test_sliding_window_and_ragged_tiles_reach_the_model():
    """S = 100 with an 8-token window: the window masks most keys and the
    kernel's 64-key tiles end ragged; the kernel route and the reference
    route both equal JAX's reference."""
    cfg = get_config("qwen3-8b").reduced(sliding_window=8)
    batch = _batch(cfg, 2, 100, seed=2)
    params, *want = _jax_run(
        jax_config("qwen3-8b").reduced(sliding_window=8), batch, "ref")
    for impl in ("kernel", "ref"):
        _assert_same(_port_run(cfg, params, batch, impl), want)


def test_bfloat16_forward_tracks_jax():
    """qwen3 reduced in bfloat16: the rounding points (RMSNorm and RoPE in
    float32 cast back, bf16 products, logits upcast after the head) are
    the reference's.  Products round to bfloat16 (2^-9 relative) after
    sums in another order, so outputs that straddle a rounding boundary
    differ by one bf16 step: relative L2 of the logits and the cache
    within 2e-2, the loss within 1e-3."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    cfg = get_config("qwen3-8b").reduced(**kw)
    batch = _batch(cfg, 2, 16, seed=4)
    params, *want = _jax_run(jax_config("qwen3-8b").reduced(**kw), batch,
                             "ref")
    loss, *got = _port_run(cfg, params, batch, "ref")
    assert loss == pytest.approx(float(want[0]), rel=1e-3)
    for g, w in zip(got, want[1:]):  # logits, cache k, cache v
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 2e-2, rel


def test_unported_entry_points_raise():
    bundle = build_model(get_config("qwen3-8b").reduced(), device="cpu")
    for fn, item in ((bundle.train_step, "item 10"),
                     (bundle.input_specs, "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            fn()
    moe = get_config("qwen3-8b").reduced(
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=128))
    with pytest.raises(NotImplementedError, match="MoE"):
        build_model(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="mixers"):
        build_model(get_config("qwen3-8b").reduced(
            block_pattern=("attn", "mamba"), n_layers=2), device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        build_model(get_config("qwen3-8b").reduced(), attention_impl="pallas",
                    device="cpu")
