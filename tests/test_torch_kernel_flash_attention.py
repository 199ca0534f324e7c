"""Kernel 6's plain PyTorch version (what CPU tensors run, and what the CUDA
kernel is held against on the card) against the JAX package's flash
attention: its Pallas kernel in interpret mode and its chunked reference.

Tolerances are ``tests/test_kernels.py``'s: float32 within ``2e-5`` (the
same online softmax in float32, other summation orders and tile sizes),
bfloat16 within ``2e-2`` (the output rounded to bfloat16, 8 bits of
mantissa: one rounding step is up to 2^-8 relative).

The bfloat16 CUDA kernel rounds at other points than the plain version
(p to bfloat16 for ``p v``, the scale on the float32 scores, ``exp2``):
its arithmetic, written out here in PyTorch, is held against the Pallas
kernel too, as the CPU-side evidence for its ``2e-2`` bound.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models.attention import attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [
    (1, 128, 128, 4, 4, 64),   # MHA, block-aligned
    (2, 100, 100, 8, 2, 64),   # GQA 4:1, ragged seq
    (1, 33, 257, 4, 1, 128),   # MQA, cross lengths, ragged blocks
]
MODES = [(True, None), (True, 64), (False, None)]


def _inputs(seed, B, Sq, Sk, H, KV, D, dtype, scale=1.0):
    """The same values for both packages: float32 normals (q and k times
    ``scale``), rounded once to ``dtype`` on each side (both round to
    nearest even)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]
    xs = [xs[0] * np.float32(scale), xs[1] * np.float32(scale), xs[2]]
    return ([jnp.asarray(x, dtype) for x in xs],
            [torch.as_tensor(x).to(getattr(torch, dtype)) for x in xs])


def _f32(x):
    return (np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.to(torch.float32).numpy())


@functools.lru_cache(maxsize=None)
def _pallas(dtype, shape, causal, window, scale=1.0):
    """JAX's Pallas kernel in interpret mode on :func:`_inputs`, as float32
    numpy; cached, so the tests here share one interpret-mode run per
    case (the driver runs a file on one worker)."""
    (jq, jk, jv), _ = _inputs(sum(shape), *shape, dtype, scale)
    return _f32(ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True))


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, shape, causal, window):
    _, (tq, tk, tv) = _inputs(sum(shape), *shape, dtype)
    want = _pallas(dtype, shape, causal, window)
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert kfa.flash_attention.launches == before  # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _bf16_kernel_arithmetic(q, k, v, *, causal, window):
    """The bfloat16 CUDA kernel's arithmetic in PyTorch: float32 scores,
    ``-1e30`` masking, 128-key tiles, the row max m of the raw scores,
    ``p = exp2(s c - m c)`` in float32 with ``c = D^-1/2 log2 e`` (the
    scale on the scores, not on q; a row that has met only masked keys
    shifts by 0), ``l`` summing that float32 p, ``p v`` taking p rounded to
    bfloat16 (float32 accumulation), ``acc * (1 / max(l, 1e-30))`` rounded
    to bfloat16."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    qf = q.float().reshape(B, Sq, KV, H // KV, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, Sq, KV, H // KV), kfa.NEG_INF)
    l = torch.zeros((B, Sq, KV, H // KV))
    acc = torch.zeros((B, Sq, KV, H // KV, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 128):
        kb, vb = kf[:, k0:k0 + 128], vf[:, k0:k0 + 128]
        cols = torch.arange(k0, k0 + kb.shape[1])[None, :]
        ok = torch.ones((Sq, kb.shape[1]), dtype=torch.bool)
        if causal:
            ok = ok & (cols <= rows)
        if window is not None:
            ok = ok & (cols > rows - window)
        s = torch.einsum("bqngd,bknd->bqngk", qf, kb)
        s = torch.where(ok[None, :, None, None, :], s, kfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * c)
        shift = torch.where(m_new == kfa.NEG_INF, 0.0, m_new * c)
        p = torch.exp2(s * c - shift[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqngk,bknd->bqngd", p.bfloat16().float(), vb)
        m = m_new
    out = acc * (1.0 / torch.clamp_min(l, 1e-30))[..., None]
    out = torch.where((m == kfa.NEG_INF)[..., None], 0.0, out)
    return out.reshape(B, Sq, H, D).bfloat16()


@pytest.mark.parametrize(
    "shape,causal,window,scale",
    [(shape, causal, window, 1.0) for shape in SHAPES
     for causal, window in MODES] + [(SHAPES[-1], True, None, 4.0)],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_bf16_kernel_arithmetic_matches_pallas_interpret(shape, causal,
                                                         window, scale):
    """The bfloat16 kernel's rounding points stay inside ``2e-2`` of the
    Pallas kernel, also with q and k at 4x unit scale (peaked softmaxes)."""
    _, (tq, tk, tv) = _inputs(sum(shape), *shape, "bfloat16", scale)
    want = _pallas("bfloat16", shape, causal, window, scale)
    got = _bf16_kernel_arithmetic(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), want, **TOL["bfloat16"])


@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("shape", [(2, 96, 96, 8, 4, 64),
                                   (1, 80, 80, 16, 2, 64)],
                         ids=["gqa2to1", "gqa8to1"])
def test_plain_matches_chunked_reference(shape, causal, window):
    """GQA 2:1 and 8:1 (the head layout h = kv * G + g), float32, against
    the chunked reference at a block size that splits the keys."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, *shape, "float32")
    want = jax_flash_ref(jq, jk, jv, causal=causal, window=window,
                         block_k=32)
    got = kfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_row_without_a_valid_key_is_zero():
    """Queries past the keys' end under a window have no valid key: both
    versions define that row as 0 (the TPU kernel's value there depends on
    its block size), and the other rows are untouched."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((1, 200, 2, 64), (1, 70, 1, 64), (1, 70, 1, 64)))
    got = kfa.flash_attention_plain(q, k, v, causal=True, window=16)
    assert bool((got[:, 85:] == 0).all())
    assert bool(torch.isfinite(got).all() and (got[:, :85] != 0).any())


def test_kernel_route_rejects_q_offset():
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="q_offset"):
        attention(q, k, k, impl="kernel", q_offset=3)
    out = attention(q, k, k, impl="kernel")
    assert out.shape == q.shape


@pytest.mark.parametrize("bad", ["heads", "dtype", "window"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k = torch.zeros(1, 4, 6, 64), torch.zeros(1, 4, 2, 64)
    kw = {}
    if bad == "heads":
        k = torch.zeros(1, 4, 4, 64)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    else:
        kw = {"window": 0}
    with pytest.raises(ValueError):
        kfa.flash_attention(q, k, k, **kw)
