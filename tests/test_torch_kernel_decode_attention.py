"""Kernel 7's plain PyTorch version (what CPU tensors run, and what the CUDA
kernel is held against on the card) against the JAX package's decode
attention: its Pallas kernel in interpret mode and ``decode_attention_ref``
(JAX's and the port's); and the split bf16 kernel's plan and two passes
(per-part partials in the kernel's workspace layout, then the combine)
written out in PyTorch, against the same Pallas kernel.

Tolerances are ``tests/test_kernels.py``'s: float32 within ``2e-5`` (the
same online softmax in float32, other summation orders and tile sizes),
bfloat16 within ``2e-2`` (the output rounded to bfloat16, 8 bits of
mantissa: one rounding step is up to 2^-8 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.models.attention import decode_attention_ref as jax_decode_ref
from repro_torch.kernels import decode_attention as kda
from repro_torch.models import attention as TA

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B, S, H, KV, D, dtype):
    """The same values for both packages: float32 normals, rounded once to
    ``dtype`` on each side (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))]
    return ([jnp.asarray(x, dtype) for x in xs],
            [torch.as_tensor(x).to(getattr(torch, dtype)) for x in xs])


def _f32(x):
    return (np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.to(torch.float32).numpy())


@functools.lru_cache(maxsize=None)
def _pallas(block_s):
    return jax.jit(functools.partial(decode_attention_pallas, block_s=block_s,
                                     interpret=True))


@pytest.mark.parametrize("B,S,H,KV,D,length", [
    (2, 256, 8, 2, 64, 200),   # tests/test_kernels.py's shapes
    (1, 100, 4, 4, 128, 100),
    (3, 513, 4, 1, 64, 77),    # S not a multiple of the tile
    (2, 96, 32, 8, 128, 70),   # Qwen3's G = 4, D = 128
    (2, 80, 48, 1, 128, 80),   # granite-34b's MQA: G = 48
], ids=["gqa4", "mha", "mqa-ragged", "qwen3", "granite-mqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, B, S, H, KV, D, length):
    (jq, jk, jv), (tq, tk, tv) = _inputs(S + H, B, S, H, KV, D, dtype)
    want = _pallas(64)(jq, jk, jv, jnp.int32(length))
    before = kda.decode_attention.launches
    got = kda.decode_attention(tq, tk, tv, length)
    assert kda.decode_attention.launches == before  # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("block_s", [32, 64])
def test_per_batch_lengths_match_pallas(block_s):
    """``tests/test_kernels.py``'s per-batch case: lengths [10, 64, 128]
    as an int32 tensor, against the TPU kernel at two block sizes."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 3, 128, 4, 2, 64, "float32")
    lengths = np.array([10, 64, 128], np.int32)
    want = _pallas(block_s)(jq, jk, jv, jnp.asarray(lengths))
    got = kda.decode_attention(tq, tk, tv, torch.as_tensor(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("length", [1, 37, 64, 65, 150, [3, 150, 64],
                                    [1, 1, 149]],
                         ids=lambda x: "x".join(map(str, np.atleast_1d(x))))
@pytest.mark.parametrize("H,KV", [(8, 2), (6, 1), (4, 4)])
def test_plain_matches_decode_attention_ref(H, KV, length):
    """Against the port's ``decode_attention_ref`` (one softmax over the
    whole cache) and JAX's: tile edges, per-batch lengths, G = 1, 4, 6."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(H + KV, 3, 150, H, KV, 64,
                                         "float32")
    tl = torch.as_tensor(length)
    got = kda.decode_attention_plain(tq, tk, tv, tl)
    np.testing.assert_allclose(
        _f32(got), _f32(TA.decode_attention_ref(tq, tk, tv, tl)),
        **TOL["float32"])
    np.testing.assert_allclose(
        _f32(got), _f32(jax.jit(jax_decode_ref)(jq, jk, jv,
                                                jnp.asarray(length))),
        **TOL["float32"])


def test_full_one_and_zero_lengths():
    """``length = S`` and ``1`` against the reference; ``0`` (never on the
    decode path) is defined as 0, as kernel 6's port defines a row with no
    valid key; a length past S counts as S; the int and tensor forms agree
    bitwise; ``length = 1`` returns the first value row of the KV head."""
    (_, _, _), (q, k, v) = _inputs(9, 2, 90, 8, 2, 64, "float32")
    for n in (90, 1):
        np.testing.assert_allclose(
            _f32(kda.decode_attention_plain(q, k, v, n)),
            _f32(TA.decode_attention_ref(q, k, v, n)), **TOL["float32"])
    zero = kda.decode_attention_plain(q, k, v, 0)
    assert bool((zero == 0).all())
    mixed = kda.decode_attention_plain(q, k, v, torch.tensor([0, 90]))
    assert bool((mixed[0] == 0).all())
    assert torch.equal(mixed[1], kda.decode_attention_plain(
        q[1:], k[1:], v[1:], 90)[0])
    assert torch.equal(kda.decode_attention_plain(q, k, v, 500),
                       kda.decode_attention_plain(q, k, v, 90))
    assert torch.equal(kda.decode_attention_plain(q, k, v, 40),
                       kda.decode_attention_plain(q, k, v,
                                                  torch.tensor([40, 40])))
    one = kda.decode_attention_plain(q, k, v, 1).reshape(2, 2, 4, 64)
    np.testing.assert_allclose(_f32(one), _f32(
        v[:, 0, :, None, :].expand(2, 2, 4, 64)), rtol=1e-6, atol=1e-6)


def test_dispatch_routes():
    """``models.attention.decode_attention``: ``"kernel"`` runs kernel 7
    (its plain version on the CPU), ``"ref"`` and ``"plain"`` the
    reference; an unknown route raises."""
    (_, _, _), (q, k, v) = _inputs(3, 2, 70, 4, 2, 64, "float32")
    outs = [TA.decode_attention(q, k, v, 50, impl=impl) for impl in TA.IMPLS]
    assert torch.equal(outs[2], kda.decode_attention_plain(q, k, v, 50))
    assert torch.equal(outs[0], TA.decode_attention_ref(q, k, v, 50))
    np.testing.assert_allclose(_f32(outs[2]), _f32(outs[0]),
                               **TOL["float32"])
    with pytest.raises(ValueError, match="unknown attention impl"):
        TA.decode_attention(q, k, v, 50, impl="pallas")


@pytest.mark.parametrize("bad", ["two-tokens", "heads", "dtype", "head-dim",
                                 "float-length", "length-shape", "rank"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k = torch.zeros(2, 1, 6, 64), torch.zeros(2, 8, 2, 64)
    length = 4
    if bad == "two-tokens":
        q = torch.zeros(2, 2, 6, 64)
    elif bad == "heads":
        k = torch.zeros(2, 8, 4, 64)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "head-dim":
        k = torch.zeros(2, 8, 2, 32)
    elif bad == "float-length":
        length = torch.tensor([4.0, 4.0])
    elif bad == "length-shape":
        length = torch.tensor([4, 4, 4])
    else:
        q = torch.zeros(2, 6, 64)
    with pytest.raises(ValueError):
        kda.decode_attention(q, k, k, length)


@pytest.mark.parametrize("B,KV,S,length,want", [
    (128, 8, 8192, 8192, (1, 128)),  # decode_32k: 1,024 CTAs, one part
    (16, 8, 320, 320, (1, 5)),       # the serve shape: a CTA an SM
    (8, 8, 4096, 4096, (2, 32)),     # 64 CTAs: two parts fill the SMs
    (4, 8, 1024, 1024, (4, 4)),      # 32 CTAs: four parts of 4 tiles
    (2, 8, 8192, 8192, (8, 16)),
    (2, 1, 8192, 8192, (32, 4)),     # 2 CTAs: parts of MIN_PART_TILES
    (2, 1, 8192, 700, (2, 6)),       # the scalar length's 11 tiles
    (4, 8, 1024, 0, (1, 1)),
    (4, 8, 200, 200, (1, 4)),        # too few tiles to split
])
def test_split_plan_cases(B, KV, S, length, want):
    assert kda.split_plan(B, KV, S, length, 132) == want


def test_split_plan_covers_every_tile_once():
    """Over a grid of shapes: at most one part per tile, and at least
    ``MIN_PART_TILES`` in each part of a split; the parts cover the tiles
    of the length and none lies wholly past it; no split when B * KV CTAs
    occupy half the SMs or more."""
    for B in (1, 3, 16, 40):
        for KV in (1, 8):
            for S in (1, 64, 65, 320, 1000, 8192):
                for length in {0, 1, S // 2, S, S + 9}:
                    parts, per = kda.split_plan(B, KV, S, length, 132)
                    tiles = -(-min(length, S) // kda.BLOCK_S)
                    assert 1 <= parts <= max(tiles, 1) and per >= 1
                    assert parts * per >= tiles
                    assert (parts - 1) * per < max(tiles, 1)
                    if parts > 1:
                        assert per >= kda.MIN_PART_TILES
                    if B * KV > 132 // 2:
                        assert parts == 1


def _two_passes(tq, tk, tv, length, parts):
    S = tk.shape[1]
    tiles = -(-S // kda.BLOCK_S)
    per = -(-tiles // parts)
    acc, m, l = kda.decode_attention_partials_plain(
        tq, tk, tv, length, -(-tiles // per), per)
    assert acc.shape == (-(-tiles // per),) + tq.shape[:1] + tq.shape[2:]
    assert m.shape == l.shape == acc.shape[:3]
    return kda.decode_attention_combine_plain(acc, m, l, tq.dtype)


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_passes_match_pallas_interpret(dtype, parts):
    """The split kernel's two passes written out in PyTorch (per-part
    partials in the workspace layout, then the combine) against the TPU
    kernel in interpret mode: 8 tiles in 1 to 4 parts, per-batch lengths
    0, S, 70 and 200 (whole parts past the length) and a scalar 100."""
    B, S, H, KV, D = 4, 512, 8, 2, 128
    (jq, jk, jv), (tq, tk, tv) = _inputs(parts + 17, B, S, H, KV, D, dtype)
    lengths = np.array([0, S, 70, 200], np.int32)
    got = _two_passes(tq, tk, tv, torch.as_tensor(lengths), parts)
    want = _pallas(64)(jq, jk, jv, jnp.asarray(lengths))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert bool((got[0] == 0).all())  # length 0 gives 0
    np.testing.assert_allclose(_f32(got[1:]), _f32(want)[1:], **TOL[dtype])
    got = _two_passes(tq, tk, tv, 100, parts)
    np.testing.assert_allclose(
        _f32(got), _f32(_pallas(64)(jq, jk, jv, jnp.int32(100))),
        **TOL[dtype])


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_two_passes_match_one_pass(parts):
    """Splitting changes only the summation order: the two passes equal
    the one-pass plain version within float32 rounding, at Qwen3's G = 4
    and granite's G = 48, ragged S, per-batch lengths with 0 and S."""
    for H, KV in ((32, 8), (48, 1)):
        (_, _, _), (tq, tk, tv) = _inputs(parts + H, 3, 333, H, KV, 64,
                                          "float32")
        lengths = torch.tensor([333, 0, 150])
        np.testing.assert_allclose(
            _f32(_two_passes(tq, tk, tv, lengths, parts)),
            _f32(kda.decode_attention_plain(tq, tk, tv, lengths)),
            rtol=1e-5, atol=1e-6)


def test_plain_ignores_what_lies_past_the_length():
    """NaN in every cache row at or past each length (a buffer never
    written) changes nothing: those scores are masked by a select and those
    values zeroed, in every part."""
    (_, _, _), (tq, tk, tv) = _inputs(4, 3, 200, 8, 2, 64, "float32")
    lengths = torch.tensor([1, 130, 200])
    past = (torch.arange(200)[None, :] >= lengths[:, None])[:, :, None, None]
    bk, bv = (torch.where(past, float("nan"), x) for x in (tk, tv))
    for parts in (1, 2, 4):
        assert torch.equal(_two_passes(tq, bk, bv, lengths, parts),
                           _two_passes(tq, tk, tv, lengths, parts))
