"""The port's attention references (``repro_torch.models.attention``)
against the JAX package's on the same numpy-made inputs.

Float32 within ``rtol/atol 2e-5``: the same arithmetic, other summation
orders.  bfloat16 (the chunked reference, which scales q in bfloat16 with
the scale rounded to bfloat16 first, as JAX's weakly typed scalar is)
within ``2e-2``: the output is rounded to bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(rng, shape, dtype="float32"):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal,window,block_k", [
    (True, None, 1024), (True, 9, 16), (False, None, 16), (False, 12, 7)])
@pytest.mark.parametrize("Sq,Sk,H,KV", [(24, 24, 4, 2), (9, 40, 8, 1)])
def test_flash_attention_ref_matches_jax(Sq, Sk, H, KV, causal, window,
                                         block_k, q_offset, dtype):
    rng = np.random.default_rng(Sq + Sk + H)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in (
        (2, Sq, H, 32), (2, Sk, KV, 32), (2, Sk, KV, 32)))
    want = jax.jit(lambda q, k, v: JA.flash_attention_ref(
        q, k, v, causal=causal, window=window, block_k=block_k,
        q_offset=q_offset))(jq, jk, jv)
    got = TA.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 block_k=block_k, q_offset=q_offset)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 6, 3), (False, None, 0), (False, 5, 2)])
def test_plain_attention_ref_matches_jax(causal, window, q_offset):
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s) for s in (
        (2, 13, 6, 16), (2, 20, 3, 16), (2, 20, 3, 16)))
    want = JA.plain_attention_ref(jq, jk, jv, causal=causal, window=window,
                                  q_offset=q_offset)
    got = TA.plain_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("length", [17, 1, [5, 30, 12]],
                         ids=["scalar", "one", "per-batch"])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4), (6, 1)])
def test_decode_attention_ref_matches_jax(H, KV, length):
    rng = np.random.default_rng(H * 10 + KV)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s) for s in (
        (3, 1, H, 32), (3, 30, KV, 32), (3, 30, KV, 32)))
    want = JA.decode_attention_ref(jq, jk, jv, jnp.asarray(length))
    got = TA.decode_attention_ref(tq, tk, tv, torch.as_tensor(length))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_the_three_routes_agree():
    """``attention()`` on each route, float32: the kernel route (its plain
    version on the CPU), the chunked and the naive reference."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 70, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    outs = [TA.attention(q, k, v, window=20, impl=impl, block_k=32)
            for impl in TA.IMPLS]
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        TA.attention(q, k, v, impl="pallas")
