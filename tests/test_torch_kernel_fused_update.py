"""The fused update's plain version (what CPU tensors run) against the JAX
package's Pallas kernel ``fused_async_update_flat(interpret=True)`` and its
oracle ``ref.fused_async_update_oracle``, at the bounds of
``tests/test_kernels.py``: ``TOL`` on the new parameters (float32 2e-5,
bfloat16 2e-2) and ``rtol 1e-4`` on the norm; on ragged sizes (1, 4096,
4097, the ``(37, 19)`` + ``(1001,)`` pytree), and with several lanes and a
scale per lane."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_update as jfu
from repro.kernels import ref
from repro_torch.kernels import fused_update as tfu

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DT[dtype]
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), jd)
    return x, torch.as_tensor(np.array(x.astype(jnp.float32))).to(td)


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("N", [1, 4096, 4097, 9000])
def test_plain_flat_matches_pallas_interpret(dtype, N):
    rng = np.random.default_rng(N)
    jw, tw = _pair(rng, (N,), dtype)
    jg, tg = _pair(rng, (N,), dtype)
    scale = 0.137
    got, sq = tfu.fused_async_update_flat_plain(tw, tg, scale)
    want, wsq = jfu.fused_async_update_flat(jw, jg, scale, interpret=True)
    assert got.dtype == tw.dtype and got.shape == (N,) and sq.shape == ()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(float(sq), float(wsq), rtol=1e-4)
    onew, onorm = ref.fused_async_update_oracle({"w": jw}, {"w": jg}, scale)
    np.testing.assert_allclose(_np(got), np.asarray(onew["w"], np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(np.sqrt(float(sq)), float(onorm), rtol=1e-4)


@pytest.mark.parametrize("dtype", list(DT))
def test_plain_pytree_matches_reference(dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (37, 19), "b": (1001,)}
    pj, pt, gj, gt = {}, {}, {}, {}
    for k, shape in shapes.items():
        pj[k], pt[k] = _pair(rng, shape, dtype)
    for k, shape in shapes.items():
        gj[k], gt[k] = _pair(rng, shape, dtype)
    new, norm = tfu.fused_async_update(pt, gt, 0.137)
    want_new, want_norm = ref.fused_async_update_oracle(pj, gj, 0.137)
    kern_new, kern_norm = jfu.fused_async_update(pj, gj, 0.137,
                                                 interpret=True)
    for k in shapes:
        assert new[k].shape == shapes[k] and new[k].dtype == pt[k].dtype
        for w in (want_new, kern_new):
            np.testing.assert_allclose(_np(new[k]),
                                       np.asarray(w[k], np.float32),
                                       **TOL[dtype])
    for w in (want_norm, kern_norm):
        np.testing.assert_allclose(float(norm), float(w), rtol=1e-4)


@pytest.mark.parametrize("dtype", list(DT))
def test_plain_lanes_with_per_lane_scales(dtype):
    rng = np.random.default_rng(7)
    L, N = 3, 5000
    jw, tw = _pair(rng, (L, N), dtype)
    jg, tg = _pair(rng, (L, N), dtype)
    scales = np.array([0.5, 0.01, 2.0], np.float32)
    got, sq = tfu.fused_async_update_flat_plain(tw, tg, torch.as_tensor(
        scales))
    assert got.shape == (L, N) and sq.shape == (L,)
    for i in range(L):
        want, wsq = jfu.fused_async_update_flat(jw[i], jg[i],
                                                float(scales[i]),
                                                interpret=True)
        np.testing.assert_allclose(_np(got[i]), np.asarray(want, np.float32),
                                   **TOL[dtype])
        np.testing.assert_allclose(float(sq[i]), float(wsq), rtol=1e-4)
        # a lane is the flat form on its own row
        one, one_sq = tfu.fused_async_update_flat_plain(
            tw[i], tg[i], float(scales[i]))
        assert torch.equal(one, got[i]) and torch.equal(one_sq, sq[i])


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(2, 4097)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(2, 4097)).astype(np.float32))
    s = torch.tensor([0.3, 0.7])
    before = tfu.fused_async_update_flat.launches
    got = tfu.fused_async_update_flat(w, g, s)
    want = tfu.fused_async_update_flat_plain(w, g, s)
    assert tfu.fused_async_update_flat.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # float32: bitwise the unfused ``w - scale * g`` the trainer runs
    assert torch.equal(got[0], w - s[:, None] * g)
    with pytest.raises(ValueError, match="no fused update kernel"):
        tfu.fused_async_update_flat(w.to("meta"), g.to("meta"), 0.1)
    with pytest.raises(ValueError, match="differ"):
        tfu.fused_async_update_flat(w, g[:, :10], 0.1)
