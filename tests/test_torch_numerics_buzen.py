"""Port parity: numerics and the Buzen DP (``repro_torch.core.buzen``)
against the JAX package, on the CPU.

Tolerances: float64 log-constants agree to ``rtol 1e-12`` (same
recursion, logsumexp reductions may associate differently); gradients to
``rtol 1e-9``; the port's own padding contract is bitwise.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import buzen as jb
from repro_torch import convert
from repro_torch.core import buzen as tb
from repro_torch.core.numerics import fma, seqcumsum, seqsum


def _nets(seed, n, with_cs):
    rng = np.random.default_rng(seed)
    leaves = {"p": rng.dirichlet(np.ones(n)),
              "mu_c": rng.uniform(0.2, 8.0, n),
              "mu_d": rng.uniform(0.2, 8.0, n),
              "mu_u": rng.uniform(0.2, 8.0, n),
              "mu_cs": np.float64(1.7) if with_cs else None}
    jp = jb.NetworkParams(**{k: None if v is None else jnp.asarray(v)
                             for k, v in leaves.items()})
    return jp, convert.network_params(leaves, device="cpu")


def test_seqsum_and_seqcumsum_are_left_to_right():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17)) * 10.0 ** rng.integers(-8, 8, (3, 17))
    want = np.zeros(3)
    prefix = []
    for j in range(17):
        want = want + x[:, j]
        prefix.append(want.copy())
    t = torch.as_tensor(x)
    assert np.array_equal(seqsum(t, dim=-1).numpy(), want)
    assert np.array_equal(seqcumsum(t, dim=-1).numpy(),
                          np.stack(prefix, axis=1))
    # zero padding is bitwise invisible
    padded = torch.cat([t, torch.zeros(3, 5, dtype=t.dtype)], dim=-1)
    assert torch.equal(seqsum(padded, dim=-1), seqsum(t, dim=-1))


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(1)
    a = rng.normal(size=2000) * 10.0 ** rng.integers(-5, 5, 2000)
    b = rng.normal(size=2000) * 10.0 ** rng.integers(-5, 5, 2000)
    c = -a * b * (1 + rng.normal(size=2000) * 1e-9)  # heavy cancellation
    c[::3] = rng.normal(size=c[::3].shape)
    got = fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["aggregate", "literal"])
@pytest.mark.parametrize("with_cs", [False, True])
def test_log_normalizing_constants_match_jax(method, with_cs):
    for seed, n, m in [(0, 3, 9), (1, 7, 25), (2, 12, 40)]:
        jp, tp = _nets(seed, n, with_cs)
        want = np.asarray(jb.log_normalizing_constants(jp, m, method=method))
        got = tb.log_normalizing_constants(tp, m, method=method).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_cs", [False, True])
def test_log_Z_gradients_match_jax(with_cs):
    jp, tp = _nets(3, 6, with_cs)
    m = 14
    w = np.random.default_rng(4).normal(size=m + 1)

    def jf(p):
        return jnp.sum(jnp.asarray(w) * jb.log_normalizing_constants(
            jp._replace(p=p), m))

    want = np.asarray(jax.grad(jf)(jp.p))
    p = tp.p.clone().requires_grad_(True)
    out = torch.sum(torch.as_tensor(w) * tb.log_normalizing_constants(
        tp._replace(p=p), m))
    (got,) = torch.autograd.grad(out, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


@pytest.mark.parametrize("with_cs", [False, True])
def test_padded_n_is_bitwise_unpadded(with_cs):
    _, tp = _nets(5, 5, with_cs)
    for n_max in (5, 8, 13):
        padded = tb.pad_network(tp, n_max)
        assert torch.equal(tb.log_normalizing_constants(padded, 20),
                           tb.log_normalizing_constants(tp, 20))
    with pytest.raises(ValueError):
        tb.pad_network(tp, 4)


@pytest.mark.parametrize("with_cs", [False, True])
def test_brute_force_agrees(with_cs):
    jp, tp = _nets(6, 2, with_cs)
    for m in (1, 3, 4):
        bf = tb.brute_force_log_Z(tp, m)
        assert bf == pytest.approx(jb.brute_force_log_Z(jp, m), rel=1e-12)
        for method in ("aggregate", "literal"):
            logZ = tb.log_normalizing_constants(tp, m, method=method)
            assert float(logZ[m]) == pytest.approx(bf, rel=1e-10)


def test_backend_flag():
    assert tb.get_backend() == "torch"
    with pytest.raises(ValueError):
        tb.set_backend("pallas")
    _, tp = _nets(7, 4, False)
    with pytest.raises(ValueError):
        tb.log_normalizing_constants(tp, 5, method="literal",
                                     backend="kernel")
    got = tb.log_normalizing_constants(tp, 12, backend="kernel")
    want = tb.log_normalizing_constants(tp, 12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
