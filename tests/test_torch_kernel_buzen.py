"""The Buzen kernel's plain float32 version (what CPU tensors run) against
the JAX package's Pallas kernel in interpret mode and the float64 DP, and
the float64 adjoint's plain version (what ``BuzenLogZ.backward`` runs for
CPU tensors) against ``jax.grad`` of the JAX package's DP.

Tolerances are the reference kernel tests' (``tests/test_kernels.py``):
``rtol/atol 2e-5`` against the float64 DP, ``rtol 3e-5, atol 3e-4`` at
the paper's scale; ``1e-5`` between the two float32 implementations (same
arithmetic, reductions may associate differently); ``rtol 1e-9`` for the
float64 gradients.  The CUDA kernels themselves are compared with the plain
versions on a card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.kernels import buzen as jk
from repro_torch.core.buzen import NetworkParams, log_normalizing_constants
from repro_torch.kernels import buzen as tk
from repro_torch.scenario.spec import PAPER_CLUSTERS_TABLE1, NetworkSpec


def _rows(seed, B, S, with_pad=False):
    rng = np.random.default_rng(seed)
    lr = np.log(rng.dirichlet(np.ones(S), size=B)) - np.log(
        rng.uniform(0.2, 8.0, (B, S)))
    if with_pad:
        lr[:, -2:] = -np.inf  # padded (load-0) stations
    lg = np.log(rng.uniform(0.1, 3.0, B))
    return lr, lg


@pytest.mark.parametrize("with_pad", [False, True])
def test_plain_matches_pallas_interpret(with_pad):
    lr, lg = _rows(0, 4, 7, with_pad)
    want = np.asarray(jk.buzen_pallas_batched(
        jnp.asarray(lr), jnp.asarray(lg), 24, interpret=True))
    got = tk.buzen_batched(torch.as_tensor(lr), torch.as_tensor(lg), 24)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,n,m", [(0, 1, 1), (1, 3, 17), (2, 8, 40),
                                      (3, 12, 33), (4, 5, 2)])
def test_plain_matches_f64_dp(seed, n, m):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    prm = NetworkParams(p=t(rng.dirichlet(np.ones(n))),
                        mu_c=t(rng.uniform(0.2, 8.0, n)),
                        mu_d=t(rng.uniform(0.2, 8.0, n)),
                        mu_u=t(rng.uniform(0.2, 8.0, n)))
    want = log_normalizing_constants(prm, m).numpy()
    got = tk.buzen_single(prm.log_rho, prm.log_gamma_total, m).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_paper_scale():
    """n = 100 clients (Table 1), m = 100 tasks."""
    prm = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).params(
        device="cpu")
    want = log_normalizing_constants(prm, 100).numpy()
    got = tk.buzen_single(prm.log_rho, prm.log_gamma_total, 100).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-4)


def test_padded_stations_are_identities():
    lr, lg = _rows(5, 3, 6)
    base = tk.buzen_batched(torch.as_tensor(lr), torch.as_tensor(lg), 30)
    padded = np.concatenate([lr, np.full((3, 4), -np.inf)], axis=1)
    got = tk.buzen_batched(torch.as_tensor(padded), torch.as_tensor(lg), 30)
    assert torch.equal(got, base)


def test_autograd_function_matches_jax_grad():
    """The backward is the float64 DP's gradient at the primal point: equal
    to ``jax.grad`` of the JAX package's ``buzen_log_Z_batched`` and of its
    VJP donor ``_reference_log_Z`` to ``rtol 1e-9``."""
    lr, lg = _rows(6, 3, 6, with_pad=True)
    w = np.random.default_rng(7).normal(size=(3, 21))
    fin = np.isfinite(lr)

    def donor(a, b):
        # the donor's -inf columns carry NaN partials; the wrapper pins them
        return jnp.sum(jnp.asarray(w) * jk._reference_log_Z(a, b, 20))

    def wrapped(a, b):
        return jnp.sum(jnp.asarray(w) * jk.buzen_log_Z_batched(a, b, 20))

    d_lr, d_lg = jax.grad(donor, argnums=(0, 1))(jnp.asarray(lr),
                                                 jnp.asarray(lg))
    j_lr, j_lg = jax.grad(wrapped, argnums=(0, 1))(jnp.asarray(lr),
                                                   jnp.asarray(lg))
    a = torch.as_tensor(lr).requires_grad_(True)
    b = torch.as_tensor(lg).requires_grad_(True)
    out = tk.buzen_log_Z_batched(a, b, 20)
    assert out.dtype == torch.float64
    got_lr, got_lg = torch.autograd.grad(torch.sum(torch.as_tensor(w) * out),
                                         (a, b))
    np.testing.assert_allclose(got_lr.numpy()[fin], np.asarray(d_lr)[fin],
                               rtol=1e-9)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(d_lg), rtol=1e-9)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(j_lr), rtol=1e-9)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(j_lg), rtol=1e-9)
    assert np.all(got_lr.numpy()[~fin] == 0.0)  # padded stations pinned


def test_cpu_runs_plain_and_counts_no_launch():
    lr, lg = _rows(8, 2, 3)
    before = tk.buzen_batched.launches
    tk.buzen_batched(torch.as_tensor(lr), torch.as_tensor(lg), 10)
    assert tk.buzen_batched.launches == before
    with pytest.raises(ValueError):
        tk.buzen_batched(torch.as_tensor(lr[0]), torch.as_tensor(lg), 10)



def _grad_cases():
    # (seed, B, S, m_max, padded columns)
    return [(10, 3, 1, 1, ()), (11, 4, 7, 24, (1, 6)), (12, 2, 12, 40, (0, 5)),
            (13, 3, 5, 0, (2,)), (14, 1, 3, 17, ())]


@pytest.mark.parametrize("seed,B,S,m_max,pad", _grad_cases())
def test_backward_plain_matches_jax_grad(seed, B, S, m_max, pad):
    """``buzen_log_Z_backward_plain`` is ``jax.grad`` of the JAX package's
    float64 DP ``_reference_log_Z`` (its padded partials, NaN there, are
    pinned to 0 here) and of ``buzen_log_Z_batched`` to ``rtol 1e-9``."""
    lr, lg = _rows(seed, B, S)
    lr[:, list(pad)] = -np.inf
    w = np.random.default_rng(seed + 1).normal(size=(B, m_max + 1))
    fin = np.isfinite(lr)

    def donor(a, b):
        return jnp.sum(jnp.asarray(w) * jk._reference_log_Z(a, b, m_max))

    def wrapped(a, b):
        return jnp.sum(jnp.asarray(w) * jk.buzen_log_Z_batched(a, b, m_max))

    d_lr, d_lg = jax.jit(jax.grad(donor, argnums=(0, 1)))(
        jnp.asarray(lr), jnp.asarray(lg))
    j_lr, j_lg = jax.jit(jax.grad(wrapped, argnums=(0, 1)))(
        jnp.asarray(lr), jnp.asarray(lg))
    got_lr, got_lg = tk.buzen_log_Z_backward_plain(
        torch.as_tensor(lr), torch.as_tensor(lg), torch.as_tensor(w), m_max)
    assert got_lr.dtype == got_lg.dtype == torch.float64
    np.testing.assert_allclose(got_lr.numpy()[fin], np.asarray(d_lr)[fin],
                               rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(d_lg), rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(j_lr), rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(j_lg), rtol=1e-9,
                               atol=1e-300)
    assert np.all(got_lr.numpy()[~fin] == 0.0)


@pytest.mark.parametrize("where", ["front", "middle", "end"])
def test_backward_plain_padded_partials_exact(where):
    """Padded columns' partials are exactly 0 and the real columns' are
    bitwise those of the unpadded rows."""
    lr, lg = _rows(20, 3, 6)
    w = torch.as_tensor(np.random.default_rng(21).normal(size=(3, 31)))
    at = {"front": 0, "middle": 3, "end": 6}[where]
    padded = np.insert(lr, [at, at], -np.inf, axis=1)
    real = [i for i in range(8) if i not in (at, at + 1)]
    base = tk.buzen_log_Z_backward_plain(torch.as_tensor(lr),
                                         torch.as_tensor(lg), w, 30)
    got = tk.buzen_log_Z_backward_plain(torch.as_tensor(padded),
                                        torch.as_tensor(lg), w, 30)
    assert torch.equal(got[0][:, real], base[0])
    assert torch.equal(got[1], base[1])
    assert torch.all(got[0][:, [at, at + 1]] == 0.0)


def test_backward_cpu_runs_plain_and_counts_no_launch():
    lr, lg = _rows(22, 2, 3)
    a, b = torch.as_tensor(lr), torch.as_tensor(lg)
    g = torch.ones(2, 11, dtype=torch.float64)
    before = tk.buzen_log_Z_backward.launches
    got = tk.buzen_log_Z_backward(a, b, g, 10)
    want = tk.buzen_log_Z_backward_plain(a, b, g, 10)
    assert tk.buzen_log_Z_backward.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        tk.buzen_log_Z_backward(a, b, g[:, :5], 10)
    with pytest.raises(ValueError):
        tk.buzen_log_Z_backward(a[0], b, g, 10)


def _kernel_arithmetic(log_rho, log_gamma_total, m_max):
    """``buzen_kernel``'s arithmetic written out in PyTorch: the row in
    float64 log2 units; per station ``Y[j] = U2[j] - j lr2`` split into
    float32 hi and lo parts; row ``m`` is ``m lr2 + R + log2(sum_j
    exp2((Yh[j] - R) + Yl[j]))`` with ``R`` the largest ``Yh[j]``, ``j <=
    m``, the sum in float32; padded stations skipped; the output rounded to
    float32 in natural units."""
    l2e = 1.4426950408889634
    m_pad = m_max + 1
    j = torch.arange(m_pad, dtype=torch.float64)
    valid = j[None, :] <= j[:, None]                         # [m, j]
    u2 = tk._init_rows(log_gamma_total, m_pad, torch.float64) * l2e
    lr2 = tk._clamp_rho(log_rho, torch.float64) * l2e
    for s in range(lr2.shape[1]):
        live = lr2[:, s] > tk.NEG_INF * l2e
        y = u2 - j * lr2[:, s, None]
        yh = y.to(torch.float32)
        yl = (y - yh.to(torch.float64)).to(torch.float32)
        r = torch.where(valid, yh[:, None, :], -torch.inf).amax(dim=-1)
        e = (yh[:, None, :] - r[..., None]) + yl[:, None, :]
        tot = torch.where(valid, torch.exp2(e), 0.0).sum(dim=-1)
        new = (j * lr2[:, s, None] + r.to(torch.float64)
               + torch.log2(tot).to(torch.float64))
        u2 = torch.where(live[:, None], new, u2)
    return (u2 * 0.6931471805599453).to(torch.float32)


def test_kernel_arithmetic_tracks_the_f64_dp():
    """The forward kernel's arithmetic (float64 row, hi/lo float32
    exponents) at Table 1's scale, m = 132, a few routings: within ``2e-5``
    of the float64 DP, where the plain float32 version (the TPU kernel's
    arithmetic) misses it by about ``1e-4``; and within the plain version's
    own ``2e-5`` of the plain version, with padded stations bitwise."""
    prm = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).params(
        device="cpu")
    rng = np.random.default_rng(30)
    p = torch.as_tensor(np.vstack([np.full(100, 0.01),
                                   rng.dirichlet(np.full(100, 5.0), 3)]))
    lr = torch.log(p) - torch.log(prm.mu_c)
    lg = torch.log((p * (1.0 / prm.mu_d + 1.0 / prm.mu_u)).sum(-1))
    want = log_normalizing_constants(prm._replace(p=p), 132).numpy()
    got = _kernel_arithmetic(lr, lg, 132)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    plain = tk.buzen_batched_plain(lr, lg, 132)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    padded = torch.cat([lr[:, :40], torch.full((4, 3), -torch.inf),
                        lr[:, 40:]], dim=1)
    assert torch.equal(_kernel_arithmetic(padded, lg, 132), got)
