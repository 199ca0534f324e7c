"""The Buzen kernel's plain float32 version (what CPU tensors run) against
the JAX package's Pallas kernel in interpret mode and the float64 DP.

Tolerances are the reference kernel tests' (``tests/test_kernels.py``):
``rtol/atol 2e-5`` against the float64 DP, ``rtol 3e-5, atol 3e-4`` at
the paper's scale; ``1e-5`` between the two float32 implementations (same
arithmetic, reductions may associate differently).  The CUDA kernel itself
is compared with the plain version on a card (``tests/test_torch_cuda.py``).
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

