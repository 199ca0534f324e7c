"""The class Buzen kernel's plain float32 version (what CPU tensors run)
against the JAX package's Pallas kernel in interpret mode and the float64
class DP, and its autograd wrapper against JAX's gradients.

Tolerances: ``rtol/atol 2e-5`` against the JAX kernel at small counts (the
reference kernel's own bound; both are float32 DPs, the port's series is
built in float64 and rounded once, the reference's in float32); ``rtol
3e-5, atol 3e-4`` against the float64 DP at Table 1's counts x 1e4
(n = 1e6, m_max = 132), the paper-scale bound of ``tests/test_kernels.py``
— which the reference kernel's float32 series misses there by about 0.1,
so this case pins the float64 build; gradients (float64 on both sides)
``rtol 1e-10``.  The CUDA kernel itself is compared with the plain version
on a card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.kernels import buzen as jk
from repro_torch.core.buzen import class_log_normalizing_constants
from repro_torch.kernels import buzen as tk
from repro_torch.scenario.spec import PAPER_CLUSTERS_TABLE1, ClassSpec


def _rows(seed, B, S, with_cs=False, with_pad=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 41, (B, S)).astype(np.float64)
    lr = (np.log(rng.dirichlet(np.ones(S), size=B) / counts)
          - np.log(rng.uniform(0.2, 8.0, (B, S))))
    if with_pad:
        lr[:, -2:] = -np.inf  # padded classes: count 0, load 0
        counts[:, -2:] = 0
    if with_cs:
        lr = np.concatenate([lr, np.log(rng.uniform(0.2, 2.0, (B, 1)))], 1)
        counts = np.concatenate([counts, np.ones((B, 1))], 1)
    lg = np.log(rng.uniform(0.1, 3.0, B))
    return lr, counts, lg


@pytest.mark.parametrize("with_cs,with_pad", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_plain_matches_pallas_interpret(with_cs, with_pad):
    lr, cnt, lg = _rows(0, 4, 5, with_cs, with_pad)
    want = np.asarray(jk.buzen_classes_pallas_batched(
        jnp.asarray(lr), jnp.asarray(cnt), jnp.asarray(lg), 30,
        interpret=True))
    got = tk.buzen_classes_batched(torch.as_tensor(lr), torch.as_tensor(cnt),
                                   torch.as_tensor(lg), 30)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_cs", [False, True])
def test_plain_matches_f64_class_dp(with_cs):
    lr, cnt, lg = _rows(1, 3, 6, with_cs, with_pad=True)
    want = np.asarray(jk._reference_class_log_Z(
        jnp.asarray(lr), jnp.asarray(cnt), jnp.asarray(lg), 40))
    got = tk.buzen_classes_batched(torch.as_tensor(lr), torch.as_tensor(cnt),
                                   torch.as_tensor(lg), 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("scale", [1, 10_000])
def test_plain_table1_at_population_scale(scale):
    """Table 1's five profiles as classes, uniform per-member routing,
    m_max = 132, counts x ``scale`` (n = 100 and n = 1e6)."""
    spec = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1)
    spec = ClassSpec(mu_c=spec.mu_c, mu_d=spec.mu_d, mu_u=spec.mu_u,
                     count=spec.count * scale)
    cp = spec.class_params(mu_cs=5.0, device="cpu")
    lr = cp.log_rho.numpy()[None]
    cnt = cp.count.numpy().astype(np.float64)[None]
    lg = cp.log_gamma_total.numpy()[None]
    want = np.asarray(jk._reference_class_log_Z(
        jnp.asarray(lr), jnp.asarray(cnt), jnp.asarray(lg), 132))
    got = tk.buzen_classes_batched(torch.as_tensor(lr), torch.as_tensor(cnt),
                                   torch.as_tensor(lg), 132).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-4)
    # consecutive differences set the throughput: held as tightly
    np.testing.assert_allclose(np.diff(got, axis=1), np.diff(want, axis=1),
                               rtol=3e-5, atol=3e-4)
    # and the class DP of the core, with its CS column, agrees
    f64 = class_log_normalizing_constants(cp, 132, backend="torch").numpy()
    k32 = class_log_normalizing_constants(cp, 132, backend="kernel").numpy()
    np.testing.assert_allclose(k32, f64, rtol=3e-5, atol=3e-4)


def test_padded_classes_are_identities_bitwise():
    lr, cnt, lg = _rows(2, 3, 4)
    base = tk.buzen_classes_batched(torch.as_tensor(lr), torch.as_tensor(cnt),
                                    torch.as_tensor(lg), 25)
    lr_p = np.concatenate([lr, np.full((3, 3), -np.inf)], axis=1)
    cnt_p = np.concatenate([cnt, np.zeros((3, 3))], axis=1)
    got = tk.buzen_classes_batched(torch.as_tensor(lr_p),
                                   torch.as_tensor(cnt_p),
                                   torch.as_tensor(lg), 25)
    assert torch.equal(got, base)
    series = tk._class_series(torch.as_tensor(lr_p), torch.as_tensor(cnt_p),
                              26)
    assert bool(torch.isfinite(series).all())
    assert bool((series[:, 4:, 0] == 0).all())
    assert bool((series[:, 4:, 1:] == tk.NEG_INF).all())


def test_autograd_function_matches_jax_grad():
    """The backward differentiates the float64 class DP at the primal
    point: JAX's ``buzen_classes_log_Z_batched`` gradients to ``rtol
    1e-10``, exactly 0 on padded classes, none for the counts."""
    lr, cnt, lg = _rows(3, 3, 6, with_cs=True, with_pad=True)
    w = np.random.default_rng(4).normal(size=(3, 21))
    live = np.isfinite(lr) & (cnt > 0)

    def wrapped(a, b):
        return jnp.sum(jnp.asarray(w) * jk.buzen_classes_log_Z_batched(
            a, jnp.asarray(cnt), b, 20))

    j_lr, j_lg = jax.grad(wrapped, argnums=(0, 1))(jnp.asarray(lr),
                                                   jnp.asarray(lg))
    a = torch.as_tensor(lr).requires_grad_(True)
    b = torch.as_tensor(lg).requires_grad_(True)
    c = torch.as_tensor(cnt)
    out = tk.buzen_classes_log_Z_batched(a, c, b, 20)
    assert out.dtype == torch.float64
    got_lr, got_lg = torch.autograd.grad(torch.sum(torch.as_tensor(w) * out),
                                         (a, b))
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(j_lr), rtol=1e-10)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(j_lg), rtol=1e-10)
    assert np.all(got_lr.numpy()[~live] == 0.0)
    assert np.all(got_lr.numpy()[live] != 0.0)


def test_cpu_runs_plain_and_counts_no_launch():
    lr, cnt, lg = _rows(5, 2, 3)
    before = tk.buzen_classes_batched.launches
    out = tk.buzen_classes_batched(torch.as_tensor(lr), torch.as_tensor(cnt),
                                   torch.as_tensor(lg), 10)
    assert tk.buzen_classes_batched.launches == before
    assert torch.equal(out, tk.buzen_classes_batched_plain(
        torch.as_tensor(lr), torch.as_tensor(cnt), torch.as_tensor(lg), 10))
    with pytest.raises(ValueError):
        tk.buzen_classes_batched(torch.as_tensor(lr[0]),
                                 torch.as_tensor(cnt[0]),
                                 torch.as_tensor(lg), 10)
    with pytest.raises(ValueError):
        tk.buzen_classes_batched(torch.as_tensor(lr),
                                 torch.as_tensor(cnt[:, :2]),
                                 torch.as_tensor(lg), 10)
