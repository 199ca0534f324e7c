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

The class backward's plain version (the float64 adjoint that
``BuzenClassesLogZ.backward`` runs for CPU tensors) is held against
``jax.grad`` of the JAX package's float64 class DP and of its custom VJP at
``rtol 1e-9`` (both float64; the adjoint sums in another order), its padded
partials exactly 0 and its real ones bitwise the unpadded run's; the class
kernel's arithmetic, written out in torch, within ``2e-5`` of the float64
class DP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.kernels import buzen as jk
from repro_torch.core.buzen import (_poisson_series,
                                    class_log_normalizing_constants)
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


def _table1_rows(seed, B, scale, with_cs):
    """Table 1's five profiles as classes (counts x ``scale``) at random
    per-member routing masses, their aggregated IS log-loads, and two
    count-0 columns (one at log_rho = -inf, one at a finite log-load); the
    CS station as a count-1 column when ``with_cs``."""
    rng = np.random.default_rng(seed)
    spec = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1)
    counts = spec.count * scale
    mass = rng.dirichlet(np.ones(len(counts)), size=B)
    lr = np.log(mass / counts) - np.log(spec.mu_c)
    lg = np.log((mass * (1.0 / spec.mu_d + 1.0 / spec.mu_u)).sum(-1))
    lr = np.concatenate([lr[:, :2], np.full((B, 1), -np.inf), lr[:, 2:],
                         np.full((B, 1), -1.5)], axis=1)
    cnt = np.tile(np.concatenate([counts[:2], [0], counts[2:], [0]]),
                  (B, 1)).astype(np.float64)
    if with_cs:
        lr = np.concatenate([lr, np.log(rng.uniform(0.1, 1.0, (B, 1)))], 1)
        cnt = np.concatenate([cnt, np.ones((B, 1))], 1)
    return lr, cnt, lg


def _grad_cases():
    # (kind, seed, B, S or scale, m_max, with_cs)
    return [("rows", 10, 3, 4, 20, False), ("rows", 11, 2, 6, 33, True),
            ("rows", 12, 1, 1, 0, False), ("table1", 13, 2, 1, 132, False),
            ("table1", 14, 2, 1, 132, True),
            ("table1", 15, 2, 10_000, 132, False),
            ("table1", 16, 2, 10_000, 132, True)]


@pytest.mark.parametrize("kind,seed,B,size,m_max,with_cs", _grad_cases())
def test_backward_plain_matches_jax_grad(kind, seed, B, size, m_max,
                                         with_cs):
    """``buzen_classes_log_Z_backward_plain`` is ``jax.grad`` of the JAX
    package's float64 class DP ``_reference_class_log_Z`` on the real
    columns (its padded partials are NaN or 0 there; the wrapper pins them)
    and of ``buzen_classes_log_Z_batched`` on every column, to ``rtol
    1e-9``: small random classes, and Table 1's counts at n = 100 and 1e6
    with count-0 columns, with and without the CS column."""
    if kind == "rows":
        lr, cnt, lg = _rows(seed, B, size, with_cs, with_pad=size > 2)
    else:
        lr, cnt, lg = _table1_rows(seed, B, size, with_cs)
    w = np.random.default_rng(seed + 1).normal(size=(B, m_max + 1))
    live = np.isfinite(lr) & (cnt > 0)

    def donor(a, b):
        return jnp.sum(jnp.asarray(w) * jk._reference_class_log_Z(
            a, jnp.asarray(cnt), b, m_max))

    def wrapped(a, b):
        return jnp.sum(jnp.asarray(w) * jk.buzen_classes_log_Z_batched(
            a, jnp.asarray(cnt), b, m_max))

    d_lr, d_lg = jax.jit(jax.grad(donor, argnums=(0, 1)))(
        jnp.asarray(lr), jnp.asarray(lg))
    j_lr, j_lg = jax.jit(jax.grad(wrapped, argnums=(0, 1)))(
        jnp.asarray(lr), jnp.asarray(lg))
    got_lr, got_lg = tk.buzen_classes_log_Z_backward_plain(
        torch.as_tensor(lr), torch.as_tensor(cnt), torch.as_tensor(lg),
        torch.as_tensor(w), m_max)
    assert got_lr.dtype == got_lg.dtype == torch.float64
    np.testing.assert_allclose(got_lr.numpy()[live], np.asarray(d_lr)[live],
                               rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(d_lg), rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(j_lr), rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(j_lg), rtol=1e-9,
                               atol=1e-300)
    assert np.all(got_lr.numpy()[~live] == 0.0)


@pytest.mark.parametrize("where", ["front", "middle", "end"])
def test_backward_plain_padded_partials_exact(where):
    """Two count-0 columns (one at log_rho = -inf, one finite): their
    partials are exactly 0, and the real columns' partials and d/d lg are
    bitwise those of the unpadded rows."""
    lr, cnt, lg = _rows(20, 3, 5, with_cs=True)
    w = torch.as_tensor(np.random.default_rng(21).normal(size=(3, 41)))
    at = {"front": 0, "middle": 3, "end": 6}[where]
    lr_p = np.insert(lr, [at, at], [-np.inf, -2.0], axis=1)
    cnt_p = np.insert(cnt, [at, at], 0.0, axis=1)
    real = [i for i in range(8) if i not in (at, at + 1)]
    t = torch.as_tensor
    base = tk.buzen_classes_log_Z_backward_plain(t(lr), t(cnt), t(lg), w, 40)
    got = tk.buzen_classes_log_Z_backward_plain(t(lr_p), t(cnt_p), t(lg), w,
                                                40)
    assert torch.equal(got[0][:, real], base[0])
    assert torch.equal(got[1], base[1])
    assert torch.all(got[0][:, [at, at + 1]] == 0.0)


def _class_kernel_arithmetic(log_rho, counts, log_gamma_total, m_max):
    """``buzen_classes_kernel``'s arithmetic written out in PyTorch: the
    Poisson row and every series in float64 (``_class_series``'s order),
    both in log2 units; row ``m`` of a live column is ``R + log2(sum_k
    exp2(float32(w2[k] + U2[m - k] - R)))`` with ``R`` the largest float64
    term, the sum in float32, the row float64; padded columns skipped; the
    output rounded to float32 in natural units."""
    l2e = 1.4426950408889634
    m_pad = m_max + 1
    j = torch.arange(m_pad)
    q = j[:, None] - j[None, :]                              # [m, k]: m - k
    valid = q >= 0
    qi = q.clamp_min(0)
    u2 = _poisson_series(log_gamma_total.to(torch.float64), m_max) * l2e
    w2 = tk._class_series(log_rho, counts, m_pad, torch.float64) * l2e
    live = tk._class_live(log_rho.to(torch.float64), counts)
    for s in range(w2.shape[1]):
        t = torch.where(valid, w2[:, s, None, :] + u2[:, qi], -torch.inf)
        r = t.amax(dim=-1)
        e = (t - r[..., None]).to(torch.float32)
        tot = torch.where(valid, torch.exp2(e), 0.0).sum(dim=-1)
        new = r + torch.log2(tot).to(torch.float64)
        u2 = torch.where(live[:, s, None], new, u2)
    return (u2 * 0.6931471805599453).to(torch.float32)


@pytest.mark.parametrize("scale", [1, 100, 10_000])
def test_kernel_arithmetic_tracks_the_f64_dp(scale):
    """The class kernel's arithmetic (float64 series and row, float32
    exponents) on Table 1's classes at n = 100, 1e4 and 1e6, m_max = 132,
    with and without the CS column: within ``2e-5`` of the float64 class
    DP (the plain float32 version misses it by up to about ``1.3e-5`` at
    these sizes, against ``rtol 3e-5, atol 3e-4``), and with its count-0
    columns bitwise the run without them."""
    for with_cs in (False, True):
        lr, cnt, lg = _table1_rows(30 + scale % 7, 4, scale, with_cs)
        want = np.asarray(jk._reference_class_log_Z(
            jnp.asarray(lr), jnp.asarray(cnt), jnp.asarray(lg), 132))
        t = torch.as_tensor
        got = _class_kernel_arithmetic(t(lr), t(cnt), t(lg), 132)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
        real = np.isfinite(lr[0]) & (cnt[0] > 0)
        assert torch.equal(_class_kernel_arithmetic(
            t(lr[:, real]), t(cnt[:, real]), t(lg), 132), got)


def test_cpu_runs_both_plain_versions_and_counts_no_launch():
    """On CPU tensors the forward and backward wrappers and the autograd
    function run the plain versions and count no launch; the backward
    wrapper refuses what the kernel would not take."""
    lr, cnt, lg = (torch.as_tensor(x) for x in _rows(40, 2, 4, True, True))
    g = torch.as_tensor(np.random.default_rng(41).normal(size=(2, 16)))
    fwd = tk.buzen_classes_batched.launches
    bwd = tk.buzen_classes_log_Z_backward.launches
    got = tk.buzen_classes_log_Z_backward(lr, cnt, lg, g, 15)
    want = tk.buzen_classes_log_Z_backward_plain(lr, cnt, lg, g, 15)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a = lr.clone().requires_grad_(True)
    b = lg.clone().requires_grad_(True)
    out = tk.buzen_classes_log_Z_batched(a, cnt, b, 15)
    assert torch.equal(out.float(), tk.buzen_classes_batched_plain(
        lr, cnt, lg, 15))
    g_lr, g_lg = torch.autograd.grad(out, (a, b), g)
    assert torch.equal(g_lr, want[0]) and torch.equal(g_lg, want[1])
    assert tk.buzen_classes_batched.launches == fwd
    assert tk.buzen_classes_log_Z_backward.launches == bwd
    with pytest.raises(ValueError):
        tk.buzen_classes_log_Z_backward(lr, cnt, lg, g[:, :5], 15)
    with pytest.raises(ValueError):
        tk.buzen_classes_log_Z_backward(lr, cnt[:, :2], lg, g, 15)
