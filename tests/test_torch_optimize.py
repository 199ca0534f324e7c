"""Port parity: the softmax-Adam routing/concurrency optimizer.

Bounds are the reference's (``tests/test_batched_optimizer.py:109-111``):
sweep values at ``rtol 1e-6``, routing at ``atol 1e-6``.  The ``"kernel"``
Buzen backend (its plain float32 forward on the CPU, float64 backward) is
held to the ``"torch"`` backend at ``rtol 1e-4``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import batched as jbat
from repro.core import buzen as jbz
from repro.core import complexity as jcx
from repro.core import optimize as jopt
from repro.scenario import spec as jspec
from repro_torch import convert
from repro_torch.core import batched as tbat
from repro_torch.core import complexity as tcx
from repro_torch.core import optimize as topt
from repro_torch.scenario import spec as tspec

CONSTS = dict(L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0, eps=1.0)


def _net(seed, n):
    rng = np.random.default_rng(seed)
    leaves = {"p": np.full(n, 1.0 / n), "mu_c": rng.uniform(0.3, 5.0, n),
              "mu_d": rng.uniform(0.3, 5.0, n),
              "mu_u": rng.uniform(0.3, 5.0, n)}
    jp = jbz.NetworkParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jp, convert.network_params(leaves, device="cpu")


@pytest.mark.parametrize("objective", ["time", "round"])
def test_sweep_matches_jax(objective):
    jp, tp = _net(11, 4)
    m_hi, steps = 8, 150
    jc, tc = jcx.LearningConstants(**CONSTS), tcx.LearningConstants(**CONSTS)
    jmake = {"time": jbat.make_time_objective_padded,
             "round": jbat.make_round_objective_padded}[objective]
    tmake = {"time": tbat.make_time_objective_padded,
             "round": tbat.make_round_objective_padded}[objective]
    want = jopt.batched_concurrency_sweep(
        jmake(jp, jc, m_hi), jp, m_grid=jnp.arange(1, m_hi + 1), steps=steps,
        backend="jnp")
    got = topt.batched_concurrency_sweep(
        tmake(tp, tc, m_hi), tp, m_grid=np.arange(1, m_hi + 1), steps=steps,
        backend="torch")
    np.testing.assert_array_equal(got.m_grid, want.m_grid)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    assert got.best.m == want.best.m


def test_optimize_routing_matches_jax():
    jp, tp = _net(12, 4)
    jc, tc = jcx.LearningConstants(**CONSTS), tcx.LearningConstants(**CONSTS)
    want = jopt.round_optimal(jp, jc, 5, steps=100)
    got = topt.round_optimal(tp, tc, 5, steps=100)
    assert got.value == pytest.approx(want.value, rel=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    want = jopt.max_throughput(jp, 5, steps=100)
    got = topt.max_throughput(tp, 5, steps=100)
    assert got.value == pytest.approx(want.value, rel=1e-6)


def test_time_optimal_table1_matches_jax():
    """The quickstart's search: Table 1 at scale 10, m_max = n + 6."""
    jnet = jspec.NetworkSpec.from_clusters(jspec.PAPER_CLUSTERS_TABLE1, 10)
    tnet = tspec.NetworkSpec.from_clusters(tspec.PAPER_CLUSTERS_TABLE1, 10)
    jp, tp = jnet.params(), tnet.params(device="cpu")
    jc = jspec.LearningSpec().consts
    tc = tspec.LearningSpec().consts
    m_max = tnet.n + 6
    want = jopt.time_optimal(jp, jc, m_max=m_max, steps=40)
    got = topt.time_optimal(tp, tc, m_max=m_max, steps=40)
    assert got.m == want.m
    assert got.value == pytest.approx(want.value, rel=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    # the kernel backend: float32 forward (plain version on the CPU),
    # float64 backward, within rtol 1e-4 of the float64 backend
    kern = topt.batched_concurrency_sweep(
        tbat.make_time_objective_padded(tp, tc, m_max), tp,
        m_grid=np.arange(2, m_max + 1), m_max=m_max, steps=40,
        backend="kernel")
    ref = topt.batched_concurrency_sweep(
        tbat.make_time_objective_padded(tp, tc, m_max), tp,
        m_grid=np.arange(2, m_max + 1), m_max=m_max, steps=40,
        backend="torch")
    np.testing.assert_allclose(kern.values, ref.values, rtol=1e-4)
    assert kern.best.m == ref.best.m


def test_sweep_guards():
    _, tp = _net(13, 3)
    tc = tcx.LearningConstants(**CONSTS)
    with pytest.raises(ValueError):
        topt.batched_concurrency_sweep(
            tbat.make_time_objective_padded(tp, tc, 5), tp,
            m_grid=np.arange(1, 7), m_max=5, steps=1)
    with pytest.raises(ValueError):
        topt.batched_concurrency_sweep(
            tbat.make_time_objective_padded(tp, tc, 5), tp,
            m_grid=np.arange(1, 5), m_max=6, steps=1)
    # search="pruned" on a grid of at most min_full points is the full
    # sweep, as in the JAX package (m = 2..5: 4 rows)
    pruned = topt.time_optimal(tp, tc, m_max=5, search="pruned", steps=1)
    full = topt.time_optimal(tp, tc, m_max=5, steps=1)
    assert pruned.m == full.m and pruned.value == full.value
    assert torch.equal(pruned.p, full.p)
    jp, _ = _net(13, 3)
    want = jopt.time_optimal(jp, jcx.LearningConstants(**CONSTS), m_max=5,
                             search="pruned", steps=1)
    assert pruned.m == want.m
    assert pruned.value == pytest.approx(want.value, rel=1e-6)
    assert torch.get_default_dtype() == torch.float32  # never changed
