"""Port parity: the concurrency searches of ``repro.core.optimize`` beyond
the batched sweep, and ``repro.core.simulator.jump_chain_throughput``.

Bounds are the reference's (``tests/test_batched_optimizer.py:109-111``):
m grids and optima exact, values ``rtol 1e-6``, routing ``atol 1e-6``.
The JAX references run jitted on the CPU; the port runs its ``torch``
Buzen backend on CPU tensors.  The sequential search compiles one JAX scan
per ``m``, so its cases stay at ``n <= 6``, ``m_max <= 12`` and ``steps <=
100``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import simulator as jsim
from repro.scenario import spec as JSP
from repro.scenario import suite as JS
import repro_torch.core as T
from repro_torch.core import simulator as tsim
from repro_torch.fl import strategies as tstrat
from repro_torch.scenario import spec as TSP
from repro_torch.scenario import suite as TS

ROOT = Path(__file__).resolve().parents[1]
CONSTS = dict(L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0, eps=1.0)
JC, TC = J.LearningConstants(**CONSTS), T.LearningConstants(**CONSTS)


def _net(n, seed, *, lo=0.5, hi=6.0, with_cs=False):
    """``tests/test_scenario.py::small_network``'s draws (uniform routing)
    as both packages' ``NetworkParams``."""
    rng = np.random.default_rng(seed)
    leaves = {"mu_c": rng.uniform(lo, hi, n), "mu_d": rng.uniform(lo, hi, n),
              "mu_u": rng.uniform(lo, hi, n)}
    if with_cs:
        leaves["mu_cs"] = float(rng.uniform(1.0, 4.0))
    j = JSP.NetworkSpec(**leaves).params()
    t = TSP.NetworkSpec(**leaves).params(device="cpu")
    return j, t


def _power(n, seed):
    rng = np.random.default_rng(seed)
    leaves = {k: rng.uniform(0.5, 3.0, n) for k in ("P_c", "P_u", "P_d")}
    return (J.PowerProfile(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            T.PowerProfile(**{k: torch.as_tensor(v) for k, v in
                              leaves.items()}))


def _same_sweep(got, want):
    np.testing.assert_array_equal(got.m_grid, want.m_grid)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-6)
    assert isinstance(got.p, torch.Tensor)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    _same_opt(got.best, want.best)


def _same_opt(got, want, *, history=True):
    assert got.m == want.m
    assert got.value == pytest.approx(want.value, rel=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    if history:
        assert [m for m, _ in got.history] == [m for m, _ in want.history]
        np.testing.assert_allclose([v for _, v in got.history],
                                   [v for _, v in want.history], rtol=1e-6)


# ---------------------------------------------------------------------------
# pruned_concurrency_sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["pruned", "tiny_grid"])
def test_pruned_matches_jax(case):
    """JAX's own case (``tests/test_scenario.py:241``): n = 6, m_max = 20;
    the grid 2..20 prunes to 12 rows, 2..6 falls back to the full sweep."""
    jp, tp = _net(6, 3)
    m_max = 20
    grid = np.arange(2, 21) if case == "pruned" else np.arange(2, 7)
    steps = 120 if case == "pruned" else 50
    want = J.pruned_concurrency_sweep(
        J.make_time_objective_padded(jp, JC, m_max), jp,
        m_grid=jnp.asarray(grid), m_max=m_max, steps=steps)
    got = T.pruned_concurrency_sweep(
        T.make_time_objective_padded(tp, TC, m_max), tp, m_grid=grid,
        m_max=m_max, steps=steps, backend="torch")
    _same_sweep(got, want)
    if case == "pruned":
        assert len(got.values) == 12 < len(grid)
    else:
        assert len(got.values) == 5


def test_pruned_defaults_m_max_from_objective():
    """The refine window's smaller grid must not trip the padding guard
    when the caller omits m_max (``tests/test_scenario.py:261``)."""
    jp, tp = _net(4, 6)
    want = J.pruned_concurrency_sweep(
        J.make_time_objective_padded(jp, JC, 20), jp,
        m_grid=jnp.arange(2, 21), steps=30)
    got = T.pruned_concurrency_sweep(
        T.make_time_objective_padded(tp, TC, 20), tp,
        m_grid=torch.arange(2, 21), steps=30, backend="torch")
    _same_sweep(got, want)


def test_pruned_ctx_grid_matches_jax():
    """A per-row context rides along the grid: the joint objective with a
    different rho on every row, subset with the coarse and refine rows."""
    jp, tp = _net(5, 7)
    jpw, tpw = _power(5, 8)
    m_max = 16
    grid = np.arange(1, m_max + 1)
    rho = np.linspace(0.05, 0.6, grid.size)
    want = J.pruned_concurrency_sweep(
        J.make_joint_objective_padded(jp, JC, jpw, 30.0, 60.0, m_max), jp,
        m_grid=jnp.asarray(grid), ctx=jnp.asarray(rho), m_max=m_max,
        steps=80)
    got = T.pruned_concurrency_sweep(
        T.make_joint_objective_padded(tp, TC, tpw, 30.0, 60.0, m_max), tp,
        m_grid=grid, ctx=torch.as_tensor(rho), m_max=m_max, steps=80,
        backend="torch")
    _same_sweep(got, want)
    assert len(got.values) < grid.size


@pytest.mark.parametrize("grid", [np.array([2, 4, 3, 5]),
                                  np.arange(2, 8).reshape(2, 3),
                                  np.array([], dtype=np.int64)])
def test_pruned_guards_raise_as_jax(grid):
    jp, tp = _net(3, 1)
    obj_j = J.make_time_objective_padded(jp, JC, 8)
    obj_t = T.make_time_objective_padded(tp, TC, 8)
    with pytest.raises(ValueError) as want:
        J.pruned_concurrency_sweep(obj_j, jp, m_grid=grid, steps=1)
    with pytest.raises(ValueError) as got:
        T.pruned_concurrency_sweep(obj_t, tp, m_grid=grid, steps=1)
    assert str(got.value) == str(want.value)


def test_time_optimal_classes_pruned_matches_jax():
    """Table 1 as classes (n = 100), m_max = 20, through the pruned search;
    ``search="sequential"`` raises JAX's message."""
    jcls = JSP.ClassSpec.from_clusters(JSP.PAPER_CLUSTERS_TABLE1).class_params()
    tcls = TSP.ClassSpec.from_clusters(TSP.PAPER_CLUSTERS_TABLE1).class_params(
        device="cpu")
    jc, tc = JSP.LearningSpec().consts, TSP.LearningSpec().consts
    want = J.time_optimal_classes(jcls, jc, 20, search="pruned", steps=40,
                                  backend="jnp")
    got = T.time_optimal_classes(tcls, tc, 20, search="pruned", steps=40,
                                 backend="torch")
    _same_opt(got, want)
    assert len(got.history) < 19
    for fn, cls, c in ((J.time_optimal_classes, jcls, jc),
                       (T.time_optimal_classes, tcls, tc)):
        with pytest.raises(ValueError) as err:
            fn(cls, c, 20, search="sequential")
        assert str(err.value) == ("unknown search mode: 'sequential'; "
                                  "expected 'batched' or 'pruned'")


# ---------------------------------------------------------------------------
# pareto_sweep
# ---------------------------------------------------------------------------

def test_pareto_sweep_matches_jax():
    jp, tp = _net(5, 9)
    jpw, tpw = _power(5, 10)
    rhos, m_max = (0.0, 0.3, 1.0), 8
    jraw, jper = J.pareto_sweep(jp, JC, jpw, rhos, 25.0, 40.0, m_max=m_max,
                                steps=100)
    traw, tper = T.pareto_sweep(tp, TC, tpw, rhos, 25.0, 40.0, m_max=m_max,
                                steps=100, backend="torch")
    np.testing.assert_array_equal(traw.m_grid,
                                  np.tile(np.arange(1, m_max + 1), 3))
    _same_sweep(traw, jraw)
    assert len(tper) == len(jper) == 3
    for got, want in zip(tper, jper):
        _same_opt(got, want)
    assert tper[-1].m == 1  # all energy weight: one task in flight


# ---------------------------------------------------------------------------
# sequential_concurrency_search, every search= of the optimizers, and the
# strategy registry
# ---------------------------------------------------------------------------

SEARCH_KW = dict(m_max=8, steps=60)


@pytest.fixture(scope="module")
def seq_case():
    """n = 4 clients with a power profile (time m* = 4, joint m* = 3) and
    the JAX package's sequential searches on it, the two calls its
    strategies make: ``time_optimal`` (``time_opt``), then ``joint_optimal``
    at the scenario's rho with tau* at that optimum (``joint``), both at
    the default patience 2.  JAX compiles once per visited m, so the
    sequential cases share these runs."""
    rng = np.random.default_rng(34)
    vec = {k: rng.uniform(0.5, 6.0, 4) for k in ("mu_c", "mu_d", "mu_u")}
    en = {k: rng.uniform(0.5, 3.0, 4) for k in ("kappa", "P_u", "P_d")}
    jscn = JSP.Scenario(network=JSP.NetworkSpec(**vec),
                        energy=JSP.EnergySpec(**en),
                        strategy=JSP.StrategySpec("time_opt",
                                                  search="sequential",
                                                  **SEARCH_KW))
    jp, jc, jpw = jscn.params(), jscn.consts, jscn.power()
    time_opt = J.time_optimal(jp, jc, search="sequential", **SEARCH_KW)
    tau_star = float(J.wallclock_time(jp._replace(p=time_opt.p), time_opt.m,
                                      jc))
    e_star = float(J.minimal_energy(jp, jc, jpw))
    joint = J.joint_optimal(jp, jc, jpw, jscn.objective.rho, tau_star,
                            e_star, search="sequential", **SEARCH_KW)
    return {"jscn": jscn, "tscn": TSP.Scenario.from_dict(jscn.to_dict()),
            "time_opt": time_opt, "joint": joint}


@pytest.mark.parametrize("patience", [1, 2])
def test_sequential_search_matches_jax(seq_case, patience):
    """The visited m, the values, p, and the early stop at ``patience``:
    at 2 the JAX run itself; at 1 the same warm-started trace, cut one
    m after the optimum."""
    want = seq_case["time_opt"]
    tscn = seq_case["tscn"]
    got = T.sequential_concurrency_search(
        T.make_time_objective(tscn.params(device="cpu"), tscn.consts), 4,
        m_start=2, patience=patience, device="cpu", **SEARCH_KW)
    visited = [m for m, _ in got.history]
    assert visited[-1] == got.m + patience < SEARCH_KW["m_max"]
    cut = len(visited)
    _same_opt(got, dataclasses.replace(want, history=want.history[:cut]))
    assert got.p.device.type == "cpu"


def test_sequential_search_takes_p_init_device():
    jp, tp = _net(3, 12)
    p0 = np.random.default_rng(0).dirichlet(np.ones(3))
    want = J.sequential_concurrency_search(
        J.make_round_objective(jp, JC), 3, m_start=0, m_max=2, steps=40,
        p_init=jnp.asarray(p0))
    got = T.sequential_concurrency_search(
        T.make_round_objective(tp, TC), 3, m_start=0, m_max=2, steps=40,
        p_init=torch.as_tensor(p0))
    _same_opt(got, want)
    assert [m for m, _ in got.history] == [1, 2]  # from max(m_start, 1)
    assert got.p.device.type == "cpu"


@pytest.mark.parametrize("search", ["batched", "pruned", "sequential"])
def test_time_optimal_every_search_matches_jax(seq_case, search):
    """Every ``search=`` of ``time_optimal`` with ``patience`` passed: the
    batched and pruned paths drop it, as JAX's do."""
    jscn, tscn = seq_case["jscn"], seq_case["tscn"]
    kw = dict(search=search, patience=2, **SEARCH_KW)
    want = (seq_case["time_opt"] if search == "sequential" else
            J.time_optimal(jscn.params(), jscn.consts, **kw))
    got = T.time_optimal(tscn.params(device="cpu"), tscn.consts, **kw)
    _same_opt(got, want)
    assert got.p.device.type == "cpu"


@pytest.mark.parametrize("search", ["batched", "pruned", "sequential"])
def test_joint_optimal_every_search_matches_jax(search):
    """JAX's check (``tests/test_batched_optimizer.py:147``): n = 4,
    rho 0.3, ``patience=100`` passed to every search; the sequential
    search visits every m and lands on the batched m."""
    rng = np.random.default_rng(13)
    p = rng.dirichlet(np.ones(4))
    leaves = {k: rng.uniform(0.3, 8.0, 4) for k in ("mu_c", "mu_d", "mu_u")}
    kappa, P_u, P_d = (rng.uniform(0.1, 2.0, 4), rng.uniform(1.0, 5.0, 4),
                       rng.uniform(1.0, 5.0, 4))
    jp = J.NetworkParams(p=jnp.asarray(p),
                         **{k: jnp.asarray(v) for k, v in leaves.items()})
    tp = T.NetworkParams(p=torch.as_tensor(p),
                         **{k: torch.as_tensor(v) for k, v in leaves.items()})
    jpw = J.PowerProfile.from_dvfs(jnp.asarray(kappa), jp.mu_c,
                                   jnp.asarray(P_u), jnp.asarray(P_d))
    tpw = T.PowerProfile.from_dvfs(torch.as_tensor(kappa), tp.mu_c,
                                   torch.as_tensor(P_u), torch.as_tensor(P_d))
    kw = dict(m_max=4 if search == "sequential" else 8, steps=100,
              patience=100)
    want = J.joint_optimal(jp, JC, jpw, 0.3, 10.0, 100.0, search=search,
                           **kw)
    got = T.joint_optimal(tp, TC, tpw, 0.3, 10.0, 100.0, search=search,
                          **kw)
    _same_opt(got, want)
    if search == "sequential":
        bat = T.joint_optimal(tp, TC, tpw, 0.3, 10.0, 100.0, **kw)
        assert got.m == bat.m
        assert [m for m, _ in got.history] == [1, 2, 3, 4]


@pytest.mark.parametrize("fn", ["time_optimal", "joint_optimal"])
def test_unknown_search_raises_as_jax(fn):
    jp, tp = _net(3, 14)
    jpw, tpw = _power(3, 15)
    messages = []
    for P, p, c, pw in ((J, jp, JC, jpw), (T, tp, TC, tpw)):
        args = (p, c) if fn == "time_optimal" else (p, c, pw, 0.1, 1.0, 1.0)
        with pytest.raises(ValueError) as err:
            getattr(P, fn)(*args, m_max=4, search="grid")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("search", ["pruned", "sequential"])
def test_strategies_resolve_every_search_as_jax(seq_case, search):
    """``StrategySpec(search=...)`` through ``resolve_strategy``
    (``time_opt``, then ``joint`` reusing its tau* through the shared
    cache) against the JAX package: its resolvers for ``pruned``, the
    calls they make for ``sequential`` (``seq_case``).
    ``make_strategies(search=...)`` gives the same."""
    jscn = seq_case["jscn"].with_strategy("time_opt", search=search,
                                          **SEARCH_KW)
    tscn = TSP.Scenario.from_dict(jscn.to_dict())
    jshared, tshared = ({}, {}), ({}, {})
    got = {}
    for name in ("time_opt", "joint"):
        if search == "sequential":
            want = (seq_case[name].p, seq_case[name].m)
        else:
            resolved, cache = jshared
            want = resolved[name] = JS.resolve_strategy(
                jscn.with_strategy(name), resolved=resolved, cache=cache)
        resolved, cache = tshared
        got[name] = resolved[name] = TS.resolve_strategy(
            tscn.with_strategy(name), resolved=resolved, cache=cache,
            device="cpu")
        assert got[name][1] == want[1]
        np.testing.assert_allclose(got[name][0], np.asarray(want[0]),
                                   atol=1e-6)
    made = tstrat.make_strategies(tscn.params(device="cpu"), tscn.consts,
                                  tscn.power(device="cpu"),
                                  rho=tscn.objective.rho, search=search,
                                  which=("time_opt", "joint"), **SEARCH_KW)
    for name in ("time_opt", "joint"):
        assert made[name][1] == got[name][1]
        np.testing.assert_array_equal(made[name][0], got[name][0])


# ---------------------------------------------------------------------------
# jump_chain_throughput
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_cs", [False, True])
def test_jump_chain_throughput_matches_jax(with_cs):
    """The same seed gives the JAX package's run: lambda and the mean
    counts within rtol 1e-12; the counts sum to m."""
    jp, tp = _net(5, 17, with_cs=with_cs)
    m, steps = 7, 1500
    lw, cw = jsim.jump_chain_throughput(jp, m, steps, seed=3)
    lg, cg = tsim.jump_chain_throughput(tp, m, steps, seed=3)
    assert isinstance(lg, float) and isinstance(cg, np.ndarray)
    assert cg.shape == (15,)
    np.testing.assert_allclose(lg, lw, rtol=1e-12)
    np.testing.assert_allclose(cg, np.asarray(cw), rtol=1e-12, atol=1e-12)
    if not with_cs:
        np.testing.assert_allclose(cg.sum(), m, rtol=1e-9)
    # the wrapped call, with the update counts it derives from the budget
    total = steps // (4 if with_cs else 3)
    st = T.simulate_stats(tp, m, total - total // 3, warmup=total // 3,
                          seed=3)
    assert lg == float(st.throughput)
    np.testing.assert_array_equal(cg, st.mean_queue_counts[:-1].numpy())
    assert int(st.delay_counts.sum()) == total - total // 3


# ---------------------------------------------------------------------------
# exports and the example
# ---------------------------------------------------------------------------

def test_core_exports_every_name_of_the_jax_package():
    missing = [name for name in J.__all__ if not hasattr(T, name)]
    assert missing == []


def test_joint_energy_example_small():
    spec = importlib.util.spec_from_file_location(
        "joint_energy_opt_torch", ROOT / "examples" / "joint_energy_opt_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu", steps=20)
    ms = [row["m"] for row in out["frontier"]]
    assert [row["rho"] for row in out["frontier"]] == list(mod.RHOS)
    assert ms[-1] == 1
    assert all(a >= b for a, b in zip(ms, ms[1:]))
    assert out["m_star"] >= 2 and out["e_star"] > 0
