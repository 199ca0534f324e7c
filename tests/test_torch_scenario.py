"""The port's Scenario API (``repro_torch.scenario``) against the JAX
package's (``repro.scenario``).

1. JSON: the same constructor calls in both packages give the same
   ``to_json()`` string and the same ``hash()``; each package's dict
   rebuilds the other's scenario; ``from_dict(to_dict())`` is bitwise.
2. What the port lacks raises at construction, listing its options: an
   unregistered law (all four of the JAX package's laws load), the
   ``pallas`` backend, ``interpret``; a ``sharded`` scenario loads with
   the JAX ``hash()``.
3. Eager validation and the step-size rules, as ``tests/test_scenario.py``.
4. Strategy resolution on Table 1 at scale 10 with its power profile,
   ``steps=40``, against JAX at the sweep tests' tolerances (m exact,
   values ``rel 1e-6``, p ``atol 1e-6``, ``energy_opt`` ``rtol 1e-10``);
   class resolution; ``joint_optimal`` on both Buzen backends.
5. ``stack``, ``build_power_profile``, both trainers' ``from_scenario`` and
   ``examples/quickstart_torch.py``.
"""
import dataclasses
import importlib.util
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import complexity as jcx
from repro.core import jackson as jjk
from repro.core import optimize as jopt
from repro.fl import engine as jeng
from repro.fl import models as jmodels
from repro.fl import strategies as jstrat
from repro.fl import trainer as jtrainer
from repro.scenario import spec as J
from repro.scenario import suite as JS
from repro_torch.core import complexity as tcx
from repro_torch.core import energy as tenergy
from repro_torch.core import optimize as topt
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import engine as teng
from repro_torch.fl import models as tmodels
from repro_torch.fl import strategies as tstrat
from repro_torch.fl import trainer as ttrainer
from repro_torch.scenario import spec as T
from repro_torch.scenario import suite as TS

ROOT = Path(__file__).resolve().parents[1]
SIX = ("asyncsgd", "max_throughput", "round_opt", "time_opt", "energy_opt",
       "joint")
STEPS = 40


# ---------------------------------------------------------------------------
# 1. JSON and hash parity
# ---------------------------------------------------------------------------

def _build(S, case: str):
    """One scenario per case, from the same calls on spec module ``S``
    (``J`` for the JAX package, ``T`` for the port)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 5

    def vec(lo=0.5, hi=6.0, k=n):
        return rng.uniform(lo, hi, k)

    net = S.NetworkSpec(mu_c=vec(), mu_d=vec(), mu_u=vec(),
                        p=rng.dirichlet(np.ones(n)),
                        labels=tuple("abcde"))
    energy = S.EnergySpec(kappa=vec(0.1, 2.0), P_u=vec(0.5, 3.0),
                          P_d=vec(0.5, 3.0))
    kw = {}
    if case == "per_client":
        pass
    elif case == "classes":
        net = S.NetworkSpec(classes=S.ClassSpec(
            mu_c=vec(k=3), mu_d=vec(k=3), mu_u=vec(k=3), count=[4, 1, 7],
            p=vec(0.01, 0.1, 3), labels=("x", "y", "z")))
        energy = S.EnergySpec(kappa=vec(0.1, 2.0, 3), P_u=vec(0.5, 3.0, 3),
                              P_d=vec(0.5, 3.0, 3))
        kw["strategy"] = S.StrategySpec("time_opt", m_max=20, steps=17)
    elif case == "classes_mu_cs":
        net = S.NetworkSpec.from_clusters(S.PAPER_CLUSTERS_TABLE1,
                                          mu_cs=3.25, aggregate=True)
    elif case == "mu_cs":
        net = dataclasses.replace(net, mu_cs=float(rng.uniform(1, 4)))
        energy = dataclasses.replace(energy, P_cs=0.75)
    elif case == "table1":
        net = S.NetworkSpec.from_clusters(S.PAPER_CLUSTERS_TABLE1, 10)
        energy = S.EnergySpec.from_clusters(S.PAPER_CLUSTERS_TABLE1, 10)
    elif case in ("deterministic", "lognormal", "hyperexponential"):
        net = dataclasses.replace(net, law=case)
    elif case.startswith("strategy_"):
        kw["strategy"] = S.StrategySpec(case[9:], steps=17, m_max=n + 3,
                                        search="pruned")
    elif case.startswith("objective_"):
        kw["objective"] = S.ObjectiveSpec(case[10:],
                                          rho=float(rng.uniform()))
    elif case == "explicit":
        kw["strategy"] = S.StrategySpec(S.EXPLICIT,
                                        p=rng.dirichlet(np.ones(n)), m=3)
    elif case == "sim":
        kw["sim"] = S.SimSpec(backend="batched", chunk=8,
                              trace=S.TraceSpec(events=64, updates=32,
                                                tolerance=0.125))
    elif case == "sim_default":
        kw["sim"] = S.SimSpec()
    elif case == "data":
        kw["data"] = S.DataSpec(dataset="emnist", partition="dirichlet",
                                alpha=0.3, num_classes=47,
                                samples_per_class=200, test_fraction=0.2,
                                seed=3)
    elif case == "named":
        kw["name"] = "a cosmetic name"
    else:
        raise AssertionError(case)
    learning = S.LearningSpec(
        consts=S.LearningSpec().consts._replace(M=float(rng.uniform(1, 3))),
        eta=float(rng.uniform(0.01, 0.1)), grad_clip=5.0)
    return S.Scenario(network=net, learning=learning, energy=energy, **kw)


CASES = (["per_client", "classes", "classes_mu_cs", "mu_cs", "table1",
          "deterministic", "lognormal", "hyperexponential", "explicit",
          "sim", "sim_default", "data", "named"]
         + [f"strategy_{s}" for s in SIX]
         + [f"objective_{o}" for o in ("time", "round", "throughput",
                                       "energy", "joint")])


def _same_spec(a, b):
    """Field by field, bitwise: arrays by value and shape, the rest by
    ``==`` (recursing into sub-specs and named tuples)."""
    assert type(a).__name__ == type(b).__name__
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_spec(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            _same_spec(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert a.shape == b.shape
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("case", CASES)
def test_json_and_hash_match_jax(case):
    j, t = _build(J, case), _build(T, case)
    assert t.to_json() == j.to_json()
    assert t.hash() == j.hash()
    # each package's dict rebuilds the other's scenario
    t2 = T.Scenario.from_dict(j.to_dict())
    assert t2 == t and t2.to_json() == j.to_json()
    _same_spec(t2, t)
    assert J.Scenario.from_dict(t.to_dict()).to_json() == t.to_json()
    # round trip through JSON text, bitwise
    t3 = T.Scenario.from_json(t.to_json())
    assert t3 == t and t3.hash() == t.hash()
    _same_spec(t3, t)
    # only plain JSON types: no numpy scalar leaks into the dict
    _plain_json(t.to_dict())


def _plain_json(x):
    if isinstance(x, dict):
        for k, v in x.items():
            assert type(k) is str
            _plain_json(v)
    elif isinstance(x, list):
        for v in x:
            _plain_json(v)
    else:
        assert type(x) in (str, int, float, bool, type(None)), type(x)


def test_hash_ignores_name_and_keys_are_absent_at_defaults():
    t = _build(T, "per_client")
    assert t.replace(name="x").hash() == t.hash()
    assert t.with_strategy("round_opt").hash() != t.hash()
    d = t.to_dict()
    assert "classes" not in d["network"]
    assert "sim" not in d and "data" not in d
    sim = T.SimSpec(backend="kernel").to_dict()
    assert sim == {"backend": "kernel", "interpret": None}


# ---------------------------------------------------------------------------
# 2. what the port lacks raises, listing its options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law", ["lognormal", "hyperexponential"])
def test_unported_laws_raise_listing_the_ports(law):
    # the law loads from the JAX package's dict, with its JSON and hash;
    # an unregistered name raises listing the four registered laws
    d = dataclasses.replace(_build(J, "per_client").network,
                            law=law).to_dict()
    got = T.NetworkSpec.from_dict(d)
    assert got.law == law and got.to_dict() == d
    unknown = {"lognormal": "weibull", "hyperexponential": "pareto"}[law]
    with pytest.raises(ValueError, match=r"registered service distributions:"
                       r" \['deterministic', 'exponential', "
                       r"'hyperexponential', 'lognormal'\]"):
        T.NetworkSpec.from_dict({**d, "law": unknown})


@pytest.mark.parametrize("backend", ["pallas"])
def test_unported_backends_raise_listing_the_ports(backend):
    d = _build(J, "per_client").replace(sim=J.SimSpec(backend=backend))
    with pytest.raises(ValueError, match=r"registered backends: "
                       r"\['batched', 'kernel', 'reference', 'sharded'\]"):
        T.Scenario.from_dict(d.to_dict())


def test_sharded_backend_loads_with_the_jax_hash():
    d = _build(J, "per_client").replace(sim=J.SimSpec(backend="sharded"))
    got = T.Scenario.from_dict(d.to_dict())
    assert got.sim.backend == "sharded" and got.sim_backend == "sharded"
    assert got.to_dict() == d.to_dict()
    assert got.to_json() == d.to_json() and got.hash() == d.hash()


@pytest.mark.parametrize("interpret", [True, False])
def test_interpret_raises(interpret):
    d = _build(J, "per_client").replace(sim=J.SimSpec(interpret=interpret))
    with pytest.raises(ValueError, match="interpret"):
        T.Scenario.from_dict(d.to_dict())


# ---------------------------------------------------------------------------
# 3. eager validation and eta (mirrors of tests/test_scenario.py)
# ---------------------------------------------------------------------------

def _small_network(S, n=4, seed=0, law="exponential"):
    rng = np.random.default_rng(seed)
    return S.NetworkSpec(mu_c=rng.uniform(0.5, 6.0, n),
                         mu_d=rng.uniform(0.5, 6.0, n),
                         mu_u=rng.uniform(0.5, 6.0, n), law=law)


def test_eager_validation_everywhere():
    with pytest.raises(ValueError, match="exponential"):
        _small_network(T, law="weibull")
    with pytest.raises(ValueError, match="time_opt"):
        T.StrategySpec("frobnicate")
    with pytest.raises(ValueError, match="joint"):
        T.ObjectiveSpec("frobnicate")
    with pytest.raises(ValueError, match="registered service distributions"):
        ttrainer.AsyncFLConfig(distribution="weibull")
    with pytest.raises(ValueError, match="search mode"):
        T.StrategySpec("time_opt", search="bisect")
    with pytest.raises(ValueError, match="registered datasets"):
        T.DataSpec(dataset="cifar")
    with pytest.raises(ValueError, match="registered partitions"):
        T.DataSpec(partition="round_robin")


@pytest.mark.parametrize("bad", [
    lambda S: S.Scenario(network=_small_network(S),
                         strategy=S.StrategySpec("joint")),
    lambda S: S.Scenario(network=_small_network(S),
                         strategy=S.StrategySpec("energy_opt")),
    lambda S: S.Scenario(network=_small_network(S), energy=S.EnergySpec(
        kappa=[1.0] * 3, P_u=[1.0] * 3, P_d=[1.0] * 3)),
    lambda S: S.NetworkSpec(mu_c=[1.0, -1.0], mu_d=[1.0, 1.0],
                            mu_u=[1.0, 1.0]),
    lambda S: S.NetworkSpec(mu_c=[1.0, 1.0], mu_d=[1.0], mu_u=[1.0, 1.0]),
    lambda S: S.ClassSpec(mu_c=[1.0], mu_d=[1.0], mu_u=[1.0], count=[0]),
    lambda S: S.TraceSpec(events=-1),
    lambda S: S.SimSpec(chunk=0),
], ids=["joint", "energy_opt", "energy_len", "rate_sign", "rate_len",
        "count_0", "trace", "chunk"])
def test_the_same_bad_input_raises_the_same_in_both(bad):
    with pytest.raises(ValueError) as want:
        bad(J)
    with pytest.raises(ValueError) as got:
        bad(T)
    assert str(got.value) == str(want.value)


def test_explicit_strategy_requires_p_and_m():
    with pytest.raises(ValueError, match="explicit"):
        T.StrategySpec(T.EXPLICIT, m=3)


def test_eta_defaults_follow_strategy():
    net = _small_network(T, 3)
    assert T.Scenario(network=net, strategy=T.StrategySpec(
        "max_throughput")).eta() == pytest.approx(0.01)
    assert T.Scenario(network=net).eta() == pytest.approx(0.05)
    s = T.Scenario(network=net, learning=T.LearningSpec(eta=0.123),
                   strategy=T.StrategySpec("max_throughput"))
    assert s.eta() == pytest.approx(0.123)


def test_with_strategy_explicit_freezes_resolved_eta():
    net = _small_network(T, 3, seed=9)
    scn = T.Scenario(network=net, strategy=T.StrategySpec("max_throughput"))
    pinned = scn.with_strategy(T.EXPLICIT, p=np.full(3, 1 / 3), m=2)
    assert pinned.eta() == pytest.approx(0.01)
    assert pinned.name == "explicit"
    scn2 = T.Scenario(network=net, learning=T.LearningSpec(eta=0.2),
                      strategy=T.StrategySpec("max_throughput"))
    assert scn2.with_strategy(T.EXPLICIT, p=np.full(3, 1 / 3),
                              m=2).eta() == pytest.approx(0.2)
    # the same rewrite in the JAX package gives the same JSON
    jscn = J.Scenario(network=_small_network(J, 3, seed=9),
                      strategy=J.StrategySpec("max_throughput"))
    assert (jscn.with_strategy(J.EXPLICIT, p=np.full(3, 1 / 3), m=2)
            .to_json() == pinned.to_json())


def test_fl_config_and_tensors_on_the_device_asked_for():
    t = _build(T, "mu_cs").replace(sim=T.SimSpec(backend="kernel"))
    cfg = t.fl_config(batch_size=16)
    assert (cfg.eta, cfg.grad_clip, cfg.batch_size, cfg.distribution) == (
        t.learning.eta, 5.0, 16, "exponential")
    assert t.sim_backend == "kernel" and t.trace is None
    prm, pw = t.params(device="cpu"), t.power(device="cpu")
    assert prm.p.device.type == "cpu" and pw.P_cs.device.type == "cpu"
    assert isinstance(t.network.mu_c, np.ndarray)  # specs hold numpy


# ---------------------------------------------------------------------------
# 4. strategy resolution against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table1():
    """Table 1 at scale 10 with its power profile: JAX's and the port's
    ``make_strategies`` over the six strategies (``steps=40``)."""
    jnet = J.NetworkSpec.from_clusters(J.PAPER_CLUSTERS_TABLE1, 10)
    jen = J.EnergySpec.from_clusters(J.PAPER_CLUSTERS_TABLE1, 10)
    tnet = T.NetworkSpec.from_clusters(T.PAPER_CLUSTERS_TABLE1, 10)
    ten = T.EnergySpec.from_clusters(T.PAPER_CLUSTERS_TABLE1, 10)
    jc, tc = J.LearningSpec().consts, T.LearningSpec().consts
    want = jstrat.make_strategies(jnet.params(), jc, jen.profile(jnet),
                                  steps=STEPS, which=SIX)
    got = tstrat.make_strategies(tnet.params(device="cpu"), tc,
                                 ten.profile(tnet, device="cpu"),
                                 steps=STEPS, which=SIX)
    return {"jnet": jnet, "tnet": tnet, "jen": jen, "ten": ten, "jc": jc,
            "tc": tc, "want": want, "got": got}


def _tau(tnet, tc, p, m):
    prm = tnet.params(p, device="cpu")
    return float(tcx.wallclock_time(prm, m, tc))


def _jtau(jnet, jc, p, m):
    return float(jcx.wallclock_time(jnet.params(jnp.asarray(p)), m, jc))


@pytest.mark.parametrize("name", SIX)
def test_make_strategies_matches_jax(table1, name):
    (pw, mw), (pg, mg) = table1["want"][name], table1["got"][name]
    assert isinstance(pg, np.ndarray) and pg.dtype == np.float64
    assert mg == mw
    if name == "energy_opt":
        np.testing.assert_allclose(pg, np.asarray(pw), rtol=1e-10)
        return
    np.testing.assert_allclose(pg, np.asarray(pw), atol=1e-6)
    assert _tau(table1["tnet"], table1["tc"], pg, mg) == pytest.approx(
        _jtau(table1["jnet"], table1["jc"], pw, mw), rel=1e-6)


@pytest.mark.parametrize("name", SIX)
def test_resolve_strategy_matches_make_strategies_and_jax(table1, name):
    """``resolve_strategy`` on a Scenario gives what ``make_strategies``
    gives, bitwise (``joint`` alone runs its own ``time_optimal`` for
    tau*, the same sweep); JAX's ``resolve_strategy`` is checked at the
    sweep tolerances for the strategies that need no second sweep."""
    tscn = T.Scenario(network=table1["tnet"], energy=table1["ten"],
                      strategy=T.StrategySpec(name, steps=STEPS))
    p, m = TS.resolve_strategy(tscn, device="cpu")
    pg, mg = table1["got"][name]
    assert m == mg
    np.testing.assert_array_equal(p, pg)
    if name in ("asyncsgd", "energy_opt", "time_opt"):
        jscn = J.Scenario(network=table1["jnet"], energy=table1["jen"],
                          strategy=J.StrategySpec(name, steps=STEPS))
        pw, mw = JS.resolve_strategy(jscn)
        assert m == mw
        np.testing.assert_allclose(p, np.asarray(pw), atol=1e-6,
                                   rtol=1e-10 if name == "energy_opt" else 0)


def test_energy_opt_is_the_closed_form(table1):
    prm = table1["tnet"].params(device="cpu")
    want = tenergy.energy_optimal_routing(
        prm, table1["ten"].profile(table1["tnet"], device="cpu"))
    np.testing.assert_array_equal(table1["got"]["energy_opt"][0],
                                  want.numpy())


def test_joint_reuses_time_opt_tau_star(table1, monkeypatch):
    """``joint`` after ``time_opt`` runs no second ``time_optimal``; alone,
    it runs one; both give the same (p, m), and the JAX package's."""
    calls = []
    real = TS.time_optimal

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TS, "time_optimal", counting)
    prm = table1["tnet"].params(device="cpu")
    pw = table1["ten"].profile(table1["tnet"], device="cpu")
    both = tstrat.make_strategies(prm, table1["tc"], pw, steps=STEPS,
                                  which=("time_opt", "joint"))
    assert len(calls) == 1
    alone = tstrat.make_strategies(prm, table1["tc"], pw, steps=STEPS,
                                   which=("joint",))
    assert len(calls) == 2
    for got in (both["joint"], alone["joint"]):
        assert got[1] == table1["got"]["joint"][1]
        np.testing.assert_array_equal(got[0], table1["got"]["joint"][0])
    want = jstrat.make_strategies(
        table1["jnet"].params(), table1["jc"],
        table1["jen"].profile(table1["jnet"]), steps=STEPS, which=("joint",))
    assert alone["joint"][1] == want["joint"][1]
    np.testing.assert_allclose(alone["joint"][0], np.asarray(want["joint"][0]),
                               atol=1e-6)


def test_unported_searches_raise(table1):
    """The searches the port once refused now resolve: ``time_opt`` with
    ``search="pruned"`` (m = 2..17, the default bound) and ``joint`` with
    ``search="sequential"`` (m up to 2: JAX compiles once per m) on Table
    1 at scale 10, two Adam steps, equal the JAX package's resolution."""
    for name, search, m_max in (("time_opt", "pruned", None),
                                ("joint", "sequential", 2)):
        spec = dict(steps=2, search=search, m_max=m_max)
        jscn = J.Scenario(network=table1["jnet"], energy=table1["jen"],
                          strategy=J.StrategySpec(name, **spec))
        tscn = T.Scenario(network=table1["tnet"], energy=table1["ten"],
                          strategy=T.StrategySpec(name, **spec))
        assert tscn.to_json() == jscn.to_json()
        pw, mw = JS.resolve_strategy(jscn)
        p, m = TS.resolve_strategy(tscn, device="cpu")
        assert m == mw
        np.testing.assert_allclose(p, np.asarray(pw), atol=1e-6)


@pytest.mark.parametrize("name", ["asyncsgd", "time_opt"])
def test_class_resolution_matches_jax(name):
    kw = dict(m_max=20, steps=STEPS) if name == "time_opt" else {}
    jscn = J.Scenario(network=J.NetworkSpec.from_clusters(
        J.PAPER_CLUSTERS_TABLE1, aggregate=True),
        strategy=J.StrategySpec(name, **kw))
    tscn = T.Scenario.from_dict(jscn.to_dict())
    pw, mw = JS.resolve_strategy(jscn)
    p, m = TS.resolve_strategy(tscn, device="cpu")
    assert m == mw and p.shape == (5,)
    np.testing.assert_allclose(p, np.asarray(pw), atol=1e-6)
    if name == "time_opt":
        forced = tscn.with_strategy("time_opt", m=7)
        pf, mf = TS.resolve_strategy(forced, device="cpu")
        pj, mj = JS.resolve_strategy(jscn.with_strategy("time_opt", m=7))
        assert mf == mj == 7
        np.testing.assert_allclose(pf, np.asarray(pj), atol=1e-6)


def test_class_resolution_refusals():
    net = T.NetworkSpec.from_clusters(T.PAPER_CLUSTERS_TABLE1, aggregate=True)
    for strat in (T.StrategySpec("max_throughput"),
                  T.StrategySpec("round_opt")):
        with pytest.raises(ValueError, match="no class-space resolver"):
            TS.resolve_strategy(T.Scenario(network=net, strategy=strat),
                                device="cpu")
    with pytest.raises(ValueError, match="explicit"):
        TS.resolve_strategy(T.Scenario(network=net, strategy=T.StrategySpec(
            "time_opt")), device="cpu")


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_joint_optimal_matches_jax(backend):
    jnet = J.NetworkSpec.from_clusters(J.PAPER_CLUSTERS_TABLE1, 10)
    tnet = T.NetworkSpec.from_clusters(T.PAPER_CLUSTERS_TABLE1, 10)
    jen = J.EnergySpec.from_clusters(J.PAPER_CLUSTERS_TABLE1, 10)
    ten = T.EnergySpec.from_clusters(T.PAPER_CLUSTERS_TABLE1, 10)
    jc, tc = J.LearningSpec().consts, T.LearningSpec().consts
    tau_star, e_star = 5000.0, 30.0
    want = jopt.joint_optimal(jnet.params(), jc, jen.profile(jnet), 0.3,
                              tau_star, e_star, m_max=12, steps=STEPS)
    got = topt.joint_optimal(tnet.params(device="cpu"), tc,
                             ten.profile(tnet, device="cpu"), 0.3, tau_star,
                             e_star, m_max=12, steps=STEPS, backend=backend)
    assert got.m == want.m
    assert [m for m, _ in got.history] == list(range(1, 13))
    vg = np.array([v for _, v in got.history])
    vw = np.array([v for _, v in want.history])
    if backend == "torch":
        np.testing.assert_allclose(vg, vw, rtol=1e-6)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                                   atol=1e-6)
    else:  # float32 forward (plain version on the CPU), float64 backward
        np.testing.assert_allclose(vg, vw, rtol=1e-4)


# ---------------------------------------------------------------------------
# 5. stack, build_power_profile, from_scenario, the example
# ---------------------------------------------------------------------------

def _lane(S, seed, name="lane"):
    rng = np.random.default_rng(seed)
    net = S.NetworkSpec(mu_c=rng.uniform(1, 4, 3), mu_d=rng.uniform(1, 4, 3),
                        mu_u=rng.uniform(1, 4, 3),
                        p=rng.dirichlet(np.ones(3)),
                        mu_cs=float(rng.uniform(1, 4)))
    en = S.EnergySpec(kappa=rng.uniform(0.1, 1, 3), P_u=rng.uniform(1, 2, 3),
                      P_d=rng.uniform(1, 2, 3), P_cs=float(rng.uniform()))
    consts = S.LearningSpec().consts._replace(L=float(rng.uniform(1, 2)))
    return S.Scenario(network=net, learning=S.LearningSpec(consts=consts),
                      energy=en, strategy=S.StrategySpec(
                          S.EXPLICIT, p=rng.dirichlet(np.ones(3)), m=2),
                      name=name)


def test_stack_leaves_match_jax():
    want = J.stack([_lane(J, s) for s in range(3)])
    got = T.stack([_lane(T, s) for s in range(3)])
    assert got.network.mu_c.shape == (3, 3)
    assert got.network.mu_cs.shape == (3,)
    assert got.learning.consts.L.shape == (3,)
    _same_spec(got, want)


def test_stack_mixed_structure_raises():
    for S in (J, T):
        with pytest.raises(ValueError, match="mixed static structure"):
            S.stack([_lane(S, 0), _lane(S, 1, name="other")])
        with pytest.raises(ValueError, match="mixed static structure"):
            S.stack([_lane(S, 0), _lane(S, 1).replace(energy=None)])
        with pytest.raises(ValueError, match="at least one"):
            S.stack([])


@pytest.mark.parametrize("P_cs", [None, 0.5])
def test_build_power_profile_bitwise(P_cs):
    want = jstrat.build_power_profile(J.PAPER_CLUSTERS_TABLE1, 10, P_cs=P_cs)
    got = tstrat.build_power_profile(T.PAPER_CLUSTERS_TABLE1, 10, P_cs=P_cs,
                                     device="cpu")
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tstrat.PAPER_CLUSTERS_TABLE6 == T.PAPER_CLUSTERS_TABLE6
    assert [dataclasses.astuple(c) for c in T.PAPER_CLUSTERS_TABLE6] == [
        dataclasses.astuple(c) for c in J.PAPER_CLUSTERS_TABLE6]


def _fl_problem(S, n=4, sim=None, law="exponential"):
    rng = np.random.default_rng(5)
    net = S.NetworkSpec(mu_c=rng.uniform(1, 4, n), mu_d=rng.uniform(1, 4, n),
                        mu_u=rng.uniform(1, 4, n), law=law)
    en = S.EnergySpec(kappa=rng.uniform(0.1, 1, n), P_u=rng.uniform(1, 2, n),
                      P_d=rng.uniform(1, 2, n))
    return S.Scenario(network=net, energy=en,
                      learning=S.LearningSpec(grad_clip=5.0),
                      strategy=S.StrategySpec("energy_opt"), sim=sim)


def _clients(n=4):
    full = make_synthetic_image_dataset(num_classes=4, samples_per_class=16,
                                        image_size=8, seed=0)
    parts = iid_partition(full.y, n, seed=0)
    return [(full.x[i], full.y[i]) for i in parts], (full.x[::3],
                                                     full.y[::3])


def _cfg_fields(cfg):
    return {k: getattr(cfg, k) for k in (
        "eta", "batch_size", "distribution", "seed", "eval_every_time",
        "eval_batch", "grad_clip", "backend")}


def test_device_trainer_from_scenario_is_the_hand_built_one():
    clients, test = _clients()
    sim = T.SimSpec(backend="kernel", chunk=8)
    scn = _fl_problem(T, sim=sim)
    over = dict(batch_size=8, eval_every_time=2.0)
    torch.manual_seed(0)
    tr = teng.DeviceTrainer.from_scenario(
        scn, tmodels.mlp_classifier(64, 4, hidden=(16,), device="cpu"),
        clients, test_data=test, device="cpu", **over)
    hand = teng.DeviceTrainer(
        tmodels.mlp_classifier(64, 4, hidden=(16,), device="cpu"), clients,
        scn.params(device="cpu"), ttrainer.AsyncFLConfig(
            eta=0.05, grad_clip=5.0, **over),
        test_data=test, power=scn.power(device="cpu"), sim_backend="kernel",
        sim_chunk=8, device="cpu")
    assert (tr.sim_backend, tr.sim_chunk) == ("kernel", 8)
    assert _cfg_fields(tr.cfg) == _cfg_fields(hand.cfg)
    p, m = TS.resolve_strategy(scn, device="cpu")
    args = ([p, np.full(4, 0.25)], [m, 3], [0.05, 0.05], [0, 1], 20.0)
    logs_a, fin_a = tr.run_lanes(*args)
    logs_b, fin_b = hand.run_lanes(*args)
    assert torch.equal(fin_a, fin_b)
    for a, b in zip(logs_a, logs_b):
        assert a.updates[-1] > 3
        assert (a.times, a.losses, a.accuracies, a.updates, a.throughput,
                a.energy) == (b.times, b.losses, b.accuracies, b.updates,
                              b.throughput, b.energy)
        np.testing.assert_array_equal(a.mean_delay, b.mean_delay)

    # the wiring as the JAX package's from_scenario gives it
    jscn = _fl_problem(J, sim=J.SimSpec(backend="batched", chunk=8))
    jtr = jeng.DeviceTrainer.from_scenario(
        jscn, jmodels.mlp_classifier(64, 4, hidden=(16,)), clients,
        test_data=test, **over)
    ttr = teng.DeviceTrainer.from_scenario(
        T.Scenario.from_dict(jscn.to_dict()),
        tmodels.mlp_classifier(64, 4, hidden=(16,), device="cpu"), clients,
        test_data=test, device="cpu", **over)
    assert _cfg_fields(ttr.cfg) == _cfg_fields(jtr.cfg)
    assert (ttr.sim_backend, ttr.sim_chunk) == (jtr.sim_backend,
                                                jtr.sim_chunk)
    for a, b in zip(ttr.net, jtr.net):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ttr.power, jtr.power):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("law", ["lognormal", "hyperexponential"])
def test_device_trainer_from_scenario_runs_each_law(law):
    # the law reaches the trainer's event stream: the kernel route at E = 8
    # equals the hand-built batched trainer at E = 1, and the wiring is
    # the JAX package's
    clients, test = _clients()
    scn = _fl_problem(T, sim=T.SimSpec(backend="kernel", chunk=8), law=law)
    over = dict(batch_size=8, eval_every_time=4.0)
    tr = teng.DeviceTrainer.from_scenario(
        scn, tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu"),
        clients, test_data=test, device="cpu", **over)
    assert tr.cfg.distribution == law
    hand = teng.DeviceTrainer(
        tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu"), clients,
        scn.params(device="cpu"), ttrainer.AsyncFLConfig(
            eta=0.05, grad_clip=5.0, distribution=law, **over),
        test_data=test, power=scn.power(device="cpu"), sim_backend="batched",
        device="cpu")
    args = ([np.full(4, 0.25)] * 2, [3, 2], [0.05, 0.05], [0, 1], 12.0)
    logs_a, fin_a = tr.run_lanes(*args)
    logs_b, fin_b = hand.run_lanes(*args)
    assert torch.equal(fin_a, fin_b)
    for a, b in zip(logs_a, logs_b):
        assert a.updates[-1] > 3
        assert (a.updates, a.throughput, a.energy) == (b.updates,
                                                       b.throughput,
                                                       b.energy)
    jtr = jeng.DeviceTrainer.from_scenario(
        _fl_problem(J, law=law), jmodels.mlp_classifier(64, 4, hidden=(8,)),
        clients, test_data=test, **over)
    assert jtr.cfg.distribution == law


@pytest.mark.parametrize("trace", [dict(updates=16), dict(events=8)])
def test_device_trainer_from_scenario_refuses_rings(trace):
    """Once a refusal; now the trainer takes the spec's update-ring
    capacity (as the JAX package's, it keeps no event ring)."""
    clients, test = _clients()
    scn = _fl_problem(T, sim=T.SimSpec(trace=T.TraceSpec(**trace)))
    tr = teng.DeviceTrainer.from_scenario(
        scn, tmodels.mlp_classifier(64, 4, hidden=(16,), device="cpu"),
        clients, test_data=test, device="cpu")
    R = trace.get("updates", 0)
    assert tr.trace_updates == R and tr.last_update_rings is None
    logs, _ = tr.run_lanes([np.full(4, 0.25)] * 2, [3, 2], [0.05, 0.05],
                           [0, 1], 4.0)
    if R:
        assert len(tr.last_update_rings) == 2
        for ring, log in zip(tr.last_update_rings, logs):
            assert ring.time.shape == (R,)
            assert int(ring.count) == log.updates[-1] > 0
    else:
        assert tr.last_update_rings is None
    jtr = jeng.DeviceTrainer.from_scenario(
        J.Scenario.from_dict(scn.to_dict()),
        jmodels.mlp_classifier(64, 4, hidden=(16,)), clients,
        test_data=test)
    assert jtr.trace_updates == tr.trace_updates


def test_async_trainer_from_scenario_matches_jax():
    clients, test = _clients()
    jscn = _fl_problem(J)
    tscn = T.Scenario.from_dict(jscn.to_dict())
    jtr = jtrainer.AsyncFLTrainer.from_scenario(
        jscn, jmodels.mlp_classifier(64, 4, hidden=(16,)), clients,
        test_data=test, batch_size=8, backend="host")
    ttr = ttrainer.AsyncFLTrainer.from_scenario(
        tscn, tmodels.mlp_classifier(64, 4, hidden=(16,), device="cpu"),
        clients, test_data=test, device="cpu", batch_size=8, backend="host")
    assert ttr.m == jtr.m == 1
    np.testing.assert_allclose(ttr.net.p.numpy(), np.asarray(jtr.net.p),
                               rtol=1e-10)
    np.testing.assert_allclose(ttr.p, np.asarray(jtr.p), rtol=1e-10)
    assert _cfg_fields(ttr.cfg) == _cfg_fields(jtr.cfg)
    for a, b in zip(ttr.power, jtr.power):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quickstart_example_matches_jax():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main(device="cpu", steps=STEPS, updates=2_000)
    jnet = J.NetworkSpec.from_clusters(J.PAPER_CLUSTERS_TABLE1, 10)
    jp, jc = jnet.params(), J.LearningSpec().consts
    n = m = jnet.n
    assert (got["n"], got["m"]) == (n, m)
    np.testing.assert_allclose(
        got["delays"], np.asarray(jjk.expected_relative_delay(jp, m)),
        rtol=1e-10)
    assert got["lambda"] == pytest.approx(float(jjk.throughput(jp, m)),
                                          rel=1e-10)
    assert got["tau"] == pytest.approx(float(jcx.wallclock_time(jp, m, jc)),
                                       rel=1e-10)
    want = jopt.time_optimal(jp, jc, m_max=n + 6, steps=STEPS)
    assert got["m_star"] == want.m
    assert got["tau_star"] == pytest.approx(want.value, rel=1e-6)
    np.testing.assert_allclose(got["p_star"], np.asarray(want.p), atol=1e-6)
    # both simulators near Prop. 4 (2,000 updates)
    assert got["device_lambda"] == pytest.approx(got["lambda"], rel=0.1)
    assert got["host_lambda"] == pytest.approx(got["lambda"], rel=0.1)
    assert got["device"] == "cpu"
