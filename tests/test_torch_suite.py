"""The port's ``ScenarioSuite`` (``repro_torch.scenario.suite``) against the
JAX package's, and its bucketing and padding contract.

1. ``analyze`` on one mixed suite built from the same dicts in both
   packages (n = 3, 4, 6; a CS station; an energy spec; a class network;
   explicit, ``asyncsgd`` and ``time_opt`` strategies): explicit and
   ``asyncsgd`` rows within ``rtol 1e-10``, ``time_opt`` rows at the sweep
   tests' classes (m exact, p ``atol 1e-6``, values ``rel 1e-6``);
   ``programs``, ``lanes``, ``cache_hits`` and the metrics counters exact
   on a first run and a re-run.  Each row is bitwise its scenario
   evaluated alone at the bucket's table size (the padding contract,
   per-lane rates), and bitwise a suite of its own where that suite's
   table size is the bucket's (``rtol 1e-10`` where it is not).
2. ``simulate``: every lane bitwise ``simulate_stats_lanes`` (class lanes
   ``simulate_stats_classes_lanes``) of its scenario alone at the same
   seed, table size and chunk, on ``reference``, ``batched`` and
   ``kernel`` (plain versions on the CPU); ``programs`` equals JAX's; the
   law and backend bucket split (a hyperexponential bucket of two
   populations and a lognormal one, as the JAX package's
   ``test_suite_simulate_buckets_mixed_laws_separately``); the
   undersized-``m_max`` error.
3. ``train``: an exact bucket bitwise ``DeviceTrainer.run_lanes`` built by
   hand; a ``DataSpec`` bucket of n = 4 and 6 with each lane bitwise the
   scenario trained alone (the lanes share one task table, so alone means
   at the same ``m``).
4. Shared ``SuiteCaches``, ``to_dict`` parity, the ring refusals, and both
   examples' ``main`` on the CPU at a tiny size.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.scenario import spec as J
from repro.scenario import suite as JS
from repro_torch.core import events as tev
from repro_torch.core import prng
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import AsyncFLConfig, DeviceTrainer, mlp_classifier
from repro_torch.obs import Metrics
from repro_torch.scenario import spec as T
from repro_torch.scenario import suite as TS
from repro_torch.sim import (build_class_lanes_fn, build_lanes_fn,
                             simulate_stats_classes_lanes,
                             simulate_stats_lanes)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FIELDS = ("throughput", "K_eps", "tau", "energy", "value")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _net(S, rng, n, **kw):
    return S.NetworkSpec(mu_c=rng.uniform(0.5, 3, n),
                         mu_d=rng.uniform(0.5, 3, n),
                         mu_u=rng.uniform(0.5, 3, n), **kw)


def _mixed(S):
    """The mixed analyze suite's scenarios, from the same calls on spec
    module ``S`` (``J`` for the JAX package, ``T`` for the port)."""
    rng = np.random.default_rng(5)
    scns = {}
    for n, m in ((3, 4), (4, 2)):
        scns[f"n{n}"] = S.Scenario(network=_net(S, rng, n),
                                   strategy=S.StrategySpec(
                                       "explicit",
                                       p=rng.dirichlet(np.ones(n)), m=m))
    scns["n6"] = S.Scenario(network=_net(S, rng, 6),
                            strategy=S.StrategySpec("asyncsgd"))
    scns["cs"] = S.Scenario(network=_net(S, rng, 4, mu_cs=2.5),
                            strategy=S.StrategySpec("asyncsgd"))
    scns["energy"] = S.Scenario(
        network=_net(S, rng, 3),
        energy=S.EnergySpec(kappa=rng.uniform(0.1, 2, 3),
                            P_u=rng.uniform(0.5, 3, 3),
                            P_d=rng.uniform(0.5, 3, 3)),
        strategy=S.StrategySpec("explicit", p=rng.dirichlet(np.ones(3)),
                                m=3),
        objective=S.ObjectiveSpec("joint", rho=0.3))
    scns["classes"] = S.Scenario(
        network=S.NetworkSpec(classes=S.ClassSpec(
            mu_c=rng.uniform(0.5, 3, 2), mu_d=rng.uniform(0.5, 3, 2),
            mu_u=rng.uniform(0.5, 3, 2), count=[3, 2])),
        strategy=S.StrategySpec("asyncsgd"))
    scns["time_opt"] = S.Scenario(network=_net(S, rng, 5),
                                  strategy=S.StrategySpec(
                                      "time_opt", m_max=8, steps=12))
    return scns


@pytest.fixture(scope="module")
def analyze_pair():
    """``(jax suite, port suite, jax results, port results)``: a first run
    and a re-run of each."""
    jsuite = JS.ScenarioSuite(_mixed(J), seeds=(0, 1))
    tsuite = TS.ScenarioSuite(
        {k: T.Scenario.from_dict(v.to_dict()) for k, v in
         jsuite.scenarios.items()}, seeds=(0, 1), device="cpu")
    jres = [jsuite.run(mode="analyze"), jsuite.run(mode="analyze")]
    tres = [tsuite.run(mode="analyze"), tsuite.run(mode="analyze")]
    return jsuite, tsuite, jres, tres


def test_analyze_matches_jax(analyze_pair):
    jsuite, tsuite, jres, tres = analyze_pair
    j, t = jres[0], tres[0]
    assert set(t.entries) == set(j.entries) == set(tsuite.scenarios)
    for name, je in j.entries.items():
        te = t.entries[name]
        assert te["m"] == je["m"] and te["objective"] == je["objective"]
        assert te["eta"] == je["eta"]
        assert te["delays"].shape == np.asarray(je["delays"]).shape
        if name == "time_opt":
            np.testing.assert_allclose(te["p"], np.asarray(je["p"]),
                                       atol=1e-6)
            for f in FIELDS:
                if je[f] is not None:
                    assert te[f] == pytest.approx(je[f], rel=1e-6), f
            np.testing.assert_allclose(te["delays"], je["delays"],
                                       rtol=1e-6)
            continue
        np.testing.assert_array_equal(te["p"], np.asarray(je["p"]))
        for f in FIELDS:
            if je[f] is None:
                assert te[f] is None, f
            else:
                assert te[f] == pytest.approx(je[f], rel=1e-10), (name, f)
        np.testing.assert_allclose(te["delays"], je["delays"], rtol=1e-10,
                                   atol=1e-12)


def test_analyze_counters_match_jax(analyze_pair):
    _, tsuite, jres, tres = analyze_pair
    for j, t in zip(jres, tres):
        assert (t.programs, t.lanes, t.cache_hits) == \
            (j.programs, j.lanes, j.cache_hits)
        assert t.metrics["counters"] == j.metrics["counters"]
    assert tres[0].programs == 4 and tres[1].programs == 0
    assert tres[1].cache_hits == len(tsuite)
    # the re-run serves the very entries of the first run
    for name in tsuite.scenarios:
        assert tres[1].entries[name] is tres[0].entries[name]
    lat = tres[1].metrics["latency"]
    assert lat["suite.lanes_per_dispatch{mode=analyze}"]["count"] == 4
    assert lat["suite.run{mode=analyze}"]["count"] == 2


def _alone_at(tsuite, name, m_max):
    """``name`` evaluated alone (unpadded, one lane) by the bucket
    runner at table size ``m_max``."""
    scn = tsuite.scenarios[name]
    p, m = tsuite.resolve()[name]
    classes = scn.is_class_network
    prm = (scn.class_params(p, device="cpu") if classes
           else scn.params(p, device="cpu"))
    power = scn.power(device="cpu")
    fn = TS._build_analyze(m_max, power is not None, classes)
    out = fn(tev.stack_lanes([prm]), torch.tensor([m]),
             TS._stack_consts([scn.consts], CPU),
             None if power is None else tev.stack_lanes([power]),
             torch.tensor([scn.objective.rho], dtype=torch.float64))
    return {k: v[0].numpy() for k, v in out.items()}


def test_analyze_rows_bitwise_alone(analyze_pair):
    _, tsuite, _, tres = analyze_pair
    got = tres[0].entries
    ms = {k: m for k, (_, m) in tsuite.resolve().items()}
    bucket = {"n3": ("n3", "n4", "n6", "time_opt")}
    m_top = max(ms[k] for k in bucket["n3"])
    for name in tsuite.scenarios:
        table = m_top if name in bucket["n3"] else ms[name]
        want = _alone_at(tsuite, name, table)
        assert got[name]["tau"] == float(want["tau"]), name
        assert got[name]["K_eps"] == float(want["K_eps"]), name
        assert got[name]["throughput"] == float(want["throughput"]), name
        np.testing.assert_array_equal(got[name]["delays"], want["delays"])
        if "energy" in want:
            assert got[name]["energy"] == float(want["energy"])
        # a suite of its own: bitwise at the same table size, float64
        # roundoff apart otherwise (torch's reductions reassociate with
        # their length)
        solo = TS.ScenarioSuite({name: tsuite.scenarios[name]},
                                device="cpu").run(mode="analyze")
        s = solo.entries[name]
        if ms[name] == table:
            assert s["tau"] == got[name]["tau"], name
            np.testing.assert_array_equal(s["delays"], got[name]["delays"])
        for f in FIELDS:
            if s[f] is not None:
                assert s[f] == pytest.approx(got[name][f], rel=1e-10), f
        np.testing.assert_allclose(s["delays"], got[name]["delays"],
                                   rtol=1e-10, atol=1e-12)


def _class_bucket(S, counts, energy):
    """Class scenarios of ``counts[i]`` classes each, one analyze bucket
    (all at m = 3, so every row's table is its own)."""
    rng = np.random.default_rng(21)
    scns = {}
    for i, C in enumerate(counts):
        cnt = rng.integers(1, 4, C)
        kw = {}
        if energy:
            kw = dict(energy=S.EnergySpec(kappa=rng.uniform(0.1, 2, C),
                                          P_u=rng.uniform(0.5, 3, C),
                                          P_d=rng.uniform(0.5, 3, C)),
                      objective=S.ObjectiveSpec("joint", rho=0.3))
        scns[f"c{i}"] = S.Scenario(
            network=S.NetworkSpec(classes=S.ClassSpec(
                mu_c=rng.uniform(0.5, 3, C), mu_d=rng.uniform(2, 6, C),
                mu_u=rng.uniform(2, 6, C), count=cnt.tolist())),
            strategy=S.StrategySpec(
                "explicit", p=rng.dirichlet(np.ones(C)) / cnt, m=3), **kw)
    return scns


@pytest.mark.parametrize("counts,energy", [((3, 3, 3), False),
                                           ((3, 2), False),
                                           ((2, 2), True)])
def test_analyze_class_bucket_of_several_lanes(counts, energy):
    """Queue 3 item 9: the class K_eps divided each lane's class row by
    the stacked populations ``[L]`` broadcast along the class axis — wrong
    values when L == C, an error otherwise.  Every row of a class bucket
    must be bitwise its scenario alone and match the JAX suite."""
    jscns = _class_bucket(J, counts, energy)
    got = TS.ScenarioSuite(
        {k: T.Scenario.from_dict(v.to_dict()) for k, v in jscns.items()},
        device="cpu").run(mode="analyze")
    want = JS.ScenarioSuite(jscns).run(mode="analyze")
    assert got.programs == want.programs == 1
    for name, scn in jscns.items():
        solo = TS.ScenarioSuite({name: T.Scenario.from_dict(scn.to_dict())},
                                device="cpu").run(mode="analyze")
        for f in FIELDS:
            assert got.entries[name][f] == solo.entries[name][f], (name, f)
            if want.entries[name][f] is not None:
                assert got.entries[name][f] == pytest.approx(
                    want.entries[name][f], rel=1e-10), (name, f)
        np.testing.assert_array_equal(got.entries[name]["delays"],
                                      solo.entries[name]["delays"])


def test_analyze_torch_and_kernel_routes_agree():
    """The bucket's one DP call on the ``kernel`` route (float32 forward,
    its plain version on CPU tensors) against ``torch``."""
    from repro_torch.core import buzen

    scns = {k: T.Scenario.from_dict(v.to_dict())
            for k, v in _mixed(J).items() if k != "time_opt"}
    rows = {}
    for be in ("torch", "kernel"):
        saved = buzen.get_backend()
        buzen.set_backend(be)
        try:
            rows[be] = TS.ScenarioSuite(scns, device="cpu").run(
                mode="analyze").entries
        finally:
            buzen.set_backend(saved)
    for name in scns:
        assert rows["kernel"][name]["tau"] == pytest.approx(
            rows["torch"][name]["tau"], rel=1e-4)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("mu_cs", [None, 2.5])
def test_lane_stacked_buzen_bitwise_alone(backend, mu_cs):
    """One DP call over lane-stacked, padded networks (per-lane rates) is
    each lane's own call, bitwise; a class set likewise with a different
    ``count`` per lane.  A shared-network batch is what it was."""
    from repro_torch.core.batched import batch_log_normalizing_constants
    from repro_torch.core.buzen import (class_log_normalizing_constants,
                                        log_normalizing_constants,
                                        pad_classes, pad_network)
    from repro_torch.core.numerics import seqsum
    from repro_torch.kernels.buzen import buzen_log_Z_batched

    rng = np.random.default_rng(6)
    nets = [_net(T, rng, n, mu_cs=mu_cs).params(
        p=rng.dirichlet(np.ones(n)), device="cpu") for n in (3, 5, 8)]
    lanes = tev.stack_lanes([pad_network(x, 8) for x in nets])
    got = log_normalizing_constants(lanes, 12, backend=backend)
    for i, net in enumerate(nets):
        assert torch.equal(got[i], log_normalizing_constants(
            net, 12, backend=backend)), i
    sets = [T.ClassSpec(mu_c=rng.uniform(0.5, 3, c),
                        mu_d=rng.uniform(0.5, 3, c),
                        mu_u=rng.uniform(0.5, 3, c),
                        count=cnt).class_params(device="cpu")
            for c, cnt in ((2, [3, 4]), (3, [1, 5, 2]))]
    sets = [cp if mu_cs is None else cp.with_cs(mu_cs) for cp in sets]
    got = class_log_normalizing_constants(
        tev.stack_lanes([pad_classes(cp, 3) for cp in sets]), 12,
        backend=backend)
    for i, cp in enumerate(sets):
        assert torch.equal(got[i], class_log_normalizing_constants(
            cp, 12, backend=backend)), i
    if backend == "kernel":  # the shared-network rows, as the sweep has them
        net = nets[1]
        rows = torch.stack([net.p, net.p.flip(0)])
        log_rho = torch.log(rows) - torch.log(net.mu_c)[None, :]
        gamma = rows * (1.0 / net.mu_d + 1.0 / net.mu_u)[None, :]
        if mu_cs is not None:
            log_rho = torch.cat([log_rho, (torch.log(seqsum(rows, dim=-1))
                                           - torch.log(net.mu_cs))[:, None]],
                                dim=-1)
        assert torch.equal(
            batch_log_normalizing_constants(net, rows, 12, backend="kernel"),
            buzen_log_Z_batched(log_rho, torch.log(seqsum(gamma, dim=-1)),
                                12))


# ---------------------------------------------------------------------------
# 2. simulate
# ---------------------------------------------------------------------------

def _sim_scenarios(S, with_classes=True):
    rng = np.random.default_rng(9)
    scns = {}
    for n, m in ((3, 3), (5, 2)):
        scns[f"n{n}"] = S.Scenario(network=_net(S, rng, n),
                                   strategy=S.StrategySpec(
                                       "explicit",
                                       p=rng.dirichlet(np.ones(n)), m=m))
    scns["det"] = S.Scenario(network=_net(S, rng, 4, law="deterministic"),
                             strategy=S.StrategySpec("asyncsgd"))
    scns["ref"] = S.Scenario(network=_net(S, rng, 3),
                             strategy=S.StrategySpec("asyncsgd"),
                             sim=S.SimSpec(backend="reference"))
    scns["power"] = S.Scenario(
        network=_net(S, rng, 4, mu_cs=2.0),
        energy=S.EnergySpec(kappa=rng.uniform(0.1, 2, 4),
                            P_u=rng.uniform(0.5, 3, 4),
                            P_d=rng.uniform(0.5, 3, 4), P_cs=0.7),
        strategy=S.StrategySpec("asyncsgd"))
    if with_classes:
        scns["classes"] = S.Scenario(
            network=S.NetworkSpec(classes=S.ClassSpec(
                mu_c=rng.uniform(0.5, 3, 2), mu_d=rng.uniform(0.5, 3, 2),
                mu_u=rng.uniform(0.5, 3, 2), count=[2, 3])),
            strategy=S.StrategySpec("asyncsgd"))
    return scns


def _alone_stats(scn, p, m, seed, m_max, backend, chunk, nu, wu):
    power = scn.power(device="cpu")
    kw = dict(warmup=wu, seeds=[seed], m_max=m_max, backend=backend,
              chunk=chunk, distribution=scn.network.law,
              power=None if power is None else [power])
    if scn.is_class_network:
        return simulate_stats_classes_lanes(
            [scn.class_params(p, device="cpu")], [m], nu, **kw)
    return simulate_stats_lanes([scn.params(p, device="cpu")], [m], nu,
                                **kw)


def _assert_stats_equal(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), \
            f"{what}: {f}"


@pytest.mark.parametrize("backend", [None, "reference", "batched", "kernel"])
def test_simulate_lanes_bitwise_alone(backend):
    scns = {k: T.Scenario.from_dict(v.to_dict()) for k, v in
            _sim_scenarios(J, with_classes=backend != "kernel").items()}
    if backend is None:  # the chunk rides each scenario's SimSpec
        scns["n5"] = scns["n5"].replace(sim=T.SimSpec(chunk=4))
    suite = TS.ScenarioSuite(scns, seeds=(0, 3), device="cpu")
    nu, wu = 60, 10
    res = suite.run(mode="simulate", num_updates=nu, warmup=wu,
                    backend=backend)
    strategies = suite.resolve()
    by_bucket = {}
    for name, scn in scns.items():
        bk = backend or scn.sim_backend or "batched"
        ck = 1 if scn.sim is None else scn.sim.chunk
        key = (scn.network.law, scn.network.mu_cs is not None,
               scn.energy is not None, bk, scn.is_class_network, ck)
        by_bucket.setdefault(key, []).append(name)
    assert res.programs == len(by_bucket)
    assert res.lanes == 2 * len(scns)
    for members in by_bucket.values():
        m_max = max(strategies[k][1] for k in members)
        for name in members:
            scn = scns[name]
            p, m = strategies[name]
            bk = backend or scn.sim_backend or "batched"
            ck = 1 if scn.sim is None else scn.sim.chunk
            for seed, got in zip(suite.seeds, res.entries[name]):
                want = _alone_stats(scn, p, m, seed, m_max, bk, ck, nu, wu)
                _assert_stats_equal(tev.lane(want, 0), got,
                                    f"{name}/{seed}/{bk}")
    again = suite.run(mode="simulate", num_updates=nu, warmup=wu,
                      backend=backend)
    assert (again.programs, again.cache_hits) == (0, len(scns))


def test_simulate_programs_match_jax():
    jsuite = JS.ScenarioSuite(_sim_scenarios(J), seeds=(0,))
    tsuite = TS.ScenarioSuite(
        {k: T.Scenario.from_dict(v.to_dict()) for k, v in
         jsuite.scenarios.items()}, seeds=(0,), device="cpu")
    kw = dict(num_updates=12, warmup=0)
    j = jsuite.run(mode="simulate", **kw)
    t = tsuite.run(mode="simulate", **kw)
    # exponential / deterministic law, reference / batched backend, CS with
    # power, classes: five buckets in both
    assert (t.programs, t.lanes, t.cache_hits) == \
        (j.programs, j.lanes, j.cache_hits) == (5, 6, 0)
    j2 = jsuite.run(mode="simulate", **kw)
    t2 = tsuite.run(mode="simulate", **kw)
    assert (t2.programs, t2.cache_hits) == (j2.programs, j2.cache_hits)
    assert t2.metrics["counters"] == j2.metrics["counters"]
    for name, stats in t.entries.items():
        assert stats[0].mean_delay.shape == \
            np.asarray(j.entries[name][0].mean_delay).shape


def test_simulate_law_buckets_bitwise_alone():
    rng = np.random.default_rng(12)
    jscns = {}
    for name, law, n, m in (("h2_a", "hyperexponential", 3, 3),
                            ("h2_b", "hyperexponential", 5, 2),
                            ("logn", "lognormal", 4, 3),
                            ("expo", "exponential", 4, 3)):
        jscns[name] = J.Scenario(network=_net(J, rng, n, law=law),
                                 strategy=J.StrategySpec(
                                     "explicit", p=rng.dirichlet(np.ones(n)),
                                     m=m))
    kw = dict(num_updates=60, warmup=10)
    j = JS.ScenarioSuite(jscns, seeds=(0,)).run(mode="simulate", **kw)
    scns = {k: T.Scenario.from_dict(v.to_dict()) for k, v in jscns.items()}
    suite = TS.ScenarioSuite(scns, seeds=(0, 1), device="cpu")
    res = suite.run(mode="simulate", backend="kernel", **kw)
    assert res.programs == j.programs == 3  # one program per law
    strategies = suite.resolve()
    for members in (["h2_a", "h2_b"], ["logn"], ["expo"]):
        m_max = max(strategies[k][1] for k in members)
        for name in members:
            p, m = strategies[name]
            for seed, got in zip(suite.seeds, res.entries[name]):
                want = _alone_stats(scns[name], p, m, seed, m_max, "kernel",
                                    1, kw["num_updates"], kw["warmup"])
                _assert_stats_equal(tev.lane(want, 0), got, f"{name}/{seed}")


def test_simulate_undersized_m_max_raises():
    scns = {k: T.Scenario.from_dict(v.to_dict()) for k, v in
            _sim_scenarios(J, with_classes=False).items()}
    suite = TS.ScenarioSuite(scns, device="cpu")
    with pytest.raises(ValueError, match="smaller than the largest"):
        suite.run(mode="simulate", num_updates=10, m_max=2)


def test_lane_runners_memoized_and_refusals():
    fn = build_lanes_fn("batched", 10, 0, "exponential", 4, False)
    assert fn is build_lanes_fn("batched", 10, 0, "exponential", 4, False)
    assert fn is not build_lanes_fn("batched", 10, 0, "exponential", 4,
                                    False, chunk=2)
    with pytest.raises(ValueError, match="no kernel"):
        build_class_lanes_fn("kernel", 10, 0, "exponential", 4, False)
    # the traced runners: memoized apart, (statistics, ring) per lane
    cls = T.ClassSpec(mu_c=[1.0, 2.0], mu_d=[3.0, 2.5], mu_u=[2.0, 1.5],
                      count=[2, 3]).class_params(device="cpu")
    net = T.NetworkSpec(mu_c=[1.0, 2.0, 1.5], mu_d=[3.0] * 3,
                        mu_u=[2.0] * 3).params(device="cpu")
    keys = prng.seed_keys([0, 1], device="cpu")
    for build, prm in ((build_lanes_fn, net), (build_class_lanes_fn, cls)):
        traced = build("batched", 10, 0, "exponential", 4, False,
                       trace_events=8)
        assert traced is build("batched", 10, 0, "exponential", 4, False,
                               trace_events=8)
        assert traced is not build("batched", 10, 0, "exponential", 4,
                                   False)
        stats, ring = traced(tev.stack_lanes([prm] * 2), [3, 4], keys, None)
        assert ring.time.shape == (2, 8)
        assert ring.count.tolist() == [3 * 10 + 3 * 4 + 8] * 2
        plain = build("batched", 10, 0, "exponential", 4, False)(
            tev.stack_lanes([prm] * 2), [3, 4], keys, None)
        _assert_stats_equal(stats, plain, build.__name__)
    with pytest.raises(ValueError, match="unknown sim backend"):
        build_lanes_fn("pallas", 10, 0, "exponential", 4, False)


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def _same_logs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.times, x.losses, x.accuracies, x.updates, x.throughput,
                x.energy) == (y.times, y.losses, y.accuracies, y.updates,
                              y.throughput, y.energy)
        np.testing.assert_array_equal(x.mean_delay, y.mean_delay)


def test_train_exact_bucket_is_run_lanes():
    rng = np.random.default_rng(2)
    n = 4
    net = _net(T, rng, n)
    scns = {name: T.Scenario(network=net, learning=T.LearningSpec(
        grad_clip=5.0), strategy=T.StrategySpec(name))
        for name in ("asyncsgd", "round_opt")}
    scns = {k: v.with_strategy(v.strategy.name, steps=10)
            for k, v in scns.items()}
    full = make_synthetic_image_dataset(num_classes=4, samples_per_class=12,
                                        image_size=8, seed=3)
    parts = iid_partition(full.y, n, seed=3)
    clients = [(full.x[i], full.y[i]) for i in parts]
    test = (full.x, full.y)
    model = mlp_classifier(64, 4, hidden=(8,), device="cpu")
    over = dict(batch_size=8, eval_every_time=2.0)
    suite = TS.ScenarioSuite(scns, seeds=(0, 1), device="cpu")
    res = suite.run(mode="train", model=model, clients=clients,
                    test_data=test, horizon_time=6.0, **over)
    assert (res.programs, res.lanes) == (1, 4)
    strategies = suite.resolve()
    hand = DeviceTrainer(mlp_classifier(64, 4, hidden=(8,), device="cpu"),
                         clients, net.params(device="cpu"),
                         AsyncFLConfig(eta=0.05, grad_clip=5.0, **over),
                         test_data=test, device="cpu")
    names = list(scns)
    logs, _ = hand.run_lanes(
        [strategies[k][0] for k in names for _ in (0, 1)],
        [strategies[k][1] for k in names for _ in (0, 1)],
        [scns[k].eta() for k in names for _ in (0, 1)], [0, 1, 0, 1], 6.0)
    _same_logs(res.entries[names[0]] + res.entries[names[1]], logs)
    # the re-run is served from the cache for the same objects only
    again = suite.run(mode="train", model=model, clients=clients,
                      test_data=test, horizon_time=6.0, **over)
    assert (again.programs, again.cache_hits) == (0, 2)
    other = suite.run(mode="train", model=model, clients=list(clients),
                      test_data=test, horizon_time=6.0, **over)
    assert other.cache_hits == 0 and other.programs == 1
    _same_logs(other.entries[names[0]], res.entries[names[0]])


def test_train_dataspec_lanes_bitwise_alone():
    rng = np.random.default_rng(4)
    data = T.DataSpec(num_classes=4, samples_per_class=16, seed=1)
    scns = {}
    for n in (4, 6):
        scns[f"n{n}"] = T.Scenario(
            network=_net(T, rng, n), data=data,
            strategy=T.StrategySpec("explicit",
                                    p=rng.dirichlet(np.ones(n)), m=3))
    model = mlp_classifier(28 * 28, 4, hidden=(8,), device="cpu")
    over = dict(batch_size=8, eval_every_time=2.0, eval_batch=32)
    res = TS.ScenarioSuite(scns, seeds=(0, 2), device="cpu").run(
        mode="train", model=model, horizon_time=5.0, **over)
    assert (res.programs, res.lanes) == (1, 4)
    for name, scn in scns.items():
        alone = TS.ScenarioSuite({name: scn}, seeds=(0, 2),
                                 device="cpu").run(
            mode="train", model=model, horizon_time=5.0, **over)
        _same_logs(res.entries[name], alone.entries[name])
        assert res.entries[name][0].mean_delay.shape == (scn.n,)


# ---------------------------------------------------------------------------
# 4. caches, dicts, refusals, examples
# ---------------------------------------------------------------------------

def test_shared_caches_serve_a_second_suite():
    scns = {k: T.Scenario.from_dict(v.to_dict()) for k, v in
            _sim_scenarios(J, with_classes=False).items()}
    caches = TS.SuiteCaches()
    metrics = Metrics()
    a = TS.ScenarioSuite(scns, caches=caches, metrics=metrics, device="cpu")
    first = a.run(mode="simulate", num_updates=20)
    b = TS.ScenarioSuite(dict(scns), caches=caches, metrics=metrics,
                         device="cpu")
    second = b.run(mode="simulate", num_updates=20)
    assert (second.programs, second.cache_hits) == (0, len(scns))
    assert first.programs > 0
    assert metrics.counter("suite.requests", mode="simulate") == 2 * len(scns)
    # another table size is another result (and another runner)
    third = b.run(mode="simulate", num_updates=20, m_max=7)
    assert third.cache_hits == 0 and third.programs > 0
    assert "suite_programs" in metrics.exposition()


def test_to_dict_matches_jax():
    jsuite = JS.ScenarioSuite(_mixed(J), seeds=(0, 3))
    tsuite = TS.ScenarioSuite.from_dict(jsuite.to_dict(), device="cpu")
    dump = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
    assert dump(tsuite.to_dict()) == dump(jsuite.to_dict())
    base = T.Scenario(network=T.NetworkSpec.from_clusters(
        T.PAPER_CLUSTERS_TABLE1, 10))
    jbase = J.Scenario(network=J.NetworkSpec.from_clusters(
        J.PAPER_CLUSTERS_TABLE1, 10))
    four = ("asyncsgd", "max_throughput", "round_opt", "time_opt")
    tg = TS.ScenarioSuite.strategy_grid(base, four, seeds=(0, 1), steps=20,
                                        m_max=15, device="cpu")
    jg = JS.ScenarioSuite.strategy_grid(jbase, four, seeds=(0, 1), steps=20,
                                        m_max=15)
    assert dump(tg.to_dict()) == dump(jg.to_dict()) and len(tg) == 4


@pytest.mark.parametrize("mode,trace", [("simulate", dict(events=8)),
                                        ("train", dict(updates=16))])
def test_rings_raise_naming_item_6(mode, trace):
    """Once a refusal; now the traced runs: ``traces`` (and in
    ``simulate`` the ``drift`` reports) come back with the entries, bitwise
    again from the result cache, a class network's rings per class."""
    sim = T.SimSpec(trace=T.TraceSpec(**trace))
    scns = {"table1": T.Scenario(network=T.NetworkSpec.from_clusters(
        T.PAPER_CLUSTERS_TABLE1, 10), sim=sim, data=T.DataSpec())}
    if mode == "simulate":
        scns["classes"] = T.Scenario(
            network=T.NetworkSpec(classes=T.ClassSpec(
                mu_c=[1.0, 2.0], mu_d=[3.0, 2.5], mu_u=[2.0, 1.5],
                count=[2, 3])), sim=sim)
    suite = TS.ScenarioSuite(scns, seeds=(0, 1), device="cpu")
    kw = (dict(num_updates=10) if mode == "simulate"
          else dict(model=mlp_classifier(28 * 28, 4, device="cpu"),
                    horizon_time=1.0))
    first = suite.run(mode=mode, **kw)
    again = suite.run(mode=mode, **kw)
    assert again.cache_hits == len(scns) and first.cache_hits == 0
    cap = trace.get("events", trace.get("updates"))
    for name in scns:
        assert len(first.traces[name]) == 2
        for a, b in zip(first.traces[name], again.traces[name]):
            assert a["capacity"] == cap and a["count"] > 0
            assert a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in a)
    if mode == "simulate":
        assert first.drift == again.drift
        assert set(first.drift) == set(scns)
        C = 2  # class rings: class indices, the [3C+1] station layout
        for d in first.traces["classes"]:
            assert d["client"].max() < C and d["station"].max() <= 3 * C
        assert len(first.drift["classes"][0]["checks"]) > 0
    else:
        assert first.drift is None
    assert suite.run(mode="analyze").traces is None


def test_unknown_mode_and_bad_entries():
    scn = T.Scenario(network=T.NetworkSpec.from_clusters(
        T.PAPER_CLUSTERS_TABLE1, 10))
    with pytest.raises(ValueError, match="unknown mode"):
        TS.ScenarioSuite(scn, device="cpu").run(mode="serve")
    with pytest.raises(TypeError, match="not a Scenario"):
        TS.ScenarioSuite({"x": 1}, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        TS.ScenarioSuite({}, device="cpu")
    with pytest.raises(ValueError, match="DataSpec"):
        TS.ScenarioSuite(scn, device="cpu").run(
            mode="train", model=mlp_classifier(4, 2, device="cpu"),
            horizon_time=1.0)


def test_paper_scale_sim_example():
    got = _load_example("paper_scale_sim_torch").main(
        device="cpu", scale=10, m=12, n_seeds=2, updates=150, warmup=20)
    assert (got["lanes"], got["programs"]) == (2, 1)
    assert (got["cache_hits"], got["rerun_programs"]) == (1, 0)
    assert got["backend"] == "batched"
    assert got["throughput"] == pytest.approx(got["closed_form"], rel=0.2)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_async_fl_emnist_example(backend):
    got = _load_example("async_fl_emnist_torch").main(
        device="cpu", horizon=1.5, steps=10, samples_per_class=12,
        backend=backend)
    assert set(got["strategies"]) == {"asyncsgd", "max_throughput",
                                      "round_opt", "time_opt"}
    if backend == "device":
        assert (got["lanes"], got["programs"]) == (4, 1)
    for row in got["strategies"].values():
        assert 1 <= row["m"] <= got["n"] + 6 and row["updates"] >= 0
