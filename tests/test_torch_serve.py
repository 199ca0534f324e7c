"""The port's suite server (``repro_torch.serve``) against the JAX package's
protocol and payloads, and its own live-server contracts on the CPU.

1. Metrics and the micro-batcher, as the JAX package's serve tests have
   them.
2. Protocol parity: the same request lines, valid and malformed, through
   both packages' ``decode_line`` / ``parse_request``.  Where both accept
   a line, ``id``, ``mode``, ``seeds``, ``options`` and
   ``scenario.hash()`` are equal; where both refuse it, the error
   ``type``, message and request id are.  A ``pallas`` sim backend and
   ``interpret: true`` are refused by the port alone, as structured
   errors.
3. ``encode_entry`` parity: the port's payload of its ``ScenarioSuite.run``
   against JAX's ``encode_entry`` of JAX's run on the same scenario and
   seeds — the same keys, list shapes and JSON types; ``analyze`` at
   ``tests/test_torch_suite.py``'s classes (explicit and ``asyncsgd`` rows
   ``rtol 1e-10``, ``time_opt`` m exact, p ``atol 1e-6``, values ``rel
   1e-6``), ``simulate`` discrete fields exact and floats ``rtol 1e-12``
   (the same-seed class), ``train`` at ``tests/test_torch_seed_parity.py``'s
   classes (times and updates exact, losses ``rtol 1e-4, atol 1e-5``,
   accuracies within one test sample, the event statistics ``rtol
   1e-12``).
4. The live server on the CPU, bitwise against direct port
   ``ScenarioSuite.run`` payloads: analyze and the response cache,
   concurrent mixed-``n`` simulate coalesced into one dispatch, two
   ``analyze`` requests of different ``m`` coalesced into one dispatch, a
   ``sharded`` simulate answered as ``batched`` (its lanes split over
   three CPU devices), mixed-``n`` train, structured errors, a killed
   in-flight client, ``stats`` and ``metrics``, drain and refusal; the refusal of ``cuda`` without a card;
   the build directory; ``python -m repro_torch.serve --device cpu
   --stdio`` answering one request in a process of its own.

No test waits out a timeout: every client timeout is a bound on a
response that comes well before it.
"""
import json
import os
import queue
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.fl.models import mlp_classifier as jax_mlp
from repro.scenario import spec as J
from repro.scenario import suite as JS
from repro.serve import protocol as JP
from repro_torch.core import buzen as tbz
from repro_torch.fl.models import mlp_classifier
from repro_torch.kernels import build
from repro_torch.scenario import spec as T
from repro_torch.scenario import suite as TS
from repro_torch import sim as tsim
from repro_torch.serve import protocol as TP
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.build_cache import (SCENARIO_KERNELS,
                                           enable_build_cache, prebuild)
from repro_torch.serve.client import ServeClient, ServeError
from repro_torch.serve.executor import Executor
from repro_torch.serve.metrics import Histogram, Metrics
from repro_torch.serve.protocol import MAX_M, WireError, encode_entry
from repro_torch.serve.server import ServeConfig, Server

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(dataset="synthetic", num_classes=2, samples_per_class=6)
MODEL_SPEC = {"kind": "mlp", "input_dim": 28 * 28, "num_classes": 2,
              "hidden": [4]}
TRAIN_OPTS = dict(horizon_time=4.0, batch_size=4, eval_every_time=2.0)


def make_scenario(n, seed=0, m=2, data=True, S=T, **kw):
    """A small explicit-strategy scenario of spec module ``S``; ``seed``
    varies the rates so each test gets distinct response-cache keys."""
    rng = np.random.default_rng(seed)
    return S.Scenario(
        network=S.NetworkSpec(mu_c=list(rng.uniform(1.0, 2.0, n)),
                              mu_d=[2.0] * n, mu_u=[2.0] * n),
        strategy=S.StrategySpec("explicit", p=list(np.full(n, 1.0 / n)),
                                m=m),
        data=S.DataSpec(**DATA) if data else None, **kw)


def direct_payload(scn, mode, seeds=(0,), **options):
    """What the server must produce, computed without the server."""
    if mode == "train":
        options = dict(options)
        spec = options.pop("model")
        options["model"] = mlp_classifier(spec["input_dim"],
                                          spec["num_classes"],
                                          hidden=tuple(spec["hidden"]),
                                          device="cpu")
    res = TS.ScenarioSuite(scn, seeds=seeds, device="cpu").run(mode=mode,
                                                               **options)
    (entry,) = res.entries.values()
    return encode_entry(mode, entry)


def bitwise_equal(a, b) -> bool:
    return json.dumps(a) == json.dumps(b)


def json_types(x):
    if isinstance(x, dict):
        return {k: json_types(v) for k, v in x.items()}
    if isinstance(x, list):
        return [json_types(v) for v in x]
    return type(x).__name__


# ---------------------------------------------------------------------------
# 1. metrics and the micro-batcher (unit)
# ---------------------------------------------------------------------------

def test_histogram_percentiles_exact():
    h = Histogram()
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100
    assert h.percentile(0.0) == 1.0
    assert h.percentile(1.0) == 100.0
    assert h.percentile(0.5) == 51.0  # nearest rank of 0.5*(n-1)
    s = h.summary()
    assert s["count"] == 100 and s["mean"] == pytest.approx(50.5)


def test_metrics_labels_and_snapshot():
    m = Metrics()
    m.inc("suite.requests", mode="analyze")
    m.inc("suite.requests", by=2, mode="analyze")
    m.observe("suite.lanes_per_dispatch", 4, mode="simulate")
    with m.timed("suite.dispatch", mode="simulate"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["suite.requests{mode=analyze}"] == 3
    assert snap["latency"]["suite.lanes_per_dispatch{mode=simulate}"][
        "p50"] == 4
    assert m.counter("suite.requests", mode="analyze") == 3


def test_direct_suite_run_reports_metrics():
    suite = TS.ScenarioSuite({"a": make_scenario(2, seed=40),
                              "b": make_scenario(3, seed=41)}, seeds=(0, 1),
                             device="cpu")
    res = suite.run(mode="analyze")
    counters = res.metrics["counters"]
    assert counters["suite.requests{mode=analyze}"] == 2
    lanes = res.metrics["latency"]["suite.lanes_per_dispatch{mode=analyze}"]
    assert lanes["count"] >= 1
    assert "suite.run{mode=analyze}" in res.metrics["latency"]


def _fake_req(bucket, seeds=(0,)):
    return types.SimpleNamespace(bucket=bucket, seeds=tuple(seeds))


def test_batcher_window_groups_by_bucket():
    q = queue.Queue()
    b = MicroBatcher(q, lambda r: r.bucket, max_wait=0.05, max_lanes=64)
    for r in (_fake_req("A"), _fake_req("B"), _fake_req("A")):
        q.put(r)
    window = b.next_window(timeout=1.0)
    assert len(window) == 3
    groups = b.group(window)
    assert [(err, [r.bucket for r in g]) for err, g in groups] == [
        (None, ["A", "A"]), (None, ["B"])]


def test_batcher_lane_budget_bounds_window():
    q = queue.Queue()
    b = MicroBatcher(q, lambda r: r.bucket, max_wait=5.0, max_lanes=4)
    for _ in range(4):
        q.put(_fake_req("A", seeds=(0, 1)))
    t0 = time.monotonic()
    window = b.next_window(timeout=1.0)
    # 2 requests x 2 seeds hit the 4-lane budget: no waiting out max_wait
    assert len(window) == 2
    assert time.monotonic() - t0 < 4.0


def test_batcher_key_errors_become_singletons():
    q = queue.Queue()

    def key(r):
        if r.bucket == "boom":
            raise WireError("ProtocolError", "bad bucket")
        return r.bucket

    b = MicroBatcher(q, key, max_wait=0.05, max_lanes=64)
    for r in (_fake_req("A"), _fake_req("boom"), _fake_req("A")):
        q.put(r)
    groups = b.group(b.next_window(timeout=1.0))
    assert len(groups) == 2
    errs = [err for err, _ in groups if err is not None]
    assert len(errs) == 1 and isinstance(errs[0], WireError)


def test_batcher_shutdown_sentinel_ends_the_window():
    q = queue.Queue()
    b = MicroBatcher(q, lambda r: r.bucket, max_wait=5.0, max_lanes=64)
    q.put(None)
    assert b.next_window(timeout=1.0) == []
    q.put(_fake_req("A"))
    q.put(None)
    t0 = time.monotonic()
    assert len(b.next_window(timeout=1.0)) == 1
    assert time.monotonic() - t0 < 4.0  # fired at the sentinel


# ---------------------------------------------------------------------------
# 2. protocol parity
# ---------------------------------------------------------------------------

def _base(**over):
    msg = {"id": "r0", "verb": "run", "mode": "analyze",
           "scenario": make_scenario(2, seed=50, S=J).to_dict(),
           "seeds": [0], "options": {}}
    msg.update(over)
    return msg


def _scn(**edit):
    d = make_scenario(2, seed=50, S=J).to_dict()
    for path, v in edit.items():
        node = d
        *head, last = path.split("__")
        for k in head:
            node = node[k]
        node[last] = v
    return d


_TRAIN = dict(TRAIN_OPTS, model=MODEL_SPEC)
LINES = {
    "analyze": _base(),
    "simulate": _base(mode="simulate", seeds=[0, 3],
                      options={"num_updates": 60, "warmup": 5,
                               "m_max": 4}),
    "train": _base(id="t1", mode="train", options=_TRAIN),
    "hyperexponential": _base(scenario=_scn(
        network__law="hyperexponential")),
    "no_id": _base(id=None),
    "empty_id": _base(id=""),
    "bad_mode": _base(mode="explode"),
    "scenario_not_object": _base(scenario="nope"),
    "empty_seeds": _base(seeds=[]),
    "float_seeds": _base(seeds=[0.5]),
    "options_not_object": _base(options=[1]),
    "unknown_option": _base(options={"volume": 11}),
    "simulate_no_updates": _base(mode="simulate", options={}),
    "train_no_model": _base(mode="train",
                            options={"horizon_time": 1.0}),
    "train_no_data": _base(mode="train", options=_TRAIN,
                           scenario=make_scenario(2, seed=50, data=False,
                                                  S=J).to_dict()),
    "unknown_strategy": _base(scenario=_scn(strategy__name="zigzag")),
    "unknown_law": _base(scenario=_scn(network__law="weibull")),
    "explicit_m_too_big": _base(scenario=make_scenario(
        2, seed=50, m=MAX_M + 1, S=J).to_dict()),
    "m_max_too_big": _base(mode="simulate",
                           options={"num_updates": 10, "m_max": MAX_M + 1}),
}
RAW = {
    "malformed_json": b'{"id": "oops", not json\n',
    "json_array": b'[1, 2, 3]\n',
    "line_too_long": b" " * (JP.MAX_LINE + 1),
}


def _parse(P, line):
    try:
        return P.parse_request(P.decode_line(line)), None
    except P.WireError as e:
        return None, (e.etype, str(e), e.req_id)


@pytest.mark.parametrize("name", sorted(LINES) + sorted(RAW))
def test_protocol_parity(name):
    line = RAW.get(name) or json.dumps(LINES.get(name)).encode() + b"\n"
    jreq, jerr = _parse(JP, line)
    treq, terr = _parse(TP, line)
    assert (jreq is None) == (treq is None), (jerr, terr)
    if jreq is None:
        assert terr == jerr
        return
    assert (treq.id, treq.mode, treq.seeds, treq.options) == \
        (jreq.id, jreq.mode, jreq.seeds, jreq.options)
    assert treq.scenario.hash() == jreq.scenario.hash()
    assert isinstance(treq.scenario, T.Scenario)


@pytest.mark.parametrize("sim", [{"backend": "pallas"},
                                 {"interpret": True}])
def test_protocol_refuses_what_only_jax_runs(sim):
    d = _scn()
    d["sim"] = dict(J.SimSpec().to_dict(), **sim)
    line = json.dumps(_base(id="j1", scenario=d)).encode()
    jreq, jerr = _parse(JP, line)
    assert jerr is None and jreq.scenario.sim is not None
    treq, terr = _parse(TP, line)
    assert treq is None
    etype, message, rid = terr
    assert etype == "ValueError" and rid == "j1"
    assert ("interpret" in message if "interpret" in sim
            else sim["backend"] in message)
    with pytest.raises(ValueError) as exc:
        T.Scenario.from_dict(d)
    assert str(exc.value) == message


# ---------------------------------------------------------------------------
# 3. encode_entry parity against the JAX package
# ---------------------------------------------------------------------------

def _pair(jscn, mode, seeds, **kw):
    """``(JAX payload, port payload)`` of one scenario run alone."""
    tscn = T.Scenario.from_dict(jscn.to_dict())
    assert tscn.hash() == jscn.hash()
    jkw, tkw = dict(kw), dict(kw)
    if mode == "train":
        spec = MODEL_SPEC
        jkw["model"] = jax_mlp(spec["input_dim"], spec["num_classes"],
                               hidden=tuple(spec["hidden"]))
        tkw["model"] = mlp_classifier(spec["input_dim"], spec["num_classes"],
                                      hidden=tuple(spec["hidden"]),
                                      device="cpu")
    (je,) = JS.ScenarioSuite(jscn, seeds=seeds).run(mode=mode,
                                                    **jkw).entries.values()
    (te,) = TS.ScenarioSuite(tscn, seeds=seeds, device="cpu").run(
        mode=mode, **tkw).entries.values()
    want, got = JP.encode_entry(mode, je), encode_entry(mode, te)
    # the same keys, list shapes and JSON types, through JSON and back
    want, got = json.loads(json.dumps(want)), json.loads(json.dumps(got))
    assert json_types(got) == json_types(want)
    return want, got


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _analyze_scenarios():
    rng = np.random.default_rng(5)

    def net(n, **kw):
        return J.NetworkSpec(mu_c=rng.uniform(0.5, 3, n),
                             mu_d=rng.uniform(0.5, 3, n),
                             mu_u=rng.uniform(0.5, 3, n), **kw)

    return {
        "explicit": J.Scenario(network=net(3), strategy=J.StrategySpec(
            "explicit", p=rng.dirichlet(np.ones(3)), m=4)),
        "energy": J.Scenario(
            network=net(3, mu_cs=2.5),
            energy=J.EnergySpec(kappa=rng.uniform(0.1, 2, 3),
                                P_u=rng.uniform(0.5, 3, 3),
                                P_d=rng.uniform(0.5, 3, 3)),
            strategy=J.StrategySpec("asyncsgd"),
            objective=J.ObjectiveSpec("joint", rho=0.3)),
        "classes": J.Scenario(
            network=J.NetworkSpec(classes=J.ClassSpec(
                mu_c=rng.uniform(0.5, 3, 2), mu_d=rng.uniform(0.5, 3, 2),
                mu_u=rng.uniform(0.5, 3, 2), count=[3, 2])),
            strategy=J.StrategySpec("asyncsgd")),
        "time_opt": J.Scenario(network=net(5), strategy=J.StrategySpec(
            "time_opt", m_max=8, steps=12)),
    }


@pytest.mark.parametrize("name", ["explicit", "energy", "classes",
                                  "time_opt"])
def test_encode_entry_analyze_matches_jax(name):
    want, got = _pair(_analyze_scenarios()[name], "analyze", (0,))
    assert set(got) == set(want)
    assert (got["m"], got["objective"], got["eta"]) == \
        (want["m"], want["objective"], want["eta"])
    rtol = 1e-6 if name == "time_opt" else 1e-10
    _close(got["p"], want["p"], 0, 1e-6 if name == "time_opt" else 0)
    for f in ("throughput", "K_eps", "tau", "energy", "value"):
        if want[f] is None:
            assert got[f] is None, f
        else:
            assert got[f] == pytest.approx(want[f], rel=rtol), f
    _close(got["delays"], want["delays"], rtol, 1e-12)


def test_encode_entry_simulate_matches_jax():
    jscn = make_scenario(4, seed=21, m=3, S=J,
                         sim=J.SimSpec(backend="batched", chunk=8))
    want, got = _pair(jscn, "simulate", (0, 5), num_updates=80, warmup=10)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["updates"] == w["updates"]
        assert g["delay_counts"] == w["delay_counts"]
        for f in ("time", "throughput", "mean_delay", "energy",
                  "mean_queue_counts"):
            _close(g[f], w[f], 1e-12, 1e-12)


def test_encode_entry_train_matches_jax():
    jscn = make_scenario(3, seed=22, S=J)
    want, got = _pair(jscn, "train", (0, 1), **TRAIN_OPTS)
    _, test = jscn.data.build(jscn.n)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["times"] == w["times"] and g["updates"] == w["updates"]
        _close(g["losses"], w["losses"], 1e-4, 1e-5)
        _close(g["accuracies"], w["accuracies"], 0,
               1.0 / len(test[1]) + 1e-6)
        for f in ("mean_delay", "throughput", "energy"):
            _close(g[f], w[f], 1e-12, 1e-12)


# ---------------------------------------------------------------------------
# 4. the live server on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("serve") / "repro.sock")
    server = Server(ServeConfig(socket_path=sock, max_wait=0.25,
                                max_lanes=16, device="cpu"))
    server.start()
    yield sock, server
    server.stop()


def test_analyze_bitwise_and_response_cache(served):
    sock, server = served
    scn = make_scenario(3, seed=1)
    with ServeClient(sock, timeout=30) as c:
        rid = c.submit(scn, mode="analyze")
        msg = c.collect(rid)
        assert msg["cached"] is False
        assert [e["event"] for e in c.events_for(rid)] == ["accepted",
                                                           "scheduled"]
        assert bitwise_equal(c.unwrap(msg), direct_payload(scn, "analyze"))
        # the repeat is answered at admission: no accepted/scheduled
        # events and no dispatch
        runs = server.metrics.counter("suite.requests", mode="analyze")
        rid2 = c.submit(scn, mode="analyze")
        msg2 = c.collect(rid2)
        assert msg2["cached"] is True
        assert c.events_for(rid2) == []
        assert bitwise_equal(c.unwrap(msg2), c.unwrap(msg))
    assert server.metrics.counter("suite.requests", mode="analyze") == runs
    assert server.metrics.counter("serve.cache_hits", mode="analyze") >= 1


def test_concurrent_simulate_coalesced_and_bitwise(served):
    sock, _ = served
    scns = [make_scenario(3, seed=2), make_scenario(5, seed=3)]
    opts = dict(num_updates=60)
    with ServeClient(sock, timeout=30) as a, \
            ServeClient(sock, timeout=30) as b:
        # two *connections* submit into the same micro-batch window
        ra = a.submit(scns[0], mode="simulate", seeds=(0, 1), **opts)
        rb = b.submit(scns[1], mode="simulate", seeds=(0, 1), **opts)
        pa = a.unwrap(a.collect(ra))
        pb = b.unwrap(b.collect(rb))
        sched = [e for e in a.events_for(ra) if e["event"] == "scheduled"]
    # mixed populations (n=3, n=5) coalesced into ONE padded dispatch
    assert sched and sched[0]["requests"] == 2 and sched[0]["lanes"] == 4
    assert bitwise_equal(pa, direct_payload(scns[0], "simulate",
                                            seeds=(0, 1), **opts))
    assert bitwise_equal(pb, direct_payload(scns[1], "simulate",
                                            seeds=(0, 1), **opts))


def _close_tree(got, want, rtol):
    """Numbers within ``rtol``, everything else equal, key for key."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close_tree(got[k], want[k], rtol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rtol)
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        assert got == want


def test_analyze_of_different_m_coalesced_and_bitwise(served):
    # the analyze bucket key has no m (the JAX key): two asyncsgd requests
    # at m = 4 and 9 on one network share a dispatch, evaluated at the
    # larger table; each payload must be its direct run's, at rtol 1e-10
    # and bitwise
    sock, _ = served
    rng = np.random.default_rng(31)
    net = T.NetworkSpec(mu_c=list(rng.uniform(1.0, 2.0, 6)),
                        mu_d=[2.0] * 6, mu_u=[2.0] * 6)
    scns = [T.Scenario(network=net, strategy=T.StrategySpec("asyncsgd",
                                                            m=m))
            for m in (4, 9)]
    with ServeClient(sock, timeout=30) as a, \
            ServeClient(sock, timeout=30) as b:
        ids = [c.submit(scn, mode="analyze")
               for c, scn in zip((a, b), scns)]
        payloads = [c.unwrap(c.collect(i)) for c, i in zip((a, b), ids)]
        sched = [e for e in a.events_for(ids[0])
                 if e["event"] == "scheduled"]
    assert sched and sched[0]["requests"] == 2
    for scn, got in zip(scns, payloads):
        want = direct_payload(scn, "analyze")
        _close_tree(got, want, 1e-10)
        assert bitwise_equal(got, want)


def test_sharded_simulate_is_served_as_batched(served, monkeypatch):
    # a request pinned to the sharded backend is parsed, dispatched with
    # its lanes split over three CPU devices, and answered with the
    # payload of a direct batched run
    sock, _ = served
    monkeypatch.setattr(tsim.sharded, "lane_devices",
                        lambda device: [torch.device("cpu")] * 3)
    scn = make_scenario(4, seed=13, sim=T.SimSpec(backend="sharded"))
    req = TP.parse_request(TP.decode_line(json.dumps(
        _base(mode="simulate", scenario=scn.to_dict(), seeds=[0, 1, 2],
              options={"num_updates": 80})).encode()))
    assert req.scenario.sim_backend == "sharded"
    with ServeClient(sock, timeout=30) as c:
        payload = c.run(scn, mode="simulate", seeds=(0, 1, 2),
                        num_updates=80)
    batched = make_scenario(4, seed=13, sim=T.SimSpec(backend="batched"))
    assert bitwise_equal(payload, direct_payload(batched, "simulate",
                                                 seeds=(0, 1, 2),
                                                 num_updates=80))


def test_train_mixed_n_coalesced_and_bitwise(served):
    sock, _ = served
    scns = [make_scenario(2, seed=4), make_scenario(3, seed=5)]
    opts = dict(TRAIN_OPTS, model=MODEL_SPEC)
    with ServeClient(sock, timeout=30) as c:
        ids = [c.submit(s, mode="train", seeds=(0,), **opts) for s in scns]
        payloads = [c.unwrap(c.collect(i)) for i in ids]
        sched = [e for e in c.events_for(ids[0])
                 if e["event"] == "scheduled"]
    # the mixed-n train bucket: both populations share one trainer
    assert sched and sched[0]["requests"] == 2
    for scn, payload in zip(scns, payloads):
        assert bitwise_equal(payload,
                             direct_payload(scn, "train", **opts))


def test_errors_are_structured_and_server_keeps_serving(served):
    sock, _ = served
    with ServeClient(sock, timeout=30) as c:
        # malformed JSON
        c.send_raw(b'{"id": "oops", not json\n')
        msg = c.collect(None)  # unparseable line -> id is None
        assert msg["event"] == "error"
        assert msg["error"]["type"] == "ProtocolError"
        # unknown strategy name (spec validation, with the request id)
        bad = make_scenario(2, seed=6).to_dict()
        bad["strategy"]["name"] = "zigzag"
        c.send({"id": "r-bad", "verb": "run", "mode": "analyze",
                "scenario": bad, "seeds": [0], "options": {}})
        assert c.collect("r-bad")["error"]["type"] == "ValueError"
        # a backend only the JAX package runs
        jax_only = make_scenario(2, seed=6).to_dict()
        jax_only["sim"] = {"backend": "pallas", "interpret": None,
                           "chunk": 1}
        c.send({"id": "r-pallas", "verb": "run", "mode": "analyze",
                "scenario": jax_only, "seeds": [0], "options": {}})
        msg = c.collect("r-pallas")
        assert msg["error"]["type"] == "ValueError"
        assert "pallas" in msg["error"]["message"]
        # unknown verb
        c.send({"id": "r-verb", "verb": "dance"})
        assert c.collect("r-verb")["error"]["type"] == "ProtocolError"
        # oversized m_max
        c.send({"id": "r-m", "verb": "run", "mode": "simulate",
                "scenario": make_scenario(2, seed=6).to_dict(),
                "seeds": [0],
                "options": {"num_updates": 10, "m_max": MAX_M + 1}})
        assert c.collect("r-m")["error"]["type"] == "ProtocolError"
        # a class network's simulate on the kernel route: no class kernel,
        # refused at dispatch as a structured error
        cls = T.Scenario(network=T.NetworkSpec(classes=T.ClassSpec(
            mu_c=[1.0, 2.0], mu_d=[2.0, 2.0], mu_u=[2.0, 2.0],
            count=[2, 3])), strategy=T.StrategySpec("asyncsgd"))
        rid = c.submit(cls, mode="simulate", num_updates=10,
                       backend="kernel")
        msg = c.collect(rid)
        assert msg["error"]["type"] == "ValueError"
        assert "no kernel" in msg["error"]["message"]
        with pytest.raises(ServeError):
            c.run(cls, mode="simulate", num_updates=10, backend="kernel",
                  warmup=1)
        # ...and the SAME connection still gets bitwise-correct results
        scn = make_scenario(2, seed=7)
        assert bitwise_equal(c.run(scn, mode="analyze"),
                             direct_payload(scn, "analyze"))
        assert bitwise_equal(c.run(cls, mode="simulate", num_updates=10,
                                   backend="batched"),
                             direct_payload(cls, "simulate", num_updates=10,
                                            backend="batched"))


def test_killed_inflight_request_does_not_poison_the_server(served):
    sock, _ = served
    scn = make_scenario(4, seed=8)
    killer = ServeClient(sock, timeout=30)
    killer.submit(scn, mode="simulate", num_updates=60)
    killer.close()  # walk away with the request in flight
    # the dispatch completes into a dead transport; the server, the
    # shared caches and the response cache all stay healthy:
    with ServeClient(sock, timeout=30) as c:
        assert bitwise_equal(
            c.run(scn, mode="simulate", num_updates=60),
            direct_payload(scn, "simulate", num_updates=60))
        assert c.stats()["counters"]


def test_stats_and_metrics_verbs(served):
    sock, _ = served
    with ServeClient(sock, timeout=30) as c:
        scn = make_scenario(2, seed=9)
        c.run(scn, mode="analyze")
        st = c.stats()
        text = c.metrics()
    assert st["uptime"] > 0
    assert st["response_cache_size"] >= 1
    assert st["counters"]["serve.requests{mode=analyze}"] >= 1
    assert st["drift"] == {"checked": 0, "breaches": 0, "last": None}
    lat = st["latency"]
    assert any(k.startswith("serve.request_latency") for k in lat)
    key = next(k for k in lat if k.startswith("serve.dispatch"))
    assert lat[key]["count"] >= 1 and lat[key]["p99"] >= lat[key]["p50"]
    assert isinstance(text, str) and "serve_requests" in text


def test_traced_simulate_feeds_the_drift_summary(served):
    sock, server = served
    scn = make_scenario(3, seed=12, sim=T.SimSpec(
        trace=T.TraceSpec(events=4096)))
    with ServeClient(sock, timeout=30) as c:
        payload = c.run(scn, mode="simulate", seeds=(0, 1),
                        num_updates=200)
        st = c.stats()
    assert bitwise_equal(payload, direct_payload(scn, "simulate",
                                                 seeds=(0, 1),
                                                 num_updates=200))
    assert st["drift"]["checked"] >= 2 and st["drift"]["last"] is not None


def test_shutdown_drains_then_refuses():
    with tempfile.TemporaryDirectory() as tmp:
        sock = os.path.join(tmp, "s.sock")
        server = Server(ServeConfig(socket_path=sock, max_wait=0.02,
                                    device="cpu"))
        server.start()
        with ServeClient(sock, timeout=30) as c:
            scn = make_scenario(2, seed=10)
            c.run(scn, mode="analyze")
            assert c.shutdown() == "draining"
        assert server._stopped.wait(timeout=30)
        assert not os.path.exists(sock)


def test_draining_server_refuses_new_requests():
    with tempfile.TemporaryDirectory() as tmp:
        sock = os.path.join(tmp, "s.sock")
        server = Server(ServeConfig(socket_path=sock, max_wait=0.02,
                                    device="cpu"))
        server.start()
        server._draining.set()  # drain announced, listener still up
        try:
            with ServeClient(sock, timeout=30) as c:
                rid = c.submit(make_scenario(2, seed=11), mode="analyze")
                msg = c.collect(rid)
                assert msg["error"]["type"] == "Unavailable"
        finally:
            server._draining.clear()
            server.stop()


def test_cuda_without_a_card_is_refused(monkeypatch):
    from repro_torch.serve import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ServeConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor()
    # the CLI: the card's routes chosen, then the refusal, no fallback
    monkeypatch.setattr(tbz, "_backend", tbz.get_backend())
    monkeypatch.setattr(tsim.backend, "_backend", tsim.get_backend())
    with pytest.raises(SystemExit) as exc:
        cli.main(["--stdio"])
    assert exc.value.code == 2
    assert (tbz.get_backend(), tsim.get_backend()) == ("kernel", "kernel")


def test_build_cache_points_the_build_at_its_directory(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    path = enable_build_cache(str(tmp_path / "kernels"))
    assert Path(path) == build.BUILD_DIR == (tmp_path / "kernels").resolve()
    assert Path(path).is_dir()
    assert build.library_path("buzen").parent == Path(path)
    assert enable_build_cache() == str(build.DEFAULT_BUILD_DIR)
    # the scenario path's sources, all of them built by build_all's flags
    assert set(SCENARIO_KERNELS) <= set(build.FLAGS)
    assert prebuild("cpu") == 0  # CPU tensors take the plain versions


def test_cli_stdio_answers_one_request(tmp_path):
    scn = make_scenario(3, seed=13)
    line = json.dumps({"id": "s1", "verb": "run", "mode": "simulate",
                       "scenario": scn.to_dict(), "seeds": [0, 1],
                       "options": {"num_updates": 40}}) + "\n"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [x for x in [os.environ.get("PYTHONPATH")]
                               if x]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
         "--stdio", "--max-wait-ms", "0", "--build-dir", str(tmp_path)],
        input=line, capture_output=True,
        text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    msgs = [json.loads(x) for x in out.stdout.splitlines()]
    assert [m["event"] for m in msgs] == ["accepted", "scheduled", "result"]
    assert all(m["id"] == "s1" for m in msgs)
    assert bitwise_equal(msgs[-1]["value"],
                         direct_payload(scn, "simulate", seeds=(0, 1),
                                        num_updates=40))

