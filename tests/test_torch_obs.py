"""Port parity: the telemetry rings and ``repro_torch.obs``.

1. Rings: the same records appended in both packages (a prefix, a
   wraparound, a ``valid`` gate, capacity 0, lane-stacked lanes) decode to
   the same columns, counts and drops; the update ring's dtypes.
2. Traced lanes, per client and per class, under the exponential and
   hyperexponential laws: the port's statistics with the event ring on
   are bitwise those with it off (``reference`` and ``batched``, chunk 1
   and 8, a capacity that wraps and one that does not), and its ring
   matches JAX's ``simulate_stats_lanes(trace_events=)`` on JAX's
   ``batched`` backend: at the same seed the discrete columns and
   ``count`` exactly and ``time`` within ``rtol 1e-12`` (the port's
   exponentials are within 1-3 ulps of XLA's); fed JAX's own ``init_state``
   and event blocks (``EventStream.from_blocks``), every column bitwise,
   on ``batched`` and ``kernel`` (the lane wrappers' plain versions on the
   CPU).
3. The trainer: the logs with the update ring on are bitwise those with
   it off; fed JAX's draws, the ring matches JAX's
   ``DeviceTrainer(trace_updates=)``: ``client``, ``staleness`` and
   ``count`` exactly, ``time`` and ``snapshot_age`` bitwise, ``grad_norm``
   within ``rtol 1e-4`` (float32 gradients in two frameworks).
4. ``predict`` within ``rtol 1e-10`` of JAX's; on one decoded ring
   ``drift_report`` gives JAX's flags and numbers within ``rtol 1e-10`` and
   ``perfetto_trace`` JAX's JSON, which matches
   ``tests/data/trace_schema.json``.
5. The CLI: the port's ``smoke --device cpu`` file passes the port's and
   the JAX package's ``check``; a corrupted ring fails both.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import buzen as jbz
from repro.core import events as JE
from repro.fl import engine as jeng
from repro.fl import models as jmodels
from repro.fl.trainer import AsyncFLConfig as JConfig
from repro.obs import drift as jdrift
from repro.obs import rings as jrings
from repro.obs import trace as jtrace
from repro.obs.__main__ import main as jax_cli
from repro.sim import batched_events as jsim
from repro_torch import convert
from repro_torch.core import events as TE
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import engine as teng
from repro_torch.fl import models as tmodels
from repro_torch.fl.trainer import AsyncFLConfig
from repro_torch.obs import drift as tdrift
from repro_torch.obs import rings as trings
from repro_torch.obs import trace as ttrace
from repro_torch.obs.__main__ import main as torch_cli
from repro_torch.sim import simulate_stats_classes_lanes, simulate_stats_lanes

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_INFO = ("count", "capacity", "dropped")


def _leaves(tree):
    """numpy leaves; a tuple leaf (the H2 unit pair) stays a tuple."""
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


def _same_decoded(got: dict, want: dict, *, time_rtol=None, what=""):
    """Two decoded rings: the same keys, counts and columns (dtypes too);
    ``time`` within ``time_rtol`` when given, else bitwise."""
    assert set(got) == set(want), what
    for k in want:
        if k in _INFO:
            assert got[k] == want[k], (what, k, got[k], want[k])
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if k == "time" and time_rtol is not None:
            np.testing.assert_allclose(g, w, rtol=time_rtol, atol=0,
                                       err_msg=f"{what} {k}")
        else:
            assert np.array_equal(g, w), (what, k)


def _tail(decoded: dict, cap: int) -> dict:
    """What a ring of capacity ``cap`` keeps of a full history."""
    count = decoded["count"]
    out = {k: (np.asarray(v)[max(0, count - cap):] if k not in _INFO else v)
           for k, v in decoded.items()}
    out.update(capacity=cap, dropped=max(0, count - cap))
    return out


# ---------------------------------------------------------------------------
# 1. the rings
# ---------------------------------------------------------------------------

RING_CASES = {"prefix": (16, 7, False), "wraparound": (5, 13, False),
              "valid_gate": (6, 17, True), "capacity_0": (0, 4, True)}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_event_ring_appends_decode_like_jax(case):
    cap, appends, gated = RING_CASES[case]
    rng = np.random.default_rng(cap + appends)
    jr = jrings.event_ring_init(cap)
    tr = trings.event_ring_init(cap, device="cpu")
    ts = trings.event_ring_init(cap, lanes=2, device="cpu")
    ints = ("station", "station_to", "kind", "slot", "client", "delay",
            "update")
    for _ in range(appends):
        rec = {"time": rng.exponential() * 10.0,
               **{k: int(rng.integers(0, 13)) for k in ints}}
        valid = bool(rng.random() < 0.6) if gated else None
        jr = jrings.event_ring_append(
            jr, **rec, valid=None if valid is None else jnp.asarray(valid))
        got = trings.event_ring_append(
            tr, **rec, valid=None if valid is None else torch.tensor(valid))
        assert got is tr  # in place
        # lane-stacked: lane 0 the same records, lane 1 every record
        trings.event_ring_append(
            ts, **{k: torch.as_tensor(np.array([v, v])) for k, v in rec.items()},
            valid=None if valid is None else torch.tensor([valid, True]))
    want = jrings.decode(jr)
    _same_decoded(trings.decode(tr), want, what=case)
    _same_decoded(trings.decode_lane(ts, 0), want, what=case + " lane 0")
    assert int(ts.count[1]) == (appends if cap else 0)
    if cap == 0:
        assert want["count"] == 0 and tr.time.shape == (0,)


def test_update_ring_dtypes_and_decode_like_jax():
    jr = jrings.update_ring_init(4)
    tr = trings.update_ring_init(4, lanes=3, device="cpu")
    assert [x.dtype for x in tr] == [torch.float64, torch.int32, torch.int32,
                                     torch.float64, torch.float64,
                                     torch.int32]
    assert [x.shape for x in tr] == [(3, 4)] * 5 + [(3,)]
    rng = np.random.default_rng(1)
    for i in range(9):
        rec = dict(time=float(i) + rng.random(),
                   client=int(rng.integers(0, 5)),
                   staleness=int(rng.integers(0, 4)),
                   grad_norm=rng.exponential(), snapshot_age=rng.random())
        valid = i % 3 != 1
        jr = jrings.update_ring_append(jr, **rec, valid=jnp.asarray(valid))
        trings.update_ring_append(
            tr, **{k: torch.as_tensor(np.array([v] * 3))
                 for k, v in rec.items()},
            valid=torch.tensor([valid, valid, True]))
    for lane, want in enumerate(trings.lane_rings(tr)[:2]):
        _same_decoded(trings.decode(want), jrings.decode(jr), what=lane)
    assert trings.decode_lane(tr, 2)["dropped"] == 5


# ---------------------------------------------------------------------------
# 2. traced lanes against the JAX package
# ---------------------------------------------------------------------------

N_UPD, WARM, M_MAX, SEEDS = 16, 4, 4, (2, 9)
EVENTS = 3 * (N_UPD + WARM) + 3 * M_MAX + 8  # what every lane runs
CAP_FULL, CAP_WRAP = 128, 32


def _lanes(form):
    """Two JAX lanes of the form (``"client"``: n = 5; ``"class"``: C = 3
    classes of 6 clients) and their concurrencies."""
    rng = np.random.default_rng(4)
    rates = {k: jnp.asarray(rng.uniform(0.6, 3.5, 5 if form == "client"
                                        else 3))
             for k in ("mu_c", "mu_d", "mu_u")}
    if form == "client":
        nets = [jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(5))),
                                  **rates) for _ in SEEDS]
        return nets, [3, 4]
    count = np.array([2, 1, 3])
    nets = [jbz.ClassParams(p=jnp.asarray(rng.dirichlet(np.ones(3))
                                          / count),
                            count=jnp.asarray(count, jnp.int64), **rates)
            for _ in SEEDS]
    return nets, [3, 4]


def _jax_traced(form, law, nets, ms):
    """JAX's batched traced lanes: ``(statistics, per-lane decoded
    rings)`` at ``CAP_FULL``."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    if form == "client":
        stats, ring = jsim.simulate_stats_lanes(
            nets, ms, N_UPD, warmup=WARM, keys=keys, distribution=law,
            m_max=M_MAX, backend="batched", trace_events=CAP_FULL)
    else:
        fn = jsim.build_class_lanes_fn("batched", N_UPD, WARM, law, M_MAX,
                                       False, trace_events=CAP_FULL)
        stats, ring = fn(jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                                *nets),
                         jnp.asarray(ms, jnp.int32), keys, None)
    return stats, [jrings.decode(jax.tree_util.tree_map(lambda a, i=i: a[i],
                                                        ring))
                   for i in range(len(SEEDS))]


def _jax_draws(form, law, nets, ms):
    """Each lane's JAX ``init_state`` and its ``EVENTS`` event blocks, as
    JAX's traced run draws them (one jitted program)."""
    init = JE.init_state if form == "client" else JE.init_class_state
    draw = (JE.draw_event_blocks if form == "client"
            else JE.draw_class_event_blocks)

    @jax.jit
    def one(net, key, m):
        st = init(net, m, key, m_max=M_MAX, distribution=law, warmup=WARM,
                  cap=WARM + N_UPD)
        return st, draw(net, st.key, EVENTS, distribution=law)[1]

    return [one(net, jax.random.PRNGKey(s), m)
            for net, s, m in zip(nets, SEEDS, ms)]


@pytest.mark.parametrize("law", ["exponential", "hyperexponential"])
@pytest.mark.parametrize("form", ["client", "class"])
def test_traced_lanes_match_jax_and_leave_stats_bitwise(form, law):
    nets, ms = _lanes(form)
    jstats, jdec = _jax_traced(form, law, nets, ms)
    to_port = (convert.network_params if form == "client"
               else convert.class_params)
    tnets = [to_port(_leaves(net), device="cpu") for net in nets]
    run = (simulate_stats_lanes if form == "client"
           else simulate_stats_classes_lanes)
    kw = dict(warmup=WARM, seeds=SEEDS, distribution=law, m_max=M_MAX)
    for backend in ("reference", "batched"):
        # ring off; every chunk runs the same trajectory (the megastep
        # contract, tests/test_torch_megastep.py)
        plain = run(tnets, ms, N_UPD, backend=backend, **kw)
        for chunk in (1, 8):
            for cap in (CAP_FULL, CAP_WRAP):
                stats, ring = run(tnets, ms, N_UPD, backend=backend,
                                  chunk=chunk, trace_events=cap, **kw)
                what = f"{form} {law} {backend} E={chunk} cap={cap}"
                for a, b in zip(stats, plain):
                    assert torch.equal(a, b), what
                assert ring.count.tolist() == [EVENTS] * len(SEEDS)
                for i, want in enumerate(jdec):
                    _same_decoded(trings.decode_lane(ring, i),
                                  _tail(want, cap), time_rtol=1e-12,
                                  what=f"{what} lane {i}")
    assert np.array_equal(plain.delay_counts.numpy(),
                          np.asarray(jstats.delay_counts))
    assert jdec[0]["dropped"] == 0 and jdec[0]["count"] == EVENTS

    # fed JAX's own draws: every column bitwise
    draws = _jax_draws(form, law, nets, ms)
    to_state = (convert.event_state if form == "client"
                else convert.class_event_state)
    blocks = [convert.event_blocks(_leaves(b), device="cpu")
              for _, b in draws]
    lanes = TE.stack_lanes(tnets)
    for backend in (("batched", "kernel") if form == "client"
                    else ("batched",)):
        for chunk in (1, 8):
            st = TE.stack_lanes([to_state(_leaves(s), device="cpu")
                                 for s, _ in draws])
            stream = TE.EventStream.from_blocks(
                TE.EventBlocks(*[None if x[0] is None else torch.stack(x, 1)
                                 for x in zip(*blocks)]), distribution=law)
            ring = trings.event_ring_init(CAP_FULL, lanes=len(SEEDS),
                                          device="cpu")
            st = TE.run_events(lanes, st, stream, EVENTS, chunk=chunk,
                               backend=backend, ring=ring)
            for i, want in enumerate(jdec):
                _same_decoded(trings.decode_lane(ring, i), want,
                              what=f"injected {backend} E={chunk} lane {i}")
            assert np.array_equal(TE.finalize_stats(st).throughput.numpy(),
                                  np.asarray(jstats.throughput))


def test_lane_wrappers_check_the_ring():
    from repro_torch.kernels import events as ke

    nets, ms = _lanes("client")
    tnets = TE.stack_lanes([convert.network_params(_leaves(n), device="cpu")
                            for n in nets])
    st = TE.stack_lanes([TE.init_state(TE.lane(tnets, i), m,
                                       torch.tensor([0, s]), m_max=M_MAX)
                         for i, (m, s) in enumerate(zip(ms, SEEDS))])
    fs = torch.ones(2, 4, dtype=torch.float64)
    cn = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring.time"):
        ke.event_step_lanes(tnets, st, fs, cn,
                            ring=trings.event_ring_init(8, lanes=3,
                                                        device="cpu"))
    with pytest.raises(ValueError, match="EventRing"):
        ke.megastep_lanes(tnets, st, fs[:, None], cn[:, None], 1,
                          ring=trings.update_ring_init(8, lanes=2,
                                                       device="cpu"))
    ring = trings.event_ring_init(8, lanes=2, device="cpu")
    ke.megastep_lanes(tnets, st, fs[:, None].repeat(1, 3, 1),
                      cn[:, None].repeat(1, 3), [3, 1], ring=ring)
    assert ring.count.tolist() == [3, 1]  # masked events neither write nor count


# ---------------------------------------------------------------------------
# 3. the trainer's update ring
# ---------------------------------------------------------------------------

def test_trainer_update_ring_matches_jax_and_is_non_invasive():
    n, image, classes, batch, R = 4, 8, 4, 6, 12
    # one bucket of JAX's lane planner (one compile): alike lanes
    horizon, seeds, ms, etas = 25.0, [3, 4], [3, 3], [0.05, 0.08]
    full = make_synthetic_image_dataset(num_classes=classes,
                                        samples_per_class=16,
                                        image_size=image, seed=11)
    clients = [(full.x[i], full.y[i])
               for i in iid_partition(full.y, n, seed=11)]
    test = (full.x[::3], full.y[::3])
    rng = np.random.default_rng(11)
    rates = {k: rng.uniform(1.0, 4.0, n) for k in ("mu_c", "mu_d", "mu_u")}
    ps = [rng.dirichlet(np.ones(n) * 2.0)] * 2
    cfg = dict(eta=0.05, batch_size=batch, eval_every_time=5.0,
               eval_batch=16, grad_clip=2.0)
    jmodel = jmodels.mlp_classifier(image * image, classes, hidden=(8,))
    tmodel = tmodels.mlp_classifier(image * image, classes, hidden=(8,),
                                    device="cpu")
    base = jbz.NetworkParams(p=jnp.asarray(ps[0]),
                             **{k: jnp.asarray(v) for k, v in rates.items()})
    jtr = jeng.DeviceTrainer(jmodel, clients, base, JConfig(**cfg),
                             test_data=test, sim_backend="batched",
                             trace_updates=R)
    jtr.run_lanes(ps, ms, etas, seeds, horizon)
    want = [jrings.decode(r) for r in jtr.last_update_rings]

    # JAX's draws: each lane's initial state and events, its minibatches
    lane_j = [base._replace(p=jnp.asarray(p)) for p in ps]

    @jax.jit
    def events(net, key, m):
        st = JE.init_state(net, m, key, m_max=max(ms), t_cap=horizon)
        return st, JE.draw_event_blocks(net, st.key, 600)[1]

    @jax.jit
    def table(dkey, sizes):
        def body(k, _):
            k, kb = jax.random.split(k)
            return k, jax.vmap(lambda hi: jax.random.randint(
                kb, (batch,), 0, hi))(sizes)

        return jax.lax.scan(body, dkey, None, length=60)[1]

    sizes = jnp.asarray([len(y) for _, y in clients], jnp.int32)
    draws = [(*events(net, jax.random.fold_in(jax.random.PRNGKey(s), 1), m),
              table(jax.random.fold_in(jax.random.PRNGKey(s), 2), sizes))
             for net, s, m in zip(lane_j, seeds, ms)]
    inits = jax.vmap(jmodel.init)(jnp.stack([jax.random.PRNGKey(s)
                                             for s in seeds]))
    lane_t = [convert.network_params(_leaves(net), device="cpu")
              for net in lane_j]

    def run(trace_updates):
        ttr = teng.DeviceTrainer(
            tmodel, clients, lane_t[0], AsyncFLConfig(**cfg),
            test_data=test, sim_backend="batched",
            trace_updates=trace_updates, device="cpu")
        params0 = torch.stack([ttr.layout.flatten(convert.model_params(
            jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), inits),
            tmodel)) for i in range(2)])
        blocks = [convert.event_blocks(_leaves(d[1]), device="cpu")
                  for d in draws]
        stream = TE.EventStream.from_blocks(TE.EventBlocks(
            *[None if x[0] is None else torch.stack(x, 1)
              for x in zip(*blocks)]))
        state = TE.stack_lanes([convert.event_state(_leaves(d[0]),
                                                    device="cpu")
                                for d in draws])
        batches = teng.BatchStream.from_table(
            torch.stack([torch.as_tensor(np.array(d[2])) for d in draws]))
        dlog, fin = ttr.run_streams(params0, state, stream, batches, lane_t,
                                    etas, horizon)
        return ttr, dlog, fin

    ttr, dlog, fin = run(R)
    _, dlog0, fin0 = run(0)
    assert torch.equal(fin, fin0)
    for a, b in zip(dlog, dlog0):
        assert torch.equal(a, b)
    assert len(ttr.last_update_rings) == 2
    for lane, (ring, w) in enumerate(zip(ttr.last_update_rings, want)):
        got = trings.decode(ring)
        assert w["count"] == int(dlog.updates[lane]) and w["dropped"] > 0
        np.testing.assert_allclose(got.pop("grad_norm"),
                                   w.pop("grad_norm"), rtol=1e-4)
        _same_decoded(got, w, what=f"update ring lane {lane}")


# ---------------------------------------------------------------------------
# 4. drift monitors and the Perfetto export
# ---------------------------------------------------------------------------

def _check_schema(spec, value, path="$"):
    """``value`` has exactly ``spec``'s shape (``tests/data/
    trace_schema.json``: type names, one-item lists, ``__each__``)."""
    if isinstance(spec, str):
        kinds = {"str": str, "int": int, "number": (int, float),
                 "any": object}
        assert isinstance(value, kinds[spec]), f"{path}: {value!r} not {spec}"
        if spec in ("int", "number"):
            assert not isinstance(value, bool), path
    elif isinstance(spec, list):
        assert isinstance(value, list), path
        for i, item in enumerate(value):
            _check_schema(spec[0], item, f"{path}[{i}]")
    elif "__each__" in spec:
        for k, v in value.items():
            _check_schema(spec["__each__"], v, f"{path}.{k}")
    else:
        assert set(spec) == set(value), (path, sorted(spec), sorted(value))
        for k in spec:
            _check_schema(spec[k], value[k], f"{path}.{k}")


def _close(got: dict, want: dict):
    """Two drift reports: the same flags and keys, numbers within ``rtol
    1e-10``."""
    assert got["ok"] == want["ok"] and got["law"] == want["law"]
    assert len(got["checks"]) == len(want["checks"])
    for g, w in zip(got["checks"], want["checks"]):
        assert g["metric"] == w["metric"] and g["ok"] == w["ok"]
        for k in ("empirical", "predicted", "rel_err", "tol"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("with_cs", [False, True])
def test_predict_matches_jax(with_cs):
    jnet, tnet = _smoke_net(with_cs)
    jp, tp = jdrift.predict(jnet, 4), tdrift.predict(tnet, 4)
    assert set(jp) == set(tp) and tp["occupancy"] == jp["occupancy"] == 4.0
    np.testing.assert_allclose(tp["throughput"], jp["throughput"],
                               rtol=1e-10)
    np.testing.assert_allclose(tp["delays"], jp["delays"], rtol=1e-10)


def _smoke_net(with_cs=False):
    """The CLI smoke scenario's network (n = 4, ``rng(0)``) in both
    packages."""
    rng = np.random.default_rng(0)
    mu_c = 0.8 + 0.4 * rng.random(4)
    jnet = jbz.NetworkParams(p=jnp.full(4, 0.25), mu_c=jnp.asarray(mu_c),
                             mu_d=jnp.full(4, 4.0), mu_u=jnp.full(4, 4.0))
    jnet = jnet.with_cs(4.0) if with_cs else jnet
    return jnet, convert.network_params(_leaves(jnet), device="cpu")


@pytest.fixture(scope="module")
def smoke_file(tmp_path_factory):
    """The port's ``smoke --device cpu`` export (one seed)."""
    path = str(tmp_path_factory.mktemp("obs") / "trace.json")
    assert torch_cli(["smoke", "--device", "cpu", "--out", path,
                      "--updates", "1000", "--warmup", "100", "--events",
                      "2048", "--seeds", "1"]) == 0
    return path


def test_drift_report_and_perfetto_match_jax(smoke_file):
    with open(smoke_file) as fh:
        meta = json.load(fh)["metadata"]
    decoded = {k: (np.asarray(v, np.float64 if k == "time" else np.int32)
                   if isinstance(v, list) else v)
               for k, v in meta["ring_data"].items()}
    assert decoded["dropped"] > 0  # a window past the start
    jnet, tnet = _smoke_net()
    preds = meta["predictions"]
    for law in ("exponential", "lognormal"):
        _close(tdrift.drift_report(decoded, predictions=preds, law=law),
               jdrift.drift_report(decoded, predictions=preds, law=law))
    got = tdrift.drift_report(decoded, params=tnet, m=4)
    _close(got, jdrift.drift_report(decoded, params=jnet, m=4))
    assert got["ok"], got
    bad = dict(decoded, time=decoded["time"] * 3.0)
    _close(tdrift.drift_report(bad, predictions=preds),
           jdrift.drift_report(bad, predictions=preds))

    host = [{"name": "suite.dispatch", "labels": {"mode": "simulate"},
             "start": 100.0, "duration": 0.5}]
    builds = [("nvcc:events", 100.8, 0.3)]
    kw = dict(name="lane0", host_spans=host, compile_spans=builds,
              metadata={"predictions": preds})
    doc = ttrace.perfetto_trace(decoded, 4, **kw)
    assert json.dumps(doc) == json.dumps(jtrace.perfetto_trace(decoded, 4,
                                                               **kw))
    with open(os.path.join(DATA_DIR, "trace_schema.json")) as fh:
        golden = json.load(fh)
    _check_schema(golden, ttrace.perfetto_trace(decoded, 4, host_spans=host,
                                                compile_spans=builds))
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i"}
    occ = ttrace.station_occupancy(decoded, 4)
    assert np.array_equal(occ, jtrace.station_occupancy(decoded, 4))
    np.testing.assert_allclose(occ.sum(), 4.0, rtol=1e-9)


# ---------------------------------------------------------------------------
# 5. the CLI
# ---------------------------------------------------------------------------

def test_cli_smoke_file_passes_both_checks(smoke_file, tmp_path, capsys):
    assert torch_cli(["check", smoke_file]) == 0
    assert jax_cli(["check", smoke_file]) == 0
    assert torch_cli(["report", smoke_file]) == 0
    with open(smoke_file) as fh:
        doc = json.load(fh)
    ring = doc["metadata"]["ring_data"]
    assert ring["count"] == doc["metadata"]["ring"]["count"] > 3000
    assert doc["metadata"]["scenario"]["name"] == "obs_smoke"
    ring["time"] = [3.0 * t for t in ring["time"]]  # a stretched clock
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as fh:
        json.dump(doc, fh)
    assert torch_cli(["check", bad]) == 1
    assert jax_cli(["check", bad]) == 1
    assert "DRIFT" in capsys.readouterr().out
