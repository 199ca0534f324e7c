"""The port's sharded lane backend (``repro_torch.sim.sharded``) and
``batched_concurrency_sweep(shard=True)``.

Bitwise contract, as the JAX package's ``tests/test_sharded.py`` states
it: a lane's program is lane-local and a sweep's rows are row-local, so a
split over devices changes where a lane or a row runs, never its bits.
The lanes and rows split over three CPU devices (``lane_devices``
patched: three worker threads, a ragged split, the gather in order) and
unsplit (one device: the ``batched`` runner itself), each against the
port's ``batched`` backend or the unsharded sweep, every leaf bitwise:
client lanes with and without the CS station, class lanes, ``chunk = 8``
against ``chunk = 1``, a traced run (the ring and its statistics, and
those the untraced run's), a suite, ``next_update`` and a short
``DeviceTrainer`` run.  The sweep's grid leaves the last shard at a lower
``max(m)``: the padding comes from the whole grid.

Against the JAX package: its ``batched`` backend at the same seed (the
JAX ``sharded`` tests are reference caveats): discrete leaves exact,
floats ``rtol 1e-12``; its ``batched_concurrency_sweep(shard=False)`` at
``tests/test_torch_optimize.py``'s bounds (values ``rtol 1e-6``, routing
``atol 1e-6``, ``best.m`` exact).
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
from repro.sim import batched_events as jlanes
from repro_torch import convert
from repro_torch.core import batched as tbat
from repro_torch.core import buzen as tbz
from repro_torch.core import events as TE
from repro_torch.core import prng
from repro_torch.core.optimize import batched_concurrency_sweep
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import engine as teng
from repro_torch.fl import models as tmodels
from repro_torch.fl.trainer import AsyncFLConfig
from repro_torch.scenario import spec as T
from repro_torch.scenario import suite as TS
from repro_torch.scenario.spec import LearningSpec
from repro_torch.sim import (BACKENDS, batched_events, build_class_lanes_fn,
                             build_lanes_fn, device_count, sharded,
                             simulate_stats_lanes, stack_lanes)

CPU = torch.device("cpu")
SPLITS = {"split": [CPU] * 3, "one": [CPU]}


@pytest.fixture(params=sorted(SPLITS))
def devices(request, monkeypatch):
    """``lane_devices`` patched to three CPU devices, or to one."""
    monkeypatch.setattr(sharded, "lane_devices",
                        lambda device: SPLITS[request.param])
    return SPLITS[request.param]


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _net(seed, n=6, with_cs=False):
    rng = np.random.default_rng(seed)
    net = tbz.NetworkParams(p=_t(rng.dirichlet(np.ones(n) * 2.0)),
                            mu_c=_t(rng.uniform(0.5, 4.0, n)),
                            mu_d=_t(rng.uniform(0.5, 4.0, n)),
                            mu_u=_t(rng.uniform(0.5, 4.0, n)))
    return net.with_cs(1.5) if with_cs else net


def _classes(seed):
    rng = np.random.default_rng(seed)
    cnt = np.array([3, 2, 5])
    return tbz.ClassParams(p=_t(rng.dirichlet(np.ones(3)) / cnt),
                           mu_c=_t(rng.uniform(0.5, 4.0, 3)),
                           mu_d=_t(rng.uniform(2.0, 6.0, 3)),
                           mu_u=_t(rng.uniform(2.0, 6.0, 3)),
                           count=torch.as_tensor(cnt))


def _equal(a, b):
    """Every tensor leaf of two (nested) results bitwise equal."""
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            _equal(x, y)


LANES = dict(warmup=50, m_max=5, seeds=range(5))
MS = [3, 4, 5, 3, 4]


def test_sharded_backend_registered():
    assert "sharded" in BACKENDS


def test_device_count_positive():
    assert device_count() >= 1


@pytest.mark.parametrize("with_cs", [False, True])
def test_sharded_lanes_bitwise_vs_batched(devices, with_cs):
    lanes = [_net(s, with_cs=with_cs) for s in range(5)]
    want = simulate_stats_lanes(lanes, MS, 200, backend="batched", **LANES)
    got = simulate_stats_lanes(lanes, MS, 200, backend="sharded", **LANES)
    _equal(got, want)
    # megasteps on the shards: chunk 8 is chunk 1's trajectory
    _equal(simulate_stats_lanes(lanes, MS, 200, backend="sharded", chunk=8,
                                **LANES), want)


def test_sharded_class_lanes_bitwise_vs_batched(devices):
    lane_classes = stack_lanes([_classes(s) for s in range(4)])
    m_vec = [3, 4, 5, 3]
    keys = prng.seed_keys(range(4), device="cpu")
    fb = build_class_lanes_fn("batched", 200, 50, "exponential", 5, False)
    fs = build_class_lanes_fn("sharded", 200, 50, "exponential", 5, False)
    _equal(fs(lane_classes, m_vec, keys, None),
           fb(lane_classes, m_vec, keys, None))


def test_traced_sharded_lanes_bitwise_vs_batched(devices):
    lanes = stack_lanes([_net(s) for s in range(5)])
    keys = prng.seed_keys(range(5), device="cpu")
    args = (lanes, MS, keys, None)
    untraced = build_lanes_fn("sharded", 150, 30, "hyperexponential", 5,
                              False)(*args)
    want = build_lanes_fn("batched", 150, 30, "hyperexponential", 5, False,
                          trace_events=256, chunk=8)(*args)
    got = build_lanes_fn("sharded", 150, 30, "hyperexponential", 5, False,
                         trace_events=256, chunk=8)(*args)
    _equal(got, want)
    _equal(got[0], untraced)
    assert got[1].count.tolist() == want[1].count.tolist()


def test_sharded_power_lanes_bitwise_vs_batched(devices):
    from repro_torch.core.energy import PowerProfile

    lanes = [_net(s, with_cs=True) for s in range(5)]
    rng = np.random.default_rng(3)
    power = [PowerProfile(P_c=_t(rng.uniform(1, 3, 6)),
                          P_u=_t(rng.uniform(1, 3, 6)),
                          P_d=_t(rng.uniform(1, 3, 6)), P_cs=_t(2.0))
             for _ in range(5)]
    want = simulate_stats_lanes(lanes, MS, 100, backend="batched",
                                power=power, **LANES)
    got = simulate_stats_lanes(lanes, MS, 100, backend="sharded",
                               power=power, **LANES)
    _equal(got, want)
    assert bool((got.energy > 0).all())


def test_class_lanes_on_kernel_still_raise():
    with pytest.raises(ValueError, match="no kernel"):
        build_class_lanes_fn("kernel", 100, 0, "exponential", 4, False)


def test_a_worker_failure_fails_the_call(monkeypatch):
    # no fallback: the shard's exception is the caller's
    monkeypatch.setattr(sharded, "lane_devices", lambda device: [CPU] * 3)
    calls = []

    def broken(lane_params, ms, *a, **k):
        calls.append(len(ms))
        raise RuntimeError("shard failed")

    monkeypatch.setattr(batched_events, "run_lanes", broken)
    with pytest.raises(RuntimeError, match="shard failed"):
        sharded.run_sharded_lanes(stack_lanes([_net(s) for s in range(5)]),
                                  MS, prng.seed_keys(range(5), device="cpu"),
                                  50, warmup=0, distribution="exponential",
                                  m_max=5)
    assert sorted(calls) == [1, 2, 2]


def test_launch_counts_lose_nothing_across_threads():
    # the shards' wrappers count launches from their worker threads at once
    import sys
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000


def test_split_bounds_are_contiguous_and_near_equal():
    assert sharded.split_bounds(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert sharded.split_bounds(2, 3) == [(0, 1), (1, 2)]
    assert sharded.split_bounds(6, 1) == [(0, 6)]


def test_sharded_suite_bitwise_vs_batched(devices):
    rows = (T.ClusterSpec("A", 1.0, 6.0, 6.0, 3),
            T.ClusterSpec("B", 2.0, 7.0, 7.0, 3))
    base = T.Scenario(network=T.NetworkSpec.from_clusters(rows),
                      learning=T.LearningSpec())

    def run(backend):
        suite = TS.ScenarioSuite(
            {"a": base.with_strategy("asyncsgd", m=4),
             "b": base.with_strategy("asyncsgd", m=2)}, seeds=(0, 1, 2),
            device="cpu")
        return suite.run(mode="simulate", num_updates=150, warmup=30,
                         backend=backend)

    ra, rb = run("batched"), run("sharded")
    assert ra.programs == rb.programs == 1 and ra.lanes == rb.lanes
    for k in ra.entries:
        for a, b in zip(ra.entries[k], rb.entries[k]):
            _equal(b, a)


def test_next_update_and_trainer_sharded_is_batched():
    net = _net(4, n=4, with_cs=True)
    keys = prng.seed_keys(range(3), device="cpu")
    outs = {}
    for be in ("batched", "sharded"):
        lanes = stack_lanes([net] * 3)
        st = stack_lanes([TE.init_state(net, 3, k, m_max=4) for k in keys])
        stream = TE.EventStream([net] * 3, TE.event_key(keys))
        for _ in range(5):
            st, out = TE.next_update(lanes, st, stream, backend=be, chunk=4)
        outs[be] = (st, out)
    _equal(outs["sharded"], outs["batched"])

    full = make_synthetic_image_dataset(num_classes=4, samples_per_class=16,
                                        image_size=8, seed=5)
    parts = iid_partition(full.y, 4, seed=5)
    clients = [(full.x[i], full.y[i]) for i in parts]
    cfg = AsyncFLConfig(eta=0.05, batch_size=6, eval_every_time=4.0,
                        eval_batch=16, grad_clip=1.0)
    runs = []
    for be in ("batched", "sharded"):
        model = tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu")
        tr = teng.DeviceTrainer(model, clients, net, cfg,
                                test_data=(full.x[::3], full.y[::3]),
                                sim_backend=be, sim_chunk=4, device="cpu")
        runs.append(tr.run_lanes([np.full(4, 0.25)] * 2, [3, 3],
                                 [0.05, 0.1], [0, 1], 12.0))
    (la, fa), (lb, fb) = runs
    assert torch.equal(fa, fb) and la[0].updates[-1] > 5
    for x, y in zip(la, lb):
        for f in ("times", "losses", "accuracies", "updates", "throughput"):
            assert getattr(x, f) == getattr(y, f), f


def test_sharded_lanes_match_jax_batched_same_seed():
    jl = [jbz.NetworkParams(**{k: jnp.asarray(v.numpy()) for k, v in
                               _net(s)._asdict().items() if v is not None})
          for s in range(5)]
    want = jlanes.simulate_stats_lanes(jl, MS, 200, backend="batched",
                                       **LANES)
    lanes = [convert.network_params({k: None if v is None else np.asarray(v)
                                     for k, v in net._asdict().items()},
                                    device="cpu")
             for net in jl]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharded, "lane_devices", lambda device: [CPU] * 3)
        got = simulate_stats_lanes(lanes, MS, 200, backend="sharded",
                                   **LANES)
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
        else:
            assert np.array_equal(g, w), name


# -- batched_concurrency_sweep(shard=True) -----------------------------------

CONSTS = LearningSpec().consts
GRID = np.arange(2, 13)  # 11 rows: shards of 4, 4, 3, the last at m <= 12
M = 12


def _sweep_inputs(kind):
    if kind == "client":
        net = _net(21, n=5)
        return net, tbat.make_time_objective_padded(net, CONSTS, M)
    cls = T.ClassSpec.from_clusters(T.PAPER_CLUSTERS_TABLE1
                                    ).class_params(device="cpu")
    return cls, tbat.make_time_objective_classes(cls, CONSTS, M)


@pytest.mark.parametrize("kind", ["client", "class"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_shard_sweep_bitwise_vs_unsharded(devices, kind, backend):
    params, obj = _sweep_inputs(kind)
    grid = GRID[:-1]  # the last shard stops at m = 10, below the padding
    kw = dict(m_grid=grid, m_max=M, steps=12, backend=backend)
    want = batched_concurrency_sweep(obj, params, **kw)
    got = batched_concurrency_sweep(obj, params, shard=True, **kw)
    assert torch.equal(got.p, want.p)
    assert np.array_equal(got.values, want.values)
    assert got.best.m == want.best.m and got.best.value == want.best.value


def test_shard_sweep_pruned_and_pareto(devices):
    from repro_torch.core.energy import PowerProfile
    from repro_torch.core.optimize import (pareto_sweep,
                                           pruned_concurrency_sweep)

    net, obj = _sweep_inputs("client")
    kw = dict(m_grid=GRID, steps=8, backend="torch")
    a = pruned_concurrency_sweep(obj, net, **kw)
    b = pruned_concurrency_sweep(obj, net, shard=True, **kw)
    assert torch.equal(a.p, b.p) and np.array_equal(a.values, b.values)
    rng = np.random.default_rng(2)
    power = PowerProfile(P_c=_t(rng.uniform(1, 3, 5)),
                         P_u=_t(rng.uniform(1, 3, 5)),
                         P_d=_t(rng.uniform(1, 3, 5)))
    args = (net, CONSTS, power, (0.0, 0.5, 1.0), 10.0, 100.0)
    a, _ = pareto_sweep(*args, m_max=6, steps=6)
    b, _ = pareto_sweep(*args, m_max=6, steps=6, shard=True)
    assert torch.equal(a.p, b.p) and np.array_equal(a.values, b.values)


def test_shard_sweep_needs_a_movable_objective(monkeypatch):
    net, obj = _sweep_inputs("client")

    def bare(p, m, logZ):
        return obj(p, m, logZ)

    monkeypatch.setattr(sharded, "lane_devices", lambda device: [CPU] * 3)
    with pytest.raises(TypeError, match=r"\.to\(device\)"):
        batched_concurrency_sweep(bare, net, m_grid=GRID, steps=1,
                                  shard=True)
    # on one device nothing moves: any objective runs
    monkeypatch.setattr(sharded, "lane_devices", lambda device: [CPU])
    batched_concurrency_sweep(bare, net, m_grid=GRID, steps=1, shard=True)


@pytest.mark.parametrize("kind", ["client", "class"])
def test_shard_sweep_matches_jax(kind, monkeypatch):
    monkeypatch.setattr(sharded, "lane_devices", lambda device: [CPU] * 3)
    params, obj = _sweep_inputs(kind)
    leaves = {k: None if v is None else jnp.asarray(v.numpy())
              for k, v in params._asdict().items()}
    jc = jcx.LearningConstants(**CONSTS._asdict())
    if kind == "client":
        jp = jbz.NetworkParams(**leaves)
        jobj = jbat.make_time_objective_padded(jp, jc, M)
    else:
        jp = jbz.ClassParams(**leaves)
        jobj = jbat.make_time_objective_classes(jp, jc, M)
    want = jopt.batched_concurrency_sweep(jobj, jp, m_grid=jnp.asarray(GRID),
                                          m_max=M, steps=40, backend="jnp")
    got = batched_concurrency_sweep(obj, params, m_grid=GRID, m_max=M,
                                    steps=40, backend="torch", shard=True)
    np.testing.assert_array_equal(got.m_grid, np.asarray(want.m_grid))
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               rtol=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)
    assert got.best.m == want.best.m
