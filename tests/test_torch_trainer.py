"""The port's AsyncSGD trainer (``repro_torch.fl``).

1. Against the JAX package: the port's ``DeviceTrainer.run_streams`` fed
   what JAX's ``DeviceTrainer.run_lanes`` draws — each lane's initial
   ``EventState`` and its ``draw_event_blocks`` stream, the initial
   parameters (converted by ``convert.model_params``) and the minibatch
   indices (``dkey = fold_in(PRNGKey(seed), 2)``, then per update
   ``split`` and ``randint(kb, (batch,), 0, sizes[c])``, here for every
   client ``c``) — reproduces JAX's run (``use_fused_update=False``,
   ``backend="batched"``; the exponential, deterministic and
   hyperexponential laws) on 2 lanes and about 30 updates: update counts,
   ``delay_counts``, ``mean_delay``, throughput, energy and
   ``grid_updates`` bitwise; final parameters at ``rtol 1e-4, atol 1e-5``
   (float32 gradients in two frameworks); grid losses at ``rtol 1e-4``;
   accuracies within one eval sample.  The CS case runs through the lane
   mode (``nets=``), where JAX's network is a jit argument (ROADMAP,
   reference caveats).
2. Contracts inside the port, bitwise on the CPU: ``sim_chunk`` 4 equals
   chunk 1, the fused update equals the plain one, each lane equals its
   single-lane run, mixed-``n`` lanes equal each scenario at its own size,
   ``max_updates`` caps, the eval grid is complete.
3. Statistically against the port's host loop (``backend="host"``):
   throughput within ``rtol 0.35`` (and within ``0.15`` of Prop. 4 over
   four seed lanes) and the staleness identity
   ``sum_i p_i E0[R_i] = m - 1`` within 1.
"""
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
from repro_torch import convert
from repro_torch.core import buzen as tbz
from repro_torch.core import jackson
from repro_torch.core import events as TE
from repro_torch.core.energy import PowerProfile
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import engine as teng
from repro_torch.fl import models as tmodels
from repro_torch.fl.trainer import AsyncFLConfig, AsyncFLTrainer

N_EVENTS = 1500   # drawn events per lane (>= the events ~30 updates take)
N_ROUNDS = 120    # minibatch-table rounds per lane


def _problem(seed, n, image=8, classes=4, spc=16):
    full = make_synthetic_image_dataset(num_classes=classes,
                                        samples_per_class=spc,
                                        image_size=image, seed=seed)
    parts = iid_partition(full.y, n, seed=seed)
    clients = [(full.x[i], full.y[i]) for i in parts]
    rng = np.random.default_rng(seed)
    test = (full.x[::3], full.y[::3])
    rates = {k: rng.uniform(1.0, 4.0, n) for k in ("mu_c", "mu_d", "mu_u")}
    return clients, test, rates


def _jnet(rates, p, mu_cs=None):
    net = jbz.NetworkParams(p=jnp.asarray(p), **{
        k: jnp.asarray(v) for k, v in rates.items()})
    return net if mu_cs is None else net.with_cs(mu_cs)


def _tnet(rates, p, mu_cs=None):
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)

    net = tbz.NetworkParams(p=t(p), **{k: t(v) for k, v in rates.items()})
    return net if mu_cs is None else net.with_cs(mu_cs)


def _leaves(tree):
    """numpy leaves; a tuple leaf (the H2 unit pair) stays a tuple."""
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


def _models(kind, image, classes):
    if kind == "mlp":
        return (jmodels.mlp_classifier(image * image, classes, hidden=(8,)),
                tmodels.mlp_classifier(image * image, classes, hidden=(8,),
                                       device="cpu"))
    return (jmodels.cnn_classifier(image, classes, channels=(2, 3),
                                   kernel=3),
            tmodels.cnn_classifier(image, classes, channels=(2, 3), kernel=3,
                                   device="cpu"))


def _jax_draws(jnets, ms, seeds, horizon, dist, sizes, batch):
    """What JAX's run_lanes draws per lane: the initial state, its event
    blocks and the within-client minibatch index of every client for each
    round."""
    m_max = max(ms)

    @jax.jit
    def events(net, key, m):
        st = JE.init_state(net, m, key, m_max=m_max, distribution=dist,
                           t_cap=horizon)
        _, blk = JE.draw_event_blocks(net, st.key, N_EVENTS,
                                      distribution=dist)
        return st, blk

    @jax.jit
    def table(dkey, sizes):
        def body(k, _):
            k, kb = jax.random.split(k)
            return k, jax.vmap(lambda hi: jax.random.randint(
                kb, (batch,), 0, hi))(sizes)

        return jax.lax.scan(body, dkey, None, length=N_ROUNDS)[1]

    out = []
    for net, m, s, sz in zip(jnets, ms, seeds, sizes):
        key = jax.random.PRNGKey(s)
        st, blk = events(net, jax.random.fold_in(key, 1), m)
        out.append((st, blk, table(jax.random.fold_in(key, 2),
                                   jnp.asarray(sz, jnp.int32))))
    return out


def _sizes(clients, n):
    return np.concatenate([[len(y) for _, y in clients],
                           np.ones(n - len(clients), np.int64)])


CASES = {
    # model, law, CS rate (through the lane mode), padded rows
    "mlp-exponential": ("mlp", "exponential", None, 0),
    "cnn-deterministic": ("cnn", "deterministic", None, 0),
    "mlp-exponential-cs-lanes": ("mlp", "exponential", 3.0, 2),
    "mlp-hyperexponential": ("mlp", "hyperexponential", None, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_fed_jax_draws_matches_jax(case):
    kind, dist, mu_cs, pad = CASES[case]
    n, image, classes, batch = 4, 8, 4, 6
    horizon, seeds, ms = 30.0, [3, 4], [2, 3]
    clients, test, rates = _problem(11, n, image, classes)
    rng = np.random.default_rng(2)
    ps = [np.full(n, 1.0 / n), rng.dirichlet(np.ones(n) * 2.0)]
    jmodel, tmodel = _models(kind, image, classes)
    jcfg = JConfig(eta=0.05, batch_size=batch, eval_every_time=6.0,
                   eval_batch=16, grad_clip=2.0, distribution=dist)
    tcfg = AsyncFLConfig(eta=0.05, batch_size=batch, eval_every_time=6.0,
                         eval_batch=16, grad_clip=2.0, distribution=dist)
    etas = [0.05, 0.08]

    lane_mode = mu_cs is not None
    base = _jnet(rates, np.full(n, 1.0 / n), mu_cs)
    if lane_mode:
        # two scenarios of different populations, both padded to n + pad
        jn = [jbz.pad_network(base, n + pad),
              jbz.pad_network(_jnet({k: v[:n - 1] for k, v in rates.items()},
                                    np.full(n - 1, 1.0 / (n - 1)), mu_cs),
                              n + pad)]
        ps = [np.concatenate([ps[0], np.zeros(pad)]),
              np.concatenate([ps[1][:n - 1] / ps[1][:n - 1].sum(),
                              np.zeros(pad + 1)])]
        lane_clients = [clients, clients[:n - 1]]
        jtr = jeng.DeviceTrainer(jmodel, clients, jn[0], jcfg,
                                 test_data=test, sim_backend="batched")
    else:
        jn = None
        lane_clients = None
        jtr = jeng.DeviceTrainer(jmodel, clients, base, jcfg,
                                 test_data=test, sim_backend="batched")

    seen = []  # (sim keys, DeviceTrainLog) of each bucket JAX ran
    run_bucket = jtr._run_bucket

    def spy(ps_, ms_, etas_, sim_keys, *a, **kw):
        out = run_bucket(ps_, ms_, etas_, sim_keys, *a, **kw)
        seen.append((np.asarray(sim_keys), out[0]))
        return out

    jtr._run_bucket = spy
    jlogs, jfin = jtr.run_lanes(ps, ms, etas, seeds, horizon, nets=jn,
                                lane_clients=lane_clients)

    # JAX's draws, fed to the port
    lane_j = [(jn[i] if lane_mode else base)._replace(p=jnp.asarray(ps[i]))
              for i in range(2)]
    rows = n + pad
    sizes = [_sizes(lane_clients[i] if lane_mode else clients, rows)
             for i in range(2)]
    draws = _jax_draws(lane_j, ms, seeds, horizon, dist, sizes, batch)
    state = TE.stack_lanes([convert.event_state(_leaves(d[0]), device="cpu")
                            for d in draws])
    blocks = [convert.event_blocks(_leaves(d[1]), device="cpu")
              for d in draws]
    stream = TE.EventStream.from_blocks(
        TE.EventBlocks(*[None if x[0] is None else torch.stack(x, 1)
                         for x in zip(*blocks)]), distribution=dist)
    batches = teng.BatchStream.from_table(
        torch.stack([torch.as_tensor(np.array(d[2])) for d in draws]))
    inits = jax.vmap(jmodel.init)(jnp.stack([jax.random.PRNGKey(s)
                                             for s in seeds]))
    ttr = teng.DeviceTrainer(
        tmodel, clients,
        convert.network_params(_leaves(jn[0] if lane_mode else base),
                               device="cpu"),
        tcfg, test_data=test, sim_backend="batched", device="cpu")
    params0 = torch.stack([ttr.layout.flatten(convert.model_params(
        jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), inits),
        tmodel)) for i in range(2)])
    lane_t = [convert.network_params(_leaves(net), device="cpu")
              for net in lane_j]
    dlog, fin = ttr.run_streams(params0, state, stream, batches, lane_t,
                                etas, horizon, lane_clients=lane_clients)

    for i, s in enumerate(seeds):
        want_key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), 1))
        (jd, row), = [(d, r) for keys, d in seen
                      for r in range(keys.shape[0])
                      if np.array_equal(keys[r], want_key)]
        for name in ("updates", "delay_counts", "mean_delay", "throughput",
                     "energy", "grid_updates", "grid_times", "t_end"):
            assert np.array_equal(getattr(dlog, name)[i].numpy(),
                                  np.asarray(getattr(jd, name)[row])), name
        assert int(dlog.updates[i]) >= 20
        want = ttr.layout.flatten(convert.model_params(
            jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), jfin),
            tmodel))
        np.testing.assert_allclose(fin[i].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    n_acts = [int(net.active_count) for net in lane_t]
    for tl, jl in zip(ttr.train_logs(dlog, n_acts), jlogs):
        assert tl.times == jl.times and tl.updates == jl.updates
        np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-4)
        np.testing.assert_allclose(tl.accuracies, jl.accuracies,
                                   atol=1.0 / 16 + 1e-6)
        assert np.array_equal(tl.mean_delay, jl.mean_delay)
        assert tl.throughput == jl.throughput and tl.energy == jl.energy


# ---------------------------------------------------------------------------
# contracts inside the port (bitwise, CPU)
# ---------------------------------------------------------------------------

def _setup(n=4, mu_cs=None, seed=5, power=False):
    clients, test, rates = _problem(seed, n)
    net = _tnet(rates, np.full(n, 1.0 / n), mu_cs)
    pw = None
    if power:
        rng = np.random.default_rng(seed)
        t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
        pw = PowerProfile(P_c=t(rng.uniform(1, 3, n)),
                          P_u=t(rng.uniform(1, 3, n)),
                          P_d=t(rng.uniform(1, 3, n)),
                          P_cs=None if mu_cs is None else t(2.0))
    return clients, test, rates, net, pw


def _config(**kw):
    base = dict(eta=0.05, batch_size=6, eval_every_time=4.0, eval_batch=16,
                grad_clip=1.0)
    base.update(kw)
    return AsyncFLConfig(**base)


def _run(clients, test, net, cfg, ps, ms, etas, seeds, horizon, pw=None,
         **kw):
    chunk = kw.pop("sim_chunk", 1)
    backend = kw.pop("sim_backend", "batched")
    model = tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu")
    tr = teng.DeviceTrainer(model, clients, net, cfg, test_data=test,
                            power=pw, sim_backend=backend, sim_chunk=chunk,
                            device="cpu")
    return tr.run_lanes(ps, ms, etas, seeds, horizon, **kw)


def _same_logs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("times", "accuracies", "losses", "updates", "throughput",
                  "energy"):
            assert getattr(x, f) == getattr(y, f), f
        assert np.array_equal(x.mean_delay, y.mean_delay)


def _plain_apply(w, g, scale):
    """The apply as plain PyTorch, in place of the fused update."""
    return w - scale[:, None] * g, None


@pytest.mark.parametrize("variant", [
    dict(sim_chunk=4), dict(sim_chunk=7, sim_backend="kernel"),
    dict(plain_update=True), dict(plain_update=True, sim_chunk=4)])
def test_chunk_and_fused_update_bitwise(variant, monkeypatch):
    clients, test, rates, net, pw = _setup(mu_cs=2.5, power=True)
    rng = np.random.default_rng(1)
    ps = [np.full(4, 0.25), rng.dirichlet(np.ones(4))]
    args = (ps, [3, 3], [0.05, 0.1], [0, 1], 16.0)
    base_logs, base_fin = _run(clients, test, net, _config(), *args, pw=pw)
    variant = dict(variant)
    if variant.pop("plain_update", False):
        monkeypatch.setattr(teng, "fused_async_update_flat", _plain_apply)
    logs, fin = _run(clients, test, net, _config(), *args, pw=pw, **variant)
    assert base_logs[0].updates[-1] > 10
    assert all(lg.energy > 0 for lg in base_logs)
    _same_logs(base_logs, logs)
    assert torch.equal(base_fin, fin)


def test_lanes_equal_single_lane_runs():
    clients, test, rates, net, _ = _setup()
    rng = np.random.default_rng(4)
    ps = [rng.dirichlet(np.ones(4)) for _ in range(3)]
    etas, seeds = [0.05, 0.02, 0.1], [7, 8, 9]
    logs, fin = _run(clients, test, net, _config(), ps, [3, 3, 3], etas,
                     seeds, 14.0)
    for i in range(3):
        one, one_fin = _run(clients, test, net, _config(), [ps[i]], [3],
                            [etas[i]], [seeds[i]], 14.0)
        _same_logs([logs[i]], one)
        assert torch.equal(fin[i], one_fin[0])
    assert len({lg.updates[-1] for lg in logs}) > 1


def test_mixed_n_lanes_equal_each_scenario_at_its_size():
    n_max = 6
    ca, test, rates_a, net_a, pw_a = _setup(n=4, mu_cs=3.0, seed=5,
                                            power=True)
    cb, _, rates_b, net_b, pw_b = _setup(n=3, mu_cs=3.0, seed=6, power=True)
    rng = np.random.default_rng(8)
    pa, pb = rng.dirichlet(np.ones(4)), rng.dirichlet(np.ones(3))

    def pad_power(pw, n):
        z = torch.zeros(n_max - n, dtype=torch.float64)
        return PowerProfile(*[x if x is None or x.dim() == 0
                              else torch.cat([x, z]) for x in pw])

    cfg = _config(grad_clip=None)
    model = tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu")
    tr = teng.DeviceTrainer(model, ca, tbz.pad_network(net_a, n_max), cfg,
                            test_data=test, sim_backend="batched",
                            device="cpu")
    logs, fin = tr.run_lanes(
        [np.concatenate([pa, np.zeros(2)]), np.concatenate([pb, np.zeros(3)])],
        [3, 3], [0.05, 0.05], [1, 2], 14.0,
        nets=[tbz.pad_network(net_a, n_max), tbz.pad_network(net_b, n_max)],
        lane_clients=[ca, cb],
        lane_powers=[pad_power(pw_a, 4), pad_power(pw_b, 3)])
    for i, (cl, net, p, pw, s) in enumerate([(ca, net_a, pa, pw_a, 1),
                                             (cb, net_b, pb, pw_b, 2)]):
        one, one_fin = _run(cl, test, net, cfg, [p], [3], [0.05], [s], 14.0,
                            pw=pw)
        _same_logs([logs[i]], one)
        assert torch.equal(fin[i], one_fin[0])
    assert logs[1].mean_delay.shape == (3,)


def test_max_updates_caps_and_grid_is_complete():
    clients, test, rates, net, _ = _setup()
    cfg = _config()
    ps = [np.full(4, 0.25)] * 2
    logs, _ = _run(clients, test, net, cfg, ps, [3, 3], [0.05] * 2, [0, 1],
                   20.0)
    for lg in logs:
        # grid 0, 4, ..., 16 below t_end = horizon, then the final point
        assert lg.times == [0.0, 4.0, 8.0, 12.0, 16.0, 20.0]
        assert lg.updates[0] == 0
        assert all(a <= b for a, b in zip(lg.updates, lg.updates[1:]))
        assert np.isfinite(lg.losses).all()
        assert all(0.0 <= a <= 1.0 for a in lg.accuracies)
    capped, _ = _run(clients, test, net, cfg, ps, [3, 3], [0.05] * 2, [0, 1],
                     20.0, max_updates=5)
    for lg, full in zip(capped, logs):
        assert lg.updates[-1] == 5 < full.updates[-1]
        assert lg.times[-1] < 20.0
        assert lg.throughput == pytest.approx(5 / lg.times[-1], rel=1e-12)
        # the grid before the cap is the uncapped run's
        k = len(lg.times) - 1
        assert lg.times[:k] == full.times[:k]
        assert lg.losses[:k] == full.losses[:k]
    with pytest.raises(ValueError, match="max_updates"):
        _run(clients, test, net, cfg, ps, [3, 3], [0.05] * 2, [0, 1], 20.0,
             max_updates=0)


def test_config_and_lane_validation():
    with pytest.raises(ValueError, match="registered"):
        AsyncFLConfig(distribution="nope")
    with pytest.raises(ValueError, match="backend"):
        AsyncFLConfig(backend="tpu")
    clients, test, rates, net, _ = _setup()
    tr = teng.DeviceTrainer(tmodels.mlp_classifier(64, 4, device="cpu"),
                            clients, net, _config(), device="cpu")
    with pytest.raises(ValueError, match="lane_clients"):
        tr.run_lanes([np.full(4, 0.25)], [2], [0.05], [0], 5.0, nets=[net])
    with pytest.raises(ValueError, match="need nets"):
        tr.run_lanes([np.full(4, 0.25)], [2], [0.05], [0], 5.0,
                     lane_clients=[clients])
    with pytest.raises(ValueError, match="active"):
        teng.DeviceTrainer(tmodels.mlp_classifier(64, 4, device="cpu"),
                           clients[:3], net, _config(), device="cpu")


# ---------------------------------------------------------------------------
# statistically against the port's host loop
# ---------------------------------------------------------------------------

def test_device_trainer_matches_host_statistics():
    clients, test, rates, net, _ = _setup(seed=3)
    m, horizon = 3, 120.0
    kw = dict(eta=0.05, batch_size=8, eval_every_time=30.0, eval_batch=16)
    model = tmodels.mlp_classifier(64, 4, hidden=(8,), device="cpu")
    dev = AsyncFLTrainer(model, clients, net, m,
                         config=AsyncFLConfig(backend="device", **kw),
                         test_data=test, device="cpu")
    dlogs = dev.run_seeds(horizon, seeds=range(4))
    host = AsyncFLTrainer(model, clients, net, m,
                          config=AsyncFLConfig(backend="host", **kw),
                          test_data=test, device="cpu")
    hlog = host.run(horizon_time=horizon)
    assert dlogs[0].times == hlog.times == [0.0, 30.0, 60.0, 90.0, 120.0]
    thr = np.mean([lg.throughput for lg in dlogs])
    np.testing.assert_allclose(thr, hlog.throughput, rtol=0.35)
    np.testing.assert_allclose(thr, float(jackson.throughput(net, m)),
                               rtol=0.15)  # Prop. 4
    p = np.asarray(net.p)
    for lg in dlogs + [hlog]:
        assert np.isfinite(lg.losses).all()
        assert abs(float(np.sum(p * lg.mean_delay)) - (m - 1)) < 1.0
    # one device lane is the device backend's run of its seed
    one = AsyncFLTrainer(model, clients, net, m,
                         config=AsyncFLConfig(backend="device", seed=2, **kw),
                         test_data=test, device="cpu").run(horizon)
    _same_logs([dlogs[2]], [one])
