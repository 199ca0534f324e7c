"""Same seed, same run: the port against the JAX package with no draws
handed across, only seeds and keys.

Against JAX's ``batched`` and ``reference`` backends (never ``pallas`` or
``sharded``: reference caveats), run jitted with the network as an
argument: ``simulate_stats`` under all four laws with and without the CS
station at ``chunk`` 1 and 8 and at a padded ``n``,
``simulate_stats_classes``, ``next_update`` (with the stream's keys
against the JAX state's ``key``), a JAX state resumed in the port through
``convert.state_key``, ``ScenarioSuite.run(mode="simulate")`` and
``run_strategy_grid`` at the trainer tests' small size.

Tolerances: discrete leaves exact (update and delay counts, slots,
clients, phases, sequence numbers, rounds); float leaves within ``rtol
1e-12, atol 1e-12`` (the exponential and the normal are within 1–3
ulps of XLA's, ``repro_torch.core.prng``); under the ``deterministic`` law,
which draws only uniforms and integers, every leaf bitwise.  The trainer's
losses and parameters within the trainer tests' ``rtol 1e-4, atol 1e-5``
(float32 gradients in two frameworks; the JAX package initialises in
float64), its initial parameters within ``rtol 1e-5``.
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
from repro.scenario import spec as J
from repro.scenario import suite as JS
from repro_torch import convert
from repro_torch.core import events as TE
from repro_torch.core import prng
from repro_torch.data import iid_partition, make_synthetic_image_dataset
from repro_torch.fl import engine as teng
from repro_torch.fl import models as tmodels
from repro_torch.fl.trainer import AsyncFLConfig
from repro_torch.scenario import spec as T
from repro_torch.scenario import suite as TS

LAWS = ["exponential", "deterministic", "lognormal", "hyperexponential"]


def _leaves(tree):
    return {k: None if v is None else np.asarray(v)
            for k, v in tree._asdict().items()}


def _close(got, want, what, exact=False):
    got = (got.cpu().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got))
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if exact or not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=str(what))


def _same(port, jax_tree, exact=False):
    for name in jax_tree._fields:
        _close(getattr(port, name), getattr(jax_tree, name), name, exact)


def _network(n=5, with_cs=False, seed=0):
    rng = np.random.default_rng(seed)
    jp = jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(n))),
                           mu_c=jnp.asarray(rng.uniform(0.5, 3.0, n)),
                           mu_d=jnp.asarray(rng.uniform(0.5, 3.0, n)),
                           mu_u=jnp.asarray(rng.uniform(0.5, 3.0, n)))
    return jp.with_cs(2.5) if with_cs else jp


@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("with_cs,chunk", [(False, 1), (True, 8)])
def test_simulate_stats_same_seed(law, with_cs, chunk):
    jp = _network(with_cs=with_cs)
    kw = dict(warmup=20, seed=7, distribution=law, m_max=6, chunk=chunk)
    want = jax.jit(lambda p: JE.simulate_stats(p, 4, 200, backend="batched",
                                               **kw))(jp)
    tp = convert.network_params(_leaves(jp), device="cpu")
    got = TE.simulate_stats(tp, 4, 200, backend="batched", **kw)
    _same(got, want, exact=law == "deterministic")
    assert int(got.updates) == 200


def test_simulate_stats_same_seed_padded_and_reference():
    """A network padded to 8 rows (kernel route, the plain version on the
    CPU) against JAX's padded ``reference`` backend at ``chunk`` 8."""
    jp = jbz.pad_network(_network(with_cs=True, seed=1), 8)
    kw = dict(warmup=10, seed=3, distribution="hyperexponential", m_max=5,
              chunk=8)
    want = jax.jit(lambda p: JE.simulate_stats(
        p, 5, 200, backend="reference", **kw))(jp)
    tp = convert.network_params(_leaves(jp), device="cpu")
    _same(TE.simulate_stats(tp, 5, 200, backend="kernel", **kw), want)


@pytest.mark.parametrize("law,with_cs,chunk", [
    ("exponential", False, 1), ("lognormal", True, 8),
    ("hyperexponential", True, 1), ("deterministic", False, 8)])
def test_simulate_stats_classes_same_seed(law, with_cs, chunk):
    rng = np.random.default_rng(2)
    count = np.array([3, 1, 70_000, 2])
    jc = jbz.ClassParams(p=jnp.asarray(rng.dirichlet(np.ones(4)) / count),
                         mu_c=jnp.asarray(rng.uniform(0.5, 3.0, 4)),
                         mu_d=jnp.asarray(rng.uniform(0.5, 3.0, 4)),
                         mu_u=jnp.asarray(rng.uniform(0.5, 3.0, 4)),
                         count=jnp.asarray(count, jnp.int64))
    jc = jc.with_cs(2.0) if with_cs else jc
    kw = dict(warmup=10, seed=5, distribution=law, m_max=7, chunk=chunk)
    want = jax.jit(lambda c: JE.simulate_stats_classes(c, 6, 200, **kw))(jc)
    tc = convert.class_params(_leaves(jc), device="cpu")
    _same(TE.simulate_stats_classes(tc, 6, 200, **kw), want,
          exact=law == "deterministic")


def _jax_updates(jp, key, law, m, m_max, updates, backend):
    @jax.jit
    def go(jp, key):
        st = JE.init_state(jp, m, key, m_max=m_max, distribution=law,
                           warmup=1, cap=999)
        stf, upds = jax.lax.scan(
            lambda s, _: JE.next_update(jp, s, distribution=law,
                                        backend=backend, chunk=1),
            st, None, length=updates)
        return st, stf, upds

    return go(jp, key)


@pytest.mark.parametrize("law,with_cs,chunk,backend", [
    ("exponential", True, 1, "batched"),
    ("hyperexponential", False, 4, "kernel"),
    ("lognormal", True, 9, "kernel")])
def test_next_update_same_key(law, with_cs, chunk, backend):
    """Two lanes, 8 updates each: the updates, every state leaf and the
    stream's keys (JAX's carried ``state.key``)."""
    jp = _network(4, with_cs, seed=6)
    seeds, m, m_max, updates = (8, 9), 3, 5, 8
    runs = [_jax_updates(jp, jax.random.PRNGKey(s), law, m, m_max, updates,
                         "batched") for s in seeds]
    tp1 = convert.network_params(_leaves(jp), device="cpu")
    keys = prng.seed_keys(seeds, device="cpu")
    st = TE.stack_lanes([TE.init_state(tp1, m, k, m_max=m_max,
                                       distribution=law, warmup=1, cap=999)
                         for k in keys])
    for i, r in enumerate(runs):
        _same(TE.lane(st, i), convert.event_state(_leaves(r[0]),
                                                  device="cpu"))
    stream = TE.EventStream([tp1] * 2, TE.event_key(keys),
                            distribution=law, block=37)
    tp = TE.stack_lanes([tp1] * 2)
    outs = []
    for _ in range(updates):
        st, upd = TE.next_update(tp, st, stream, backend=backend,
                                 chunk=chunk)
        outs.append(upd)
    upd = TE.UpdateOut(*[torch.stack(x, 1) for x in zip(*outs)])
    for i, (_, stf, upds) in enumerate(runs):
        for name in TE.UpdateOut._fields:
            _close(getattr(upd, name)[i], getattr(upds, name), name)
        for name in TE.EventState._fields:
            _close(getattr(st, name)[i], getattr(stf, name), name)
        assert stream.keys()[i].tolist() == np.asarray(
            stf.key).astype(np.int64).tolist()


def test_jax_state_resumes_in_the_port():
    """JAX runs 5 updates, the port takes its state and key over
    (``convert``) and runs 5 more: the JAX package's own 10."""
    jp = _network(5, True, seed=4)
    law = "hyperexponential"
    _, mid, _ = _jax_updates(jp, jax.random.PRNGKey(21), law, 4, 6, 5,
                             "reference")
    _, end, upds = jax.jit(lambda jp, st: (None,) + jax.lax.scan(
        lambda s, _: JE.next_update(jp, s, distribution=law,
                                    backend="batched", chunk=1),
        st, None, length=5))(jp, mid)
    tp = TE.stack_lanes([convert.network_params(_leaves(jp), device="cpu")])
    st = TE.stack_lanes([convert.event_state(_leaves(mid), device="cpu")])
    key = convert.state_key(_leaves(mid), device="cpu")
    stream = TE.EventStream([TE.lane(tp, 0)], key[None], distribution=law)
    for k in range(5):
        st, upd = TE.next_update(tp, st, stream, backend="batched")
        for name in TE.UpdateOut._fields:
            _close(getattr(upd, name)[0], getattr(upds, name)[k], name)
    _same(TE.lane(st, 0), convert.event_state(_leaves(end), device="cpu"))
    assert stream.keys()[0].tolist() == np.asarray(end.key).tolist()


def _sim_scenarios(S):
    rng = np.random.default_rng(9)

    def net(n, **kw):
        return S.NetworkSpec(mu_c=rng.uniform(0.5, 3, n),
                             mu_d=rng.uniform(0.5, 3, n),
                             mu_u=rng.uniform(0.5, 3, n), **kw)

    return {
        "n3": S.Scenario(network=net(3), strategy=S.StrategySpec(
            "explicit", p=rng.dirichlet(np.ones(3)), m=3)),
        "h2": S.Scenario(network=net(5, law="hyperexponential", mu_cs=2.0),
                         strategy=S.StrategySpec("asyncsgd"),
                         sim=S.SimSpec(chunk=8)),
        "ref": S.Scenario(network=net(4, law="lognormal"),
                          strategy=S.StrategySpec("asyncsgd"),
                          sim=S.SimSpec(backend="reference")),
        "classes": S.Scenario(
            network=S.NetworkSpec(classes=S.ClassSpec(
                mu_c=rng.uniform(0.5, 3, 2), mu_d=rng.uniform(0.5, 3, 2),
                mu_u=rng.uniform(0.5, 3, 2), count=[2, 3])),
            strategy=S.StrategySpec("asyncsgd"))}


def test_suite_simulate_same_seed():
    jsuite = JS.ScenarioSuite(_sim_scenarios(J), seeds=(0, 4))
    tsuite = TS.ScenarioSuite(
        {k: T.Scenario.from_dict(v.to_dict()) for k, v in
         jsuite.scenarios.items()}, seeds=(0, 4), device="cpu")
    kw = dict(mode="simulate", num_updates=100, warmup=20)
    j, t = jsuite.run(**kw), tsuite.run(**kw)
    assert (t.programs, t.lanes) == (j.programs, j.lanes)
    for name, lanes in j.entries.items():
        for jl, tl in zip(lanes, t.entries[name]):
            _same(tl, jl)


def test_run_strategy_grid_same_seed():
    n, image, classes, batch = 4, 8, 4, 6
    full = make_synthetic_image_dataset(num_classes=classes,
                                        samples_per_class=16,
                                        image_size=image, seed=11)
    clients = [(full.x[i], full.y[i])
               for i in iid_partition(full.y, n, seed=11)]
    test = (full.x[::3], full.y[::3])
    rng = np.random.default_rng(11)
    rates = {k: rng.uniform(1.0, 4.0, n) for k in ("mu_c", "mu_d", "mu_u")}
    jnet = jbz.NetworkParams(p=jnp.full(n, 1.0 / n),
                             **{k: jnp.asarray(v) for k, v in rates.items()})
    tnet = convert.network_params(_leaves(jnet), device="cpu")
    strategies = {"uniform": (np.full(n, 1.0 / n), 2),
                  "skewed": (rng.dirichlet(np.ones(n) * 2.0), 3)}
    cfg = dict(eta=0.05, batch_size=batch, eval_every_time=6.0,
               eval_batch=16, grad_clip=2.0)
    jmodel = jmodels.mlp_classifier(image * image, classes, hidden=(8,))
    tmodel = tmodels.mlp_classifier(image * image, classes, hidden=(8,),
                                    device="cpu")
    jtr = jeng.DeviceTrainer(jmodel, clients, jnet, JConfig(**cfg),
                             test_data=test, sim_backend="batched")
    want = jeng.run_strategy_grid(jmodel, clients, jnet, strategies,
                                  JConfig(**cfg), horizon_time=30.0,
                                  seeds=(3, 4), test_data=test, trainer=jtr)
    got = teng.run_strategy_grid(tmodel, clients, tnet, strategies,
                                 AsyncFLConfig(**cfg), horizon_time=30.0,
                                 seeds=(3, 4), test_data=test, device="cpu")
    for name in strategies:
        for tl, jl in zip(got.logs[name], want.logs[name]):
            assert tl.times == jl.times and tl.updates == jl.updates
            assert tl.updates[-1] >= 15
            _close(tl.mean_delay, jl.mean_delay, "mean_delay")
            _close(tl.throughput, jl.throughput, "throughput")
            _close(tl.energy, jl.energy, "energy")
            np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(tl.accuracies, jl.accuracies,
                                       atol=1.0 / 16 + 1e-6)
    # the initial parameters: JAX's init of the same key
    trainer = teng.DeviceTrainer(tmodel, clients, tnet, AsyncFLConfig(**cfg),
                                 device="cpu")
    init = jmodel.init(jax.random.PRNGKey(3))
    want0 = trainer.layout.flatten(convert.model_params(
        jax.tree_util.tree_map(np.asarray, init), tmodel))
    np.testing.assert_allclose(trainer.init_params([3])[0].numpy(),
                               want0.numpy(), rtol=1e-5, atol=0)
