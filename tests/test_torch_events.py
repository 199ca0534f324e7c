"""Port parity: the device event engine (``repro_torch.core.events``).

1. Injected blocks: the JAX package's ``init_state`` and
   ``draw_event_blocks`` feed both engines, which then run the same events
   (JAX ``step_event_block`` vs the port's loop on both lane backends).
   Every state leaf and the final statistics must be **bitwise** equal,
   for the exponential, deterministic and hyperexponential laws (the H2
   unit pairs as JAX drew them).  The lognormal blocks carry JAX's raw
   subkeys, which the test turns into their normals with
   ``jax.random.normal``: discrete leaves exact, float leaves within
   ``rtol 1e-12, atol 1e-12`` (XLA may contract the normal's last multiply
   with ``- log(rate)`` into one fused multiply-add inside its fusion, and
   its ``exp`` and ``log`` are not PyTorch's).
2. Inside the port: ``kernel`` equals ``batched`` equals ``reference``,
   lanes equal single runs, padded ``n`` equals unpadded — bitwise.
3. Distributional: the port's own-generator runs and the host simulator
   against Prop. 4 (``rtol 0.05``, as ``tests/test_events.py`` does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import buzen as jbz
from repro.core import energy as jen
from repro.core import events as JE
from repro_torch import convert
from repro_torch.core import buzen as tbz
from repro_torch.core import events as TE
from repro_torch.core.energy import PowerProfile
from repro_torch.core.jackson import throughput
from repro_torch.core.simulator import AsyncNetworkSim
from repro_torch.sim import simulate_stats_lanes


def _leaves(tree):
    """numpy leaves; a tuple leaf (the H2 unit pair) stays a tuple."""
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


_normals = jax.jit(lambda ks: jax.vmap(jax.random.normal)(
    ks.reshape(-1, 2)).reshape(ks.shape[:-1]))


def _unit_leaves(blk, dist):
    """JAX's blocks as numpy leaves, the lognormal's raw subkeys replaced
    by their normals ``jax.random.normal(k)``."""
    if dist == "lognormal":
        blk = blk._replace(up=_normals(blk.up), comp=_normals(blk.comp))
    return _leaves(blk)


def _jax_net(seed, n, with_cs):
    rng = np.random.default_rng(seed)
    jp = jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(n) * 2.0)),
                           mu_c=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_d=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_u=jnp.asarray(rng.uniform(0.5, 4.0, n)))
    jpw = jen.PowerProfile(P_c=jnp.asarray(rng.uniform(1.0, 3.0, n)),
                           P_u=jnp.asarray(rng.uniform(1.0, 3.0, n)),
                           P_d=jnp.asarray(rng.uniform(1.0, 3.0, n)),
                           P_cs=jnp.asarray(2.5) if with_cs else None)
    return (jp.with_cs(1.5) if with_cs else jp), jpw


def _run_injected(dist, with_cs, n_max, power):
    """JAX's engine and the port's on both lane backends, fed JAX's
    ``init_state`` and blocks: ``(JAX's final state, its statistics, {backend:
    the port's final state})``."""
    n, m, m_max, N = 4, 7, 9, 360
    jp, jpw = _jax_net(0, n, with_cs)
    if n_max is not None:
        jp = jbz.pad_network(jp, n_max)
        jpw = jen.PowerProfile(*[None if x is None or not x.ndim else
                                 jnp.concatenate([x, jnp.zeros(n_max - n)])
                                 for x in jpw[:3]], P_cs=jpw.P_cs)
    jpw = jpw if power else None
    st0 = JE.init_state(jp, m, jax.random.PRNGKey(3), m_max=m_max,
                        distribution=dist, warmup=25, cap=75)
    _, blk = JE.draw_event_blocks(jp, jax.random.PRNGKey(5), N,
                                  distribution=dist)

    def body(s, b):
        return JE.step_event_block(jp, s, b, distribution=dist,
                                   power=jpw)[0], None

    want, _ = jax.jit(lambda s, b: jax.lax.scan(body, s, b))(st0, blk)

    lanes = TE.stack_lanes
    tp = lanes([convert.network_params(_leaves(jp), device="cpu")])
    tpw = (None if jpw is None else
           lanes([convert.power_profile(_leaves(jpw), device="cpu")]))
    tst = lanes([convert.event_state(_leaves(st0), device="cpu")])
    tblk = convert.event_blocks(_unit_leaves(blk, dist), device="cpu")
    tblk = TE.EventBlocks(*[None if x is None else x[:, None] for x in tblk])
    got = {backend: TE.run_event_blocks(tp, tst, tblk, distribution=dist,
                                        power=tpw, backend=backend)
           for backend in ("batched", "kernel")}
    assert int(want.round) > 75  # the window closed inside the run
    return want, JE.finalize_stats(want), got


@pytest.mark.parametrize("dist,with_cs,n_max,power", [
    ("exponential", False, None, True),
    ("exponential", True, 7, True),
    ("exponential", False, 6, False),
    ("deterministic", False, None, True),
    ("deterministic", True, 7, False),
    ("hyperexponential", False, None, True),
    ("hyperexponential", True, 7, True),
])
def test_injected_blocks_bitwise_vs_jax(dist, with_cs, n_max, power):
    want, want_stats, outs = _run_injected(dist, with_cs, n_max, power)
    for backend, got in outs.items():
        for name in TE.EventState._fields:
            assert np.array_equal(getattr(got, name)[0].numpy(),
                                  np.asarray(getattr(want, name))), \
                (backend, name)
        stats = TE.finalize_stats(got)
        for name in TE.EventStats._fields:
            assert np.array_equal(getattr(stats, name)[0].numpy(),
                                  np.asarray(getattr(want_stats, name))), \
                (backend, name)


@pytest.mark.parametrize("with_cs,n_max,power", [(False, None, True),
                                                 (True, 7, True),
                                                 (False, 6, False)])
def test_injected_blocks_lognormal_vs_jax(with_cs, n_max, power):
    want, want_stats, outs = _run_injected("lognormal", with_cs, n_max,
                                           power)

    def close(g, w, what):
        g, w = g.numpy(), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=what)
        else:
            assert np.array_equal(g, w), what

    for backend, got in outs.items():
        for name in TE.EventState._fields:
            close(getattr(got, name)[0], getattr(want, name), (backend, name))
        stats = TE.finalize_stats(got)
        for name in TE.EventStats._fields:
            close(getattr(stats, name)[0], getattr(want_stats, name),
                  (backend, name))
    assert torch.equal(outs["batched"].finish, outs["kernel"].finish)


def _net(seed, n, with_cs=False):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    prm = tbz.NetworkParams(p=t(rng.dirichlet(np.ones(n) * 2.0)),
                            mu_c=t(rng.uniform(0.5, 4.0, n)),
                            mu_d=t(rng.uniform(0.5, 4.0, n)),
                            mu_u=t(rng.uniform(0.5, 4.0, n)))
    return prm.with_cs(1.5) if with_cs else prm


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dist,with_cs", [("exponential", False),
                                          ("deterministic", True)])
def test_backends_lanes_and_padding_bitwise(dist, with_cs):
    prms = [_net(s, 4, with_cs) for s in (1, 2, 3)]
    ms = [3, 5, 6]
    rng = np.random.default_rng(9)
    pw = PowerProfile(P_c=torch.as_tensor(rng.uniform(1, 3, 4)),
                      P_u=torch.as_tensor(rng.uniform(1, 3, 4)),
                      P_d=torch.as_tensor(rng.uniform(1, 3, 4)),
                      P_cs=torch.tensor(2.0, dtype=torch.float64)
                      if with_cs else None)
    kw = dict(warmup=20, distribution=dist, power=pw, m_max=6, seeds=[4, 5, 6])
    batched = simulate_stats_lanes(prms, ms, 120, backend="batched", **kw)
    kernel = simulate_stats_lanes(prms, ms, 120, backend="kernel", **kw)
    reference = simulate_stats_lanes(prms, ms, 120, backend="reference", **kw)
    assert _equal(batched, kernel) and _equal(batched, reference)
    for i, (prm, m, seed) in enumerate(zip(prms, ms, kw["seeds"])):
        single = TE.simulate_stats(prm, m, 120, warmup=20, seed=seed,
                                   distribution=dist, power=pw, m_max=6)
        assert _equal(single, TE.lane(batched, i))
    # padded n: the same draws, statistics bitwise after unpadding
    padded = tbz.pad_network(prms[0], 7)
    pw_pad = PowerProfile(*[torch.cat([x, torch.zeros(3, dtype=x.dtype)])
                            for x in pw[:3]], P_cs=pw.P_cs)
    got = TE.simulate_stats(padded, 3, 120, warmup=20, seed=4,
                            distribution=dist, power=pw_pad, m_max=6)
    assert _equal(TE.unpad_stats(got, 4), TE.lane(batched, 0))


def test_throughput_matches_prop4_and_host():
    prm = _net(8, 4)
    m = 6
    lam = float(throughput(prm, m))
    lanes = simulate_stats_lanes([prm] * 8, [m] * 8, 3_000, warmup=500,
                                 seeds=range(8), backend="kernel")
    assert float(lanes.throughput.mean()) == pytest.approx(lam, rel=0.05)
    # closed network: the time-averaged occupancy sums to m
    np.testing.assert_allclose(lanes.mean_queue_counts.sum(-1).numpy(), m,
                               rtol=1e-9)
    host = AsyncNetworkSim(prm, m, seed=0).run(20_000, warmup=3_000)
    assert host.throughput == pytest.approx(lam, rel=0.05)


def test_generator_seeding_and_validation():
    prm = _net(10, 3)
    g = torch.Generator().manual_seed(7)
    a = TE.simulate_stats(prm, 4, 50, generator=g)
    b = TE.simulate_stats(prm, 4, 50, seed=7)
    assert _equal(a, b)
    for law in ("lognormal", "hyperexponential"):
        got = TE.simulate_stats(prm, 4, 50, distribution=law, seed=7)
        assert int(got.updates) == 50 and bool(got.throughput > 0)
    with pytest.raises(ValueError, match=r"registered service distributions:"
                       r" \['deterministic', 'exponential', "
                       r"'hyperexponential', 'lognormal'\]"):
        TE.simulate_stats(prm, 4, 50, distribution="weibull")
    with pytest.raises(ValueError):
        simulate_stats_lanes([prm], [4], 10, backend="pallas")
