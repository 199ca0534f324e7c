"""The port's megastep path (``chunk > 1``) and ``next_update``.

1. Inside the port, bitwise: ``simulate_stats(_lanes)`` at ``chunk`` 2 and
   7 equals ``chunk = 1`` on every lane backend, for both scale laws (the
   other two in ``tests/test_torch_laws.py``), with and without the CS
   station, with power and with padded ``n``; one case puts a draw-block
   boundary inside a megastep.  Lanes equal singles.
2. ``next_update`` against the JAX package: fed the events JAX's
   ``draw_event_blocks`` draws from the state's key, the port's
   ``next_update`` reproduces JAX ``next_update(backend="batched",
   chunk=1)`` bitwise over 6 updates (the update and every state leaf but
   the key; the hyperexponential law too), and at ``chunk`` 4 and 9 it
   equals its own ``chunk = 1``.  Under the lognormal law (JAX's raw
   subkeys turned into their normals) the port is held against JAX's
   ``batched`` and ``reference`` backends, never its ``pallas`` one (a
   reference caveat): discrete results exact, float leaves within ``rtol
   1e-12, atol 1e-12``.
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
from repro_torch.core import prng
from repro_torch.core.energy import PowerProfile
from repro_torch.sim import simulate_stats_lanes


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _net(seed, n, with_cs=False):
    rng = np.random.default_rng(seed)
    prm = tbz.NetworkParams(p=_t(rng.dirichlet(np.ones(n) * 2.0)),
                            mu_c=_t(rng.uniform(0.5, 4.0, n)),
                            mu_d=_t(rng.uniform(0.5, 4.0, n)),
                            mu_u=_t(rng.uniform(0.5, 4.0, n)))
    return prm.with_cs(1.5) if with_cs else prm


def _power(n, with_cs, pad=0):
    rng = np.random.default_rng(9)
    z = np.zeros(pad)
    return PowerProfile(
        P_c=_t(np.concatenate([rng.uniform(1, 3, n), z])),
        P_u=_t(np.concatenate([rng.uniform(1, 3, n), z])),
        P_d=_t(np.concatenate([rng.uniform(1, 3, n), z])),
        P_cs=_t(2.0) if with_cs else None)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dist,with_cs,power,draw_events", [
    ("exponential", False, True, 1024),
    ("exponential", True, False, 1024),
    ("deterministic", False, False, 1024),
    ("deterministic", True, True, 1024),
    ("exponential", False, False, 50),   # block boundaries inside chunks
])
def test_simulate_chunks_bitwise(dist, with_cs, power, draw_events):
    n = 4
    prms = [_net(s, n, with_cs) for s in (1, 2, 3)]
    ms = [3, 5, 6]
    pw = _power(n, with_cs) if power else None
    kw = dict(warmup=20, distribution=dist, power=pw, m_max=6,
              seeds=[4, 5, 6], draw_events=draw_events)
    base = simulate_stats_lanes(prms, ms, 100, chunk=1, backend="batched",
                                **kw)
    assert int(base.updates.min()) == 100
    for chunk in (2, 7):
        for backend in ("batched", "kernel", "reference"):
            got = simulate_stats_lanes(prms, ms, 100, chunk=chunk,
                                       backend=backend, **kw)
            assert _equal(base, got), (chunk, backend)
    for i, (prm, m, seed) in enumerate(zip(prms, ms, kw["seeds"])):
        single = TE.simulate_stats(prm, m, 100, warmup=20, seed=seed,
                                   distribution=dist, power=pw, m_max=6,
                                   chunk=7, draw_events=draw_events)
        assert _equal(single, TE.lane(base, i)), i


def test_simulate_chunks_padded_n_bitwise():
    prm = _net(1, 4, with_cs=True)
    kw = dict(warmup=20, seed=4, distribution="exponential", m_max=6)
    base = TE.simulate_stats(prm, 5, 100, power=_power(4, True), chunk=1,
                             **kw)
    padded = TE.simulate_stats(tbz.pad_network(prm, 7), 5, 100,
                               power=_power(4, True, pad=3), chunk=7,
                               backend="kernel", **kw)
    assert _equal(TE.unpad_stats(padded, 4), base)


def _leaves(tree):
    """numpy leaves; a tuple leaf (the H2 unit pair) stays a tuple."""
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


_normals = jax.jit(lambda ks: jax.vmap(jax.random.normal)(
    ks.reshape(-1, 2)).reshape(ks.shape[:-1]))


def _fed_jax_stream(dist, with_cs, power, jax_backend="batched"):
    """Two lanes of JAX ``next_update`` over 6 updates and the port's,
    fed JAX's initial states and the blocks JAX draws from their keys:
    ``(JAX's runs, port(chunk, backend) -> (state, UpdateOut))``."""
    n, m, m_max, updates, N = 4, 3, 5, 6, 200
    rng = np.random.default_rng(6)
    jp = jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(n) * 2.0)),
                           mu_c=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_d=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_u=jnp.asarray(rng.uniform(0.5, 4.0, n)))
    jp = jp.with_cs(1.5) if with_cs else jp
    jpw = (jen.PowerProfile(P_c=jnp.asarray(rng.uniform(1, 3, n)),
                            P_u=jnp.asarray(rng.uniform(1, 3, n)),
                            P_d=jnp.asarray(rng.uniform(1, 3, n)),
                            P_cs=jnp.asarray(2.5) if with_cs else None)
           if power else None)

    # the network enters as an argument, not as constants of the program:
    # with constant rates XLA rounds JAX's own single-step CS service
    # apart from its drawn blocks (one ulp at n = 4 within 20 events)
    @jax.jit
    def go(jp, jpw, key):
        st = JE.init_state(jp, m, key, m_max=m_max, distribution=dist,
                           warmup=1, cap=999)

        def body(s, _):
            return JE.next_update(jp, s, distribution=dist, power=jpw,
                                  backend=jax_backend, chunk=1)

        stf, upds = jax.lax.scan(body, st, None, length=updates)
        _, blk = JE.draw_event_blocks(jp, st.key, N, distribution=dist)
        if dist == "lognormal":  # the raw subkeys' normals
            blk = blk._replace(up=_normals(blk.up), comp=_normals(blk.comp))
        return st, stf, upds, blk

    runs = [go(jp, jpw, jax.random.PRNGKey(s)) for s in (8, 9)]  # two lanes
    lanes = TE.stack_lanes
    tp = lanes([convert.network_params(_leaves(jp), device="cpu")] * 2)
    tpw = (None if jpw is None else
           lanes([convert.power_profile(_leaves(jpw), device="cpu")] * 2))
    st0 = lanes([convert.event_state(_leaves(r[0]), device="cpu")
                 for r in runs])
    blocks = [convert.event_blocks(_leaves(r[3]), device="cpu") for r in runs]
    blocks = TE.EventBlocks(*[None if x[0] is None else torch.stack(x, 1)
                              for x in zip(*blocks)])

    def port(chunk, backend):
        stream = TE.EventStream.from_blocks(blocks, distribution=dist)
        st, outs = st0, []
        for _ in range(updates):
            st, upd = TE.next_update(tp, st, stream, power=tpw,
                                     backend=backend, chunk=chunk)
            outs.append(upd)
        return st, TE.UpdateOut(*[torch.stack(x, 1) for x in zip(*outs)])

    return runs, port


@pytest.mark.parametrize("dist,with_cs,power", [
    ("exponential", False, True),
    ("exponential", True, False),
    ("deterministic", True, True),
    ("hyperexponential", True, True),
])
def test_next_update_fed_jax_stream_bitwise(dist, with_cs, power):
    updates = 6
    runs, port = _fed_jax_stream(dist, with_cs, power)
    st1, upd1 = port(1, "batched")
    for k, (_, stf, upds, _) in enumerate(runs):
        for name in TE.UpdateOut._fields:
            assert np.array_equal(getattr(upd1, name)[k].numpy(),
                                  np.asarray(getattr(upds, name))), name
        for name in TE.EventState._fields:
            assert np.array_equal(getattr(st1, name)[k].numpy(),
                                  np.asarray(getattr(stf, name))), name
    assert int(upd1.steps.sum()) > 2 * updates
    for chunk, backend in ((1, "kernel"), (4, "batched"), (9, "kernel")):
        st2, upd2 = port(chunk, backend)
        assert _equal(upd1, upd2) and _equal(st1, st2), (chunk, backend)


@pytest.mark.parametrize("jax_backend,with_cs", [("batched", True),
                                                 ("reference", False)])
def test_next_update_lognormal_fed_jax_stream(jax_backend, with_cs):
    runs, port = _fed_jax_stream("lognormal", with_cs, True, jax_backend)

    def close(g, w, what):
        g, w = g.numpy(), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=str(what))
        else:
            assert np.array_equal(g, w), what

    st1, upd1 = port(1, "batched")
    for k, (_, stf, upds, _) in enumerate(runs):
        for name in TE.UpdateOut._fields:
            close(getattr(upd1, name)[k], getattr(upds, name), name)
        for name in TE.EventState._fields:
            close(getattr(st1, name)[k], getattr(stf, name), name)
    for chunk, backend in ((1, "kernel"), (9, "kernel")):
        st2, upd2 = port(chunk, backend)
        assert _equal(upd1, upd2) and _equal(st1, st2), (chunk, backend)


def test_next_update_generator_stream_chunks_and_lanes():
    """Own keys with a draw block of 13 events: megasteps straddle
    blocks and lanes move their cursors apart; every chunk and each lane
    run alone give the same updates."""
    prms = [_net(s, 5) for s in (1, 2, 3)]

    def run(idx, chunk):
        keys = prng.seed_keys((1, 2, 3), device="cpu")
        ps = [prms[i] for i in idx]
        st = TE.stack_lanes([TE.init_state(prms[i], 4, keys[i], m_max=6)
                             for i in idx])
        stream = TE.EventStream(ps, TE.event_key(keys[idx]), block=13)
        outs = []
        for _ in range(20):
            st, upd = TE.next_update(TE.stack_lanes(ps), st, stream,
                                     chunk=chunk, backend="kernel")
            outs.append(upd)
        return st, TE.UpdateOut(*[torch.stack(x, 1) for x in zip(*outs)])

    st1, upd1 = run([0, 1, 2], 1)
    assert len(set(upd1.steps.sum(1).tolist())) > 1  # cursors apart
    for chunk in (4, 9):
        st2, upd2 = run([0, 1, 2], chunk)
        assert _equal(upd1, upd2) and _equal(st1, st2), chunk
    for i in range(3):
        st2, upd2 = run([i], 4)
        assert _equal(TE.lane(upd1, i), TE.lane(upd2, 0))
        assert _equal(TE.lane(st1, i), TE.lane(st2, 0))


def test_stream_and_chunk_validation():
    prm = _net(1, 3)
    key = prng.PRNGKey(0, device="cpu")
    st = TE.stack_lanes([TE.init_state(prm, 3, key, m_max=3)])
    _, blk = TE.draw_event_blocks(prm, TE.event_key(key), 2)
    stream = TE.EventStream.from_blocks(
        TE.EventBlocks(*[None if x is None else x[:, None] for x in blk]))
    with pytest.raises(RuntimeError, match="ran out"):
        for _ in range(4):
            st, _ = TE.next_update(TE.stack_lanes([prm]), st, stream)
    with pytest.raises(ValueError):
        TE.simulate_stats(prm, 3, 10, chunk=0)
    with pytest.raises(ValueError):
        TE.EventStream([prm], key[None], block=0)
