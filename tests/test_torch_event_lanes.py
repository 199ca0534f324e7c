"""The event engine's lane steps: the transition and the statistics of each
event in one call (``repro_torch.kernels.events.event_step_lanes`` /
``megastep_lanes``; the CUDA lane kernel on the card, the plain versions
``repro_torch.core.events.event_step_lanes_plain`` /
``megastep_lanes_plain`` on CPU tensors).

1. The plain lane steps equal the composition they replace, written out
   here: the plain table transition, then ``replay_event`` per kept event
   (tables held where masked) — bitwise on every ``EventState`` leaf, the
   event times and the descriptors; both laws, CS on and off, power with
   and without ``P_cs``, ``keep`` masks, ``rem < chunk``,
   ``stop_on_update``, chunk 1, 7 and 32, padded ``n``.  One megastep
   equals ``chunk`` masked single steps of the composition.
2. The ``kernel`` route on the CPU, fed the blocks the JAX package drew,
   equals JAX's reference engine (its ``step_event_block`` scanned) and
   JAX's ``next_update(backend="batched", chunk=1)`` bitwise at chunk 1,
   7 and 32.
3. ``run_events`` and ``next_update`` leave the caller's state untouched.

All inputs come from numpy with a seed.
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
from repro_torch.kernels import events as ke

_TABLES = ("finish", "phase", "client", "seq", "disp_round")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _lanes(rng, K, n, with_cs, power, pad=0):
    """``K`` numpy-made networks of ``n`` clients (``pad`` zero-mass rows
    appended) and their power profiles: ``power`` None, ``"no_pcs"`` or
    ``"pcs"``."""
    prms, pws = [], []
    for _ in range(K):
        prm = tbz.NetworkParams(p=_t(rng.dirichlet(np.ones(n) * 2.0)),
                                mu_c=_t(rng.uniform(0.5, 4.0, n)),
                                mu_d=_t(rng.uniform(0.5, 4.0, n)),
                                mu_u=_t(rng.uniform(0.5, 4.0, n)))
        prm = prm.with_cs(1.5) if with_cs else prm
        z = np.zeros(pad)
        pws.append(PowerProfile(
            *[_t(np.concatenate([rng.uniform(1.0, 3.0, n), z]))
              for _ in range(3)],
            P_cs=_t(2.5) if power == "pcs" else None))
        prms.append(tbz.pad_network(prm, n + pad) if pad else prm)
    return (TE.stack_lanes(prms),
            None if power is None else TE.stack_lanes(pws))


def _state(rng, params, ms, m_max, law, warmup, cap):
    """Lane-stacked initial states drawn with numpy: ``m`` tasks each on a
    uniformly drawn real client's downlink."""
    K, n = params.p.shape
    n_act = int((params.p[0] > 0).sum())
    lanes = []
    for k, m in enumerate(ms):
        cl = rng.integers(0, n_act, m_max)
        unit = (np.ones(m_max) if law == "deterministic"
                else rng.exponential(size=m_max))
        svc = _t(unit) / params.mu_d[k, cl]
        lanes.append(TE.EventState(client=_t(cl).to(torch.int32),
                                   **TE._init_leaves(_t(cl), svc, m, n,
                                                     warmup, cap, np.inf)))
    return TE.stack_lanes(lanes)


def _events(rng, params, N, law):
    """``N`` events per lane: ``fs [K, N, 4]`` (unit uplink and compute
    parts, the routed client's downlink service, the CS service) and
    ``c_new [K, N]`` int32."""
    K, n = params.p.shape
    n_act = int((params.p[0] > 0).sum())
    c_new = rng.integers(0, n_act, (K, N))

    def unit(shape):
        return (np.ones(shape) if law == "deterministic"
                else rng.exponential(size=shape))

    mu_d = params.mu_d.numpy()[np.arange(K)[:, None], c_new]
    mu_cs = (1.0 if params.mu_cs is None
             else params.mu_cs.numpy()[:, None])
    fs = np.stack([unit((K, N)), unit((K, N)), unit((K, N)) / mu_d,
                   unit((K, N)) / mu_cs if params.mu_cs is not None
                   else np.zeros((K, N))], axis=-1)
    return _t(fs), _t(c_new).to(torch.int32)


def _composed_event(params, state, fs, c_new, power, keep):
    """What one event per lane was before the lane steps: the plain
    transition, then ``replay_event``; masked lanes keep their tables."""
    n = params.p.shape[-1]
    has_cs = params.mu_cs is not None
    iscal = torch.stack([c_new, state.seq_ctr, state.round],
                        dim=-1).to(torch.int32)
    *tables, t_col, int_col = ke.event_step_tables_plain(
        state.finish, state.phase, state.client, state.seq, state.disp_round,
        params.mu_c, params.mu_u, fs, iscal, has_cs=has_cs)
    new = TE.replay_event(state, t_col[:, 0], int_col, iscal[:, 0], n=n,
                          has_cs=has_cs, power=power, keep=keep)
    if keep is not None:
        tables = [torch.where(keep[:, None], a, getattr(state, k))
                  for k, a in zip(_TABLES, tables)]
    return new._replace(**dict(zip(_TABLES, tables))), t_col, int_col


def _composed_megastep(params, state, fs, c_new, rem, power, stop):
    """What a megastep was before the lane steps: the plain megastep
    transition, then ``replay_event`` per kept event in event order."""
    n = params.p.shape[-1]
    has_cs = params.mu_cs is not None
    K, chunk = c_new.shape
    iscal = torch.cat([state.seq_ctr[:, None], state.round[:, None],
                       torch.as_tensor(rem, dtype=torch.int32)[:, None],
                       c_new], dim=1).to(torch.int32)
    *tables, t_mat, int_mat = ke.megastep_tables_plain(
        state.finish, state.phase, state.client, state.seq, state.disp_round,
        params.mu_c, params.mu_u, fs.reshape(K, 4 * chunk), iscal,
        has_cs=has_cs, chunk=chunk, stop_on_update=stop)
    D = int_mat.view(K, chunk, 10)
    for i in range(chunk):
        state = TE.replay_event(state, t_mat[:, i], D[:, i], c_new[:, i],
                                n=n, has_cs=has_cs, power=power,
                                keep=D[:, i, 9] > 0)
    return state._replace(**dict(zip(_TABLES, tables))), t_mat, int_mat


def _assert_same(got, want, what):
    for name, g, w in zip(TE.EventState._fields, got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g, w), (what, name)
    assert torch.equal(got[1], want[1]), (what, "t")
    assert torch.equal(got[2], want[2]), (what, "desc")


_CASES = [  # law, CS station, power, padded clients
    ("exponential", False, None, 0),
    ("exponential", True, "pcs", 0),
    ("deterministic", True, "no_pcs", 3),
    ("deterministic", False, "no_pcs", 0),
    ("exponential", False, "no_pcs", 2),
]


@pytest.mark.parametrize("law,with_cs,power,pad", _CASES)
def test_event_step_lanes_plain_equals_composition(law, with_cs, power,
                                                   pad):
    rng = np.random.default_rng(1)
    K, n, m_max, N = 5, 4, 7, 150
    params, pw = _lanes(rng, K, n, with_cs, power, pad)
    state = _state(rng, params, [3, 5, 7, 6, 4], m_max, law, 6, 16)
    fs, cn = _events(rng, params, N, law)
    st_a = st_b = state
    before = ke.event_step_lanes.launches
    for i in range(N):
        keep = (None if i % 3 == 0
                else torch.as_tensor(rng.random(K) < 0.8))
        want = _composed_event(params, st_a, fs[:, i], cn[:, i], pw, keep)
        got = TE.event_step_lanes_plain(params, st_b, fs[:, i], cn[:, i],
                                        power=pw, keep=keep)
        _assert_same(got, want, f"event {i}")
        routed = ke.event_step_lanes(params, st_b, fs[:, i], cn[:, i],
                                     power=pw, keep=keep)
        _assert_same(routed, want, f"event {i} (wrapper)")
        st_a, st_b = want[0], got[0]
    assert ke.event_step_lanes.launches == before  # CPU: no kernel
    assert int(st_a.round.min()) > 16  # the window closed inside the run
    if power is not None:
        assert bool((st_a.energy > 0).all())


@pytest.mark.parametrize("law,with_cs,power,pad", _CASES)
@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("stop", [False, True])
def test_megastep_lanes_plain_equals_composition(law, with_cs, power, pad,
                                                 chunk, stop):
    rng = np.random.default_rng(chunk + 2 * stop)
    K, n, m_max, steps = 5, 4, 7, 4
    params, pw = _lanes(rng, K, n, with_cs, power, pad)
    state = _state(rng, params, [3, 5, 7, 6, 4], m_max, law, 2, 12)
    st_a = st_b = state
    for s in range(steps):
        fs, cn = _events(rng, params, chunk, law)
        rem = rng.integers(0, chunk + 1, K)
        rem[0] = chunk  # a full lane, and one past the chunk
        rem[1] = chunk + 3
        want = _composed_megastep(params, st_a, fs, cn, rem.tolist(), pw,
                                  stop)
        for r in (rem.tolist(), torch.as_tensor(rem, dtype=torch.int32)):
            got = TE.megastep_lanes_plain(params, st_b, fs, cn, r, power=pw,
                                          stop_on_update=stop)
            _assert_same(got, want, f"megastep {s}")
            routed = ke.megastep_lanes(params, st_b, fs, cn, r, power=pw,
                                       stop_on_update=stop)
            _assert_same(routed, want, f"megastep {s} (wrapper)")
        st_a, st_b = want[0], got[0]


@pytest.mark.parametrize("stop", [False, True])
def test_one_megastep_equals_masked_single_steps(stop):
    rng = np.random.default_rng(7)
    K, chunk = 4, 9
    params, pw = _lanes(rng, K, 5, True, "pcs")
    st = _state(rng, params, [4, 6, 8, 8], 8, "deterministic", 0, 40)
    for _ in range(3):
        fs, cn = _events(rng, params, chunk, "deterministic")
        rem = [chunk, 3, 0, chunk]
        mega = TE.megastep_lanes_plain(params, st, fs, cn, rem, power=pw,
                                       stop_on_update=stop)
        one = st
        done = torch.zeros(K, dtype=torch.bool)
        for i in range(chunk):
            keep = (torch.as_tensor(rem) > i) & ~done
            one, t_col, int_col = _composed_event(params, one, fs[:, i],
                                                  cn[:, i], pw, keep)
            D = mega[2].view(K, chunk, 10)[:, i]
            assert torch.equal(mega[1][:, i], t_col[:, 0])
            assert torch.equal(D[:, :9], int_col)
            assert torch.equal(D[:, 9] > 0, keep)
            if stop:
                done = done | (keep & (int_col[:, 2] > 0))
        for name, a, b in zip(TE.EventState._fields, mega[0], one):
            assert torch.equal(a, b), name
        st = mega[0]


def test_lane_wrappers_check_their_inputs():
    rng = np.random.default_rng(3)
    params, pw = _lanes(rng, 2, 3, False, "no_pcs")
    st = _state(rng, params, [2, 3], 4, "exponential", 0, 10)
    fs, cn = _events(rng, params, 4, "exponential")
    with pytest.raises(ValueError, match="c_new"):
        ke.event_step_lanes(params, st, fs[:, 0], cn[:, 0].long())
    with pytest.raises(ValueError, match="state.occ"):
        ke.megastep_lanes(params, st._replace(occ=st.occ[:, 1:]), fs, cn, 4)
    with pytest.raises(ValueError, match="power.P_c"):
        ke.megastep_lanes(params, st, fs, cn, 4,
                          power=pw._replace(P_c=pw.P_c.float()))
    with pytest.raises(ValueError, match="keep"):
        ke.event_step_lanes(params, st, fs[:, 0], cn[:, 0],
                            keep=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="rem"):
        ke.megastep_lanes(params, st, fs, cn, [1, 2, 3])
    meta = TE.EventState(*[x.to("meta") for x in st])
    on_meta = (tbz.NetworkParams(*[x.to("meta") for x in params[:4]]),
               meta, fs[:, 0].to("meta"), cn[:, 0].to("meta"))
    with pytest.raises(ValueError, match="no event lane kernel"):
        ke.event_step_lanes(*on_meta)


# -- the kernel route against the JAX package -------------------------------

def _leaves(tree):
    return {k: None if v is None else np.asarray(v)
            for k, v in tree._asdict().items()}


def _jax_net(rng, n, with_cs, power, n_max=None):
    jp = jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(n) * 2.0)),
                           mu_c=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_d=jnp.asarray(rng.uniform(0.5, 4.0, n)),
                           mu_u=jnp.asarray(rng.uniform(0.5, 4.0, n)))
    jp = jp.with_cs(1.5) if with_cs else jp
    rows = [rng.uniform(1.0, 3.0, n) for _ in range(3)]
    if n_max is not None:
        jp = jbz.pad_network(jp, n_max)
        rows = [np.concatenate([r, np.zeros(n_max - n)]) for r in rows]
    jpw = (None if power is None else jen.PowerProfile(
        *[jnp.asarray(r) for r in rows],
        P_cs=jnp.asarray(2.5) if power == "pcs" else None))
    return jp, jpw


def _to_port(jp, jpw, K):
    tp = TE.stack_lanes([convert.network_params(_leaves(jp),
                                                device="cpu")] * K)
    tpw = (None if jpw is None else TE.stack_lanes(
        [convert.power_profile(_leaves(jpw), device="cpu")] * K))
    return tp, tpw


@pytest.mark.parametrize("dist,with_cs,power,n_max", [
    ("exponential", False, "no_pcs", 7),
    ("deterministic", True, "pcs", None),
    ("exponential", True, None, None),
])
def test_kernel_route_fed_jax_blocks_bitwise(dist, with_cs, power, n_max):
    rng = np.random.default_rng(11)
    n, m, m_max, N = 4, 6, 8, 300
    jp, jpw = _jax_net(rng, n, with_cs, power, n_max)

    @jax.jit
    def reference(jp, jpw, key):
        st0 = JE.init_state(jp, m, key, m_max=m_max, distribution=dist,
                            warmup=10, cap=60)
        _, blk = JE.draw_event_blocks(jp, jax.random.fold_in(key, 1), N,
                                      distribution=dist)

        def body(s, b):
            return JE.step_event_block(jp, s, b, distribution=dist,
                                       power=jpw)[0], None

        return st0, blk, jax.lax.scan(body, st0, blk)[0]

    runs = [reference(jp, jpw, jax.random.PRNGKey(s)) for s in (2, 3)]
    tp, tpw = _to_port(jp, jpw, 2)
    st0 = TE.stack_lanes([convert.event_state(_leaves(r[0]), device="cpu")
                          for r in runs])
    blocks = [convert.event_blocks(_leaves(r[1]), device="cpu")
              for r in runs]
    blocks = TE.EventBlocks(*[None if x[0] is None else torch.stack(x, 1)
                              for x in zip(*blocks)])
    for chunk in (1, 7, 32):
        got = TE.run_event_blocks(tp, st0, blocks, distribution=dist,
                                  power=tpw, backend="kernel", chunk=chunk)
        for k, (_, _, want) in enumerate(runs):
            for name in TE.EventState._fields:
                assert np.array_equal(getattr(got, name)[k].numpy(),
                                      np.asarray(getattr(want, name))), \
                    (chunk, k, name)
    assert int(runs[0][2].round) > 60  # the window closed inside the run


@pytest.mark.parametrize("dist,with_cs,power", [
    ("exponential", True, "pcs"),
    ("deterministic", False, "no_pcs"),
])
def test_kernel_route_next_update_fed_jax_stream_bitwise(dist, with_cs,
                                                         power):
    rng = np.random.default_rng(12)
    n, m, m_max, updates, N = 4, 4, 6, 8, 300
    jp, jpw = _jax_net(rng, n, with_cs, power)

    @jax.jit
    def go(jp, jpw, key):
        st = JE.init_state(jp, m, key, m_max=m_max, distribution=dist,
                           warmup=2, cap=999)

        def body(s, _):
            return JE.next_update(jp, s, distribution=dist, power=jpw,
                                  backend="batched", chunk=1)

        stf, upds = jax.lax.scan(body, st, None, length=updates)
        _, blk = JE.draw_event_blocks(jp, st.key, N, distribution=dist)
        return st, stf, upds, blk

    runs = [go(jp, jpw, jax.random.PRNGKey(s)) for s in (4, 5, 6)]
    tp, tpw = _to_port(jp, jpw, 3)
    st0 = TE.stack_lanes([convert.event_state(_leaves(r[0]), device="cpu")
                          for r in runs])
    blocks = [convert.event_blocks(_leaves(r[3]), device="cpu")
              for r in runs]
    blocks = TE.EventBlocks(*[None if x[0] is None else torch.stack(x, 1)
                              for x in zip(*blocks)])
    for chunk in (1, 7, 32):
        stream = TE.EventStream.from_blocks(blocks, distribution=dist)
        st, outs = st0, []
        for _ in range(updates):
            st, upd = TE.next_update(tp, st, stream, power=tpw,
                                     backend="kernel", chunk=chunk)
            outs.append(upd)
        for k, (_, stf, upds, _) in enumerate(runs):
            for i, name in enumerate(TE.UpdateOut._fields):
                got = torch.stack([u[i][k] for u in outs]).numpy()
                assert np.array_equal(got, np.asarray(getattr(upds, name))), \
                    (chunk, k, name)
            for name in TE.EventState._fields:
                assert np.array_equal(getattr(st, name)[k].numpy(),
                                      np.asarray(getattr(stf, name))), \
                    (chunk, k, name)


@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_run_events_and_next_update_leave_the_state_untouched(backend):
    rng = np.random.default_rng(13)
    params, pw = _lanes(rng, 3, 4, True, "pcs")
    state = _state(rng, params, [3, 4, 5], 6, "exponential", 1, 50)
    kept = [x.clone() for x in state]
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    singles = [TE.lane(params, i) for i in range(3)]
    for chunk in (1, 7):
        stream = TE.EventStream(singles, gens, block=16)
        out = TE.run_events(params, state, stream, 40, chunk=chunk,
                            power=pw, backend=backend)
        assert not torch.equal(out.finish, state.finish)
        out_kept = [x.clone() for x in out]
        for chunk_u in (1, 7):
            TE.next_update(params, out, stream, power=pw, backend=backend,
                           chunk=chunk_u)
        for name, a, b, c, d in zip(TE.EventState._fields, state, kept, out,
                                    out_kept):
            assert torch.equal(a, b) and torch.equal(c, d), (chunk, name)
