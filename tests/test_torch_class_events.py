"""Port parity: the class-aggregated event engine
(``repro_torch.core.events``, class half, and class lanes).

1. Injected blocks: the JAX package's ``init_class_state`` and
   ``draw_class_event_blocks`` feed both engines, which run the same
   events (JAX ``step_class_event_block`` vs the port's loop).  Every
   state leaf, ``energy`` included, and the statistics must be **bitwise**
   equal, the hyperexponential law's included; under the lognormal law
   (JAX's raw subkeys turned into their normals) discrete leaves exactly
   and float leaves within ``rtol 1e-12, atol 1e-12``.
2. Inside the port: chunk E equals chunk 1, lanes equal singles,
   ``reference`` equals ``batched`` and padded classes equal unpadded —
   bitwise.
3. ``expand_class_stats`` shapes and weights; the class engine's
   throughput against the per-client engine on ``expand()`` and Prop. 4
   (``rel 0.1``, as ``tests/test_classes.py`` does); ``"kernel"`` raises.
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
from repro_torch.core.jackson import throughput
from repro_torch.scenario.spec import PAPER_CLUSTERS_TABLE1, ClassSpec
from repro_torch.sim import simulate_stats_classes_lanes, simulate_stats_lanes


def _leaves(tree):
    """numpy leaves; a tuple leaf (the H2 unit pair) stays a tuple."""
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


_normals = jax.jit(lambda ks: jax.vmap(jax.random.normal)(
    ks.reshape(-1, 2)).reshape(ks.shape[:-1]))


def _jax_classes(seed, C, with_cs):
    rng = np.random.default_rng(seed)
    count = rng.integers(1, 5, C)
    mass = rng.dirichlet(np.ones(C) * 2.0)
    jc = jbz.ClassParams(p=jnp.asarray(mass / count),
                         mu_c=jnp.asarray(rng.uniform(0.5, 4.0, C)),
                         mu_d=jnp.asarray(rng.uniform(0.5, 4.0, C)),
                         mu_u=jnp.asarray(rng.uniform(0.5, 4.0, C)),
                         count=jnp.asarray(count, jnp.int64))
    jpw = jen.PowerProfile(P_c=jnp.asarray(rng.uniform(1.0, 3.0, C)),
                           P_u=jnp.asarray(rng.uniform(1.0, 3.0, C)),
                           P_d=jnp.asarray(rng.uniform(1.0, 3.0, C)),
                           P_cs=jnp.asarray(2.5) if with_cs else None)
    return (jc.with_cs(1.5) if with_cs else jc), jpw


@pytest.mark.parametrize("dist,with_cs,power,c_max", [
    ("exponential", False, True, None),
    ("exponential", True, True, 6),
    ("exponential", False, False, 5),
    ("deterministic", True, False, None),
    ("deterministic", False, True, None),
    ("hyperexponential", True, True, 6),
    ("hyperexponential", False, True, None),
    ("lognormal", True, True, 6),
    ("lognormal", False, False, None),
])
def test_injected_class_blocks_bitwise_vs_jax(dist, with_cs, power, c_max):
    C, m, m_max, N = 4, 7, 9, 360
    jc, jpw = _jax_classes(0, C, with_cs)
    if c_max is not None:
        jc = jbz.pad_classes(jc, c_max)
        jpw = jen.PowerProfile(*[jnp.concatenate([x, jnp.zeros(c_max - C)])
                                 for x in jpw[:3]], P_cs=jpw.P_cs)
    jpw = jpw if power else None
    st0 = JE.init_class_state(jc, m, jax.random.PRNGKey(3), m_max=m_max,
                              distribution=dist, warmup=25, cap=75)
    _, blk = JE.draw_class_event_blocks(jc, jax.random.PRNGKey(5), N,
                                        distribution=dist)

    def body(s, b):
        return JE.step_class_event_block(jc, s, b, distribution=dist,
                                         power=jpw)[0], None

    want, _ = jax.jit(lambda s, b: jax.lax.scan(body, s, b))(st0, blk)
    want_stats = JE.finalize_stats(want)

    lanes = TE.stack_lanes
    tc = lanes([convert.class_params(_leaves(jc), device="cpu")])
    tpw = (None if jpw is None else
           lanes([convert.power_profile(_leaves(jpw), device="cpu")]))
    tst = lanes([convert.class_event_state(_leaves(st0), device="cpu")])
    if dist == "lognormal":  # the raw subkeys' normals
        blk = blk._replace(up=_normals(blk.up), comp=_normals(blk.comp))
    tblk = convert.event_blocks(_leaves(blk), device="cpu")
    assert tblk.member is not None
    tblk = TE.EventBlocks(*[None if x is None else x[:, None] for x in tblk])

    def same(g, w, what):
        g, w = g.numpy(), np.asarray(w)
        if dist == "lognormal" and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=str(what))
        else:
            assert np.array_equal(g, w), what

    for chunk in (1, 8):
        got = TE.run_event_blocks(tc, tst, tblk, distribution=dist,
                                  power=tpw, chunk=chunk)
        assert isinstance(got, TE.ClassEventState)
        for name in TE.ClassEventState._fields:
            same(getattr(got, name)[0], getattr(want, name), (chunk, name))
        stats = TE.finalize_stats(got)
        for name in TE.EventStats._fields:
            same(getattr(stats, name)[0], getattr(want_stats, name),
                 (chunk, name))
    assert int(want.round) > 75  # the window closed inside the run


def test_single_class_step_matches_jax_block_step():
    """One ``step_class_event_block`` call on lane-stacked inputs equals
    JAX's single step, ``EventOut`` included."""
    jc, _ = _jax_classes(1, 3, True)
    st = JE.init_class_state(jc, 5, jax.random.PRNGKey(0), m_max=6)
    _, blk = JE.draw_class_event_blocks(jc, jax.random.PRNGKey(1), 40)
    tc = TE.stack_lanes([convert.class_params(_leaves(jc), device="cpu")])
    tst = TE.stack_lanes([convert.class_event_state(_leaves(st),
                                                    device="cpu")])
    tblk = convert.event_blocks(_leaves(blk), device="cpu")
    step = jax.jit(lambda s, b: JE.step_class_event_block(jc, s, b))
    for i in range(40):
        b = JE.EventBlocks(*[x if not hasattr(x, "shape") or not x.shape
                             else x[i] for x in blk])
        st, out = step(st, b)
        one = TE.EventBlocks(*[None if x is None else x[i:i + 1]
                               for x in tblk])
        tst, tout = TE.step_class_event_block(tc, tst, one)
        for name in ("is_update", "time", "slot", "client", "delay"):
            assert np.array_equal(getattr(tout, name)[0].numpy(),
                                  np.asarray(getattr(out, name))), (i, name)
    for name in TE.ClassEventState._fields:
        assert np.array_equal(getattr(tst, name)[0].numpy(),
                              np.asarray(getattr(st, name))), name


def _classes(seed, C, with_cs=False):
    rng = np.random.default_rng(seed)
    count = rng.integers(1, 6, C)
    mass = rng.dirichlet(np.ones(C) * 2.0)
    spec = ClassSpec(mu_c=rng.uniform(0.5, 4.0, C),
                     mu_d=rng.uniform(0.5, 4.0, C),
                     mu_u=rng.uniform(0.5, 4.0, C), count=count,
                     p=mass / count)
    return spec.class_params(mu_cs=1.5 if with_cs else None, device="cpu")


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dist,with_cs", [("exponential", False),
                                          ("deterministic", True)])
def test_class_chunk_lanes_backends_and_padding_bitwise(dist, with_cs):
    cls = [_classes(s, 3, with_cs) for s in (1, 2, 3)]
    ms = [3, 5, 6]
    rng = np.random.default_rng(9)
    pw = PowerProfile(P_c=torch.as_tensor(rng.uniform(1, 3, 3)),
                      P_u=torch.as_tensor(rng.uniform(1, 3, 3)),
                      P_d=torch.as_tensor(rng.uniform(1, 3, 3)),
                      P_cs=torch.tensor(2.0, dtype=torch.float64)
                      if with_cs else None)
    kw = dict(warmup=20, distribution=dist, power=pw, m_max=6,
              seeds=[4, 5, 6], draw_events=64)
    base = simulate_stats_classes_lanes(cls, ms, 100, backend="batched",
                                        **kw)
    for chunk in (3, 8):
        got = simulate_stats_classes_lanes(cls, ms, 100, backend="batched",
                                           chunk=chunk, **kw)
        assert _equal(got, base), chunk
    ref = simulate_stats_classes_lanes(cls, ms, 100, backend="reference",
                                       **kw)
    assert _equal(ref, base)
    for i, (c, m, seed) in enumerate(zip(cls, ms, kw["seeds"])):
        single = TE.simulate_stats_classes(c, m, 100, warmup=20, seed=seed,
                                           distribution=dist, power=pw,
                                           m_max=6, draw_events=64)
        assert _equal(single, TE.lane(base, i))
    # padded classes: the same draws and the same statistics on real rows
    padded = tbz.pad_classes(cls[0], 5)
    pw_pad = PowerProfile(*[torch.cat([x, torch.zeros(2, dtype=x.dtype)])
                            for x in pw[:3]], P_cs=pw.P_cs)
    got = TE.simulate_stats_classes(padded, 3, 100, warmup=20, seed=4,
                                    distribution=dist, power=pw_pad, m_max=6,
                                    draw_events=64)
    want = TE.lane(base, 0)
    for name in ("updates", "time", "throughput", "energy"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.mean_delay[:3], want.mean_delay)
    assert torch.equal(got.delay_counts[:3], want.delay_counts)
    assert torch.all(got.delay_counts[3:] == 0)
    occ_g, occ_w = got.mean_queue_counts, want.mean_queue_counts
    for seg in range(3):
        assert torch.equal(occ_g[5 * seg:5 * seg + 3],
                           occ_w[3 * seg:3 * seg + 3])
        assert torch.all(occ_g[5 * seg + 3:5 * seg + 5] == 0)
    assert torch.equal(occ_g[15:], occ_w[9:])


def test_expand_class_stats_shapes_and_weights():
    cls = _classes(4, 3, with_cs=True)
    stats = TE.simulate_stats_classes(cls, 6, 300, warmup=50, seed=1)
    count = cls.count
    n = int(count.sum())
    ex = TE.expand_class_stats(stats, count)
    assert ex.mean_delay.shape == (n,)
    assert ex.delay_counts.shape == (n,)
    assert ex.mean_queue_counts.shape == (3 * n + 1,)
    # the per-member split conserves each class's totals
    torch.testing.assert_close(ex.delay_counts.sum(),
                               stats.delay_counts.sum().to(torch.float64))
    torch.testing.assert_close(ex.mean_queue_counts.sum(),
                               stats.mean_queue_counts.sum())
    starts = torch.cumsum(count, 0) - count
    for c in range(3):
        assert torch.equal(ex.mean_delay[starts[c]:starts[c] + count[c]],
                           stats.mean_delay[c].expand(int(count[c])))
    # lanes keep their leading axis; padded classes drop out
    lanes = simulate_stats_classes_lanes(
        [tbz.pad_classes(cls, 4)] * 2, [6, 6], 100, seeds=[0, 1])
    ex2 = TE.expand_class_stats(lanes, tbz.pad_classes(cls, 4).count)
    assert ex2.mean_delay.shape == (2, n)
    assert ex2.mean_queue_counts.shape == (2, 3 * n + 1)


def test_class_engine_matches_expanded_distributionally():
    """The class engine's throughput on Table 1 at scale 10 (n = 9) within
    10% of the per-client engine on ``expand()`` and of Prop. 4."""
    cls = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10)
    cp = cls.class_params(device="cpu")
    m = 6
    lam = float(throughput(cp.expand(), m))
    c_stats = simulate_stats_classes_lanes([cp] * 4, [m] * 4, 2_000,
                                           warmup=300, seeds=range(4))
    p_stats = simulate_stats_lanes([cp.expand()] * 4, [m] * 4, 2_000,
                                   warmup=300, seeds=range(4))
    thr_c = float(c_stats.throughput.mean())
    thr_p = float(p_stats.throughput.mean())
    assert thr_c == pytest.approx(thr_p, rel=0.1)
    assert thr_c == pytest.approx(lam, rel=0.1)
    # closed network: the time-averaged occupancy sums to m
    np.testing.assert_allclose(c_stats.mean_queue_counts.sum(-1).numpy(), m,
                               rtol=1e-9)


def test_class_route_draws_members_uniformly_and_skips_padding():
    cp = tbz.pad_classes(ClassSpec(mu_c=[1.0, 2.0], mu_d=[1.0, 1.0],
                                   mu_u=[1.0, 1.0], count=[3, 400_000],
                                   p=[0.1, 0.7 / 400_000]).class_params(
                                       device="cpu"), 3)
    _, blk = TE.draw_class_event_blocks(cp, prng.PRNGKey(0, device="cpu"),
                                        20_000)
    assert blk.member.dtype == torch.int64
    assert bool((blk.c_new < 2).all())
    frac = float((blk.c_new == 0).double().mean())
    assert frac == pytest.approx(0.3, abs=0.02)
    big = blk.member[blk.c_new == 1]
    assert int(big.max()) < 400_000 and int(big.min()) >= 0
    assert float(big.double().mean()) == pytest.approx(200_000, rel=0.02)
    small = blk.member[blk.c_new == 0]
    assert set(small.tolist()) == {0, 1, 2}


def test_class_lanes_refuse_kernel_backend():
    cp = _classes(5, 2)
    with pytest.raises(ValueError, match="no kernel"):
        simulate_stats_classes_lanes([cp], [3], 10, backend="kernel")
    with pytest.raises(ValueError, match="no kernel"):
        TE.simulate_stats_classes(cp, 3, 10, backend="kernel")
    with pytest.raises(TypeError):
        simulate_stats_classes_lanes([cp.expand()], [3], 10)
