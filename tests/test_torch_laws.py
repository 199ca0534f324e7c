"""The port's timing laws (``repro_torch.scenario.laws``) against the JAX
package's (``repro.scenario.laws``), and inside the port.

1. The host samplers make the JAX laws' numpy calls: bitwise the same
   draws from the same ``numpy.random.Generator``, for all four laws.
2. Moments, as ``tests/test_scenario.py`` checks them: the
   hyperexponential's mean within 5% of ``1/mu`` and its SCV 4 within
   15%, the lognormal's mean within 5%, host and device draws.
3. The unit factorization ``unit_apply(unit_draw(g, shape), rate) ==
   device_draw(g, rate)`` bitwise; each law's rate form applied to the
   JAX law's own unit parts gives the JAX law's service (the
   hyperexponential bitwise, the lognormal within ``rtol 1e-12``: XLA's
   ``exp`` and ``log`` are not PyTorch's).
4. Inside the port every law is bitwise across the ``reference``,
   ``batched`` and ``kernel`` routes, megasteps E = 3, 8 and 32 against E
   = 1, lanes against single runs and padded ``n`` against unpadded.
5. Host against device, with the JAX package's tolerances
   (``tests/test_events.py``): throughput within ``rtol 0.06``, mean
   delays within ``rtol 0.15, atol 0.1``, over 10,000 updates after 1,000
   of warm-up, pooled over 8 lanes on the device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.scenario import laws as JL
from repro_torch.core import buzen as tbz
from repro_torch.core import events as TE
from repro_torch.core import prng
from repro_torch.core.energy import PowerProfile
from repro_torch.core.simulator import AsyncNetworkSim, make_sampler
from repro_torch.kernels import events as ke
from repro_torch.scenario import laws as TL
from repro_torch.sim import simulate_stats_lanes

LAWS = ["exponential", "deterministic", "lognormal", "hyperexponential"]
NEW = ["lognormal", "hyperexponential"]


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _net(seed, n, with_cs=False):
    rng = np.random.default_rng(seed)
    prm = tbz.NetworkParams(p=_t(rng.dirichlet(np.ones(n) * 2.0)),
                            mu_c=_t(rng.uniform(0.5, 4.0, n)),
                            mu_d=_t(rng.uniform(0.5, 4.0, n)),
                            mu_u=_t(rng.uniform(0.5, 4.0, n)))
    return prm.with_cs(1.5) if with_cs else prm


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("law", LAWS)
def test_host_samplers_bitwise_jax(law):
    mus = np.random.default_rng(1).uniform(0.2, 6.0, 500)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    want = [JL.get_law(law).host_sample(float(mu), rj) for mu in mus]
    got = [TL.get_law(law).host_sample(float(mu), rt) for mu in mus]
    assert np.array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="positive"):
        make_sampler(law, np.random.default_rng(0))(0.0)


@pytest.mark.parametrize("law", NEW)
def test_moments_host_and_device(law):
    mu, N = 2.5, 60_000
    sampler = make_sampler(law, np.random.default_rng(0))
    host = np.array([sampler(mu) for _ in range(N)])
    dev = TL.get_law(law).device_draw(
        prng.PRNGKey(1, device="cpu"),
        torch.full((N,), mu, dtype=torch.float64), (N,))
    for xs in (host, dev.numpy()):
        assert xs.mean() == pytest.approx(1.0 / mu, rel=0.05)
        if law == "hyperexponential":
            assert xs.var() / xs.mean() ** 2 == pytest.approx(4.0, rel=0.15)


@pytest.mark.parametrize("law", LAWS)
def test_unit_factorization_bitwise(law):
    tl = TL.get_law(law)
    for shape in ((7,), (3, 5), (1024,)):
        rate = _t(np.random.default_rng(2).uniform(0.1, 9.0, shape))
        key = prng.PRNGKey(3, device="cpu")
        u = tl.unit_draw(key, rate.shape)
        want = tl.device_draw(key, rate, rate.shape)
        got = tl.unit_apply(u, rate)
        assert got.shape == rate.shape and torch.equal(got, want)
        x, f = tl.unit_split(u)
        assert torch.equal(TL.apply_rate(tl.form, x, f, rate), got)
    assert tl.form == {"lognormal": "lognormal",
                       "hyperexponential": "h2"}.get(law, "scale")


def test_h2_constants_and_forms_are_the_jax_laws():
    q = JL._H2_Q
    assert TL.H2_FAST == 2.0 * q and TL.H2_SLOW == 2.0 * (1.0 - q)
    rate = _t([1.0, 2.0])
    with pytest.raises(ValueError, match="forms"):
        TL.apply_rate("weibull", rate, None, rate)
    # a zero rate (a client outside the network) gives inf in every form
    zero = torch.zeros(1, dtype=torch.float64)
    for form in TL.FORMS:
        assert torch.isinf(TL.apply_rate(form, _t([0.7]), _t([1.2]),
                                         zero)).all()


@pytest.mark.parametrize("law", NEW)
def test_rate_form_on_jax_unit_parts(law):
    key = jax.random.PRNGKey(11)
    rate = np.random.default_rng(4).uniform(0.1, 9.0, 400)
    if law == "hyperexponential":
        jl = JL.get_law(law)
        u = jax.jit(lambda k: jl.unit_draw(k, (400,)))(key)
        want = np.asarray(jax.jit(jl.unit_apply)(u, jnp.asarray(rate)))
        got = TL.get_law(law).unit_apply(
            torch.stack([_t(np.asarray(u[0])), _t(np.asarray(u[1]))], -1),
            _t(rate))
        assert np.array_equal(got.numpy(), want)
    else:
        z = np.asarray(jax.jit(lambda k: jax.random.normal(k, (400,)))(key))
        want = np.asarray(jax.jit(lambda k, r: JL.get_law(law).device_draw(
            k, r, (400,)))(key, jnp.asarray(rate)))
        got = TL.get_law(law).unit_apply(_t(z), _t(rate))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("law,with_cs", [("hyperexponential", True),
                                         ("lognormal", False)])
def test_laws_bitwise_inside_the_port(law, with_cs):
    n = 4
    prms = [_net(s, n, with_cs) for s in (1, 2, 3)]
    ms = [3, 5, 6]
    rng = np.random.default_rng(9)
    pw = PowerProfile(P_c=_t(rng.uniform(1, 3, n)),
                      P_u=_t(rng.uniform(1, 3, n)),
                      P_d=_t(rng.uniform(1, 3, n)),
                      P_cs=_t(2.0) if with_cs else None)
    kw = dict(warmup=20, distribution=law, power=pw, m_max=6,
              seeds=[4, 5, 6], draw_events=50)
    base = simulate_stats_lanes(prms, ms, 100, chunk=1, backend="batched",
                                **kw)
    assert int(base.updates.min()) == 100
    for chunk, backend in ((1, "kernel"), (3, "reference"), (8, "kernel"),
                           (32, "batched"), (32, "kernel")):
        got = simulate_stats_lanes(prms, ms, 100, chunk=chunk,
                                   backend=backend, **kw)
        assert _equal(base, got), (chunk, backend)
    for i, (prm, m, seed) in enumerate(zip(prms, ms, kw["seeds"])):
        single = TE.simulate_stats(prm, m, 100, warmup=20, seed=seed,
                                   distribution=law, power=pw, m_max=6,
                                   chunk=8, backend="kernel", draw_events=50)
        assert _equal(single, TE.lane(base, i)), i
    # padded n: the same draws, statistics bitwise after unpadding
    pw_pad = PowerProfile(*[torch.cat([x, torch.zeros(3, dtype=x.dtype)])
                            for x in pw[:3]], P_cs=pw.P_cs)
    got = TE.simulate_stats(tbz.pad_network(prms[0], 7), 3, 100, warmup=20,
                            seed=4, distribution=law, power=pw_pad, m_max=6,
                            chunk=8, backend="kernel", draw_events=50)
    assert _equal(TE.unpad_stats(got, n), TE.lane(base, 0))


def test_lane_wrappers_check_the_law_width():
    prm = TE.stack_lanes([_net(1, 3)])
    st = TE.stack_lanes([TE.init_state(TE.lane(prm, 0), 3,
                                       prng.PRNGKey(0, device="cpu"))])
    fs4 = torch.ones(1, 2, 4, dtype=torch.float64)
    cn = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="fs"):
        ke.megastep_lanes(prm, st, fs4, cn, 2, law="hyperexponential")
    with pytest.raises(ValueError, match="fs"):
        ke.event_step_lanes(prm, st, torch.ones(1, 6, dtype=torch.float64),
                            cn[:, 0], law="lognormal")
    with pytest.raises(ValueError, match="registered service"):
        ke.megastep_lanes(prm, st, fs4, cn, 2, law="weibull")


@pytest.mark.parametrize("law", NEW)
def test_host_against_device(law):
    prm = _net(10, 3)
    m, L, updates, warmup = 4, 8, 10_000, 1_000
    st = simulate_stats_lanes([prm] * L, [m] * L, updates // L,
                              warmup=warmup // L, seeds=range(L),
                              distribution=law, chunk=32, backend="kernel")
    # pooled over the lanes: the updates over the summed horizon, and the
    # delays over every lane's samples
    thr = float(st.updates.sum() / st.time.sum())
    cnt = st.delay_counts.sum(0)
    delay = (st.mean_delay * st.delay_counts).sum(0) / cnt
    host = AsyncNetworkSim(prm, m, distribution=law, seed=0).run(
        updates, warmup=warmup)
    np.testing.assert_allclose(thr, host.throughput, rtol=0.06)
    np.testing.assert_allclose(delay.numpy(), host.mean_delay, rtol=0.15,
                               atol=0.1)
    assert bool(torch.isfinite(delay).all())
