"""Port parity: the class-aggregated analysis path (``ClassParams``, the
class Buzen DP, the class closed forms, ``time_optimal_classes``,
``ClassSpec``) against the JAX package and against the port's own
per-client forms on ``expand()``.

Tolerances: the float64 class DP ``rtol 1e-12`` (as ``tests/test_classes.py``
holds it against the expanded DP); the float64 closed forms ``rtol 1e-10``;
the class sweep ``rtol 1e-6`` and the same ``m*`` (as the per-client sweep
of ``tests/test_torch_optimize.py``); class padding bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import batched as jbat
from repro.core import buzen as jbz
from repro.core import energy as jen
from repro.core import events as JE
from repro.core.complexity import LearningConstants as JLC
from repro.core.optimize import time_optimal_classes as j_time_optimal
from repro_torch import convert
from repro_torch.core import batched as tbat
from repro_torch.core import buzen as tbz
from repro_torch.core import complexity as tcx
from repro_torch.core import energy as ten
from repro_torch.core import jackson as tjk
from repro_torch.core.complexity import LearningConstants
from repro_torch.core.optimize import time_optimal_classes
from repro_torch.scenario.spec import (PAPER_CLUSTERS_TABLE1, ClassSpec,
                                       LearningSpec, NetworkSpec)

RTOL = 1e-10
CONSTS = dict(L=1.3, delta=2.0, sigma=0.7, M=1.5, G=3.0, eps=0.5)


def _leaves(tree):
    return {k: None if v is None else np.asarray(v)
            for k, v in tree._asdict().items()}


def _setup(seed, C, with_cs):
    rng = np.random.default_rng(seed)
    count = rng.integers(1, 9, C)
    mass = rng.dirichlet(np.ones(C) * 2.0)
    jc = jbz.ClassParams(p=jnp.asarray(mass / count),
                         mu_c=jnp.asarray(rng.uniform(0.3, 5.0, C)),
                         mu_d=jnp.asarray(rng.uniform(0.3, 5.0, C)),
                         mu_u=jnp.asarray(rng.uniform(0.3, 5.0, C)),
                         count=jnp.asarray(count, jnp.int64))
    if with_cs:
        jc = jc.with_cs(2.2)
    jpw = jen.PowerProfile.from_dvfs(
        jnp.asarray(rng.uniform(0.1, 2.0, C)), jc.mu_c,
        jnp.asarray(rng.uniform(1.0, 5.0, C)),
        jnp.asarray(rng.uniform(1.0, 5.0, C)),
        jnp.asarray(3.0) if with_cs else None)
    tc = convert.class_params(_leaves(jc), device="cpu")
    tpw = convert.power_profile(_leaves(jpw), device="cpu")
    return jc, tc, jpw, tpw


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_cs", [False, True])
def test_class_dp_matches_jax_and_expanded(with_cs):
    jc, tc, _, _ = _setup(0, 4, with_cs)
    want = jax.jit(lambda c: jbz.class_log_normalizing_constants(
        c, 30, backend="jnp"))(jc)
    got = tbz.class_log_normalizing_constants(tc, 30, backend="torch")
    assert got.dtype == torch.float64
    _close(got, want, rtol=1e-12)
    per_client = tbz.log_normalizing_constants(tc.expand(), 30)
    _close(got, per_client.numpy(), rtol=1e-12)
    # count 1 is the geometric series exactly
    geo = tbz._geometric_series(tc.log_rho, 30)
    assert torch.equal(tbz._negbinom_series(tc.log_rho,
                                            torch.ones_like(tc.count), 30),
                       geo)


@pytest.mark.parametrize("with_cs", [False, True])
@pytest.mark.parametrize("m", [1, 7])
def test_class_forms_match_jax(with_cs, m):
    jc, tc, jpw, tpw = _setup(1, 4, with_cs)
    m_max = 12
    consts = LearningConstants(**CONSTS)
    jconsts = JLC(**CONSTS)

    def forms(c, pw):
        logZ = jbz.class_log_normalizing_constants(c, m_max, backend="jnp")
        mm = jnp.asarray(m)
        cross, same = jbat.second_moment_classes(c, mm, logZ, m_max)
        jx, js = jbat.delay_jacobian_classes(c, mm, logZ, m_max)
        return dict(
            lam=jbat.throughput_padded(logZ, mm),
            delays=jbat.expected_relative_delay_classes(c, mm, logZ, m_max),
            k_eps=jbat.round_complexity_classes(c, mm, jconsts, logZ, m_max),
            tau=jbat.wallclock_time_classes(c, mm, jconsts, logZ, m_max),
            energy=jbat.energy_complexity_classes(c, mm, jconsts, pw, logZ,
                                                  m_max),
            joint=jbat.joint_objective_classes(c, mm, jconsts, pw, 0.3,
                                               2.0, 5.0, logZ, m_max),
            e_round=jen.energy_per_round_classes(c, pw),
            cross=cross, same=same, j_cross=jx, j_same=js)

    want = jax.jit(forms)(jc, jpw)
    tb = tc._replace(p=tc.p[None])
    mm = torch.tensor([m])
    logZ = tbat.batch_class_log_normalizing_constants(tc, tb.p, m_max,
                                                      backend="torch")
    cross, same = tbat.second_moment_classes(tb, mm, logZ, m_max)
    jx, js = tbat.delay_jacobian_classes(tb, mm, logZ, m_max)
    got = dict(
        lam=tbat.throughput_padded(logZ, mm),
        delays=tbat.expected_relative_delay_classes(tb, mm, logZ, m_max),
        k_eps=tbat.round_complexity_classes(tb, mm, consts, logZ, m_max),
        tau=tbat.wallclock_time_classes(tb, mm, consts, logZ, m_max),
        energy=tbat.energy_complexity_classes(tb, mm, consts, tpw, logZ,
                                              m_max),
        joint=tbat.joint_objective_classes(tb, mm, consts, tpw, 0.3, 2.0,
                                           5.0, logZ, m_max),
        e_round=ten.energy_per_round_classes(tc, tpw),
        cross=cross, same=same, j_cross=jx, j_same=js)
    for k in want:
        g = got[k] if k == "e_round" else got[k][0]
        _close(g, want[k], atol=1e-300 if m == 1 else 0.0)


@pytest.mark.parametrize("with_cs", [False, True])
def test_class_forms_match_per_client_forms_on_expand(with_cs):
    _, tc, _, tpw = _setup(2, 3, with_cs)
    prm = tc.expand()
    cnt = tc.count
    pw_p = ten.PowerProfile(*[torch.repeat_interleave(x, cnt)
                              for x in tpw[:3]], P_cs=tpw.P_cs)
    consts = LearningConstants(**CONSTS)
    m, m_max = 6, 10
    tb = tc._replace(p=tc.p[None])
    mm = torch.tensor([m])
    logZ = tbat.batch_class_log_normalizing_constants(tc, tb.p, m_max)
    _close(logZ[0], tbz.log_normalizing_constants(prm, m_max).numpy(),
           rtol=1e-12)
    _close(tbat.throughput_padded(logZ, mm)[0],
           tjk.throughput(prm, m).numpy())
    d = tbat.expected_relative_delay_classes(tb, mm, logZ, m_max)[0]
    _close(torch.repeat_interleave(d, cnt),
           tjk.expected_relative_delay(prm, m).numpy())
    _close(tbat.round_complexity_classes(tb, mm, consts, logZ, m_max)[0],
           tcx.round_complexity(prm, m, consts).numpy())
    _close(tbat.wallclock_time_classes(tb, mm, consts, logZ, m_max)[0],
           tcx.wallclock_time(prm, m, consts).numpy())
    _close(ten.energy_per_round_classes(tc, tpw),
           ten.energy_per_round(prm, pw_p).numpy())
    cross, same = tbat.second_moment_classes(tb, mm, logZ, m_max)
    _close(tbat.expand_class_matrix(cross[0], same[0], cnt),
           tjk.second_moment_matrix(prm, m).numpy())
    jx, js = tbat.delay_jacobian_classes(tb, mm, logZ, m_max)
    _close(tbat.expand_class_matrix(jx[0], js[0], cnt),
           tjk.delay_jacobian(prm, m).numpy(), atol=1e-12)


@pytest.mark.parametrize("with_cs", [False, True])
def test_class_forms_bitwise_invariant_to_padding(with_cs):
    _, tc, _, tpw = _setup(3, 4, with_cs)
    pad = tbz.pad_classes(tc, 7)
    pw_pad = ten.PowerProfile(*[torch.cat([x, torch.ones(3, dtype=x.dtype)])
                                for x in tpw[:3]], P_cs=tpw.P_cs)
    consts = LearningConstants(**CONSTS)
    m_max = 15
    ms = torch.tensor([1, 2, 9, 15])
    outs = []
    for c, pw in ((tc, tpw), (pad, pw_pad)):
        rows = c.p.expand(4, -1)
        cb = c._replace(p=rows)
        logZ = tbat.batch_class_log_normalizing_constants(c, rows, m_max)
        outs.append(dict(
            logZ=logZ,
            logZ_kernel=tbat.batch_class_log_normalizing_constants(
                c, rows, m_max, backend="kernel"),
            k_eps=tbat.round_complexity_classes(cb, ms, consts, logZ, m_max),
            tau=tbat.wallclock_time_classes(cb, ms, consts, logZ, m_max),
            energy=tbat.energy_complexity_classes(cb, ms, consts, pw, logZ,
                                                  m_max),
            delays=tbat.expected_relative_delay_classes(
                cb, ms, logZ, m_max)[:, :4]))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def _jax_network(net):
    return jbz.NetworkParams(p=jnp.asarray(net.p.numpy()),
                             mu_c=jnp.asarray(net.mu_c.numpy()),
                             mu_d=jnp.asarray(net.mu_d.numpy()),
                             mu_u=jnp.asarray(net.mu_u.numpy()))


def test_classes_from_network_keeps_first_occurrence_order():
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=5).params(
        device="cpu")
    # interleave the clusters so np.unique's sorted order differs
    perm = torch.as_tensor(np.random.default_rng(0).permutation(net.n))
    net = net._replace(p=net.p[perm], mu_c=net.mu_c[perm],
                       mu_d=net.mu_d[perm], mu_u=net.mu_u[perm])
    want = jbz.classes_from_network(_jax_network(net))
    got = tbz.classes_from_network(net)
    for k in ("p", "mu_c", "mu_d", "mu_u", "count"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    first = [float(x) for x in net.mu_c[:3]]
    assert [float(x) for x in got.mu_c[:len(set(first))]] == list(
        dict.fromkeys(first))
    assert int(got.n_total) == net.n
    # padded rows drop out
    padded = tbz.pad_network(net, net.n + 3)
    assert torch.equal(tbz.classes_from_network(padded).count, got.count)


def test_time_optimal_classes_matches_jax():
    cls = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10)
    consts = LearningSpec().consts
    jc = jbz.ClassParams(p=jnp.full(cls.C, 1.0 / cls.n_total),
                         mu_c=jnp.asarray(cls.mu_c),
                         mu_d=jnp.asarray(cls.mu_d),
                         mu_u=jnp.asarray(cls.mu_u),
                         count=jnp.asarray(cls.count))
    want = j_time_optimal(jc, JLC(**consts._asdict()), 15, steps=40)
    got = time_optimal_classes(cls.class_params(device="cpu"), consts, 15,
                               steps=40, backend="torch")
    assert got.m == want.m
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-6)
    np.testing.assert_allclose(float((got.p * cls.class_params(
        device="cpu").count).sum()), 1.0, rtol=1e-12)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_sweep_over_padded_classes_is_finite_and_unchanged(backend):
    """A padded class set gives a finite gradient on every row (zero on
    the padded logits) and the unpadded sweep's result; the JAX package's
    sweep is NaN there (its ``log p`` at ``p = 0``)."""
    cls = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10)
    consts = LearningSpec().consts
    cp = cls.class_params(device="cpu")
    pad = tbz.pad_classes(cp, 7)
    obj = tbat.make_time_objective_classes(pad, consts, 12)
    cnt = pad.count.to(torch.float64)
    theta = torch.log(torch.clamp(cnt / cnt.sum(), min=1e-12)).expand(
        11, -1).clone().requires_grad_(True)
    live = pad.count > 0
    ps = torch.softmax(torch.where(live, theta, -torch.inf), -1) / torch.where(
        live, cnt, 1.0)
    logZ = tbat.batch_class_log_normalizing_constants(pad, ps, 12,
                                                      backend=backend)
    (g,) = torch.autograd.grad(obj(ps, torch.arange(2, 13), logZ).sum(),
                               theta)
    assert bool(torch.isfinite(g).all())
    assert bool((g[:, 5:] == 0).all()) and bool((g[:, :5] != 0).any())
    a = time_optimal_classes(cp, consts, 12, steps=15, backend=backend)
    b = time_optimal_classes(pad, consts, 12, steps=15, backend=backend)
    assert a.m == b.m and np.isfinite(b.value)
    np.testing.assert_allclose(b.value, a.value, rtol=1e-12)
    np.testing.assert_allclose(b.p[:5].numpy(), a.p.numpy(), rtol=1e-12)
    assert bool((b.p[5:] == 0).all())


def test_kernel_backend_sweep_matches_torch():
    """The float32 class kernel's sweep within ``rtol 1e-4`` of the
    float64 one (the chip's cross-backend gate, here with the plain
    version)."""
    cp = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10).class_params(
        mu_cs=4.0, device="cpu")
    consts = LearningSpec().consts
    a = time_optimal_classes(cp, consts, 12, steps=20, backend="torch")
    b = time_optimal_classes(cp, consts, 12, steps=20, backend="kernel")
    np.testing.assert_allclose([v for _, v in b.history],
                               [v for _, v in a.history], rtol=1e-4)


def test_classspec_and_networkspec_classes():
    spec = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, aggregate=True,
                                     mu_cs=3.0)
    assert spec.classes is not None and spec.n == 100
    assert spec.classes.C == 5 and spec.classes.n_total == 100
    cp = spec.class_params(device="cpu")
    assert cp.count.tolist() == [15, 15, 20, 40, 10]
    assert float(cp.mu_cs) == 3.0
    torch.testing.assert_close(cp.mass.sum(), torch.tensor(
        1.0, dtype=torch.float64))
    prm = spec.params(device="cpu")
    assert prm.n == 100 and float(prm.mu_cs) == 3.0
    flat = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).params(
        device="cpu")
    assert torch.equal(prm.mu_c, flat.mu_c)
    torch.testing.assert_close(prm.p, flat.p, rtol=1e-15, atol=0)
    with pytest.raises(ValueError):
        NetworkSpec(mu_c=[1.0], mu_d=[1.0], mu_u=[1.0],
                    classes=spec.classes)
    with pytest.raises(ValueError):
        NetworkSpec()
    with pytest.raises(ValueError):
        NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).class_params()
    with pytest.raises(ValueError, match=">= 1"):
        ClassSpec(mu_c=[1.0, 2.0], mu_d=[1.0, 1.0], mu_u=[1.0, 1.0],
                  count=[3, 0])
    with pytest.raises(ValueError, match="integers"):
        ClassSpec(mu_c=[1.0], mu_d=[1.0], mu_u=[1.0], count=[2.5])
    with pytest.raises(ValueError, match="length"):
        ClassSpec(mu_c=[1.0, 2.0], mu_d=[1.0, 1.0], mu_u=[1.0, 1.0],
                  count=[3])
    big = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=1)
    assert ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1,
                                   scale=1000).count.tolist() == [1] * 5
    assert big.class_params(device="cpu").n_total.item() == 100


def test_convert_class_leaves():
    jc, tc, _, _ = _setup(4, 3, True)
    assert tc.count.dtype == torch.int64
    assert np.array_equal(tc.count.numpy(), np.asarray(jc.count))
    st = jax.jit(lambda c: JE.init_class_state(c, 4, jax.random.PRNGKey(0),
                                               m_max=5))(jc)
    ts = convert.class_event_state(_leaves(st), device="cpu")
    assert ts.cls.dtype == torch.int32 and ts.member.dtype == torch.int32
    assert np.array_equal(ts.member.numpy(), np.asarray(st.member))
    assert ts.occ.shape == (3 * 3 + 1,)
