"""Port parity: the float64 closed forms (Jackson, complexity, energy and the
batched ``*_padded`` forms) against the JAX package at ``rtol 1e-10``, the
tolerance class of ``tests/test_batched_optimizer.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import batched as jbat
from repro.core import buzen as jbz
from repro.core import complexity as jcx
from repro.core import energy as jen
from repro.core import jackson as jjk
from repro_torch import convert
from repro_torch.core import batched as tbat
from repro_torch.core import buzen as tbz
from repro_torch.core import complexity as tcx
from repro_torch.core import energy as ten
from repro_torch.core import jackson as tjk

RTOL = 1e-10
CONSTS = dict(L=1.3, delta=2.0, sigma=0.7, M=1.5, G=3.0, eps=0.5)


def _leaves(tree):
    return {k: None if v is None else np.asarray(v)
            for k, v in tree._asdict().items()}


def _setup(seed, n, with_cs):
    rng = np.random.default_rng(seed)
    jp = jbz.NetworkParams(p=jnp.asarray(rng.dirichlet(np.ones(n) * 2.0)),
                           mu_c=jnp.asarray(rng.uniform(0.3, 5.0, n)),
                           mu_d=jnp.asarray(rng.uniform(0.3, 5.0, n)),
                           mu_u=jnp.asarray(rng.uniform(0.3, 5.0, n)))
    if with_cs:
        jp = jp.with_cs(2.2)
    jpw = jen.PowerProfile.from_dvfs(
        jnp.asarray(rng.uniform(0.1, 2.0, n)), jp.mu_c,
        jnp.asarray(rng.uniform(1.0, 5.0, n)),
        jnp.asarray(rng.uniform(1.0, 5.0, n)),
        jnp.asarray(3.0) if with_cs else None)
    tp = convert.network_params(_leaves(jp), device="cpu")
    tpw = convert.power_profile(_leaves(jpw), device="cpu")
    return jp, tp, jpw, tpw


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_cs", [False, True])
@pytest.mark.parametrize("m", [1, 7])
def test_jackson_matches_jax(with_cs, m):
    jp, tp, _, _ = _setup(0, 5, with_cs)
    want = jax.jit(lambda q: {**jjk.analyze(q, m),
                              "second": jjk.second_moment_matrix(q, m)})(jp)
    got = tjk.analyze(tp, m)
    _close(tjk.second_moment_matrix(tp, m), want["second"], atol=1e-14)
    for key in ("logZ", "delays", "total_delay", "throughput",
                "throughput_grad"):
        _close(got[key], want[key], atol=1e-14)
    if m > 1:
        _close(got["delay_jacobian"], want["delay_jacobian"], atol=1e-12)
    _close(tjk.expected_relative_delay(tp, m), want["delays"], atol=1e-14)
    _close(tjk.throughput(tp, m), want["throughput"])


@pytest.mark.parametrize("with_cs", [False, True])
def test_closed_form_gradients_match_autograd_and_jax(with_cs):
    """The closed-form Jacobians (Thm 2 Eq 4, Prop 4 Eq 12) against
    ``torch.autograd`` of the port and ``jax.grad`` of the reference."""
    jp, tp, _, _ = _setup(1, 4, with_cs)
    m = 6
    p = tp.p.clone().requires_grad_(True)
    lam = tjk.throughput(tp._replace(p=p), m)
    (g,) = torch.autograd.grad(lam, p)
    _close(tjk.throughput_grad(tp, m), g, rtol=1e-8)
    jg = jax.grad(lambda q: jjk.throughput(jp._replace(p=q), m))(jp.p)
    _close(g, jg, rtol=1e-9)
    jac = torch.autograd.functional.jacobian(
        lambda q: tjk.expected_relative_delay(tp._replace(p=q), m), tp.p)
    _close(tjk.delay_jacobian(tp, m), jac, rtol=1e-7, atol=1e-10)
    jj = jax.jacrev(lambda q: jjk.expected_relative_delay(
        jp._replace(p=q), m))(jp.p)
    _close(jac, jj, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("with_cs", [False, True])
@pytest.mark.parametrize("m", [1, 8])
def test_complexity_and_energy_match_jax(with_cs, m):
    jp, tp, jpw, tpw = _setup(2, 6, with_cs)
    jc, tc = jcx.LearningConstants(**CONSTS), tcx.LearningConstants(**CONSTS)
    _close(tcx.round_complexity(tp, m, tc), jcx.round_complexity(jp, m, jc))
    _close(tcx.round_complexity_unbounded(tp, m, tc),
           jcx.round_complexity_unbounded(jp, m, jc))
    _close(tcx.wallclock_time(tp, m, tc), jcx.wallclock_time(jp, m, jc))
    if m > 1:
        _close(tcx.eta_max(tp, m, tc), jcx.eta_max(jp, m, jc))
    _close(ten.per_task_energy(tp, tpw), jen.per_task_energy(jp, jpw))
    _close(ten.energy_per_round(tp, tpw), jen.energy_per_round(jp, jpw))
    _close(ten.energy_complexity(tp, m, tc, tpw),
           jen.energy_complexity(jp, m, jc, jpw))
    _close(ten.energy_optimal_routing(tp, tpw),
           jen.energy_optimal_routing(jp, jpw))
    _close(ten.minimal_energy(tp, tc, tpw), jen.minimal_energy(jp, jc, jpw))
    _close(ten.joint_objective(tp, m, tc, tpw, 0.3, 7.0, 11.0),
           jen.joint_objective(jp, m, jc, jpw, 0.3, 7.0, 11.0))


@pytest.mark.parametrize("with_cs,n_max", [(False, None), (True, 9)])
def test_padded_forms_match_jax(with_cs, n_max):
    """Batched rows of the port's ``*_padded`` forms against the JAX forms
    vmapped over the same rows (optionally on a padded-``n`` network)."""
    jp, tp, jpw, tpw = _setup(3, 5, with_cs)
    if n_max is not None:
        jp, tp = jbz.pad_network(jp, n_max), tbz.pad_network(tp, n_max)
        jpw = jen.PowerProfile(*[None if x is None else jnp.concatenate(
            [x, jnp.zeros(n_max - 5)]) if x.ndim else x for x in jpw])
        tpw = convert.power_profile(_leaves(jpw), device="cpu")
    m_max = 9
    rng = np.random.default_rng(4)
    B = 6
    p_rows = rng.dirichlet(np.ones(5), size=B)
    if n_max is not None:
        p_rows = np.concatenate([p_rows, np.zeros((B, n_max - 5))], axis=1)
    m_rows = np.array([1, 2, 3, 5, 8, 9])
    jc, tc = jcx.LearningConstants(**CONSTS), tcx.LearningConstants(**CONSTS)

    jlz = jbat.batch_log_normalizing_constants(jp, jnp.asarray(p_rows), m_max)
    tlz = tbat.batch_log_normalizing_constants(tp, torch.as_tensor(p_rows),
                                               m_max)
    _close(tlz, jlz, rtol=1e-12)
    tpp = tp._replace(p=torch.as_tensor(p_rows))
    tm = torch.as_tensor(m_rows)

    def jrows(fn):  # one compiled program per form, not one per primitive
        return jax.jit(jax.vmap(lambda p, m, lz: fn(jp._replace(p=p), m, lz)))(
            jnp.asarray(p_rows), jnp.asarray(m_rows), jlz)

    _close(tbat.throughput_padded(tlz, tm),
           jax.vmap(jbat.throughput_padded)(jlz, jnp.asarray(m_rows)))
    _close(tbat.expected_relative_delay_padded(tpp, tm, tlz, m_max),
           jrows(lambda q, m, lz: jbat.expected_relative_delay_padded(
               q, m, lz, m_max)), atol=1e-14)
    _close(tbat.wallclock_time_padded(tpp, tm, tc, tlz, m_max),
           jrows(lambda q, m, lz: jbat.wallclock_time_padded(
               q, m, jc, lz, m_max)))
    _close(tbat.energy_complexity_padded(tpp, tm, tc, tpw, tlz, m_max),
           jrows(lambda q, m, lz: jbat.energy_complexity_padded(
               q, m, jc, jpw, lz, m_max)))
    _close(tbat.joint_objective_padded(tpp, tm, tc, tpw, 0.4, 5.0, 3.0, tlz,
                                       m_max),
           jrows(lambda q, m, lz: jbat.joint_objective_padded(
               q, m, jc, jpw, 0.4, 5.0, 3.0, lz, m_max)))
    _close(tbat.second_moment_matrix_padded(tpp, tm, tlz, m_max),
           jrows(lambda q, m, lz: jbat.second_moment_matrix_padded(
               q, m, lz, m_max)), atol=1e-14)
    _close(tbat.delay_jacobian_padded(tpp, tm, tlz, m_max),
           jrows(lambda q, m, lz: jbat.delay_jacobian_padded(
               q, m, lz, m_max)), rtol=1e-9, atol=1e-12)
    # the objective factories and the surface helpers
    obj = tbat.make_time_objective_padded(tp, tc, m_max)
    _close(obj(torch.as_tensor(p_rows), tm, tlz),
           tbat.wallclock_time_padded(tpp, tm, tc, tlz, m_max), rtol=0)
    surf = tbat.objective_surface(obj, tp, p_rows, m_rows, m_max=m_max)
    _close(surf, obj(torch.as_tensor(p_rows), tm, tlz), rtol=0)


def test_tau_surface_matches_jax():
    jp, tp, _, _ = _setup(5, 4, False)
    jc, tc = jcx.LearningConstants(**CONSTS), tcx.LearningConstants(**CONSTS)
    p_rows = np.random.default_rng(6).dirichlet(np.ones(4), size=3)
    ms = np.array([2, 4, 7])
    _close(tbat.tau_surface(tp, tc, ms, p_rows),
           jbat.tau_surface(jp, jc, jnp.asarray(ms), jnp.asarray(p_rows)))
