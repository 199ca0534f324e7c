"""The strategy and objective registrations, and strategy resolution (port
of the registration half of ``repro.scenario.suite``).

The paper's six scheduling configurations resolve through ``STRATEGIES``
and its closed-form objectives through ``OBJECTIVES``; their
implementations live in ``repro_torch.core``.  :func:`resolve_strategy`
turns one :class:`repro_torch.scenario.spec.Scenario` into ``(p, m)``.
The Buzen backend of the sweeps is the process-wide one
(``repro_torch.core.buzen.set_backend``).  ``ScenarioSuite`` is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.batched import (make_energy_objective_padded,
                            make_joint_objective_padded,
                            make_round_objective_padded,
                            make_throughput_objective_padded,
                            make_time_objective_padded)
from ..core.buzen import NetworkParams
from ..core.complexity import LearningConstants, wallclock_time
from ..core.energy import (PowerProfile, energy_optimal_routing,
                           minimal_energy)
from ..core.numerics import DTYPE
from ..core.optimize import (joint_optimal, make_energy_objective,
                             make_joint_objective, make_round_objective,
                             make_throughput_objective, make_time_objective,
                             optimize_routing, time_optimal)
from .registry import STRATEGIES, OBJECTIVES, objective, strategy
from .spec import EXPLICIT, Scenario


# ---------------------------------------------------------------------------
# objective registry — named closed-form objectives (static + padded forms)
# ---------------------------------------------------------------------------

class ObjectiveDef(NamedTuple):
    """One optimizable/reportable closed form.

    ``static(params, consts, power, refs)`` returns the ``obj(p, m)``
    callable; ``padded(params, consts, power, refs, m_max)`` the batched
    ``obj(p, m, logZ[, rho])`` of ``repro_torch.core.batched``.  ``refs``
    carries the joint objective's normalizers (``tau_star``/``e_star``);
    ``uses_ctx`` marks objectives whose padded form takes the per-row
    sweep context (the Pareto weight ``rho``).
    """

    static: Callable
    padded: Callable
    needs_power: bool = False
    needs_refs: bool = False
    uses_ctx: bool = False


@objective("time")
def _obj_time() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_time_objective(prm, c),
        padded=lambda prm, c, pw, refs, mx:
            make_time_objective_padded(prm, c, mx))


@objective("round")
def _obj_round() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_round_objective(prm, c),
        padded=lambda prm, c, pw, refs, mx:
            make_round_objective_padded(prm, c, mx))


@objective("throughput")
def _obj_throughput() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_throughput_objective(prm),
        padded=lambda prm, c, pw, refs, mx:
            make_throughput_objective_padded(prm, mx))


@objective("energy")
def _obj_energy() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_energy_objective(prm, c, pw),
        padded=lambda prm, c, pw, refs, mx:
            make_energy_objective_padded(prm, c, pw, mx),
        needs_power=True)


@objective("joint")
def _obj_joint() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_joint_objective(
            prm, c, pw, refs["rho"], refs["tau_star"], refs["e_star"]),
        padded=lambda prm, c, pw, refs, mx: make_joint_objective_padded(
            prm, c, pw, refs["tau_star"], refs["e_star"], mx),
        needs_power=True, needs_refs=True, uses_ctx=True)


def get_objective(name: str) -> ObjectiveDef:
    return OBJECTIVES.get(name)()


# ---------------------------------------------------------------------------
# strategy registry — the paper's scheduling configurations (Section 5.3/6.5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResolveContext:
    """Inputs a strategy resolver sees (one scenario's worth)."""

    params: NetworkParams             # base network, on the resolve device
    consts: LearningConstants
    power: Optional[PowerProfile]
    rho: float                        # Pareto weight (objective spec)
    m: Optional[int]                  # forced concurrency (None = strategy's)
    m_max: int                        # concurrency search bound
    steps: int                        # Adam steps
    search: str                       # "batched" | "pruned" | "sequential"
    resolved: dict                    # earlier (p, m) results in this batch
    cache: dict                       # shared memo (tau_star / e_star)


def _as_pm(p, m) -> tuple[np.ndarray, int]:
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    return np.asarray(p, dtype=np.float64), int(m)


@strategy("asyncsgd")
def _strat_asyncsgd(ctx: ResolveContext):
    """Uniform routing, m = n (Alg. 2 of [29])."""
    n = ctx.params.n
    return _as_pm(np.full(n, 1.0 / n), ctx.m if ctx.m is not None else n)


@strategy("max_throughput")
def _strat_max_throughput(ctx: ResolveContext):
    """p*_lambda at m = n."""
    m = ctx.m if ctx.m is not None else ctx.params.n
    obj = get_objective("throughput").static(ctx.params, ctx.consts,
                                             ctx.power, None)
    res = optimize_routing(obj, ctx.params.n, m, steps=ctx.steps,
                           device=ctx.params.device)
    return _as_pm(res.p, m)


@strategy("round_opt")
def _strat_round_opt(ctx: ResolveContext):
    """p*_K at m = n ([31, 2])."""
    m = ctx.m if ctx.m is not None else ctx.params.n
    obj = get_objective("round").static(ctx.params, ctx.consts, ctx.power,
                                        None)
    res = optimize_routing(obj, ctx.params.n, m, steps=ctx.steps,
                           device=ctx.params.device)
    return _as_pm(res.p, m)


@strategy("time_opt")
def _strat_time_opt(ctx: ResolveContext):
    """(p*_tau, m*_tau) — the paper's proposed strategy."""
    if ctx.m is not None:
        obj = get_objective("time").static(ctx.params, ctx.consts, ctx.power,
                                           None)
        res = optimize_routing(obj, ctx.params.n, ctx.m, steps=ctx.steps,
                               device=ctx.params.device)
        return _as_pm(res.p, ctx.m)
    res = time_optimal(ctx.params, ctx.consts, m_max=ctx.m_max,
                       steps=ctx.steps, search=ctx.search)
    ctx.cache["tau_star"] = float(res.value)
    return _as_pm(res.p, res.m)


@strategy("energy_opt")
def _strat_energy_opt(ctx: ResolveContext):
    """Closed-form (p*_E, m = 1) — Eq. 16."""
    if ctx.power is None:
        raise ValueError("strategy 'energy_opt' needs a power profile "
                         "(EnergySpec)")
    return _as_pm(energy_optimal_routing(ctx.params, ctx.power),
                  ctx.m if ctx.m is not None else 1)


@strategy("joint")
def _strat_joint(ctx: ResolveContext):
    """(p*_rho, m*_rho) — the Eq. 18 scalarization at the scenario's rho;
    reuses ``tau_star`` from the cache or from a resolved ``time_opt``."""
    if ctx.power is None:
        raise ValueError("strategy 'joint' needs a power profile "
                         "(EnergySpec)")
    tau_star = ctx.cache.get("tau_star")
    if tau_star is None:
        if "time_opt" in ctx.resolved:
            p_tau, m_tau = ctx.resolved["time_opt"]
            p_tau = torch.as_tensor(p_tau, dtype=DTYPE,
                                    device=ctx.params.device)
            tau_star = float(wallclock_time(ctx.params._replace(p=p_tau),
                                            m_tau, ctx.consts))
        else:
            tau_star = time_optimal(ctx.params, ctx.consts, m_max=ctx.m_max,
                                    steps=ctx.steps,
                                    search=ctx.search).value
        ctx.cache["tau_star"] = tau_star
    e_star = ctx.cache.get("e_star")
    if e_star is None:
        e_star = ctx.cache["e_star"] = float(
            minimal_energy(ctx.params, ctx.consts, ctx.power))
    res = joint_optimal(ctx.params, ctx.consts, ctx.power, ctx.rho, tau_star,
                        e_star, m_max=ctx.m_max, steps=ctx.steps,
                        search=ctx.search)
    return _as_pm(res.p, res.m)


def default_m_max(n: int) -> int:
    """The historical ``make_strategies`` search bound."""
    return n + max(8, n // 4)


def _resolve_class_strategy(scenario: Scenario, cache: dict, device
                            ) -> tuple[np.ndarray, int]:
    """Class-space strategy resolution — O(#classes), never expands.

    Returns a PER-CLASS routing vector ``p`` of shape ``[C]`` (one
    member's probability for each class).  Supported: ``"asyncsgd"``
    (uniform per-member routing, ``m = n_total`` unless forced) and
    ``"time_opt"`` (the class-space sweep of ``time_optimal_classes``;
    needs an explicit ``StrategySpec.m_max``).  Other strategies raise:
    resolve them on the expanded per-client network.
    """
    from ..core.batched import make_time_objective_classes
    from ..core.optimize import (batched_concurrency_sweep,
                                 time_optimal_classes)

    spec = scenario.strategy
    n_total = int(scenario.n)
    C = scenario.network.classes.C
    if spec.name == "asyncsgd":
        m = spec.m if spec.m is not None else n_total
        return _as_pm(np.full(C, 1.0 / n_total), m)
    if spec.name == "time_opt":
        if spec.m_max is None:
            raise ValueError(
                "class-network 'time_opt' needs an explicit "
                "StrategySpec.m_max: the per-client default scales with the "
                f"population (n_total = {n_total} here)")
        if spec.m is not None and spec.m > spec.m_max:
            raise ValueError(f"forced m={spec.m} exceeds m_max={spec.m_max}")
        classes = scenario.class_params(device=device)
        if spec.m is not None:
            res = batched_concurrency_sweep(
                make_time_objective_classes(classes, scenario.consts,
                                            spec.m_max),
                classes, m_grid=[spec.m], m_max=spec.m_max,
                steps=spec.steps).best
        else:
            res = time_optimal_classes(classes, scenario.consts, spec.m_max,
                                       search=spec.search, steps=spec.steps)
        cache.setdefault("tau_star", float(res.value))
        return _as_pm(res.p, res.m)
    raise ValueError(
        f"strategy {scenario.strategy.name!r} has no class-space resolver; "
        "class networks support 'explicit', 'asyncsgd' and 'time_opt' "
        "(expand with NetworkSpec.from_clusters(..., aggregate=False) to "
        "use the per-client resolvers)")


def resolve_strategy(scenario: Scenario, *, resolved: Optional[dict] = None,
                     cache: Optional[dict] = None, device="cuda"
                     ) -> tuple[np.ndarray, int]:
    """One scenario's ``(p, m)``: the explicit spec or the registry's
    resolver, run on ``device``; ``p`` comes back as float64 numpy.

    Class-aggregated networks dispatch to the O(#classes) resolvers before
    any per-client array exists.
    """
    spec = scenario.strategy
    if spec.name == EXPLICIT:
        return _as_pm(spec.p, spec.m)
    if scenario.is_class_network:
        return _resolve_class_strategy(scenario,
                                       {} if cache is None else cache, device)
    n = scenario.n
    ctx = ResolveContext(
        params=scenario.params(device=device), consts=scenario.consts,
        power=scenario.power(device=device), rho=scenario.objective.rho,
        m=spec.m,
        m_max=spec.m_max if spec.m_max is not None else default_m_max(n),
        steps=spec.steps, search=spec.search,
        resolved={} if resolved is None else resolved,
        cache={} if cache is None else cache)
    return STRATEGIES.get(spec.name)(ctx)
