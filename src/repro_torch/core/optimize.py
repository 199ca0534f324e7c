"""Gradient-based optimization of routing and concurrency (port of
``repro.core.optimize``, per-client half).

The routing vector lives on the simplex via ``p = softmax(theta)``
(Appendix B.2) and objectives are minimized with Adam; gradients come from
``torch.autograd`` through the log-space Buzen pipeline.

  * :func:`optimize_routing` — one concurrency ``m``, a static objective
    ``obj(p, m)``;
  * :func:`batched_concurrency_sweep` — every candidate ``m`` at once: the
    ``B = len(m_grid)`` softmax logits are stacked, each Adam step evaluates
    the batched Buzen DP once for the whole ``[B, n]`` routing batch
    (``"torch"`` or ``"kernel"`` backend) and the summed loss decouples
    row-wise, so the step is exactly ``B`` independent Adam runs;
  * :func:`time_optimal` and :func:`joint_optimal` (``search="batched"``),
    :func:`round_optimal`, :func:`max_throughput`;
  * :func:`time_optimal_classes` — the same sweep over a class-aggregated
    population (:class:`ClassParams`), with logits on the class masses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .buzen import ClassParams, NetworkParams
from .complexity import LearningConstants, round_complexity, wallclock_time
from .energy import PowerProfile, energy_complexity, joint_objective
from .jackson import throughput
from .numerics import DTYPE


@dataclasses.dataclass
class OptResult:
    p: torch.Tensor
    m: int
    value: float
    history: list


@dataclasses.dataclass
class SweepResult:
    """Full ``(p, m)`` surface from one batched sweep: ``p[b]`` is the
    optimized routing for ``m_grid[b]`` and ``values[b]`` the objective
    there; ``best`` is the argmin row with the ``(m, value)`` trace."""

    p: torch.Tensor        # [B, n]
    m_grid: np.ndarray     # [B]
    values: np.ndarray     # [B]
    best: OptResult


def _adam_minimize(loss_fn: Callable, theta0: torch.Tensor, steps: int,
                   lr: float):
    """Plain Adam on unconstrained logits; returns ``(theta, values)``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    theta = theta0.detach().clone()
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    vals = []
    for t in range(steps):
        th = theta.detach().requires_grad_(True)
        val = loss_fn(th)
        (g,) = torch.autograd.grad(val, th)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mu_hat = mu / (1 - b1 ** (t + 1.0))
        nu_hat = nu / (1 - b2 ** (t + 1.0))
        theta = theta - lr * mu_hat / (torch.sqrt(nu_hat) + eps)
        vals.append(val.detach())
    return theta, (torch.stack(vals) if vals else torch.zeros(0))


def optimize_routing(objective: Callable, n: int, m: int, *,
                     steps: int = 400, lr: float = 0.05,
                     p_init: Optional[torch.Tensor] = None,
                     device="cuda") -> OptResult:
    """Minimize ``objective(p, m)`` over the simplex with softmax-Adam."""
    p0 = (torch.full((n,), 1.0 / n, dtype=DTYPE, device=device)
          if p_init is None else p_init)
    theta0 = torch.log(torch.clamp(p0, min=1e-12))

    def loss(theta):
        return objective(torch.softmax(theta, dim=-1), m)

    theta, vals = _adam_minimize(loss, theta0, steps, lr)
    with torch.no_grad():
        p = torch.softmax(theta, dim=-1)
        value = float(objective(p, m))
    return OptResult(p=p, m=m, value=value,
                     history=[float(v) for v in vals.cpu()])


def batched_concurrency_sweep(objective: Callable, params, *,
                              m_grid, ctx=None, steps: int = 400,
                              lr: float = 0.05,
                              p_init: Optional[torch.Tensor] = None,
                              m_max: Optional[int] = None,
                              backend: Optional[str] = None) -> SweepResult:
    """Optimize routing for every concurrency candidate in one batched
    Adam run.

    ``objective`` follows the batched protocol of
    :mod:`repro_torch.core.batched`: ``obj(p [B, n], m [B], logZ [B,
    m_max+1])`` (plus ``ctx [B]`` when given) returns one value per row.
    Rows never interact, so the summed loss is ``B`` independent problems.

    ``params`` may be a :class:`ClassParams`: rows are then per-member
    routing over classes and the O(C) class DP replaces the O(n) one.  The
    logits parameterise class masses ``q`` (a softmax, summing to 1),
    members share ``p = q / count``, and padded (count-0) classes are
    pinned to ``-inf`` logits, so they carry ``p = 0`` and a zero
    gradient.
    """
    from .batched import (batch_class_log_normalizing_constants,
                          batch_log_normalizing_constants)

    dev = params.device
    m_grid = torch.as_tensor(np.asarray(m_grid), dtype=torch.int64,
                             device=dev)
    B = int(m_grid.shape[0])
    is_classes = isinstance(params, ClassParams)
    if is_classes:
        n = params.C
        cmask = params.count > 0
        cnt = params.count.to(DTYPE)
        cnt_safe = torch.where(cmask, cnt, 1.0)
        n_total = float(params.n_total)
    else:
        n = params.n
    m_top = int(m_grid.max())
    m_pad = m_top if m_max is None else m_max
    if m_pad < m_top:
        raise ValueError(
            f"m_max={m_pad} must cover max(m_grid)={m_top}; the padded "
            "objective must be built with the same m_max")
    obj_pad = getattr(objective, "m_max", None)
    if obj_pad is not None and obj_pad != m_pad:
        raise ValueError(
            f"objective was built with m_max={obj_pad} but this sweep pads "
            f"logZ to m_max={m_pad}; the paddings must match")
    if ctx is not None:
        ctx = torch.as_tensor(ctx, dtype=DTYPE, device=dev)

    if p_init is not None:
        p0 = torch.as_tensor(p_init, dtype=DTYPE, device=dev)
    else:
        p0 = torch.full((n,), 1.0 / (n_total if is_classes else n),
                        dtype=DTYPE, device=dev)
    theta0 = torch.log(torch.clamp(cnt * p0 if is_classes else p0,
                                   min=1e-12))
    if theta0.dim() == 1:
        theta0 = theta0.expand(B, n)

    def to_p(thetas):
        if is_classes:
            th = torch.where(cmask, thetas, -torch.inf)
            return torch.softmax(th, dim=-1) / cnt_safe
        return torch.softmax(thetas, dim=-1)

    def row_values(thetas):
        ps = to_p(thetas)
        dp = (batch_class_log_normalizing_constants if is_classes
              else batch_log_normalizing_constants)
        logZ = dp(params, ps, m_pad, backend=backend)
        if ctx is None:
            return ps, objective(ps, m_grid, logZ)
        return ps, objective(ps, m_grid, logZ, ctx)

    theta, _ = _adam_minimize(lambda th: torch.sum(row_values(th)[1]),
                              theta0, steps, lr)
    with torch.no_grad():
        ps, vals = row_values(theta)

    m_np = m_grid.cpu().numpy()
    vals_np = vals.cpu().numpy()
    b = int(np.argmin(vals_np))
    best = OptResult(p=ps[b], m=int(m_np[b]), value=float(vals_np[b]),
                     history=[(int(m), float(v))
                              for m, v in zip(m_np, vals_np)])
    return SweepResult(p=ps, m_grid=m_np, values=vals_np, best=best)


# ---------------------------------------------------------------------------
# canned objectives / strategies of Section 5.3 (static-m protocol)
# ---------------------------------------------------------------------------

def _with_p(params: NetworkParams, p: torch.Tensor) -> NetworkParams:
    return params._replace(p=p)


def make_round_objective(params: NetworkParams, consts: LearningConstants):
    """Minimize K_eps — the 'Round-Optimized' strategy."""
    def obj(p, m):
        return round_complexity(_with_p(params, p), m, consts)
    return obj


def make_throughput_objective(params: NetworkParams):
    """Maximize lambda — the 'Max-Throughput' strategy (negated)."""
    def obj(p, m):
        return -throughput(_with_p(params, p), m)
    return obj


def make_time_objective(params: NetworkParams, consts: LearningConstants):
    """Minimize E0[tau_eps] — the paper's proposed strategy."""
    def obj(p, m):
        return wallclock_time(_with_p(params, p), m, consts)
    return obj


def make_energy_objective(params: NetworkParams, consts: LearningConstants,
                          power: PowerProfile):
    def obj(p, m):
        return energy_complexity(_with_p(params, p), m, consts, power)
    return obj


def make_joint_objective(params: NetworkParams, consts: LearningConstants,
                         power: PowerProfile, rho: float, tau_star: float,
                         e_star: float):
    """Eq. (18) normalized scalarization."""
    def obj(p, m):
        return joint_objective(_with_p(params, p), m, consts, power, rho,
                               tau_star, e_star)
    return obj


def time_optimal(params: NetworkParams, consts: LearningConstants,
                 m_max: Optional[int] = None, *, search: str = "batched",
                 **kw) -> OptResult:
    """``(p*_tau, m*_tau)``: jointly time-optimal routing and concurrency,
    by one batched sweep over ``m = 2..m_max`` (``search="batched"``; the
    pruned and sequential searches are not ported yet)."""
    from .batched import make_time_objective_padded

    if search != "batched":
        raise ValueError(f"unknown search mode: {search!r}; the port "
                         "implements 'batched'")
    m_max = m_max or params.n + 32
    res = batched_concurrency_sweep(
        make_time_objective_padded(params, consts, m_max), params,
        m_grid=np.arange(2, m_max + 1), m_max=m_max, **kw)
    return res.best


def time_optimal_classes(classes: ClassParams, consts: LearningConstants,
                         m_max: int, *, search: str = "batched",
                         **kw) -> OptResult:
    """Class-space :func:`time_optimal`: O(C) per Adam step instead of
    O(n), one batched sweep over ``m = 2..m_max``.  ``m_max`` is explicit
    (a concurrency budget; ``n + 32`` would be absurd at ``n = 10^6``).
    Returns per-member routing ``p`` (length ``C``) with ``sum_c count_c
    p_c = 1``.  ``search="pruned"`` is not ported yet."""
    from .batched import make_time_objective_classes

    if search != "batched":
        raise ValueError(f"unknown search mode: {search!r}; the port "
                         "implements 'batched'")
    res = batched_concurrency_sweep(
        make_time_objective_classes(classes, consts, m_max), classes,
        m_grid=np.arange(2, m_max + 1), m_max=m_max, **kw)
    return res.best


def round_optimal(params: NetworkParams, consts: LearningConstants, m: int,
                  **kw) -> OptResult:
    return optimize_routing(make_round_objective(params, consts), params.n,
                            m, device=params.device, **kw)


def max_throughput(params: NetworkParams, m: int, **kw) -> OptResult:
    return optimize_routing(make_throughput_objective(params), params.n, m,
                            device=params.device, **kw)


def joint_optimal(params: NetworkParams, consts: LearningConstants,
                  power: PowerProfile, rho: float, tau_star: float,
                  e_star: float, m_max: Optional[int] = None, *,
                  search: str = "batched", **kw) -> OptResult:
    """``(p*_rho, m*_rho)``: the Eq. 18 scalarization at Pareto weight
    ``rho``, by one batched sweep over ``m = 1..m_max`` with ``rho`` as
    every row's context (``search="batched"``; the pruned and sequential
    searches are not ported yet)."""
    from .batched import make_joint_objective_padded

    if search != "batched":
        raise ValueError(f"unknown search mode: {search!r}; the port "
                         "implements 'batched'")
    m_max = m_max or params.n + 32
    m_grid = np.arange(1, m_max + 1)
    res = batched_concurrency_sweep(
        make_joint_objective_padded(params, consts, power, tau_star, e_star,
                                    m_max), params,
        m_grid=m_grid, ctx=np.full(m_grid.shape, rho), m_max=m_max, **kw)
    return res.best
