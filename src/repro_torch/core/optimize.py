"""Gradient-based optimization of routing and concurrency (port of
``repro.core.optimize``).

The routing vector lives on the simplex via ``p = softmax(theta)``
(Appendix B.2) and objectives are minimized with Adam; gradients come from
``torch.autograd`` through the log-space Buzen pipeline.

  * :func:`optimize_routing` — one concurrency ``m``, a static objective
    ``obj(p, m)``;
  * :func:`batched_concurrency_sweep` — every candidate ``m`` at once: the
    ``B = len(m_grid)`` softmax logits are stacked, each Adam step evaluates
    the batched Buzen DP once for the whole ``[B, n]`` routing batch
    (``"torch"`` or ``"kernel"`` backend) and the summed loss decouples
    row-wise, so the step is exactly ``B`` independent Adam runs
    (``shard=True`` splits the rows over the local devices, bitwise);
  * :func:`pruned_concurrency_sweep` — coarse-to-fine over the batched
    sweep: a strided coarse pass, then a warm-started refinement between
    the coarse neighbours of its winner (about ``2 sqrt(B)`` rows);
  * :func:`pareto_sweep` — the Eq. 18 time-energy frontier over the whole
    ``rhos x m`` grid in one batched sweep;
  * :func:`sequential_concurrency_search` — the paper's warm-started loop
    of Section 5.3.2, one :func:`optimize_routing` per ``m`` on the static
    objectives (their Buzen DP takes the process-wide backend,
    :func:`repro_torch.core.buzen.set_backend`);
  * :func:`time_optimal` and :func:`joint_optimal` (``search="batched" |
    "pruned" | "sequential"``), :func:`round_optimal`,
    :func:`max_throughput`;
  * :func:`time_optimal_classes` — the same sweeps over a class-aggregated
    population (:class:`ClassParams`), with logits on the class masses
    (``search="batched" | "pruned"``).
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


def _solve_rows(objective: Callable, params, theta0: torch.Tensor,
                m_rows: torch.Tensor, ctx_rows, *, m_pad: int, steps: int,
                lr: float, backend: Optional[str]):
    """Adam on the logit rows ``theta0 [B, n]`` of one sweep, then the
    final evaluation: ``(p [B, n], values [B])``, on ``params``' device.
    Every operation is row-local (the Buzen DP, the objective and Adam), so
    a subset of rows gives those rows' bits."""
    from .batched import (batch_class_log_normalizing_constants,
                          batch_log_normalizing_constants)

    is_classes = isinstance(params, ClassParams)
    if is_classes:
        cmask = params.count > 0
        cnt_safe = torch.where(cmask, params.count.to(DTYPE), 1.0)
    dp = (batch_class_log_normalizing_constants if is_classes
          else batch_log_normalizing_constants)

    def to_p(thetas):
        if is_classes:
            th = torch.where(cmask, thetas, -torch.inf)
            return torch.softmax(th, dim=-1) / cnt_safe
        return torch.softmax(thetas, dim=-1)

    def row_values(thetas):
        ps = to_p(thetas)
        logZ = dp(params, ps, m_pad, backend=backend)
        if ctx_rows is None:
            return ps, objective(ps, m_rows, logZ)
        return ps, objective(ps, m_rows, logZ, ctx_rows)

    theta, _ = _adam_minimize(lambda th: torch.sum(row_values(th)[1]),
                              theta0, steps, lr)
    with torch.no_grad():
        return row_values(theta)


def _sharded_rows(objective: Callable, params, theta0: torch.Tensor,
                  m_rows: torch.Tensor, ctx_rows, **kw):
    """:func:`_solve_rows` with the rows split into contiguous chunks over
    :func:`repro_torch.sim.sharded.lane_devices` of ``params``' device,
    one worker thread and stream a device; the chunks' results gathered in
    row order on that device.  Each device gets the network and the
    objective rebuilt on it (``objective.to(device)``); with one device
    nothing moves and no thread starts."""
    from ..sim.sharded import lane_devices, run_split
    from .numerics import map_tensors

    src = params.device
    devices = lane_devices(src)
    if len(devices) == 1:
        return _solve_rows(objective, params, theta0, m_rows, ctx_rows, **kw)
    if not callable(getattr(objective, "to", None)):
        raise TypeError(
            "batched_concurrency_sweep(shard=True) over several devices "
            "needs an objective with a .to(device) method, which rebuilds "
            "it on another device (every repro_torch.core.batched factory "
            "gives one)")

    def shard(a, b, dev):
        def part(t):
            return t[a:b].to(dev)

        out = _solve_rows(objective.to(dev),
                          map_tensors(lambda t: t.to(dev), params),
                          part(theta0), part(m_rows),
                          None if ctx_rows is None else part(ctx_rows), **kw)
        return map_tensors(lambda t: t.to(src), out)

    return run_split(shard, theta0.shape[0], devices, src)


def batched_concurrency_sweep(objective: Callable, params, *,
                              m_grid, ctx=None, steps: int = 400,
                              lr: float = 0.05,
                              p_init: Optional[torch.Tensor] = None,
                              m_max: Optional[int] = None,
                              backend: Optional[str] = None,
                              shard: bool = False) -> SweepResult:
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

    ``shard=True`` splits the ``B`` rows into contiguous chunks over the
    local CUDA devices (:func:`repro_torch.sim.sharded.lane_devices`), an
    Adam run on each, concurrently, with ``logZ`` padded to the whole
    grid's ``m_max``: bitwise the unsharded sweep.  Over more than one
    device the objective must have ``.to(device)`` (the
    :mod:`repro_torch.core.batched` factories' objectives do); on one
    device it is the unsharded sweep.
    """
    dev = params.device
    m_grid = torch.as_tensor(np.asarray(m_grid), dtype=torch.int64,
                             device=dev)
    B = int(m_grid.shape[0])
    is_classes = isinstance(params, ClassParams)
    if is_classes:
        n = params.C
        cnt = params.count.to(DTYPE)
        n_total = float(params.n_total)
    else:
        n = params.n
    # the padding comes from the whole grid, before any split: a shard
    # whose rows stop at a lower m pads as the whole sweep does
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

    solve = _sharded_rows if shard else _solve_rows
    ps, vals = solve(objective, params, theta0, m_grid, ctx, m_pad=m_pad,
                     steps=steps, lr=lr, backend=backend)

    m_np = m_grid.cpu().numpy()
    vals_np = vals.cpu().numpy()
    b = int(np.argmin(vals_np))
    best = OptResult(p=ps[b], m=int(m_np[b]), value=float(vals_np[b]),
                     history=[(int(m), float(v))
                              for m, v in zip(m_np, vals_np)])
    return SweepResult(p=ps, m_grid=m_np, values=vals_np, best=best)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pruned_concurrency_sweep(objective: Callable, params, *, m_grid,
                             ctx=None, coarse_stride: Optional[int] = None,
                             min_full: int = 8, **kw) -> SweepResult:
    """Coarse-to-fine batched sweep: a strided subsample of the ``m`` grid
    first, then only the grid points between the coarse neighbours of its
    winner, warm-started from the winner's routing.

    The stride is ``max(2, round(sqrt(B)))`` (or ``coarse_stride``), so the
    two passes evaluate about ``2 sqrt(B)`` rows instead of ``B``.  It
    assumes the optimized objective is unimodal in ``m`` up to the stride,
    the regime of the wall-clock and joint objectives (Figs. 2/8).  Grids
    of at most ``min_full`` points run the full sweep.  ``ctx`` is subset
    with the grid, which is treated as one monotone ``m`` axis (product
    grids such as :func:`pareto_sweep`'s want the full sweep).  ``**kw``
    goes to :func:`batched_concurrency_sweep` (``steps``, ``lr``,
    ``m_max``, ``backend``, ``shard``); ``m_max`` is pinned for both
    passes from the objective's, else the grid's last value.  ``p`` stays
    on the network's device.
    """
    m_np = np.asarray(_host(m_grid), dtype=np.int64)
    if m_np.ndim != 1 or m_np.size == 0:
        raise ValueError(f"m_grid must be a non-empty 1-D grid, got shape "
                         f"{m_np.shape}")
    if not (np.diff(m_np) > 0).all():
        raise ValueError("pruned search needs a strictly increasing m_grid")
    B = int(m_np.size)
    # the refine window's largest m is below the grid's: pin the padding
    # for both passes, or an objective built for the grid trips the
    # sweep's padding guard
    if kw.get("m_max") is None:
        kw["m_max"] = getattr(objective, "m_max", None) or int(m_np[-1])
    if B <= max(int(min_full), 1):
        return batched_concurrency_sweep(objective, params, m_grid=m_np,
                                         ctx=ctx, **kw)

    ctx_np = None if ctx is None else _host(ctx)
    stride = (max(2, int(round(np.sqrt(B)))) if coarse_stride is None
              else max(2, int(coarse_stride)))
    coarse = np.unique(np.append(np.arange(0, B, stride), B - 1))

    def sub(idx):
        return m_np[idx], None if ctx_np is None else ctx_np[idx]

    mg, cx = sub(coarse)
    first = batched_concurrency_sweep(objective, params, m_grid=mg, ctx=cx,
                                      **kw)
    k = int(np.argmin(first.values))
    lo = int(coarse[max(k - 1, 0)])
    hi = int(coarse[min(k + 1, len(coarse) - 1)])
    refine = np.setdiff1d(np.arange(lo, hi + 1), coarse)

    ms, vals, ps = [first.m_grid], [first.values], [first.p]
    if refine.size:
        mg2, cx2 = sub(refine)
        second = batched_concurrency_sweep(
            objective, params, m_grid=mg2, ctx=cx2,
            **{**kw, "p_init": first.p[k]})  # warm start from the winner
        ms.append(second.m_grid)
        vals.append(second.values)
        ps.append(second.p)

    m_all = np.concatenate(ms)
    order = np.argsort(m_all)
    m_all = m_all[order]
    v_all = np.concatenate(vals)[order]
    p_all = torch.cat(ps, dim=0)[torch.as_tensor(order,
                                                 device=first.p.device)]
    b = int(np.argmin(v_all))
    best = OptResult(p=p_all[b], m=int(m_all[b]), value=float(v_all[b]),
                     history=[(int(m), float(v))
                              for m, v in zip(m_all, v_all)])
    return SweepResult(p=p_all, m_grid=m_all, values=v_all, best=best)


def pareto_sweep(params: NetworkParams, consts, power, rhos, tau_star,
                 e_star, *, m_max: int, **kw
                 ) -> tuple[SweepResult, list[OptResult]]:
    """The Eq. 18 time-energy frontier in one batched sweep.

    Optimizes the joint objective over the ``rhos x (1..m_max)`` product
    grid (``rho`` as the row context) and argmins per rho.  Returns the
    raw :class:`SweepResult` (rows rho-major, ``np.tile(m_cands,
    len(rhos))``) and one :class:`OptResult` per rho whose ``history`` is
    that rho's ``(m, value)`` slice.  ``**kw`` goes to
    :func:`batched_concurrency_sweep` (``shard=True`` among them).
    """
    from .batched import make_joint_objective_padded

    m_cands = np.arange(1, m_max + 1)
    mm = np.tile(m_cands, len(rhos))
    rr = np.repeat(np.asarray(rhos, dtype=np.float64), len(m_cands))
    sweep = batched_concurrency_sweep(
        make_joint_objective_padded(params, consts, power, tau_star, e_star,
                                    m_max), params,
        m_grid=mm, ctx=rr, m_max=m_max, **kw)
    vals = sweep.values.reshape(len(rhos), len(m_cands))
    per_rho = []
    for r_i in range(len(rhos)):
        b = r_i * len(m_cands) + int(np.argmin(vals[r_i]))
        per_rho.append(OptResult(
            p=sweep.p[b], m=int(sweep.m_grid[b]),
            value=float(sweep.values[b]),
            history=[(int(m), float(v)) for m, v in zip(m_cands, vals[r_i])]))
    return sweep, per_rho


def sequential_concurrency_search(objective: Callable, n: int, *,
                                  m_start: int = 1, m_max: int = 256,
                                  steps: int = 400, lr: float = 0.05,
                                  patience: int = 2,
                                  p_init: Optional[torch.Tensor] = None,
                                  device=None) -> OptResult:
    """Sequential ``(m, p)`` optimization with warm starts (Section 5.3.2):
    one :func:`optimize_routing` per ``m = max(m_start, 1) ..  m_max``,
    each started from the previous ``m``'s routing, stopping after
    ``patience`` results in a row that do not improve on the best.  The
    best result's ``history`` is the ``(m, value)`` trace.  It runs on
    ``device``, else ``p_init``'s device, else the card."""
    if device is None:
        device = "cuda" if p_init is None else p_init.device
    best: Optional[OptResult] = None
    stale = 0
    p_warm = p_init
    trace = []
    for m in range(max(m_start, 1), m_max + 1):
        res = optimize_routing(objective, n, m, steps=steps, lr=lr,
                               p_init=p_warm, device=device)
        trace.append((m, res.value))
        p_warm = res.p
        if best is None or res.value < best.value:
            best = res
            stale = 0
        else:
            stale += 1
            if stale >= patience:
                break
    best.history = trace
    return best


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
    """``(p*_tau, m*_tau)``: jointly time-optimal routing and concurrency
    over ``m = 2..m_max``.

    ``search``: ``"batched"`` (one sweep over the whole grid, the
    default), ``"pruned"`` (the coarse-to-fine sweep) or ``"sequential"``
    (the paper's warm-started loop on the static objective, on
    ``params``' device unless ``device=`` says otherwise).
    """
    m_max = m_max or params.n + 32
    if search in ("batched", "pruned"):
        from .batched import make_time_objective_padded

        kw.pop("patience", None)  # full grid: no early stop to tune
        engine = (batched_concurrency_sweep if search == "batched"
                  else pruned_concurrency_sweep)
        res = engine(
            make_time_objective_padded(params, consts, m_max), params,
            m_grid=np.arange(2, m_max + 1), m_max=m_max, **kw)
        return res.best
    if search != "sequential":
        raise ValueError(f"unknown search mode: {search!r}; expected "
                         "'batched', 'pruned' or 'sequential'")
    kw.setdefault("device", params.device)
    return sequential_concurrency_search(
        make_time_objective(params, consts), params.n, m_start=2,
        m_max=m_max, **kw)


def time_optimal_classes(classes: ClassParams, consts: LearningConstants,
                         m_max: int, *, search: str = "batched",
                         **kw) -> OptResult:
    """Class-space :func:`time_optimal`: O(C) per Adam step instead of
    O(n), over ``m = 2..m_max`` (``search="batched"`` or ``"pruned"``).
    ``m_max`` is explicit (a concurrency budget; ``n + 32`` would be absurd
    at ``n = 10^6``).  Returns per-member routing ``p`` (length ``C``)
    with ``sum_c count_c p_c = 1``."""
    from .batched import make_time_objective_classes

    if search not in ("batched", "pruned"):
        raise ValueError(f"unknown search mode: {search!r}; expected "
                         "'batched' or 'pruned'")
    engine = (batched_concurrency_sweep if search == "batched"
              else pruned_concurrency_sweep)
    res = engine(
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
    ``rho`` over ``m = 1..m_max``; ``search`` as in :func:`time_optimal`
    (the batched and pruned sweeps carry ``rho`` as every row's
    context)."""
    m_max = m_max or params.n + 32
    if search in ("batched", "pruned"):
        from .batched import make_joint_objective_padded

        kw.pop("patience", None)
        engine = (batched_concurrency_sweep if search == "batched"
                  else pruned_concurrency_sweep)
        m_grid = np.arange(1, m_max + 1)
        res = engine(
            make_joint_objective_padded(params, consts, power, tau_star,
                                        e_star, m_max), params,
            m_grid=m_grid, ctx=np.full(m_grid.shape, rho), m_max=m_max,
            **kw)
        return res.best
    if search != "sequential":
        raise ValueError(f"unknown search mode: {search!r}; expected "
                         "'batched', 'pruned' or 'sequential'")
    kw.setdefault("device", params.device)
    return sequential_concurrency_search(
        make_joint_objective(params, consts, power, rho, tau_star, e_star),
        params.n, m_start=1, m_max=m_max, **kw)
