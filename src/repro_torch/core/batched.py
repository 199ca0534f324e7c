"""Batched (padded, traced-``m``) closed forms (port of
``repro.core.batched``): per client, and per class on a
:class:`repro_torch.core.buzen.ClassParams` population.

Where the JAX package writes each quantity for one ``(p, m, logZ)`` row
and ``vmap``s it, the port writes the batch axis out: every function here
takes ``params.p`` as ``[B, n]`` (rates stay ``[n]``), ``m`` as an integer
``[B]`` tensor and ``logZ`` as ``[B, m_max + 1]``, and returns one value
per row.  Series run to the static bound ``m_max`` and are masked by each
row's population, so a whole ``(p, m)`` grid evaluates (and
differentiates) in one pass.

  * :func:`batch_log_normalizing_constants` — the ``[B, m_max+1]`` DP on
    the ``"torch"`` (float64) or ``"kernel"`` (CUDA, float32 forward,
    float64 backward) backend;
  * ``*_padded`` — throughput, delays, ``K_eps``, wall-clock and energy
    complexity, the joint objective, second moments, the delay Jacobian;
  * ``make_*_objective_padded`` — objectives ``obj(p, m, logZ) -> [B]``
    for :func:`repro_torch.core.optimize.batched_concurrency_sweep`;
  * :func:`objective_surface` / :func:`tau_surface` — dense grids;
  * ``*_classes`` and :func:`batch_class_log_normalizing_constants` — the
    same forms on class representatives (``p [B, C]``, ``count [C]``),
    O(C) per row, the class DP on ``"torch"`` or the class kernel on
    ``"kernel"``.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

from typing import Callable, Optional

import torch

from .buzen import (ClassParams, NetworkParams, class_log_normalizing_constants,
                    get_backend, log_normalizing_constants)
from .complexity import LearningConstants
from .energy import PowerProfile, energy_per_round, energy_per_round_classes
from .jackson import _log_geom_sum
from .numerics import DTYPE, NEG_INF, map_tensors, seqsum
from .optimize import _with_p  # shared routing-replace helper


# ---------------------------------------------------------------------------
# padded log-Z helpers
# ---------------------------------------------------------------------------

def batch_log_normalizing_constants(params: NetworkParams,
                                    p_batch: torch.Tensor, m_max: int, *,
                                    backend: Optional[str] = None
                                    ) -> torch.Tensor:
    """``log Z_{n, 0..m_max}`` for every routing row of ``p_batch [B, n]``.

    The rates are shared (``[n]``, scalar ``mu_cs``) or one network per row
    (``[B, n]``, ``mu_cs [B]``, as lane-stacked networks give them).
    ``"kernel"`` runs the batched CUDA Buzen kernel with the CS station
    appended as one more column; ``"torch"`` runs the float64 DP with the
    batch as a leading axis.  ``None`` defers to the process-wide flag.
    """
    backend = get_backend() if backend is None else backend
    if backend == "kernel":
        from ..kernels.buzen import buzen_log_Z_batched

        # the rates broadcast against the rows: [n] over every row, [B, n]
        # row by row
        log_rho = torch.log(p_batch) - torch.log(params.mu_c)
        gamma = p_batch * (1.0 / params.mu_d + 1.0 / params.mu_u)
        log_gamma_total = torch.log(seqsum(gamma, dim=-1))
        if params.mu_cs is not None:
            log_load_cs = (torch.log(seqsum(p_batch, dim=-1))
                           - torch.log(params.mu_cs))
            log_rho = torch.cat([log_rho, log_load_cs[:, None]], dim=-1)
        return buzen_log_Z_batched(log_rho, log_gamma_total, m_max)
    if backend != "torch":
        raise ValueError(f"unknown buzen backend: {backend}")
    return log_normalizing_constants(_with_p(params, p_batch), m_max,
                                     backend="torch")


def _lz(logZ: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``log Z[b, idx[b, ...]]`` with ``Z[idx < 0] = 0`` (-> NEG_INF);
    ``idx`` has the batch axis first."""
    B = logZ.shape[0]
    flat = idx.expand((B,) + idx.shape[1:]).reshape(B, -1)
    out = torch.gather(logZ, 1, flat.clamp_min(0))
    return torch.where(flat >= 0, out, NEG_INF).reshape(
        (B,) + idx.shape[1:])


def _padded_series_vs_Z(log_load: torch.Tensor, logZ: torch.Tensor,
                        pop: torch.Tensor, shift: int, m_max: int,
                        weights_log: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``log sum_{k=1}^{pop-shift+1} w_k load^k Z[pop-shift+1-k] / Z[pop]``
    per row, padded to ``m_max`` terms; ``log_load`` is ``[B, X]``, the
    result ``[B, X]``."""
    k = torch.arange(1, m_max + 1, device=logZ.device)
    idx = pop[:, None] - shift + 1 - k[None, :]                  # [B, K]
    zterm = _lz(logZ, idx) - _lz(logZ, pop)[:, None]             # [B, K]
    terms = log_load[:, :, None] * k + zterm[:, None, :]        # [B, X, K]
    if weights_log is not None:
        terms = terms + weights_log
    # contract: allow(raw-reduction): logsumexp over the k = 1..m_max convolution axis — static length, never client/class padded
    return torch.logsumexp(
        torch.where((idx >= 0)[:, None, :], terms, NEG_INF), dim=-1)


# ---------------------------------------------------------------------------
# padded closed forms (Thm 2 / Prop 4 / Thm 3 / Prop 5)
# ---------------------------------------------------------------------------

def mean_total_counts_padded(params: NetworkParams, logZ: torch.Tensor,
                             pop: torch.Tensor, m_max: int) -> torch.Tensor:
    """``E[sum_s X_i^s]`` per row and client at population ``pop [B]``."""
    comp = torch.exp(_padded_series_vs_Z(params.log_rho, logZ, pop, 1, m_max))
    is_part = params.gamma * torch.exp(
        _lz(logZ, pop - 1) - _lz(logZ, pop))[:, None]
    total = comp + is_part
    if params.mu_cs is not None:
        psum = seqsum(params.p)
        log_load_cs = torch.log(psum) - torch.log(params.mu_cs)
        cs_total = torch.exp(_padded_series_vs_Z(
            log_load_cs[:, None], logZ, pop, 1, m_max))[:, 0]
        total = total + params.p / psum[:, None] * cs_total[:, None]
    return total


def expected_relative_delay_padded(params: NetworkParams, m: torch.Tensor,
                                   logZ: torch.Tensor,
                                   m_max: int) -> torch.Tensor:
    """``E0[D_i]`` (Thm 2 Eq 3/5) per row for concurrencies ``m [B]``."""
    return mean_total_counts_padded(params, logZ, m - 1, m_max)


def throughput_padded(logZ: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``lambda(p, m) = Z_{n,m-1} / Z_{n,m}`` per row."""
    return torch.exp(_lz(logZ, m - 1) - _lz(logZ, m))


def round_complexity_padded(params: NetworkParams, m: torch.Tensor,
                            consts: LearningConstants, logZ: torch.Tensor,
                            m_max: int) -> torch.Tensor:
    """``K_eps(p, m)`` (Thm 3 Eq 9) per row.

    The staleness term vanishes at ``m = 1``; the double ``where`` keeps
    value and gradient finite there.  Under the padded-``n`` convention the
    per-client sums are masked to the real population and the divisions run
    on a pinned-safe ``p`` (padded entries replaced by 1), so padded rows
    are NaN-free in the value and in the gradient.
    """
    n = params.active_count
    if torch.is_tensor(n):
        n = n.to(DTYPE)  # an integer tensor times a float would be float32
    p = params.p
    mask = params.active_mask
    eps = consts.eps
    delays = expected_relative_delay_padded(params, m, logZ, m_max)
    if mask is not None:
        p_safe = torch.where(mask, p, 1.0)
        # n_active is a scalar, or [B] on lane-stacked networks
        inv_np = torch.where(mask, 1.0 / (n[..., None] * p_safe), 0.0)
        stale_terms = torch.where(mask, delays / p_safe**2, 0.0)
    else:
        inv_np = 1.0 / (n * p)
        stale_terms = delays / p**2
    first = (4.0 + consts.B / eps) * seqsum(inv_np)
    staleness = seqsum(stale_terms)
    mf = m.to(DTYPE)
    raw = consts.C * (mf - 1.0) / eps * staleness
    safe = torch.where(m > 1, raw, 1.0)
    second = torch.where(m > 1, torch.sqrt(safe), 0.0)
    return 24.0 * consts.L * consts.delta / (n * eps) * (first + second)


def wallclock_time_padded(params: NetworkParams, m: torch.Tensor,
                          consts: LearningConstants, logZ: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """``E0[tau_eps] = K_eps / lambda`` (Prop. 4/8) per row."""
    return (round_complexity_padded(params, m, consts, logZ, m_max)
            / throughput_padded(logZ, m))


def energy_complexity_padded(params: NetworkParams, m: torch.Tensor,
                             consts: LearningConstants, power: PowerProfile,
                             logZ: torch.Tensor, m_max: int) -> torch.Tensor:
    """``E0[E_eps]`` (Prop. 5/9) per row."""
    return (round_complexity_padded(params, m, consts, logZ, m_max)
            * energy_per_round(params, power))


def joint_objective_padded(params: NetworkParams, m: torch.Tensor,
                           consts: LearningConstants, power: PowerProfile,
                           rho, tau_star, e_star, logZ: torch.Tensor,
                           m_max: int) -> torch.Tensor:
    """Normalized rho-scalarization (Eq. 18); ``rho`` may be per row."""
    k_eps = round_complexity_padded(params, m, consts, logZ, m_max)
    tau = k_eps / throughput_padded(logZ, m)
    en = k_eps * energy_per_round(params, power)
    return rho * en / e_star + (1.0 - rho) * tau / tau_star


# ---------------------------------------------------------------------------
# padded second moments / delay Jacobian (Thm 2 Eq 6/4; Thm 7 Eq 24/22)
# ---------------------------------------------------------------------------

def second_moment_matrix_padded(params: NetworkParams, m: torch.Tensor,
                                logZ: torch.Tensor,
                                m_max: int) -> torch.Tensor:
    """``E[S_i S_j]`` at population ``m - 1`` per row: ``[B, n, n]``;
    padded rows/columns are exactly zero."""
    n = params.n
    dev = logZ.device
    log_rho = params.log_rho                                     # [B, n]
    gamma = params.gamma
    mask = params.active_mask
    lr_safe = log_rho if mask is None else torch.where(mask, log_rho, 0.0)
    pop = m - 1
    pop_c = pop.clamp_min(1)  # at pop <= 0 everything masks to zero

    wlog = torch.log(2.0 * torch.arange(1, m_max + 1, device=dev,
                                        dtype=DTYPE) - 1.0)
    alpha_diag = torch.exp(_padded_series_vs_Z(log_rho, logZ, pop_c, 1,
                                               m_max, weights_log=wlog))
    if m_max >= 2:
        s = torch.arange(2, m_max + 1, device=dev)               # [S]
        d = lr_safe[:, :, None] - lr_safe[:, None, :]            # [B, n, n]
        lgs = _log_geom_sum(d[:, None], (s - 1)[None, :, None, None])
        log_c = s[None, :, None, None] * lr_safe[:, None, None, :] + lgs
        zlog = (_lz(logZ, pop_c[:, None] - s[None, :])
                - _lz(logZ, pop_c)[:, None])[:, :, None, None]
        valid = (s[None, :] <= pop_c[:, None])[:, :, None, None]
        if mask is not None:
            valid = valid & (mask[:, None] & mask[None, :])
        # contract: allow(raw-reduction): logsumexp over the s = 2..m_max axis — static length, never client/class padded
        alpha_off = torch.exp(torch.logsumexp(
            torch.where(valid, log_c + zlog, NEG_INF), dim=1))
    else:
        alpha_off = torch.zeros(log_rho.shape + (n,), dtype=DTYPE,
                                device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    alpha = torch.where(eye, alpha_diag[:, :, None], alpha_off)

    beta2 = torch.exp(_padded_series_vs_Z(log_rho, logZ, pop_c, 2, m_max))
    z3 = torch.exp(_lz(logZ, pop_c - 2) - _lz(logZ, pop_c))[:, None, None]
    z2 = torch.exp(_lz(logZ, pop_c - 1) - _lz(logZ, pop_c))[:, None, None]
    psi = (gamma[:, :, None] * gamma[:, None, :] * z3
           + torch.diag_embed(gamma) * z2)
    second = (alpha + beta2[:, :, None] * gamma[:, None, :]
              + beta2[:, None, :] * gamma[:, :, None] + psi)
    if params.mu_cs is not None:
        second = second + _cs_second_moment_terms_padded(params, logZ,
                                                         pop_c, m_max)
    return torch.where((pop > 0)[:, None, None], second, 0.0)


def _cs_second_moment_terms_padded(params: NetworkParams, logZ: torch.Tensor,
                                   pop: torch.Tensor,
                                   m_max: int) -> torch.Tensor:
    """Padded Theorem 7 Eq (24) CS terms (``pop [B] >= 1``)."""
    dev = logZ.device
    p = params.p
    psum = seqsum(p)                                             # [B]
    gamma = params.gamma
    log_rho = params.log_rho
    log_load_cs = torch.log(psum) - torch.log(params.mu_cs)     # [B]

    beta_cs2 = torch.exp(_padded_series_vs_Z(log_load_cs[:, None], logZ,
                                             pop, 2, m_max))[:, 0]
    k = torch.arange(1, m_max + 1, device=dev)
    base = torch.where(
        k[None, :] <= pop[:, None],
        k * log_load_cs[:, None] + _lz(logZ, pop[:, None] - k[None, :])
        - _lz(logZ, pop)[:, None], NEG_INF)                     # [B, K]
    # contract: allow(raw-reduction): logsumexp over the k = 1..m_max axis — static length, never client/class padded
    s0 = torch.exp(torch.logsumexp(base, dim=-1))
    s1_terms = torch.where(
        k > 1, base + torch.log(torch.clamp_min(k.to(DTYPE) - 1.0, 1e-300)),
        NEG_INF)
    # contract: allow(raw-reduction): logsumexp over the k = 1..m_max axis — static length, never client/class padded
    s1 = torch.exp(torch.logsumexp(s1_terms, dim=-1))
    pi = p / psum[:, None]
    ps = psum[:, None, None]
    alpha_cs = ((pi[:, :, None] * pi[:, None, :]) * 2.0 * s1[:, None, None]
                * ps * ps)
    alpha_cs = alpha_cs + torch.diag_embed(pi * psum[:, None]) * s0[:, None,
                                                                     None]
    if m_max >= 2:
        kk = torch.arange(1, m_max, device=dev)
        ll = torch.arange(1, m_max, device=dev)
        lz_kl = _lz(logZ, pop[:, None, None] - kk[None, :, None]
                    - ll[None, None, :])                        # [B, K, L]
        grid = (kk[None, None, :, None] * log_load_cs[:, None, None, None]
                + ll[None, None, None, :] * log_rho[:, :, None, None]
                + lz_kl[:, None]
                - _lz(logZ, pop)[:, None, None, None])          # [B,n,K,L]
        valid = ((kk[:, None] + ll[None, :])[None]
                 <= pop[:, None, None])[:, None]
        grid = torch.where(valid, grid, NEG_INF)
        # contract: allow(raw-reduction): logsumexp over the (kk, ll) m-grid axes — static lengths, never client/class padded
        alpha_cs_i = torch.exp(torch.logsumexp(grid.flatten(2), dim=-1))
    else:
        alpha_cs_i = torch.zeros_like(p)
    return (alpha_cs
            + beta_cs2[:, None, None] * (pi[:, :, None] * gamma[:, None, :]
                                         + pi[:, None, :] * gamma[:, :, None])
            * ps
            + pi[:, :, None] * alpha_cs_i[:, None, :] * ps
            + pi[:, None, :] * alpha_cs_i[:, :, None] * ps)


def delay_jacobian_padded(params: NetworkParams, m: torch.Tensor,
                          logZ: torch.Tensor, m_max: int) -> torch.Tensor:
    """``J[b, i, j] = d E0[D_i] / d p_j`` per row (covariance identity);
    padded columns mask to zero instead of dividing by zero."""
    mean = mean_total_counts_padded(params, logZ, m - 1, m_max)
    second = second_moment_matrix_padded(params, m, logZ, m_max)
    cov = second - mean[:, :, None] * mean[:, None, :]
    mask = params.active_mask
    if mask is None:
        return cov / params.p[:, None, :]
    p_safe = torch.where(mask, params.p, 1.0)
    return torch.where(mask[None, :] & mask[:, None],
                       cov / p_safe[:, None, :], 0.0)


# ---------------------------------------------------------------------------
# class-space closed forms: O(#classes) per evaluation (ClassParams)
# ---------------------------------------------------------------------------
#
# Each form is the padded per-client formula evaluated on class
# representatives (one member stands for its ``count`` exchangeable
# peers), with population sums weighted by ``count`` and taken
# sequentially, so padded count-0 classes add exact zeros.  As above, the
# batch axis is written out: ``classes.p`` is ``[B, C]`` per-member
# routing (the rates and ``count`` stay ``[C]``), ``m [B]``, ``logZ [B,
# m_max + 1]`` from the class DP.  They agree with the ``*_padded`` forms
# on ``classes.expand()`` to float64 roundoff and are bitwise invariant to
# class padding.

def batch_class_log_normalizing_constants(classes: ClassParams,
                                          p_batch: torch.Tensor, m_max: int,
                                          *, backend: Optional[str] = None
                                          ) -> torch.Tensor:
    """``log Z_{n, 0..m_max}`` for every per-member routing row
    ``p_batch [B, C]``: the class kernel (CUDA, float32 forward, float64
    backward) with the CS station as one more count-1 column on
    ``"kernel"``, the float64 class DP on ``"torch"``."""
    backend = get_backend() if backend is None else backend
    rows = classes._replace(p=p_batch)
    if backend == "kernel":
        from ..kernels.buzen import buzen_classes_log_Z_batched

        log_rho = rows.log_rho
        counts = classes.count.expand(p_batch.shape)
        if classes.mu_cs is not None:
            log_load_cs = (torch.log(seqsum(rows.mass))
                           - torch.log(classes.mu_cs))
            log_rho = torch.cat([log_rho, log_load_cs[:, None]], dim=-1)
            counts = torch.cat([counts, torch.ones_like(counts[:, :1])],
                               dim=-1)
        return buzen_classes_log_Z_batched(log_rho, counts,
                                           rows.log_gamma_total, m_max)
    if backend != "torch":
        raise ValueError(f"unknown buzen backend: {backend}")
    return class_log_normalizing_constants(rows, m_max, backend="torch")


def mean_member_counts_classes(classes: ClassParams, logZ: torch.Tensor,
                               pop: torch.Tensor,
                               m_max: int) -> torch.Tensor:
    """``E[sum_s X_i^s]`` of one member of each class at population
    ``pop [B]``: ``[B, C]`` (all members of a class share it)."""
    comp = torch.exp(_padded_series_vs_Z(classes.log_rho, logZ, pop, 1,
                                         m_max))
    is_part = classes.gamma * torch.exp(
        _lz(logZ, pop - 1) - _lz(logZ, pop))[:, None]
    total = comp + is_part
    if classes.mu_cs is not None:
        msum = seqsum(classes.mass)
        log_load_cs = torch.log(msum) - torch.log(classes.mu_cs)
        cs_total = torch.exp(_padded_series_vs_Z(
            log_load_cs[:, None], logZ, pop, 1, m_max))[:, 0]
        total = total + classes.p / msum[:, None] * cs_total[:, None]
    return total


def expected_relative_delay_classes(classes: ClassParams, m: torch.Tensor,
                                    logZ: torch.Tensor,
                                    m_max: int) -> torch.Tensor:
    """``E0[D_i]`` (Thm 2 Eq 3/5) of one member of each class: ``[B, C]``."""
    return mean_member_counts_classes(classes, logZ, m - 1, m_max)


def round_complexity_classes(classes: ClassParams, m: torch.Tensor,
                             consts: LearningConstants, logZ: torch.Tensor,
                             m_max: int) -> torch.Tensor:
    """``K_eps(p, m)`` (Thm 3 Eq 9) with ``sum_i`` over clients as
    ``sum_c count_c (member value)``; padded classes add exact zeros
    through pinned-safe divisions (``p`` replaced by 1 where
    ``count = 0``), in the value and in the gradient."""
    cnt = classes.count.to(DTYPE)
    n = classes.n_total.to(DTYPE)
    mask = classes.count > 0
    eps = consts.eps
    delays = expected_relative_delay_classes(classes, m, logZ, m_max)
    p_safe = torch.where(mask, classes.p, 1.0)
    # n [...] per lane (or a scalar) against the [..., C] class axis
    inv_np = torch.where(mask, cnt / (n[..., None] * p_safe), 0.0)
    stale_terms = torch.where(mask, cnt * delays / p_safe**2, 0.0)
    first = (4.0 + consts.B / eps) * seqsum(inv_np)
    staleness = seqsum(stale_terms)
    mf = m.to(DTYPE)
    raw = consts.C * (mf - 1.0) / eps * staleness
    safe = torch.where(m > 1, raw, 1.0)
    second = torch.where(m > 1, torch.sqrt(safe), 0.0)
    return 24.0 * consts.L * consts.delta / (n * eps) * (first + second)


def wallclock_time_classes(classes: ClassParams, m: torch.Tensor,
                           consts: LearningConstants, logZ: torch.Tensor,
                           m_max: int) -> torch.Tensor:
    """``E0[tau_eps] = K_eps / lambda`` (Prop. 4/8), class-space."""
    return (round_complexity_classes(classes, m, consts, logZ, m_max)
            / throughput_padded(logZ, m))


def energy_complexity_classes(classes: ClassParams, m: torch.Tensor,
                              consts: LearningConstants,
                              power: PowerProfile, logZ: torch.Tensor,
                              m_max: int) -> torch.Tensor:
    """``E0[E_eps]`` (Prop. 5/9), class-space (``power`` per class)."""
    return (round_complexity_classes(classes, m, consts, logZ, m_max)
            * energy_per_round_classes(classes, power))


def joint_objective_classes(classes: ClassParams, m: torch.Tensor,
                            consts: LearningConstants, power: PowerProfile,
                            rho, tau_star, e_star, logZ: torch.Tensor,
                            m_max: int) -> torch.Tensor:
    """Normalized rho-scalarization (Eq. 18), class-space."""
    k_eps = round_complexity_classes(classes, m, consts, logZ, m_max)
    tau = k_eps / throughput_padded(logZ, m)
    en = k_eps * energy_per_round_classes(classes, power)
    return rho * en / e_star + (1.0 - rho) * tau / tau_star


def second_moment_classes(classes: ClassParams, m: torch.Tensor,
                          logZ: torch.Tensor, m_max: int):
    """Member-representative second moments ``(cross [B, C, C], same [B,
    C])``: ``cross[b, a, c] = E[S_i S_j]`` for a member ``i`` of class
    ``a`` and a distinct member ``j`` of class ``c`` (on the diagonal, two
    distinct members of one class), ``same[b, c] = E[S_i^2]``; together
    the O(C^2) compression of the per-client ``[n, n]`` matrix
    (:func:`expand_class_matrix` unrolls it)."""
    dev = logZ.device
    log_rho = classes.log_rho                                    # [B, C]
    gamma = classes.gamma
    mask = classes.count > 0
    lr_safe = torch.where(mask, log_rho, 0.0)
    pop = m - 1
    pop_c = pop.clamp_min(1)

    wlog = torch.log(2.0 * torch.arange(1, m_max + 1, device=dev,
                                        dtype=DTYPE) - 1.0)
    alpha_same = torch.exp(_padded_series_vs_Z(log_rho, logZ, pop_c, 1,
                                               m_max, weights_log=wlog))
    if m_max >= 2:
        s = torch.arange(2, m_max + 1, device=dev)               # [S]
        d = lr_safe[:, :, None] - lr_safe[:, None, :]            # [B, C, C]
        lgs = _log_geom_sum(d[:, None], (s - 1)[None, :, None, None])
        log_c = s[None, :, None, None] * lr_safe[:, None, None, :] + lgs
        zlog = (_lz(logZ, pop_c[:, None] - s[None, :])
                - _lz(logZ, pop_c)[:, None])[:, :, None, None]
        valid = ((s[None, :] <= pop_c[:, None])[:, :, None, None]
                 & (mask[:, None] & mask[None, :]))
        # contract: allow(raw-reduction): logsumexp over the s = 2..m_max axis — static length, never client/class padded
        alpha_cross = torch.exp(torch.logsumexp(
            torch.where(valid, log_c + zlog, NEG_INF), dim=1))
    else:
        alpha_cross = torch.zeros(log_rho.shape + (classes.C,), dtype=DTYPE,
                                  device=dev)

    beta2 = torch.exp(_padded_series_vs_Z(log_rho, logZ, pop_c, 2, m_max))
    z3 = torch.exp(_lz(logZ, pop_c - 2) - _lz(logZ, pop_c))
    z2 = torch.exp(_lz(logZ, pop_c - 1) - _lz(logZ, pop_c))
    cross = (alpha_cross + beta2[:, :, None] * gamma[:, None, :]
             + beta2[:, None, :] * gamma[:, :, None]
             + gamma[:, :, None] * gamma[:, None, :] * z3[:, None, None])
    same = (alpha_same + 2.0 * beta2 * gamma + gamma**2 * z3[:, None]
            + gamma * z2[:, None])
    if classes.mu_cs is not None:
        cross_cs, same_cs = _cs_second_moment_terms_classes(classes, logZ,
                                                            pop_c, m_max)
        cross = cross + cross_cs
        same = same + same_cs
    live = pop > 0
    return (torch.where(live[:, None, None], cross, 0.0),
            torch.where(live[:, None], same, 0.0))


def _cs_second_moment_terms_classes(classes: ClassParams, logZ: torch.Tensor,
                                    pop: torch.Tensor, m_max: int):
    """Theorem 7 Eq (24) CS terms on class representatives (``(cross,
    same)`` extras of :func:`second_moment_classes`; ``pop [B] >= 1``)."""
    dev = logZ.device
    p = classes.p
    psum = seqsum(classes.mass)                                  # [B]
    gamma = classes.gamma
    log_rho = classes.log_rho
    log_load_cs = torch.log(psum) - torch.log(classes.mu_cs)    # [B]

    beta_cs2 = torch.exp(_padded_series_vs_Z(log_load_cs[:, None], logZ,
                                             pop, 2, m_max))[:, 0]
    k = torch.arange(1, m_max + 1, device=dev)
    base = torch.where(
        k[None, :] <= pop[:, None],
        k * log_load_cs[:, None] + _lz(logZ, pop[:, None] - k[None, :])
        - _lz(logZ, pop)[:, None], NEG_INF)                     # [B, K]
    # contract: allow(raw-reduction): logsumexp over the k = 1..m_max axis — static length, never client/class padded
    s0 = torch.exp(torch.logsumexp(base, dim=-1))
    s1_terms = torch.where(
        k > 1, base + torch.log(torch.clamp_min(k.to(DTYPE) - 1.0, 1e-300)),
        NEG_INF)
    # contract: allow(raw-reduction): logsumexp over the k = 1..m_max axis — static length, never client/class padded
    s1 = torch.exp(torch.logsumexp(s1_terms, dim=-1))
    pi = p / psum[:, None]
    if m_max >= 2:
        kk = torch.arange(1, m_max, device=dev)
        ll = torch.arange(1, m_max, device=dev)
        lz_kl = _lz(logZ, pop[:, None, None] - kk[None, :, None]
                    - ll[None, None, :])                        # [B, K, L]
        grid = (kk[None, None, :, None] * log_load_cs[:, None, None, None]
                + ll[None, None, None, :] * log_rho[:, :, None, None]
                + lz_kl[:, None]
                - _lz(logZ, pop)[:, None, None, None])          # [B,C,K,L]
        valid = ((kk[:, None] + ll[None, :])[None]
                 <= pop[:, None, None])[:, None]
        grid = torch.where(valid, grid, NEG_INF)
        # contract: allow(raw-reduction): logsumexp over the (kk, ll) m-grid axes — static lengths, never client/class padded
        alpha_cs_i = torch.exp(torch.logsumexp(grid.flatten(2), dim=-1))
    else:
        alpha_cs_i = torch.zeros_like(p)

    ps = psum[:, None, None]
    pairs = pi[:, :, None] * pi[:, None, :] * 2.0 * s1[:, None, None] * ps * ps
    betas = beta_cs2[:, None, None] * (pi[:, :, None] * gamma[:, None, :]
                                       + pi[:, None, :] * gamma[:, :, None]) * ps
    alphas = (pi[:, :, None] * alpha_cs_i[:, None, :] * ps
              + pi[:, None, :] * alpha_cs_i[:, :, None] * ps)
    cross = pairs + betas + alphas
    p1 = psum[:, None]
    same = (pi**2 * 2.0 * s1[:, None] * p1 * p1 + pi * p1 * s0[:, None]
            + 2.0 * beta_cs2[:, None] * pi * gamma * p1
            + 2.0 * pi * alpha_cs_i * p1)
    return cross, same


def delay_jacobian_classes(classes: ClassParams, m: torch.Tensor,
                           logZ: torch.Tensor, m_max: int):
    """Class-compressed delay Jacobian ``(J_cross [B, C, C], J_same [B,
    C])`` (covariance identity, Thm 2 Eq 4 / Thm 7 Eq 22): ``J_cross[b, a,
    c] = d E0[D_i] / d p_j`` for a member ``i`` of class ``a`` and a
    distinct member ``j`` of class ``c``; ``J_same`` the own-mass
    sensitivity.  Padded columns mask to zero."""
    mean = mean_member_counts_classes(classes, logZ, m - 1, m_max)
    cross, same = second_moment_classes(classes, m, logZ, m_max)
    cov_cross = cross - mean[:, :, None] * mean[:, None, :]
    cov_same = same - mean**2
    mask = classes.count > 0
    p_safe = torch.where(mask, classes.p, 1.0)
    j_cross = torch.where(mask[:, None] & mask[None, :],
                          cov_cross / p_safe[:, None, :], 0.0)
    j_same = torch.where(mask, cov_same / p_safe, 0.0)
    return j_cross, j_same


def expand_class_matrix(cross: torch.Tensor, same: torch.Tensor,
                        count: torch.Tensor) -> torch.Tensor:
    """Unroll class-pair values to the per-client ``[..., n, n]`` matrix:
    the diagonal from ``same``, every off-diagonal entry (across and
    within classes) from ``cross`` (the oracle helper)."""
    idx = torch.repeat_interleave(
        torch.arange(count.shape[-1], device=count.device), count)
    mat = cross[..., idx[:, None], idx[None, :]].clone()
    diag = torch.arange(idx.shape[0], device=count.device)
    mat[..., diag, diag] = same[..., idx]
    return mat


def _objective(obj: Callable, factory: Callable, *args) -> Callable:
    """``obj`` as ``factory(*args)`` returns it: ``obj.m_max`` (the last
    argument, consumed by the sweep-side padding guard) and
    ``obj.to(device)``, the factory's objective on the arguments moved to
    ``device`` (what a sharded sweep runs on each device)."""
    obj.m_max = args[-1]
    obj.to = lambda device: factory(*map_tensors(
        lambda t: t.to(device), args))
    return obj


def make_time_objective_classes(classes: ClassParams,
                                consts: LearningConstants, m_max: int):
    """Class-space wall-clock objective ``obj(p [B, C], m [B], logZ)``."""
    def obj(p, m, logZ):
        return wallclock_time_classes(_with_p(classes, p), m, consts, logZ,
                                      m_max)
    return _objective(obj, make_time_objective_classes, classes, consts,
                      m_max)


def make_round_objective_classes(classes: ClassParams,
                                 consts: LearningConstants, m_max: int):
    """Class-space ``K_eps`` objective (the same protocol)."""
    def obj(p, m, logZ):
        return round_complexity_classes(_with_p(classes, p), m, consts, logZ,
                                        m_max)
    return _objective(obj, make_round_objective_classes, classes, consts,
                      m_max)


# ---------------------------------------------------------------------------
# padded objective factories (protocol: obj(p [B,n], m [B], logZ) -> [B])
# ---------------------------------------------------------------------------

def make_round_objective_padded(params: NetworkParams,
                                consts: LearningConstants, m_max: int):
    def obj(p, m, logZ):
        return round_complexity_padded(_with_p(params, p), m, consts, logZ,
                                       m_max)
    return _objective(obj, make_round_objective_padded, params, consts,
                      m_max)


def make_throughput_objective_padded(params: NetworkParams, m_max: int):
    def obj(p, m, logZ):
        return -throughput_padded(logZ, m)
    return _objective(obj, make_throughput_objective_padded, params, m_max)


def make_time_objective_padded(params: NetworkParams,
                               consts: LearningConstants, m_max: int):
    def obj(p, m, logZ):
        return wallclock_time_padded(_with_p(params, p), m, consts, logZ,
                                     m_max)
    return _objective(obj, make_time_objective_padded, params, consts,
                      m_max)


def make_energy_objective_padded(params: NetworkParams,
                                 consts: LearningConstants,
                                 power: PowerProfile, m_max: int):
    def obj(p, m, logZ):
        return energy_complexity_padded(_with_p(params, p), m, consts, power,
                                        logZ, m_max)
    return _objective(obj, make_energy_objective_padded, params, consts,
                      power, m_max)


def make_joint_objective_padded(params: NetworkParams,
                                consts: LearningConstants,
                                power: PowerProfile, tau_star, e_star,
                                m_max: int):
    """Joint objective with ``rho`` as the per-row context (``ctx=`` of the
    sweep), so one sweep traces the whole Pareto frontier."""
    def obj(p, m, logZ, rho):
        return joint_objective_padded(_with_p(params, p), m, consts, power,
                                      rho, tau_star, e_star, logZ, m_max)
    return _objective(obj, make_joint_objective_padded, params, consts,
                      power, tau_star, e_star, m_max)


# ---------------------------------------------------------------------------
# dense surface evaluation (Figure 2 / Figure 8 grids)
# ---------------------------------------------------------------------------

def objective_surface(objective: Callable, params: NetworkParams,
                      p_grid: torch.Tensor, m_grid: torch.Tensor, *,
                      m_max: Optional[int] = None,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Evaluate a padded objective on aligned grids ``p_grid [B, n]`` and
    ``m_grid [B]`` in one batched pass."""
    m_grid = torch.as_tensor(m_grid, device=params.device)
    m_max = int(m_grid.max()) if m_max is None else m_max
    obj_pad = getattr(objective, "m_max", None)
    if obj_pad is not None and obj_pad != m_max:
        raise ValueError(
            f"objective was built with m_max={obj_pad} but the surface pads "
            f"logZ to m_max={m_max}; the paddings must match")
    p_grid = torch.as_tensor(p_grid, dtype=DTYPE, device=params.device)
    logZ = batch_log_normalizing_constants(params, p_grid, m_max,
                                           backend=backend)
    return objective(p_grid, m_grid, logZ)


def tau_surface(params: NetworkParams, consts: LearningConstants, ms,
                p_rows: torch.Tensor, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """``E0[tau_eps]`` on the outer grid ``ms x p_rows``: ``[len(ms), P]``."""
    ms = torch.as_tensor(ms, device=params.device)
    p_rows = torch.as_tensor(p_rows, dtype=DTYPE, device=params.device)
    M, P = ms.shape[0], p_rows.shape[0]
    m_top = int(ms.max())
    obj = make_time_objective_padded(params, consts, m_top)
    vals = objective_surface(obj, params, p_rows.repeat(M, 1),
                             ms.repeat_interleave(P), m_max=m_top,
                             backend=backend)
    return vals.reshape(M, P)
