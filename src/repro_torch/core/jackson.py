"""Closed-form stationary analysis of the Generalized AsyncSGD network (port
of ``repro.core.jackson``).

In log space: Theorem 2 (mean relative delays, second moments, the routing
Jacobian), Proposition 4 (throughput and its gradient) and their Section 7
CS-buffer variants, selected when ``params.mu_cs`` is set.  ``m`` is a
Python int and ``params.p`` a single ``[n]`` routing row; the batched,
traced-``m`` forms live in :mod:`repro_torch.core.batched`.  Everything is
differentiable with ``torch.autograd``.

Conventions: ``Z[k] = 0`` for ``k < 0``; the embedded chain lives at
population ``m - 1`` (Prop. 1), hence most ratios are against ``Z_{n,m-1}``.
"""
from __future__ import annotations

import torch

from .buzen import NetworkParams, log_normalizing_constants
from .numerics import DTYPE, NEG_INF


def _arange(lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(lo, hi, device=like.device)


def _lz(logZ: torch.Tensor, idx) -> torch.Tensor:
    """``log Z[idx]`` with ``Z[idx < 0] = 0`` (log -> NEG_INF); ``logZ`` is
    one ``[m+1]`` row, ``idx`` any integer tensor."""
    idx = torch.as_tensor(idx, device=logZ.device)
    return torch.where(idx >= 0, logZ[idx.clamp_min(0)], NEG_INF)


def _log_geom_sum(d: torch.Tensor, K) -> torch.Tensor:
    """``log sum_{k=1}^{K} exp(k d)`` for integer ``K >= 0`` (K=0 -> -inf);
    stable for any sign of ``d``, ``log K`` at ``|d| ~ 0``."""
    K = torch.as_tensor(K, device=d.device).to(DTYPE)
    small = torch.abs(d) < 1e-12
    d_safe = torch.where(small, 1.0, d)  # avoid 0/0 in the untaken branch

    def log1mexp(a):  # log(1 - e^{-a}) for a > 0
        a = torch.clamp_min(a, 1e-300)
        return torch.where(a < 0.693, torch.log(-torch.expm1(-a)),
                           torch.log1p(-torch.exp(-a)))

    neg = (d_safe + log1mexp(K * torch.abs(d_safe))
           - log1mexp(torch.abs(d_safe)))
    pos = (K * d_safe + log1mexp(K * torch.abs(d_safe))
           - log1mexp(torch.abs(d_safe)))
    out = torch.where(d_safe > 0, pos, neg)
    out = torch.where(small, torch.log(torch.clamp_min(K, 1e-300)), out)
    return torch.where(K >= 1, out, NEG_INF)


def _series_vs_Z(log_load, logZ: torch.Tensor, pop: int, shift: int,
                 weights_log=None) -> torch.Tensor:
    """``log sum_{k=1}^{pop-shift+1} w_k load^k Z[pop-shift+1-k] / Z[pop]``
    elementwise over ``log_load`` (``[n]`` or scalar)."""
    log_load = torch.as_tensor(log_load, device=logZ.device)
    top = pop - shift + 1
    if top < 1:
        return torch.full(log_load.shape, NEG_INF, dtype=DTYPE,
                          device=logZ.device)
    k = _arange(1, top + 1, logZ)
    zterm = _lz(logZ, pop - shift + 1 - k) - logZ[pop]
    terms = log_load[..., None] * k + zterm
    if weights_log is not None:
        terms = terms + weights_log[:top]
    return torch.logsumexp(terms, dim=-1)


# ---------------------------------------------------------------------------
# mean station counts & relative delay (Thm 2 Eq 3/5; Thm 7 Eq 21/23)
# ---------------------------------------------------------------------------

def mean_total_counts(params: NetworkParams, logZ: torch.Tensor,
                      pop: int) -> torch.Tensor:
    """``E[sum_s X_i^s]`` per client at population ``pop``."""
    if pop <= 0:
        return torch.zeros(params.n, dtype=DTYPE, device=params.device)
    comp = torch.exp(_series_vs_Z(params.log_rho, logZ, pop, shift=1))
    is_part = params.gamma * torch.exp(_lz(logZ, pop - 1) - logZ[pop])
    total = comp + is_part
    if params.mu_cs is not None:
        log_load_cs = torch.log(torch.sum(params.p)) - torch.log(params.mu_cs)
        cs_total = torch.exp(_series_vs_Z(log_load_cs, logZ, pop, shift=1))
        total = total + params.p / torch.sum(params.p) * cs_total
    return total


def expected_relative_delay(params: NetworkParams, m: int,
                            logZ=None) -> torch.Tensor:
    """``E0[D_i]`` for each client (Thm 2 Eq 3/5; Thm 7 Eq 21/23)."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    return mean_total_counts(params, logZ, m - 1)


# ---------------------------------------------------------------------------
# second moments (Thm 2 Eq 6; Thm 7 Eq 24)
# ---------------------------------------------------------------------------

def second_moment_matrix(params: NetworkParams, m: int,
                         logZ=None) -> torch.Tensor:
    """``E[S_i S_j]`` with ``S_i = sum_s X_i^s`` at population ``m - 1``."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    n = params.n
    log_rho = params.log_rho
    gamma = params.gamma
    pop = m - 1
    if pop <= 0:
        return torch.zeros((n, n), dtype=DTYPE, device=params.device)

    # alpha (queue-queue); i == j: sum_k (2k-1) rho_i^k Z[pop-k]/Z[pop]
    wlog = torch.log(2.0 * _arange(1, pop + 1, logZ).to(DTYPE) - 1.0)
    alpha_diag = torch.exp(_series_vs_Z(log_rho, logZ, pop, shift=1,
                                        weights_log=wlog))
    # i != j: sum_{s=2}^{pop} Z[pop-s]/Z[pop] * exp(s lr_j) geom(lr_i-lr_j, s-1)
    s = _arange(2, pop + 1, logZ)
    if s.numel() > 0:
        d = log_rho[:, None] - log_rho[None, :]
        lgs = _log_geom_sum(d[None], (s - 1)[:, None, None])  # [S, n, n]
        log_c = s[:, None, None] * log_rho[None, None, :] + lgs
        zlog = (_lz(logZ, pop - s) - logZ[pop])[:, None, None]
        alpha_off = torch.exp(torch.logsumexp(log_c + zlog, dim=0))
    else:
        alpha_off = torch.zeros((n, n), dtype=DTYPE, device=params.device)
    eye = torch.eye(n, dtype=torch.bool, device=params.device)
    alpha = torch.where(eye, alpha_diag[:, None]
                        * torch.eye(n, dtype=DTYPE, device=params.device),
                        alpha_off)

    beta2 = torch.exp(_series_vs_Z(log_rho, logZ, pop, shift=2))
    z3 = torch.exp(_lz(logZ, pop - 2) - logZ[pop])  # Z[m-3]/Z[m-1]
    z2 = torch.exp(_lz(logZ, pop - 1) - logZ[pop])  # Z[m-2]/Z[m-1]
    psi = gamma[:, None] * gamma[None, :] * z3 + torch.diag(gamma) * z2

    second = (alpha + beta2[:, None] * gamma[None, :]
              + beta2[None, :] * gamma[:, None] + psi)
    if params.mu_cs is not None:
        second = second + _cs_second_moment_terms(params, logZ, pop)
    return second


def _cs_second_moment_terms(params: NetworkParams, logZ: torch.Tensor,
                            pop: int) -> torch.Tensor:
    """The CS-specific terms of Theorem 7 Eq (24) at population ``pop``."""
    n = params.n
    p = params.p
    psum = torch.sum(p)
    gamma = params.gamma
    log_rho = params.log_rho
    log_load_cs = torch.log(psum) - torch.log(params.mu_cs)

    beta_cs2 = torch.exp(_series_vs_Z(log_load_cs, logZ, pop, shift=2))
    k = _arange(1, pop + 1, logZ)
    base = k * log_load_cs + _lz(logZ, pop - k) - logZ[pop]
    s0 = torch.exp(torch.logsumexp(base, dim=0))
    s1_terms = torch.where(
        k > 1, base + torch.log(torch.clamp_min(k.to(DTYPE) - 1.0, 1e-300)),
        NEG_INF)
    s1 = torch.exp(torch.logsumexp(s1_terms, dim=0))
    pi = p / psum
    alpha_cs = (pi[:, None] * pi[None, :]) * 2.0 * s1 * psum * psum
    alpha_cs = alpha_cs + torch.diag(pi * psum) * s0

    if pop >= 2:
        kk = _arange(1, pop, logZ)
        ll = _arange(1, pop, logZ)
        grid = (kk[:, None] * log_load_cs
                + ll[None, :] * log_rho[:, None, None]
                + _lz(logZ, pop - kk[:, None] - ll[None, :]) - logZ[pop])
        valid = (kk[:, None] + ll[None, :]) <= pop
        grid = torch.where(valid[None, :, :], grid, NEG_INF)
        alpha_cs_i = torch.exp(torch.logsumexp(grid.flatten(1), dim=1))
    else:
        alpha_cs_i = torch.zeros(n, dtype=DTYPE, device=params.device)

    return (alpha_cs
            + beta_cs2 * (pi[:, None] * gamma[None, :]
                          + pi[None, :] * gamma[:, None]) * psum
            + pi[:, None] * alpha_cs_i[None, :] * psum
            + pi[None, :] * alpha_cs_i[:, None] * psum)


# ---------------------------------------------------------------------------
# routing Jacobian of the delay (Thm 2 Eq 4; Thm 7 Eq 22)
# ---------------------------------------------------------------------------

def delay_jacobian(params: NetworkParams, m: int, logZ=None) -> torch.Tensor:
    """``J[i, j] = d E0[D_i] / d p_j`` via the covariance identity."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    mean = mean_total_counts(params, logZ, m - 1)
    second = second_moment_matrix(params, m, logZ)
    cov = second - mean[:, None] * mean[None, :]
    return cov / params.p[None, :]


# ---------------------------------------------------------------------------
# throughput (Prop 4 Eq 11/12; Prop 8 Eq 26/27)
# ---------------------------------------------------------------------------

def throughput(params: NetworkParams, m: int, logZ=None) -> torch.Tensor:
    """``lambda(p, m) = Z_{n,m-1} / Z_{n,m}`` — updates per unit time."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    return torch.exp(logZ[m - 1] - logZ[m])


def throughput_grad(params: NetworkParams, m: int, logZ=None) -> torch.Tensor:
    """``d lambda / d p_j = lambda/p_j (E[S_j]_{m-1} - E[S_j]_m)``."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    lam = throughput(params, m, logZ)
    mean_embedded = mean_total_counts(params, logZ, m - 1)
    mean_stationary = mean_total_counts(params, logZ, m)
    return lam / params.p * (mean_embedded - mean_stationary)


def analyze(params: NetworkParams, m: int) -> dict:
    """One-shot stationary analysis at concurrency ``m``."""
    logZ = log_normalizing_constants(params, m)
    delays = expected_relative_delay(params, m, logZ)
    return {
        "logZ": logZ,
        "delays": delays,
        "total_delay": torch.sum(delays),  # == m - 1 (Eq 7)
        "throughput": throughput(params, m, logZ),
        "delay_jacobian": delay_jacobian(params, m, logZ),
        "throughput_grad": throughput_grad(params, m, logZ),
    }
