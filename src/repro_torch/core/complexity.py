"""Round / wall-clock complexity of Generalized AsyncSGD (port of
``repro.core.complexity``).

Theorem 3 (``K_eps`` Eq. 9 and ``eta_max`` Eq. 8), Theorem 17 (the
bounded-gradient-free variant, Eq. 58) and Prop. 4/8 (``E0[tau_eps] =
K_eps / lambda``), with ``B = 6 (sigma^2 + 2 M^2)``, ``C = 6 (sigma^2 +
G^2)`` and ``Delta = f(w_0) - f*``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .buzen import NetworkParams, log_normalizing_constants
from .jackson import expected_relative_delay, throughput


class LearningConstants(NamedTuple):
    """Problem-dependent constants of Assumptions A1–A5 (Section 2.5)."""

    L: float = 1.0        # smoothness (A2)
    delta: float = 1.0    # f(w_0) - f^*  (A1)
    sigma: float = 1.0    # gradient noise std (A3)
    M: float = 0.0        # gradient dissimilarity (A4)
    G: float = 1.0        # gradient norm bound (A5)
    eps: float = 1.0      # target stationarity

    @property
    def B(self) -> float:
        return 6.0 * (self.sigma**2 + 2.0 * self.M**2)

    @property
    def C(self) -> float:
        return 6.0 * (self.sigma**2 + self.G**2)


def round_complexity(params: NetworkParams, m: int, consts: LearningConstants,
                     logZ=None) -> torch.Tensor:
    """``K_eps(p, m)`` — Theorem 3, Eq. (9)."""
    n = params.n
    p = params.p
    eps = consts.eps
    first = (4.0 + consts.B / eps) * torch.sum(1.0 / (n * p))
    if m > 1:  # the staleness term vanishes at m = 1 (serial SGD)
        delays = expected_relative_delay(params, m, logZ)
        staleness = torch.sum(delays / p**2)
        second = torch.sqrt(consts.C * (m - 1) / eps * staleness)
    else:
        second = 0.0
    return 24.0 * consts.L * consts.delta / (n * eps) * (first + second)


def eta_max(params: NetworkParams, m: int, consts: LearningConstants,
            logZ=None) -> torch.Tensor:
    """Maximal admissible learning rate — Theorem 3, Eq. (8)."""
    n = params.n
    p = params.p
    L, eps = consts.L, consts.eps
    inv_p_sum = torch.sum(1.0 / p)
    delays = expected_relative_delay(params, m, logZ)
    staleness = torch.clamp_min(torch.sum(delays / p**2), 1e-300)
    t1 = n**2 / (8.0 * L * inv_p_sum)
    t2 = n**2 * eps / (2.0 * L * consts.B * inv_p_sum)
    t3 = n * math.sqrt(eps) / (2.0 * L) / torch.sqrt(
        torch.clamp_min(consts.C * max(m - 1, 0) * staleness, 1e-300))
    return torch.minimum(t1, torch.minimum(t2, t3))


def system_staleness_factor(params: NetworkParams, m: int) -> torch.Tensor:
    """``S_sys`` of Theorem 17 (Eq. 58)."""
    mu_u_tot = torch.sum(params.mu_u)
    per = (1.0 / params.mu_d + 1.0 / params.mu_u + m / params.mu_c) / params.p**2
    return (m - 1) * mu_u_tot * torch.sum(per)


def round_complexity_unbounded(params: NetworkParams, m: int,
                               consts: LearningConstants,
                               logZ=None) -> torch.Tensor:
    """Theorem 17 — ``K_eps`` without the bounded-gradient assumption A5."""
    n = params.n
    p = params.p
    eps = consts.eps
    first = (2.0 + consts.B / eps) * torch.sum(1.0 / (n * p))
    if m > 1:
        delays = expected_relative_delay(params, m, logZ)
        s_sys = system_staleness_factor(params, m)
        second = torch.sqrt(torch.clamp_min((m - 1) * s_sys, 0.0))
        third = torch.sqrt(consts.B * (m - 1) / (2.0 * eps)
                           * torch.sum(delays / p**2))
    else:
        second = third = 0.0
    return 96.0 * consts.L * consts.delta / (n * eps) * (first + second + third)


def wallclock_time(params: NetworkParams, m: int, consts: LearningConstants,
                   logZ=None) -> torch.Tensor:
    """``E0[tau_eps] = K_eps(p, m) / lambda(p, m)`` — Prop. 4 / Prop. 8."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    return (round_complexity(params, m, consts, logZ)
            / throughput(params, m, logZ))
