"""Energy complexity of Generalized AsyncSGD (port of ``repro.core.energy``:
the per-client forms and the class-space energy per round).

The phase-dependent power model (Eq. 13/14) with cubic DVFS computation
power, Prop. 5/9 (``E0[E_eps] = K_eps * energy per round``), the
closed-form energy-optimal routing (Eq. 16/28), the minimal energy (Eq.
17/29) and the rho-scalarized joint objective (Eq. 18).  Client-axis sums
that sit on the padded-``n`` contract are sequential (``seqsum``).
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

from typing import NamedTuple, Optional

import torch

from .buzen import NetworkParams, log_normalizing_constants
from .complexity import LearningConstants, round_complexity, wallclock_time
from .numerics import seqsum


class PowerProfile(NamedTuple):
    """Per-client phase powers (Section 6.1); for a class network the
    leaves are per-class ``[C]`` arrays (members share their class's
    ratings)."""

    P_c: torch.Tensor  # [n] computation power
    P_u: torch.Tensor  # [n] uplink transmission power
    P_d: torch.Tensor  # [n] downlink reception power
    P_cs: Optional[torch.Tensor] = None  # scalar CS processing power

    @staticmethod
    def from_dvfs(kappa, mu_c, P_u, P_d, P_cs=None) -> "PowerProfile":
        """Cubic DVFS law: ``P_comp = kappa * mu_c**3`` (Section 6.5.1)."""
        return PowerProfile(P_c=kappa * mu_c**3, P_u=P_u, P_d=P_d, P_cs=P_cs)


def per_task_energy(params: NetworkParams, power: PowerProfile) -> torch.Tensor:
    """``E_i = P_c/mu_c + P_u/mu_u + P_d/mu_d`` — mean energy per task."""
    return (power.P_c / params.mu_c + power.P_u / params.mu_u
            + power.P_d / params.mu_d)


def energy_per_round(params: NetworkParams, power: PowerProfile) -> torch.Tensor:
    """``E[P(0)] / lambda`` — mean energy per round (Prop. 5 / Prop. 9);
    ``params.p`` may carry leading batch axes."""
    p = params.p
    e = seqsum(p / seqsum(p)[..., None] * per_task_energy(params, power))
    if power.P_cs is not None:
        if params.mu_cs is None:
            raise ValueError("P_cs given but params.mu_cs is None")
        e = e + power.P_cs / params.mu_cs
    return e


def energy_per_round_classes(classes, power: PowerProfile) -> torch.Tensor:
    """Class-space :func:`energy_per_round` with ``power`` holding
    per-class arrays: ``sum_c count_c p_c E_c / sum_c count_c p_c``, the
    class masses weighting the per-member task energies; padded classes
    add exact zeros to both sequential sums."""
    mass = classes.mass
    e = seqsum(mass / seqsum(mass)[..., None]
               * per_task_energy(classes, power))
    if power.P_cs is not None:
        if classes.mu_cs is None:
            raise ValueError("P_cs given but classes.mu_cs is None")
        e = e + power.P_cs / classes.mu_cs
    return e


def energy_complexity(params: NetworkParams, m: int, consts: LearningConstants,
                      power: PowerProfile, logZ=None) -> torch.Tensor:
    """``E0[E_eps] = K_eps(p, m) * energy_per_round`` — Prop. 5 / Prop. 9."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    return (round_complexity(params, m, consts, logZ)
            * energy_per_round(params, power))


def energy_optimal_routing(params: NetworkParams,
                           power: PowerProfile) -> torch.Tensor:
    """Closed-form minimizer at ``m = 1`` (Eq. 16 / Eq. 28)."""
    e = per_task_energy(params, power)
    if power.P_cs is not None:
        if params.mu_cs is None:
            raise ValueError("P_cs given but params.mu_cs is None")
        e = e + power.P_cs / params.mu_cs
    w = 1.0 / torch.sqrt(e)
    return w / seqsum(w)


def minimal_energy(params: NetworkParams, consts: LearningConstants,
                   power: PowerProfile) -> torch.Tensor:
    """``E*`` — Eq. (17) / Eq. (29): energy at ``(p*_E, m = 1)``."""
    n = params.n
    e = per_task_energy(params, power)
    if power.P_cs is not None:
        e = e + power.P_cs / params.mu_cs
    pref = 24.0 * consts.L * consts.delta / (n**2 * consts.eps)
    return pref * (4.0 + consts.B / consts.eps) * seqsum(torch.sqrt(e)) ** 2


def joint_objective(params: NetworkParams, m: int, consts: LearningConstants,
                    power: PowerProfile, rho: float, tau_star, e_star,
                    logZ=None) -> torch.Tensor:
    """Normalized rho-scalarization (Eq. 18)."""
    if logZ is None:
        logZ = log_normalizing_constants(params, m)
    tau = wallclock_time(params, m, consts, logZ)
    en = energy_complexity(params, m, consts, power, logZ)
    return rho * en / e_star + (1.0 - rho) * tau / tau_star
