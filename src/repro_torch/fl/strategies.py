"""Cluster tables to networks and power profiles, the strategy factory,
and strategy lanes for the trainer (port of ``repro.fl.strategies``).

The declarative home of all of it is ``repro_torch.scenario``:
``build_network_params`` is ``NetworkSpec.from_clusters(...).params()``,
``build_power_profile`` is ``EnergySpec.from_clusters(...).profile(...)``
and the six scheduling configurations (Sections 5.3/6.5) are entries of
the strategy registry (``repro_torch.scenario.suite``):

  - ``asyncsgd``        — uniform routing, m = n          [29, Alg. 2]
  - ``max_throughput``  — p*_lambda, m = n
  - ``round_opt``       — p*_K, m = n                     [31, 2]
  - ``time_opt``        — (p*_tau, m*_tau)                (proposed)
  - ``energy_opt``      — (p*_E, m = 1), closed form Eq. 16
  - ``joint``           — (p*_rho, m*_rho), Eq. 18

:func:`make_strategies` returns ``{name: (p, m)}`` through that registry;
:func:`strategy_batch` flattens such a mapping into lane arrays for
:class:`repro_torch.fl.engine.DeviceTrainer`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.buzen import NetworkParams
from ..core.complexity import LearningConstants
from ..core.energy import PowerProfile
from ..scenario.spec import (DEFAULT_ETA, MAX_THROUGHPUT_ETA,  # noqa: F401
                             PAPER_CLUSTERS_TABLE1, PAPER_CLUSTERS_TABLE6,
                             ClusterSpec, EnergySpec, NetworkSpec,
                             expand_clusters)


def build_network_params(clusters: list[ClusterSpec], scale: int = 1,
                         mu_cs: Optional[float] = None, *,
                         device="cuda") -> NetworkParams:
    """``NetworkSpec.from_clusters(...).params()`` on ``device``."""
    return NetworkSpec.from_clusters(clusters, scale,
                                     mu_cs=mu_cs).params(device=device)


def build_power_profile(clusters: list[ClusterSpec], scale: int = 1,
                        P_cs: Optional[float] = None, *,
                        device="cuda") -> PowerProfile:
    """``EnergySpec.from_clusters(...).profile(network)`` on ``device``."""
    return EnergySpec.from_clusters(clusters, scale, P_cs=P_cs).profile(
        NetworkSpec.from_clusters(clusters, scale), device=device)


def cluster_labels(clusters: list[ClusterSpec], scale: int = 1) -> list[str]:
    return list(expand_clusters(clusters, scale)[0])


def make_strategies(
    params: NetworkParams,
    consts: LearningConstants,
    power: Optional[PowerProfile] = None,
    *,
    rho: float = 0.1,
    m_max: Optional[int] = None,
    steps: int = 300,
    which: tuple = ("asyncsgd", "max_throughput", "round_opt", "time_opt"),
    search: str = "batched",
) -> dict[str, tuple[np.ndarray, int]]:
    """``{name: (p, m)}`` for the requested strategies, each resolved on
    ``params``'s device through the strategy registry with one shared
    cache, so ``joint`` reuses ``time_opt``'s tau*.  ``search`` is their
    concurrency search (``"batched"``, ``"pruned"`` or
    ``"sequential"``)."""
    from ..scenario.registry import STRATEGIES
    from ..scenario.suite import ResolveContext, default_m_max

    m_max = m_max or default_m_max(params.n)
    out: dict[str, tuple[np.ndarray, int]] = {}
    cache: dict = {}
    for name in which:
        ctx = ResolveContext(
            params=params, consts=consts, power=power, rho=rho, m=None,
            m_max=m_max, steps=steps, search=search, resolved=out,
            cache=cache)
        out[name] = STRATEGIES.get(name)(ctx)
    return out


def default_etas(strategies) -> dict:
    """Per-strategy step sizes for a ``make_strategies`` result."""
    return {name: MAX_THROUGHPUT_ETA if name == "max_throughput"
            else DEFAULT_ETA for name in strategies}


def strategy_batch(strategies: dict, etas=None
                   ) -> tuple[list, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a ``{name: (p, m)}`` mapping into lane arrays for the device
    trainer: returns ``(names, p_mat [S, n], m_vec [S], eta_vec [S])``.

    ``etas`` is an optional ``{name: step size}`` override (scalar allowed);
    defaults to :func:`default_etas`.
    """
    names = list(strategies)
    if etas is None:
        etas = {}
    elif not isinstance(etas, dict):
        etas = {name: float(etas) for name in names}
    defaults = default_etas(names)
    p_mat = np.stack([np.asarray(torch.as_tensor(strategies[k][0]).cpu(),
                                 np.float64) for k in names])
    m_vec = np.asarray([int(strategies[k][1]) for k in names])
    eta_vec = np.asarray([float(etas.get(k, defaults[k])) for k in names])
    return names, p_mat, m_vec, eta_vec
