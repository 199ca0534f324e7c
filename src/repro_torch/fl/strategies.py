"""Cluster tables to networks, and strategy lanes for the trainer (port of
``repro.fl.strategies``).

``build_network_params`` is ``NetworkSpec.from_clusters(...).params()``;
:func:`strategy_batch` flattens a ``{name: (p, m)}`` strategy mapping into
lane arrays for :class:`repro_torch.fl.engine.DeviceTrainer`.
``make_strategies`` and ``build_power_profile`` need the strategy
registry's entries and ``EnergySpec``, which wait for the port's Scenario
API.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.buzen import NetworkParams
from ..scenario.spec import (DEFAULT_ETA, MAX_THROUGHPUT_ETA,  # noqa: F401
                             PAPER_CLUSTERS_TABLE1, ClusterSpec, NetworkSpec,
                             expand_clusters)


def build_network_params(clusters: list[ClusterSpec], scale: int = 1,
                         mu_cs: Optional[float] = None, *,
                         device="cuda") -> NetworkParams:
    """``NetworkSpec.from_clusters(...).params()`` on ``device``."""
    return NetworkSpec.from_clusters(clusters, scale,
                                     mu_cs=mu_cs).params(device=device)


def cluster_labels(clusters: list[ClusterSpec], scale: int = 1) -> list[str]:
    return list(expand_clusters(clusters, scale)[0])


def default_etas(strategies) -> dict:
    """Per-strategy step sizes for a ``{name: (p, m)}`` mapping."""
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
