"""The parts of the declarative Scenario spec that the main path touches
(port of ``repro.scenario.spec``): the cluster rows of the paper's Table 1,
the per-client :class:`NetworkSpec` built from them, the default learning
constants and the paper's step sizes.  JSON round-trips, hashing, class
networks and ``ScenarioSuite`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.buzen import NetworkParams
from ..core.complexity import LearningConstants
from ..core.numerics import DTYPE
from .registry import TIMING_LAWS

# The paper's step sizes for the Table-3 comparison: max-throughput needs a
# reduced learning rate to stay stable (Section 5.3).
DEFAULT_ETA = 0.05
MAX_THROUGHPUT_ETA = 0.01

@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One client cluster row of Table 1 / Table 4."""

    name: str
    mu_c: float
    mu_u: float
    mu_d: float
    count: int
    kappa: float = 0.0   # DVFS energy coefficient (Table 4)
    P_u: float = 0.0
    P_d: float = 0.0


# Table 1 — the paper's main experimental population (n = 100).
PAPER_CLUSTERS_TABLE1 = [
    ClusterSpec("A", 10.0, 2.0, 2.5, 15, kappa=0.08, P_u=5.0, P_d=3.0),
    ClusterSpec("B", 0.3, 9.0, 10.0, 15, kappa=200.0, P_u=15.0, P_d=10.0),
    ClusterSpec("C", 5.0, 6.0, 7.0, 20, kappa=0.25, P_u=4.0, P_d=3.0),
    ClusterSpec("D", 0.15, 0.1, 0.12, 40, kappa=14400.0, P_u=0.5, P_d=0.2),
    ClusterSpec("E", 12.0, 10.0, 11.0, 10, kappa=1.50, P_u=50.0, P_d=40.0),
]


def expand_clusters(clusters, scale: int = 1):
    """Cluster rows -> per-client columns ``(labels, mu_c, mu_d, mu_u,
    kappa, P_u, P_d)`` with each count divided by ``scale`` (at least 1)."""
    cols = {k: [] for k in ("label", "mu_c", "mu_d", "mu_u",
                            "kappa", "P_u", "P_d")}
    for c in clusters:
        cnt = max(1, c.count // scale)
        cols["label"] += [c.name] * cnt
        for k in ("mu_c", "mu_d", "mu_u", "kappa", "P_u", "P_d"):
            cols[k] += [getattr(c, k)] * cnt
    return (tuple(cols["label"]),) + tuple(
        np.asarray(cols[k], dtype=np.float64)
        for k in ("mu_c", "mu_d", "mu_u", "kappa", "P_u", "P_d"))


def _vec(v, n: Optional[int], name: str) -> Optional[np.ndarray]:
    if v is None:
        return None
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim != 1:
        raise ValueError(f"NetworkSpec.{name} must be 1-D, got {arr.shape}")
    if n is not None and arr.shape[0] != n:
        raise ValueError(f"NetworkSpec.{name} has length {arr.shape[0]}, "
                         f"expected {n}")
    if not (arr > 0).all():
        raise ValueError(f"NetworkSpec.{name} must be positive")
    return arr


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkSpec:
    """The closed queueing network: per-client rates, base routing, the
    service-time law and the optional CS-side buffer (Section 7)."""

    mu_c: np.ndarray
    mu_d: np.ndarray
    mu_u: np.ndarray
    p: Optional[np.ndarray] = None    # base routing (None = uniform)
    mu_cs: Optional[float] = None     # CS buffer rate (None = no CS)
    law: str = "exponential"          # registered timing law
    labels: Optional[tuple] = None    # per-client cluster labels

    def __post_init__(self):
        n = len(np.asarray(self.mu_c))
        for name in ("mu_c", "mu_d", "mu_u", "p"):
            object.__setattr__(self, name, _vec(getattr(self, name), n, name))
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
            if len(self.labels) != n:
                raise ValueError("labels/rates length mismatch")
        if self.mu_cs is not None:
            if not float(self.mu_cs) > 0:
                raise ValueError(f"mu_cs must be positive, got {self.mu_cs}")
            object.__setattr__(self, "mu_cs", float(self.mu_cs))
        TIMING_LAWS.get(self.law)  # eager: unknown laws fail here

    @classmethod
    def from_clusters(cls, clusters, scale: int = 1, *,
                      mu_cs: Optional[float] = None,
                      law: str = "exponential") -> "NetworkSpec":
        labels, mu_c, mu_d, mu_u, _, _, _ = expand_clusters(clusters, scale)
        return cls(mu_c=mu_c, mu_d=mu_d, mu_u=mu_u, mu_cs=mu_cs, law=law,
                   labels=labels)

    @property
    def n(self) -> int:
        return len(self.mu_c)

    def params(self, p=None, *, device="cuda") -> NetworkParams:
        """Materialize :class:`NetworkParams` on ``device`` (routing
        override ``p`` > spec base ``p`` > uniform)."""
        if p is None:
            p = self.p if self.p is not None else np.full(self.n, 1.0 / self.n)

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                   dtype=DTYPE, device=device)

        params = NetworkParams(p=t(p), mu_c=t(self.mu_c), mu_d=t(self.mu_d),
                               mu_u=t(self.mu_u))
        if self.mu_cs is not None:
            params = params.with_cs(self.mu_cs)
        return params


@dataclasses.dataclass(frozen=True)
class LearningSpec:
    """Learning-side spec: the Assumption A1-A5 constants used by the
    paper's experiments."""

    consts: LearningConstants = LearningConstants(
        L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0, eps=1.0)
