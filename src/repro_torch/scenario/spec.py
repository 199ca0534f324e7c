"""The parts of the declarative Scenario spec that the main path touches
(port of ``repro.scenario.spec``): the cluster rows of the paper's Table 1,
the :class:`NetworkSpec` built from them (per client, or class-aggregated
through a :class:`ClassSpec`), the default learning constants and the
paper's step sizes.  JSON round-trips, hashing and ``ScenarioSuite`` are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.buzen import ClassParams, NetworkParams
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


def _vec(v, n: Optional[int], name: str,
         owner: str = "NetworkSpec") -> Optional[np.ndarray]:
    if v is None:
        return None
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim != 1:
        raise ValueError(f"{owner}.{name} must be 1-D, got {arr.shape}")
    if n is not None and arr.shape[0] != n:
        raise ValueError(f"{owner}.{name} has length {arr.shape[0]}, "
                         f"expected {n}")
    if not (arr > 0).all():
        raise ValueError(f"{owner}.{name} must be positive")
    return arr


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=DTYPE,
                           device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class ClassSpec:
    """Client classes with integer multiplicities — the O(C) population
    axis.  ``count[c]`` identical clients of one ``(p, mu_c, mu_d, mu_u)``
    profile form a class (:class:`repro_torch.core.buzen.ClassParams`),
    so the population ``n_total = sum(count)`` is a free variable.  ``p``
    is the per-member routing mass (``None``: uniform ``1 / n_total``).
    Counts are at least 1: padding with count-0 classes happens on
    ``ClassParams`` (``pad_classes``), not in the spec."""

    mu_c: np.ndarray
    mu_d: np.ndarray
    mu_u: np.ndarray
    count: np.ndarray
    p: Optional[np.ndarray] = None
    labels: Optional[tuple] = None    # per-class cluster labels

    def __post_init__(self):
        C = len(np.asarray(self.mu_c))
        for name in ("mu_c", "mu_d", "mu_u", "p"):
            object.__setattr__(self, name, _vec(getattr(self, name), C, name,
                                                "ClassSpec"))
        arr = np.asarray(self.count)
        if arr.ndim != 1:
            raise ValueError(f"ClassSpec.count must be 1-D, got shape "
                             f"{arr.shape}")
        if arr.shape[0] != C:
            raise ValueError(f"ClassSpec.count has length {arr.shape[0]}, "
                             f"expected {C}")
        if (not np.issubdtype(arr.dtype, np.integer)
                and not np.all(arr == np.round(arr))):
            raise ValueError("ClassSpec.count must be integers")
        arr = arr.astype(np.int64)
        if not (arr >= 1).all():
            raise ValueError("ClassSpec.count must be >= 1 (padding with "
                             "count-0 classes happens at the ClassParams "
                             "level, not in the spec)")
        object.__setattr__(self, "count", arr)
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
            if len(self.labels) != C:
                raise ValueError("labels/rates length mismatch")

    @classmethod
    def from_clusters(cls, clusters, scale: int = 1) -> "ClassSpec":
        """One class per cluster row, each count divided by ``scale`` (at
        least 1) — the aggregated form of :meth:`NetworkSpec.from_clusters`."""
        return cls(mu_c=[c.mu_c for c in clusters],
                   mu_d=[c.mu_d for c in clusters],
                   mu_u=[c.mu_u for c in clusters],
                   count=np.asarray([max(1, c.count // scale)
                                     for c in clusters], np.int64),
                   labels=tuple(c.name for c in clusters))

    @property
    def C(self) -> int:
        return len(self.count)

    @property
    def n_total(self) -> int:
        return int(self.count.sum())

    def class_params(self, p=None, mu_cs=None, *,
                     device="cuda") -> ClassParams:
        """Materialize :class:`ClassParams` on ``device`` (routing override
        ``p`` > spec base ``p`` > uniform ``1 / n_total``)."""
        if p is None:
            p = (self.p if self.p is not None
                 else np.full(self.C, 1.0 / self.n_total))
        cp = ClassParams(p=_tensor(p, device), mu_c=_tensor(self.mu_c, device),
                         mu_d=_tensor(self.mu_d, device),
                         mu_u=_tensor(self.mu_u, device),
                         count=torch.as_tensor(self.count, dtype=torch.int64,
                                               device=device))
        return cp if mu_cs is None else cp.with_cs(mu_cs)


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkSpec:
    """The closed queueing network: per-client rates, base routing, the
    service-time law and the optional CS-side buffer (Section 7).

    Two population forms, mutually exclusive: per-client arrays
    ``mu_c``/``mu_d``/``mu_u``/``p``, or ``classes=``, a
    :class:`ClassSpec` whose closed forms and event engine are O(#classes).
    """

    mu_c: Optional[np.ndarray] = None
    mu_d: Optional[np.ndarray] = None
    mu_u: Optional[np.ndarray] = None
    p: Optional[np.ndarray] = None    # base routing (None = uniform)
    mu_cs: Optional[float] = None     # CS buffer rate (None = no CS)
    law: str = "exponential"          # registered timing law
    labels: Optional[tuple] = None    # per-client cluster labels
    classes: Optional[ClassSpec] = None  # class-aggregated population

    def __post_init__(self):
        if self.classes is not None:
            if any(getattr(self, f) is not None
                   for f in ("mu_c", "mu_d", "mu_u", "p")):
                raise ValueError(
                    "NetworkSpec with classes= must not also carry "
                    "per-client rate/routing arrays — the ClassSpec is the "
                    "population")
        else:
            if self.mu_c is None:
                raise ValueError("NetworkSpec needs either per-client "
                                 "rates (mu_c/mu_d/mu_u) or classes=")
            n = len(np.asarray(self.mu_c))
            for name in ("mu_c", "mu_d", "mu_u", "p"):
                object.__setattr__(self, name,
                                   _vec(getattr(self, name), n, name))
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
                      law: str = "exponential",
                      aggregate: bool = False) -> "NetworkSpec":
        """Per-client network from cluster rows; ``aggregate=True`` builds
        the class-aggregated form (one class per cluster) instead."""
        if aggregate:
            return cls(classes=ClassSpec.from_clusters(clusters, scale),
                       mu_cs=mu_cs, law=law)
        labels, mu_c, mu_d, mu_u, _, _, _ = expand_clusters(clusters, scale)
        return cls(mu_c=mu_c, mu_d=mu_d, mu_u=mu_u, mu_cs=mu_cs, law=law,
                   labels=labels)

    @property
    def n(self) -> int:
        return (self.classes.n_total if self.classes is not None
                else len(self.mu_c))

    def params(self, p=None, *, device="cuda") -> NetworkParams:
        """Materialize :class:`NetworkParams` on ``device`` (routing
        override ``p`` > spec base ``p`` > uniform).  A class network is
        expanded (O(n), the oracle path), ``p`` per member over classes."""
        if self.classes is not None:
            return self.class_params(p, device=device).expand()
        if p is None:
            p = self.p if self.p is not None else np.full(self.n, 1.0 / self.n)
        params = NetworkParams(p=_tensor(p, device),
                               mu_c=_tensor(self.mu_c, device),
                               mu_d=_tensor(self.mu_d, device),
                               mu_u=_tensor(self.mu_u, device))
        if self.mu_cs is not None:
            params = params.with_cs(self.mu_cs)
        return params

    def class_params(self, p=None, *, device="cuda") -> ClassParams:
        """Materialize :class:`ClassParams` on ``device`` (class networks
        only; ``p`` is per-member routing over classes)."""
        if self.classes is None:
            raise ValueError("not a class network: construct NetworkSpec "
                             "with classes= for the O(C) forms")
        return self.classes.class_params(p, mu_cs=self.mu_cs, device=device)


@dataclasses.dataclass(frozen=True)
class LearningSpec:
    """Learning-side spec: the Assumption A1-A5 constants used by the
    paper's experiments."""

    consts: LearningConstants = LearningConstants(
        L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0, eps=1.0)
