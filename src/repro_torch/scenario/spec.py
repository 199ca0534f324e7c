"""The declarative Scenario spec (port of ``repro.scenario.spec``).

One :class:`Scenario` describes an experiment — a closed queueing network
with a timing law, the learning constants, an optional energy model, a
routing/concurrency strategy and an objective::

    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10)
    scn = Scenario(network=net, learning=LearningSpec(grad_clip=5.0),
                   strategy=StrategySpec("time_opt"))

``repro_torch.scenario.suite.resolve_strategy`` turns its strategy into
``(p, m)``; ``DeviceTrainer.from_scenario`` and
``AsyncFLTrainer.from_scenario`` build the trainers from it.

Data and meta fields.  Each sub-spec is a frozen dataclass whose *data*
fields hold the numbers (rates, routing, power coefficients, learning
constants) and whose *meta* fields the structure (law, strategy and
objective names, optimizer settings).  Specs hold numpy arrays and Python
scalars; only :meth:`Scenario.params`, :meth:`Scenario.class_params`,
:meth:`Scenario.power` and :meth:`EnergySpec.profile` build tensors, on
the ``device`` they are given.  :func:`stack` stacks the data fields of
structurally identical scenarios along a leading lane axis.

Serialization: ``to_dict`` / ``from_dict`` round-trip through plain JSON
types bitwise, key for key as the JAX package writes them, so the same
scenario gives the same :meth:`Scenario.to_json` string and the same
:meth:`Scenario.hash` in both packages.

Validation is eager: unknown timing laws, strategies, objectives,
backends or malformed shapes raise at construction, listing the
registered options.  The port registers the ``exponential``,
``deterministic``, ``lognormal`` and ``hyperexponential`` laws and the
``reference``, ``batched``, ``kernel`` and ``sharded`` sim backends (the
JAX package's ``pallas`` raises); it has no interpret mode, so
``SimSpec.interpret`` must be ``None``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np
import torch

from ..core.buzen import ClassParams, NetworkParams
from ..core.complexity import LearningConstants
from ..core.energy import PowerProfile
from ..core.numerics import DTYPE
from .registry import OBJECTIVES, PARTITIONS, STRATEGIES, TIMING_LAWS

# The paper's step sizes for the Table-3 comparison: max-throughput needs a
# reduced learning rate to stay stable (Section 5.3).
DEFAULT_ETA = 0.05
MAX_THROUGHPUT_ETA = 0.01

EXPLICIT = "explicit"  # StrategySpec.name for a hand-given (p, m)

# :func:`stack` rebuilds specs whose data fields carry a lane axis, where
# the 1-D checks of ``__post_init__`` must be suspended
_SKIP_VALIDATION = 0


@contextlib.contextmanager
def _no_validation():
    global _SKIP_VALIDATION
    _SKIP_VALIDATION += 1
    try:
        yield
    finally:
        _SKIP_VALIDATION -= 1


def _coerce_vec(obj, field: str, n: Optional[int] = None,
                positive: bool = False) -> Optional[int]:
    """Coerce a 1-D float64 vector field in place; returns its length (or
    ``n`` unchanged for an absent optional field)."""
    v = getattr(obj, field)
    if v is None:
        return n
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim != 1:
        raise ValueError(f"{type(obj).__name__}.{field} must be 1-D, "
                         f"got shape {arr.shape}")
    if n is not None and arr.shape[0] != n:
        raise ValueError(f"{type(obj).__name__}.{field} has length "
                         f"{arr.shape[0]}, expected {n}")
    if positive and not (arr > 0).all():
        raise ValueError(f"{type(obj).__name__}.{field} must be positive")
    object.__setattr__(obj, field, arr)
    return arr.shape[0]


def _spec(data_fields):
    """Mark a frozen dataclass's data fields (everything else is meta) and
    give it an array-aware structural ``__eq__`` (the classes set
    ``eq=False``; instances hash by identity)."""
    data_fields = tuple(data_fields)

    def deco(cls):
        def __eq__(self, other):
            if type(other) is not type(self):
                return NotImplemented
            for f in dataclasses.fields(self):
                a, b = getattr(self, f.name), getattr(other, f.name)
                if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                    if not (isinstance(a, np.ndarray)
                            and isinstance(b, np.ndarray)
                            and a.shape == b.shape and (a == b).all()):
                        return False
                elif a != b:
                    return False
            return True

        cls._data_fields = data_fields
        cls.__eq__ = __eq__
        cls.__hash__ = object.__hash__
        return cls

    return deco


def _dict_vec(v):
    return None if v is None else [float(x) for x in np.asarray(v)]


def _opt_float(v):
    return None if v is None else float(v)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=DTYPE,
                           device=device)


# ---------------------------------------------------------------------------
# cluster rows (Table 1 / Table 4 / Table 6)
# ---------------------------------------------------------------------------

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

# Table 6 — the round-complexity experiment population (Appendix H).
PAPER_CLUSTERS_TABLE6 = [
    ClusterSpec("A", 10.0, 2.0, 2.5, 15),
    ClusterSpec("B", 2.5, 8.0, 9.0, 35),
    ClusterSpec("C", 5.0, 5.0, 6.0, 30),
    ClusterSpec("D", 0.5, 0.8, 1.1, 15),
    ClusterSpec("E", 15.0, 10.0, 11.0, 5),
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


# ---------------------------------------------------------------------------
# sub-specs
# ---------------------------------------------------------------------------

@_spec(data_fields=("mu_c", "mu_d", "mu_u", "p", "count"))
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
    labels: Optional[tuple] = None    # per-class cluster labels (meta)

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        C = _coerce_vec(self, "mu_c", positive=True)
        C = _coerce_vec(self, "mu_d", C, positive=True)
        C = _coerce_vec(self, "mu_u", C, positive=True)
        _coerce_vec(self, "p", C, positive=True)
        if self.count is not None:
            arr = np.asarray(self.count)
            if arr.ndim != 1:
                raise ValueError(f"ClassSpec.count must be 1-D, got shape "
                                 f"{arr.shape}")
            if C is not None and arr.shape[0] != C:
                raise ValueError(f"ClassSpec.count has length "
                                 f"{arr.shape[0]}, expected {C}")
            if (not np.issubdtype(arr.dtype, np.integer)
                    and not np.all(arr == np.round(arr))):
                raise ValueError("ClassSpec.count must be integers")
            arr = arr.astype(np.int64)
            if not (arr >= 1).all():
                raise ValueError("ClassSpec.count must be >= 1 (padding "
                                 "with count-0 classes happens at the "
                                 "ClassParams level, not in the spec)")
            object.__setattr__(self, "count", arr)
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
            if C is not None and len(self.labels) != C:
                raise ValueError("labels/rates length mismatch")

    @classmethod
    def from_clusters(cls, clusters, scale: int = 1) -> "ClassSpec":
        """One class per cluster row, each count divided by ``scale`` (at
        least 1) — the aggregated form of :meth:`NetworkSpec.from_clusters`."""
        return cls(
            mu_c=np.asarray([c.mu_c for c in clusters], np.float64),
            mu_d=np.asarray([c.mu_d for c in clusters], np.float64),
            mu_u=np.asarray([c.mu_u for c in clusters], np.float64),
            count=np.asarray([max(1, c.count // scale) for c in clusters],
                             np.int64),
            labels=tuple(c.name for c in clusters))

    @property
    def C(self) -> int:
        return len(self.count)

    @property
    def n_total(self) -> int:
        return int(np.asarray(self.count).sum())

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

    def to_dict(self) -> dict:
        return {"mu_c": _dict_vec(self.mu_c), "mu_d": _dict_vec(self.mu_d),
                "mu_u": _dict_vec(self.mu_u),
                "count": [int(x) for x in np.asarray(self.count)],
                "p": _dict_vec(self.p),
                "labels": None if self.labels is None else list(self.labels)}

    @classmethod
    def from_dict(cls, d: dict) -> "ClassSpec":
        return cls(**{**d, "labels": None if d.get("labels") is None
                      else tuple(d["labels"])})


@_spec(data_fields=("mu_c", "mu_d", "mu_u", "p", "mu_cs", "classes"))
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
    law: str = "exponential"          # registered timing law (meta)
    labels: Optional[tuple] = None    # per-client cluster labels (meta)
    classes: Optional[ClassSpec] = None  # class-aggregated population

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
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
            n = _coerce_vec(self, "mu_c", positive=True)
            n = _coerce_vec(self, "mu_d", n, positive=True)
            n = _coerce_vec(self, "mu_u", n, positive=True)
            _coerce_vec(self, "p", n, positive=True)
            if self.labels is not None:
                object.__setattr__(self, "labels", tuple(self.labels))
                if n is not None and len(self.labels) != n:
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

    def to_dict(self) -> dict:
        d = {"mu_c": _dict_vec(self.mu_c), "mu_d": _dict_vec(self.mu_d),
             "mu_u": _dict_vec(self.mu_u), "p": _dict_vec(self.p),
             "mu_cs": _opt_float(self.mu_cs), "law": self.law,
             "labels": None if self.labels is None else list(self.labels)}
        # absent (not null) when unset, so a per-client network's JSON,
        # and every hash over it, is what it was before classes existed
        if self.classes is not None:
            d["classes"] = self.classes.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkSpec":
        return cls(**{**d, "labels": None if d.get("labels") is None
                      else tuple(d["labels"]),
                      "classes": None if d.get("classes") is None
                      else ClassSpec.from_dict(d["classes"])})


@_spec(data_fields=("consts",))
@dataclasses.dataclass(frozen=True, eq=False)
class LearningSpec:
    """Learning-side spec: Assumption A1-A5 constants, the step size
    (``None`` = the per-strategy Table-3 defaults), gradient clipping."""

    consts: LearningConstants = LearningConstants(
        L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0, eps=1.0)
    eta: Optional[float] = None       # None -> per-strategy default table
    grad_clip: Optional[float] = None

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        if not isinstance(self.consts, LearningConstants):
            object.__setattr__(self, "consts",
                               LearningConstants(*self.consts))

    def eta_for(self, strategy_name: str) -> float:
        """Resolved step size: an explicit ``eta`` wins, else the paper's
        per-strategy defaults (Section 5.3)."""
        if self.eta is not None:
            return float(self.eta)
        return (MAX_THROUGHPUT_ETA if strategy_name == "max_throughput"
                else DEFAULT_ETA)

    def to_dict(self) -> dict:
        c = self.consts
        return {"consts": {"L": float(c.L), "delta": float(c.delta),
                           "sigma": float(c.sigma), "M": float(c.M),
                           "G": float(c.G), "eps": float(c.eps)},
                "eta": _opt_float(self.eta),
                "grad_clip": _opt_float(self.grad_clip)}

    @classmethod
    def from_dict(cls, d: dict) -> "LearningSpec":
        return cls(consts=LearningConstants(**d["consts"]), eta=d.get("eta"),
                   grad_clip=d.get("grad_clip"))


@_spec(data_fields=("kappa", "P_u", "P_d", "P_cs"))
@dataclasses.dataclass(frozen=True, eq=False)
class EnergySpec:
    """Phase-dependent power profile (Table 4): cubic-DVFS computation
    power ``kappa * mu_c**3`` plus radio powers (Section 6.5.1)."""

    kappa: np.ndarray                # [n] DVFS coefficients
    P_u: np.ndarray                  # [n] uplink powers
    P_d: np.ndarray                  # [n] downlink powers
    P_cs: Optional[float] = None     # CS processing power (Section 7.5)

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        n = _coerce_vec(self, "kappa")
        n = _coerce_vec(self, "P_u", n)
        _coerce_vec(self, "P_d", n)
        if self.P_cs is not None:
            object.__setattr__(self, "P_cs", float(self.P_cs))

    @classmethod
    def from_clusters(cls, clusters, scale: int = 1, *,
                      P_cs: Optional[float] = None) -> "EnergySpec":
        _, _, _, _, kappa, P_u, P_d = expand_clusters(clusters, scale)
        return cls(kappa=kappa, P_u=P_u, P_d=P_d, P_cs=P_cs)

    def profile(self, network: NetworkSpec, *,
                device="cuda") -> PowerProfile:
        """The :class:`PowerProfile` on ``device``; for a class network
        the arrays are per class (``[C]``, one rating shared by the
        members of a class)."""
        mu_c = (network.classes.mu_c if network.classes is not None
                else network.mu_c)
        return PowerProfile.from_dvfs(
            _tensor(self.kappa, device), _tensor(mu_c, device),
            _tensor(self.P_u, device), _tensor(self.P_d, device),
            P_cs=None if self.P_cs is None else _tensor(self.P_cs, device))

    def to_dict(self) -> dict:
        return {"kappa": _dict_vec(self.kappa), "P_u": _dict_vec(self.P_u),
                "P_d": _dict_vec(self.P_d), "P_cs": _opt_float(self.P_cs)}

    @classmethod
    def from_dict(cls, d: dict) -> "EnergySpec":
        return cls(**d)


@_spec(data_fields=("p",))
@dataclasses.dataclass(frozen=True, eq=False)
class StrategySpec:
    """Routing/concurrency strategy: a registered name (resolved by the
    strategy registry, ``repro_torch.scenario.suite``) or ``"explicit"``
    with ``(p, m)``.  ``search`` is the concurrency search of the
    ``time_opt`` and ``joint`` resolvers: ``"batched"``, ``"pruned"`` or
    ``"sequential"`` (class networks: the first two), as in the JAX
    package."""

    name: str = "asyncsgd"
    p: Optional[np.ndarray] = None    # explicit routing (name="explicit")
    m: Optional[int] = None           # explicit / forced concurrency
    m_max: Optional[int] = None       # concurrency search bound
    steps: int = 300                  # Adam steps of the routing optimizer
    search: str = "batched"           # "batched" | "pruned" | "sequential"

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        _coerce_vec(self, "p", positive=True)
        if self.m is not None:
            object.__setattr__(self, "m", int(self.m))
        if self.m_max is not None:
            object.__setattr__(self, "m_max", int(self.m_max))
        if self.search not in ("batched", "pruned", "sequential"):
            raise ValueError(f"unknown search mode: {self.search!r}; "
                             "expected 'batched', 'pruned' or 'sequential'")
        if self.name == EXPLICIT:
            if self.p is None or self.m is None:
                raise ValueError(
                    "explicit strategy needs both p and m")
        else:
            # the registrations live in repro_torch.scenario.suite: load
            # them, then fail eagerly on unknown names
            from . import suite  # noqa: F401
            STRATEGIES.get(self.name)

    def to_dict(self) -> dict:
        return {"name": self.name, "p": _dict_vec(self.p), "m": self.m,
                "m_max": self.m_max, "steps": int(self.steps),
                "search": self.search}

    @classmethod
    def from_dict(cls, d: dict) -> "StrategySpec":
        return cls(**d)


@_spec(data_fields=())
@dataclasses.dataclass(frozen=True, eq=False)
class ObjectiveSpec:
    """What to optimize / report: a registered objective plus its Pareto
    weight ``rho`` (used by the ``"joint"`` objective/strategy, Eq. 18)."""

    name: str = "time"
    rho: float = 0.1

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        object.__setattr__(self, "rho", float(self.rho))
        from . import suite  # noqa: F401  (loads objective registrations)
        OBJECTIVES.get(self.name)

    def to_dict(self) -> dict:
        return {"name": self.name, "rho": float(self.rho)}

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectiveSpec":
        return cls(**d)


@_spec(data_fields=())
@dataclasses.dataclass(frozen=True, eq=False)
class TraceSpec:
    """Telemetry-channel selection, as data: ``events``/``updates`` are
    ring capacities (0 disables the channel) and ``tolerance`` the
    relative drift band between ring empirics and the closed forms.  The
    port has no rings yet; a trainer asked for one raises."""

    events: int = 0        # event-ring capacity (engine channel)
    updates: int = 0       # update-ring capacity (trainer channel)
    tolerance: float = 0.25

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        for f in ("events", "updates"):
            v = int(getattr(self, f))
            if v < 0:
                raise ValueError(f"TraceSpec.{f} must be >= 0, got {v}")
            object.__setattr__(self, f, v)
        tol = float(self.tolerance)
        if not tol > 0:
            raise ValueError(f"TraceSpec.tolerance must be > 0, got {tol}")
        object.__setattr__(self, "tolerance", tol)

    def to_dict(self) -> dict:
        return {"events": int(self.events), "updates": int(self.updates),
                "tolerance": float(self.tolerance)}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        return cls(**d)


@_spec(data_fields=())
@dataclasses.dataclass(frozen=True, eq=False)
class SimSpec:
    """Event-engine knobs: the ``repro_torch.sim`` backend that runs this
    scenario's trajectories (``None`` = the process-wide default), the
    megastep chunk (events retired per transition call; trajectories are
    bitwise invariant to it) and the telemetry channels (``trace``).
    ``interpret`` exists so the JAX package's dicts load: the port has no
    interpret mode, and anything but ``None`` raises."""

    backend: Optional[str] = None     # reference|batched|kernel|sharded
    interpret: Optional[bool] = None
    chunk: int = 1                    # megastep events per transition call
    trace: Optional[TraceSpec] = None

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        if self.backend is not None:
            from ..sim.backend import _check

            object.__setattr__(self, "backend", _check(str(self.backend)))
        if self.interpret is not None:
            raise ValueError(
                f"SimSpec.interpret={self.interpret!r}: the port has no "
                "interpret mode (its kernels run on CUDA tensors and their "
                "plain versions on CPU tensors); leave it None")
        object.__setattr__(self, "chunk", int(self.chunk))
        if self.chunk < 1:
            raise ValueError(f"chunk must be a positive integer, got "
                             f"{self.chunk}")
        if self.trace is not None and not isinstance(self.trace, TraceSpec):
            object.__setattr__(self, "trace", TraceSpec(**dict(self.trace)))

    def to_dict(self) -> dict:
        d = {"backend": self.backend, "interpret": self.interpret}
        # trace and chunk are absent (not null) at their defaults, as the
        # JAX package writes them, so the hashes agree
        if self.trace is not None:
            d["trace"] = self.trace.to_dict()
        if self.chunk != 1:
            d["chunk"] = self.chunk
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SimSpec":
        d = dict(d)
        trace = d.pop("trace", None)
        return cls(trace=None if trace is None
                   else TraceSpec.from_dict(trace), **d)


@_spec(data_fields=())
@dataclasses.dataclass(frozen=True, eq=False)
class DataSpec:
    """Declarative training data: a registered dataset of
    ``repro_torch.data.DATASETS`` plus an ``@partition`` registry key (and
    its Dirichlet ``alpha``), so the per-client datasets come from the
    spec: ``"synthetic"`` (the procedural class glyphs) or ``"emnist"`` (a
    local ``.npz`` cache when present, else a deterministic synthetic
    stand-in of the same 28x28 format)."""

    dataset: str = "synthetic"        # registered dataset name
    partition: str = "iid"            # @partition registry key
    alpha: float = 0.2                # Dirichlet concentration (if used)
    num_classes: int = 4
    samples_per_class: int = 40
    test_fraction: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        from .. import data  # registers the partitioners and datasets

        if self.dataset not in data.DATASETS:
            raise ValueError(f"unknown dataset: {self.dataset!r}; "
                             f"registered datasets: "
                             f"{sorted(data.DATASETS)}")
        PARTITIONS.get(self.partition)
        object.__setattr__(self, "alpha", float(self.alpha))
        for f in ("num_classes", "samples_per_class", "seed"):
            object.__setattr__(self, f, int(getattr(self, f)))
        object.__setattr__(self, "test_fraction", float(self.test_fraction))

    def build(self, n: int):
        """``(clients, test_data)`` for an ``n``-client network, as numpy:
        ``clients[i] = (x_i, y_i)`` per the registered partitioner."""
        import inspect

        from ..data import get_dataset, train_test_split

        full = get_dataset(
            self.dataset, num_classes=self.num_classes,
            samples_per_class=self.samples_per_class, seed=self.seed)
        ds, test = train_test_split(full, self.test_fraction,
                                    seed=self.seed + 1)
        part = PARTITIONS.get(self.partition)
        kw = {"seed": self.seed}
        if "alpha" in inspect.signature(part).parameters:
            kw["alpha"] = self.alpha
        parts = part(ds.y, n, **kw)
        clients = [(ds.x[i], ds.y[i]) for i in parts]
        return clients, (test.x, test.y)

    def to_dict(self) -> dict:
        return {"dataset": self.dataset, "partition": self.partition,
                "alpha": float(self.alpha),
                "num_classes": int(self.num_classes),
                "samples_per_class": int(self.samples_per_class),
                "test_fraction": float(self.test_fraction),
                "seed": int(self.seed)}

    @classmethod
    def from_dict(cls, d: dict) -> "DataSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# the Scenario
# ---------------------------------------------------------------------------

@_spec(data_fields=("network", "learning", "energy", "strategy",
                    "objective", "sim", "data"))
@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """One complete experiment: network x learning x energy x strategy x
    objective (x optional sim backend and data layout)."""

    network: NetworkSpec
    learning: LearningSpec = dataclasses.field(default_factory=LearningSpec)
    energy: Optional[EnergySpec] = None
    strategy: StrategySpec = dataclasses.field(default_factory=StrategySpec)
    objective: ObjectiveSpec = dataclasses.field(
        default_factory=ObjectiveSpec)
    sim: Optional[SimSpec] = None     # None = process-default backend
    data: Optional[DataSpec] = None   # None = explicit clients required
    name: str = ""

    def __post_init__(self):
        if _SKIP_VALIDATION:
            return
        if self.energy is not None:
            # class networks carry per-class power arrays
            expected = (self.network.classes.C
                        if self.network.classes is not None
                        else self.network.n)
            if len(self.energy.kappa) != expected:
                raise ValueError("energy/network population mismatch")
        # contract: allow(stringly-dispatch): eager construction-time check that these two strategies need an EnergySpec — resolution itself routes through STRATEGIES
        if (self.strategy.name in ("energy_opt", "joint")
                and self.energy is None):
            raise ValueError(
                f"strategy {self.strategy.name!r} needs an EnergySpec")

    # -- convenience ---------------------------------------------------------

    @property
    def n(self) -> int:
        return self.network.n

    @property
    def consts(self) -> LearningConstants:
        return self.learning.consts

    def params(self, p=None, *, device="cuda") -> NetworkParams:
        return self.network.params(p, device=device)

    def class_params(self, p=None, *, device="cuda") -> ClassParams:
        return self.network.class_params(p, device=device)

    @property
    def is_class_network(self) -> bool:
        return self.network.classes is not None

    def power(self, *, device="cuda") -> Optional[PowerProfile]:
        return None if self.energy is None else self.energy.profile(
            self.network, device=device)

    def eta(self) -> float:
        return self.learning.eta_for(self.strategy.name)

    @property
    def sim_backend(self) -> Optional[str]:
        """The pinned ``repro_torch.sim`` backend (None = process
        default)."""
        return None if self.sim is None else self.sim.backend

    @property
    def trace(self) -> Optional[TraceSpec]:
        """The telemetry channels (None = tracing off)."""
        return None if self.sim is None else self.sim.trace

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def with_strategy(self, strategy, **kw) -> "Scenario":
        """New scenario with a different strategy: pass a name (plus
        StrategySpec field overrides) or a full :class:`StrategySpec`.

        Rewriting a named strategy as ``"explicit"`` (e.g. pinning its
        resolved ``(p, m)``) freezes the *current* resolved step size into
        the learning spec, so that max-throughput's reduced eta does not
        revert to the default.
        """
        if isinstance(strategy, StrategySpec):
            spec = dataclasses.replace(strategy, **kw) if kw else strategy
        else:
            spec = dataclasses.replace(self.strategy, name=str(strategy),
                                       **kw)
        learning = self.learning
        if (spec.name == EXPLICIT and self.strategy.name != EXPLICIT
                and learning.eta is None):
            learning = dataclasses.replace(learning, eta=self.eta())
        name = self.name or None
        return dataclasses.replace(
            self, strategy=spec, learning=learning,
            name=f"{name}:{spec.name}" if name else spec.name)

    def fl_config(self, **overrides):
        """An :class:`repro_torch.fl.AsyncFLConfig` for this scenario
        (law, grad clip and resolved eta pre-filled; kwargs override)."""
        from ..fl.trainer import AsyncFLConfig  # local: fl imports scenario

        kw = dict(eta=self.eta(), distribution=self.network.law,
                  grad_clip=self.learning.grad_clip)
        kw.update(overrides)
        return AsyncFLConfig(**kw)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "version": 1,
            "kind": "Scenario",
            "name": self.name,
            "network": self.network.to_dict(),
            "learning": self.learning.to_dict(),
            "energy": None if self.energy is None else self.energy.to_dict(),
            "strategy": self.strategy.to_dict(),
            "objective": self.objective.to_dict(),
        }
        # sim and data are absent (not null) when unset, as the JAX package
        # writes them
        if self.sim is not None:
            d["sim"] = self.sim.to_dict()
        if self.data is not None:
            d["data"] = self.data.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        if d.get("kind", "Scenario") != "Scenario":
            raise ValueError(f"not a Scenario dict: kind={d.get('kind')!r}")
        return cls(
            network=NetworkSpec.from_dict(d["network"]),
            learning=LearningSpec.from_dict(d["learning"]),
            energy=None if d.get("energy") is None
            else EnergySpec.from_dict(d["energy"]),
            strategy=StrategySpec.from_dict(d["strategy"]),
            objective=ObjectiveSpec.from_dict(d["objective"]),
            sim=None if d.get("sim") is None
            else SimSpec.from_dict(d["sim"]),
            data=None if d.get("data") is None
            else DataSpec.from_dict(d["data"]),
            name=d.get("name", ""),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    def hash(self) -> str:
        """Short digest of the canonical JSON.  The cosmetic ``name`` is
        excluded: two physically identical scenarios hash equal."""
        d = self.to_dict()
        d.pop("name", None)
        return hashlib.sha256(json.dumps(
            d, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()[:12]


def _is_spec(x) -> bool:
    return hasattr(type(x), "_data_fields")


def _structure(x):
    """What must agree for :func:`stack`: each spec's type and meta values,
    the shape of its data tree (absent fields, named tuples); leaves are
    ``*``."""
    if x is None:
        return None
    if _is_spec(x):
        data = type(x)._data_fields
        fields = dataclasses.fields(x)
        return (type(x).__name__,
                tuple((f.name, getattr(x, f.name)) for f in fields
                      if f.name not in data),
                tuple(_structure(getattr(x, f)) for f in data))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple(_structure(v) for v in x))
    return "*"


def _stack(xs):
    x0 = xs[0]
    if x0 is None:
        return None
    if _is_spec(x0):
        data = type(x0)._data_fields
        return type(x0)(**{
            f.name: (_stack([getattr(x, f.name) for x in xs])
                     if f.name in data else getattr(x0, f.name))
            for f in dataclasses.fields(x0)})
    if isinstance(x0, tuple) and hasattr(x0, "_fields"):
        return type(x0)(*[_stack([x[i] for x in xs])
                          for i in range(len(x0))])
    return np.stack(xs)


def stack(scenarios) -> Scenario:
    """Stack structurally identical scenarios field by field into one
    batched Scenario (leading axis = scenario lane).

    All scenarios must share their meta fields (same law, strategy and
    objective names, population size, ...); data fields are stacked with
    ``np.stack`` (validation is suspended, since the leaves gain an axis).
    """
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    structures = []
    for s in scenarios:
        st = _structure(s)
        if st not in structures:
            structures.append(st)
    if len(structures) != 1:
        raise ValueError(
            "scenarios have mixed static structure and cannot be stacked "
            "directly; run them through ScenarioSuite (which buckets by "
            f"structure): {sorted(map(str, structures))}")
    with _no_validation():  # leaves gain a lane axis: skip the 1-D checks
        return _stack(scenarios)
