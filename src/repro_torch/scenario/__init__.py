"""repro_torch.scenario — the declarative Scenario API (port of
``repro.scenario``): timing laws and the registries, the spec
(:class:`Scenario` and its sub-specs, JSON round-trips, ``hash``,
``stack``), the strategy and objective registrations with
:func:`resolve_strategy`, and :class:`ScenarioSuite` (``analyze``,
``simulate`` and ``train`` over bucketed, padded lanes) with its
:class:`SuiteResult` and :class:`SuiteCaches`.

Import structure, as in the JAX package: this ``__init__`` eagerly loads
only the dependency-free ``registry`` and ``laws`` modules (the engines in
``repro_torch.core`` import them); ``spec`` and ``suite``, which import
``repro_torch.core``, load on first attribute access.
"""
from __future__ import annotations

from . import laws  # registers the built-in timing laws  # noqa: F401
from .laws import TimingLaw, get_law, law_names
from .registry import (OBJECTIVES, PARTITIONS, STRATEGIES, TIMING_LAWS,
                       Registry, objective, partition, strategy, timing_law)

_SPEC = ("Scenario", "NetworkSpec", "ClassSpec", "LearningSpec", "EnergySpec",
         "StrategySpec", "ObjectiveSpec", "SimSpec", "TraceSpec", "DataSpec",
         "ClusterSpec",
         "PAPER_CLUSTERS_TABLE1", "PAPER_CLUSTERS_TABLE6", "expand_clusters",
         "DEFAULT_ETA", "MAX_THROUGHPUT_ETA", "EXPLICIT", "stack")
_SUITE = ("ObjectiveDef", "ResolveContext", "resolve_strategy",
          "get_objective", "default_m_max", "ScenarioSuite", "SuiteResult",
          "SuiteCaches")

__all__ = [
    "Registry", "TIMING_LAWS", "STRATEGIES", "OBJECTIVES", "PARTITIONS",
    "timing_law", "strategy", "objective", "partition",
    "TimingLaw", "get_law", "law_names",
    *_SPEC, *_SUITE,
]


def __getattr__(name: str):
    if name in _SPEC:
        from . import spec

        return getattr(spec, name)
    if name in _SUITE:
        from . import suite

        return getattr(suite, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
