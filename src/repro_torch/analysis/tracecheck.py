"""Build and launch sentinel — build budgets as machine-checked asserts
(port of ``repro.analysis.tracecheck``).

The port compiles no XLA.  What it does build or reuse is counted
instead, from the process-wide records of :mod:`repro_torch.kernels.build`:

  * every ``nvcc`` run, with its ``(program, end, seconds)`` span
    (``build.spans()``; the JAX package counts XLA compiles);
  * every library loaded from the build directory without ``nvcc``
    (``build.reuses()``; JAX's persistent-cache hits);
  * every bucket runner built, by name (``build.runners()``: a miss of
    ``SuiteCaches`` in :class:`repro_torch.scenario.ScenarioSuite` or of
    the lane builders' memo in :mod:`repro_torch.sim.batched_events`;
    JAX's compiled program names);
  * every kernel launch, by wrapper (``build.launch_totals()``, the
    wrappers' ``.launches``; JAX sees the ``pallas_call`` it ran);
  * Dynamo compiles (``torch._dynamo.utils.counters``), read only when
    ``torch._dynamo`` is already imported, so a watch costs no import.
    The port runs no ``torch.compile``: its budget is 0.

Usage::

    from repro_torch.analysis import tracecheck

    with tracecheck.expect(max_programs=2,
                           pattern=tracecheck.PLANNER_PROGRAMS) as watch:
        suite.run(mode="simulate", num_updates=2000)
    # raises TraceBudgetExceeded on the way out if >2 runners were built

    with tracecheck.forbid("a cached repeat builds nothing"):
        suite.run(mode="simulate", num_updates=2000)

    counted = tracecheck.counting(objective)   # Python-call counter
    sweep(counted, ...); assert counted.traces == steps

The tests take this module from the ``tracecheck`` fixture of
``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import contextlib
import re
import sys
from typing import Optional

from ..kernels import build

#: the names the runner memos record: the suite's analyze, simulate and
#: train buckets (``suite.<mode>``) and the lane runners of
#: :func:`repro_torch.sim.batched_events.build_lanes_fn` and its class
#: sibling (``lanes.<backend>``, ``class_lanes.<backend>``; the sharded
#: builders go through them).  Budgets scoped to this pattern count
#: planner runners only.
PLANNER_PROGRAMS = (
    r"^(suite\.(analyze|simulate|train)|(class_)?lanes\.[a-z]+)$")


class TraceBudgetExceeded(AssertionError):
    """A watched block built more than its budget."""


def _dynamo_compiles() -> int:
    """Graphs Dynamo compiled so far; 0 unless ``torch._dynamo`` is
    already imported (reading it must not import it)."""
    if "torch._dynamo" not in sys.modules:
        return 0
    utils = sys.modules.get("torch._dynamo.utils")
    counters = getattr(utils, "counters", None)
    if counters is None:
        return 0
    return int(counters["stats"]["unique_graphs"])


class Watch:
    """Counters for one watched block: live inside it, frozen at its end."""

    def __init__(self):
        self._spans0 = len(build.spans())
        self._reuses0 = len(build.reuses())
        self._runners0 = len(build.runners())
        self._launches0 = build.launch_totals()
        self._dynamo0 = _dynamo_compiles()
        self._frozen: Optional[dict] = None

    def _now(self) -> dict:
        if self._frozen is not None:
            return self._frozen
        totals = build.launch_totals()
        launches = {k: v - self._launches0.get(k, 0)
                    for k, v in sorted(totals.items())
                    if v != self._launches0.get(k, 0)}
        return {"spans": build.spans()[self._spans0:],
                "reuses": build.reuses()[self._reuses0:],
                "runners": [name for name, _ in
                            build.runners()[self._runners0:]],
                "launches": launches,
                "dynamo": _dynamo_compiles() - self._dynamo0}

    def _freeze(self) -> None:
        self._frozen = self._now()

    @property
    def spans(self) -> list:
        """``(program, end, seconds)`` of each ``nvcc`` run in the block
        (the compile track of ``repro_torch.obs.trace.perfetto_trace``)."""
        return list(self._now()["spans"])

    @property
    def builds(self) -> int:
        """``nvcc`` runs (the JAX package's XLA compiles; every one is
        fresh)."""
        return len(self._now()["spans"])

    @property
    def cache_hits(self) -> int:
        """Libraries loaded from the build directory without ``nvcc`` (the
        JAX package's persistent-cache hits)."""
        return len(self._now()["reuses"])

    @property
    def compiled(self) -> list:
        """Names of the bucket runners built, in order."""
        return list(self._now()["runners"])

    @property
    def launches(self) -> dict:
        """Kernel launches by wrapper name (only those that launched)."""
        return dict(self._now()["launches"])

    @property
    def dynamo_compiles(self) -> int:
        """Graphs Dynamo compiled (``torch.compile``)."""
        return self._now()["dynamo"]

    def programs(self, pattern: Optional[str] = None) -> list:
        """Runner names built, optionally filtered by regex."""
        if pattern is None:
            return self.compiled
        rx = re.compile(pattern)
        return [n for n in self.compiled if rx.search(n)]


@contextlib.contextmanager
def watch():
    """Count builds, runners, launches and Dynamo compiles in the block."""
    w = Watch()
    try:
        yield w
    finally:
        w._freeze()


@contextlib.contextmanager
def expect(max_programs: Optional[int] = None,
           pattern: Optional[str] = None,
           max_builds: Optional[int] = None,
           max_compiles: Optional[int] = None,
           what: str = ""):
    """Budget-checked :func:`watch`: raises :class:`TraceBudgetExceeded`
    on exit when the block exceeded any given budget.

    ``max_programs`` bounds the runners built whose names match
    ``pattern`` (default: every name); ``max_builds`` bounds ``nvcc``
    runs; ``max_compiles`` bounds Dynamo compiles.
    """
    with watch() as w:
        yield w
    label = f" ({what})" if what else ""
    if max_programs is not None:
        progs = w.programs(pattern)
        if len(progs) > max_programs:
            raise TraceBudgetExceeded(
                f"built {len(progs)} runners{label}, budget "
                f"{max_programs}: {progs}")
    if max_builds is not None and w.builds > max_builds:
        raise TraceBudgetExceeded(
            f"{w.builds} nvcc builds{label}, budget {max_builds}: "
            f"{[s[0] for s in w.spans]}")
    if max_compiles is not None and w.dynamo_compiles > max_compiles:
        raise TraceBudgetExceeded(
            f"{w.dynamo_compiles} Dynamo compiles{label}, budget "
            f"{max_compiles}")


def forbid(what: str = "block must not build anything"):
    """The block builds nothing: no ``nvcc`` run, no runner, no Dynamo
    compile (zero-budget :func:`expect`)."""
    return expect(max_programs=0, max_builds=0, max_compiles=0, what=what)


def fresh() -> None:
    """Clear the port's runner memos (the lane builders'), the
    counterpart of ``jax.clear_caches()``; ``SuiteCaches`` belong to their
    suites."""
    from ..sim.batched_events import _build_lanes_fn

    _build_lanes_fn.cache_clear()


class counting:  # noqa: N801 — reads as a verb at call sites
    """Wrap a function so each *Python execution* is counted in
    ``.traces`` (eager PyTorch runs the body on every call; the name is
    the JAX package's, where the body runs only while tracing)."""

    def __init__(self, fn):
        self.fn = fn
        self.traces = 0

    def __call__(self, *args, **kwargs):
        self.traces += 1
        return self.fn(*args, **kwargs)
