"""Counters, latency histograms and host spans: the one metrics registry
(port of ``repro.obs.metrics``; the standard library only).

A :class:`Metrics` registry threads through ``ScenarioSuite.run`` (every
suite owns one; pass ``metrics=`` to share a registry across suites), so
each run reports the same per-bucket counters: programs built, lanes
dispatched, cache hits, and wall-clock latency percentiles.  It also keeps
a bounded window of **host spans** (every ``timed()`` block's start and
duration) and renders a Prometheus-style text :meth:`Metrics.exposition`.

The registry is thread-safe and dependency-free: histograms keep a
bounded reservoir of recent observations, so percentiles are exact over
the window in O(1) memory.
"""
from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Optional

_RESERVOIR = 2048  # recent-observation window per histogram
_SPANS = 4096      # recent-span window

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


class Histogram:
    """Bounded-reservoir histogram: exact percentiles over the most
    recent ``_RESERVOIR`` observations, plus all-time count and sum."""

    __slots__ = ("count", "total", "_window")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self._window = deque(maxlen=_RESERVOIR)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += float(value)
        self._window.append(float(value))

    def percentile(self, q: float) -> float:
        """Exact q-quantile (0 <= q <= 1) of the recent window (nearest
        rank); 0.0 when nothing has been observed."""
        if not self._window:
            return 0.0
        ordered = sorted(self._window)
        rank = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[rank]

    def summary(self) -> dict:
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99)}


class Metrics:
    """Thread-safe named counters + histograms with optional labels.

    Label values land in the flattened snapshot key as
    ``name{k=v,...}`` — e.g. ``suite.lanes{mode=train}``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        # (name, labels dict, perf_counter start, duration s): the recent
        # host-span window
        self._spans: deque = deque(maxlen=_SPANS)

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        return f"{name}{{{inner}}}"

    def inc(self, name: str, by: float = 1, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0)

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = Histogram()
        hist.observe(value)

    def timed(self, name: str, **labels) -> "_Timer":
        """``with metrics.timed("suite.dispatch", mode="train"): ...``
        observes the block's wall-clock seconds (and keeps the span)."""
        return _Timer(self, name, labels)

    def record_span(self, name: str, labels: dict, start: float,
                    duration: float) -> None:
        """Keep one host span (``start`` on the ``time.perf_counter``
        clock) in the bounded span window."""
        with self._lock:
            self._spans.append((name, dict(labels), float(start),
                                float(duration)))

    def spans(self) -> list:
        """Recent host spans as ``{name, labels, start, duration}`` dicts
        (start on the ``perf_counter`` clock, seconds)."""
        with self._lock:
            return [{"name": n, "labels": lb, "start": s, "duration": d}
                    for n, lb, s, d in self._spans]

    def snapshot(self) -> dict:
        """JSON-able view: ``{"counters": {...}, "latency": {key:
        {count, mean, p50, p99}}}``."""
        with self._lock:
            counters = dict(self._counters)
            hists = {k: h.summary() for k, h in self._hists.items()}
        return {"counters": counters, "latency": hists}

    def exposition(self) -> str:
        """Prometheus text exposition of the registry.

        Counters render as ``counter`` samples, histograms as ``summary``
        quantiles plus ``_sum``/``_count`` — names sanitized to the
        Prometheus charset (``suite.dispatch`` -> ``suite_dispatch``),
        labels quoted.
        """
        snap = self.snapshot()
        lines: list[str] = []
        typed: set[str] = set()

        def emit(kind: str, key: str, render) -> None:
            name, labels = _split_key(key)
            metric = _NAME_RE.sub("_", name)
            if metric not in typed:
                typed.add(metric)
                lines.append(f"# TYPE {metric} {kind}")
            render(metric, labels)

        for key in sorted(snap["counters"]):
            value = snap["counters"][key]
            emit("counter", key, lambda metric, labels: lines.append(
                f"{metric}{_render_labels(labels)} {float(value)}"))
        for key in sorted(snap["latency"]):
            s = snap["latency"][key]

            def render(metric, labels, s=s):
                for q, v in (("0.5", s["p50"]), ("0.99", s["p99"])):
                    lines.append(f"{metric}"
                                 f"{_render_labels(labels, quantile=q)}"
                                 f" {float(v)}")
                lines.append(f"{metric}_sum{_render_labels(labels)}"
                             f" {s['mean'] * s['count']}")
                lines.append(f"{metric}_count{_render_labels(labels)}"
                             f" {s['count']}")

            emit("summary", key, render)
        return "\n".join(lines) + "\n"


def _split_key(key: str) -> tuple[str, dict]:
    """Inverse of :meth:`Metrics._key`: ``name{k=v,...}`` -> (name, dict)."""
    if "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def _render_labels(labels: dict, **extra) -> str:
    merged = {**labels, **extra}
    if not merged:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", k)}="{merged[k]}"'
                     for k in sorted(merged))
    return f"{{{inner}}}"


class _Timer:
    __slots__ = ("_metrics", "_name", "_labels", "_t0")

    def __init__(self, metrics: Metrics, name: str, labels: dict):
        self._metrics = metrics
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        dt = time.perf_counter() - self._t0
        self._metrics.observe(self._name, dt, **self._labels)
        self._metrics.record_span(self._name, self._labels, self._t0, dt)
        return None
