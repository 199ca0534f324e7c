"""Chrome-trace / Perfetto export of the *simulated* timeline (port of
``repro.obs.trace``; numpy only, the JAX package's code as it stands).

The event ring records every service completion as ``(time, station,
station_to, kind, slot, client, delay, update)``.  Because a closed
network's task sits at exactly one station between consecutive events of
its slot, the ring is a complete interval decomposition of the simulated
clock: :func:`station_spans` rebuilds one span per (event, slot) pair and
:func:`perfetto_trace` lays them out on one track per station — client
downlinks, compute queues, uplinks and the central server — exactly the
"what was every task doing at simulated time t" view the host-side
``AsyncNetworkSim`` never had.

The same file carries the *host* timeline on a second process track:
``repro_torch.obs.metrics`` span samples (suite planning, bucket
dispatches) and compile spans, ``(program, end, seconds)`` triples: the
port's callers pass the CUDA kernels' builds
(``repro_torch.kernels.build``) or nothing.
Load the JSON in ``chrome://tracing`` or https://ui.perfetto.dev.

Every emitted event uses the SAME key set ``{name, ph, ts, dur, pid,
tid, args}`` regardless of phase (``M`` metadata / ``X`` complete /
``i`` instant) so the golden schema (``tests/data/trace_schema.json``)
stays homogeneous.  ``ts``/``dur`` are microseconds: one unit of
simulated time maps to one second by default (``time_scale=1e6``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["station_label", "station_spans", "station_occupancy",
           "perfetto_trace"]

PID_SIM = 1    # the simulated network timeline
PID_HOST = 2   # host-side planning / dispatch / compile spans

TID_HOST_SPANS = 1
TID_COMPILES = 2

_KIND_NAMES = {-1: "inactive", 0: "down", 1: "comp_wait", 2: "comp",
               3: "up", 4: "cs_wait", 5: "cs"}


def station_label(station: int, n: int) -> str:
    """Human label of a ``[3n+1]`` station row (``events._station_index``
    layout: down_i / comp_i / up_i / CS)."""
    s = int(station)
    if s < n:
        return f"down/{s}"
    if s < 2 * n:
        return f"comp/{s - n}"
    if s < 3 * n:
        return f"up/{s - 2 * n}"
    return "cs"


def station_spans(decoded: dict) -> list:
    """Interval decomposition of one lane's ring.

    Returns dict rows ``{station, slot, client, kind, start, duration,
    update}`` sorted by start time: task ``slot`` sat at ``station`` from
    its previous event (or the window start — the simulation start ``0``
    when the ring never wrapped) until this event's ``time``.  A final
    tail span per slot (``kind=-1``, ``update=0``) covers [last event,
    window end] at the slot's ``station_to``.
    """
    t = np.asarray(decoded["time"], dtype=np.float64)
    if not t.size:
        return []
    t0 = 0.0 if int(decoded.get("dropped", 0)) == 0 else float(t[0])
    t1 = float(t[-1])
    prev: dict = {}
    spans = []
    cols = {k: np.asarray(decoded[k])
            for k in ("station", "station_to", "kind", "slot", "client",
                      "update")}
    for i in range(len(t)):
        j = int(cols["slot"][i])
        start = prev.get(j, t0)
        spans.append({"station": int(cols["station"][i]), "slot": j,
                      "client": int(cols["client"][i]),
                      "kind": int(cols["kind"][i]),
                      "start": float(start),
                      "duration": float(t[i]) - float(start),
                      "update": int(cols["update"][i])})
        prev[j] = float(t[i])
    for i in range(len(t) - 1, -1, -1):  # last event of each slot
        j = int(cols["slot"][i])
        if prev.get(j) is None:
            continue
        if prev[j] == float(t[i]):
            spans.append({"station": int(cols["station_to"][i]), "slot": j,
                          "client": int(cols["client"][i]), "kind": -1,
                          "start": float(t[i]),
                          "duration": t1 - float(t[i]), "update": 0})
            prev[j] = None
    spans.sort(key=lambda s: (s["start"], s["slot"]))
    return spans


def station_occupancy(decoded: dict, n: int) -> Optional[np.ndarray]:
    """Time-averaged ``[3n+1]`` station occupancy reconstructed from the
    ring spans — the empirical counterpart of
    ``EventStats.mean_queue_counts`` (WAIT and SERV share a station, same
    as ``events._station_index``).  ``None`` when the window is empty."""
    t = np.asarray(decoded["time"], dtype=np.float64)
    if t.size < 2:
        return None
    t0 = 0.0 if int(decoded.get("dropped", 0)) == 0 else float(t[0])
    t1 = float(t[-1])
    if not t1 > t0:
        return None
    occ = np.zeros(3 * int(n) + 1, dtype=np.float64)
    for s in station_spans(decoded):
        lo = min(max(s["start"], t0), t1)
        hi = min(s["start"] + s["duration"], t1)
        if hi > lo:
            occ[s["station"]] += hi - lo
    return occ / (t1 - t0)


def _event(name, ph, ts, dur, pid, tid, args) -> dict:
    # ONE shape for every phase — see the module docstring
    return {"name": str(name), "ph": str(ph), "ts": float(ts),
            "dur": float(dur), "pid": int(pid), "tid": int(tid),
            "args": dict(args)}


def perfetto_trace(decoded: dict, n: int, *, name: str = "lane",
                   metadata: Optional[dict] = None,
                   host_spans=None, compile_spans=None,
                   time_scale: float = 1e6) -> dict:
    """One lane's ring (plus optional host/compile spans) as a Chrome-trace
    JSON object ``{"traceEvents": [...], "displayTimeUnit": "ms",
    "metadata": {...}}``.

    ``host_spans`` takes ``repro_torch.obs.metrics.Metrics.spans()`` rows
    (``{name, labels, start, duration}``, perf-counter seconds);
    ``compile_spans`` takes ``(program, end, seconds)`` triples (the
    kernel builds).  Both are rebased to their own
    zero so the host track starts alongside the simulated one.
    """
    n = int(n)
    events = [
        _event("process_name", "M", 0, 0, PID_SIM, 0,
               {"name": f"simulated network ({name})"}),
        _event("process_name", "M", 0, 0, PID_HOST, 0,
               {"name": "host"}),
        _event("thread_name", "M", 0, 0, PID_HOST, TID_HOST_SPANS,
               {"name": "suite/serve spans"}),
        _event("thread_name", "M", 0, 0, PID_HOST, TID_COMPILES,
               {"name": "compiles"}),
    ]
    spans = station_spans(decoded)
    for station in sorted({s["station"] for s in spans}):
        events.append(_event("thread_name", "M", 0, 0, PID_SIM, station,
                             {"name": station_label(station, n)}))
    for s in spans:
        label = (_KIND_NAMES.get(s["kind"], "span") if s["kind"] >= 0
                 else station_label(s["station"], n))
        events.append(_event(
            f"{label} slot{s['slot']}", "X", s["start"] * time_scale,
            s["duration"] * time_scale, PID_SIM, s["station"],
            {"slot": s["slot"], "client": s["client"], "kind": s["kind"]}))
        if s["update"]:
            events.append(_event(
                "update", "i", (s["start"] + s["duration"]) * time_scale,
                0.0, PID_SIM, s["station"],
                {"slot": s["slot"], "client": s["client"],
                 "kind": s["kind"]}))
    starts = [float(h["start"]) for h in (host_spans or [])]
    starts += [float(end) - float(secs)
               for _, end, secs in (compile_spans or [])]
    base = min(starts) if starts else 0.0
    for h in host_spans or []:
        events.append(_event(
            h["name"], "X", (float(h["start"]) - base) * 1e6,
            float(h["duration"]) * 1e6, PID_HOST, TID_HOST_SPANS,
            {str(k): str(v) for k, v in dict(h.get("labels") or {}).items()}))
    for prog, end, secs in compile_spans or []:
        events.append(_event(
            f"compile:{prog}", "X", (float(end) - float(secs) - base) * 1e6,
            float(secs) * 1e6, PID_HOST, TID_COMPILES, {"program": str(prog)}))
    meta = {"ring": {"count": int(decoded.get("count", len(spans))),
                     "capacity": int(decoded.get("capacity", 0)),
                     "dropped": int(decoded.get("dropped", 0))},
            "n": n, "time_scale": float(time_scale)}
    if metadata:
        meta.update(metadata)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}
