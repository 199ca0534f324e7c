"""Telemetry rings for the event engine and the lane trainer (port of
``repro.obs.rings``).

A ring is a NamedTuple of fixed-size tensors plus a monotone write counter
``count``.  An append writes at ``count % capacity`` (wraparound keeps the
most recent records) and bumps ``count``; it reads what the engine
reported and never writes the engine's state, so a traced run equals an
untraced run bitwise.  Rings are lane-stacked when ``lanes`` is given:
every column ``[L, capacity]`` and ``count [L]``, one record a lane per
append.

Appends write the ring's tensors **in place** and return the ring: the
CUDA lane kernel (``kernels/csrc/events.cu``) writes the caller's event
ring in the same way inside its launches, so both routes leave the same
buffers behind.  Capacity 0 is the disabled channel: the columns are
zero-length and every append is a Python no-op.

Channels:

  * :class:`EventRing` — one record per event (service completion):
    completion clock, the station completed at (``[3n+1]`` layout: down_i
    / comp_i / up_i / CS), the station the task moved to, the pre-event
    phase, task slot, client (the class on the class engine), relative
    delay and the update flag;
  * :class:`UpdateRing` — one record per applied model update: apply
    clock, client, staleness, the float64 L2 norm of the gradient and the
    snapshot's age.

:func:`decode` is host-side: the wraparound is unrolled so the records
come back in chronological order, with the count of dropped
(overwritten) records.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class EventRing(NamedTuple):
    """Per-event channel (columns ``[capacity]``, ``count`` a scalar; or
    ``[L, capacity]`` and ``[L]`` lane-stacked)."""

    time: torch.Tensor        # completion clock (float64)
    station: torch.Tensor     # station completed at (pre-event)
    station_to: torch.Tensor  # station the task moved to
    kind: torch.Tensor        # pre-event phase (DOWN/COMP_SERV/UP/CS_SERV)
    slot: torch.Tensor        # task-table row
    client: torch.Tensor      # owning client (class on the class engine)
    delay: torch.Tensor       # relative delay round - dispatch round
    update: torch.Tensor      # 1 iff this event applied a model update
    count: torch.Tensor       # records ever appended (monotone)


class UpdateRing(NamedTuple):
    """Per-applied-update channel of the lane trainer."""

    time: torch.Tensor          # apply clock (float64)
    client: torch.Tensor        # gradient's client C_k
    staleness: torch.Tensor     # relative delay of the applied gradient
    grad_norm: torch.Tensor     # float64 L2 norm of the gradient
    snapshot_age: torch.Tensor  # apply clock minus the snapshot's clock
    count: torch.Tensor


_EVENT_DTYPES = {"time": torch.float64, "station": torch.int32,
                 "station_to": torch.int32, "kind": torch.int32,
                 "slot": torch.int32, "client": torch.int32,
                 "delay": torch.int32, "update": torch.int32}
_UPDATE_DTYPES = {"time": torch.float64, "client": torch.int32,
                  "staleness": torch.int32, "grad_norm": torch.float64,
                  "snapshot_age": torch.float64}


def _init(cls, dtypes: dict, capacity: int, lanes: Optional[int], device):
    lead = () if lanes is None else (int(lanes),)
    cols = {k: torch.zeros(lead + (int(capacity),), dtype=dt, device=device)
            for k, dt in dtypes.items()}
    return cls(count=torch.zeros(lead, dtype=torch.int32, device=device),
               **cols)


def event_ring_init(capacity: int, *, lanes: Optional[int] = None,
                    device="cuda") -> EventRing:
    """An empty event ring (``capacity == 0`` disables the channel), one
    per lane when ``lanes`` is given."""
    return _init(EventRing, _EVENT_DTYPES, capacity, lanes, device)


def update_ring_init(capacity: int, *, lanes: Optional[int] = None,
                     device="cuda") -> UpdateRing:
    """An empty update ring (``capacity == 0`` disables the channel)."""
    return _init(UpdateRing, _UPDATE_DTYPES, capacity, lanes, device)


def capacity(ring) -> int:
    """Records a ring (or each lane of it) holds."""
    return int(ring.time.shape[-1])


def _append(ring, valid, cols: dict):
    """Write one record (one a lane) at ``count % capacity`` and bump the
    counter, in place.  ``valid`` (a bool tensor, ``[L]`` lane-stacked)
    gates the write and the bump; ``None`` appends unconditionally.  A
    Python no-op at capacity 0."""
    cap = capacity(ring)
    if cap == 0:
        return ring
    stacked = ring.count.dim() == 1
    idx = (ring.count % cap).long()
    at = ((torch.arange(idx.shape[0], device=idx.device), idx) if stacked
          else (idx,))
    for name, value in cols.items():
        col = getattr(ring, name)
        v = torch.as_tensor(value, dtype=col.dtype, device=col.device)
        if valid is not None:
            v = torch.where(valid, v, col[at])
        col[at] = v
    ring.count.add_(1 if valid is None else valid.to(torch.int32))
    return ring


def event_ring_append(ring: EventRing, *, time, station, station_to, kind,
                      slot, client, delay, update,
                      valid: Optional[torch.Tensor] = None) -> EventRing:
    return _append(ring, valid, {
        "time": time, "station": station, "station_to": station_to,
        "kind": kind, "slot": slot, "client": client, "delay": delay,
        "update": update})


def update_ring_append(ring: UpdateRing, *, time, client, staleness,
                       grad_norm, snapshot_age,
                       valid: Optional[torch.Tensor] = None) -> UpdateRing:
    return _append(ring, valid, {
        "time": time, "client": client, "staleness": staleness,
        "grad_norm": grad_norm, "snapshot_age": snapshot_age})


def decode(ring) -> dict:
    """Host-side view of one ring (one lane: index lane-stacked rings with
    :func:`decode_lane`).

    Returns ``{column: np.ndarray}`` in chronological order plus
    ``count`` (records ever appended), ``capacity`` and ``dropped``
    (records overwritten by wraparound).
    """
    count = int(ring.count)
    cap = capacity(ring)
    out: dict = {}
    for name in ring._fields:
        if name == "count":
            continue
        col = getattr(ring, name).detach().cpu().numpy()
        if count <= cap:
            col = col[:count]
        else:
            col = np.roll(col, -(count % cap), axis=0)
        out[name] = col
    out["count"] = count
    out["capacity"] = cap
    out["dropped"] = max(0, count - cap)
    return out


def lane_rings(ring) -> list:
    """The lanes of a lane-stacked ring, one ring each (views)."""
    return [type(ring)(*[x[i] for x in ring])
            for i in range(ring.count.shape[0])]


def decode_lane(ring, lane: int) -> dict:
    """:func:`decode` of one lane of a lane-stacked ring."""
    return decode(type(ring)(*[x[lane] for x in ring]))
