"""Lanes split over the local CUDA devices (``backend="sharded"``; port of
``repro.sim.sharded``).

Lanes are independent, so the lane axis splits into contiguous,
near-equal chunks, one a device of :func:`lane_devices`.  Each chunk's
networks, concurrencies, keys and power profiles move to its device, where
the ``"batched"`` lane program runs on them (the JAX package's
``"sharded"`` is its ``"batched"`` program under ``shard_map``, not its
``"pallas"`` one) with the whole call's table size, depth, chunk, draw
block and ring capacity.  The chunks run concurrently, one worker thread a
device, each inside ``torch.cuda.device(d)`` on a stream of its own, and
the results are gathered in lane order onto the input's device, leaf by
leaf with ``torch.cat``.

Bitwise contract: a lane's trajectory depends on its own network, key and
the call's static signature only (lanes equal singles), so a split changes
where a lane runs, never what it computes: ``"sharded"`` equals
``"batched"`` lane by lane at any device count.  A ragged split gives the
same bits, so no lane is padded (the JAX package repeats the last lane to
a device-count multiple because ``shard_map`` needs equal shards).

With one device (a CPU run, or a host with one card) the ``"batched"``
runner is called directly, with no thread and no copy, as the JAX
package's trivial mesh is.  :func:`lane_devices` is the one place that
names the devices; a test patches it (``unittest.mock.patch``) to force a
split, three CPU devices or ``[cuda:0] * 3`` on one card.  A worker's
failure is raised again in the caller: nothing falls back to a serial or
a CPU run.

:func:`run_split` is the same worker pool for any row-local work:
``batched_concurrency_sweep(shard=True)`` runs its Adam shards through it.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import threading

import torch

from ..core.events import DRAW_EVENTS
from ..core.numerics import map_tensors


def device_count() -> int:
    """The local devices lanes split over: the CUDA devices visible to the
    process, 1 without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def lane_devices(device) -> list:
    """The devices that lanes on ``device`` split over: every visible CUDA
    device for a CUDA ``device``, ``[device]`` otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def split_bounds(total: int, parts: int) -> list:
    """``[(start, stop), ...]``: ``total`` rows in at most ``parts``
    contiguous chunks whose sizes differ by at most one (the first ``total
    % parts`` one longer); no empty chunk."""
    base, extra = divmod(int(total), int(parts))
    bounds, start = [], 0
    for i in range(min(int(parts), int(total))):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def run_split(shard, total: int, devices, src):
    """``total`` rows split by :func:`split_bounds` over ``devices``:
    ``shard(start, stop, device)`` for each chunk, concurrently, one worker
    thread a device, each inside ``torch.cuda.device(d)`` on a new stream
    of its own for a CUDA ``d``; the chunks' results :func:`gather`-ed in
    row order.  ``src`` is where the caller's inputs live; ``shard`` reads
    its rows of them, moves them to its device and returns its results on
    ``src``.  The caller's stream is synchronized before the workers
    start, and each worker's stream after it ends; every CUDA tensor
    returned is recorded on the caller's stream, so its memory is not
    reused before the caller's later work has read it.  The first worker
    exception is raised again here, after every worker ended."""
    bounds = split_bounds(total, len(devices))
    devices = devices[:len(bounds)]
    src = torch.device(src)
    if src.type == "cuda":
        torch.cuda.current_stream(src).synchronize()
    results = [None] * len(devices)
    errors = [None] * len(devices)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]

    def worker(i):
        d, stream = devices[i], streams[i]
        try:
            if stream is None:
                results[i] = shard(*bounds[i], d)
                return
            with torch.cuda.device(d), torch.cuda.stream(stream):
                results[i] = shard(*bounds[i], d)
        except BaseException as e:  # raised again in the caller
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"lane-shard-{i}")
               for i in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for stream in streams:
        if stream is not None:
            stream.synchronize()
    for e in errors:
        if e is not None:
            raise e

    def keep(t):
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
        return t

    return gather([map_tensors(keep, r) for r in results])


def gather(parts):
    """Per-chunk results (tensors, tuples or ``NamedTuple``s of them) as
    one, each leaf concatenated along its leading lane axis in chunk
    order."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat(parts)
    if isinstance(first, tuple):
        leaves = [None if x is None else gather([p[i] for p in parts])
                  for i, x in enumerate(first)]
        return (type(first)(*leaves) if hasattr(first, "_fields")
                else tuple(leaves))
    return first


def run_sharded_lanes(lane_params, ms, keys, num_updates: int, *,
                      warmup: int, distribution: str, m_max: int,
                      power=None, chunk: int = 1,
                      draw_events: int = DRAW_EVENTS,
                      trace_events: int = 0):
    """:func:`repro_torch.sim.batched_events.run_lanes` on ``"batched"``
    with the lanes split over :func:`lane_devices` of ``keys``' device:
    the same arguments and the same result (``EventStats``, or
    ``(EventStats, EventRing)`` with ``trace_events > 0``), on the input's
    device."""
    from .batched_events import run_lanes

    kw = dict(warmup=warmup, distribution=distribution, m_max=m_max,
              backend="batched", chunk=chunk, draw_events=draw_events,
              trace_events=trace_events)
    src = keys.device
    devices = lane_devices(src)
    ms = [int(m) for m in ms]
    if len(devices) == 1:
        return run_lanes(lane_params, ms, keys, num_updates, power=power,
                         **kw)

    def shard(a, b, dev):
        def part(t):
            return t[a:b].to(dev)

        out = run_lanes(map_tensors(part, lane_params), ms[a:b],
                        part(keys), num_updates,
                        power=map_tensors(part, power), **kw)
        return map_tensors(lambda t: t.to(src), out)

    return run_split(shard, len(ms), devices, src)


def build_sharded_lanes_fn(num_updates: int, warmup: int, distribution: str,
                           m_max: int, has_power: bool,
                           trace_events: int = 0, chunk: int = 1):
    """``fn(lane_params, m_vec, keys, power) -> EventStats`` (``(EventStats,
    EventRing)`` with ``trace_events > 0``) with the lane axis split over
    the local devices: the ``"sharded"`` entry of
    :func:`repro_torch.sim.batched_events.build_lanes_fn`, with the JAX
    package's signature.  Memoized per signature."""
    from .batched_events import build_lanes_fn

    return build_lanes_fn("sharded", num_updates, warmup, distribution,
                          m_max, has_power, trace_events=trace_events,
                          chunk=chunk)


def build_sharded_class_lanes_fn(num_updates: int, warmup: int,
                                 distribution: str, m_max: int,
                                 has_power: bool, trace_events: int = 0,
                                 chunk: int = 1):
    """:func:`build_sharded_lanes_fn` for lanes of class-aggregated
    networks (lane-stacked :class:`repro_torch.core.buzen.ClassParams`):
    the ``"sharded"`` entry of
    :func:`repro_torch.sim.batched_events.build_class_lanes_fn`."""
    from .batched_events import build_class_lanes_fn

    return build_class_lanes_fn("sharded", num_updates, warmup,
                                distribution, m_max, has_power,
                                trace_events=trace_events, chunk=chunk)
