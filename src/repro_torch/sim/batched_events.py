"""Lane-batched simulation: K independent lanes advance in lock-step, one
event or one megastep of ``chunk`` events per lane per step (port of
``repro.sim.batched_events``).

  * ``"reference"`` — each lane runs alone (``K = 1``) and the results are
    stacked;
  * ``"batched"``   — all lanes in one ``[K, ...]`` state through the plain
    PyTorch table transition;
  * ``"kernel"``    — the same loop with the transition in the CUDA event
    kernel (``chunk = 1``) or the CUDA megastep kernel;
  * ``"sharded"``   — ``"batched"`` with the lanes split over the local
    CUDA devices (:mod:`repro_torch.sim.sharded`).

Each lane draws from its own key (``PRNGKey(seed)`` of
:mod:`repro_torch.core.prng`, the JAX package's seeds and streams), in
blocks of ``draw_events`` events (:data:`DRAW_EVENTS` by default) through
an :class:`repro_torch.core.events.EventStream`, so a lane run alone and
the same lane among others, at any ``chunk``, consume identical draws:
lanes equal singles and every ``chunk`` equals ``chunk = 1``, bitwise.

:func:`simulate_stats_classes_lanes` runs lanes of class-aggregated
networks (:class:`repro_torch.core.buzen.ClassParams`) through the same
loop on ``"reference"``, ``"batched"`` and ``"sharded"``; the class
transition has no kernel, so ``"kernel"`` raises for class lanes.

:func:`build_lanes_fn` and :func:`build_class_lanes_fn` return the runner
of one static signature (the programs ``ScenarioSuite`` dispatches its
buckets through), memoized per signature.

``trace_events > 0`` carries an event telemetry ring of that capacity per
lane (:mod:`repro_torch.obs.rings`) on every backend: the runs return
``(EventStats, EventRing)``, the ring lane-stacked, with statistics
bitwise those of the untraced run.  On ``"kernel"`` the lane kernel
writes the ring in the same launches.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import functools
from typing import Optional

import torch

from ..core import events, prng
from ..core.buzen import ClassParams, NetworkParams
from ..core.events import (DRAW_EVENTS, EventStats, finalize_stats, lane,
                           stack_lanes)  # noqa: F401  (re-exported)
from ..kernels import build
from ..obs.rings import event_ring_init
from ..scenario.laws import get_law
from .backend import resolve_backend


def run_lanes(lane_params: NetworkParams, ms, keys, num_updates: int,
              *, warmup: int, distribution: str, m_max: int, power=None,
              backend: str = "batched", chunk: int = 1,
              draw_events: int = DRAW_EVENTS, trace_events: int = 0):
    """The lock-step loop: ``lane_params``/``power`` lane-stacked, one
    concurrency and one seed key (``keys [L, 2]``) per lane;
    ``ceil(num_events / chunk)`` steps of ``chunk`` events, the events past
    ``num_events`` masked.
    ``"reference"`` runs the lanes one at a time through the same loop,
    ``"sharded"`` splits them over the local devices
    (:func:`repro_torch.sim.sharded.run_sharded_lanes`).
    :class:`ClassParams` lanes run the class engine.  Returns
    :class:`EventStats`, or ``(EventStats, EventRing)`` with
    ``trace_events > 0``."""
    if backend == "sharded":
        from .sharded import run_sharded_lanes

        return run_sharded_lanes(lane_params, ms, keys, num_updates,
                                 warmup=warmup, distribution=distribution,
                                 m_max=m_max, power=power, chunk=chunk,
                                 draw_events=draw_events,
                                 trace_events=trace_events)
    if backend == "reference":
        outs = [run_lanes(stack_lanes([lane(lane_params, i)]), [ms[i]],
                          keys[i:i + 1], num_updates, warmup=warmup,
                          distribution=distribution, m_max=m_max,
                          power=None if power is None
                          else stack_lanes([lane(power, i)]),
                          backend="batched", chunk=chunk,
                          draw_events=draw_events, trace_events=trace_events)
                for i in range(len(keys))]
        if trace_events:
            return tuple(stack_lanes([lane(o[part], 0) for o in outs])
                         for part in (0, 1))
        return stack_lanes([lane(o, 0) for o in outs])
    mult = 4 if lane_params.mu_cs is not None else 3
    num_events = mult * (num_updates + warmup) + mult * m_max + 8
    cap = warmup + num_updates
    singles = [lane(lane_params, i) for i in range(len(keys))]
    init = (events.init_class_state if isinstance(lane_params, ClassParams)
            else events.init_state)
    st = stack_lanes([
        init(prm, m, k, m_max=m_max, distribution=distribution,
             warmup=warmup, cap=cap)
        for prm, m, k in zip(singles, ms, keys)])
    stream = events.EventStream(singles, events.event_key(keys),
                                distribution=distribution, block=draw_events,
                                total=num_events)
    ring = (event_ring_init(trace_events, lanes=len(keys),
                            device=keys.device) if trace_events else None)
    st = events.run_events(lane_params, st, stream, num_events, chunk=chunk,
                           power=power, backend=backend, ring=ring)
    return finalize_stats(st) if ring is None else (finalize_stats(st), ring)


def simulate_stats_lanes(params, ms, num_updates: int, *, warmup: int = 0,
                         keys=None, seeds=None,
                         distribution: str = "exponential", power=None,
                         m_max: Optional[int] = None,
                         backend: Optional[str] = None, chunk: int = 1,
                         draw_events: int = DRAW_EVENTS,
                         trace_events: int = 0):
    """Stationary statistics for ``L`` lanes through the selected backend.

    ``params`` is a list of per-lane :class:`NetworkParams` (or one
    lane-stacked with ``[L, n]`` leaves); ``ms`` the per-lane
    concurrencies; ``keys [L, 2]`` one seed key per lane, or ``seeds``
    for ``PRNGKey(seed)`` on the params' device (default ``0..L-1``, as
    the JAX package's); ``power`` ``None``, one shared profile or a per-lane
    list.  ``chunk`` events retire per step (megasteps; the statistics are
    bitwise those of ``chunk = 1``) and each lane draws its randomness in
    blocks of ``draw_events``.  Returns :class:`EventStats` with a leading
    ``[L]`` lane axis, or ``(EventStats, EventRing)`` when ``trace_events >
    0`` enables the event telemetry ring (statistics bitwise unchanged).
    """
    return _lanes(NetworkParams, params, ms, num_updates, warmup=warmup,
                  keys=keys, seeds=seeds,
                  distribution=distribution, power=power, m_max=m_max,
                  backend=backend, chunk=chunk, draw_events=draw_events,
                  trace_events=trace_events)


def simulate_stats_classes_lanes(classes, ms, num_updates: int, *,
                                 warmup: int = 0, keys=None,
                                 seeds=None,
                                 distribution: str = "exponential",
                                 power=None, m_max: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 chunk: int = 1,
                                 draw_events: int = DRAW_EVENTS,
                                 trace_events: int = 0):
    """:func:`simulate_stats_lanes` for class-aggregated lanes: ``classes``
    a list of per-lane :class:`ClassParams` (or one lane-stacked with
    ``[L, C]`` leaves), ``power`` per-class profiles.  The per-client
    fields of the result are per class (``[L, C]``, occupancy ``[L,
    3C+1]``; :func:`repro_torch.core.events.expand_class_stats` expands
    them).  ``backend`` ``"batched"``, ``"reference"`` or ``"sharded"``;
    ``"kernel"`` raises (no kernel exists for the class transition).
    ``trace_events`` as in :func:`simulate_stats_lanes`, the ring's
    ``client`` the class."""
    return _lanes(ClassParams, classes, ms, num_updates, warmup=warmup,
                  keys=keys, seeds=seeds,
                  distribution=distribution, power=power, m_max=m_max,
                  backend=backend, chunk=chunk, draw_events=draw_events,
                  trace_events=trace_events)


def _lanes(kind, params, ms, num_updates: int, *, warmup, keys, seeds,
           distribution, power, m_max, backend, chunk, draw_events,
           trace_events):
    """Stack the lanes of ``kind`` (:class:`NetworkParams` or
    :class:`ClassParams`), their keys and power profiles, and run
    :func:`run_lanes`."""
    get_law(distribution)  # eager: unknown laws fail listing the options
    backend = resolve_backend(backend)
    lane_params = params if isinstance(params, kind) else stack_lanes(params)
    if not isinstance(lane_params, kind):
        raise TypeError(f"expected {kind.__name__} lanes, got "
                        f"{type(lane_params).__name__}")
    L = lane_params.p.shape[0]
    ms = [int(m) for m in ms]
    if len(ms) != L:
        raise ValueError(f"got {len(ms)} concurrencies for {L} lanes")
    if keys is None:
        seeds = range(L) if seeds is None else seeds
        keys = prng.seed_keys(seeds, device=lane_params.p.device)
    if keys.shape != (L, 2):
        raise ValueError(f"got keys of shape {tuple(keys.shape)} for {L} "
                         "lanes")
    m_max = max(ms) if m_max is None else int(m_max)
    if power is not None:
        if isinstance(power, (list, tuple)) and not hasattr(power, "P_c"):
            power = stack_lanes(power)
        elif power.P_c.dim() == 1:  # one shared profile -> every lane
            power = stack_lanes([power] * L)
    return run_lanes(lane_params, ms, keys, int(num_updates),
                     warmup=int(warmup), distribution=distribution,
                     m_max=m_max, power=power, backend=backend,
                     chunk=int(chunk), draw_events=int(draw_events),
                     trace_events=int(trace_events))


def build_lanes_fn(backend: str, num_updates: int, warmup: int,
                   distribution: str, m_max: int, has_power: bool, *,
                   trace_events: int = 0, chunk: int = 1):
    """The lane-sweep runner for one static signature:
    ``fn(lane_params, m_vec, keys, power) -> EventStats`` with a leading
    lane axis on every field.  ``lane_params`` is lane-stacked (``[L, n]``
    leaves), ``m_vec`` the ``L`` concurrencies, ``keys [L, 2]`` one seed
    key per lane and ``power`` ``None`` when
    ``has_power`` is false, else a lane-stacked ``PowerProfile``.  ``chunk
    > 1`` retires that many events per step (bitwise the same statistics).
    ``trace_events > 0`` carries an event ring of that capacity per lane:
    the runner returns ``(EventStats, EventRing)``.  Runners are memoized
    per signature; a ``"sharded"`` runner splits its lanes over the local
    devices (:func:`run_lanes`)."""
    get_law(distribution)
    return _build_lanes_fn(NetworkParams, resolve_backend(backend),
                           int(num_updates), int(warmup), distribution,
                           int(m_max), bool(has_power), int(chunk),
                           int(trace_events))


def build_class_lanes_fn(backend: str, num_updates: int, warmup: int,
                         distribution: str, m_max: int, has_power: bool, *,
                         trace_events: int = 0, chunk: int = 1):
    """:func:`build_lanes_fn` for lanes of class-aggregated networks
    (lane-stacked :class:`ClassParams`, per-class power profiles).  No
    kernel exists for the class transition: ``"kernel"`` raises."""
    get_law(distribution)
    backend = resolve_backend(backend)
    if backend == "kernel":
        raise ValueError(
            "the class-aggregated event engine has no kernel; pin "
            "backend='batched', 'reference' or 'sharded' for class lanes")
    return _build_lanes_fn(ClassParams, backend, int(num_updates),
                           int(warmup), distribution, int(m_max),
                           bool(has_power), int(chunk), int(trace_events))


@functools.lru_cache(maxsize=None)
def _build_lanes_fn(kind, backend: str, num_updates: int, warmup: int,
                    distribution: str, m_max: int, has_power: bool,
                    chunk: int, trace_events: int):
    build.runner_built(("class_lanes." if kind is ClassParams else "lanes.")
                       + backend)

    def fn(lane_params, m_vec, keys, power):
        if not isinstance(lane_params, kind):
            raise TypeError(f"expected {kind.__name__} lanes, got "
                            f"{type(lane_params).__name__}")
        if (power is not None) != has_power:
            raise ValueError(f"this runner was built with has_power="
                             f"{has_power}, got power={power!r}")
        return run_lanes(lane_params, [int(m) for m in m_vec],
                         keys, num_updates, warmup=warmup,
                         distribution=distribution, m_max=m_max,
                         power=power, backend=backend, chunk=chunk,
                         trace_events=trace_events)

    return fn
