"""Device-resident event engine for the Generalized AsyncSGD closed network
(port of ``repro.core.events``, per-client half, one event per step).

The state is a fixed-size in-flight task table per lane (``[K, m_max]``:
phase, owning client, FIFO sequence, dispatch round and the absolute
completion clock of each task) plus O(1)-updated occupancy carries and the
statistics of the update-count window ``[warmup, cap)``.  One event is one
service completion: the argmin over the clocks, the phase promotion or
re-dispatch of the completed slot, and the FIFO promotions — the table
transition of :mod:`repro_torch.kernels.events`.  Around it,
:func:`step_event_lanes` keeps the statistics and the occupancy carries in
PyTorch, the same float operations whichever transition runs.

Randomness is separated from the state: every per-event draw is
state-independent and is drawn up front, for many events at once, as
:class:`EventBlocks` from one ``torch.Generator`` per lane
(:func:`draw_event_blocks`).  The generator path and an injected-blocks
path (e.g. blocks drawn by the JAX package) run the same
:func:`step_event_block` loop, which is how the port is held bitwise to
the JAX engine.  Same-seed parity with ``jax.random`` is not ported.

Every state leaf carries a leading lane axis ``[K, ...]`` in the step;
:func:`init_state` builds one lane and :func:`stack_lanes` stacks them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..scenario.laws import get_law
from .buzen import NetworkParams
from .numerics import DTYPE, fma, seqcumsum, seqsum

# task phases
INACTIVE = -1
DOWN = 0        # downlink in service (infinite-server)
COMP_WAIT = 1   # waiting in the client's compute FIFO
COMP_SERV = 2   # in service at the client's compute queue
UP = 3          # uplink in service (infinite-server)
CS_WAIT = 4     # waiting in the CS FIFO (Section 7)
CS_SERV = 5     # in service at the CS single-server queue

_BIG_SEQ = 2**31 - 1
_NO_CAP = 2**31 - 1


class EventState(NamedTuple):
    """Carry of the event loop (the JAX state without its PRNG key)."""

    t: torch.Tensor          # current wall-clock time
    round: torch.Tensor      # updates completed so far (round counter k)
    seq_ctr: torch.Tensor    # global FIFO arrival counter
    client: torch.Tensor     # [m_max]
    phase: torch.Tensor      # [m_max]
    finish: torch.Tensor     # [m_max]
    seq: torch.Tensor        # [m_max]
    disp_round: torch.Tensor  # [m_max]
    warmup: torch.Tensor
    cap: torch.Tensor
    t_cap: torch.Tensor
    t0: torch.Tensor         # time of update #warmup (stats origin)
    t1: torch.Tensor         # time of update #cap (stats end)
    delay_sum: torch.Tensor  # [n]
    delay_cnt: torch.Tensor  # [n]
    energy: torch.Tensor     # Eq. 14 time integral
    occ_int: torch.Tensor    # [3n+1] time-weighted station occupancy
    occ: torch.Tensor        # [3n+1] current station occupancy
    serving: torch.Tensor    # [n] busy indicator of each compute server
    cs_busy: torch.Tensor    # CS server busy


class EventOut(NamedTuple):
    """Per-event emission of :func:`step_event_block`."""

    is_update: torch.Tensor
    time: torch.Tensor
    slot: torch.Tensor    # task-table row of the completed task
    client: torch.Tensor  # client whose gradient would be applied
    delay: torch.Tensor   # relative delay round - dispatch_round


class EventStats(NamedTuple):
    """Device analogue of ``repro_torch.core.simulator.SimStats``."""

    updates: torch.Tensor
    time: torch.Tensor
    throughput: torch.Tensor
    mean_delay: torch.Tensor         # [n] unscaled E0[R_i], 0 where no samples
    delay_counts: torch.Tensor       # [n]
    energy: torch.Tensor
    mean_queue_counts: torch.Tensor  # [3n+1]


class EventBlocks(NamedTuple):
    """Pre-drawn randomness of consecutive events (leading event axis).

    The routing draw, the downlink service of the re-dispatched task and
    the CS service resolve fully up front; the uplink and computation
    services depend on the completing client's rate, so they are stored as
    the law's unit parts and rate-applied inside the step.
    """

    c_new: torch.Tensor     # routed client (int64)
    svc_down: torch.Tensor  # downlink service of the re-dispatched task
    up: torch.Tensor        # uplink unit part
    comp: torch.Tensor      # computation unit part
    svc_cs: Optional[torch.Tensor] = None  # CS service; None without CS


def _route_client(p: torch.Tensor, u: torch.Tensor, n_act,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch routing ``C ~ p / sum(p)`` by inverse CDF on one uniform per
    draw, against the strictly sequential prefix sums of ``p`` — never a
    categorical sampler, whose noise would depend on the padded length.
    Padded (zero-mass) entries repeat the total, so they are never hit."""
    if prefix is None:
        prefix = seqcumsum(p)
    idx = torch.searchsorted(prefix, u * prefix[-1], right=True)
    return torch.clamp(idx, max=n_act - 1)


def draw_event_blocks(params: NetworkParams, generator: torch.Generator,
                      chunk: int, *, distribution: str = "exponential",
                      route_prefix: Optional[torch.Tensor] = None
                      ) -> EventBlocks:
    """Draw the randomness of ``chunk`` consecutive events of one lane."""
    law = get_law(distribution)
    dev = params.device
    u = torch.rand(chunk, generator=generator, dtype=DTYPE, device=dev)
    c_new = _route_client(params.p, u, params.active_count, route_prefix)
    svc_down = law.device_draw(generator, params.mu_d[c_new])
    up = law.unit_draw(generator, (chunk,), DTYPE, dev)
    comp = law.unit_draw(generator, (chunk,), DTYPE, dev)
    svc_cs = (law.device_draw(generator, params.mu_cs.expand(chunk))
              if params.mu_cs is not None else None)
    return EventBlocks(c_new=c_new, svc_down=svc_down, up=up, comp=comp,
                       svc_cs=svc_cs)


def _station_counts(phase, client, n):
    """Per-station occupancy of one table: ``down[n], comp_total[n],
    comp_serving[n], up[n], cs_total, cs_busy`` (a full recount; seeds the
    O(1)-update carries)."""
    cl = client.long()

    def count(mask):
        return torch.zeros(n, dtype=DTYPE, device=phase.device).index_add_(
            0, cl, mask.to(DTYPE))

    down = count(phase == DOWN)
    comp_total = count((phase == COMP_WAIT) | (phase == COMP_SERV))
    comp_serving = count(phase == COMP_SERV)
    up = count(phase == UP)
    cs_total = torch.sum(((phase == CS_WAIT) | (phase == CS_SERV)).to(DTYPE))
    cs_busy = torch.any(phase == CS_SERV)
    return down, comp_total, comp_serving, up, cs_total, cs_busy


def _station_index(phase, client, n):
    """Row of the ``[3n+1]`` occupancy vector a task in ``(phase, client)``
    occupies: down_i / comp_i (WAIT and SERV share it) / up_i / CS."""
    return torch.where(
        phase == DOWN, client,
        torch.where((phase == COMP_WAIT) | (phase == COMP_SERV), n + client,
                    torch.where(phase == UP, 2 * n + client, 3 * n)))


def init_state(params: NetworkParams, m, generator: torch.Generator, *,
               m_max: Optional[int] = None,
               distribution: str = "exponential", warmup=0, cap=_NO_CAP,
               t_cap=math.inf) -> EventState:
    """One lane's initial state: ``m`` tasks dispatched uniformly at random
    into the downlink servers at ``t = 0`` (Section 5.3.3); slots ``>= m``
    of the ``m_max`` table are inactive.  Under the padded-``n`` convention
    only real clients are drawn."""
    law = get_law(distribution)
    n = params.n
    dev = params.device
    m_max = int(m) if m_max is None else m_max
    clients = torch.randint(0, int(params.active_count), (m_max,),
                            generator=generator, device=dev)
    active = torch.arange(m_max, device=dev) < m
    svc = law.device_draw(generator, params.mu_d[clients])
    phase0 = torch.where(active, DOWN, INACTIVE).to(torch.int32)
    client0 = clients.to(torch.int32)
    down, comp_total, comp_serving, up, cs_total, cs_busy = _station_counts(
        phase0, client0, n)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    def f64(x):
        return torch.as_tensor(x, dtype=DTYPE, device=dev)

    return EventState(
        t=f64(0.0), round=i32(0), seq_ctr=i32(0),
        client=client0, phase=phase0,
        finish=torch.where(active, svc, torch.inf),
        seq=torch.zeros(m_max, dtype=torch.int32, device=dev),
        disp_round=torch.zeros(m_max, dtype=torch.int32, device=dev),
        warmup=i32(warmup), cap=i32(cap), t_cap=f64(t_cap),
        t0=f64(0.0), t1=f64(0.0),
        delay_sum=torch.zeros(n, dtype=DTYPE, device=dev),
        delay_cnt=torch.zeros(n, dtype=torch.int32, device=dev),
        energy=f64(0.0),
        occ_int=torch.zeros(3 * n + 1, dtype=DTYPE, device=dev),
        occ=torch.cat([down, comp_total, up, cs_total[None]]),
        serving=comp_serving, cs_busy=cs_busy)


def stack_lanes(trees):
    """Leaf-wise stack of per-lane ``NamedTuple``s (``NetworkParams``,
    ``EventState``, ``PowerProfile``, ...) onto a leading lane axis;
    ``None`` leaves stay ``None``."""
    trees = list(trees)
    if not trees:
        raise ValueError("need at least one lane")
    first = trees[0]
    return type(first)(*[
        None if leaf is None else torch.stack([t[i] for t in trees])
        for i, leaf in enumerate(first)])


def lane(tree, i: int):
    """Lane ``i`` of a lane-stacked ``NamedTuple``."""
    return type(tree)(*[None if leaf is None else leaf[i] for leaf in tree])


# ---------------------------------------------------------------------------
# EventState-level step: statistics in PyTorch around the table transition
# ---------------------------------------------------------------------------

def _lane_stats(st, t_new, c, is_update, delay, pw, n: int):
    """Statistics over the sojourn ending at this event, per lane — the
    reference engine's accumulation with the lane axis written out."""
    K = t_new.shape[0]
    lanes = torch.arange(K, device=t_new.device)
    measure = (st.round >= st.warmup) & (st.round < st.cap)
    dt_eff = torch.where(
        measure,
        torch.clamp_min(torch.minimum(t_new, st.t_cap)
                        - torch.minimum(st.t, st.t_cap), 0.0),
        0.0)
    occ_int = st.occ_int + dt_eff[:, None] * st.occ
    energy = st.energy
    if pw is not None:
        # the reference engine's power sum and energy step round as fused
        # multiply-adds (see numerics.fma); cs_busy is 0/1, so its product
        # is exact and a plain add rounds the same
        p_w = seqsum(fma(pw.P_d, st.occ[:, :n],
                         fma(pw.P_u, st.occ[:, 2 * n:3 * n],
                             pw.P_c * st.serving)))
        if pw.P_cs is not None:
            p_w = p_w + pw.P_cs * st.cs_busy
        energy = fma(dt_eff, p_w, energy)
    upd_measured = is_update & measure
    cl = c.long()
    delay_sum = st.delay_sum.clone()
    delay_sum[lanes, cl] = st.delay_sum[lanes, cl] + torch.where(
        upd_measured, delay.to(DTYPE), 0.0)
    delay_cnt = st.delay_cnt.clone()
    delay_cnt[lanes, cl] = (st.delay_cnt[lanes, cl]
                            + upd_measured.to(torch.int32))
    return occ_int, energy, delay_sum, delay_cnt


def step_event_lanes(params, state, blk, *, table_step,
                     distribution: str = "exponential", power=None):
    """One event for every lane: ``state`` leaves carry a leading lane axis
    ``[K, ...]``, ``params``/``power`` leaves ``[K, n]`` (scalars ``[K]``),
    ``blk`` one :class:`repro_torch.core.events.EventBlocks` row per lane.
    ``table_step`` is the CUDA kernel's wrapper
    :func:`repro_torch.kernels.events.event_step_tables` or its plain
    version.
    Returns ``(EventState, EventOut)``."""
    n = params.p.shape[-1]
    has_cs = params.mu_cs is not None
    law = get_law(distribution)
    one = torch.ones((), dtype=DTYPE, device=state.finish.device)
    # the unit parts at unit rate: the kernel rescales them by the
    # completing client's rate, e / mu[c] (the law's own unit_apply)
    e_up = law.unit_apply(blk.up, one)
    e_comp = law.unit_apply(blk.comp, one)
    svc_cs = blk.svc_cs if has_cs else torch.zeros_like(blk.svc_down)
    fscal = torch.stack([e_up, e_comp, blk.svc_down, svc_cs], dim=-1)
    iscal = torch.stack([blk.c_new.to(torch.int32), state.seq_ctr,
                         state.round], dim=-1).to(torch.int32)
    finish, phase, client, seq, disp, t_col, int_col = table_step(
        state.finish, state.phase, state.client, state.seq, state.disp_round,
        params.mu_c, params.mu_u, fscal, iscal, has_cs=has_cs)
    t_new = t_col[:, 0]
    c = int_col[:, 1]
    is_update = int_col[:, 2] > 0
    delay = int_col[:, 3]
    seq_ctr = int_col[:, 4]
    new_round = int_col[:, 5]
    ph_pre = int_col[:, 6]
    do_comp = int_col[:, 7] > 0
    do_cs = int_col[:, 8] > 0

    occ_int, energy, delay_sum, delay_cnt = _lane_stats(
        state, t_new, c, is_update, delay, power, n)

    # O(1) maintenance of the occupancy carries: slot j moved stations;
    # the FIFO promotions stay within theirs and only flip busy indicators
    is_comp = ph_pre == COMP_SERV
    is_down = ph_pre == DOWN
    is_cs = ph_pre == CS_SERV
    phase_j = torch.where(is_down, COMP_WAIT, torch.where(
        is_comp, UP, torch.where(is_update, DOWN, CS_WAIT)))
    client_j = torch.where(is_update, iscal[:, 0], c)
    stations = torch.arange(3 * n + 1, device=t_new.device)
    occ_new = (state.occ
               + (stations[None, :] == _station_index(
                   phase_j, client_j, n)[:, None]).to(DTYPE)
               - (stations[None, :] == _station_index(
                   ph_pre, c, n)[:, None]).to(DTYPE))
    delta_srv = do_comp.to(DTYPE) - is_comp.to(DTYPE)
    serving_new = state.serving + torch.where(
        torch.arange(n, device=t_new.device)[None, :] == c[:, None],
        delta_srv[:, None], 0.0)
    cs_busy_new = ((state.cs_busy & ~is_cs) | do_cs if has_cs
                   else state.cs_busy)
    t0 = torch.where(is_update & (new_round == state.warmup), t_new, state.t0)
    t1 = torch.where(is_update & (new_round == state.cap), t_new, state.t1)

    new_state = EventState(
        t=t_new, round=new_round, seq_ctr=seq_ctr, client=client,
        phase=phase, finish=finish, seq=seq, disp_round=disp,
        warmup=state.warmup, cap=state.cap, t_cap=state.t_cap, t0=t0, t1=t1,
        delay_sum=delay_sum, delay_cnt=delay_cnt, energy=energy,
        occ_int=occ_int, occ=occ_new, serving=serving_new,
        cs_busy=cs_busy_new)
    out = EventOut(is_update=is_update, time=t_new, slot=int_col[:, 0],
                     client=c, delay=delay)
    return new_state, out


def step_event_block(params: NetworkParams, state: EventState,
                     blk: EventBlocks, *, distribution: str = "exponential",
                     power=None, backend: str = "batched"
                     ) -> tuple[EventState, EventOut]:
    """One event per lane with its randomness pre-resolved in ``blk``.

    ``backend="kernel"`` runs the table transition in the CUDA event kernel
    (its plain version for CPU tensors); ``"batched"``/``"reference"`` run
    the plain PyTorch transition; both go through :func:`step_event_lanes`.
    """
    from ..kernels.events import event_step_tables, event_step_tables_plain

    table_step = (event_step_tables if backend == "kernel"
                  else event_step_tables_plain)
    return step_event_lanes(params, state, blk, table_step=table_step,
                            distribution=distribution, power=power)


def run_event_blocks(params: NetworkParams, state: EventState,
                     blocks: EventBlocks, *,
                     distribution: str = "exponential", power=None,
                     backend: str = "batched") -> EventState:
    """Advance every lane by one event per row of ``blocks`` (leaves
    ``[events, K]``) through :func:`step_event_block`."""
    for i in range(blocks.c_new.shape[0]):
        blk = EventBlocks(*[None if x is None else x[i] for x in blocks])
        state, _ = step_event_block(params, state, blk,
                                    distribution=distribution, power=power,
                                    backend=backend)
    return state


def step_event(params: NetworkParams, state: EventState, generators, *,
               distribution: str = "exponential", power=None,
               backend: str = "batched") -> tuple[EventState, EventOut]:
    """Advance every lane by exactly one event: a one-event block draw from
    each lane's generator followed by :func:`step_event_block`."""
    blk = stack_blocks([draw_event_blocks(lane(params, i), g, 1,
                                          distribution=distribution)
                        for i, g in enumerate(generators)])
    blk = EventBlocks(*[None if x is None else x[0] for x in blk])
    return step_event_block(params, state, blk, distribution=distribution,
                            power=power, backend=backend)


def stack_blocks(blocks) -> EventBlocks:
    """Per-lane ``[events]`` blocks -> one ``[events, K]`` block."""
    blocks = list(blocks)
    return EventBlocks(*[
        None if leaf is None else torch.stack([b[i] for b in blocks], dim=1)
        for i, leaf in enumerate(blocks[0])])


# ---------------------------------------------------------------------------
# stationary statistics (device analogue of AsyncNetworkSim.run)
# ---------------------------------------------------------------------------

def finalize_stats(st: EventState) -> EventStats:
    """Stationary statistics from a final state (any leading lane axes)."""
    updates = torch.minimum(torch.clamp_min(st.round, 0), st.cap) - st.warmup
    horizon = torch.where(st.round >= st.cap, st.t1 - st.t0, st.t - st.t0)
    mean_delay = torch.where(st.delay_cnt > 0,
                             st.delay_sum / torch.clamp_min(st.delay_cnt, 1),
                             0.0)
    h = torch.clamp_min(horizon, 1e-12)
    return EventStats(
        updates=updates, time=horizon,
        throughput=torch.where(horizon > 0, updates / h, 0.0),
        mean_delay=mean_delay, delay_counts=st.delay_cnt, energy=st.energy,
        mean_queue_counts=st.occ_int / h[..., None])


def unpad_stats(stats: EventStats, n: int) -> EventStats:
    """Strip the padded-``n`` rows: per-client arrays cut to ``n`` and the
    ``[3 n_max + 1]`` occupancy re-packed into the ``[3n + 1]`` layout."""
    nm = (stats.mean_queue_counts.shape[-1] - 1) // 3
    occ = stats.mean_queue_counts
    return stats._replace(
        mean_delay=stats.mean_delay[..., :n],
        delay_counts=stats.delay_counts[..., :n],
        mean_queue_counts=torch.cat(
            [occ[..., 0:n], occ[..., nm:nm + n],
             occ[..., 2 * nm:2 * nm + n], occ[..., 3 * nm:]], dim=-1))


def simulate_stats(params: NetworkParams, m, num_updates: int, *,
                   warmup: int = 0,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0, distribution: str = "exponential",
                   power=None, m_max: Optional[int] = None,
                   backend: Optional[str] = None) -> EventStats:
    """Stationary statistics over ``num_updates`` rounds of one lane.

    Mirrors :meth:`AsyncNetworkSim.run`: statistics over the update-count
    window ``[warmup, warmup + num_updates)``.  The randomness comes from
    ``generator`` (default: a fresh one on the params' device seeded with
    ``seed``).  ``backend`` picks the table transition
    (:mod:`repro_torch.sim.backend`).
    """
    from ..sim.batched_events import run_lanes
    from ..sim.backend import resolve_backend

    get_law(distribution)  # eager: unknown laws fail listing the options
    if generator is None:
        generator = torch.Generator(device=params.device).manual_seed(seed)
    m_max = int(m) if m_max is None else m_max
    lanes = stack_lanes([params])
    pw = None if power is None else stack_lanes([power])
    stats = run_lanes(lanes, [int(m)], [generator], int(num_updates),
                      warmup=int(warmup), distribution=distribution,
                      m_max=m_max, power=pw,
                      backend=resolve_backend(backend))
    return lane(stats, 0)
