"""Device-resident event engine for the Generalized AsyncSGD closed network
(port of ``repro.core.events``, per-client half).

The state is a fixed-size in-flight task table per lane (``[K, m_max]``:
phase, owning client, FIFO sequence, dispatch round and the absolute
completion clock of each task) plus O(1)-updated occupancy carries and the
statistics of the update-count window ``[warmup, cap)``.  One event is one
service completion: the argmin over the clocks, the phase promotion or
re-dispatch of the completed slot, and the FIFO promotions — the table
transition — followed by the event's statistics and occupancy carries,
:func:`replay_event`.  The lane steps run both for one event per call or
up to ``chunk`` per call, a megastep: on the ``"kernel"`` backend the CUDA
lane kernel of :mod:`repro_torch.kernels.events` retires its events with
their statistics in one launch; their plain versions here
(:func:`event_step_lanes_plain`, :func:`megastep_lanes_plain`) run the
plain transition, then :func:`replay_event` in PyTorch event by event.  Every
route does the same float operations in the same order: megasteps are
bitwise the same trajectory as single steps, and the kernel bitwise the
plain version.  :func:`next_update` runs each lane to its next model
update.

Randomness is separated from the state: every per-event draw is
state-independent and is drawn up front, for many events at once, as
:class:`EventBlocks` from each lane's key (:mod:`repro_torch.core.prng`,
bitwise ``jax.random``): the serial key chain and every hash word of a
block come from one launch of the key-chain kernel for all lanes
(:mod:`repro_torch.kernels.threefry`), and an :class:`EventStream` hands
each lane its events in order.  The same key gives the JAX package's
draws: its chain, routing draws and integers exactly, its services within
1–3 ulps (XLA's expansions of ``log1p`` and ``erf_inv``, rounded step by
step, :mod:`repro_torch.core.prng`).  An
injected-blocks path (blocks drawn by the JAX package) feeds the same
cursor.  The state carries no key: :func:`init_state` draws from a seed
key and the events from :func:`event_key` of it.  The uplink and
computation services are stored as the timing law's rate-free parts and
every route applies the completing client's rate in the law's form
(:func:`repro_torch.scenario.laws.apply_rate`): ``x / mu`` for the
exponential and deterministic laws, ``x / (f mu)`` for the
hyperexponential, ``exp((z - log mu) - 0.5)`` for the lognormal.

Every state leaf carries a leading lane axis ``[K, ...]`` in the step;
:func:`init_state` builds one lane and :func:`stack_lanes` stacks them.

The class-aggregated engine (:class:`ClassEventState`, over
:class:`repro_torch.core.buzen.ClassParams`) runs the same dynamics with
each task owned by a ``(class, member)`` pair: the task table and the
FIFO promotions are those of the expanded network, while the statistics
and occupancy carries are per class, so a lane is O(#classes) wide at any
population.  It shares the draw cursor, the statistics replay, the event
loop (:func:`run_events`) and :func:`finalize_stats` with the per-client
engine; its table transition has no kernel (nor has the JAX package's).
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import math
from typing import NamedTuple, Optional

import torch

from ..kernels import threefry
from ..obs.rings import event_ring_append
from ..scenario.laws import form_width, get_law, law_form
from . import prng
from .buzen import ClassParams, NetworkParams
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

DRAW_EVENTS = 1024  # events drawn per block and lane (bounds block memory)


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


class UpdateOut(NamedTuple):
    """Result of :func:`next_update` (one model update per lane)."""

    time: torch.Tensor
    slot: torch.Tensor
    client: torch.Tensor
    delay: torch.Tensor
    steps: torch.Tensor   # events consumed to reach this update


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
    the law's unit parts and rate-applied inside the step (a ``[events]``
    leaf, or ``[events, 2]`` for the hyperexponential's pair of branch
    uniform and unit exponential).
    """

    c_new: torch.Tensor     # routed client (class, for the class engine)
    svc_down: torch.Tensor  # downlink service of the re-dispatched task
    up: torch.Tensor        # uplink unit part
    comp: torch.Tensor      # computation unit part
    svc_cs: Optional[torch.Tensor] = None  # CS service; None without CS
    member: Optional[torch.Tensor] = None  # routed member (class engine)


class ClassEventState(NamedTuple):
    """Carry of the class-aggregated event loop: the task table of
    :class:`EventState` with each task owned by a ``(cls, member)`` pair,
    and per-class statistics (members of a class are exchangeable)."""

    t: torch.Tensor
    round: torch.Tensor
    seq_ctr: torch.Tensor
    cls: torch.Tensor        # [m_max] owning class of each task
    member: torch.Tensor     # [m_max] member index within the class
    phase: torch.Tensor
    finish: torch.Tensor
    seq: torch.Tensor
    disp_round: torch.Tensor
    warmup: torch.Tensor
    cap: torch.Tensor
    t_cap: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    delay_sum: torch.Tensor  # [C] per-class relative-delay sums
    delay_cnt: torch.Tensor  # [C]
    energy: torch.Tensor
    occ_int: torch.Tensor    # [3C+1] time-weighted per-class occupancy
    occ: torch.Tensor        # [3C+1] current per-class occupancy
    serving: torch.Tensor    # [C] busy compute servers of each class
    cs_busy: torch.Tensor


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


# the subkeys of an event's 6-way split (the JAX step's order): the next
# key, then the uplink, routing, downlink, computation and CS draws
_UP, _ROUTE, _SVC, _COMP, _CS = 1, 2, 3, 4, 5


def block_paths(distribution: str, has_cs: bool, classes: bool = False):
    """The hash paths (:mod:`repro_torch.kernels.threefry`) of one event's
    draws, and the slices of them that each draw reads: routing (one
    uniform; the class engine's 2-way split into the class uniform and the
    member's two ``randint`` words), then the law's paths from the
    downlink, uplink, computation and (with CS) CS subkeys."""
    law = get_law(distribution)
    route = ([(_ROUTE, 0, 0), (_ROUTE, 1, 0, 0), (_ROUTE, 1, 1, 0)]
             if classes else [(_ROUTE, 0)])
    paths, groups = list(route), {"route": slice(0, len(route))}
    for name, s in (("svc", _SVC), ("up", _UP), ("comp", _COMP)) + (
            (("cs", _CS),) if has_cs else ()):
        groups[name] = slice(len(paths), len(paths) + len(law.paths))
        paths += [(s,) + p for p in law.paths]
    return paths, groups


def blocks_from_words(lane_params, words: torch.Tensor, *,
                      distribution: str = "exponential",
                      route_prefixes=None) -> EventBlocks:
    """The lanes' :class:`EventBlocks` (``[L, events]`` leaves) from the
    hash words ``[L, events, P, 2]`` of :func:`block_paths`: what the JAX
    package's ``draw_event_blocks`` (``draw_class_event_blocks`` for
    :class:`ClassParams`) resolves from the same keys.  ``lane_params`` is
    a list of one lane's parameters per lane; the law's conversions run
    once for every lane and draw (elementwise, so a lane's values do not
    depend on the others), the routing lane by lane."""
    law = get_law(distribution)
    first = lane_params[0]
    classes = isinstance(first, ClassParams)
    has_cs = first.mu_cs is not None
    _, g = block_paths(distribution, has_cs, classes)
    names = ["svc", "up", "comp"] + (["cs"] if has_cs else [])
    unit = dict(zip(names, law.unit_words(
        torch.stack([words[:, :, g[k]] for k in names], 2)).unbind(2)))
    rw = words[:, :, g["route"]]
    u = prng.uniform_words(rw[:, :, 0])
    if route_prefixes is None:
        route_prefixes = [None] * len(lane_params)
    routed = [_route_class(prm.mass, prm.count, u[i], rw[i, :, 1],
                           rw[i, :, 2], pre) if classes
              else (_route_client(prm.p, u[i], prm.active_count, pre), None)
              for i, (prm, pre) in enumerate(zip(lane_params,
                                                 route_prefixes))]
    c_new = torch.stack([r[0] for r in routed])
    member = torch.stack([r[1] for r in routed]) if classes else None
    mu_d = torch.stack([prm.mu_d for prm in lane_params])
    svc_cs = None
    if has_cs:
        mu_cs = torch.stack([prm.mu_cs for prm in lane_params])
        svc_cs = law.unit_apply(unit["cs"],
                                mu_cs[:, None].expand(c_new.shape))
    return EventBlocks(c_new=c_new,
                       svc_down=law.unit_apply(unit["svc"],
                                               mu_d.gather(1, c_new)),
                       up=unit["up"], comp=unit["comp"], svc_cs=svc_cs,
                       member=member)


def draw_event_blocks(params: NetworkParams, key: torch.Tensor, chunk: int,
                      *, distribution: str = "exponential",
                      route_prefix: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, EventBlocks]:
    """Draw the randomness of ``chunk`` consecutive events of one lane from
    its key ``[2]``, as the JAX package's ``draw_event_blocks`` does:
    ``(chain [chunk, 2], blocks)``, ``chain[i]`` the key after ``i + 1``
    events.  The key chain and the hash words come from one launch of the
    key-chain kernel (its plain version for CPU keys)."""
    paths, _ = block_paths(distribution, params.mu_cs is not None,
                           isinstance(params, ClassParams))
    chain, words = threefry.chain_words(
        key.reshape(1, 2), chunk, threefry.paths_tensor(paths, key.device))
    blk = blocks_from_words([params], words, distribution=distribution,
                            route_prefixes=[route_prefix])
    return chain[0], lane(blk, 0)


def _route_class(mass: torch.Tensor, count: torch.Tensor, u: torch.Tensor,
                 high: torch.Tensor, low: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None):
    """Dispatch routing of the class engine: ``(class, member)`` per event.
    The class by inverse CDF of one uniform ``u`` on the sequential prefix
    of the class masses (as :func:`_route_client`; count-0 classes repeat
    the total and are never hit), clipped to the last class with a nonzero
    count; the member by ``randint(0, max(count[class], 1))`` on its two
    hash words ``high``, ``low`` (:func:`prng.randint_words`).  Bitwise
    invariant to trailing class padding."""
    if prefix is None:
        prefix = seqcumsum(mass)
    idx = torch.searchsorted(prefix, u * prefix[-1], right=True)
    cum = seqcumsum(count)
    c_last = torch.searchsorted(cum, cum[-1:] - 1, right=True)
    c = torch.minimum(idx, c_last)
    mb = prng.randint_words(high, low, 0, torch.clamp_min(count[c], 1))
    return c, mb


def draw_class_event_blocks(classes: ClassParams, key: torch.Tensor,
                            chunk: int, *,
                            distribution: str = "exponential",
                            route_prefix: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, EventBlocks]:
    """The class engine's :func:`draw_event_blocks`: the routing draw
    resolves a ``(class, member)`` pair per event (``c_new``, ``member``),
    the downlink service comes from the routed class's rate."""
    return draw_event_blocks(classes, key, chunk, distribution=distribution,
                             route_prefix=route_prefix)


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
    # contract: allow(raw-reduction): 0/1 indicator count over the task table — exact small-integer f64 under any association, and the table axis is m_max (never padded-n)
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


def event_key(key: torch.Tensor) -> torch.Tensor:
    """The key a lane's events draw from after :func:`init_state` (or
    :func:`init_class_state`) drew its initial tasks from ``key`` (``[...,
    2]``): the first key of their 3-way split, the key the JAX package's
    state carries (``state.key``)."""
    return prng.split(key, 3)[..., 0, :]


def init_state(params: NetworkParams, m, key: torch.Tensor, *,
               m_max: Optional[int] = None,
               distribution: str = "exponential", warmup=0, cap=_NO_CAP,
               t_cap=math.inf) -> EventState:
    """One lane's initial state: ``m`` tasks dispatched uniformly at random
    into the downlink servers at ``t = 0`` (Section 5.3.3); slots ``>= m``
    of the ``m_max`` table are inactive.  Under the padded-``n`` convention
    only real clients are drawn.  The draws are the JAX package's from the
    same ``key`` (a 3-way split, ``randint`` and the law's draw); the
    events then draw from :func:`event_key` of it."""
    law = get_law(distribution)
    m_max = int(m) if m_max is None else m_max
    ks = prng.split(key, 3)
    clients = prng.randint(ks[1], (m_max,), 0, int(params.active_count))
    svc = law.device_draw(ks[2], params.mu_d[clients], (m_max,))
    return EventState(client=clients.to(torch.int32), **_init_leaves(
        clients, svc, m, params.n, warmup, cap, t_cap))


def init_class_state(classes: ClassParams, m, key: torch.Tensor, *,
                     m_max: Optional[int] = None,
                     distribution: str = "exponential", warmup=0,
                     cap=_NO_CAP, t_cap=math.inf) -> ClassEventState:
    """The class engine's initial state: ``m`` tasks dispatched uniformly
    over the ``n_total`` members at ``t = 0``.  The member is drawn as a
    flat index in ``[0, n_total)`` and split into ``(class, member)``
    against the sequential count prefix: the distribution of
    :func:`init_state` on the expanded network, bitwise invariant to
    trailing class padding.  The draws are the JAX package's from
    ``key``."""
    law = get_law(distribution)
    m_max = int(m) if m_max is None else m_max
    ks = prng.split(key, 3)
    cum = seqcumsum(classes.count)
    idx = prng.randint(ks[1], (m_max,), 0, int(cum[-1]))
    cls = torch.searchsorted(cum, idx, right=True)
    member = idx - torch.where(cls > 0, cum[(cls - 1).clamp_min(0)], 0)
    svc = law.device_draw(ks[2], classes.mu_d[cls], (m_max,))
    return ClassEventState(
        cls=cls.to(torch.int32), member=member.to(torch.int32),
        **_init_leaves(cls, svc, m, classes.C, warmup, cap, t_cap))


def _init_leaves(owner, svc, m, n: int, warmup, cap, t_cap) -> dict:
    """The leaves both engines share at ``t = 0``: ``owner [m_max]`` (a
    client, or a class) and the downlink services ``svc`` of the first
    ``m`` slots; statistics over ``n`` owners."""
    dev = owner.device
    m_max = owner.shape[0]
    active = torch.arange(m_max, device=dev) < m
    phase0 = torch.where(active, DOWN, INACTIVE).to(torch.int32)
    down, comp_total, comp_serving, up, cs_total, cs_busy = _station_counts(
        phase0, owner, n)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    def f64(x):
        return torch.as_tensor(x, dtype=DTYPE, device=dev)

    return dict(
        t=f64(0.0), round=i32(0), seq_ctr=i32(0), phase=phase0,
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
# the draw cursor: each lane's pre-drawn randomness, consumed event by event
# ---------------------------------------------------------------------------

def _unit_scalars(blk: EventBlocks, distribution: str):
    """The kernels' per-event scalars of ``blk``: ``[..., W]`` float64
    ``[x_up, x_comp, svc_down, svc_cs]``, then for the ``"h2"`` form the
    branch factors ``[f_up, f_comp]`` (``W = 6``; else ``W = 4``), with the
    unit parts split by the law's ``unit_split`` (the kernels apply the
    completing client's rate, :func:`repro_torch.scenario.laws.apply_rate`),
    the routed clients (classes) as int32, and the routed members as int32
    (``None`` for the per-client engine)."""
    law = get_law(distribution)
    x_up, f_up = law.unit_split(blk.up)
    x_comp, f_comp = law.unit_split(blk.comp)
    svc_cs = (blk.svc_cs if blk.svc_cs is not None
              else torch.zeros_like(blk.svc_down))
    cols = [x_up, x_comp, blk.svc_down, svc_cs]
    if f_up is not None:
        cols += [f_up, f_comp]
    fs = torch.stack(cols, dim=-1)
    mb = None if blk.member is None else blk.member.to(torch.int32)
    return fs, blk.c_new.to(torch.int32), mb


class EventStream:
    """Per-lane draw cursor over the events' pre-drawn randomness.

    Each lane draws from its own key chain (``keys [L, 2]``, the key each
    lane's next event draws from: :func:`event_key` of its seed key) in
    blocks of ``block`` events (the last block cut so that no more than
    ``total`` events are drawn), one launch of the key-chain kernel for
    every lane a block.  A lane's events are the JAX package's for the same
    key, whatever ``block`` and ``total``: a step that consumes one event
    and a megastep that consumes ``chunk`` read the same numbers, a
    megastep may straddle two blocks, and each lane moves on by exactly the
    events it retired (:meth:`advance`); :meth:`keys` is each lane's key
    after them, JAX's carried ``state.key``.  :meth:`from_blocks` feeds the
    cursor blocks drawn elsewhere (e.g. by the JAX package, converted by
    :mod:`repro_torch.convert`) instead.  Lanes of :class:`ClassParams`
    draw ``(class, member)`` pairs.
    """

    def __init__(self, lane_params, keys, *,
                 distribution: str = "exponential",
                 block: int = DRAW_EVENTS, total: Optional[int] = None):
        self._params = list(lane_params)
        if keys is not None and not torch.is_tensor(keys):
            keys = torch.stack(list(keys))
        n_keys = 0 if keys is None else keys.shape[0]
        if n_keys != len(self._params):
            raise ValueError(f"got {n_keys} keys for {len(self._params)} "
                             "lanes")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self._prefix = [seqcumsum(prm.mass if isinstance(prm, ClassParams)
                                  else prm.p) for prm in self._params]
        self._dist = distribution
        self.form = get_law(distribution).form  # the steps' rate form
        self._block = int(block)
        self._total = total
        self._drawn = 0  # events drawn so far, the same for every lane
        self._fs = self._cn = self._mb = None
        self._off = [0] * len(self._params)
        # the key before the buffer's first event, and after each of its
        # events; None for injected blocks
        self._key0 = keys
        self._chain = None
        self._paths = None
        if self._params:
            first = self._params[0]
            self._paths = threefry.paths_tensor(
                block_paths(distribution, first.mu_cs is not None,
                            isinstance(first, ClassParams))[0],
                keys.device)

    @classmethod
    def from_blocks(cls, blocks: EventBlocks, *,
                    distribution: str = "exponential") -> "EventStream":
        """A cursor over the ``[events, K]`` leaves of ``blocks`` alone."""
        self = cls([], None, distribution=distribution)
        fs, cn, mb = _unit_scalars(blocks, distribution)
        self._fs, self._cn = fs.transpose(0, 1), cn.transpose(0, 1)
        self._mb = None if mb is None else mb.transpose(0, 1)
        self._drawn = self._total = fs.shape[0]
        self._off = [0] * fs.shape[1]
        return self

    def _width(self) -> int:
        return 0 if self._cn is None else self._cn.shape[1]

    def _draw(self) -> bool:
        """Append one block to every lane; ``False`` when none is left."""
        size = self._block
        if self._total is not None:
            size = min(size, self._total - self._drawn)
        if size <= 0 or not self._params:
            return False
        start = (self._key0 if self._chain is None or not self._width()
                 else self._chain[:, -1])
        chain, words = threefry.chain_words(start, size, self._paths)
        fs, cn, mb = _unit_scalars(
            blocks_from_words(self._params, words, distribution=self._dist,
                              route_prefixes=self._prefix), self._dist)
        if self._cn is not None:
            # drop what every lane has consumed
            lo = min(self._off)
            self._off = [o - lo for o in self._off]
            if lo:
                self._key0 = self._chain[:, lo - 1]
            fs = torch.cat([self._fs[:, lo:], fs], dim=1)
            cn = torch.cat([self._cn[:, lo:], cn], dim=1)
            chain = torch.cat([self._chain[:, lo:], chain], dim=1)
            if mb is not None:
                mb = torch.cat([self._mb[:, lo:], mb], dim=1)
        self._fs, self._cn, self._mb, self._chain = fs, cn, mb, chain
        self._drawn += size
        return True

    def keys(self) -> torch.Tensor:
        """``[L, 2]``: each lane's key after the events it has consumed
        (the JAX state's ``key``)."""
        if self._key0 is None:
            raise ValueError("a stream over injected blocks has no keys")
        if self._chain is None:
            return self._key0
        off = torch.as_tensor(self._off, device=self._chain.device)
        at = self._chain[torch.arange(len(self._off),
                                      device=off.device),
                         (off - 1).clamp_min(0)]
        return torch.where((off > 0)[:, None], at, self._key0)

    def window(self, chunk: int):
        """The next ``chunk`` events of every lane from its cursor:
        ``(fs [K, chunk, W], c_new [K, chunk], member [K, chunk])`` (see
        :func:`_unit_scalars`; ``member`` is ``None`` for per-client
        lanes).  Past the end of a finite stream the window is
        zero-filled: those events must be masked."""
        while self._width() < max(self._off) + chunk and self._draw():
            pass
        off = self._off
        short = max(off) + chunk - self._width()
        idx = None
        if min(off) != max(off):
            idx = (torch.as_tensor(off, device=self._cn.device)[:, None]
                   + torch.arange(chunk, device=self._cn.device)[None, :])

        def cut(x):
            if x is None:
                return None
            if short > 0:
                x = torch.cat([x, x.new_zeros((x.shape[0], short)
                                              + x.shape[2:])], 1)
            if idx is None:
                return x[:, off[0]:off[0] + chunk]
            return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                            .expand((-1, -1) + x.shape[2:]))

        return cut(self._fs), cut(self._cn), cut(self._mb)

    def advance(self, taken) -> None:
        """Move lane ``k``'s cursor by ``taken[k]`` events (an ``int``
        moves every lane)."""
        if isinstance(taken, int):
            taken = [taken] * len(self._off)
        self._off = [o + int(t) for o, t in zip(self._off, taken)]
        if max(self._off) > self._width():
            raise RuntimeError("the event stream ran out: a lane retired "
                               "more events than were drawn")


# ---------------------------------------------------------------------------
# EventState-level steps: the statistics replay and the lane steps
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


_TABLES = ("finish", "phase", "client", "seq", "disp_round")


def replay_event(state: EventState, t_new, desc, c_new, *, n: int,
                 has_cs: bool, power=None, keep=None) -> EventState:
    """One event's statistics and O(1) carries from its descriptors.

    ``t_new [K]`` and ``desc [K, >= 9]`` (``[j, c, is_update, delay,
    seq_ctr', round', ph_pre, do_comp, do_cs]``) are what a table
    transition reported for the event, ``c_new [K]`` its routed client.
    Updates the clock, counters, statistics window and occupancy carries;
    the table leaves pass through (the transition owns them).  Where
    ``keep [K]`` is given and false, every leaf stays as it was.  The
    plain lane steps replay their events through here; the CUDA lane
    kernels do the same operations in the same order on the card
    (``replay_one`` in ``kernels/csrc/events.cu``).
    """
    c = desc[:, 1]
    is_update = desc[:, 2] > 0
    new_round = desc[:, 5]
    ph_pre = desc[:, 6]
    do_comp = desc[:, 7] > 0
    do_cs = desc[:, 8] > 0

    occ_int, energy, delay_sum, delay_cnt = _lane_stats(
        state, t_new, c, is_update, desc[:, 3], power, n)

    # O(1) maintenance of the occupancy carries: slot j moved stations;
    # the FIFO promotions stay within theirs and only flip busy indicators
    is_comp = ph_pre == COMP_SERV
    is_cs = ph_pre == CS_SERV
    stations = torch.arange(3 * n + 1, device=t_new.device)
    occ_new = (state.occ
               + (stations[None, :] == _moved_to(desc, c_new, n)[:, None])
               .to(DTYPE)
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

    new = dict(t=t_new, round=new_round, seq_ctr=desc[:, 4], t0=t0, t1=t1,
               delay_sum=delay_sum, delay_cnt=delay_cnt, energy=energy,
               occ_int=occ_int, occ=occ_new, serving=serving_new,
               cs_busy=cs_busy_new)
    if keep is not None:
        new = {k: _select(keep, v, getattr(state, k)) for k, v in new.items()}
    return state._replace(**new)


def _moved_to(desc, c_new, n: int):
    """The station each lane's event moved its task to, from the event's
    descriptors ``desc [K, >= 9]`` and routed client ``c_new [K]``: a
    downlink to the compute queue, a computation to the uplink, an update
    re-dispatches the slot to ``c_new``'s downlink, else the task joins
    the CS queue."""
    c, is_update, ph_pre = desc[:, 1], desc[:, 2] > 0, desc[:, 6]
    phase_j = torch.where(ph_pre == DOWN, COMP_WAIT, torch.where(
        ph_pre == COMP_SERV, UP, torch.where(is_update, DOWN, CS_WAIT)))
    return _station_index(phase_j, torch.where(is_update, c_new, c), n)


def ring_append_events(ring, t_new, desc, station_to, n: int, valid=None):
    """Append one event a lane to the lane-stacked event ``ring`` (in
    place; a no-op at capacity 0): the time ``t_new [K]``, the descriptors
    ``desc [K, >= 9]`` and the station the task moved to; ``valid [K]``
    gates the append per lane.  Reads, never writes, the engine's
    state."""
    ph = desc[:, 6]
    return event_ring_append(
        ring, time=t_new, station=_station_index(ph, desc[:, 1], n),
        station_to=station_to, kind=ph, slot=desc[:, 0], client=desc[:, 1],
        delay=desc[:, 3], update=desc[:, 2], valid=valid)


def _post_station(state, desc, n: int, owner: str = "client"):
    """The station of each lane's completed slot in the post-step tables
    ``state`` (``owner`` the table of the slot's client or class)."""
    j = desc[:, 0].long()
    lanes = torch.arange(j.shape[0], device=j.device)
    return _station_index(state.phase[lanes, j],
                          getattr(state, owner)[lanes, j], n)


def _select(keep, a, b):
    """Per lane ``a`` where ``keep [K]`` else ``b`` (any trailing axes)."""
    return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a, b)


def megastep_lanes_plain(params, state: EventState, fs, c_new, rem, *,
                         power=None, stop_on_update: bool = False,
                         donate: bool = False, law: str = "scale",
                         ring=None):
    """Up to ``chunk`` events per lane in PyTorch — the plain version of
    the CUDA lane steps
    (:func:`repro_torch.kernels.events.megastep_lanes`): the plain
    megastep transition, then :func:`replay_event` per kept event, in
    event order.  ``rem`` is an int, one int per lane or an int32 ``[K]``
    tensor; ``law`` the rate form of ``fs [K, chunk, W]``
    (:func:`repro_torch.scenario.laws.apply_rate`).  A lane-stacked event
    ``ring`` (:mod:`repro_torch.obs.rings`) gets each kept event, in
    place; a masked event neither writes it nor bumps its count.  Never
    reuses a donated buffer."""
    from ..kernels.events import megastep_tables_plain

    law = law_form(law)
    n = params.p.shape[-1]
    has_cs = params.mu_cs is not None
    K, chunk = c_new.shape
    dev = state.finish.device
    rem_t = (rem if isinstance(rem, torch.Tensor) else torch.as_tensor(
        [rem] * K if isinstance(rem, int) else list(rem), dtype=torch.int32,
        device=dev))
    iscal = torch.cat([state.seq_ctr[:, None], state.round[:, None],
                       rem_t[:, None], c_new], dim=1).to(torch.int32)
    *tables, t_mat, int_mat = megastep_tables_plain(
        state.finish, state.phase, state.client, state.seq, state.disp_round,
        params.mu_c, params.mu_u, fs.reshape(K, form_width(law) * chunk),
        iscal, has_cs=has_cs, chunk=chunk, stop_on_update=stop_on_update,
        law=law)
    D = int_mat.view(K, chunk, 10)
    keep_mat = D[..., 9] > 0
    if stop_on_update or isinstance(rem, torch.Tensor):
        # contract: allow(raw-reduction): boolean count over the chunk axis — exact integer arithmetic, never a padded client/class axis
        taken = keep_mat.sum(dim=1).tolist()  # data-dependent: ask
    else:
        taken = [min(max(int(r), 0), chunk)
                 for r in ([rem] * K if isinstance(rem, int) else rem)]
    st = state
    for i in range(max(taken, default=0)):
        # events past every lane's taken count change nothing
        keep = None if min(taken) > i else keep_mat[:, i]
        st = replay_event(st, t_mat[:, i], D[:, i], c_new[:, i], n=n,
                          has_cs=has_cs, power=power, keep=keep)
        if ring is not None:
            ring_append_events(ring, t_mat[:, i], D[:, i],
                               _moved_to(D[:, i], c_new[:, i], n), n,
                               valid=keep_mat[:, i])
    return st._replace(**dict(zip(_TABLES, tables))), t_mat, int_mat


def event_step_lanes_plain(params, state: EventState, fs, c_new, *,
                           power=None, keep=None, donate: bool = False,
                           law: str = "scale", ring=None):
    """One event per lane in PyTorch — the plain version of
    :func:`repro_torch.kernels.events.event_step_lanes`: the megastep of
    one event (:func:`megastep_lanes_plain`), kept where ``keep [K]``.
    Each kept event is appended to the lane-stacked event ``ring``, its
    destination read from the post-step table at the completed slot.
    Returns the new state, ``t_new [K, 1]`` and the nine descriptors ``[K,
    9]``."""
    rem = 1 if keep is None else keep.to(torch.int32)
    st, t_mat, int_mat = megastep_lanes_plain(
        params, state, fs[:, None], c_new[:, None], rem, power=power,
        law=law)
    if ring is not None:
        n = params.p.shape[-1]
        ring_append_events(ring, t_mat[:, 0], int_mat,
                           _post_station(st, int_mat, n), n, valid=keep)
    return st, t_mat, int_mat[:, :9]


def _lane_steps(backend: str):
    """``(single step, megastep)`` of a lane backend: the CUDA lane
    steps' wrappers for ``"kernel"`` (transition and statistics in one
    launch), their plain versions (the plain transition, then
    :func:`replay_event` per kept event) otherwise: ``"sharded"`` steps
    its lanes as ``"batched"`` does, as the JAX package's does."""
    if backend == "kernel":
        from ..kernels import events as ke

        return ke.event_step_lanes, ke.megastep_lanes
    return event_step_lanes_plain, megastep_lanes_plain


def _event_out(t_col, int_col) -> EventOut:
    """:class:`EventOut` from one event's ``t_new [K, 1]`` and
    descriptors ``[K, >= 9]``."""
    return EventOut(is_update=int_col[:, 2] > 0, time=t_col[:, 0],
                    slot=int_col[:, 0], client=int_col[:, 1],
                    delay=int_col[:, 3])


_CLASS_TABLES = ("finish", "phase", "cls", "member", "seq", "disp_round")


def step_class_event_lanes(classes, state: ClassEventState, fs, c_new,
                           member, *, power=None, keep=None,
                           law: str = "scale", ring=None):
    """One event for every lane of the class engine: ``state`` leaves
    ``[K, ...]``, ``classes``/``power`` leaves ``[K, C]`` (scalars
    ``[K]``), ``fs [K, W]``, ``c_new [K]`` and ``member [K]`` the event's
    scalars (of the rate form ``law``) and routed ``(class, member)``
    pairs.  The transition is
    :func:`repro_torch.kernels.events.class_step_tables_plain`, the
    statistics :func:`replay_event` over ``C`` owners.  Lanes where
    ``keep [K]`` is false stay as they were.  Each kept event is appended
    to the lane-stacked event ``ring`` (the class as its client, stations
    in the ``[3C+1]`` class layout).  Returns ``(ClassEventState,
    EventOut)`` (``client`` reports the completing task's class)."""
    from ..kernels.events import class_step_tables_plain

    C = classes.p.shape[-1]
    has_cs = classes.mu_cs is not None
    iscal = torch.stack([c_new, state.seq_ctr, state.round, member],
                        dim=-1).to(torch.int32)
    *tables, t_col, int_col = class_step_tables_plain(
        state.finish, state.phase, state.cls, state.member, state.seq,
        state.disp_round, classes.mu_c, classes.mu_u, fs, iscal,
        has_cs=has_cs, law=law)
    new_state = replay_event(state, t_col[:, 0], int_col, iscal[:, 0], n=C,
                             has_cs=has_cs, power=power, keep=keep)
    if keep is not None:
        tables = [_select(keep, a, getattr(state, k))
                  for k, a in zip(_CLASS_TABLES, tables)]
    new_state = new_state._replace(**dict(zip(_CLASS_TABLES, tables)))
    if ring is not None:
        ring_append_events(ring, t_col[:, 0], int_col,
                           _post_station(new_state, int_col, C, "cls"), C,
                           valid=keep)
    return new_state, _event_out(t_col, int_col)


def run_events(params: NetworkParams, state: EventState,
               stream: EventStream, num_events: int, *, chunk: int = 1,
               power=None, backend: str = "batched",
               ring=None) -> EventState:
    """Advance every lane by ``num_events`` events from ``stream``.

    ``chunk = 1`` runs one lane step per event (the event lane kernel
    under ``"kernel"``); ``chunk > 1`` runs ``ceil(num_events / chunk)``
    megasteps (the megastep lane kernel under ``"kernel"``), the events
    past ``num_events`` masked.  Both are bitwise the same trajectory.
    Under ``"kernel"`` each launch retires its events with their
    statistics; the first writes new buffers and the rest reuse them, so
    ``state`` itself is never written.  With :class:`ClassParams` lanes
    every event runs the class transition (:func:`step_class_event_lanes`),
    ``chunk`` events taken from the stream at a time.  The steps apply the
    rates in the stream's law's form (``stream.form``).  A lane-stacked
    event ``ring`` (:func:`repro_torch.obs.rings.event_ring_init`) gets
    every event, in place: under ``"kernel"`` the lane kernel writes it
    in the same launches; its ``count`` grows by ``num_events`` a lane.
    The statistics are bitwise those of a run without it.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    classes = isinstance(params, ClassParams)
    if not classes:
        step, megastep = _lane_steps(backend)
    elif backend == "kernel":
        raise ValueError(
            "the class-aggregated event engine has no kernel; pin "
            "backend='batched', 'reference' or 'sharded' for class lanes")
    law = stream.form
    done = 0
    owned = False  # whether state's buffers are this call's own
    while done < num_events:
        rem = min(chunk, num_events - done)
        fs, cn, mb = stream.window(chunk)
        if classes:
            for i in range(rem):
                state, _ = step_class_event_lanes(
                    params, state, fs[:, i], cn[:, i], mb[:, i], power=power,
                    law=law, ring=ring)
        elif chunk == 1:
            state = step(params, state, fs[:, 0], cn[:, 0], power=power,
                         donate=owned, law=law, ring=ring)[0]
        else:
            state = megastep(params, state, fs, cn, rem, power=power,
                             donate=owned, law=law, ring=ring)[0]
        owned = True
        stream.advance(rem)
        done += rem
    return state


def step_event_block(params: NetworkParams, state: EventState,
                     blk: EventBlocks, *, distribution: str = "exponential",
                     power=None, backend: str = "batched"
                     ) -> tuple[EventState, EventOut]:
    """One event per lane with its randomness pre-resolved in ``blk``
    (one row per lane).

    ``backend="kernel"`` runs the event lane kernel (its plain version for
    CPU tensors); ``"batched"``/``"reference"`` run the plain PyTorch
    transition and :func:`replay_event`.
    """
    fs, cn, _ = _unit_scalars(blk, distribution)
    state, t_col, int_col = _lane_steps(backend)[0](
        params, state, fs, cn, power=power, law=get_law(distribution).form)
    return state, _event_out(t_col, int_col)


def step_class_event_block(classes, state: ClassEventState,
                           blk: EventBlocks, *,
                           distribution: str = "exponential", power=None
                           ) -> tuple[ClassEventState, EventOut]:
    """The class engine's :func:`step_event_block`: one event per lane
    with its randomness (and routed member) pre-resolved in ``blk``."""
    fs, cn, mb = _unit_scalars(blk, distribution)
    return step_class_event_lanes(classes, state, fs, cn, mb, power=power,
                                  law=get_law(distribution).form)


def run_event_blocks(params: NetworkParams, state: EventState,
                     blocks: EventBlocks, *,
                     distribution: str = "exponential", power=None,
                     backend: str = "batched", chunk: int = 1) -> EventState:
    """Advance every lane by one event per row of ``blocks`` (leaves
    ``[events, K]``), in megasteps of ``chunk`` (:func:`run_events`)."""
    stream = EventStream.from_blocks(blocks, distribution=distribution)
    return run_events(params, state, stream, blocks.c_new.shape[0],
                      chunk=chunk, power=power, backend=backend)


def step_class_event(classes, state: ClassEventState, keys, *,
                     distribution: str = "exponential", power=None):
    """Advance every lane of the class engine by exactly one event drawn
    from its key (``keys [K, 2]``); returns ``(state, out, next keys)``."""
    nxt, blk = zip(*[draw_class_event_blocks(lane(classes, i), k, 1,
                                             distribution=distribution)
                     for i, k in enumerate(keys)])
    blk = EventBlocks(*[None if x is None else x[0]
                        for x in stack_blocks(blk)])
    state, out = step_class_event_block(classes, state, blk,
                                        distribution=distribution,
                                        power=power)
    return state, out, torch.stack([c[0] for c in nxt])


def step_event(params: NetworkParams, state: EventState, keys, *,
               distribution: str = "exponential", power=None,
               backend: str = "batched"):
    """Advance every lane by exactly one event: a one-event block drawn
    from each lane's key (``keys [K, 2]``, as the JAX step splits its
    state's key) followed by :func:`step_event_block`; returns ``(state,
    out, next keys)``."""
    nxt, blk = zip(*[draw_event_blocks(lane(params, i), k, 1,
                                       distribution=distribution)
                     for i, k in enumerate(keys)])
    blk = EventBlocks(*[None if x is None else x[0]
                        for x in stack_blocks(blk)])
    state, out = step_event_block(params, state, blk,
                                  distribution=distribution, power=power,
                                  backend=backend)
    return state, out, torch.stack([c[0] for c in nxt])


def next_update(params: NetworkParams, state: EventState,
                stream: EventStream, *, power=None,
                max_steps: Optional[int] = None,
                backend: Optional[str] = None, chunk: int = 1
                ) -> tuple[EventState, UpdateOut]:
    """Run every lane until its next model update (uplink completion, or CS
    completion with the CS station) or ``max_steps`` events.

    Port of the JAX package's ``next_update`` with the lane axis written
    out: ``state`` leaves ``[K, ...]``, the events drawn from ``stream``
    (each lane consumes exactly the events it retired).  ``max_steps``
    defaults to ``3 m_max + 8`` (``4 m_max + 8`` with the CS station), a
    bound a valid state never meets.  A lane that has its update is frozen
    while the others go on.  ``chunk > 1`` retires up to ``chunk`` events
    per lane step (the megastep lane kernel with its early stop under
    ``"kernel"``); the result is bitwise that of ``chunk = 1``.  Under
    ``"kernel"`` the first step writes new buffers and the rest reuse
    them, so ``state`` itself is never written.  Returns
    the state and :class:`UpdateOut` with ``[K]`` leaves: the last retired
    event's time, slot, client and delay, and the events consumed.
    """
    from ..sim.backend import resolve_backend

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    step, megastep = _lane_steps(resolve_backend(backend))
    K, m_max = state.finish.shape
    dev = state.finish.device
    if max_steps is None:
        max_steps = (4 if params.mu_cs is not None else 3) * m_max + 8
    law = stream.form
    zero = torch.zeros(K, dtype=torch.int32, device=dev)
    out = [torch.zeros(K, dtype=DTYPE, device=dev), zero, zero, zero]
    steps = [0] * K
    active = [max_steps > 0] * K
    owned = False  # whether state's buffers are this call's own
    while any(active):
        fs, cn, _ = stream.window(chunk)
        if chunk == 1:
            keep = torch.as_tensor(active, device=dev)
            state, t_col, int_col = step(params, state, fs[:, 0], cn[:, 0],
                                         power=power, keep=keep,
                                         donate=owned, law=law)
            taken = [int(a) for a in active]
            got = ((int_col[:, 2] > 0) & keep).tolist()
            new = [t_col[:, 0], int_col[:, 0], int_col[:, 1], int_col[:, 3]]
        else:
            rem = [max_steps - s if a else 0 for s, a in zip(steps, active)]
            state, t_mat, int_mat = megastep(params, state, fs, cn, rem,
                                             power=power, stop_on_update=True,
                                             donate=owned, law=law)
            D = int_mat.view(K, chunk, 10)
            kept = D[..., 9] > 0
            # contract: allow(raw-reduction): boolean count over the chunk axis — exact integer arithmetic, never a padded client/class axis
            n_kept = kept.sum(dim=1)
            # one read for both: the events each lane took, its update
            taken, got = torch.stack([n_kept, (kept & (D[..., 2] > 0))
                                      .any(dim=1).to(n_kept.dtype)]).tolist()
            last = torch.clamp_min(n_kept - 1, 0)[:, None]
            keep = n_kept > 0
            new = [x.gather(1, last)[:, 0]
                   for x in (t_mat, D[..., 0], D[..., 1], D[..., 3])]
        owned = True
        out = [torch.where(keep, a, b) for a, b in zip(new, out)]
        stream.advance(taken)
        steps = [s + t for s, t in zip(steps, taken)]
        active = [a and not g and s < max_steps
                  for a, g, s in zip(active, got, steps)]
    return state, UpdateOut(time=out[0], slot=out[1], client=out[2],
                            delay=out[3],
                            steps=torch.as_tensor(steps, dtype=torch.int32,
                                                  device=dev))


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
                   warmup: int = 0, key: Optional[torch.Tensor] = None,
                   seed: int = 0, distribution: str = "exponential",
                   power=None, m_max: Optional[int] = None,
                   backend: Optional[str] = None, chunk: int = 1,
                   draw_events: int = DRAW_EVENTS) -> EventStats:
    """Stationary statistics over ``num_updates`` rounds of one lane.

    Mirrors :meth:`AsyncNetworkSim.run`: statistics over the update-count
    window ``[warmup, warmup + num_updates)``.  The randomness comes from
    ``key`` (default ``PRNGKey(seed)`` on the params' device), the JAX
    package's draws for the same key, drawn in blocks of ``draw_events``.
    ``backend`` picks the table transition (:mod:`repro_torch.sim.backend`;
    one lane runs ``"sharded"`` as ``"batched"``, as the JAX package's
    single-lane scan does); ``chunk`` events retire per transition call
    (megasteps), bitwise the same statistics for every ``chunk``.
    """
    from ..sim.batched_events import run_lanes
    from ..sim.backend import resolve_backend

    get_law(distribution)  # eager: unknown laws fail listing the options
    if key is None:
        key = prng.PRNGKey(seed, device=params.device)
    m_max = int(m) if m_max is None else m_max
    lanes = stack_lanes([params])
    pw = None if power is None else stack_lanes([power])
    backend = resolve_backend(backend)
    stats = run_lanes(lanes, [int(m)], key.reshape(1, 2), int(num_updates),
                      warmup=int(warmup), distribution=distribution,
                      m_max=m_max, power=pw,
                      backend="batched" if backend == "sharded" else backend,
                      chunk=int(chunk), draw_events=int(draw_events))
    return lane(stats, 0)


def simulate_stats_classes(classes: ClassParams, m, num_updates: int, *,
                           warmup: int = 0,
                           key: Optional[torch.Tensor] = None,
                           seed: int = 0, distribution: str = "exponential",
                           power=None, m_max: Optional[int] = None,
                           backend: Optional[str] = None, chunk: int = 1,
                           draw_events: int = DRAW_EVENTS) -> EventStats:
    """Class-aggregated :func:`simulate_stats`: statistics over
    ``num_updates`` rounds with O(#classes) per-event state.

    The per-client fields of the result are per-class aggregates
    (``mean_delay``/``delay_counts`` ``[C]``, occupancy ``[3C+1]``);
    :func:`expand_class_stats` gives the per-member view.  ``power`` holds
    per-class ``[C]`` arrays.  ``backend`` is ``"batched"``,
    ``"reference"`` or ``"sharded"`` (one lane: ``"batched"``; the class
    transition has no kernel, ``"kernel"`` raises), and every ``chunk``
    gives bitwise the same statistics.  The randomness is ``key``'s
    (default ``PRNGKey(seed)``), as in the JAX package.
    """
    from ..sim.backend import resolve_backend
    from ..sim.batched_events import simulate_stats_classes_lanes

    backend = resolve_backend(backend)
    if backend == "sharded":
        backend = "batched"
    if key is None:
        key = prng.PRNGKey(seed, device=classes.device)
    stats = simulate_stats_classes_lanes(
        [classes], [m], num_updates, warmup=warmup, keys=key.reshape(1, 2),
        distribution=distribution,
        power=None if power is None else [power],
        m_max=int(m) if m_max is None else m_max, backend=backend,
        chunk=chunk, draw_events=draw_events)
    return lane(stats, 0)


def expand_class_stats(stats: EventStats, count) -> EventStats:
    """Per-class :class:`EventStats` to the per-member view (O(n), on
    demand).  Members of a class are exchangeable, so ``mean_delay``
    repeats the class mean, ``delay_counts`` becomes the mean count per
    member (``cnt_c / count_c``, a float) and each per-class occupancy
    segment divides equally among the members.  Padded count-0 classes are
    dropped; any leading lane axes are kept."""
    count = torch.as_tensor(count).to(stats.mean_delay.device)
    keep = count > 0
    reps = count[keep]
    w = reps.to(DTYPE)
    C = count.shape[0]

    def rep(x, per_member=False):
        x = x[..., keep]
        if per_member:
            x = x / w
        return torch.repeat_interleave(x, reps, dim=-1)

    occ = stats.mean_queue_counts
    return stats._replace(
        mean_delay=rep(stats.mean_delay),
        delay_counts=rep(stats.delay_counts, per_member=True),
        mean_queue_counts=torch.cat(
            [rep(occ[..., 0:C], True), rep(occ[..., C:2 * C], True),
             rep(occ[..., 2 * C:3 * C], True), occ[..., 3 * C:]], dim=-1))
