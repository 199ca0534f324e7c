"""The event engine on the card (port of ``repro.kernels.events``): one
hand-written CUDA kernel, ``lanes_kernel`` in ``csrc/events.cu``, that
retires up to ``chunk`` events per lane in one launch, with or without
their statistics, through one per-event body.

It replaces two Pallas TPU kernels:

  * ``repro/kernels/events.py::event_step_tables`` (body ``_event_kernel``
    / ``_one_event``): one warp per lane, the argmin over the finish clocks
    and both FIFO picks as warp reductions on ``(value, index)`` pairs with
    ties to the lowest index;
  * ``repro/kernels/events.py::megastep_tables`` (``_megastep_kernel``):
    the same warp per lane with the lane's rows held in shared memory for
    all ``chunk`` events, ``keep``-masked past ``rem`` and, with
    ``stop_on_update``, after the first kept update.

:func:`event_step_tables` / :func:`megastep_tables` keep the TPU kernels'
contract (tables in, tables and descriptors out): the kernel with its
statistics compiled out.  The main path runs the lane steps
:func:`event_step_lanes` (one event, a ``keep`` mask) and
:func:`megastep_lanes` (up to ``chunk`` events): one CTA per lane carries
the lane's whole :class:`~repro_torch.core.events.EventState` (staged in
shared memory, or in place in global memory where its rows pass what a
block may stage on the device), and after each kept event's transition
does what :func:`repro_torch.core.events.replay_event` does (the
statistics window, the energy integral with hardware fused multiply-adds,
the O(1) occupancy carries), so that no PyTorch operation runs per event.
In the JAX package those statistics are ``jnp`` around the kernel that XLA
fuses; an eager port turned each of them into a launch.

The completing client's rate is applied inside the kernel in the timing
law's form (:func:`repro_torch.scenario.laws.apply_rate`), a template
parameter of the lane kernel: ``"scale"`` (exponential, deterministic:
``x / mu``), ``"h2"`` (hyperexponential: ``x / (f mu)``, ``fs`` six
scalars an event) and ``"lognormal"`` (``exp((z - log mu) - 0.5)``).  The
transition-only entry points keep the TPU kernels' contract, the
``"scale"`` form.

At the main path's sizes every launch is bound by the launch itself; its
bytes are tens of KB.  Each wrapper launches the kernel for CUDA tensors
(or raises) and runs its plain version for CPU tensors only: for the
tables :func:`event_step_tables_plain` / :func:`megastep_tables_plain`,
for the lane steps :func:`repro_torch.core.events.event_step_lanes_plain`
/ :func:`~repro_torch.core.events.megastep_lanes_plain` (the plain
transition, then ``replay_event`` per kept event).  Each wrapper's
``launches`` counts its launches.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import ctypes
import functools
from typing import Optional

import torch

from ..core import events as E
from ..obs.rings import _EVENT_DTYPES, EventRing
from ..scenario.laws import FORMS, apply_rate, form_width, law_form
from . import build


def _first_index_min(values: torch.Tensor, idx: torch.Tensor):
    """Per row: ``(min, first index attaining it)``."""
    v_min = values.amin(dim=1)
    pick = torch.where(values == v_min[:, None], idx, values.shape[1])
    return v_min, pick.amin(dim=1)


def event_step_tables_plain(finish, phase, client, seq, disp_round, mu_c,
                            mu_u, fscal, iscal, *, has_cs: bool,
                            law: str = "scale"):
    """One event per lane in PyTorch — the contract of the CUDA kernel
    (and, for the ``"scale"`` form, of the JAX package's
    ``event_step_oracle``); ``fscal [K, W]`` holds the event's scalars in
    the rate form ``law``."""
    return _step_plain(finish, phase, client, seq, disp_round, mu_c, mu_u,
                       fscal, iscal, has_cs=has_cs, law=law)[:7]


def class_step_tables_plain(finish, phase, cls, member, seq, disp_round,
                            mu_c, mu_u, fscal, iscal, *, has_cs: bool,
                            law: str = "scale"):
    """One event per lane of the class-aggregated engine, in PyTorch.

    The transition of :func:`event_step_tables_plain` with each task owned
    by a ``(cls, member)`` pair: rates are per class (``mu_c``/``mu_u``
    ``[K, C]``), the compute FIFO promotes within the completing task's
    member (every member is its own single-server station), and ``iscal``
    carries a fourth column, the routed member.  Returns the six updated
    tables ``(finish, phase, cls, member, seq, disp_round)``, ``t_new [K,
    1]`` and the nine descriptors (``c`` is the completing task's class).
    The JAX package has no kernel for this engine, so neither has the
    port: it runs on the plain transition on every device.
    """
    finish, phase, cls, seq, disp, t_col, desc, member = _step_plain(
        finish, phase, cls, seq, disp_round, mu_c, mu_u, fscal, iscal,
        has_cs=has_cs, member=member, law=law)
    return finish, phase, cls, member, seq, disp, t_col, desc


def _step_plain(finish, phase, client, seq, disp_round, mu_c, mu_u, fscal,
                iscal, *, has_cs: bool, member=None, law: str = "scale"):
    """The shared body: ``client`` owns the rates; with ``member`` given a
    task's compute station is its ``(client, member)`` pair and the
    routed member is ``iscal[:, 3]``.  The uplink and computation services
    are ``fscal``'s first two columns with the completing client's rates
    applied in the form ``law`` (the ``"h2"`` factors in columns 4 and
    5)."""
    K, M = finish.shape
    dev = finish.device
    idx = torch.arange(M, device=dev)
    lanes = torch.arange(K, device=dev)
    c_new, seq_ctr, rnd = iscal[:, 0], iscal[:, 1], iscal[:, 2]

    t_new, j = _first_index_min(finish, idx)
    c = client[lanes, j]
    ph = phase[lanes, j]
    delay = rnd - disp_round[lanes, j]
    is_down = ph == E.DOWN
    is_comp = ph == E.COMP_SERV
    is_up = ph == E.UP
    is_cs = ph == E.CS_SERV
    is_update = is_cs if has_cs else is_up
    new_round = rnd + is_update.to(torch.int32)
    cl = c.long()
    law = law_form(law)
    h2 = law == "h2"
    svc_up = apply_rate(law, fscal[:, 0], fscal[:, 4] if h2 else None,
                        mu_u[lanes, cl])
    svc_c = apply_rate(law, fscal[:, 1], fscal[:, 5] if h2 else None,
                       mu_c[lanes, cl])

    phase_j = torch.where(is_down, E.COMP_WAIT, torch.where(
        is_comp, E.UP, torch.where(is_update, E.DOWN, E.CS_WAIT)))
    finish_j = torch.where(is_comp, t_new + svc_up, torch.where(
        is_update, t_new + fscal[:, 2], torch.inf))
    joins_fifo = is_down | (is_up & has_cs)
    seq_j = torch.where(joins_fifo, seq_ctr, seq[lanes, j])
    new_seq_ctr = seq_ctr + joins_fifo.to(torch.int32)
    client_j = torch.where(is_update, c_new, c)
    disp_j = torch.where(is_update, new_round, disp_round[lanes, j])

    onej = idx[None, :] == j[:, None]
    phase = torch.where(onej, phase_j[:, None], phase).to(torch.int32)
    finish = torch.where(onej, finish_j[:, None], finish)
    seq = torch.where(onej, seq_j[:, None], seq).to(torch.int32)
    client = torch.where(onej, client_j[:, None], client).to(torch.int32)
    disp = torch.where(onej, disp_j[:, None], disp_round).to(torch.int32)

    # FIFO promotion at the compute station of client c (of member (c, mb))
    promo_comp = is_down | is_comp
    mine = client == c[:, None]
    if member is not None:
        mb = member[lanes, j]
        member_j = torch.where(is_update, iscal[:, 3], mb)
        member = torch.where(onej, member_j[:, None], member).to(torch.int32)
        mine = mine & (member == mb[:, None])
    serving_c = ((phase == E.COMP_SERV) & mine).any(dim=1)
    waiting_c = (phase == E.COMP_WAIT) & mine
    _, pick = _first_index_min(torch.where(waiting_c, seq, E._BIG_SEQ), idx)
    do_comp = promo_comp & ~serving_c & waiting_c.any(dim=1)
    onep = (idx[None, :] == pick[:, None]) & do_comp[:, None]
    phase = torch.where(onep, E.COMP_SERV, phase)
    finish = torch.where(onep, (t_new + svc_c)[:, None], finish)

    if has_cs:
        promo_cs = is_up | is_cs
        cs_waiting = phase == E.CS_WAIT
        _, pick_cs = _first_index_min(
            torch.where(cs_waiting, seq, E._BIG_SEQ), idx)
        do_cs = (promo_cs & ~(phase == E.CS_SERV).any(dim=1)
                 & cs_waiting.any(dim=1))
        onec = (idx[None, :] == pick_cs[:, None]) & do_cs[:, None]
        phase = torch.where(onec, E.CS_SERV, phase)
        finish = torch.where(onec, (t_new + fscal[:, 3])[:, None], finish)
    else:
        do_cs = torch.zeros(K, dtype=torch.bool, device=dev)

    int_col = torch.stack([j, c, is_update, delay, new_seq_ctr, new_round, ph,
                           do_comp, do_cs], dim=-1).to(torch.int32)
    return (finish, phase.to(torch.int32), client, seq, disp, t_new[:, None],
            int_col, member)


def megastep_tables_plain(finish, phase, client, seq, disp_round, mu_c,
                          mu_u, fscal, iscal, *, has_cs: bool, chunk: int,
                          stop_on_update: bool = False, law: str = "scale"):
    """Up to ``chunk`` events per lane in PyTorch — the contract of the CUDA
    megastep kernel and of the JAX package's ``_megastep_kernel``: event
    ``i`` is :func:`event_step_tables_plain` on the held table, kept when
    ``keep_i = (i < rem) & ~done``.  A masked event still computes its
    transition and descriptors, and the table and counters are held.
    ``fscal [K, W * chunk]`` holds ``W`` scalars an event in the rate form
    ``law``."""
    W = form_width(law_form(law))
    K = finish.shape[0]
    tbl = (finish, phase, client, seq, disp_round)
    seq_ctr, rnd, rem = iscal[:, 0], iscal[:, 1], iscal[:, 2]
    done = torch.zeros(K, dtype=torch.bool, device=finish.device)
    ts, descs = [], []
    for i in range(chunk):
        one = torch.stack([iscal[:, 3 + i], seq_ctr, rnd], dim=-1)
        *tbl2, t_col, d = event_step_tables_plain(
            *tbl, mu_c, mu_u, fscal[:, W * i:W * i + W], one, has_cs=has_cs,
            law=law)
        keep = (i < rem) & ~done
        if stop_on_update:
            done = done | (keep & (d[:, 2] > 0))
        tbl = tuple(torch.where(keep[:, None], a, b)
                    for a, b in zip(tbl2, tbl))
        seq_ctr = torch.where(keep, d[:, 4], seq_ctr)
        rnd = torch.where(keep, d[:, 5], rnd)
        ts.append(t_col)
        descs.append(torch.cat([d, keep[:, None].to(torch.int32)], dim=1))
    return (*tbl, torch.cat(ts, dim=1), torch.cat(descs, dim=1))


def _launch(symbol: str, counter, tables, n_f: int, n_i: int, n_t: int,
            n_desc: int, flags):
    """Check ``tables`` (the five ``[K, m_max]`` tables, the two ``[K, n]``
    rate tables, ``fscal [K, n_f]`` and ``iscal [K, n_i]``), allocate the
    outputs (five tables, ``[K, n_t]`` times, ``[K, n_desc]``
    descriptors), launch ``csrc/events.cu``'s ``symbol`` with
    ``(K, m_max, n, *flags)`` on the current stream and count the launch
    on ``counter``."""
    finish, mu_c = tables[0], tables[5]
    K, M = finish.shape
    n = mu_c.shape[1]
    if M < 1:
        raise ValueError("the task table needs at least one slot")
    expect = ([torch.float64] + [torch.int32] * 4 + [torch.float64] * 3
              + [torch.int32])
    shapes = [(K, M)] * 5 + [(K, n)] * 2 + [(K, n_f), (K, n_i)]
    args = []
    for x, dtype, shape in zip(tables, expect, shapes):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{symbol}: got {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {shape}")
        if x.device != finish.device:
            raise ValueError(f"{symbol}: inputs on different devices")
        args.append(x.contiguous())
    dev = finish.device
    out = [torch.empty((K, M), dtype=torch.float64, device=dev)]
    out += [torch.empty((K, M), dtype=torch.int32, device=dev)
            for _ in range(4)]
    out += [torch.empty((K, n_t), dtype=torch.float64, device=dev),
            torch.empty((K, n_desc), dtype=torch.int32, device=dev)]
    ints = (K, M, n) + tuple(int(f) for f in flags)
    fn = getattr(build.load("events"), symbol)
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = ([ctypes.c_void_p] * (len(args) + len(out))
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() for a in args + out], *ints, stream)
    build.check(err, f"{symbol} launch")
    build.count(counter)
    return tuple(out)


def event_step_tables(finish, phase, client, seq, disp_round, mu_c, mu_u,
                      fscal, iscal, *, has_cs: bool):
    """One event per lane on ``K`` stacked task tables.

    Tables are ``[K, m_max]`` (``finish`` float64, the rest int32), rates
    ``[K, n]`` float64, ``fscal = [e_up, e_comp, svc_down, svc_cs]``
    float64 ``[K, 4]`` and ``iscal = [c_new, seq_ctr, round]`` int32
    ``[K, 3]``.  Returns the five updated tables, ``t_new [K, 1]`` and the
    descriptors ``[j, c, is_update, delay, seq_ctr', round', ph_pre,
    do_comp, do_cs]`` int32 ``[K, 9]``.
    """
    if finish.is_cuda:
        return _launch("event_step", event_step_tables,
                       (finish, phase, client, seq, disp_round, mu_c, mu_u,
                        fscal, iscal), 4, 3, 1, 9, (has_cs,))
    if finish.device.type == "cpu":
        return event_step_tables_plain(finish, phase, client, seq, disp_round,
                                       mu_c, mu_u, fscal, iscal,
                                       has_cs=has_cs)
    raise ValueError(f"no event kernel for device {finish.device}")


event_step_tables.launches = 0


def megastep_tables(finish, phase, client, seq, disp_round, mu_c, mu_u,
                    fscal, iscal, *, has_cs: bool, chunk: int,
                    stop_on_update: bool = False):
    """Up to ``chunk`` events per lane on ``K`` stacked task tables, one
    launch.

    Tables and rates as :func:`event_step_tables`; ``fscal`` float64
    ``[K, 4 * chunk]`` holds ``[e_up, e_comp, svc_down, svc_cs]`` per event
    and ``iscal`` int32 ``[K, 3 + chunk]`` holds ``[seq_ctr, round, rem]``
    and then the routed client of each event.  Returns the five tables
    after the kept events, the event times ``[K, chunk]`` and the
    descriptors ``[K, 10 * chunk]``: per event the nine of
    :func:`event_step_tables` and ``keep``.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if finish.is_cuda:
        return _launch("megastep", megastep_tables,
                       (finish, phase, client, seq, disp_round, mu_c, mu_u,
                        fscal, iscal), 4 * chunk, 3 + chunk, chunk,
                       10 * chunk, (has_cs, chunk, stop_on_update))
    if finish.device.type == "cpu":
        return megastep_tables_plain(finish, phase, client, seq, disp_round,
                                     mu_c, mu_u, fscal, iscal, has_cs=has_cs,
                                     chunk=chunk,
                                     stop_on_update=stop_on_update)
    raise ValueError(f"no megastep kernel for device {finish.device}")


megastep_tables.launches = 0


# ---------------------------------------------------------------------------
# the lane steps: transitions together with their statistics
# ---------------------------------------------------------------------------

_CONST = ("warmup", "cap", "t_cap")  # leaves a step never changes
_MUTABLE = tuple(f for f in E.EventState._fields if f not in _CONST)
_OTHER = ("mu_c", "mu_u", "P_c", "P_u", "P_d", "P_cs", "fs", "c_new", "rem",
          "keep", "ev_t", "ev_int")
# the event ring's columns (repro_torch.obs.rings.EventRing), then its count
_RING = EventRing._fields
_RING_DTYPES = tuple(_EVENT_DTYPES.values()) + (None,)  # None: the count
_RING_PTRS = tuple("r_" + f for f in _RING)
_INTS = ("K", "m_max", "n", "has_cs", "chunk", "rem_all", "stop_on_update",
         "desc_width", "law", "ring_cap")


class _LaneArgs(ctypes.Structure):
    """``csrc/events.cu``'s ``LaneArgs``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in E.EventState._fields]
                + [("o_" + f, ctypes.c_void_p) for f in _MUTABLE]
                + [(f, ctypes.c_void_p) for f in _OTHER]
                + [(f, ctypes.c_void_p) for f in _RING_PTRS]
                + [(f, ctypes.c_longlong)
                   for f in ("fs_stride", "cn_stride", "sc_stride")]
                + [(f, ctypes.c_int) for f in _INTS])


@functools.lru_cache(maxsize=64)
def _lane_specs(K: int, M: int, n: int, chunk: Optional[int], power: bool,
                pcs: bool, keep: bool, width: int) -> tuple:
    """``(name, dtype, shape)`` of each input of a lane step, in the order
    of :func:`_lane_tensors` (``chunk`` ``None``: the one event of
    :func:`event_step_lanes`, ``fs [K, width]`` and ``c_new [K]``)."""
    f64, i32 = torch.float64, torch.int32
    kf, ki, S = (f64, (K,)), (i32, (K,)), 3 * n + 1
    state = dict(t=kf, round=ki, seq_ctr=ki, client=(i32, (K, M)),
                 phase=(i32, (K, M)), finish=(f64, (K, M)),
                 seq=(i32, (K, M)), disp_round=(i32, (K, M)), warmup=ki,
                 cap=ki, t_cap=kf, t0=kf, t1=kf, delay_sum=(f64, (K, n)),
                 delay_cnt=(i32, (K, n)), energy=kf,
                 occ_int=(f64, (K, S)), occ=(f64, (K, S)),
                 serving=(f64, (K, n)), cs_busy=(torch.bool, (K,)))
    specs = [(f"state.{k}", *state[k]) for k in E.EventState._fields]
    specs += [("mu_c", f64, (K, n)), ("mu_u", f64, (K, n)),
              ("fs", f64, (K, width) if chunk is None
               else (K, chunk, width)),
              ("c_new", i32, (K,) if chunk is None else (K, chunk))]
    if power:
        specs += [(f"power.{k}", f64, (K, n)) for k in ("P_c", "P_u", "P_d")]
    if pcs:
        specs.append(("power.P_cs", f64, (K,)))
    if keep:
        specs.append(("keep", torch.bool, (K,)))
    return tuple((name, dtype, torch.Size(shape))
                 for name, dtype, shape in specs)


def _lane_tensors(params, state, power, fs, c_new, keep) -> list:
    xs = [*state, params.mu_c, params.mu_u, fs, c_new]
    if power is not None:
        xs += [power.P_c, power.P_u, power.P_d]
        if power.P_cs is not None:
            xs.append(power.P_cs)
    if keep is not None:
        xs.append(keep)
    return xs


def _check_lanes(what: str, params, state, power, fs, c_new, keep,
                 chunk: Optional[int], law: str):
    """Raise ``ValueError`` unless every input of a lane step has the
    dtype, shape and device the kernel takes (``fs`` the width of the rate
    form ``law``)."""
    K, M = state.finish.shape
    dev = state.finish.device
    specs = _lane_specs(K, M, params.mu_c.shape[-1], chunk,
                        power is not None,
                        power is not None and power.P_cs is not None,
                        keep is not None, form_width(law))
    for (name, dtype, shape), x in zip(specs, _lane_tensors(
            params, state, power, fs, c_new, keep)):
        if x.dtype != dtype or x.shape != shape:
            raise ValueError(f"{what}: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} "
                             f"{tuple(shape)}")
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, the state on "
                             f"{dev}")
    if M < 1:
        raise ValueError(f"{what}: the task table needs at least one slot")


def _check_ring(what: str, ring, K: int, dev) -> None:
    """Raise ``ValueError`` unless ``ring`` is a lane-stacked event ring
    of ``K`` lanes on ``dev`` whose columns the kernel can write in place
    (contiguous, the ring's dtypes).  Runs once a launch: kept lean."""
    if type(ring) is not EventRing:
        raise ValueError(f"{what}: ring must be an EventRing, got "
                         f"{type(ring).__name__}")
    cols = (K, ring.time.shape[-1])
    for name, x, dtype in zip(_RING, ring, _RING_DTYPES):
        shape = cols if dtype is not None else (K,)
        dtype = dtype or torch.int32
        if x.dtype != dtype or x.shape != shape:
            raise ValueError(f"{what}: ring.{name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{what}: ring.{name} must be contiguous on "
                             f"{dev}, the state's device")


def _check_rem(rem, K: int, dev) -> None:
    """Raise ``ValueError`` unless ``rem`` is an int, ``K`` ints or an
    int32 ``[K]`` tensor on ``dev``."""
    if isinstance(rem, torch.Tensor):
        if rem.dtype != torch.int32 or tuple(rem.shape) != (K,) \
                or rem.device != dev:
            raise ValueError(f"rem must be int32 [{K}] on {dev}, got "
                             f"{rem.dtype} {tuple(rem.shape)} on "
                             f"{rem.device}")
    elif not isinstance(rem, int) and len(rem) != K:
        raise ValueError(f"got {len(rem)} rem values for {K} lanes")


def _rem_arg(rem, K: int, dev):
    """``(rem tensor or None, rem for every lane)`` for the kernel, from a
    checked ``rem``: one value for every lane needs no tensor."""
    if isinstance(rem, torch.Tensor):
        return rem.contiguous(), 0
    if isinstance(rem, int):
        return None, rem
    rem = [int(r) for r in rem]
    if len(set(rem)) == 1:
        return None, rem[0]
    return torch.as_tensor(rem, dtype=torch.int32, device=dev), 0


def _launch_lanes(counter, params, state, power, fs, c_new, *, chunk: int,
                  rem, keep, stop_on_update: bool, desc_width: int,
                  donate: bool, law: str, ring):
    """Launch ``csrc/events.cu``'s lane steps on the checked inputs:
    returns the new state (in the donated buffers of ``state`` when
    ``donate``, else in new ones; the leaves a step never changes are
    ``state``'s own), the event times ``[K, chunk]`` and the descriptors
    ``[K, desc_width * chunk]``; the kernel appends each kept event to
    the event ``ring`` in place (none, or capacity 0: null pointers);
    counts the launch on ``counter``."""
    K, M = state.finish.shape
    n = params.mu_c.shape[-1]
    dev = state.finish.device
    leaves = {f: getattr(state, f).contiguous() for f in E.EventState._fields}
    out = {f: leaves[f] if donate else torch.empty_like(leaves[f])
           for f in _MUTABLE}
    if fs.stride(-1) != 1 or (fs.dim() == 3
                              and fs.stride(1) != fs.shape[-1]):
        fs = fs.contiguous()
    if c_new.dim() == 2 and c_new.stride(1) != 1:
        c_new = c_new.contiguous()
    rem_t, rem_all = _rem_arg(rem, K, dev)
    ev_t = torch.empty((K, chunk), dtype=torch.float64, device=dev)
    ev_int = torch.empty((K, desc_width * chunk), dtype=torch.int32,
                         device=dev)
    ptrs = dict(mu_c=params.mu_c, mu_u=params.mu_u, rem=rem_t, keep=keep,
                ev_t=ev_t, ev_int=ev_int)
    if power is not None:
        ptrs.update(P_c=power.P_c, P_u=power.P_u, P_d=power.P_d,
                    P_cs=power.P_cs)
    args = _LaneArgs()
    for f, x in leaves.items():
        setattr(args, f, x.data_ptr())
    for f, x in out.items():
        setattr(args, "o_" + f, x.data_ptr())
    # a copy made here is freed at return, on this stream: safe
    ptrs = {f: None if x is None else x.contiguous()
            for f, x in ptrs.items()}
    for f, x in list(ptrs.items()) + [("fs", fs), ("c_new", c_new)]:
        setattr(args, f, None if x is None else x.data_ptr())
    ring_cap = 0 if ring is None else ring.time.shape[-1]
    if ring_cap:
        for f, x in zip(_RING_PTRS, ring):
            setattr(args, f, x.data_ptr())
    args.fs_stride, args.cn_stride = fs.stride(0), c_new.stride(0)
    args.sc_stride = 1
    for f, v in zip(_INTS, (K, M, n, params.mu_cs is not None, chunk,
                            rem_all, stop_on_update, desc_width,
                            FORMS.index(law), ring_cap)):
        setattr(args, f, int(v))
    fn = build.load("events").lanes
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = [ctypes.POINTER(_LaneArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the launch, its shared-memory opt-in and the stream are the lane
    # device's, whichever device is current in the calling thread
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    build.check(err, "lane step launch")
    build.count(counter)
    return (E.EventState(**{**leaves, **out}), ev_t, ev_int)


def event_step_lanes(params, state, fs, c_new, *, power=None, keep=None,
                     donate: bool = False, law: str = "scale", ring=None):
    """One event per lane on ``K`` lane-stacked states, statistics and all.

    ``params``/``power`` leaves ``[K, n]`` (``P_cs`` ``[K]``), ``state``
    an :class:`~repro_torch.core.events.EventState` with ``[K, ...]``
    leaves, ``fs`` float64 ``[K, W]`` and ``c_new`` int32 ``[K]`` the
    event's scalars and routed clients; lanes where ``keep [K]`` (bool) is
    false stay as they were.  ``law`` is the rate form (or a law's name):
    ``"scale"`` and ``"lognormal"`` take ``W = 4`` scalars ``[x_up,
    x_comp, svc_down, svc_cs]`` (``x`` the unit-rate variate or the
    normal), ``"h2"`` ``W = 6``, the branch factors ``[f_up, f_comp]``
    after them; rows may be strided.  Returns the new state, ``t_new [K,
    1]`` and the nine descriptors ``[K, 9]`` of :func:`event_step_tables`.
    With ``donate`` the kernel may write the new state into ``state``'s
    own buffers (the caller must own them and use only the result).  A
    lane-stacked event ``ring`` (:mod:`repro_torch.obs.rings`) gets each
    kept event, written in place by the same launch; it belongs to the
    caller and is never donated.
    """
    law = law_form(law)
    _check_lanes("event_step_lanes", params, state, power, fs, c_new, keep,
                 None, law)
    if ring is not None:
        _check_ring("event_step_lanes", ring, c_new.shape[0],
                    state.finish.device)
    if state.finish.is_cuda:
        return _launch_lanes(event_step_lanes, params, state, power, fs,
                             c_new, chunk=1, rem=1, keep=keep,
                             stop_on_update=False, desc_width=9,
                             donate=donate, law=law, ring=ring)
    if state.finish.device.type == "cpu":
        return E.event_step_lanes_plain(params, state, fs, c_new,
                                        power=power, keep=keep, law=law,
                                        ring=ring)
    raise ValueError(f"no event lane kernel for device {state.finish.device}")


event_step_lanes.launches = 0


def megastep_lanes(params, state, fs, c_new, rem, *, power=None,
                   stop_on_update: bool = False, donate: bool = False,
                   law: str = "scale", ring=None):
    """Up to ``chunk`` events per lane on ``K`` lane-stacked states in one
    launch, statistics and all.

    As :func:`event_step_lanes`, with ``fs`` float64 ``[K, chunk, W]`` and
    ``c_new`` int32 ``[K, chunk]``; event ``i`` of lane ``k`` is kept when
    ``i < rem[k]`` (``rem`` an int, one int per lane or an int32 ``[K]``
    tensor) and, with ``stop_on_update``, no earlier kept event of the
    lane was an update.  Returns the new state, the event times ``[K,
    chunk]`` and the descriptors ``[K, 10 * chunk]`` of
    :func:`megastep_tables` (masked events' too).  Each kept event goes to
    the event ``ring`` as in :func:`event_step_lanes`; a masked one
    neither writes it nor bumps its count.
    """
    if c_new.dim() != 2 or c_new.shape[1] < 1:
        raise ValueError(f"c_new must be [K, chunk >= 1], got "
                         f"{tuple(c_new.shape)}")
    chunk = c_new.shape[1]
    law = law_form(law)
    _check_lanes("megastep_lanes", params, state, power, fs, c_new, None,
                 chunk, law)
    _check_rem(rem, c_new.shape[0], state.finish.device)
    if ring is not None:
        _check_ring("megastep_lanes", ring, c_new.shape[0],
                    state.finish.device)
    if state.finish.is_cuda:
        return _launch_lanes(megastep_lanes, params, state, power, fs, c_new,
                             chunk=chunk, rem=rem, keep=None,
                             stop_on_update=stop_on_update, desc_width=10,
                             donate=donate, law=law, ring=ring)
    if state.finish.device.type == "cpu":
        return E.megastep_lanes_plain(params, state, fs, c_new, rem,
                                      power=power,
                                      stop_on_update=stop_on_update, law=law,
                                      ring=ring)
    raise ValueError(f"no megastep lane kernel for device "
                     f"{state.finish.device}")


megastep_lanes.launches = 0
