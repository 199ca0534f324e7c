"""The event engine's table transition (port of ``repro.kernels.events``):
one event per launch, and the megastep, up to ``chunk`` events per launch.

Replaces two Pallas TPU kernels with hand-written CUDA kernels in
``csrc/events.cu`` that share one per-event body:

  * ``repro/kernels/events.py::event_step_tables`` (body ``_event_kernel``
    / ``_one_event``) -> ``event_kernel``: one warp per lane, the argmin
    over the finish clocks and both FIFO picks as warp reductions on
    ``(value, index)`` pairs with ties to the lowest index;
  * ``repro/kernels/events.py::megastep_tables`` (``_megastep_kernel``)
    -> ``megastep_kernel``: the same warp per lane with the lane's five
    rows held in shared memory for all ``chunk`` events, ``keep``-masked
    past ``rem`` and, with ``stop_on_update``, after the first kept update.

At the main path's sizes both are bound by their launch; their bytes (the
table rows read and written once, one rate sector per gather, the scalars
and descriptors) are tens of KB.

  * :func:`event_step_tables` / :func:`megastep_tables` launch the CUDA
    kernel for CUDA tensors (or raise) and run
    :func:`event_step_tables_plain` / :func:`megastep_tables_plain` — the
    same contract in PyTorch — for CPU tensors only.  Each wrapper's
    ``launches`` counts its kernel's launches.

The ``EventState``-level steps around the transitions (statistics window,
O(1) occupancy update) are :func:`repro_torch.core.events.step_event_lanes`
and :func:`repro_torch.core.events.megastep_event_lanes`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import events as E
from . import build


def _first_index_min(values: torch.Tensor, idx: torch.Tensor):
    """Per row: ``(min, first index attaining it)``."""
    v_min = values.amin(dim=1)
    pick = torch.where(values == v_min[:, None], idx, values.shape[1])
    return v_min, pick.amin(dim=1)


def event_step_tables_plain(finish, phase, client, seq, disp_round, mu_c,
                            mu_u, fscal, iscal, *, has_cs: bool):
    """One event per lane in PyTorch — the contract of the CUDA kernel
    (and of the JAX package's ``event_step_oracle``)."""
    return _step_plain(finish, phase, client, seq, disp_round, mu_c, mu_u,
                       fscal, iscal, has_cs=has_cs)[:7]


def class_step_tables_plain(finish, phase, cls, member, seq, disp_round,
                            mu_c, mu_u, fscal, iscal, *, has_cs: bool):
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
        has_cs=has_cs, member=member)
    return finish, phase, cls, member, seq, disp, t_col, desc


def _step_plain(finish, phase, client, seq, disp_round, mu_c, mu_u, fscal,
                iscal, *, has_cs: bool, member=None):
    """The shared body: ``client`` owns the rates; with ``member`` given a
    task's compute station is its ``(client, member)`` pair and the
    routed member is ``iscal[:, 3]``."""
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
    svc_up = fscal[:, 0] / mu_u[lanes, cl]
    svc_c = fscal[:, 1] / mu_c[lanes, cl]

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
                          stop_on_update: bool = False):
    """Up to ``chunk`` events per lane in PyTorch — the contract of the CUDA
    megastep kernel and of the JAX package's ``_megastep_kernel``: event
    ``i`` is :func:`event_step_tables_plain` on the held table, kept when
    ``keep_i = (i < rem) & ~done``.  A masked event still computes its
    transition and descriptors, and the table and counters are held."""
    K = finish.shape[0]
    tbl = (finish, phase, client, seq, disp_round)
    seq_ctr, rnd, rem = iscal[:, 0], iscal[:, 1], iscal[:, 2]
    done = torch.zeros(K, dtype=torch.bool, device=finish.device)
    ts, descs = [], []
    for i in range(chunk):
        one = torch.stack([iscal[:, 3 + i], seq_ctr, rnd], dim=-1)
        *tbl2, t_col, d = event_step_tables_plain(
            *tbl, mu_c, mu_u, fscal[:, 4 * i:4 * i + 4], one, has_cs=has_cs)
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
    counter.launches += 1
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
