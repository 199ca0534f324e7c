"""The event engine's per-event table transition (port of
``repro.kernels.events``, the single-step kernel).

Replaces the Pallas TPU kernel ``repro/kernels/events.py::event_step_tables``
(body ``_event_kernel`` / ``_one_event``) with the hand-written CUDA kernel
``csrc/events.cu``: one warp per lane, the argmin over the finish clocks and
both FIFO picks as warp reductions on ``(value, index)`` pairs with ties to
the lowest index.  At the main path's sizes it is bound by its launch; its
bytes (each table row read and written once, one rate per lane and rate
table) are about ten KB.

  * :func:`event_step_tables` — one event per lane on ``[K, m_max]`` tables:
    launches the CUDA kernel for CUDA tensors (or raises) and runs
    :func:`event_step_tables_plain` — the same contract in PyTorch — for
    CPU tensors only.  ``event_step_tables.launches`` counts launches.

The ``EventState``-level step around the transition (statistics window,
O(1) occupancy update) is :func:`repro_torch.core.events.step_event_lanes`,
which takes either function as its ``table_step``.
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

    # FIFO promotion at the compute station of client c
    promo_comp = is_down | is_comp
    mine = client == c[:, None]
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
            int_col)


def _launch(finish, phase, client, seq, disp_round, mu_c, mu_u, fscal, iscal,
            has_cs: bool):
    K, M = finish.shape
    n = mu_c.shape[1]
    if M < 1:
        raise ValueError("the task table needs at least one slot")
    expect = [(finish, torch.float64, (K, M)), (phase, torch.int32, (K, M)),
              (client, torch.int32, (K, M)), (seq, torch.int32, (K, M)),
              (disp_round, torch.int32, (K, M)),
              (mu_c, torch.float64, (K, n)), (mu_u, torch.float64, (K, n)),
              (fscal, torch.float64, (K, 4)), (iscal, torch.int32, (K, 3))]
    args = []
    for x, dtype, shape in expect:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"event_step_tables: got {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if x.device != finish.device:
            raise ValueError("event_step_tables: inputs on different devices")
        args.append(x.contiguous())
    out = [torch.empty((K, M), dtype=torch.float64, device=finish.device)]
    out += [torch.empty((K, M), dtype=torch.int32, device=finish.device)
            for _ in range(4)]
    out += [torch.empty((K, 1), dtype=torch.float64, device=finish.device),
            torch.empty((K, 9), dtype=torch.int32, device=finish.device)]
    fn = build.load("events").event_step
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(finish.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() for a in args + out], K, M, n, int(has_cs),
                 stream)
    build.check(err, "event_step launch")
    event_step_tables.launches += 1
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
        return _launch(finish, phase, client, seq, disp_round, mu_c, mu_u,
                       fscal, iscal, has_cs)
    if finish.device.type == "cpu":
        return event_step_tables_plain(finish, phase, client, seq, disp_round,
                                       mu_c, mu_u, fscal, iscal,
                                       has_cs=has_cs)
    raise ValueError(f"no event kernel for device {finish.device}")


event_step_tables.launches = 0

