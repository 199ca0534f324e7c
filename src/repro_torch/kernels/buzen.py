"""Batched Buzen DP kernel: the routing optimizer's inner loop (port of
``repro.kernels.buzen``, per-client half).

Replaces the Pallas TPU kernel ``repro/kernels/buzen.py::buzen_pallas_batched``
(body ``_buzen_kernel``) with the hand-written CUDA kernel
``csrc/buzen.cu``: one CTA per batch row, the station loop inside the
block, the running row double-buffered in shared memory.  It is bound by
operations (about ``B * S * (m+1)(m+2)/2`` float32 exp terms per call),
not by the bytes it moves.

Entry points:

  * :func:`buzen_batched` — the raw float32 forward ``[B, S] -> [B, m+1]``:
    launches the CUDA kernel for CUDA tensors (or raises), and runs
    :func:`buzen_batched_plain` — the same arithmetic in PyTorch — for CPU
    tensors only.  ``buzen_batched.launches`` counts kernel launches.
  * :func:`buzen_log_Z_batched` — differentiable wrapper
    (``torch.autograd.Function``): the forward is the kernel, the backward
    differentiates the float64 PyTorch DP at the same primal point.
  * :func:`buzen_single` — the single-row form (``B = 1``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.numerics import NEG_INF
from . import build

_MAX_M_PAD = 6144  # two f32 rows in 48 KB of shared memory


def _init_rows(log_gamma_total: torch.Tensor, m_pad: int) -> torch.Tensor:
    """The aggregated IS Poisson row ``k log gamma - lgamma(k+1)`` in f32."""
    k = torch.arange(m_pad, dtype=torch.float32,
                     device=log_gamma_total.device)
    return (k[None, :] * log_gamma_total[:, None].to(torch.float32)
            - torch.lgamma(k + 1.0)[None, :])


def _clamp_rho(log_rho: torch.Tensor) -> torch.Tensor:
    # a load-0 station (padded client) arrives as log_rho = -inf: clamp it
    # to the finite mask value so k * log_rho stays NaN-free; its k >= 1
    # terms then underflow to 0 and the station is the identity
    return torch.clamp_min(log_rho.to(torch.float32), NEG_INF)


def buzen_batched_plain(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                        m_max: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (float32, masked ``(m+1)^2``
    logsumexp per station, max then sum) — what CPU tensors run."""
    m_pad = m_max + 1
    u = _init_rows(log_gamma_total, m_pad)
    rho = _clamp_rho(log_rho)
    ar = torch.arange(m_pad, device=log_rho.device)
    valid = ar[None, :] <= ar[:, None]                     # [m, k]: k <= m
    shifted = torch.where(valid, ar[:, None] - ar[None, :], 0)
    kf = ar.to(torch.float32)
    for s in range(rho.shape[1]):
        terms = torch.where(valid, kf[None, None, :] * rho[:, s, None, None]
                            + u[:, shifted], NEG_INF)
        row_max = terms.amax(dim=-1)
        sumexp = torch.exp(terms - row_max[..., None]).sum(dim=-1)
        u = row_max + torch.log(sumexp)
    return u


def _launch(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
            m_max: int) -> torch.Tensor:
    B, S = log_rho.shape
    m_pad = m_max + 1
    if not 1 <= m_pad <= _MAX_M_PAD:
        raise ValueError(f"m_max={m_max} outside the kernel's range "
                         f"[0, {_MAX_M_PAD - 1}]")
    if log_gamma_total.shape != (B,):
        raise ValueError(f"log_gamma_total has shape "
                         f"{tuple(log_gamma_total.shape)}, expected ({B},)")
    if log_gamma_total.device != log_rho.device:
        raise ValueError("log_rho and log_gamma_total on different devices")
    rho = _clamp_rho(log_rho).contiguous()
    init = _init_rows(log_gamma_total, m_pad).contiguous()
    out = torch.empty((B, m_pad), dtype=torch.float32, device=log_rho.device)
    fn = build.load("buzen").buzen_forward
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(log_rho.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rho.data_ptr(), init.data_ptr(), out.data_ptr(), B, S,
                 m_pad, stream)
    build.check(err, "buzen_forward launch")
    buzen_batched.launches += 1
    return out


def buzen_batched(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                  m_max: int) -> torch.Tensor:
    """``log Z_{., 0..m_max}`` (float32 ``[B, m_max+1]``) for a batch of
    networks: ``log_rho [B, S]`` single-server log-loads (the CS station as
    one more column if modelled), ``log_gamma_total [B]`` aggregated IS
    log-loads."""
    if log_rho.dim() != 2:
        raise ValueError(f"log_rho must be [B, S], got {tuple(log_rho.shape)}")
    if log_rho.is_cuda:
        return _launch(log_rho, log_gamma_total, m_max)
    if log_rho.device.type == "cpu":
        return buzen_batched_plain(log_rho, log_gamma_total, m_max)
    raise ValueError(f"no Buzen kernel for device {log_rho.device}")


buzen_batched.launches = 0


def reference_log_Z(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                    m_max: int) -> torch.Tensor:
    """Float64 PyTorch DP on the same ``[B, S]``/``[B]`` layout — the
    gradient donor of :func:`buzen_log_Z_batched`."""
    from ..core.buzen import aggregate_log_Z

    return aggregate_log_Z(log_rho, log_gamma_total, m_max)


class BuzenLogZ(torch.autograd.Function):
    """Kernel forward, float64 reference backward."""

    @staticmethod
    def forward(ctx, log_rho, log_gamma_total, m_max):
        ctx.m_max = m_max
        ctx.save_for_backward(log_rho, log_gamma_total)
        out = buzen_batched(log_rho.detach(), log_gamma_total.detach(), m_max)
        return out.to(log_rho.dtype)

    @staticmethod
    def backward(ctx, g):
        log_rho, log_gamma_total = ctx.saved_tensors
        with torch.enable_grad():
            lr = log_rho.detach().requires_grad_(True)
            lg = log_gamma_total.detach().requires_grad_(True)
            out = reference_log_Z(lr, lg, ctx.m_max)
            g_lr, g_lg = torch.autograd.grad(out, (lr, lg),
                                             g.to(log_rho.dtype))
        # padded (load-0) stations enter as log_rho = -inf: the value does
        # not depend on them, so pin their partials to exactly 0
        g_lr = torch.where(torch.isfinite(log_rho), g_lr, 0.0)
        return g_lr, g_lg, None


def buzen_log_Z_batched(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                        m_max: int) -> torch.Tensor:
    """Differentiable batched Buzen DP: kernel forward cast to the input
    dtype, float64 reference backward (so the optimizer can run on it)."""
    return BuzenLogZ.apply(log_rho, log_gamma_total, m_max)


def buzen_single(log_rho: torch.Tensor, log_gamma_total,
                 m_max: int) -> torch.Tensor:
    """Single-network form: ``[S] -> [m_max + 1]``."""
    lg = torch.as_tensor(log_gamma_total, device=log_rho.device)
    return buzen_batched(log_rho[None, :], lg.reshape(1), m_max)[0]
