"""Batched Buzen DP kernels: the routing optimizer's inner loop (port of
``repro.kernels.buzen``).

Hand-written CUDA kernels in ``csrc/buzen.cu``, one CTA per batch row, the
station (or class) loop inside the block, the running row double-buffered
in shared memory.  All are bound by operations (about ``B * S *
(m+1)(m+2)/2`` exp terms per call), not by the bytes they move.

  * ``repro/kernels/buzen.py::buzen_pallas_batched`` (``_buzen_kernel``)
    -> ``buzen_kernel``: per-client stations, the geometric series
    ``k log_rho`` formed in the kernel; each column's terms spread over the
    whole CTA (a group of lanes per pair of rows), the row carried in
    float64 in log2 units, every exp a float32 ``ex2.approx``;
  * the float64 VJP of ``buzen_log_Z_batched`` (``_buzen_log_Z_bwd``, a
    ``jnp`` VJP, no Pallas kernel) -> ``buzen_backward_kernel``: the
    adjoint of the float64 DP, the rows recomputed in float64 and walked
    back in the same CTA;
  * ``repro/kernels/buzen.py::buzen_classes_pallas_batched``
    (``_buzen_classes_kernel``) -> ``buzen_classes_kernel``: one fold per
    client class through a negative-binomial series built here in float64
    (:func:`_class_series`) and staged into shared memory per class.

Entry points:

  * :func:`buzen_batched` / :func:`buzen_classes_batched` — the raw
    float32 forwards ``[B, S] -> [B, m+1]``: they launch the CUDA kernel
    for CUDA tensors (or raise), and run :func:`buzen_batched_plain` /
    :func:`buzen_classes_batched_plain` — the TPU kernels' arithmetic in
    PyTorch — for CPU tensors only.  Each wrapper's ``launches`` counts its
    kernel's launches.
  * :func:`buzen_log_Z_backward` — the float64 adjoint of the per-client
    DP: the backward kernel for CUDA tensors (or raise),
    :func:`buzen_log_Z_backward_plain` for CPU tensors only; its
    ``launches`` counts the kernel's launches.
  * :func:`buzen_log_Z_batched` / :func:`buzen_classes_log_Z_batched` —
    differentiable wrappers (``torch.autograd.Function``): the forward is
    the kernel; the backward is :func:`buzen_log_Z_backward` per client,
    and differentiates the float64 PyTorch class DP at the same primal
    point per class.
  * :func:`buzen_single` — the single-row per-client form (``B = 1``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.numerics import NEG_INF
from . import build

# the forward's two float64 rows (96 KB) and the backward's four (192 KB)
# in dynamic shared memory
_MAX_M_PAD = 6144


def _init_rows(log_gamma_total: torch.Tensor, m_pad: int,
               dtype=torch.float32) -> torch.Tensor:
    """The aggregated IS Poisson row ``k log gamma - lgamma(k+1)``."""
    k = torch.arange(m_pad, dtype=dtype, device=log_gamma_total.device)
    return (k[None, :] * log_gamma_total[:, None].to(dtype)
            - torch.lgamma(k + 1.0)[None, :])


def _clamp_rho(log_rho: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    # a load-0 station (padded client) arrives as log_rho = -inf: clamp it
    # to the finite mask value so k * log_rho stays NaN-free; its k >= 1
    # terms then underflow to 0 and the station is the identity
    return torch.clamp_min(log_rho.to(dtype), NEG_INF)


def _fold_plain(u: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """One station fold of the kernels' arithmetic in PyTorch: ``u [B, m+1]``
    convolved with ``series [B, m+1]`` by a masked ``(m+1)^2`` logsumexp,
    max then sum, masked terms entering as ``NEG_INF``."""
    m_pad = u.shape[1]
    ar = torch.arange(m_pad, device=u.device)
    valid = ar[None, :] <= ar[:, None]                     # [m, k]: k <= m
    shifted = torch.where(valid, ar[:, None] - ar[None, :], 0)
    terms = torch.where(valid, series[:, None, :] + u[:, shifted], NEG_INF)
    row_max = terms.amax(dim=-1)
    sumexp = torch.exp(terms - row_max[..., None]).sum(dim=-1)
    return row_max + torch.log(sumexp)


def buzen_batched_plain(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                        m_max: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (float32, masked ``(m+1)^2``
    logsumexp per station, max then sum) — what CPU tensors run."""
    m_pad = m_max + 1
    u = _init_rows(log_gamma_total, m_pad)
    rho = _clamp_rho(log_rho)
    kf = torch.arange(m_pad, device=log_rho.device, dtype=torch.float32)
    for s in range(rho.shape[1]):
        u = _fold_plain(u, kf[None, :] * rho[:, s, None])
    return u


def _check_rows(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                m_max: int, limit: int) -> int:
    """Validate the ``[B, S]`` / ``[B]`` layout; returns ``m_pad``."""
    B = log_rho.shape[0]
    m_pad = m_max + 1
    if not 1 <= m_pad <= limit:
        raise ValueError(f"m_max={m_max} outside the kernel's range "
                         f"[0, {limit - 1}]")
    if log_gamma_total.shape != (B,):
        raise ValueError(f"log_gamma_total has shape "
                         f"{tuple(log_gamma_total.shape)}, expected ({B},)")
    if log_gamma_total.device != log_rho.device:
        raise ValueError("log_rho and log_gamma_total on different devices")
    return m_pad


def _launch(symbol: str, counter, rows: torch.Tensor, init: torch.Tensor,
            S: int) -> torch.Tensor:
    """Launch ``csrc/buzen.cu``'s ``symbol(rows, init, out, B, S, m_pad,
    stream)`` on the current stream and count it on ``counter``."""
    B, m_pad = init.shape
    rows, init = rows.contiguous(), init.contiguous()
    out = torch.empty((B, m_pad), dtype=torch.float32, device=init.device)
    fn = getattr(build.load("buzen"), symbol)
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), init.data_ptr(), out.data_ptr(), B, S,
                 m_pad, stream)
    build.check(err, f"{symbol} launch")
    counter.launches += 1
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
        # the kernel carries the row in float64: its inputs are float64
        m_pad = _check_rows(log_rho, log_gamma_total, m_max, _MAX_M_PAD)
        return _launch("buzen_forward", buzen_batched,
                       _clamp_rho(log_rho, torch.float64),
                       _init_rows(log_gamma_total, m_pad, torch.float64),
                       log_rho.shape[1])
    if log_rho.device.type == "cpu":
        return buzen_batched_plain(log_rho, log_gamma_total, m_max)
    raise ValueError(f"no Buzen kernel for device {log_rho.device}")


buzen_batched.launches = 0


def buzen_log_Z_backward_plain(log_rho: torch.Tensor,
                               log_gamma_total: torch.Tensor, g: torch.Tensor,
                               m_max: int):
    """The adjoint of the float64 DP in PyTorch — what CPU tensors run:
    ``(d/d log_rho, d/d log_gamma_total)`` of ``sum(g * log Z)`` at the
    primal point, float64.  With ``U_0`` the Poisson row and ``U_s[m] =
    logsumexp_{k <= m} (U_{s-1}[k] + (m - k) lr_s)``, walking back from
    ``g_S = g``::

        P_s[m, k]  = exp(U_{s-1}[k] + (m - k) lr_s - U_s[m])    (k <= m)
        g_{s-1}[k] = sum_{m >= k} g_s[m] P_s[m, k]
        d/d lr_s   = sum_{m, k} g_s[m] (m - k) P_s[m, k]
        d/d lg     = sum_k k g_0[k]       (k = 0 is pinned in the row)

    A non-finite ``log_rho`` column (a padded station) is an explicit
    identity: the rows and ``g`` pass through and its partial is exactly 0,
    so the real columns' partials are bitwise the unpadded run's."""
    from ..core.buzen import _poisson_series

    lr = log_rho.to(torch.float64)
    g = g.to(torch.float64)
    live = torch.isfinite(lr)
    lr = torch.where(live, lr, 0.0)
    ar = torch.arange(m_max + 1, device=lr.device)
    q = ar[:, None] - ar[None, :]                      # [m, k]: m - k
    valid = q >= 0
    qd = q.clamp_min(0).to(torch.float64)
    rows = [_poisson_series(log_gamma_total.to(torch.float64), m_max)]
    for s in range(lr.shape[1]):
        u = rows[-1]
        terms = torch.where(valid, u[:, None, :] + qd * lr[:, s, None, None],
                            NEG_INF)
        rows.append(torch.where(live[:, s, None],
                                torch.logsumexp(terms, dim=-1), u))
    g_lr = torch.zeros_like(lr)
    for s in reversed(range(lr.shape[1])):
        e = (rows[s][:, None, :] + qd * lr[:, s, None, None]
             - rows[s + 1][:, :, None])
        gp = g[:, :, None] * torch.exp(torch.where(valid, e, -torch.inf))
        g_lr[:, s] = torch.where(live[:, s], (gp * qd).sum(dim=(1, 2)), 0.0)
        g = torch.where(live[:, s, None], gp.sum(dim=1), g)
    return g_lr, (g * ar.to(torch.float64)).sum(dim=-1)


def buzen_log_Z_backward(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                         g: torch.Tensor, m_max: int):
    """``(d/d log_rho [B, S], d/d log_gamma_total [B])`` of ``sum(g * log
    Z)`` for the float64 DP at the primal point (``g [B, m_max+1]``),
    float64: the backward kernel for CUDA tensors (or raise),
    :func:`buzen_log_Z_backward_plain` for CPU tensors only.
    ``buzen_log_Z_backward.launches`` counts the kernel's launches."""
    if log_rho.dim() != 2:
        raise ValueError(f"log_rho must be [B, S], got {tuple(log_rho.shape)}")
    if g.shape != (log_rho.shape[0], m_max + 1):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(log_rho.shape[0], m_max + 1)}")
    if g.device != log_rho.device:
        raise ValueError("log_rho and g on different devices")
    if log_rho.is_cuda:
        from ..core.buzen import _poisson_series

        m_pad = _check_rows(log_rho, log_gamma_total, m_max, _MAX_M_PAD)
        B, S = log_rho.shape
        f64 = dict(dtype=torch.float64, device=log_rho.device)
        lr = log_rho.to(torch.float64).contiguous()
        init = _poisson_series(log_gamma_total.to(torch.float64),
                               m_max).contiguous()
        g = g.to(torch.float64).contiguous()
        rows = torch.empty((B, S + 1, m_pad), **f64)  # U_0..U_S, in L2
        g_lr = torch.empty((B, S), **f64)
        g_lg = torch.empty((B,), **f64)
        fn = build.load("buzen").buzen_backward
        if not fn.argtypes:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        with torch.cuda.device(log_rho.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(lr.data_ptr(), init.data_ptr(), g.data_ptr(),
                     rows.data_ptr(), g_lr.data_ptr(), g_lg.data_ptr(), B,
                     S, m_pad, stream)
        build.check(err, "buzen_backward launch")
        buzen_log_Z_backward.launches += 1
        return g_lr, g_lg
    if log_rho.device.type == "cpu":
        return buzen_log_Z_backward_plain(log_rho, log_gamma_total, g, m_max)
    raise ValueError(f"no Buzen backward kernel for device {log_rho.device}")


buzen_log_Z_backward.launches = 0


class BuzenLogZ(torch.autograd.Function):
    """Kernel forward, float64 adjoint backward (:func:`buzen_log_Z_backward`:
    the backward kernel on CUDA tensors, its plain version on CPU ones)."""

    @staticmethod
    def forward(ctx, log_rho, log_gamma_total, m_max):
        ctx.m_max = m_max
        ctx.save_for_backward(log_rho, log_gamma_total)
        out = buzen_batched(log_rho.detach(), log_gamma_total.detach(), m_max)
        return out.to(log_rho.dtype)

    @staticmethod
    def backward(ctx, g):
        log_rho, log_gamma_total = ctx.saved_tensors
        g_lr, g_lg = buzen_log_Z_backward(log_rho.detach(),
                                          log_gamma_total.detach(), g,
                                          ctx.m_max)
        return (g_lr.to(log_rho.dtype), g_lg.to(log_gamma_total.dtype),
                None)


def buzen_log_Z_batched(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                        m_max: int) -> torch.Tensor:
    """Differentiable batched Buzen DP: kernel forward cast to the input
    dtype, float64 adjoint backward (so the optimizer can run on it)."""
    return BuzenLogZ.apply(log_rho, log_gamma_total, m_max)


def buzen_single(log_rho: torch.Tensor, log_gamma_total,
                 m_max: int) -> torch.Tensor:
    """Single-network form: ``[S] -> [m_max + 1]``."""
    lg = torch.as_tensor(log_gamma_total, device=log_rho.device)
    return buzen_batched(log_rho[None, :], lg.reshape(1), m_max)[0]


# ---------------------------------------------------------------------------
# the class Buzen DP: one fold per client CLASS
# ---------------------------------------------------------------------------

_MAX_M_PAD_CLASSES = 4096  # three f32 rows (U, U', the series) in 48 KB


def _class_series(log_rho: torch.Tensor, counts: torch.Tensor,
                  m_pad: int) -> torch.Tensor:
    """The negative-binomial series ``[B, S, m_pad]`` of every class
    column, built in float64 and rounded once to float32:

        ``k max(log_rho, NEG_INF) + lgamma(k + count) - lgamma(k + 1)
          - lgamma(count)``, clamped below at ``NEG_INF``, ``k = 0``
        pinned to 0 (``torch.where``, after it is formed).

    The JAX package's kernel forms this in float32, where
    ``lgamma(k + count) - lgamma(count)`` cancels: both terms are about
    ``count log count``, so at ``count = 4e5`` (Table 1 at n = 1e6) most of
    the difference's digits are lost and log Z misses the float64 DP by
    about 0.1.  Built in float64 the series is exact to float32 rounding,
    and the kernel holds its stated bound (``rtol/atol 2e-5`` against the
    float64 DP up to rounding of log Z itself) at every population.  A
    count-0 (padded) column is ``[0, NEG_INF, ...]``: the identity."""
    k = torch.arange(m_pad, dtype=torch.float64, device=log_rho.device)
    cnt = counts.to(torch.float64)[..., None]
    lr = torch.clamp_min(log_rho.to(torch.float64), NEG_INF)[..., None]
    series = (k * lr + torch.lgamma(k + cnt) - torch.lgamma(k + 1.0)
              - torch.lgamma(cnt))
    series = torch.where(k == 0, 0.0, torch.clamp_min(series, NEG_INF))
    return series.to(torch.float32)


def buzen_classes_batched_plain(log_rho: torch.Tensor, counts: torch.Tensor,
                                log_gamma_total: torch.Tensor,
                                m_max: int) -> torch.Tensor:
    """The class kernel's arithmetic in PyTorch (float32, one masked
    ``(m+1)^2`` logsumexp per class column, max then sum) — what CPU
    tensors run."""
    m_pad = m_max + 1
    return _fold_series_plain(_init_rows(log_gamma_total, m_pad),
                              _class_series(log_rho, counts, m_pad))


def _fold_series_plain(u: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """The class DP on a built series: ``u [B, m+1]`` folded through every
    class column of ``series [B, S, m+1]`` in order."""
    for s in range(series.shape[1]):
        u = _fold_plain(u, series[:, s])
    return u


def buzen_classes_batched(log_rho: torch.Tensor, counts: torch.Tensor,
                          log_gamma_total: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """``log Z_{., 0..m_max}`` (float32 ``[B, m_max+1]``) for a batch of
    class-aggregated networks: ``log_rho``/``counts`` ``[B, S]`` per-member
    log-loads and multiplicities (the CS station as one more count-1
    column if modelled), ``log_gamma_total [B]`` the aggregated IS
    log-loads.  Launches the CUDA kernel for CUDA tensors (or raises);
    :func:`buzen_classes_batched_plain` for CPU tensors only.
    ``buzen_classes_batched.launches`` counts the kernel's launches."""
    if log_rho.dim() != 2 or counts.shape != log_rho.shape:
        raise ValueError(f"log_rho and counts must both be [B, S], got "
                         f"{tuple(log_rho.shape)} and {tuple(counts.shape)}")
    if counts.device != log_rho.device:
        raise ValueError("log_rho and counts on different devices")
    if log_rho.is_cuda:
        m_pad = _check_rows(log_rho, log_gamma_total, m_max,
                            _MAX_M_PAD_CLASSES)
        return _launch("buzen_classes_forward", buzen_classes_batched,
                       _class_series(log_rho, counts, m_pad),
                       _init_rows(log_gamma_total, m_pad), log_rho.shape[1])
    if log_rho.device.type == "cpu":
        return buzen_classes_batched_plain(log_rho, counts, log_gamma_total,
                                           m_max)
    raise ValueError(f"no class Buzen kernel for device {log_rho.device}")


buzen_classes_batched.launches = 0


def reference_class_log_Z(log_rho: torch.Tensor, counts: torch.Tensor,
                          log_gamma_total: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """Float64 PyTorch class DP on the same layout — the gradient donor of
    :func:`buzen_classes_log_Z_batched`."""
    from ..core.buzen import aggregate_class_log_Z

    return aggregate_class_log_Z(log_rho, counts, log_gamma_total, m_max)


class BuzenClassesLogZ(torch.autograd.Function):
    """Class kernel forward, float64 reference backward; ``counts`` are
    structural integers and take no gradient."""

    @staticmethod
    def forward(ctx, log_rho, counts, log_gamma_total, m_max):
        ctx.m_max = m_max
        ctx.save_for_backward(log_rho, counts, log_gamma_total)
        out = buzen_classes_batched(log_rho.detach(), counts,
                                    log_gamma_total.detach(), m_max)
        return out.to(log_rho.dtype)

    @staticmethod
    def backward(ctx, g):
        log_rho, counts, log_gamma_total = ctx.saved_tensors
        with torch.enable_grad():
            lr = log_rho.detach().requires_grad_(True)
            lg = log_gamma_total.detach().requires_grad_(True)
            out = reference_class_log_Z(lr, counts, lg, ctx.m_max)
            g_lr, g_lg = torch.autograd.grad(out, (lr, lg),
                                             g.to(log_rho.dtype))
        # padded classes (count 0, or load 0) are convolution identities:
        # the value does not depend on them, so pin their partials to 0
        live = torch.isfinite(log_rho) & (counts > 0)
        return torch.where(live, g_lr, 0.0), None, g_lg, None


def buzen_classes_log_Z_batched(log_rho: torch.Tensor, counts: torch.Tensor,
                                log_gamma_total: torch.Tensor,
                                m_max: int) -> torch.Tensor:
    """Differentiable batched class Buzen DP: kernel forward cast to the
    input dtype, float64 reference backward."""
    return BuzenClassesLogZ.apply(log_rho, counts, log_gamma_total, m_max)
