"""Batched Buzen DP kernels: the routing optimizer's inner loop (port of
``repro.kernels.buzen``).

Hand-written CUDA kernels in ``csrc/buzen.cu``, one CTA per batch row, the
station (or class) loop inside the block, the running row double-buffered
in shared memory, each column's terms spread over the whole CTA (a group of
lanes per pair of rows).  All are bound by operations (about ``B * S *
(m+1)(m+2)/2`` exp terms per call), not by the bytes they move.

  * ``repro/kernels/buzen.py::buzen_pallas_batched`` (``_buzen_kernel``)
    -> ``buzen_kernel``: per-client stations, the geometric series
    ``k log_rho`` formed in the kernel, the row carried in float64 in log2
    units, every exp a float32 ``ex2.approx``;
  * ``repro/kernels/buzen.py::buzen_classes_pallas_batched``
    (``_buzen_classes_kernel``) -> ``buzen_classes_kernel``: one fold per
    client class through its negative-binomial series, which the kernel
    builds itself in float64 (the card's double ``lgamma``) from the raw
    ``log_rho``, ``counts`` and ``log_gamma_total``; float64 terms and row,
    each exponent rounded to float32 for ``ex2.approx``;
  * the float64 VJPs of ``buzen_log_Z_batched`` and
    ``buzen_classes_log_Z_batched`` (``_buzen_log_Z_bwd`` and
    ``_buzen_classes_log_Z_bwd``, ``jnp`` VJPs, no Pallas kernel) ->
    ``buzen_backward_kernel<false>`` and ``<true>``: the adjoint of the
    float64 DP, the rows recomputed in float64 and walked back in the same
    CTA, one template over the column's term.

Entry points:

  * :func:`buzen_batched` / :func:`buzen_classes_batched` — the raw
    float32 forwards ``[B, S] -> [B, m+1]``: they launch the CUDA kernel
    for CUDA tensors (or raise), and run :func:`buzen_batched_plain` /
    :func:`buzen_classes_batched_plain` — the TPU kernels' arithmetic in
    PyTorch — for CPU tensors only.  Each wrapper's ``launches`` counts its
    kernel's launches.
  * :func:`buzen_log_Z_backward` / :func:`buzen_classes_log_Z_backward`
    — the float64 adjoints of the two DPs: the backward kernel for CUDA
    tensors (or raise), :func:`buzen_log_Z_backward_plain` /
    :func:`buzen_classes_log_Z_backward_plain` for CPU tensors only; each
    wrapper's ``launches`` counts its kernel's launches.
  * :func:`buzen_log_Z_batched` / :func:`buzen_classes_log_Z_batched` —
    differentiable wrappers (``torch.autograd.Function``): the forward is
    the kernel, the backward the adjoint wrapper (one launch each on the
    card, no autograd graph).
  * :func:`buzen_single` — the single-row per-client form (``B = 1``).
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

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
    # contract: allow(raw-reduction): sum over the k <= m convolution axis within ONE station — the station axis is the Python loop (the kernel's column walk), and this float32 path is rtol-validated, not bitwise
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


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64).contiguous()


def _launch(symbol: str, tensors, ints) -> None:
    """Call ``csrc/buzen.cu``'s ``symbol(*tensors, *ints, stream)`` (the
    tensors' data pointers, the ints, the current stream of the first
    tensor's device); raise on a CUDA error."""
    fn = getattr(build.load("buzen"), symbol)
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    build.check(err, f"{symbol} launch")


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
        B, S = log_rho.shape
        out = torch.empty((B, m_pad), dtype=torch.float32,
                          device=log_rho.device)
        _launch("buzen_forward",
                (_clamp_rho(log_rho, torch.float64).contiguous(),
                 _init_rows(log_gamma_total, m_pad,
                            torch.float64).contiguous(), out),
                (B, S, m_pad))
        build.count(buzen_batched)
        return out
    if log_rho.device.type == "cpu":
        return buzen_batched_plain(log_rho, log_gamma_total, m_max)
    raise ValueError(f"no Buzen kernel for device {log_rho.device}")


buzen_batched.launches = 0


def _adjoint_plain(series: torch.Tensor, live: torch.Tensor,
                   init: torch.Tensor, g: torch.Tensor):
    """The adjoint of a float64 DP in PyTorch: ``(d/d log_rho, d/d
    log_gamma_total)`` of ``sum(g * log Z)`` at the primal point, float64.
    ``series [B, S, m+1]`` is each column's series ``w_s`` (``d w_s[q] /
    d log_rho_s = q``), ``live [B, S]`` marks the real columns, ``init``
    is the Poisson row ``U_0``.  With ``U_s[m] = logsumexp_{k <= m}
    (U_{s-1}[k] + w_s[m - k])``, walking back from ``g_S = g``::

        P_s[m, k]  = exp(U_{s-1}[k] + w_s[m - k] - U_s[m])      (k <= m)
        g_{s-1}[k] = sum_{m >= k} g_s[m] P_s[m, k]
        d/d lr_s   = sum_{m, k} g_s[m] (m - k) P_s[m, k]
        d/d lg     = sum_k k g_0[k]       (k = 0 is pinned in the row)

    A padded column is an explicit identity: the rows and ``g`` pass
    through and its partial is exactly 0, so the real columns' partials
    are bitwise the unpadded run's."""
    ar = torch.arange(init.shape[1], device=init.device)
    q = ar[:, None] - ar[None, :]                      # [m, k]: m - k
    valid = q >= 0
    qi = q.clamp_min(0)
    qd = qi.to(torch.float64)
    rows = [init]
    for s in range(series.shape[1]):
        u = rows[-1]
        terms = torch.where(valid, u[:, None, :] + series[:, s][:, qi],
                            NEG_INF)
        rows.append(torch.where(live[:, s, None],
                                # contract: allow(raw-reduction): logsumexp over the k <= m convolution axis within ONE column — the column axis is the Python loop, and a padded column passes through as an explicit identity
                                torch.logsumexp(terms, dim=-1), u))
    g_lr = torch.zeros(live.shape, dtype=torch.float64, device=init.device)
    for s in reversed(range(series.shape[1])):
        e = rows[s][:, None, :] + series[:, s][:, qi] - rows[s + 1][:, :, None]
        gp = g[:, :, None] * torch.exp(torch.where(valid, e, -torch.inf))
        # contract: allow(raw-reduction): sum over the (m, k) convolution axes of ONE column's partial — the column axis is the Python loop, never summed
        g_lr[:, s] = torch.where(live[:, s], (gp * qd).sum(dim=(1, 2)), 0.0)
        # contract: allow(raw-reduction): sum over the m convolution axis of ONE column — the column axis is the Python loop, never summed
        g = torch.where(live[:, s, None], gp.sum(dim=1), g)
    # contract: allow(raw-reduction): sum over the k = 0..m_max axis of the Poisson row's adjoint — static length, never client/class padded
    return g_lr, (g * ar.to(torch.float64)).sum(dim=-1)


def buzen_log_Z_backward_plain(log_rho: torch.Tensor,
                               log_gamma_total: torch.Tensor, g: torch.Tensor,
                               m_max: int):
    """The adjoint of the per-client float64 DP in PyTorch — what CPU
    tensors run: :func:`_adjoint_plain` with the geometric series ``w_s[q]
    = q lr_s``; a non-finite ``log_rho`` column (a padded station) is the
    identity."""
    from ..core.buzen import _poisson_series

    lr = log_rho.to(torch.float64)
    live = torch.isfinite(lr)
    k = torch.arange(m_max + 1, dtype=torch.float64, device=lr.device)
    return _adjoint_plain(k * torch.where(live, lr, 0.0)[..., None], live,
                          _poisson_series(log_gamma_total.to(torch.float64),
                                          m_max), g.to(torch.float64))


def _check_backward(log_rho: torch.Tensor, g: torch.Tensor, m_max: int):
    if log_rho.dim() != 2:
        raise ValueError(f"log_rho must be [B, S], got {tuple(log_rho.shape)}")
    if g.shape != (log_rho.shape[0], m_max + 1):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(log_rho.shape[0], m_max + 1)}")
    if g.device != log_rho.device:
        raise ValueError("log_rho and g on different devices")


def _launch_backward(symbol: str, log_rho: torch.Tensor, counts,
                     log_gamma_total: torch.Tensor, g: torch.Tensor,
                     m_max: int, limit: int):
    """Launch ``symbol`` (``buzen_backward`` or, with ``counts``,
    ``buzen_classes_backward``): float64 inputs, the ``[B, S+1, m_pad]``
    rows scratch and both partials allocated here."""
    m_pad = _check_rows(log_rho, log_gamma_total, m_max, limit)
    B, S = log_rho.shape
    f64 = dict(dtype=torch.float64, device=log_rho.device)
    rows = torch.empty((B, S + 1, m_pad), **f64)  # U_0..U_S, in L2
    g_lr = torch.empty((B, S), **f64)
    g_lg = torch.empty((B,), **f64)
    ins = (_f64(log_rho),) + (() if counts is None else (_f64(counts),))
    _launch(symbol, ins + (_f64(log_gamma_total), _f64(g), rows, g_lr, g_lg),
            (B, S, m_pad))
    return g_lr, g_lg


def buzen_log_Z_backward(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                         g: torch.Tensor, m_max: int):
    """``(d/d log_rho [B, S], d/d log_gamma_total [B])`` of ``sum(g * log
    Z)`` for the float64 DP at the primal point (``g [B, m_max+1]``),
    float64: the backward kernel for CUDA tensors (or raise),
    :func:`buzen_log_Z_backward_plain` for CPU tensors only.
    ``buzen_log_Z_backward.launches`` counts the kernel's launches."""
    _check_backward(log_rho, g, m_max)
    if log_rho.is_cuda:
        out = _launch_backward("buzen_backward", log_rho, None,
                               log_gamma_total, g, m_max, _MAX_M_PAD)
        build.count(buzen_log_Z_backward)
        return out
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

# in dynamic shared memory, the forward's three float64 rows (two of U,
# lgamma(k + 1)) and at least one class's series (128 KB at 4096), the
# backward's five and one series (193 KB)
_MAX_M_PAD_CLASSES = 4096


def _class_series(log_rho: torch.Tensor, counts: torch.Tensor, m_pad: int,
                  dtype=torch.float32) -> torch.Tensor:
    """The negative-binomial series ``[B, S, m_pad]`` of every class
    column, built in float64 and rounded once to ``dtype``:

        ``k max(log_rho, NEG_INF) + lgamma(k + count) - lgamma(k + 1)
          - lgamma(count)``, clamped below at ``NEG_INF``, ``k = 0``
        pinned to 0 (``torch.where``, after it is formed).

    The JAX package's kernel forms this in float32, where
    ``lgamma(k + count) - lgamma(count)`` cancels: both terms are about
    ``count log count``, so at ``count = 4e5`` (Table 1 at n = 1e6) most of
    the difference's digits are lost and log Z misses the float64 DP by
    about 0.1.  Built in float64 the series is exact to float32 rounding,
    and the plain version holds its stated bound (``rtol/atol 2e-5``
    against the float64 DP up to rounding of log Z itself) at every
    population.  A count-0 (padded) column is ``[0, NEG_INF, ...]``: the
    identity.  The class kernels build the same series on the card, step
    by step in this order."""
    k = torch.arange(m_pad, dtype=torch.float64, device=log_rho.device)
    cnt = counts.to(torch.float64)[..., None]
    lr = torch.clamp_min(log_rho.to(torch.float64), NEG_INF)[..., None]
    series = (k * lr + torch.lgamma(k + cnt) - torch.lgamma(k + 1.0)
              - torch.lgamma(cnt))
    series = torch.where(k == 0, 0.0, torch.clamp_min(series, NEG_INF))
    return series.to(dtype)


def _class_live(log_rho: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The real class columns: a positive count and a ``log_rho`` finite
    above ``NEG_INF``; the rest (padded classes) are identities, skipped by
    the class kernels and pinned to a 0 partial."""
    return torch.isfinite(log_rho) & (log_rho > NEG_INF) & (counts > 0)


def buzen_classes_batched_plain(log_rho: torch.Tensor, counts: torch.Tensor,
                                log_gamma_total: torch.Tensor,
                                m_max: int) -> torch.Tensor:
    """The TPU class kernel's arithmetic in PyTorch on the float64-built
    series (float32, one masked ``(m+1)^2`` logsumexp per class column, max
    then sum) — what CPU tensors run."""
    m_pad = m_max + 1
    u = _init_rows(log_gamma_total, m_pad)
    series = _class_series(log_rho, counts, m_pad)
    for s in range(series.shape[1]):
        u = _fold_plain(u, series[:, s])
    return u


def _check_classes(log_rho: torch.Tensor, counts: torch.Tensor) -> None:
    if log_rho.dim() != 2 or counts.shape != log_rho.shape:
        raise ValueError(f"log_rho and counts must both be [B, S], got "
                         f"{tuple(log_rho.shape)} and {tuple(counts.shape)}")
    if counts.device != log_rho.device:
        raise ValueError("log_rho and counts on different devices")


def buzen_classes_batched(log_rho: torch.Tensor, counts: torch.Tensor,
                          log_gamma_total: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """``log Z_{., 0..m_max}`` (float32 ``[B, m_max+1]``) for a batch of
    class-aggregated networks: ``log_rho``/``counts`` ``[B, S]`` per-member
    log-loads and multiplicities (the CS station as one more count-1
    column if modelled), ``log_gamma_total [B]`` the aggregated IS
    log-loads.  For CUDA tensors one launch of the class kernel, which
    builds the Poisson row and every series itself (or raise);
    :func:`buzen_classes_batched_plain` for CPU tensors only.
    ``buzen_classes_batched.launches`` counts the kernel's launches."""
    _check_classes(log_rho, counts)
    if log_rho.is_cuda:
        m_pad = _check_rows(log_rho, log_gamma_total, m_max,
                            _MAX_M_PAD_CLASSES)
        B, S = log_rho.shape
        out = torch.empty((B, m_pad), dtype=torch.float32,
                          device=log_rho.device)
        _launch("buzen_classes_forward", (_f64(log_rho), _f64(counts),
                                          _f64(log_gamma_total), out),
                (B, S, m_pad))
        build.count(buzen_classes_batched)
        return out
    if log_rho.device.type == "cpu":
        return buzen_classes_batched_plain(log_rho, counts, log_gamma_total,
                                           m_max)
    raise ValueError(f"no class Buzen kernel for device {log_rho.device}")


buzen_classes_batched.launches = 0


def buzen_classes_log_Z_backward_plain(log_rho: torch.Tensor,
                                       counts: torch.Tensor,
                                       log_gamma_total: torch.Tensor,
                                       g: torch.Tensor, m_max: int):
    """The adjoint of the float64 class DP in PyTorch — what CPU tensors
    run: :func:`_adjoint_plain` with each class's float64 series
    (:func:`_class_series`, whose derivative in ``log_rho`` is its index);
    padded classes (:func:`_class_live`) are identities with a 0 partial,
    and ``counts`` take no gradient."""
    from ..core.buzen import _poisson_series

    lr = log_rho.to(torch.float64)
    return _adjoint_plain(
        _class_series(lr, counts, m_max + 1, torch.float64),
        _class_live(lr, counts),
        _poisson_series(log_gamma_total.to(torch.float64), m_max),
        g.to(torch.float64))


def buzen_classes_log_Z_backward(log_rho: torch.Tensor, counts: torch.Tensor,
                                 log_gamma_total: torch.Tensor,
                                 g: torch.Tensor, m_max: int):
    """``(d/d log_rho [B, S], d/d log_gamma_total [B])`` of ``sum(g * log
    Z)`` for the float64 class DP at the primal point (``g [B,
    m_max+1]``), float64: one launch of the class backward kernel for CUDA
    tensors (or raise), :func:`buzen_classes_log_Z_backward_plain` for CPU
    tensors only.  ``buzen_classes_log_Z_backward.launches`` counts the
    kernel's launches."""
    _check_classes(log_rho, counts)
    _check_backward(log_rho, g, m_max)
    if log_rho.is_cuda:
        out = _launch_backward("buzen_classes_backward", log_rho, counts,
                               log_gamma_total, g, m_max, _MAX_M_PAD_CLASSES)
        build.count(buzen_classes_log_Z_backward)
        return out
    if log_rho.device.type == "cpu":
        return buzen_classes_log_Z_backward_plain(log_rho, counts,
                                                  log_gamma_total, g, m_max)
    raise ValueError(f"no class Buzen backward kernel for device "
                     f"{log_rho.device}")


buzen_classes_log_Z_backward.launches = 0


def reference_class_log_Z(log_rho: torch.Tensor, counts: torch.Tensor,
                          log_gamma_total: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """Float64 PyTorch class DP on the same layout — what the class kernel
    is held against."""
    from ..core.buzen import aggregate_class_log_Z

    return aggregate_class_log_Z(log_rho, counts, log_gamma_total, m_max)


class BuzenClassesLogZ(torch.autograd.Function):
    """Class kernel forward, float64 adjoint backward
    (:func:`buzen_classes_log_Z_backward`: the backward kernel on CUDA
    tensors, its plain version on CPU ones); ``counts`` are structural
    integers and take no gradient."""

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
        g_lr, g_lg = buzen_classes_log_Z_backward(
            log_rho.detach(), counts, log_gamma_total.detach(), g, ctx.m_max)
        return (g_lr.to(log_rho.dtype), None,
                g_lg.to(log_gamma_total.dtype), None)


def buzen_classes_log_Z_batched(log_rho: torch.Tensor, counts: torch.Tensor,
                                log_gamma_total: torch.Tensor,
                                m_max: int) -> torch.Tensor:
    """Differentiable batched class Buzen DP: kernel forward cast to the
    input dtype, float64 adjoint backward."""
    return BuzenClassesLogZ.apply(log_rho, counts, log_gamma_total, m_max)
