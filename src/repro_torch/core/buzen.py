"""Buzen's algorithm for the closed-network normalising constants (port of
``repro.core.buzen``).

Proposition 15 (client-only network) and Proposition 19 (with the CS-side
single-server queue), in log space.  ``method="aggregate"`` merges the
``2n`` infinite-server stations into one Poisson factor of total load
``gamma_tot``; ``method="literal"`` folds every station in the order of
Prop. 15.  Both return ``logZ[..., k] = log Z_{n,k}`` for ``k = 0..m_max``.
The class half (:class:`ClassParams`, :func:`pad_classes`,
:func:`classes_from_network`, :func:`class_log_normalizing_constants`)
folds ``count`` identical clients into one negative-binomial factor, so
the DP is O(C m^2) whatever the population.

Backends: ``"torch"`` (the float64 DPs below, the default) and ``"kernel"``
(the hand-written CUDA Buzen kernels of ``repro_torch.kernels.buzen``: a
float32 forward with a float64 backward, ``aggregate`` only).  Select per
call with ``backend=`` or process-wide with :func:`set_backend`; no
environment variable is read.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import functools
import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .numerics import NEG_INF, seqsum

_BACKENDS = ("torch", "kernel")
_backend = "torch"


def set_backend(name: str) -> None:
    """Set the process-wide default Buzen backend (``"torch"``/``"kernel"``)."""
    global _backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown buzen backend: {name!r}")
    _backend = name


def get_backend() -> str:
    return _backend


class NetworkParams(NamedTuple):
    """Rates of the closed queueing network (Section 2.6 / 7.1).

    Leaves are float64 tensors on one device.  ``p`` may carry leading
    batch axes (``[..., n]``, one routing row per batch entry) while the
    rates stay ``[n]``; lane-stacked networks (``stack_lanes``) carry one
    lane axis on every leaf (``p [L, n]``, ``n_active [L]``).  Padded-``n``
    convention: rows beyond ``n_active`` carry zero routing mass and unit
    rates (:func:`pad_network`); ``n_active is None`` means every row is
    real.
    """

    p: torch.Tensor
    mu_c: torch.Tensor
    mu_d: torch.Tensor
    mu_u: torch.Tensor
    mu_cs: Optional[torch.Tensor] = None  # scalar CS rate (None = no CS)
    n_active: Optional[torch.Tensor] = None  # real-client count (None = n)

    @property
    def n(self) -> int:
        return self.p.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.p.device

    @property
    def active_count(self):
        return self.n if self.n_active is None else self.n_active

    @property
    def active_mask(self) -> Optional[torch.Tensor]:
        if self.n_active is None:
            return None
        # [..., n]: a lane-stacked n_active [L] gives one mask row per lane
        return (torch.arange(self.n, device=self.device)
                < self.n_active[..., None])

    @property
    def log_rho(self) -> torch.Tensor:
        return torch.log(self.p) - torch.log(self.mu_c)

    @property
    def gamma(self) -> torch.Tensor:
        return self.p * (1.0 / self.mu_d + 1.0 / self.mu_u)

    @property
    def log_gamma_total(self) -> torch.Tensor:
        # sequential sum: padded clients (gamma = 0) stay bitwise invisible
        return torch.log(seqsum(self.gamma))

    def with_cs(self, mu_cs) -> "NetworkParams":
        return self._replace(mu_cs=torch.as_tensor(
            mu_cs, dtype=self.p.dtype, device=self.device))


def pad_network(params: NetworkParams, n_max: int) -> NetworkParams:
    """Pad to ``n_max`` client rows: zero routing mass, unit rates, and
    ``n_active`` recording the real population — every closed form and the
    event engine then give **bitwise** the unpadded result."""
    n = params.n
    if n_max < n:
        raise ValueError(f"n_max={n_max} is smaller than the network's "
                         f"population n={n}")
    n_act = params.active_count

    def pad(x, fill):
        tail = torch.full(x.shape[:-1] + (n_max - n,), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=-1)

    return params._replace(
        p=pad(params.p, 0.0), mu_c=pad(params.mu_c, 1.0),
        mu_d=pad(params.mu_d, 1.0), mu_u=pad(params.mu_u, 1.0),
        n_active=torch.as_tensor(n_act, dtype=torch.int64,
                                 device=params.device))


class ClassParams(NamedTuple):
    """Class-aggregated network: ``C`` client classes with multiplicities.

    ``count[c]`` identical clients of profile ``(p, mu_c, mu_d, mu_u)``
    fold into one class: their computation stations enter the Buzen DP as
    one negative-binomial series (:func:`_negbinom_series`), the IS
    stations through the aggregate Poisson factor, so the DP, the closed
    forms and the event engine's statistics are O(C) whatever the
    population.  ``p`` is the per-member routing mass (the class carries
    ``count * p``).  Padded classes (:func:`pad_classes`) have ``count = 0``
    and ``p = 0`` and are bitwise invisible.  Leaves may carry a leading
    lane or batch axis (``p [..., C]``).  :meth:`expand` unrolls to the
    per-client :class:`NetworkParams`, the oracle of every class form.
    """

    p: torch.Tensor        # [C] per-member routing mass (0 on padded)
    mu_c: torch.Tensor     # [C] computation rates
    mu_d: torch.Tensor     # [C] downlink rates
    mu_u: torch.Tensor     # [C] uplink rates
    count: torch.Tensor    # [C] int64 multiplicity (0 = padded class)
    mu_cs: Optional[torch.Tensor] = None  # scalar CS rate (None = no CS)

    @property
    def C(self) -> int:
        return self.p.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.p.device

    @property
    def n_total(self) -> torch.Tensor:
        """Total population ``sum_c count[c]`` (sequential; int64)."""
        return seqsum(self.count)

    @property
    def mass(self) -> torch.Tensor:
        """Class routing mass ``count * p`` (what routing draws on)."""
        return self.count.to(self.p.dtype) * self.p

    @property
    def log_rho(self) -> torch.Tensor:
        """Per-member log-load of one computation station: the reference's
        ``log p - log mu_c`` (``-inf`` where ``p = 0``), with the ``log``
        taken of a pinned-safe ``p`` so that a zero-mass class passes a
        zero gradient to ``p`` rather than ``0 / 0`` (a sweep over
        :func:`pad_classes` stays finite)."""
        live = self.p > 0
        lr = torch.log(torch.where(live, self.p, 1.0)) - torch.log(self.mu_c)
        return torch.where(live, lr, -torch.inf)

    @property
    def gamma(self) -> torch.Tensor:
        """Per-member aggregate IS load (Theorem 2)."""
        return self.p * (1.0 / self.mu_d + 1.0 / self.mu_u)

    @property
    def log_gamma_total(self) -> torch.Tensor:
        """Aggregate IS log-load of the whole population (sequential)."""
        return torch.log(seqsum(self.count.to(self.p.dtype) * self.gamma))

    def with_cs(self, mu_cs) -> "ClassParams":
        return self._replace(mu_cs=torch.as_tensor(
            mu_cs, dtype=self.p.dtype, device=self.device))

    def expand(self) -> NetworkParams:
        """Unroll to the per-client network (O(n); the test oracle)."""
        reps = self.count.to(torch.int64)

        def rep(x):
            return torch.repeat_interleave(x, reps)

        return NetworkParams(p=rep(self.p), mu_c=rep(self.mu_c),
                             mu_d=rep(self.mu_d), mu_u=rep(self.mu_u),
                             mu_cs=self.mu_cs)


def pad_classes(classes: ClassParams, c_max: int) -> ClassParams:
    """Pad to ``c_max`` classes: zero count, zero routing mass and unit
    rates — bitwise invisible to the class DP, the class forms and the
    class event engine (the class analogue of :func:`pad_network`)."""
    C = classes.C
    if c_max < C:
        raise ValueError(f"c_max={c_max} is smaller than the class-set "
                         f"size C={C}")

    def pad(x, fill):
        tail = torch.full(x.shape[:-1] + (c_max - C,), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=-1)

    return classes._replace(
        p=pad(classes.p, 0.0), mu_c=pad(classes.mu_c, 1.0),
        mu_d=pad(classes.mu_d, 1.0), mu_u=pad(classes.mu_u, 1.0),
        count=pad(classes.count, 0))


def classes_from_network(params: NetworkParams) -> ClassParams:
    """Group the clients of a concrete network with bitwise-equal
    ``(p, mu_c, mu_d, mu_u)`` profiles into classes, in order of first
    occurrence (the class order is the DP's fold order).  Padded rows
    (beyond ``n_active``) are dropped.  Host-side."""
    n = params.n if params.n_active is None else int(params.n_active)
    cols = np.stack([x.detach().cpu().numpy()[:n] for x in
                     (params.p, params.mu_c, params.mu_d, params.mu_u)],
                    axis=1)
    _, first, counts = np.unique(cols, axis=0, return_index=True,
                                 return_counts=True)
    order = np.argsort(first)  # undo np.unique's lexicographic sort
    cols_u = cols[np.sort(first)]

    def t(x):
        return torch.as_tensor(x, dtype=params.p.dtype, device=params.device)

    return ClassParams(p=t(cols_u[:, 0]), mu_c=t(cols_u[:, 1]),
                       mu_d=t(cols_u[:, 2]), mu_u=t(cols_u[:, 3]),
                       count=torch.as_tensor(counts[order], dtype=torch.int64,
                                             device=params.device),
                       mu_cs=params.mu_cs)


@functools.lru_cache(maxsize=None)
def _conv_index(M: int, device: torch.device):
    """``rev[m, k] = m - k`` clipped at 0, and the ``k <= m`` mask."""
    ar = torch.arange(M + 1, device=device)
    rev = ar[:, None] - ar[None, :]
    return rev.clamp_min(0), rev >= 0


def _log_conv(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """Truncated log-space convolution over the last axis:
    ``out[..., m] = logsumexp_{k<=m} (log_a[..., k] + log_b[..., m - k])``."""
    M = log_a.shape[-1] - 1
    rev, valid = _conv_index(M, log_a.device)
    terms = torch.where(valid, log_a[..., None, :] + log_b[..., rev], NEG_INF)
    # contract: allow(raw-reduction): logsumexp over the k = 0..m_max convolution axis — static length m_max + 1, never client/class padded
    return torch.logsumexp(terms, dim=-1)


def _geometric_series(log_rho: torch.Tensor, m_max: int) -> torch.Tensor:
    """``[k log_rho for k in 0..m_max]`` (trailing axis); ``k = 0`` pinned to
    0 so a load-0 station (``log_rho = -inf``) is the convolution identity."""
    log_rho = torch.as_tensor(log_rho)
    k = torch.arange(m_max + 1, device=log_rho.device)
    return torch.where(k == 0, 0.0, k * log_rho[..., None])


def _poisson_series(log_load: torch.Tensor, m_max: int) -> torch.Tensor:
    """``[k log_load - log k! for k in 0..m_max]`` (``k = 0`` pinned)."""
    log_load = torch.as_tensor(log_load)
    k = torch.arange(m_max + 1, device=log_load.device, dtype=log_load.dtype)
    return torch.where(k == 0, 0.0,
                       k * log_load[..., None] - torch.lgamma(k + 1.0))


def _negbinom_series(log_rho: torch.Tensor, count: torch.Tensor,
                     m_max: int) -> torch.Tensor:
    """Series of ``count`` identical single-server stations of per-member
    load ``rho`` (trailing axis): ``(1 - rho x)^{-count}``, in log space

        ``coef[j] = j log_rho + lgamma(j + count) - lgamma(j + 1)
                    - lgamma(count)``.

    ``count = 0`` (a padded class) makes every ``j >= 1`` coefficient
    ``-inf``; the ``j = 0`` term (``NaN`` there, ``inf - inf``) is pinned
    to exactly 0 after it is formed, so the class is the convolution
    identity.  ``count = 1`` gives the geometric series exactly."""
    log_rho = torch.as_tensor(log_rho)
    j = torch.arange(m_max + 1, device=log_rho.device, dtype=log_rho.dtype)
    cnt = torch.as_tensor(count, device=log_rho.device).to(
        log_rho.dtype)[..., None]
    lw = torch.lgamma(j + cnt) - torch.lgamma(j + 1.0) - torch.lgamma(cnt)
    return torch.where(j == 0, 0.0, j * log_rho[..., None] + lw)


def aggregate_class_log_Z(log_rho: torch.Tensor, counts: torch.Tensor,
                          log_gamma_total: torch.Tensor,
                          m_max: int) -> torch.Tensor:
    """Class DP on the ``[..., S]`` / ``[...]`` layout: the Poisson row of
    ``gamma_tot``, then one negative-binomial fold per class column."""
    logZ = _poisson_series(log_gamma_total, m_max)
    for s in range(log_rho.shape[-1]):
        logZ = _log_conv(logZ, _negbinom_series(log_rho[..., s],
                                                counts[..., s], m_max))
    return logZ


def aggregate_log_Z(log_rho: torch.Tensor, log_gamma_total: torch.Tensor,
                    m_max: int) -> torch.Tensor:
    """Aggregate-IS DP on the ``[..., S]`` / ``[...]`` layout: the Poisson
    row of ``gamma_tot``, then one geometric fold per station column."""
    logZ = _poisson_series(log_gamma_total, m_max)
    for s in range(log_rho.shape[-1]):
        logZ = _log_conv(logZ, _geometric_series(log_rho[..., s], m_max))
    return logZ


def log_normalizing_constants(params: NetworkParams, m_max: int, *,
                              method: str = "aggregate",
                              backend: Optional[str] = None) -> torch.Tensor:
    """``log Z_{n,m}`` for ``m = 0..m_max`` (trailing axis).

    Includes the CS station when ``params.mu_cs`` is set (the ``W_{n,m}``
    of Prop. 19).  The ``"kernel"`` backend implements ``aggregate`` only.
    """
    backend = _backend if backend is None else backend
    if backend == "kernel":
        if method != "aggregate":
            raise ValueError(
                f"the kernel backend only implements method='aggregate', "
                f"got {method!r}")
        from .batched import batch_log_normalizing_constants  # no cycle

        p = params.p
        rows = p.reshape(-1, p.shape[-1])
        out = batch_log_normalizing_constants(params, rows, m_max,
                                              backend="kernel")
        return out.reshape(p.shape[:-1] + (m_max + 1,))
    if backend not in _BACKENDS:
        raise ValueError(f"unknown buzen backend: {backend!r}")

    log_rho = params.log_rho
    if method == "aggregate":
        logZ = aggregate_log_Z(log_rho, params.log_gamma_total, m_max)
    elif method == "literal":
        # station by station in the order of Prop. 15: n computation
        # queues, then n downlink IS stations, then n uplink IS stations
        logZ = torch.full((m_max + 1,), NEG_INF, dtype=log_rho.dtype,
                          device=params.device)
        logZ[0] = 0.0  # Z_{.,0} = 1 only
        logZ = logZ.expand(log_rho.shape[:-1] + (m_max + 1,))
        for i in range(params.n):
            logZ = _log_conv(logZ, _geometric_series(log_rho[..., i], m_max))
        for i in range(params.n):
            logZ = _log_conv(logZ, _poisson_series(
                torch.log(params.p[..., i] / params.mu_d[i]), m_max))
        for i in range(params.n):
            logZ = _log_conv(logZ, _poisson_series(
                torch.log(params.p[..., i] / params.mu_u[i]), m_max))
    else:
        raise ValueError(f"unknown method: {method}")

    if params.mu_cs is not None:
        # the multinomial class structure of Eq. (20) sums out to one
        # geometric factor of load sum_j p_j / mu_cs
        log_load_cs = torch.log(seqsum(params.p)) - torch.log(params.mu_cs)
        logZ = _log_conv(logZ, _geometric_series(log_load_cs, m_max))
    return logZ


def class_log_normalizing_constants(classes: ClassParams, m_max: int, *,
                                    backend: Optional[str] = None
                                    ) -> torch.Tensor:
    """Class-space ``log Z_{n, 0..m_max}`` in O(C m^2) instead of O(n m^2).

    The IS stations enter through the aggregate Poisson factor and each
    class's computation stations as one negative-binomial fold; the CS
    station, when set, is one geometric fold of load ``sum(mass) / mu_cs``.
    Agrees with :func:`log_normalizing_constants` on ``classes.expand()``
    to float64 roundoff and is bitwise invariant to :func:`pad_classes`.
    ``backend="kernel"`` runs the CUDA class Buzen kernel (float32
    forward, float64 backward) with the CS station as a count-1 column.
    ``classes.p`` may carry leading batch axes (``count`` stays ``[C]``),
    or every leaf one lane axis (lane-stacked class sets, ``p [L, C]``).
    """
    backend = _backend if backend is None else backend
    if backend == "kernel":
        from .batched import batch_class_log_normalizing_constants

        p = classes.p
        rows = p.reshape(-1, p.shape[-1])
        out = batch_class_log_normalizing_constants(classes, rows, m_max,
                                                    backend="kernel")
        return out.reshape(p.shape[:-1] + (m_max + 1,))
    if backend not in _BACKENDS:
        raise ValueError(f"unknown buzen backend: {backend!r}")
    logZ = aggregate_class_log_Z(classes.log_rho,
                                 classes.count.expand(classes.p.shape),
                                 classes.log_gamma_total, m_max)
    if classes.mu_cs is not None:
        # the per-client DP's geometric CS factor, with the class-mass
        # sequential sum standing in for sum_j p_j
        log_load_cs = (torch.log(seqsum(classes.mass))
                       - torch.log(classes.mu_cs))
        logZ = _log_conv(logZ, _geometric_series(log_load_cs, m_max))
    return logZ


def log_Z_ratio(logZ: torch.Tensor, num: int, den: int) -> torch.Tensor:
    """``Z[num] / Z[den]`` in linear space, with ``Z[k<0] = 0``."""
    if num < 0:
        return torch.zeros((), dtype=logZ.dtype, device=logZ.device)
    return torch.exp(logZ[..., num] - logZ[..., den])


def brute_force_log_Z(params: NetworkParams, m: int) -> float:
    """Exact ``log Z_{n,m}`` by state enumeration — test oracle, tiny
    systems only (host numpy)."""
    p = params.p.detach().cpu().numpy()
    mu_c = params.mu_c.detach().cpu().numpy()
    mu_d = params.mu_d.detach().cpu().numpy()
    mu_u = params.mu_u.detach().cpu().numpy()
    n = len(p)
    stations = ([(p[i] / mu_c[i], False) for i in range(n)]
                + [(p[i] / mu_d[i], True) for i in range(n)]
                + [(p[i] / mu_u[i], True) for i in range(n)])
    if params.mu_cs is not None:
        # math.fsum rounds once: appended zeros cannot change it
        stations.append((math.fsum(p) / float(params.mu_cs), False))
    S = len(stations)
    total = 0.0
    # compositions of m into S parts
    for comp in itertools.combinations(range(m + S - 1), S - 1):
        prev = -1
        xs = []
        for c in comp:
            xs.append(c - prev - 1)
            prev = c
        xs.append(m + S - 2 - prev)
        term = 1.0
        for (load, is_is), x in zip(stations, xs):
            term *= load ** x
            if is_is:
                term /= math.factorial(x)
        total += term
    return math.log(total)
