"""Service-time (timing) laws — one registry entry drives both engines
(port of ``repro.scenario.laws``: the ``exponential``, ``deterministic``,
``lognormal`` and ``hyperexponential`` laws).

A :class:`TimingLaw` packages:

  * ``host_sample(mu, rng)`` — one draw of mean ``1/mu`` from a
    ``numpy.random.Generator`` (the host simulator
    :class:`repro_torch.core.simulator.AsyncNetworkSim`), the JAX law's
    numpy calls exactly, so bitwise its draws for the same generator;
  * ``device_draw(key, rate, shape=())`` — draws of mean ``1/rate`` from
    keys (:mod:`repro_torch.core.prng`, ``[..., 2]``; a draw of ``shape``
    from each), the JAX law's ``jax.random`` calls on the same keys;
  * ``unit_draw(key, shape=())`` and ``unit_apply(u, rate)`` — the unit
    factorization the event engine's pre-drawn blocks use: the rate-free
    part is drawn up front and the completing client's rate applied in
    the step, with ``device_draw(key, rate, shape) ==
    unit_apply(unit_draw(key, shape), rate)`` bitwise (``device_draw`` is
    that composition);
  * ``paths`` and ``unit_words(words)`` — the same unit part of a scalar
    draw from the hash words of ``paths`` (each a path of counters from
    the law's key, :mod:`repro_torch.kernels.threefry`), which the key
    chain kernel draws for a block of events at once:
    ``unit_words(words of paths from key) == unit_draw(key)``;
  * ``form`` and ``unit_split(u)`` — how the event kernels apply the rate
    (:func:`apply_rate`): ``unit_split`` turns a unit part into the
    per-event scalars the kernels read, ``(x, f)`` with ``f`` ``None``
    unless the form takes a factor, and ``unit_apply(u, rate)`` is
    ``apply_rate(form, *unit_split(u), rate)``.

The three forms, each the JAX law's arithmetic:

  * ``"scale"`` (exponential, deterministic): ``x / rate``, ``x`` the
    variate at unit rate;
  * ``"h2"`` (hyperexponential): ``x / (f * rate)``, ``f`` the branch
    factor ``2 q`` or ``2 (1 - q)`` (``repro/scenario/laws.py``'s
    ``unit_apply``);
  * ``"lognormal"``: ``exp((x - log(rate)) - 0.5)``, ``x`` a standard
    normal.  The JAX package gives this law no unit factorization: XLA may
    contract the normal's ``sqrt2 * erfinv(u)`` with the ``- log(rate)``
    into one fused multiply-add when the draw and the rate meet in one
    fusion, so it stores raw subkeys and draws in the step.  The port
    factors it: separate PyTorch operations never contract, and the lane
    kernel builds with ``-fmad=false``, so the stored ``x`` and the same
    three operations give the same bits on every route.  Against the JAX
    package the law is therefore held within ``rtol 1e-12`` on its float
    leaves (exact on its discrete ones), not bitwise.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .registry import TIMING_LAWS, timing_law

FORMS = ("scale", "h2", "lognormal")


class TimingLaw(NamedTuple):
    """Host and device implementations of one service-time distribution."""

    host_sample: Callable  # (mu: float, rng: np.random.Generator) -> float
    device_draw: Callable  # (key, rate: Tensor, shape=()) -> Tensor
    unit_draw: Callable    # (key, shape=()) -> unit part
    unit_apply: Callable   # (u, rate) -> sample
    unit_split: Callable   # u -> (x, f or None), the kernels' scalars
    paths: tuple           # hash paths of one scalar draw from its key
    unit_words: Callable   # words [..., len(paths), 2] -> unit part
    form: str = "scale"    # how the rate is applied (see apply_rate)


def apply_rate(form: str, x: torch.Tensor, f, rate: torch.Tensor):
    """The rate application of a law's ``form`` to its per-event scalars
    ``x`` (and factor ``f``): what ``unit_apply``, the plain transition and
    the CUDA lane kernel compute.  A rate of 0 gives ``inf`` in every
    form."""
    if form == "scale":
        return x / rate
    if form == "h2":
        return x / (f * rate)
    if form == "lognormal":
        return torch.exp((x - torch.log(rate)) - 0.5)
    raise ValueError(f"unknown rate form {form!r}; forms: {list(FORMS)}")


def law_form(law: str) -> str:
    """The rate form of a form name or of a registered law's name."""
    return law if law in FORMS else get_law(law).form


def form_width(form: str) -> int:
    """Scalars an event of a rate form carries to the event kernels:
    ``[x_up, x_comp, svc_down, svc_cs]``, then for ``"h2"`` the branch
    factors ``[f_up, f_comp]``."""
    return 6 if form == "h2" else 4


def _check(mu: float) -> float:
    """Host-side guard: a zero/negative rate would stall the event heap."""
    if not mu > 0:
        raise ValueError(f"service rate must be positive, got mu={mu}")
    return mu


_cache: dict[str, TimingLaw] = {}


def get_law(name: str) -> TimingLaw:
    """Resolve a registered law; unknown names raise listing the options."""
    hit = _cache.get(name)
    if hit is None:
        hit = _cache[name] = TIMING_LAWS.get(name)()
    return hit


def law_names() -> tuple[str, ...]:
    return TIMING_LAWS.names()


def _prng():
    """:mod:`repro_torch.core.prng`, imported when a law is first built:
    ``repro_torch.core`` imports this module."""
    from ..core import prng
    return prng


def _law(form: str, host_sample, unit_draw, unit_split, paths,
         unit_words) -> TimingLaw:
    """A law whose ``device_draw`` is its unit draw with the rate applied
    (so the factorization holds bitwise by construction)."""
    def unit_apply(u, rate):
        x, f = unit_split(u)
        return apply_rate(form, x, f, rate)

    def device_draw(key, rate, shape=()):
        return unit_apply(unit_draw(key, shape), rate)

    return TimingLaw(host_sample=host_sample, device_draw=device_draw,
                     unit_draw=unit_draw, unit_apply=unit_apply,
                     unit_split=unit_split, paths=tuple(paths),
                     unit_words=unit_words, form=form)


@timing_law("exponential")
def _exponential() -> TimingLaw:
    prng = _prng()
    return _law("scale",
                lambda mu, rng: rng.exponential(1.0 / _check(mu)),
                prng.exponential, lambda u: (u, None), [(0,)],
                lambda w: prng.exponential_words(w[..., 0, :]))


@timing_law("deterministic")
def _deterministic() -> TimingLaw:
    prng = _prng()
    # key-free: the unit part only carries the shape, and every service at
    # unit rate is 1
    return _law("scale",
                lambda mu, rng: 1.0 / _check(mu),
                lambda key, shape=(): torch.zeros(
                    key.shape[:-1] + prng._shape(shape), dtype=torch.float64,
                    device=key.device),
                lambda u: (torch.ones_like(u), None), [],
                lambda w: torch.zeros(w.shape[:-2], dtype=torch.float64,
                                      device=w.device))


@timing_law("lognormal")
def _lognormal() -> TimingLaw:
    prng = _prng()
    # underlying normal variance 1, mean of the law 1/mu:
    # exp(mu_N + 1/2) = 1/mu  ->  mu_N = -log(mu) - 1/2
    return _law("lognormal",
                lambda mu, rng: rng.lognormal(-math.log(_check(mu)) - 0.5,
                                              1.0),
                prng.normal, lambda u: (u, None), [(0,)],
                lambda w: prng.normal_words(w[..., 0, :]))


# H2 balanced-means parameters for SCV = 4: q (1 - q) = 1 / (2 (SCV + 1));
# with probability q a task is a fast exponential of rate 2 q mu, else a
# slow one of rate 2 (1 - q) mu, so the mean is 1/mu for every mu
_H2_SCV = 4.0
_H2_Q = 0.5 * (1.0 + math.sqrt((_H2_SCV - 1.0) / (_H2_SCV + 1.0)))
H2_FAST = 2.0 * _H2_Q          # the branch factors, Python floats as the
H2_SLOW = 2.0 * (1.0 - _H2_Q)  # JAX law computes them


@timing_law("hyperexponential")
def _hyperexponential() -> TimingLaw:
    prng = _prng()
    q = _H2_Q

    def host_sample(mu, rng):
        rate = (2.0 * q if rng.random() < q else 2.0 * (1.0 - q)) * _check(mu)
        return rng.exponential(1.0 / rate)

    def unit_draw(key, shape=()):
        """``[..., 2]``: the branch uniform from the first key of a 2-way
        split, the unit exponential from the second."""
        k = prng.split(key)
        return torch.stack([prng.uniform(k[..., 0, :], shape),
                            prng.exponential(k[..., 1, :], shape)], -1)

    def unit_words(w):
        return torch.stack([prng.uniform_words(w[..., 0, :]),
                            prng.exponential_words(w[..., 1, :])], -1)

    def unit_split(u):
        f = torch.full_like(u[..., 0], H2_SLOW).masked_fill_(u[..., 0] < q,
                                                             H2_FAST)
        return u[..., 1], f

    return _law("h2", host_sample, unit_draw, unit_split, [(0, 0), (1, 0)],
                unit_words)
