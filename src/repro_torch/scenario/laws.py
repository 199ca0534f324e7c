"""Service-time (timing) laws — one registry entry drives both engines
(port of ``repro.scenario.laws``: the ``exponential`` and ``deterministic``
laws; ``lognormal`` and ``hyperexponential`` are not ported yet).

A :class:`TimingLaw` packages:

  * ``host_sample(mu, rng)`` — one draw of mean ``1/mu`` from a
    ``numpy.random.Generator`` (the host simulator
    :class:`repro_torch.core.simulator.AsyncNetworkSim`);
  * ``device_draw(generator, rate)`` — draws of mean ``1/rate`` on
    ``rate``'s device and shape from a ``torch.Generator``;
  * ``unit_draw(generator, shape, dtype, device)`` and
    ``unit_apply(u, rate)`` — the unit factorization the event engine's
    pre-drawn blocks use: the rate-free part is drawn up front and the
    completing client's rate applied in the step, with
    ``unit_apply(u, rate)`` the same arithmetic as the JAX law's (so blocks
    drawn by the JAX package replay bitwise).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .registry import TIMING_LAWS, timing_law


class TimingLaw(NamedTuple):
    """Host and device implementations of one service-time distribution."""

    host_sample: Callable  # (mu: float, rng: np.random.Generator) -> float
    device_draw: Callable  # (generator, rate: Tensor) -> Tensor
    unit_draw: Callable    # (generator, shape, dtype, device) -> unit part
    unit_apply: Callable   # (u, rate) -> sample


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


def _exp_unit(generator, shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        generator=generator)


@timing_law("exponential")
def _exponential() -> TimingLaw:
    return TimingLaw(
        host_sample=lambda mu, rng: rng.exponential(1.0 / _check(mu)),
        device_draw=lambda g, rate:
            _exp_unit(g, rate.shape, rate.dtype, rate.device) / rate,
        unit_draw=_exp_unit,
        unit_apply=lambda u, rate: u / rate)


@timing_law("deterministic")
def _deterministic() -> TimingLaw:
    return TimingLaw(
        host_sample=lambda mu, rng: 1.0 / _check(mu),
        device_draw=lambda g, rate: 1.0 / rate,
        # generator-free: the unit part only carries the shape
        unit_draw=lambda g, shape, dtype, device:
            torch.zeros(shape, dtype=dtype, device=device),
        unit_apply=lambda u, rate: torch.broadcast_to(1.0 / rate, u.shape))
