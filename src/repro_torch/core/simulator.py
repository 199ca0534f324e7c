"""Host discrete-event simulator of the Generalized AsyncSGD network (port of
``repro.core.simulator``: :class:`AsyncNetworkSim`, the exact
per-task-identity reference, and :func:`jump_chain_throughput`, a thin
entry point to the device event engine).

A heap-based host simulation in numpy, with per-task identity, every
registered timing law (through the laws' ``host_sample``), the optional
CS-side FIFO buffer (Section 7) and phase-dependent energy accounting
(Eq. 14); it measures the relative delay exactly as Section 2.4 defines
it.  The device engine :mod:`repro_torch.core.events` is held against it
distributionally (throughput, delays, occupancy), since the two consume
randomness differently.  Network parameters may be given as tensors on any
device; they are copied to the host once.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterator, Optional

import numpy as np

from ..scenario.laws import get_law
from .buzen import NetworkParams


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


# event kinds
_DOWN, _COMP, _UP, _CS = 0, 1, 2, 3


def make_sampler(kind: str, rng: np.random.Generator) -> Callable[[float], float]:
    """Host sampler for service times with mean ``1/mu``.

    ``kind`` names a law in the timing-law registry
    (:mod:`repro_torch.scenario.laws`); unknown names raise eagerly with
    the registered options.  The
    returned sampler raises ``ValueError`` on a non-positive rate instead
    of silently emitting ``inf``/NaN service times (a zero rate would
    otherwise stall the event heap with infinite clocks).
    """
    law = get_law(kind)
    return lambda mu: law.host_sample(mu, rng)


@dataclasses.dataclass
class UpdateEvent:
    """One model-parameter update at the CS (end of a round)."""

    round: int           # round index k (0-based): this is update number k
    client: int          # C_k — client whose gradient is applied
    dispatch_round: int  # round counter value when the task was dispatched
    time: float          # wall-clock time of the update
    task_id: int = -1    # identity of the completed task (payload key)

    @property
    def relative_delay(self) -> int:
        return self.round - self.dispatch_round


@dataclasses.dataclass
class SimStats:
    updates: int
    time: float
    throughput: float
    # [n] unscaled per-client conditional mean delay E0[R_i], 0 where no
    # samples; E0[D_i] of Theorem 2 is p_i * mean_delay[i]
    mean_delay: np.ndarray
    delay_counts: np.ndarray        # [n] number of updates per client
    energy: float
    mean_queue_counts: np.ndarray   # [3n(+1)] time-averaged station occupancy


class AsyncNetworkSim:
    """Discrete-event simulation of the closed network of Fig. 1 / Fig. 6."""

    def __init__(
        self,
        params: NetworkParams,
        m: int,
        *,
        distribution: str = "exponential",
        seed: int = 0,
        power: Optional[object] = None,  # energy.PowerProfile or None
    ):
        self.p = _host(params.p)
        self.p = self.p / self.p.sum()
        self.mu_c = _host(params.mu_c)
        self.mu_d = _host(params.mu_d)
        self.mu_u = _host(params.mu_u)
        self.mu_cs = None if params.mu_cs is None else float(params.mu_cs)
        self.n = len(self.p)
        self.m = m
        self.rng = np.random.default_rng(seed)
        self.sample = make_sampler(distribution, self.rng)
        self.power = power

        self.t = 0.0
        self.round = 0
        self.heap: list = []  # (time, seq, kind, client, task_id)
        self._seq = 0
        self.comp_queue: list[list[int]] = [[] for _ in range(self.n)]  # FIFO of task ids
        self.comp_busy = np.zeros(self.n, dtype=bool)
        self.cs_queue: list[tuple[int, int]] = []  # (task_id, client)
        self.cs_busy = False
        self.task_dispatch_round: dict[int, int] = {}
        self._next_task = 0

        # statistics
        self.delay_sum = np.zeros(self.n)
        self.delay_cnt = np.zeros(self.n, dtype=np.int64)
        self.energy = 0.0
        self.n_down = np.zeros(self.n, dtype=np.int64)
        self.n_up = np.zeros(self.n, dtype=np.int64)
        self._occ_int = np.zeros(3 * self.n + 1)
        self._last_t = 0.0

        # initial out-of-equilibrium dispatch: m tasks uniformly at random
        # into the downlink servers (Section 5.3.3)
        self.initial_tasks: list[tuple[int, int]] = []  # (client, task_id)
        for _ in range(m):
            client = int(self.rng.integers(self.n))
            tid = self._dispatch(client)
            self.initial_tasks.append((client, tid))

    # -- internals ----------------------------------------------------------

    def _push(self, dt: float, kind: int, client: int, task_id: int):
        self._seq += 1
        heapq.heappush(self.heap, (self.t + dt, self._seq, kind, client, task_id))

    def _dispatch(self, client: int) -> int:
        task_id = self._next_task
        self._next_task += 1
        self.task_dispatch_round[task_id] = self.round
        self.n_down[client] += 1
        self._push(self.sample(self.mu_d[client]), _DOWN, client, task_id)
        return task_id

    def _start_compute(self, client: int):
        if not self.comp_busy[client] and self.comp_queue[client]:
            task_id = self.comp_queue[client].pop(0)
            self.comp_busy[client] = True
            self._push(self.sample(self.mu_c[client]), _COMP, client, task_id)

    def _start_cs(self):
        if not self.cs_busy and self.cs_queue:
            task_id, client = self.cs_queue.pop(0)
            self.cs_busy = True
            self._push(self.sample(self.mu_cs), _CS, client, task_id)

    def _instantaneous_power(self) -> float:
        if self.power is None:
            return 0.0
        P_c = _host(self.power.P_c)
        P_u = _host(self.power.P_u)
        P_d = _host(self.power.P_d)
        val = float(np.sum(P_c * self.comp_busy) + np.sum(P_u * self.n_up)
                    + np.sum(P_d * self.n_down))
        if self.power.P_cs is not None and self.cs_busy:
            val += float(self.power.P_cs)
        return val

    def _advance_time(self, new_t: float):
        dt = new_t - self._last_t
        if dt > 0:
            self.energy += dt * self._instantaneous_power()
            occ = np.concatenate([
                self.n_down.astype(float),
                np.array([len(q) for q in self.comp_queue], dtype=float)
                + self.comp_busy.astype(float),
                self.n_up.astype(float),
                np.array([len(self.cs_queue) + float(self.cs_busy)]),
            ])
            self._occ_int += dt * occ
            self._last_t = new_t
        self.t = new_t

    # -- public -------------------------------------------------------------

    def next_update(self) -> UpdateEvent:
        """Advance until the next model-parameter update and return it.

        The caller is responsible for calling :meth:`dispatch_next` (routing
        a fresh task) after consuming the event — the FL trainer does this so
        it can record which parameter version travels with the task.  For
        plain statistics collection use :meth:`run`.
        """
        while True:
            time, _, kind, client, task_id = heapq.heappop(self.heap)
            self._advance_time(time)
            if kind == _DOWN:
                self.n_down[client] -= 1
                self.comp_queue[client].append(task_id)
                self._start_compute(client)
            elif kind == _COMP:
                self.comp_busy[client] = False
                self._start_compute(client)
                self.n_up[client] += 1
                self._push(self.sample(self.mu_u[client]), _UP, client, task_id)
            elif kind == _UP:
                self.n_up[client] -= 1
                if self.mu_cs is None:
                    return self._apply_update(client, task_id)
                self.cs_queue.append((task_id, client))
                self._start_cs()
            elif kind == _CS:
                self.cs_busy = False
                ev = self._apply_update(client, task_id)
                self._start_cs()
                return ev

    def _apply_update(self, client: int, task_id: int) -> UpdateEvent:
        dispatch_round = self.task_dispatch_round.pop(task_id)
        ev = UpdateEvent(round=self.round, client=client,
                         dispatch_round=dispatch_round, time=self.t,
                         task_id=task_id)
        self.round += 1
        self.delay_sum[client] += ev.relative_delay
        self.delay_cnt[client] += 1
        return ev

    def dispatch_next(self) -> tuple[int, int]:
        """Route a fresh task according to ``p`` (Algorithm 1, lines 7–8).

        Returns ``(client, task_id)`` so callers can attach a payload (the
        parameter snapshot travelling with the task)."""
        client = int(self.rng.choice(self.n, p=self.p))
        tid = self._dispatch(client)
        return client, tid

    def run(self, num_updates: int, *, warmup: int = 0) -> SimStats:
        """Collect stationary statistics over ``num_updates`` rounds."""
        for k in range(warmup):
            self.next_update()
            self.dispatch_next()
        # reset statistics after warmup
        self.delay_sum[:] = 0
        self.delay_cnt[:] = 0
        self.energy = 0.0
        self._occ_int[:] = 0
        t0 = self.t
        self._last_t = self.t
        for k in range(num_updates):
            self.next_update()
            self.dispatch_next()
        horizon = self.t - t0
        mean_delay = np.where(self.delay_cnt > 0,
                              self.delay_sum / np.maximum(self.delay_cnt, 1), 0.0)
        return SimStats(
            updates=num_updates,
            time=horizon,
            throughput=num_updates / horizon if horizon > 0 else 0.0,
            mean_delay=mean_delay,
            delay_counts=self.delay_cnt.copy(),
            energy=self.energy,
            mean_queue_counts=self._occ_int / max(horizon, 1e-12),
        )


# ---------------------------------------------------------------------------
# the device event engine's sampler entry point
# ---------------------------------------------------------------------------

def jump_chain_throughput(params: NetworkParams, m: int, steps: int,
                          seed: int = 0, *, backend: Optional[str] = None,
                          chunk: int = 1) -> tuple[float, np.ndarray]:
    """Monte-Carlo estimate of ``lambda`` and the mean station counts on
    the device event engine (:func:`repro_torch.core.events.simulate_stats`
    on ``params``' device, ``backend`` and ``chunk`` as there).

    ``steps`` is an event budget: ``steps // 3`` updates (``// 4`` with a
    CS station), the first third of them warm-up.  The same ``seed`` gives
    the JAX package's run.  Returns ``(lambda, mean_counts)`` with
    ``mean_counts`` of shape ``[3n]`` (downlink / computation / uplink per
    client), summing to ``m`` less the CS station's mean occupancy.
    """
    from .events import simulate_stats

    mult = 4 if params.mu_cs is not None else 3
    total_updates = max(steps // mult, 1)
    warmup = total_updates // 3
    stats = simulate_stats(params, m, total_updates - warmup, warmup=warmup,
                           seed=seed, backend=backend, chunk=chunk)
    return (float(stats.throughput),
            stats.mean_queue_counts[:-1].cpu().numpy())
