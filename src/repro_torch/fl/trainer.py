"""Generalized AsyncSGD as a runnable training system (Algorithms 1 + 2;
port of ``repro.fl.trainer``).

Two interchangeable execution backends behind one API:

  * ``backend="device"`` (default) —
    :class:`repro_torch.fl.engine.DeviceTrainer`: the queueing dynamics,
    the stale gradients against the snapshot ring, the bias-corrected
    ``eta / (n p_C)`` apply, energy accounting and eval-grid logging run
    as one lock-step loop over lanes; :meth:`AsyncFLTrainer.run_seeds`
    runs several seeds as lanes.

  * ``backend="host"`` — the event-at-a-time loop driven by the exact
    per-task-identity host simulator
    (:class:`repro_torch.core.simulator.AsyncNetworkSim`).  It is the
    semantic reference the device engine is held against; the two consume
    randomness differently, so same-seed trajectories differ while all
    statistics agree in distribution.

In both backends each dispatched task carries a snapshot of the global
parameters; when its uplink (or CS-buffer service) completes, the gradient —
computed at the stale snapshot on the owning client's local data — is
applied with the bias-corrected step ``eta / (n p_C)`` (Algorithm 1,
line 6).  :meth:`AsyncFLTrainer.from_scenario` builds a trainer from a
declarative ``repro_torch.scenario.Scenario``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.buzen import NetworkParams
from ..core.simulator import AsyncNetworkSim
from ..scenario.laws import get_law
from .models import accuracy, cross_entropy_loss


@dataclasses.dataclass
class AsyncFLConfig:
    eta: float = 0.05                 # base learning rate
    batch_size: int = 128
    distribution: str = "exponential"  # registered timing law (Section 5.3.3)
    seed: int = 0
    eval_every_time: float = 10.0     # evaluate on a wall-clock grid
    eval_batch: int = 512
    grad_clip: Optional[float] = None  # constrains G (Section 2.5)
    backend: str = "device"           # "device" (lane loop) | "host" (ref)

    def __post_init__(self):
        # eager timing-law validation: an unknown law fails at construction,
        # with the registered laws in the message
        get_law(self.distribution)
        if self.backend not in ("device", "host"):
            raise ValueError(f"unknown backend: {self.backend!r}; "
                             "expected 'device' or 'host'")


@dataclasses.dataclass
class TrainLog:
    times: list          # wall-clock (virtual) eval times
    accuracies: list
    losses: list
    updates: list        # cumulative update count at eval points
    # [n] unscaled per-client conditional mean delay E0[R_i] (same estimator
    # as SimStats.mean_delay); E0[D_i] of Thm 2 is p_i * mean_delay[i]
    mean_delay: np.ndarray | None = None
    throughput: float = 0.0
    energy: float = 0.0

    def time_to_accuracy(self, target: float) -> float:
        """First virtual time at which test accuracy reaches ``target``.

        Robust to empty logs and to NaN accuracy readings (e.g. a diverged
        model): non-finite entries are skipped, no-hit returns ``inf``.
        """
        for t, a in zip(self.times, self.accuracies):
            if np.isfinite(a) and a >= target:
                return t
        return float("inf")


class AsyncFLTrainer:
    """Train ``model`` with Generalized AsyncSGD under routing ``p`` and
    concurrency ``m`` on a heterogeneous client population."""

    def __init__(
        self,
        model: torch.nn.Module,
        client_data: list,  # [(x_i, y_i)] per client
        net: NetworkParams,
        m: int,
        config: AsyncFLConfig = AsyncFLConfig(),
        test_data=None,
        power=None,
        loss_fn: Callable = cross_entropy_loss,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.clients = client_data
        self.net = net
        self.m = m
        self.cfg = config
        self.test = test_data
        self.power = power
        self.loss_fn = loss_fn
        self.n = net.n
        self.p = np.asarray(net.p.detach().cpu(), dtype=np.float64)
        self.p = self.p / self.p.sum()
        self.rng = np.random.default_rng(config.seed + 1)
        self._device = None  # the lane engine, built on first use

    @classmethod
    def from_scenario(cls, scenario, model: torch.nn.Module, client_data:
                      list, *, test_data=None,
                      loss_fn: Callable = cross_entropy_loss, device="cuda",
                      **config_overrides) -> "AsyncFLTrainer":
        """A trainer for a declarative ``repro_torch.scenario.Scenario``:
        the strategy registry resolves ``(p, m)`` on ``device``, the
        network spec gives the rates and law, the learning spec eta and
        clipping; ``config_overrides`` feed ``AsyncFLConfig`` (e.g.
        ``batch_size=32, backend="host"``)."""
        from ..scenario.suite import resolve_strategy

        p, m = resolve_strategy(scenario, device=device)
        return cls(model, client_data, scenario.params(p, device=device), m,
                   config=scenario.fl_config(**config_overrides),
                   test_data=test_data, power=scenario.power(device=device),
                   loss_fn=loss_fn, device=device)

    # -- device backend -----------------------------------------------------

    def _device_trainer(self):
        if self._device is None:
            from .engine import DeviceTrainer  # lazy: keeps import cheap

            self._device = DeviceTrainer(
                self.model, self.clients, self.net, self.cfg,
                test_data=self.test, power=self.power, loss_fn=self.loss_fn,
                device=self.device)
        return self._device

    def run_seeds(self, horizon_time: float, seeds,
                  max_updates: Optional[int] = None) -> list[TrainLog]:
        """Every seed's run as one lane of one lock-step loop (device
        backend regardless of ``cfg.backend``)."""
        dev = self._device_trainer()
        seeds = list(seeds)
        L = len(seeds)
        logs, _ = dev.run_lanes([self.p] * L, [self.m] * L,
                                [self.cfg.eta] * L, seeds,
                                horizon_time, max_updates=max_updates)
        return logs

    def _run_device(self, horizon_time: float, max_updates: Optional[int],
                    init_params=None) -> TrainLog:
        dev = self._device_trainer()
        init = None if init_params is None else init_params[None]
        logs, final = dev.run_lanes(
            [self.p], [self.m], [self.cfg.eta], [self.cfg.seed],
            horizon_time, max_updates=max_updates, init_params=init)
        self.final_params = final[0]
        return logs[0]

    # -- public -------------------------------------------------------------

    def run(self, horizon_time: float, max_updates: int = 10**9,
            init_params: Optional[torch.Tensor] = None) -> TrainLog:
        """Train until ``horizon_time`` (or ``max_updates`` updates).

        ``init_params`` (flat ``[N]``, the model's ``named_parameters``
        order) overrides the initial parameters, which are otherwise drawn
        from ``PRNGKey(cfg.seed)``, as the JAX trainer draws them;
        :attr:`final_params` holds the flat parameters at the end.
        """
        if self.cfg.backend == "device":
            cap = None if max_updates >= 10**9 else max_updates
            return self._run_device(horizon_time, cap, init_params)
        return self._run_host(horizon_time, max_updates, init_params)

    # -- host reference loop (exact per-task-identity semantics) ------------

    def _batch(self, client: int):
        x, y = self.clients[client]
        idx = self.rng.integers(0, len(y),
                                size=min(self.cfg.batch_size, len(y)))
        return (torch.as_tensor(np.asarray(x)[idx], dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(np.asarray(y)[idx], dtype=torch.int64,
                                device=self.device))

    def _run_host(self, horizon_time: float, max_updates: int = 10**9,
                  init_params=None) -> TrainLog:
        eng = self._device_trainer()  # the parameter layout and gradients
        params = (eng.init_params([self.cfg.seed])[0] if init_params is None
                  else init_params.to(self.device, eng.layout.dtype))
        sim = AsyncNetworkSim(self.net, self.m,
                              distribution=self.cfg.distribution,
                              seed=self.cfg.seed, power=self.power)
        payloads = {tid: params for _, tid in sim.initial_tasks}

        log = TrainLog(times=[], accuracies=[], losses=[], updates=[])
        next_eval = 0.0
        k = 0
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            while True:
                ev = sim.next_update()
                if ev.time > horizon_time or k >= max_updates:
                    break
                # grid points strictly before the update event see the
                # pre-update snapshot (the update lands exactly at ev.time)
                while next_eval < ev.time:
                    self._log_eval(log, eng, params, next_eval, k)
                    next_eval += self.cfg.eval_every_time
                stale = payloads.pop(ev.task_id)
                x, y = self._batch(ev.client)
                scale = self.cfg.eta / (self.n * self.p[ev.client])
                params = params - scale * eng._grad(stale, x, y)
                k += 1
                # Algorithm 1 lines 7-8: route a fresh task carrying w_{k+1}
                _, tid = sim.dispatch_next()
                payloads[tid] = params
                # a grid point landing exactly on the update instant sees
                # the post-update params (exact hits are real under
                # deterministic service laws)
                while ev.time >= next_eval:
                    self._log_eval(log, eng, params, next_eval, k)
                    next_eval += self.cfg.eval_every_time
            # fill grid points between the last update and the horizon,
            # then a final eval at the horizon itself
            t_end = min(sim.t, horizon_time)
            while next_eval < t_end:
                self._log_eval(log, eng, params, next_eval, k)
                next_eval += self.cfg.eval_every_time
            self._log_eval(log, eng, params, t_end, k)
        # E0[D_i] of Theorem 2 is the *unscaled* per-client conditional
        # mean, exactly what AsyncNetworkSim.run reports
        log.mean_delay = np.where(
            sim.delay_cnt > 0,
            sim.delay_sum / np.maximum(sim.delay_cnt, 1), 0.0)
        log.throughput = k / max(sim.t, 1e-9)
        log.energy = sim.energy
        self.final_params = params
        return log

    @torch.no_grad()
    def _log_eval(self, log: TrainLog, eng, params, t: float, k: int):
        if self.test is None:
            return
        x, y = self.test
        idx = self.rng.integers(0, len(y),
                                size=min(self.cfg.eval_batch, len(y)))
        logits = torch.func.functional_call(
            self.model, eng.layout.views(params),
            (torch.as_tensor(np.asarray(x)[idx], dtype=torch.float32,
                             device=self.device),))
        yt = torch.as_tensor(np.asarray(y)[idx], dtype=torch.int64,
                             device=self.device)
        log.times.append(float(t))
        log.losses.append(float(self.loss_fn(logits, yt)))
        log.accuracies.append(float(accuracy(logits, yt)))
        log.updates.append(k)
