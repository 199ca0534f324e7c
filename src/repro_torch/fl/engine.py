"""Device-resident Generalized AsyncSGD training (Algorithms 1 + 2; port of
``repro.fl.engine``).

A training run is a loop over update rounds in which every lane moves in
lock-step: the queueing dynamics (:func:`repro_torch.core.events.next_update`
over the lanes' ``EventState``), the stale gradient at the snapshot the
completing task was dispatched with, the bias-corrected ``eta / (n p_C)``
apply (through the CUDA kernel of
:mod:`repro_torch.kernels.fused_update`), energy accounting and eval-grid
logging.  Lanes are strategies x seeds: routing ``p``, concurrency ``m``,
step size ``eta`` and seed vary per lane; in the mixed-``n`` lane mode the
network, client table and power profile do too.

Layout.  Each lane's parameters live in one flat buffer: lanes stack into
``params [L, N]`` (``N`` parameters in the model's ``named_parameters``
order, :class:`ParamLayout`) and ``torch.func.functional_call`` reads
per-leaf views of a row.  The snapshot ring is ``[L, m_max, N]``: because
the event engine re-dispatches into the freed task-table slot, the slot
index doubles as the ring index — an update reads its stale snapshot at
the completed slot and writes the post-update parameters back into the
same slot for the freshly dispatched task (no live mask: time is monotone,
so a write past the horizon is never read by a live update).  The eval
grid keeps ``[L, G, N]`` snapshots: parameters are piecewise constant
between updates, so when an update interval sweeps past grid times the
loop records one *pre-update* snapshot at the first swept grid index;
after the loop those ``G`` snapshots are evaluated on a fixed held-out
batch and a ``searchsorted`` gather fills the grid — a grid time ``t``
sees the parameters after exactly ``#{updates with time <= t}`` updates.

Gradients run lane by lane (one ``torch.autograd.grad`` per live lane and
update), so a lane's arithmetic does not depend on which other lanes run
beside it: each lane of :meth:`DeviceTrainer.run_lanes` is bitwise its
single-lane run.  Everything else (the event step, the apply, the masks
and the ring writes) is elementwise over the lane axis.  On a CUDA device
the run pins cuDNN to deterministic full-float32 convolutions (no TF32),
so the same inputs give the same bits on every run.

No counting pre-pass.  The JAX package pre-simulates each lane's update
count (``_count_updates``) and buckets lanes by a quantised scan length,
because ``lax.scan`` needs a static length.  Here the loop runs until
every lane has retired one update beyond the horizon, or until
``max_updates`` rounds: that is the reference's ``K = min(count + 1,
max_updates)``, and the outputs cannot tell the two apart, because the
masked rounds past a lane's first non-live update change nothing (its
energy integral is capped at the horizon).

Randomness.  The keys are the JAX package's (:mod:`repro_torch.core.prng`,
bitwise ``jax.random``): lane seed ``s`` initialises the model from
``PRNGKey(s)``, draws its events through an
:class:`repro_torch.core.events.EventStream` from ``fold_in(PRNGKey(s),
1)`` and its minibatch indices through a :class:`BatchStream` from
``fold_in(PRNGKey(s), 2)``, so the same seeds give the JAX trainer's
events and minibatches.  :meth:`DeviceTrainer.run_streams` takes the
initial state, both streams and the initial parameters as inputs, so a
test can also feed in what the JAX package drew
(``EventStream.from_blocks``, ``BatchStream.from_table``).

Host-reference contract: :class:`repro_torch.fl.trainer.AsyncFLTrainer`
with ``backend="host"`` drives the exact per-task-identity host simulator
(:class:`repro_torch.core.simulator.AsyncNetworkSim`); the engines consume
randomness differently, so trainer-level cross-checks are statistical.
The reference's documented deviations (fixed eval batch, minibatches drawn
with replacement at full ``batch_size``, float32 parameter updates, energy
integrated exactly to the horizon, the throughput denominator when a
``max_updates`` cap binds) hold here too.  :meth:`DeviceTrainer.from_scenario`
builds the trainer from a declarative ``repro_torch.scenario.Scenario``.

Telemetry.  ``trace_updates = R > 0`` keeps an update ring of ``R``
records per lane (:mod:`repro_torch.obs.rings`): each live update's time,
client, staleness, the float64 L2 norm of its gradient (before the clip,
as the JAX package records it) and its snapshot's age (the update time
less the time its slot's snapshot was written, from a ``[L, m_max]``
table of write times).  The appends read the loop's values and never feed
back into it, so training is bitwise that of an untraced run;
:attr:`DeviceTrainer.last_update_rings` holds the rings of the last run.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..core import jackson, prng
from ..core.buzen import NetworkParams
from ..core.events import (EventStream, event_key, init_state, next_update,
                           stack_lanes)
from ..core.numerics import DTYPE, seqsum
from ..kernels.fused_update import fused_async_update_flat
from ..kernels.threefry import chain_words, paths_tensor
from ..obs.rings import lane_rings, update_ring_append, update_ring_init
from ..sim.backend import resolve_backend
from .models import accuracy, cross_entropy_loss

_GRID_CAP = 20_000  # eval-grid safety bound, as the reference's
DRAW_BATCHES = 256  # minibatch draws per block and lane


class PaddedClientData(NamedTuple):
    """Client datasets padded to a common length for device-side sampling."""

    x: torch.Tensor      # [n, S_max, ...] float32
    y: torch.Tensor      # [n, S_max] int64
    sizes: torch.Tensor  # [n] int64


def pad_client_data(clients, n_total: Optional[int] = None,
                    min_samples: Optional[int] = None, *,
                    device="cuda") -> PaddedClientData:
    """Stack per-client ``(x_i, y_i)`` datasets into padded tensors.

    ``n_total`` (the padded-``n`` convention: the network's row count)
    appends empty placeholder rows beyond the real clients — padded
    clients carry zero routing mass, are never dispatched, and so never
    have a minibatch sampled from their (single zero) row.
    ``min_samples`` forces the sample axis to at least that length so
    per-lane tables of different datasets stack into one ``[L, n, S_max]``
    table (minibatch draws are bounded by the *real* ``sizes``, so the
    extra zero rows are never sampled and trajectories are bitwise
    invariant to the sample-axis padding).
    """
    sizes = np.array([len(y) for _, y in clients], dtype=np.int64)
    if (sizes <= 0).any():
        raise ValueError("every client needs at least one sample")
    n_rows = len(clients) if n_total is None else int(n_total)
    if n_rows < len(clients):
        raise ValueError(f"n_total={n_rows} is smaller than the "
                         f"{len(clients)} provided clients")
    s_max = int(sizes.max())
    if min_samples is not None:
        s_max = max(s_max, int(min_samples))
    x0 = np.asarray(clients[0][0])
    xs = np.zeros((n_rows, s_max) + x0.shape[1:], dtype=np.float32)
    ys = np.zeros((n_rows, s_max), dtype=np.int64)
    for i, (x, y) in enumerate(clients):
        xs[i, :len(y)] = x
        ys[i, :len(y)] = y
    sizes = np.concatenate(
        [sizes, np.ones(n_rows - len(clients), dtype=np.int64)])
    return PaddedClientData(x=torch.as_tensor(xs, device=device),
                            y=torch.as_tensor(ys, device=device),
                            sizes=torch.as_tensor(sizes, device=device))


class ParamLayout:
    """Names, shapes and offsets of a module's parameters in one flat
    vector (``named_parameters`` order)."""

    def __init__(self, model: torch.nn.Module):
        self.entries = []  # (name, shape, offset, numel)
        off = 0
        for name, p in model.named_parameters():
            self.entries.append((name, tuple(p.shape), off, p.numel()))
            off += p.numel()
        self.size = off
        self.dtype = next(model.parameters()).dtype

    def views(self, flat: torch.Tensor) -> dict:
        """``{name: view}`` of a flat ``[N]`` buffer."""
        return {name: flat[o:o + k].view(shape)
                for name, shape, o, k in self.entries}

    def flatten(self, params) -> torch.Tensor:
        """A module's parameters (or a ``{name: tensor}`` mapping in the
        module's order) as one flat ``[N]`` tensor."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        return torch.cat([params[name].detach().reshape(-1)
                          for name, _, _, _ in self.entries])


class BatchStream:
    """Per-lane minibatch draws, one per update round and lane.

    :meth:`take` returns each lane's *within-client* sample indices for the
    round's completing client ``c``: JAX's per-round ``dkey, kb =
    split(dkey)`` then ``randint(kb, (batch,), 0, sizes[c])``, drawn with
    replacement, from each lane's data key (``keys [L, 2]``).  The key
    chain and the words of ``DRAW_BATCHES`` rounds come from one launch of
    the key-chain kernel for every lane; the indices are resolved from them
    once ``c`` is known.  :meth:`from_table` replays a table ``[L, rounds,
    n, batch]`` of within-client indices drawn elsewhere (e.g. by the JAX
    package for every client of every round) instead.
    """

    def __init__(self, keys, batch: int):
        self._keys = keys
        self._batch = int(batch)
        self._words = None
        self._table = None
        self._pos = 0
        self._paths = None if keys is None else paths_tensor(
            [(1, 0, j) for j in range(self._batch)]
            + [(1, 1, j) for j in range(self._batch)], keys.device)

    @classmethod
    def from_table(cls, table: torch.Tensor) -> "BatchStream":
        self = cls(None, table.shape[-1])
        self._table = table.long()
        return self

    def take(self, c: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        """``[L, batch]`` within-client indices of client ``c [L]`` of each
        lane (``sizes [L, n]`` the real sample counts)."""
        lanes = torch.arange(c.shape[0], device=c.device)
        if self._table is not None:
            if self._pos >= self._table.shape[1]:
                raise RuntimeError("the minibatch table ran out")
            out = self._table[lanes, self._pos, c]
        else:
            if self._words is None or self._pos == DRAW_BATCHES:
                chain, self._words = chain_words(self._keys, DRAW_BATCHES,
                                                 self._paths)
                self._keys = chain[:, -1]
                self._pos = 0
            w = self._words[:, self._pos]
            b = self._batch
            out = prng.randint_words(w[:, :b], w[:, b:], 0,
                                     sizes[lanes, c][:, None])
        self._pos += 1
        return out


class DeviceTrainLog(NamedTuple):
    """Per-lane tensors of one run (leading lane axis ``[L]``); converted
    to ``TrainLog`` by :meth:`DeviceTrainer.train_logs`."""

    grid_times: torch.Tensor    # [L, G]
    grid_losses: torch.Tensor   # [L, G]
    grid_accs: torch.Tensor     # [L, G]
    grid_updates: torch.Tensor  # [L, G]
    grid_valid: torch.Tensor    # [L, G] bool
    t_end: torch.Tensor
    final_loss: torch.Tensor
    final_acc: torch.Tensor
    updates: torch.Tensor       # k_h — updates applied within the horizon
    mean_delay: torch.Tensor    # [L, n] unscaled E0[R_i] estimator
    delay_counts: torch.Tensor  # [L, n]
    throughput: torch.Tensor
    energy: torch.Tensor


def max_throughput_bound(net: NetworkParams, m) -> float:
    """Distribution-free upper bound on the update rate ``lambda``:
    ``min(single-server capacity, m / E[pure service per cycle])``."""
    def host(x):
        return np.asarray(torch.as_tensor(x).detach().cpu(), dtype=np.float64)

    p = host(net.p)
    # contract: allow(raw-reduction): host-side numpy planning bound over the trainer's own unpadded network, reported only as updates_per_lane — the round loop stops on the lanes' own counts, so no run reads it
    p = p / p.sum()
    station = float(np.min(host(net.mu_c) / np.maximum(p, 1e-12)))
    if net.mu_cs is not None:
        station = min(station, float(net.mu_cs))
    # contract: allow(raw-reduction): host-side numpy planning bound over the trainer's own unpadded network, reported only as updates_per_lane — the round loop stops on the lanes' own counts, so no run reads it
    cycle = float(np.sum(p * (1.0 / host(net.mu_d) + 1.0 / host(net.mu_c)
                              + 1.0 / host(net.mu_u))))
    if net.mu_cs is not None:
        cycle += 1.0 / float(net.mu_cs)
    return min(station, float(m) / cycle)


class DeviceTrainer:
    """The training loop for one FL problem (model, client data, network
    rates); lanes vary ``(p, m, eta, seed)``."""

    def __init__(self, model: torch.nn.Module, clients, net: NetworkParams,
                 config, test_data=None, power=None,
                 loss_fn: Callable = cross_entropy_loss,
                 sim_backend: Optional[str] = None, sim_chunk: int = 1, *,
                 trace_updates: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.layout = ParamLayout(self.model)
        self.net = net
        self.cfg = config
        self.power = power
        self.loss_fn = loss_fn
        # event-engine backend (repro_torch.sim.backend; None defers to the
        # process-wide default) and megastep size: next_update retires up
        # to sim_chunk events per transition call, bitwise the same
        # trajectories for any value
        self.sim_backend = sim_backend
        self.sim_chunk = int(sim_chunk)
        # update-ring capacity per lane (0: tracing off); the last run's
        # per-lane rings, in input lane order (None when tracing is off)
        self.trace_updates = int(trace_updates)
        self.last_update_rings = None
        self.n = net.n              # row count (n_max when padded)
        # real population: the bias correction eta/(n p_C) and the reported
        # per-client statistics use the active count
        self.n_act = int(net.active_count)
        if len(clients) not in (self.n, self.n_act):
            raise ValueError(
                f"{len(clients)} clients for a network with "
                f"{self.n_act} active of {self.n} rows")
        self.data = pad_client_data(clients, n_total=self.n,
                                    device=self.device)
        self.has_test = test_data is not None
        if self.has_test:
            x, y = test_data
            rng = np.random.default_rng(0)
            idx = rng.permutation(len(y))[:min(config.eval_batch, len(y))]
            self.test_x = torch.as_tensor(
                np.asarray(x)[idx], dtype=torch.float32, device=self.device)
            self.test_y = torch.as_tensor(
                np.asarray(y)[idx], dtype=torch.int64, device=self.device)
        else:
            self.test_x = self.test_y = None

    @classmethod
    def from_scenario(cls, scenario, model: torch.nn.Module, clients, *,
                      test_data=None, loss_fn: Callable = cross_entropy_loss,
                      device="cuda", **config_overrides) -> "DeviceTrainer":
        """The trainer for a declarative ``repro_torch.scenario.Scenario``:
        the network's rates and law, the grad clip, eta and power profile
        come from the spec, the event-engine backend and megastep chunk
        from its ``SimSpec``; ``config_overrides`` feed ``AsyncFLConfig``.
        Lane routing and concurrency still vary per :meth:`run_lanes` call
        (resolve them with ``repro_torch.scenario.resolve_strategy``).  The
        update-ring capacity is the spec's ``TraceSpec.updates`` (the
        trainer keeps no event ring, as the JAX package's does not)."""
        sim, trace = scenario.sim, scenario.trace
        return cls(model, clients, scenario.params(device=device),
                   scenario.fl_config(**config_overrides),
                   test_data=test_data, power=scenario.power(device=device),
                   loss_fn=loss_fn,
                   sim_backend=None if sim is None else sim.backend,
                   sim_chunk=1 if sim is None else sim.chunk,
                   trace_updates=0 if trace is None else trace.updates,
                   device=device)

    # -- parameters ---------------------------------------------------------

    def init_params(self, seeds=None, *, keys=None) -> torch.Tensor:
        """``[L, N]`` initial parameters, lane ``l`` drawn by the model's
        ``init_parameters`` from ``keys[l]`` (default ``PRNGKey(seeds[l])``,
        as the JAX trainer's ``model.init``), on a copy: the model's own
        parameters stay as they are."""
        if keys is None:
            keys = prng.seed_keys(seeds, device=self.device)
        scratch = copy.deepcopy(self.model)
        rows = []
        for k in keys:
            scratch.init_parameters(k)
            rows.append(self.layout.flatten(scratch))
        return torch.stack(rows)

    def _raw_grad(self, flat_w, x, y) -> torch.Tensor:
        """The flat gradient of the loss at ``flat_w [N]``."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.layout.views(flat_w).items()}
        with torch.enable_grad():
            loss = self.loss_fn(functional_call(self.model, leaves, (x,)), y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return torch.cat([v.reshape(-1) for v in grads])

    def _grad(self, flat_w, x, y) -> torch.Tensor:
        """:meth:`_raw_grad` clipped to ``grad_clip`` by its norm in the
        parameter type."""
        return self._clip(self._raw_grad(flat_w, x, y))

    def _clip(self, g) -> torch.Tensor:
        """``g`` scaled to at most ``grad_clip`` in norm (no clip: as is)."""
        clip = self.cfg.grad_clip
        if clip is not None:
            # contract: allow(raw-reduction): parameter-axis grad norm — model leaves are never padded along the client axis
            norm = torch.sqrt(torch.sum(g * g))
            factor = torch.clamp_max(torch.full_like(norm, clip)
                                     / (norm + 1e-12), 1.0)
            g = g * factor
        return g

    @torch.no_grad()
    def _evaluate(self, flat_w):
        logits = functional_call(self.model, self.layout.views(flat_w),
                                 (self.test_x,))
        return self.loss_fn(logits, self.test_y), accuracy(logits,
                                                           self.test_y)

    def _apply(self, params, g, scale):
        """``params - scale * g`` over ``[L, N]`` in the parameter type: the
        fused kernel, one launch for every lane (its plain version on CPU
        tensors), bitwise the plain PyTorch update."""
        return fused_async_update_flat(params, g, scale)[0]

    # -- planning (informational) -------------------------------------------

    def _plan_one(self, p, m, horizon: float, net=None) -> int:
        """Upper bound on a lane's rounds within ``horizon``, from the
        closed-form throughput (exponential) tightened / replaced by the
        distribution-free bound otherwise."""
        base = self.net if net is None else net
        lane = base._replace(p=torch.as_tensor(np.asarray(p, np.float64),
                                               dtype=DTYPE,
                                               device=base.device))
        rate = max_throughput_bound(lane, m)
        if self.cfg.distribution == "exponential":
            rate = min(rate, 1.25 * float(jackson.throughput(lane, int(m))))
        return int(horizon * rate * 1.08) + 2 * int(m) + 32

    def plan_updates(self, ps, ms, horizon: float,
                     max_updates: Optional[int] = None) -> int:
        """Upper bound on the rounds covering ``horizon`` for every given
        lane (informational: the loop stops on the lanes' own counts)."""
        k = max(self._plan_one(p, m, horizon) for p, m in zip(ps, ms))
        if max_updates is not None:
            k = min(k, int(max_updates))
        return max(k, 1)

    # -- the run ------------------------------------------------------------

    def run_streams(self, params0: torch.Tensor, state, events: EventStream,
                    batches: BatchStream, lane_nets, etas,
                    horizon_time: float, *, max_updates: Optional[int] = None,
                    lane_clients=None, lane_powers=None):
        """The training loop on prepared inputs: ``params0 [L, N]``, the
        lane-stacked initial ``EventState`` (``t_cap`` at the horizon), the
        event and minibatch streams, the per-lane networks (routing ``p``
        set, padded to this trainer's rows) and step sizes ``etas [L]``.
        ``lane_clients`` and ``lane_powers`` are the lane mode's per-lane
        datasets and power profiles (see :meth:`run_lanes`); without them
        this trainer's data and power profile serve every lane.

        Returns ``(DeviceTrainLog, final params [L, N])``.
        """
        lane_data = lane_power = None
        if lane_clients is not None:
            s_top = max(max(len(y) for _, y in cl) for cl in lane_clients)
            tables = [pad_client_data(cl, n_total=self.n, min_samples=s_top,
                                      device=self.device)
                      for cl in lane_clients]
            lane_data = PaddedClientData(*[torch.stack(x)
                                           for x in zip(*tables)])
        if lane_powers is not None:
            lane_power = stack_lanes(lane_powers)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            return self._run(params0, state, events, batches, lane_nets,
                             etas, float(horizon_time), max_updates,
                             lane_data, lane_power)

    def _run(self, params0, state, events, batches, lane_nets, etas, horizon,
             max_updates, lane_data, lane_power):
        cfg = self.cfg
        dev = self.device
        L = params0.shape[0]
        if max_updates is not None and int(max_updates) < 1:
            raise ValueError(f"max_updates must be >= 1, got {max_updates}")
        G = int(horizon / cfg.eval_every_time) + 1
        if G > _GRID_CAP:
            raise ValueError(
                f"eval grid of {G} points exceeds the cap {_GRID_CAP}; "
                f"coarsen eval_every_time or use the host backend")
        backend = resolve_backend(self.sim_backend)
        n, m_max = self.n, state.finish.shape[1]
        # the engine reads the rates only; n_active rides with each lane's
        # event stream and its n_act below
        nets = stack_lanes([net._replace(n_active=None) for net in lane_nets])
        n_act = torch.as_tensor([float(net.active_count) for net in lane_nets],
                                dtype=DTYPE, device=dev)
        eta = torch.as_tensor(np.asarray(etas, np.float64), dtype=DTYPE,
                              device=dev)
        # sequential sum: bitwise invariant to padded zero-mass clients
        p_norm = nets.p / seqsum(nets.p)[:, None]
        if lane_power is None and self.power is not None:
            lane_power = stack_lanes([self.power] * L)
        data = self.data if lane_data is None else lane_data
        s_max = data.y.shape[-1]
        x_flat = data.x.reshape((-1,) + tuple(self.data.x.shape[2:]))
        y_flat = data.y.reshape(-1)
        sizes = (data.sizes.expand(L, n) if lane_data is None
                 else data.sizes)
        lanes = torch.arange(L, device=dev)
        row0 = (lanes * (n * s_max) if lane_data is not None
                else torch.zeros_like(lanes))

        ring = None
        if self.trace_updates:
            ring = update_ring_init(self.trace_updates, lanes=L, device=dev)
            # when each slot's snapshot was written (snapshot_age)
            snap_t = torch.zeros(L, m_max, dtype=DTYPE, device=dev)
            gnorm = torch.zeros(L, dtype=DTYPE, device=dev)
        params = params0.to(dev, self.layout.dtype).clone()
        snaps = params[:, None].repeat(1, m_max, 1)    # [L, m_max, N]
        grid_snaps = params[:, None].repeat(1, G, 1)   # [L, G, N]
        t_grid = torch.arange(G, dtype=DTYPE, device=dev) * cfg.eval_every_time
        prev_t = torch.zeros(L, dtype=DTYPE, device=dev)
        outs = []
        done = [False] * L  # lane has retired an update beyond the horizon
        k = 0
        while not all(done) and (max_updates is None or k < max_updates):
            state, upd = next_update(nets, state, events, power=lane_power,
                                     backend=backend, chunk=self.sim_chunk)
            live = upd.time <= horizon
            j, c = upd.slot.long(), upd.client.long()
            rows = (row0[:, None] + c[:, None] * s_max
                    + batches.take(c, sizes))
            live_host = live.tolist()
            stale = snaps[lanes, j]
            g = torch.zeros_like(params)
            for i in range(L):
                # a masked round's gradient is discarded: skip it
                if live_host[i]:
                    raw = self._raw_grad(stale[i], x_flat[rows[i]],
                                         y_flat[rows[i]])
                    if ring is not None:
                        # contract: allow(raw-reduction): parameter-axis grad norm — model leaves are never padded along the client axis
                        gnorm[i] = torch.sqrt(torch.sum(torch.square(
                            raw.to(DTYPE))))
                    g[i] = self._clip(raw)
            if ring is not None:
                update_ring_append(ring, time=upd.time, client=c,
                                   staleness=upd.delay, grad_norm=gnorm,
                                   snapshot_age=upd.time - snap_t[lanes, j],
                                   valid=live)
                # no live mask, like the snapshots: time is monotone, so a
                # write past the horizon is only read by masked appends
                snap_t[lanes, j] = upd.time
            # bias correction over the REAL population (Algorithm 2), in
            # float64, then cast to the parameter type
            scale = (eta / (n_act * p_norm[lanes, c])).to(params.dtype)
            new = torch.where(live[:, None], self._apply(params, g, scale),
                              params)
            # first grid point inside [prev_t, t_k), if any
            g0 = torch.searchsorted(t_grid, prev_t, side="left")
            g0c = torch.clamp(g0, 0, G - 1)
            cross = (t_grid[g0c] >= prev_t) & (t_grid[g0c] < upd.time)
            grid_snaps[lanes, g0c] = torch.where(
                cross[:, None], params, grid_snaps[lanes, g0c])
            snaps[lanes, j] = new
            params, prev_t = new, upd.time
            outs.append((upd.time, c, upd.delay, live))
            done = [d or not lv for d, lv in zip(done, live_host)]
            k += 1
        self.last_update_rings = (None if ring is None
                                  else lane_rings(ring))
        times, clients_k, delays, live = (torch.stack(x, dim=1)
                                          for x in zip(*outs))
        K = times.shape[1]

        if self.has_test:
            final = [self._evaluate(params[i]) for i in range(L)]
            final_loss = torch.stack([f[0] for f in final])
            final_acc = torch.stack([f[1] for f in final])
            snap = [[self._evaluate(grid_snaps[i, gi]) for gi in range(G)]
                    for i in range(L)]
            snap_losses = torch.stack([torch.stack([s[0] for s in r])
                                       for r in snap])
            snap_accs = torch.stack([torch.stack([s[1] for s in r])
                                     for r in snap])
        else:
            final_loss = final_acc = torch.zeros(L, device=dev)
            snap_losses = snap_accs = torch.zeros(L, G, device=dev)

        # contract: allow(raw-reduction): boolean count of live updates over the round axis — exact integer arithmetic under any association
        k_h = live.sum(dim=1)
        delay_sum = torch.zeros(L, n, dtype=DTYPE, device=dev).scatter_add_(
            1, clients_k, torch.where(live, delays.to(DTYPE), 0.0))
        delay_cnt = torch.zeros(L, n, dtype=torch.int32,
                                device=dev).scatter_add_(
            1, clients_k, live.to(torch.int32))
        mean_delay = torch.where(delay_cnt > 0,
                                 delay_sum / torch.clamp_min(delay_cnt, 1),
                                 0.0)
        t_last = torch.where(live, times, 0.0).amax(dim=1)
        t_end = torch.where(k_h < K, torch.full_like(t_last, horizon), t_last)
        # the host reference divides by the time of the first update beyond
        # the horizon (the loop's break event) when one exists
        t_break = torch.where(live, torch.inf, times).amin(dim=1)
        denom = torch.where(torch.isfinite(t_break), t_break, t_last)
        thr = torch.where(denom > 0, k_h / torch.clamp_min(denom, 1e-12), 0.0)

        live_times = torch.where(live, times, torch.inf)
        grid = t_grid.expand(L, G).contiguous()
        kg = torch.searchsorted(live_times, grid, side="right")
        # grid points swept by the same update interval share kg; gather
        # each from the representative (first) index of its kg-run
        g_first = torch.searchsorted(kg, kg, side="left")
        swept = kg < k_h[:, None]
        dlog = DeviceTrainLog(
            grid_times=grid,
            grid_losses=torch.where(swept, snap_losses.gather(1, g_first),
                                    final_loss[:, None]),
            grid_accs=torch.where(swept, snap_accs.gather(1, g_first),
                                  final_acc[:, None]),
            grid_updates=kg.to(torch.int32), grid_valid=grid < t_end[:, None],
            t_end=t_end, final_loss=final_loss, final_acc=final_acc,
            updates=k_h, mean_delay=mean_delay, delay_counts=delay_cnt,
            throughput=thr, energy=state.energy)
        return dlog, params

    def train_logs(self, dlog: DeviceTrainLog, n_acts=None) -> list:
        """One ``TrainLog`` per lane: the valid grid points plus the final
        point at ``t_end``; ``mean_delay`` cut to each lane's real
        population (``n_acts``, default this trainer's)."""
        from .trainer import TrainLog  # local: trainer imports this module

        L = dlog.t_end.shape[0]
        n_acts = [self.n_act] * L if n_acts is None else n_acts
        logs = []
        for i in range(L):
            if self.has_test:
                valid = dlog.grid_valid[i]
                times = dlog.grid_times[i][valid].tolist()
                losses = dlog.grid_losses[i][valid].tolist()
                accs = dlog.grid_accs[i][valid].tolist()
                upds = dlog.grid_updates[i][valid].tolist()
                times.append(float(dlog.t_end[i]))
                losses.append(float(dlog.final_loss[i]))
                accs.append(float(dlog.final_acc[i]))
                upds.append(int(dlog.updates[i]))
            else:
                times, losses, accs, upds = [], [], [], []
            logs.append(TrainLog(
                times=times, accuracies=accs, losses=losses, updates=upds,
                mean_delay=dlog.mean_delay[i, :int(n_acts[i])].cpu().numpy(),
                throughput=float(dlog.throughput[i]),
                energy=float(dlog.energy[i])))
        return logs

    def run_lanes(self, ps, ms, etas, seeds, horizon_time: float, *,
                  max_updates: Optional[int] = None,
                  init_params: Optional[torch.Tensor] = None,
                  init_keys=None, nets=None, lane_clients=None,
                  lane_powers=None):
        """Run ``L`` lanes (routing ``ps[L, n]``, concurrency ``ms[L]``,
        step size ``etas[L]``, seed ``seeds[L]``) in lock-step.

        Lane ``l`` draws its events from ``fold_in(PRNGKey(seeds[l]), 1)``
        and its minibatches from ``fold_in(PRNGKey(seeds[l]), 2)``, the JAX
        trainer's keys; ``init_keys [L, 2]`` overrides the model's
        initialisation keys (default ``PRNGKey(seeds[l])``) and
        ``init_params [L, N]`` the initial parameters themselves.
        Returns ``(list[TrainLog], final params [L, N])`` in lane order.

        Mixed-``n`` lanes: ``nets`` gives each lane its own network, padded
        (``pad_network``) to this trainer's row count; it requires
        ``lane_clients`` (per-lane client datasets, padded here into one
        ``[L, n, S_max]`` table) and optionally ``lane_powers`` (per-lane
        power profiles padded to the same rows).  Under the padding
        contract each lane is bitwise a single-lane run of its scenario at
        its own size.
        """
        L = len(ms)
        horizon = float(horizon_time)
        lane_mode = nets is not None
        if lane_mode:
            if len(nets) != L:
                raise ValueError(f"{len(nets)} lane networks for {L} lanes")
            if lane_clients is None or len(lane_clients) != L:
                raise ValueError("per-lane networks require per-lane "
                                 "client datasets (lane_clients)")
            if lane_powers is not None and len(lane_powers) != L:
                raise ValueError(
                    f"{len(lane_powers)} lane powers for {L} lanes")
            for net in nets:
                if net.n != self.n:
                    raise ValueError(
                        f"lane network has {net.n} rows; pad_network it "
                        f"to this trainer's {self.n}")
        elif lane_clients is not None or lane_powers is not None:
            raise ValueError("lane_clients/lane_powers need nets")
        base = list(nets) if lane_mode else [self.net] * L
        lane_nets = [net._replace(p=torch.as_tensor(p, dtype=DTYPE,
                                                    device=net.device))
                     for net, p in zip(base, ps)]
        seeds = [int(s) for s in seeds]
        seed_keys = prng.seed_keys(seeds, device=self.device)
        if init_keys is not None:
            init_keys = torch.as_tensor(init_keys, dtype=torch.int64,
                                        device=self.device)
            if init_keys.shape != (L, 2):
                raise ValueError(f"init_keys has shape "
                                 f"{tuple(init_keys.shape)} for {L} lanes")
        if init_params is None:
            init_params = self.init_params(
                keys=seed_keys if init_keys is None else init_keys)
        if init_params.shape != (L, self.layout.size):
            raise ValueError(f"init_params has shape "
                             f"{tuple(init_params.shape)}, expected "
                             f"{(L, self.layout.size)}")
        sim_keys = prng.fold_in(seed_keys, 1)
        m_max = int(max(ms))  # shared by every lane
        dist = self.cfg.distribution
        state = stack_lanes([
            init_state(net, int(m), k, m_max=m_max, distribution=dist,
                       t_cap=horizon)
            for net, m, k in zip(lane_nets, ms, sim_keys)])
        events = EventStream(lane_nets, event_key(sim_keys),
                             distribution=dist)
        batches = BatchStream(prng.fold_in(seed_keys, 2),
                              self.cfg.batch_size)
        dlog, final = self.run_streams(
            init_params, state, events, batches, lane_nets, etas, horizon,
            max_updates=max_updates, lane_clients=lane_clients,
            lane_powers=lane_powers)
        n_acts = [int(net.active_count) for net in lane_nets]
        return self.train_logs(dlog, n_acts), final


@dataclasses.dataclass
class StrategyGridResult:
    """Result of :func:`run_strategy_grid`: ``logs[name][seed_idx]``, and
    the final flat parameters ``[lanes, N]`` in lane order (strategies in
    their order, each over the seeds)."""

    logs: dict
    seeds: tuple
    lanes: int
    updates_per_lane: int
    final_params: Optional[torch.Tensor] = None


def run_strategy_grid(model: torch.nn.Module, clients, net: NetworkParams,
                      strategies: dict, config, *, horizon_time: float,
                      seeds=(0,), etas=None, test_data=None, power=None,
                      trainer: Optional[DeviceTrainer] = None,
                      loss_fn: Callable = cross_entropy_loss,
                      device="cuda") -> StrategyGridResult:
    """One multi-seed strategy comparison: the ``strategies x seeds`` grid
    runs as the lanes of one :meth:`DeviceTrainer.run_lanes` call.

    ``strategies`` maps name -> ``(p, m)``; ``etas`` maps name -> step size
    (or a scalar for all).
    """
    if trainer is None:
        trainer = DeviceTrainer(model, clients, net, config,
                                test_data=test_data, power=power,
                                loss_fn=loss_fn, device=device)
    names = list(strategies)
    if etas is None:
        etas = {name: config.eta for name in names}
    elif not isinstance(etas, dict):
        etas = {name: float(etas) for name in names}
    ps, ms, es, ss = [], [], [], []
    for name in names:
        p, m = strategies[name]
        p = np.asarray(torch.as_tensor(p).detach().cpu(), np.float64)
        for s in seeds:
            ps.append(p)
            ms.append(int(m))
            es.append(float(etas[name]))
            ss.append(int(s))
    logs, final = trainer.run_lanes(ps, ms, es, ss, horizon_time)
    n_seeds = len(seeds)
    per_name = {name: logs[i * n_seeds:(i + 1) * n_seeds]
                for i, name in enumerate(names)}
    return StrategyGridResult(logs=per_name, seeds=tuple(seeds),
                              lanes=len(ms),
                              updates_per_lane=trainer.plan_updates(
                                  ps, ms, float(horizon_time)),
                              final_params=final)
