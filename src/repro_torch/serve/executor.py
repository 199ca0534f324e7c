"""Request execution on shared suite caches (port of
``repro.serve.executor``).

The executor is the single owner of all tensor state in the server: one
:class:`repro_torch.scenario.SuiteCaches` bundle (bucket runners,
trainers, result cache, datasets) shared by every micro-batch, one
:class:`Metrics` registry, a content-keyed strategy-resolution cache and
a response cache keyed by ``(mode, Scenario.hash(), seeds, options)`` —
a repeat request is answered from it without any dispatch.

All methods that touch torch MUST be called from one thread (the
server's dispatcher): PyTorch's current device and current stream belong
to each thread, so the dispatcher calls :meth:`Executor.bind` before its
first dispatch and every kernel launches on that thread's stream.  The
admission path only parses and hashes.

Batching contract (why the bucket key looks the way it does): ``n``- and
class-axis padding are bitwise invariant, so requests with different
populations share a dispatch freely.  The task TABLE size is **not**
invariant — trajectories draw per slot — so simulate/train requests
bucket on their *effective* ``m`` and only equal-``m`` requests coalesce;
every response is bitwise what a direct single-scenario
``ScenarioSuite`` run returns.  Train requests additionally bucket on
everything that keys the suite's structural train bucket (law,
CS-buffer/power structure, grad clip, data spec, overrides, model
architecture).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..scenario import ScenarioSuite
from ..scenario.suite import SuiteCaches, resolve_strategy
from .metrics import Metrics
from .protocol import MAX_M, Request, WireError, encode_entry


@dataclasses.dataclass
class Completion:
    """One finished request: the JSON-able payload plus dispatch facts."""

    request: Request
    value: object = None
    cached: bool = False
    error: Optional[WireError] = None


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _options_key(options: dict) -> tuple:
    return _freeze(options)


class Executor:
    """Builds per-micro-batch suites over one shared cache bundle, on
    ``device`` (default the card; asking for ``cuda`` without one raises
    here, never falls back to the CPU)."""

    def __init__(self, metrics: Optional[Metrics] = None, *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"the server was asked for device {str(self.device)!r} "
                    "but no CUDA device is available; pass device='cpu' "
                    "(CLI: --device cpu) to serve on the CPU")
            if self.device.index is None:
                # "cuda" is the constructing thread's current card; the
                # dispatcher thread is bound to it by index
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.caches = SuiteCaches()
        self.metrics = metrics if metrics is not None else Metrics()
        self._resolve_shared: dict = {}   # net_key -> resolve_strategy caches
        self._resolved: dict = {}         # (scenario hash) -> (p, m)
        self._models: dict = {}           # model-spec key -> Model
        self._responses: dict = {}        # response cache
        #: rolling drift-monitor summary over every traced dispatch,
        #: surfaced by the server's ``stats`` verb
        self.drift: dict = {"checked": 0, "breaches": 0, "last": None}

    def bind(self) -> None:
        """Make the executor's device the calling thread's current device
        (the dispatcher calls this once, before its first dispatch)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # -- admission-side helpers (no torch) ----------------------------------

    def response_key(self, req: Request) -> tuple:
        return (req.mode, req.scenario.hash(), req.seeds,
                _options_key(req.options))

    def cached_response(self, req: Request):
        return self._responses.get(self.response_key(req))

    # -- dispatcher-side --------------------------------------------------

    def resolve(self, req: Request):
        """Resolved ``(p, m)`` for a request's scenario (content-cached;
        shared normalizers reused across requests on the same network —
        mirrors ``ScenarioSuite.resolve``)."""
        scn = req.scenario
        rkey = scn.hash()
        hit = self._resolved.get(rkey)
        if hit is not None:
            return hit
        net_key = (str(scn.network.to_dict()), str(scn.learning.to_dict()),
                   str(None if scn.energy is None else scn.energy.to_dict()),
                   scn.strategy.m_max, scn.strategy.steps,
                   scn.strategy.search)
        shared = self._resolve_shared.setdefault(
            net_key, {"cache": {}, "resolved": {}})
        pm = resolve_strategy(scn, resolved=shared["resolved"],
                              cache=shared["cache"], device=self.device)
        shared["resolved"][scn.strategy.name] = pm
        self._resolved[rkey] = pm
        return pm

    def bucket_key(self, req: Request) -> tuple:
        """The micro-batch coalescing key: requests with equal keys run
        as lanes of ONE suite dispatch, bitwise-equal to running alone."""
        scn = req.scenario
        _, m = self.resolve(req)
        m_eff = int(req.options.get("m_max") or m)
        if m_eff > MAX_M:
            raise WireError("ProtocolError",
                            f"resolved concurrency m={m_eff} exceeds the "
                            f"server bound {MAX_M}", req.id)
        structure = (scn.network.law, scn.network.mu_cs is not None,
                     None if scn.energy is None
                     else scn.energy.P_cs is not None,
                     scn.is_class_network, scn.sim_backend,
                     None if scn.sim is None else scn.sim.interpret,
                     # ring capacities key the traced runner variants —
                     # traced and untraced requests must not coalesce
                     None if scn.trace is None
                     else (scn.trace.events, scn.trace.updates))
        if req.mode == "analyze":
            # closed forms are padding-invariant on every axis incl. the
            # task table, and analyze results cache by scenario hash alone
            return ("analyze", req.seeds, structure)
        opts = dict(req.options)
        if req.mode == "simulate":
            return ("simulate", req.seeds, structure, m_eff,
                    int(opts["num_updates"]), int(opts.get("warmup", 0)),
                    opts.get("backend"))
        model_key = _options_key(opts.pop("model"))
        opts.pop("horizon_time"), opts.pop("max_updates", None)
        return ("train", req.seeds, structure, int(m), model_key,
                scn.learning.grad_clip,
                str(None if scn.data is None else scn.data.to_dict()),
                float(req.options["horizon_time"]),
                req.options.get("max_updates"), _options_key(opts))

    def _model_for(self, spec) -> object:
        """Architecture from a wire model spec — identity-cached so the
        suite's trainer memo keeps hitting across micro-batches."""
        from ..fl.models import mlp_classifier

        if not isinstance(spec, dict):
            raise WireError("ProtocolError",
                            "options.model must be an object like "
                            '{"kind": "mlp", "input_dim": ..., '
                            '"num_classes": ..., "hidden": [...]}')
        key = _options_key(spec)
        hit = self._models.get(key)
        if hit is not None:
            return hit
        kind = spec.get("kind", "mlp")
        if kind != "mlp":
            raise WireError("ProtocolError",
                            f"unknown model kind {kind!r}; the wire "
                            "format currently serves 'mlp'")
        try:
            model = mlp_classifier(int(spec["input_dim"]),
                                   int(spec["num_classes"]),
                                   hidden=tuple(spec.get("hidden", (8,))),
                                   device=self.device)
        except KeyError as e:
            raise WireError("ProtocolError",
                            f"model spec needs {e.args[0]!r}") from e
        self._models[key] = model
        return model

    def run_group(self, requests: list) -> list:
        """ONE suite dispatch for a coalesced group (equal bucket keys).

        Returns a :class:`Completion` per request, in order.  A failure
        is reported on every member (they shared the dispatch) as a
        structured error; the shared caches stay valid — they are
        content-keyed and only written after a successful run.
        """
        mode = requests[0].mode
        # positional suite keys: wire ids are only unique per connection,
        # and one micro-batch spans connections
        suite = ScenarioSuite(
            {f"q{i}": req.scenario for i, req in enumerate(requests)},
            seeds=requests[0].seeds, caches=self.caches,
            metrics=self.metrics, device=self.device)
        # pre-resolved strategies: skip re-resolving inside the suite
        for i, req in enumerate(requests):
            suite._strategies[f"q{i}"] = self.resolve(req)
        opts = dict(requests[0].options)
        try:
            if mode == "analyze":
                res = suite.run(mode="analyze")
            elif mode == "simulate":
                res = suite.run(
                    mode="simulate", num_updates=int(opts["num_updates"]),
                    warmup=int(opts.get("warmup", 0)),
                    m_max=(None if opts.get("m_max") is None
                           else int(opts["m_max"])),
                    backend=opts.get("backend"))
            else:
                model = self._model_for(opts.pop("model"))
                horizon = float(opts.pop("horizon_time"))
                max_updates = opts.pop("max_updates", None)
                res = suite.run(mode="train", model=model,
                                horizon_time=horizon,
                                max_updates=(None if max_updates is None
                                             else int(max_updates)),
                                **opts)
            if getattr(res, "drift", None):
                for reports in res.drift.values():
                    for rep in reports:
                        self.drift["checked"] += 1
                        if not rep.get("ok"):
                            self.drift["breaches"] += 1
                            self.metrics.inc("obs.drift_breaches", mode=mode)
                        self.drift["last"] = rep
            out = []
            for i, req in enumerate(requests):
                payload = encode_entry(mode, res.entries[f"q{i}"])
                self._responses[self.response_key(req)] = payload
                out.append(Completion(request=req, value=payload))
            return out
        except WireError as e:
            return [Completion(request=req,
                               error=WireError(e.etype, str(e), req.id))
                    for req in requests]
        except Exception as e:
            return [Completion(request=req,
                               error=WireError(type(e).__name__, str(e),
                                               req.id))
                    for req in requests]
