"""ScenarioSuite — plan and run batches of Scenarios in few programs (port
of ``repro.scenario.suite``), and the strategy and objective
registrations.

One entry point, three execution modes, all driven by the same spec::

    suite = ScenarioSuite.strategy_grid(base, ("asyncsgd", "time_opt"),
                                        seeds=range(4))
    closed = suite.run(mode="analyze")                     # closed forms
    stats = suite.run(mode="simulate", num_updates=2000)   # event engine
    logs = suite.run(mode="train", model=m, horizon_time=240.0)  # trainer

Planning: scenarios x seeds flatten into *lanes*; lanes are bucketed by
static structure and each bucket runs as one batched evaluation over its
stacked, padded lanes (one runner per bucket signature, kept in
``SuiteCaches.jit``); ``SuiteResult.programs`` counts the runners built.

The paper's six scheduling configurations resolve through ``STRATEGIES``
and its closed-form objectives through ``OBJECTIVES``; their
implementations live in ``repro_torch.core``.  :func:`resolve_strategy`
turns one :class:`repro_torch.scenario.spec.Scenario` into ``(p, m)``.
The Buzen backend of the sweeps and of ``analyze`` is the process-wide
one (``repro_torch.core.buzen.set_backend``).
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.batched import (energy_complexity_classes,
                            energy_complexity_padded,
                            expected_relative_delay_classes,
                            expected_relative_delay_padded,
                            make_energy_objective_padded,
                            make_joint_objective_padded,
                            make_round_objective_padded,
                            make_throughput_objective_padded,
                            make_time_objective_padded,
                            round_complexity_classes,
                            round_complexity_padded, throughput_padded)
from ..core.buzen import (NetworkParams, class_log_normalizing_constants,
                          get_backend, log_normalizing_constants,
                          pad_classes, pad_network)
from ..core import prng
from ..core.complexity import LearningConstants, wallclock_time
from ..core.energy import (PowerProfile, energy_optimal_routing,
                           minimal_energy)
from ..core.events import lane, stack_lanes, unpad_stats
from ..core.numerics import DTYPE
from ..kernels import build
from ..obs.drift import drift_report, predict
from ..obs.rings import decode, decode_lane
from ..core.optimize import (joint_optimal, make_energy_objective,
                             make_joint_objective, make_round_objective,
                             make_throughput_objective, make_time_objective,
                             optimize_routing, time_optimal)
from .registry import STRATEGIES, OBJECTIVES, objective, strategy
from .spec import EXPLICIT, Scenario

MODES = ("analyze", "simulate", "train")


# ---------------------------------------------------------------------------
# objective registry — named closed-form objectives (static + padded forms)
# ---------------------------------------------------------------------------

class ObjectiveDef(NamedTuple):
    """One optimizable/reportable closed form.

    ``static(params, consts, power, refs)`` returns the ``obj(p, m)``
    callable; ``padded(params, consts, power, refs, m_max)`` the batched
    ``obj(p, m, logZ[, rho])`` of ``repro_torch.core.batched``.  ``refs``
    carries the joint objective's normalizers (``tau_star``/``e_star``);
    ``uses_ctx`` marks objectives whose padded form takes the per-row
    sweep context (the Pareto weight ``rho``).
    """

    static: Callable
    padded: Callable
    needs_power: bool = False
    needs_refs: bool = False
    uses_ctx: bool = False


@objective("time")
def _obj_time() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_time_objective(prm, c),
        padded=lambda prm, c, pw, refs, mx:
            make_time_objective_padded(prm, c, mx))


@objective("round")
def _obj_round() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_round_objective(prm, c),
        padded=lambda prm, c, pw, refs, mx:
            make_round_objective_padded(prm, c, mx))


@objective("throughput")
def _obj_throughput() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_throughput_objective(prm),
        padded=lambda prm, c, pw, refs, mx:
            make_throughput_objective_padded(prm, mx))


@objective("energy")
def _obj_energy() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_energy_objective(prm, c, pw),
        padded=lambda prm, c, pw, refs, mx:
            make_energy_objective_padded(prm, c, pw, mx),
        needs_power=True)


@objective("joint")
def _obj_joint() -> ObjectiveDef:
    return ObjectiveDef(
        static=lambda prm, c, pw, refs: make_joint_objective(
            prm, c, pw, refs["rho"], refs["tau_star"], refs["e_star"]),
        padded=lambda prm, c, pw, refs, mx: make_joint_objective_padded(
            prm, c, pw, refs["tau_star"], refs["e_star"], mx),
        needs_power=True, needs_refs=True, uses_ctx=True)


def get_objective(name: str) -> ObjectiveDef:
    return OBJECTIVES.get(name)()


# ---------------------------------------------------------------------------
# strategy registry — the paper's scheduling configurations (Section 5.3/6.5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResolveContext:
    """Inputs a strategy resolver sees (one scenario's worth)."""

    params: NetworkParams             # base network, on the resolve device
    consts: LearningConstants
    power: Optional[PowerProfile]
    rho: float                        # Pareto weight (objective spec)
    m: Optional[int]                  # forced concurrency (None = strategy's)
    m_max: int                        # concurrency search bound
    steps: int                        # Adam steps
    search: str                       # "batched" | "pruned" | "sequential"
    resolved: dict                    # earlier (p, m) results in this batch
    cache: dict                       # shared memo (tau_star / e_star)


def _as_pm(p, m) -> tuple[np.ndarray, int]:
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    return np.asarray(p, dtype=np.float64), int(m)


@strategy("asyncsgd")
def _strat_asyncsgd(ctx: ResolveContext):
    """Uniform routing, m = n (Alg. 2 of [29])."""
    n = ctx.params.n
    return _as_pm(np.full(n, 1.0 / n), ctx.m if ctx.m is not None else n)


@strategy("max_throughput")
def _strat_max_throughput(ctx: ResolveContext):
    """p*_lambda at m = n."""
    m = ctx.m if ctx.m is not None else ctx.params.n
    obj = get_objective("throughput").static(ctx.params, ctx.consts,
                                             ctx.power, None)
    res = optimize_routing(obj, ctx.params.n, m, steps=ctx.steps,
                           device=ctx.params.device)
    return _as_pm(res.p, m)


@strategy("round_opt")
def _strat_round_opt(ctx: ResolveContext):
    """p*_K at m = n ([31, 2])."""
    m = ctx.m if ctx.m is not None else ctx.params.n
    obj = get_objective("round").static(ctx.params, ctx.consts, ctx.power,
                                        None)
    res = optimize_routing(obj, ctx.params.n, m, steps=ctx.steps,
                           device=ctx.params.device)
    return _as_pm(res.p, m)


@strategy("time_opt")
def _strat_time_opt(ctx: ResolveContext):
    """(p*_tau, m*_tau) — the paper's proposed strategy."""
    if ctx.m is not None:
        obj = get_objective("time").static(ctx.params, ctx.consts, ctx.power,
                                           None)
        res = optimize_routing(obj, ctx.params.n, ctx.m, steps=ctx.steps,
                               device=ctx.params.device)
        return _as_pm(res.p, ctx.m)
    res = time_optimal(ctx.params, ctx.consts, m_max=ctx.m_max,
                       steps=ctx.steps, search=ctx.search)
    ctx.cache["tau_star"] = float(res.value)
    return _as_pm(res.p, res.m)


@strategy("energy_opt")
def _strat_energy_opt(ctx: ResolveContext):
    """Closed-form (p*_E, m = 1) — Eq. 16."""
    if ctx.power is None:
        raise ValueError("strategy 'energy_opt' needs a power profile "
                         "(EnergySpec)")
    return _as_pm(energy_optimal_routing(ctx.params, ctx.power),
                  ctx.m if ctx.m is not None else 1)


@strategy("joint")
def _strat_joint(ctx: ResolveContext):
    """(p*_rho, m*_rho) — the Eq. 18 scalarization at the scenario's rho;
    reuses ``tau_star`` from the cache or from a resolved ``time_opt``."""
    if ctx.power is None:
        raise ValueError("strategy 'joint' needs a power profile "
                         "(EnergySpec)")
    tau_star = ctx.cache.get("tau_star")
    if tau_star is None:
        if "time_opt" in ctx.resolved:
            p_tau, m_tau = ctx.resolved["time_opt"]
            p_tau = torch.as_tensor(p_tau, dtype=DTYPE,
                                    device=ctx.params.device)
            tau_star = float(wallclock_time(ctx.params._replace(p=p_tau),
                                            m_tau, ctx.consts))
        else:
            tau_star = time_optimal(ctx.params, ctx.consts, m_max=ctx.m_max,
                                    steps=ctx.steps,
                                    search=ctx.search).value
        ctx.cache["tau_star"] = tau_star
    e_star = ctx.cache.get("e_star")
    if e_star is None:
        e_star = ctx.cache["e_star"] = float(
            minimal_energy(ctx.params, ctx.consts, ctx.power))
    res = joint_optimal(ctx.params, ctx.consts, ctx.power, ctx.rho, tau_star,
                        e_star, m_max=ctx.m_max, steps=ctx.steps,
                        search=ctx.search)
    return _as_pm(res.p, res.m)


def default_m_max(n: int) -> int:
    """The historical ``make_strategies`` search bound."""
    return n + max(8, n // 4)


def _resolve_class_strategy(scenario: Scenario, cache: dict, device
                            ) -> tuple[np.ndarray, int]:
    """Class-space strategy resolution — O(#classes), never expands.

    Returns a PER-CLASS routing vector ``p`` of shape ``[C]`` (one
    member's probability for each class).  Supported: ``"asyncsgd"``
    (uniform per-member routing, ``m = n_total`` unless forced) and
    ``"time_opt"`` (the class-space sweep of ``time_optimal_classes``;
    needs an explicit ``StrategySpec.m_max``).  Other strategies raise:
    resolve them on the expanded per-client network.
    """
    from ..core.batched import make_time_objective_classes
    from ..core.optimize import (batched_concurrency_sweep,
                                 time_optimal_classes)

    spec = scenario.strategy
    n_total = int(scenario.n)
    C = scenario.network.classes.C
    if spec.name == "asyncsgd":
        m = spec.m if spec.m is not None else n_total
        return _as_pm(np.full(C, 1.0 / n_total), m)
    if spec.name == "time_opt":
        if spec.m_max is None:
            raise ValueError(
                "class-network 'time_opt' needs an explicit "
                "StrategySpec.m_max: the per-client default scales with the "
                f"population (n_total = {n_total} here)")
        if spec.m is not None and spec.m > spec.m_max:
            raise ValueError(f"forced m={spec.m} exceeds m_max={spec.m_max}")
        classes = scenario.class_params(device=device)
        if spec.m is not None:
            res = batched_concurrency_sweep(
                make_time_objective_classes(classes, scenario.consts,
                                            spec.m_max),
                classes, m_grid=[spec.m], m_max=spec.m_max,
                steps=spec.steps).best
        else:
            res = time_optimal_classes(classes, scenario.consts, spec.m_max,
                                       search=spec.search, steps=spec.steps)
        cache.setdefault("tau_star", float(res.value))
        return _as_pm(res.p, res.m)
    raise ValueError(
        f"strategy {scenario.strategy.name!r} has no class-space resolver; "
        "class networks support 'explicit', 'asyncsgd' and 'time_opt' "
        "(expand with NetworkSpec.from_clusters(..., aggregate=False) to "
        "use the per-client resolvers)")


def resolve_strategy(scenario: Scenario, *, resolved: Optional[dict] = None,
                     cache: Optional[dict] = None, device="cuda"
                     ) -> tuple[np.ndarray, int]:
    """One scenario's ``(p, m)``: the explicit spec or the registry's
    resolver, run on ``device``; ``p`` comes back as float64 numpy.

    Class-aggregated networks dispatch to the O(#classes) resolvers before
    any per-client array exists.
    """
    spec = scenario.strategy
    if spec.name == EXPLICIT:
        return _as_pm(spec.p, spec.m)
    if scenario.is_class_network:
        return _resolve_class_strategy(scenario,
                                       {} if cache is None else cache, device)
    n = scenario.n
    ctx = ResolveContext(
        params=scenario.params(device=device), consts=scenario.consts,
        power=scenario.power(device=device), rho=scenario.objective.rho,
        m=spec.m,
        m_max=spec.m_max if spec.m_max is not None else default_m_max(n),
        steps=spec.steps, search=spec.search,
        resolved={} if resolved is None else resolved,
        cache={} if cache is None else cache)
    return STRATEGIES.get(spec.name)(ctx)


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SuiteResult:
    """Result of one :meth:`ScenarioSuite.run` call.

    ``entries[name]`` is mode-dependent: a closed-form dict (``analyze``),
    a per-seed list of ``EventStats`` (``simulate``), or a per-seed list of
    ``TrainLog`` (``train``).  ``programs`` counts the bucket runners the
    call built (in ``train``, the trainers) — the bucketing win is
    ``programs < len(entries)`` for structurally-alike scenarios.
    ``cache_hits`` counts entries served from the suite-level result cache
    (keyed by ``Scenario.hash()`` x seeds x mode x run settings): re-running
    an unchanged scenario costs nothing.  ``traces[name]`` holds the
    per-seed decoded telemetry rings (:func:`repro_torch.obs.rings.decode`)
    of scenarios whose ``TraceSpec`` asks for them — the event ring in
    ``simulate``, the update ring in ``train`` — and ``drift[name]`` the
    per-seed drift reports of the event rings against the closed forms
    (:func:`repro_torch.obs.drift.drift_report`); ``None`` when no
    scenario traces.
    """

    mode: str
    entries: dict
    seeds: tuple
    lanes: int
    programs: int
    strategies: dict  # name -> (p, m) resolved routing/concurrency
    cache_hits: int = 0
    metrics: Optional[dict] = None  # Metrics.snapshot() of the owning suite
    traces: Optional[dict] = None
    drift: Optional[dict] = None


@dataclasses.dataclass
class SuiteCaches:
    """The content-keyed caches a :class:`ScenarioSuite` runs on, as a
    shareable bundle: pass one ``SuiteCaches`` to many suites and they
    share bucket runners (``jit``), built trainers, per-entry results and
    DataSpec-built datasets.  Name-keyed state (resolved strategies) stays
    per suite — names are caller-chosen and collide across requests."""

    jit: dict = dataclasses.field(default_factory=dict)
    trainers: dict = dataclasses.field(default_factory=dict)
    results: dict = dataclasses.field(default_factory=dict)
    data: dict = dataclasses.field(default_factory=dict)


class ScenarioSuite:
    """A keyed collection of Scenarios sharing a seed set, run on
    ``device`` (default the card).

    Scenarios x seeds flatten into *lanes*; lanes are bucketed by static
    structure and each bucket runs as ONE batched evaluation over the
    stacked lanes (populations padded to the suite-wide ``n_max`` with
    ``pad_network``, class sets to ``c_max`` with ``pad_classes``)::

        suite = ScenarioSuite.strategy_grid(base, ("asyncsgd", "time_opt"),
                                            seeds=range(4))
        closed = suite.run(mode="analyze")                    # closed forms
        stats = suite.run(mode="simulate", num_updates=2000)  # event engine
        logs = suite.run(mode="train", model=m, clients=c,
                         horizon_time=240.0)                  # the trainer

    The Buzen backend of ``analyze`` and of the strategy sweeps is the
    process-wide one (``repro_torch.core.buzen.set_backend``); the event
    engine's comes from the ``backend=`` argument, each scenario's
    ``SimSpec`` or ``repro_torch.sim.set_backend``, in that order.
    """

    def __init__(self, scenarios, seeds=(0,), *, caches=None, metrics=None,
                 device="cuda"):
        from ..obs.metrics import Metrics

        if isinstance(scenarios, Scenario):
            scenarios = [scenarios]
        if not isinstance(scenarios, dict):
            scenarios = {
                (s.name or f"scenario{i}"): s
                for i, s in enumerate(scenarios)}
        if not scenarios:
            raise ValueError("need at least one scenario")
        for k, s in scenarios.items():
            if not isinstance(s, Scenario):
                raise TypeError(f"suite entry {k!r} is not a Scenario: {s!r}")
        self.scenarios: dict[str, Scenario] = dict(scenarios)
        self.seeds = tuple(int(s) for s in seeds)
        self.device = torch.device(device)
        self.caches = caches if caches is not None else SuiteCaches()
        self.metrics = metrics if metrics is not None else Metrics()
        self._strategies: dict[str, tuple[np.ndarray, int]] = {}
        self._jit_cache = self.caches.jit
        self._trainers = self.caches.trainers
        self._result_cache = self.caches.results  # Scenario.hash keys
        self._data_cache = self.caches.data  # DataSpec-built datasets

    @classmethod
    def strategy_grid(cls, base: Scenario, strategies, seeds=(0,), *,
                      device="cuda", **strategy_kw) -> "ScenarioSuite":
        """One suite entry per strategy name, derived from ``base``."""
        return cls({name: base.with_strategy(name, **strategy_kw)
                    for name in strategies}, seeds=seeds, device=device)

    def __len__(self) -> int:
        return len(self.scenarios)

    def to_dict(self) -> dict:
        return {"seeds": list(self.seeds),
                "scenarios": {k: s.to_dict()
                              for k, s in self.scenarios.items()}}

    @classmethod
    def from_dict(cls, d: dict, *, device="cuda") -> "ScenarioSuite":
        return cls({k: Scenario.from_dict(v)
                    for k, v in d["scenarios"].items()},
                   seeds=tuple(d.get("seeds", (0,))), device=device)

    # -- strategy resolution (cached) ---------------------------------------

    def resolve(self) -> dict[str, tuple[np.ndarray, int]]:
        """Resolved ``{name: (p, m)}`` for every scenario (cached; shared
        normalizers like tau*/E* are computed once per network).

        The sharing key covers everything the cached values depend on —
        network, constants, energy spec AND the strategy search settings
        (``m_max``/``steps``/``search``) — so a suite sweeping power
        profiles or optimizer budgets never reuses a stale tau*/E*.
        """
        caches: dict = {}
        for name, scn in self.scenarios.items():
            if name in self._strategies:
                continue
            net_key = (str(scn.network.to_dict()),
                       str(scn.learning.to_dict()),
                       str(None if scn.energy is None
                           else scn.energy.to_dict()),
                       scn.strategy.m_max, scn.strategy.steps,
                       scn.strategy.search)
            shared = caches.setdefault(net_key, {"cache": {}, "resolved": {}})
            pm = resolve_strategy(scn, resolved=shared["resolved"],
                                  cache=shared["cache"], device=self.device)
            shared["resolved"][scn.strategy.name] = pm
            self._strategies[name] = pm
        return {name: self._strategies[name] for name in self.scenarios}

    # -- dispatch ------------------------------------------------------------

    def run(self, mode: str = "analyze", **kw) -> SuiteResult:
        runners = {"analyze": self._run_analyze,
                   "simulate": self._run_simulate,
                   "train": self._run_train}
        if mode not in runners:
            raise ValueError(
                f"unknown mode: {mode!r}; expected one of {MODES}")
        with self.metrics.timed("suite.run", mode=mode):
            res = runners[mode](**kw)
        self.metrics.inc("suite.requests", by=len(self.scenarios), mode=mode)
        self.metrics.inc("suite.cache_hits", by=res.cache_hits, mode=mode)
        self.metrics.inc("suite.programs", by=res.programs, mode=mode)
        self.metrics.inc("suite.lanes", by=res.lanes, mode=mode)
        res.metrics = self.metrics.snapshot()
        return res

    def _pop_max(self):
        """The suite-wide pads: ``n_max`` over the per-client scenarios and
        ``c_max`` over the class sets (class lanes never inflate the
        per-client pad)."""
        scns = self.scenarios.values()
        n_max = max((s.n for s in scns if not s.is_class_network), default=0)
        c_max = max((s.network.classes.C for s in scns
                     if s.is_class_network), default=0)
        return n_max, c_max

    def _lane_params(self, name: str, p, is_classes: bool, n_max: int,
                     c_max: int):
        """One lane's network at routing ``p``, padded to the suite's
        pad."""
        scn = self.scenarios[name]
        if is_classes:
            return pad_classes(scn.class_params(p, device=self.device),
                               c_max)
        return pad_network(scn.params(p, device=self.device), n_max)

    # -- analyze: closed forms, one batched evaluation per bucket ------------

    def _run_analyze(self) -> SuiteResult:
        """Closed forms for every scenario, bucketed by (CS station, power
        signature, class network): each bucket is one batched evaluation
        over its stacked lanes — one Buzen DP call for the bucket, then
        the padded (or class) forms with per-lane ``m``, constants and
        ``rho``.  Under the padding contract each row is bitwise its
        scenario evaluated alone at the bucket's table size (``m_max``,
        the bucket's largest ``m``)."""
        strategies = self.resolve()
        names = list(self.scenarios)
        n_max, c_max = self._pop_max()
        backend = get_backend()
        entries: dict = {}
        cache_hits = 0
        buckets: dict = {}
        for name in names:
            scn = self.scenarios[name]
            hit = self._result_cache.get(self._analyze_key(scn, backend))
            if hit is not None:
                entries[name] = hit
                cache_hits += 1
                continue
            key = (scn.network.mu_cs is not None, _power_sig(scn),
                   scn.is_class_network)
            buckets.setdefault(key, []).append(name)

        programs = 0
        for (has_cs, power_sig, is_classes), members in buckets.items():
            has_power = power_sig is not None
            m_max = max(strategies[name][1] for name in members)
            axis_max = c_max if is_classes else n_max
            prm = stack_lanes([self._lane_params(n_, strategies[n_][0],
                                                 is_classes, n_max, c_max)
                               for n_ in members])
            consts = _stack_consts([self.scenarios[n_].consts
                                    for n_ in members], self.device)
            power = (stack_lanes([
                _pad_power(self.scenarios[n_].power(device=self.device),
                           axis_max) for n_ in members])
                     if has_power else None)
            m_vec = torch.as_tensor([strategies[n_][1] for n_ in members],
                                    dtype=torch.int64, device=self.device)
            rho = torch.as_tensor([self.scenarios[n_].objective.rho
                                   for n_ in members], dtype=DTYPE,
                                  device=self.device)
            sig = ("analyze", is_classes, axis_max, has_cs, power_sig, m_max)
            fn = self._jit_cache.get(sig)
            if fn is None:
                fn = self._jit_cache[sig] = _build_analyze(
                    m_max, has_power, is_classes)
                programs += 1
                build.runner_built("suite.analyze")
            with self.metrics.timed("suite.dispatch", mode="analyze"):
                out = {k: v.detach().cpu().numpy()
                       for k, v in fn(prm, m_vec, consts, power,
                                      rho).items()}
            self.metrics.observe("suite.lanes_per_dispatch", len(members),
                                 mode="analyze")
            for i, name in enumerate(members):
                scn = self.scenarios[name]
                # class rows report per-CLASS delays (one member each);
                # truncate to the scenario's own axis either way
                n_i = scn.network.classes.C if is_classes else scn.n
                row = {k: v[i] for k, v in out.items()}
                p, m = strategies[name]
                obj_name = scn.objective.name
                # None (not a mislabeled tau) for objectives analyze cannot
                # evaluate: registered extensions without an analyze column
                val_key = _ANALYZE_KEY.get(obj_name)
                entries[name] = {
                    "p": p, "m": m, "eta": scn.eta(),
                    "throughput": float(row["throughput"]),
                    "K_eps": float(row["K_eps"]),
                    "tau": float(row["tau"]),
                    "delays": row["delays"][:n_i],  # E0[D_i] (Thm 2)
                    "energy": (float(row["energy"]) if has_power else None),
                    "objective": obj_name,
                    "value": (float(row[val_key])
                              if val_key is not None and val_key in row
                              else None),
                }
                self._result_cache[self._analyze_key(scn, backend)] = \
                    entries[name]
        return SuiteResult(mode="analyze", entries=entries, seeds=self.seeds,
                           lanes=len(names), programs=programs,
                           strategies=strategies, cache_hits=cache_hits)

    def _analyze_key(self, scn: Scenario, backend: str) -> tuple:
        # the Buzen backend and the device change the last bits
        return ("analyze", scn.hash(), backend, str(self.device))

    # -- simulate: the event engine, one runner per bucket -------------------

    def _run_simulate(self, num_updates: int, *, warmup: int = 0,
                      m_max: Optional[int] = None,
                      backend: Optional[str] = None) -> SuiteResult:
        """The event engine through the ``repro_torch.sim`` backends.

        Backend precedence: the ``backend=`` argument, else each scenario's
        ``SimSpec``, else the process-wide ``repro_torch.sim`` flag; lanes
        are bucketed by (law, CS station, power signature, backend, class
        network, chunk), so pinned scenarios coexist.  Lanes are padded to
        the suite-wide ``n_max`` (``c_max``); trajectories are bitwise
        invariant to that padding, so each lane's statistics — unpadded
        before they are returned and cached — equal
        :func:`repro_torch.sim.simulate_stats_lanes` of its scenario alone
        at the same seed, table size and chunk, bitwise.  Seed ``s`` is
        ``PRNGKey(s)``, the JAX package's key, so each lane draws what the
        JAX suite's lane draws.  A scenario whose ``TraceSpec`` asks for an
        event ring runs with one per lane (the bucket carries its
        capacity): the result's ``traces`` and ``drift`` hold the decoded
        rings and their drift reports, cached beside the statistics.
        """
        from ..sim.backend import resolve_backend
        from ..sim.batched_events import build_class_lanes_fn, build_lanes_fn

        strategies = self.resolve()
        names = list(self.scenarios)
        n_max, c_max = self._pop_max()
        entries: dict = {}
        traces: dict = {}
        drift: dict = {}
        cache_hits = 0
        buckets: dict = {}
        for name in names:
            scn = self.scenarios[name]
            bk = resolve_backend(backend if backend is not None
                                 else scn.sim_backend)
            ck = 1 if scn.sim is None else int(scn.sim.chunk)
            tr = 0 if scn.trace is None else int(scn.trace.events)
            key = (scn.network.law, scn.network.mu_cs is not None,
                   _power_sig(scn), bk, scn.is_class_network, ck, tr)
            buckets.setdefault(key, []).append(name)

        programs = 0
        S = len(self.seeds)
        nu, wu = int(num_updates), int(warmup)
        for (law, has_cs, power_sig, bk, is_classes, ck, tr), \
                members in buckets.items():
            has_power = power_sig is not None
            # the table size comes from ALL bucket members (trajectories
            # depend on it: init_state draws per slot), so the *effective*
            # size — not the raw argument — keys the result cache: a hit is
            # bitwise what this bucket would compute fresh, whichever
            # members happen to be cached already
            m_top = max(strategies[name][1] for name in members)
            mx = m_max or m_top
            if mx < m_top:
                # a task table smaller than a lane's m would return
                # plausible-but-wrong statistics
                raise ValueError(
                    f"m_max={mx} is smaller than the largest resolved "
                    f"concurrency m={m_top} in this suite")
            todo = []
            for name in members:
                ckey = ("simulate", self.scenarios[name].hash(), self.seeds,
                        nu, wu, mx, bk, ck, str(self.device))
                hit = self._result_cache.get(ckey)
                if hit is not None:
                    entries[name] = hit
                    cache_hits += 1
                    if tr:  # cached alongside the statistics, same ckey
                        traces[name], drift[name] = self._result_cache[
                            ("trace",) + ckey]
                else:
                    todo.append((name, ckey))
            if not todo:
                continue
            axis_max = c_max if is_classes else n_max
            lane_params = stack_lanes([
                self._lane_params(n_, strategies[n_][0], is_classes, n_max,
                                  c_max)
                for n_, _ in todo for _ in self.seeds])
            power = (stack_lanes([
                _pad_power(self.scenarios[n_].power(device=self.device),
                           axis_max) for n_, _ in todo for _ in self.seeds])
                     if has_power else None)
            m_vec = [strategies[n_][1] for n_, _ in todo for _ in self.seeds]
            keys = prng.seed_keys([s for _ in todo for s in self.seeds],
                                  device=self.device)
            sig = ("simulate", is_classes, axis_max, law, has_cs, power_sig,
                   mx, nu, wu, bk, ck, tr)
            fn = self._jit_cache.get(sig)
            if fn is None:
                builder = (build_class_lanes_fn if is_classes
                           else build_lanes_fn)
                fn = self._jit_cache[sig] = builder(
                    bk, nu, wu, law, mx, has_power, trace_events=tr,
                    chunk=ck)
                programs += 1
                build.runner_built("suite.simulate")
            with self.metrics.timed("suite.dispatch", mode="simulate"):
                out = fn(lane_params, m_vec, keys, power)
            stats, rings = out if tr else (out, None)
            self.metrics.observe("suite.lanes_per_dispatch", len(todo) * S,
                                 mode="simulate")
            for i, (name, ckey) in enumerate(todo):
                # class lanes: statistics are per CLASS — unpad on the
                # class axis (expand_class_stats recovers per-member views)
                n_i = (self.scenarios[name].network.classes.C if is_classes
                       else self.scenarios[name].n)
                entries[name] = [unpad_stats(lane(stats, i * S + j), n_i)
                                 for j in range(S)]
                self._result_cache[ckey] = entries[name]
                if tr:
                    traces[name] = [decode_lane(rings, i * S + j)
                                    for j in range(S)]
                    preds = self._drift_predictions(name, strategies[name],
                                                    is_classes)
                    tol = self.scenarios[name].trace.tolerance
                    drift[name] = [drift_report(d, predictions=preds,
                                                law=law, tolerance=tol)
                                   for d in traces[name]]
                    self._result_cache[("trace",) + ckey] = (traces[name],
                                                             drift[name])
        return SuiteResult(mode="simulate", entries=entries, seeds=self.seeds,
                           lanes=len(names) * S, programs=programs,
                           strategies=strategies, cache_hits=cache_hits,
                           traces=traces or None, drift=drift or None)

    def _drift_predictions(self, name: str, strategy, is_classes: bool):
        """The closed forms a scenario's event rings are held to, at its
        resolved ``(p, m)``: seed- and run-invariant, so computed once per
        (scenario, m) and cached (with the Buzen backend and the device,
        which change the last bits).  Class rings index stations per
        class, so the members' delays fold onto their classes (``E0[D_c]``,
        the sum of the members' shares)."""
        scn = self.scenarios[name]
        p, m = strategy
        pkey = ("drift_pred", scn.hash(), int(m), get_backend(),
                str(self.device))
        preds = self._result_cache.get(pkey)
        if preds is None:
            # Scenario.params() expands a class network, so the closed
            # forms always see the member population
            preds = predict(scn.params(p, device=self.device), m)
            if is_classes:
                cnt = scn.class_params(p, device=self.device).count
                cnt = cnt.detach().cpu().numpy().astype(np.int64)
                lbl = np.repeat(np.arange(len(cnt)), cnt)
                d = np.bincount(lbl, weights=np.asarray(preds["delays"],
                                                        dtype=np.float64),
                                minlength=len(cnt))
                preds = dict(preds, delays=[float(v) for v in d])
            self._result_cache[pkey] = preds
        return preds

    # -- train: the lane trainer ---------------------------------------------

    def _client_data(self, scn: Scenario, name: str):
        """``(clients, test_data)`` for a scenario's ``DataSpec`` (memoized
        by spec content x population, so alike scenarios share the arrays
        and the trainer memo keeps hitting)."""
        if scn.data is None:
            raise ValueError(
                f"mode='train' for scenario {name!r} needs either an "
                "explicit clients= argument or a DataSpec on the scenario")
        key = (str(scn.data.to_dict()), scn.n)
        hit = self._data_cache.get(key)
        if hit is None:
            hit = self._data_cache[key] = scn.data.build(scn.n)
        return hit

    def _run_train(self, *, model, clients=None, horizon_time: float,
                   test_data=None, max_updates: Optional[int] = None,
                   loss_fn=None, **config_overrides) -> SuiteResult:
        """Every scenario x seed as a lane of
        :meth:`repro_torch.fl.DeviceTrainer.run_lanes`.

        Scenarios driven by a ``DataSpec`` (no ``clients=``) bucket by
        structure ("nets" buckets): each lane's network, client table and
        power profile are padded to the bucket's largest population and
        ride the lane (``nets=``, ``lane_clients=``, ``lane_powers=``);
        the rest bucket by their exact network ("exact" buckets).  The
        trainer gets the scenario's ``SimSpec`` backend and chunk.
        ``programs`` counts the trainers this call built (the JAX package
        counts compiled scans instead); the trainer memo and the result
        cache hit only for the same ``model``, ``clients``, ``test_data``
        and ``loss_fn`` objects.  A scenario whose ``TraceSpec`` asks for
        an update ring gets one per lane (the bucket carries its
        capacity): the result's ``traces`` hold the decoded rings, cached
        beside the logs.
        """
        from ..fl.engine import DeviceTrainer  # local: fl imports scenario
        from ..fl.models import cross_entropy_loss

        strategies = self.resolve()
        names = list(self.scenarios)
        dev = str(self.device)
        run_sig = (float(horizon_time), max_updates,
                   tuple(sorted(config_overrides.items())), dev)
        entries: dict = {}
        traces: dict = {}
        cache_hits = 0
        buckets: dict = {}
        for name in names:
            scn = self.scenarios[name]
            ckey = ("train", scn.hash(), self.seeds, run_sig)
            hit = self._result_cache.get(ckey)
            # identity-checked: a hit requires the SAME model/clients/
            # test_data objects the cached logs were trained with
            if hit is not None and hit[0] is model and hit[1] is clients \
                    and hit[2] is test_data and hit[3] is loss_fn:
                entries[name] = hit[4]
                if hit[5] is not None:
                    traces[name] = hit[5]
                cache_hits += 1
                continue
            ck = 1 if scn.sim is None else int(scn.sim.chunk)
            common = (str(None if scn.data is None else scn.data.to_dict()),
                      scn.sim_backend, ck,
                      0 if scn.trace is None else int(scn.trace.updates),
                      tuple(sorted(config_overrides.items())), dev)
            if clients is None and not scn.is_class_network:
                # DataSpec-driven scenarios bucket by STRUCTURE: the
                # network, client table and power profile ride each lane,
                # so mixed-population requests share one trainer.  The
                # config takes only law and grad clip from the spec (eta is
                # per lane); the power profile needs only its signature
                key = ("nets", scn.network.law,
                       scn.network.mu_cs is not None, _power_sig(scn),
                       scn.learning.grad_clip) + common
            else:
                key = ("exact", str(scn.network.to_dict()),
                       scn.learning.grad_clip,
                       str(None if scn.energy is None
                           else scn.energy.to_dict())) + common
            buckets.setdefault(key, []).append((name, ckey))

        programs = 0
        S = len(self.seeds)
        for key, members in buckets.items():
            lane_mode = key[0] == "nets"
            # the template scenario sizes the trainer's row count: the
            # largest population in a structural bucket, any member in an
            # exact one (all identical networks)
            ref_name = (max((nm for nm, _ in members),
                            key=lambda nm: self.scenarios[nm].n)
                        if lane_mode else members[0][0])
            scn0 = self.scenarios[ref_name]
            if clients is None:
                bucket_clients, built_test = self._client_data(scn0,
                                                               ref_name)
                bucket_test = (test_data if test_data is not None
                               else built_test)
            else:
                bucket_clients, bucket_test = clients, test_data
            # identity-checked memo: the cached trainer holds strong refs
            # to everything it was built from, and a hit requires the SAME
            # objects — never a stale trainer on a superseded test set
            cached = self._trainers.get(key)
            trainer = None
            if cached is not None and cached[0] is model \
                    and cached[1] is bucket_clients \
                    and cached[2] is bucket_test and cached[3] is loss_fn:
                trainer = cached[4]
            if trainer is None:
                net0 = scn0.params(device=self.device)
                trainer = DeviceTrainer(
                    model, bucket_clients,
                    pad_network(net0, scn0.n) if lane_mode else net0,
                    scn0.fl_config(**config_overrides),
                    test_data=bucket_test,
                    power=None if lane_mode else scn0.power(
                        device=self.device),
                    loss_fn=loss_fn or cross_entropy_loss,
                    sim_backend=scn0.sim_backend,
                    sim_chunk=1 if scn0.sim is None else scn0.sim.chunk,
                    trace_updates=(0 if scn0.trace is None
                                   else scn0.trace.updates),
                    device=self.device)
                self._trainers[key] = (model, bucket_clients, bucket_test,
                                       loss_fn, trainer)
                programs += 1
                build.runner_built("suite.train")
            n_top = trainer.n
            ps, ms, etas, seeds = [], [], [], []
            nets, lane_clients, lane_powers = [], [], []
            for name, _ in members:
                scn = self.scenarios[name]
                p, m = strategies[name]
                if lane_mode:
                    p = np.concatenate([np.asarray(p, np.float64),
                                        np.zeros(n_top - len(p))])
                    net_i = pad_network(scn.params(device=self.device),
                                        n_top)
                    cl_i, _ = self._client_data(scn, name)
                    pw_i = scn.power(device=self.device)
                    if pw_i is not None:
                        pw_i = _pad_power(pw_i, n_top)
                for s in self.seeds:
                    ps.append(p)
                    ms.append(m)
                    etas.append(scn.eta())
                    seeds.append(s)
                    if lane_mode:
                        nets.append(net_i)
                        lane_clients.append(cl_i)
                        lane_powers.append(pw_i)
            lane_kw = {}
            if lane_mode:
                lane_kw = dict(
                    nets=nets, lane_clients=lane_clients,
                    lane_powers=(None if lane_powers[0] is None
                                 else lane_powers))
            with self.metrics.timed("suite.dispatch", mode="train"):
                logs, _ = trainer.run_lanes(ps, ms, etas, seeds,
                                            float(horizon_time),
                                            max_updates=max_updates,
                                            **lane_kw)
            self.metrics.observe("suite.lanes_per_dispatch", len(ps),
                                 mode="train")
            lane_rings = trainer.last_update_rings
            for i, (name, ckey) in enumerate(members):
                entries[name] = logs[i * S:(i + 1) * S]
                if lane_rings is not None:
                    traces[name] = [decode(lane_rings[i * S + j])
                                    for j in range(S)]
                self._result_cache[ckey] = (model, clients, test_data,
                                            loss_fn, entries[name],
                                            traces.get(name))
        return SuiteResult(mode="train", entries=entries, seeds=self.seeds,
                           lanes=len(names) * S, programs=programs,
                           strategies=strategies, cache_hits=cache_hits,
                           traces=traces or None)


_ANALYZE_KEY = {"time": "tau", "round": "K_eps", "throughput": "throughput",
                "energy": "energy", "joint": "joint"}


# ---------------------------------------------------------------------------
# lane stacking / the analyze bucket evaluation
# ---------------------------------------------------------------------------

def _power_sig(scn) -> Optional[bool]:
    """Structural signature of a scenario's power profile for bucketing:
    ``None`` (no energy spec) or whether the CS power term is present."""
    if scn.energy is None:
        return None
    return scn.energy.P_cs is not None


def _pad_power(power: PowerProfile, n_max: int) -> PowerProfile:
    """Pad a power profile to ``n_max`` client rows with zero powers —
    padded clients are never busy, so they contribute exactly 0 energy."""
    def pad(x):
        return torch.cat([x, torch.zeros(n_max - x.shape[0], dtype=x.dtype,
                                          device=x.device)])

    return power._replace(P_c=pad(power.P_c), P_u=pad(power.P_u),
                          P_d=pad(power.P_d))


def _stack_consts(consts_list, device) -> LearningConstants:
    return LearningConstants(*[
        torch.as_tensor([float(getattr(c, f)) for c in consts_list],
                        dtype=DTYPE, device=device)
        for f in LearningConstants._fields])


def _build_analyze(m_max: int, has_power: bool, is_classes: bool):
    """The closed-form evaluation of one analyze bucket:
    ``fn(prm, m, consts, power, rho)`` over lane-stacked networks (``[L,
    n]`` leaves, or :class:`ClassParams` with ``[L, C]`` leaves), ``m
    [L]``, constants and ``rho`` ``[L]`` — one Buzen DP call for all lanes
    (kernel 1 or 5 on ``"kernel"``), then the padded or class forms.  A
    class row's ``delays`` are per CLASS (one member of each); the class
    path never materializes a per-client array, so n = 10^6 costs what n =
    10 does at equal class counts."""
    if is_classes:
        lognc, delay_f = (class_log_normalizing_constants,
                          expected_relative_delay_classes)
        k_eps_f, energy_f = round_complexity_classes, energy_complexity_classes
    else:
        lognc, delay_f = (log_normalizing_constants,
                          expected_relative_delay_padded)
        k_eps_f, energy_f = round_complexity_padded, energy_complexity_padded

    def analyze_lanes(prm, m, consts, power, rho):
        logZ = lognc(prm, m_max)
        thr = throughput_padded(logZ, m)
        k_eps = k_eps_f(prm, m, consts, logZ, m_max)
        tau = k_eps / thr
        out = {"throughput": thr, "K_eps": k_eps, "tau": tau,
               "delays": delay_f(prm, m, logZ, m_max)}
        if has_power:
            en = energy_f(prm, m, consts, power, logZ, m_max)
            out["energy"] = en
            out["joint"] = rho * en + (1.0 - rho) * tau
        return out

    return analyze_lanes
