"""Program audit — ops, float64, downcasts, host syncs and kernel launches
of every resident program as a JSON report (port of
``repro.analysis.audit``).

The JAX package builds the jaxpr of each resident program and walks it.
Eager PyTorch has no program to walk, so the port runs each one instead:
once to warm it (libraries loaded, memos filled), then once more under a
recorder, a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that sees every aten op the run dispatches, at the JAX audit's tiny
static sizes (``L, n_max, m_max = 2, 3, 3``).  Eager execution repeats a
loop body, so trip counts come for free.  Per program the report holds:

  * ``total_ops``, ``op_counts`` (by overload-packet name) and a rough
    ``flops_estimate`` (the JAX rule: products ``2 * out * contract``,
    reductions their input size, elementwise ops their output size);
  * ``f64``: ops with a float64 output, with examples located at the
    first ``repro_torch`` frame of the stack;
  * ``downcasts_f64_to_f32``: float64 -> narrower float copies (clock
    truncation candidates);
  * ``host_syncs``: ``_local_scalar_dense`` (``.item()``, ``bool(t)``,
    ``int(t)``, ``float(t)``), ``nonzero``, ``masked_select``, ``equal``,
    boolean-mask ``index`` and copies from the card to the host.  These
    replace the JAX audit's host callbacks, and they are where the JAX
    linter's ``numpy-in-jit`` and ``traced-branch`` rules went: in eager
    code a host value pulled out of a device computation is a sync.  On
    the CPU a ``.tolist()``/``.cpu()``/``.numpy()`` dispatches nothing, so
    only the card's count is complete;
  * ``launches``: the hand-written kernels' launches, from the wrappers'
    counters (``repro_torch.kernels.build.launch_totals``): their
    ``ctypes`` calls bypass the dispatcher;
  * ``graph_capturable`` and ``graph_blockers``: a program with a host
    sync cannot be captured as one CUDA graph (``"host-syncs"``).  The
    card runs float64, so f64 is reported but blocks nothing.

The JAX audit's ``unbounded_loops`` (``while`` primitives, whose trip
count a jaxpr does not know) has no counterpart: a recorded run executes
every iteration, so each loop's trip count is in the counts.

``python -m repro_torch.analysis audit --out AUDIT_torch.json`` writes the
report; ``--device`` defaults to ``cuda`` and raises without a card (no
CPU fallback); ``--device cpu`` runs the kernel wrappers' plain
versions, as everywhere in the port.  The schema is pinned by
``tests/data/audit_torch_schema.json``.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Callable, Optional

SCHEMA_VERSION = 1

# elementwise ops: flops ~= output size
_ELEMENTWISE = frozenset(
    {"add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow", "neg",
     "abs", "sign", "floor", "ceil", "round", "trunc", "exp", "exp2", "log",
     "log2", "log1p", "expm1", "sqrt", "rsqrt", "tanh", "sigmoid", "erf",
     "erfinv", "sin", "cos", "tan", "atan2", "maximum", "minimum", "clamp",
     "clamp_min", "clamp_max", "where", "logical_and", "logical_or",
     "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
     "bitwise_xor", "bitwise_not", "nextafter", "square", "reciprocal"})
# reductions and scans: flops ~= input size
_REDUCE = frozenset(
    {"sum", "amax", "amin", "max", "min", "prod", "all", "any", "argmax",
     "argmin", "cumsum", "logcumsumexp", "cummax", "cummin", "cumprod",
     "logsumexp", "mean"})
# products: 2 * output size * contracted length (the first operand's last
# axis, after the bias of the add- forms)
_PRODUCTS = {"mm": 0, "bmm": 0, "matmul": 0, "mv": 0, "dot": 0,
             "addmm": 1, "addmv": 1, "baddbmm": 1, "addbmm": 1}
# ops that hand a device value to the host
_SYNC_OPS = frozenset(
    {"_local_scalar_dense", "nonzero", "masked_select", "equal"})
_COPY_OPS = frozenset({"_to_copy", "copy_"})
_EXAMPLES = 8


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]  # in argument order
    return []


def _flops(name: str, args, outs) -> float:
    out_size = sum(t.numel() for t in outs)
    if name in _PRODUCTS:
        ins = _tensors(args)
        i = _PRODUCTS[name]
        if len(ins) > i and ins[i].dim() >= 1:
            return 2.0 * out_size * ins[i].shape[-1]
        return 0.0
    if name in _REDUCE:
        return float(sum(t.numel() for t in _tensors(args)))
    if name in _ELEMENTWISE:
        return float(out_size)
    return 0.0


def _source_line() -> Optional[str]:
    """``path:line (function)`` of the innermost frame of the port outside
    this analysis package, else ``None``."""
    here = os.path.dirname(os.path.abspath(__file__))
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if "repro_torch" in path and not path.startswith(here):
            short = path[path.rindex("repro_torch"):]
            return f"{short}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return None


def _is_host_sync(name: str, args, outs) -> bool:
    import torch

    if name in _SYNC_OPS:
        return True
    if name == "index":
        idx = args[1] if len(args) > 1 else ()
        return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in (idx or ()))
    if name in _COPY_OPS:
        ins = [t for t in _tensors(args) if t.device.type != "cpu"]
        if name == "copy_":
            dst = args[0]
            return dst.device.type == "cpu" and bool(ins)
        return bool(ins) and any(t.device.type == "cpu" for t in outs)
    return False


def _downcast(name: str, args, outs) -> Optional[str]:
    import torch

    if name not in _COPY_OPS or not outs:
        return None
    src = args[1] if name == "copy_" else args[0]
    dst = args[0] if name == "copy_" else outs[0]
    if (isinstance(src, torch.Tensor) and src.dtype == torch.float64
            and dst.dtype.is_floating_point and dst.dtype.itemsize < 8):
        return f"f64->{str(dst.dtype).replace('torch.', '')}"
    return None


class _Recorder:
    """The dispatch recorder: one instance per recorded run."""

    def __init__(self):
        self.op_counts: dict[str, int] = {}
        self.f64_counts: dict[str, int] = {}
        self.f64_examples: list[str] = []
        self.downcasts = 0
        self.downcast_examples: list[str] = []
        self.syncs: dict[str, int] = {}
        self.flops = 0.0
        self.total = 0

    def see(self, func, args, out) -> None:
        import torch

        name = func.overloadpacket.__name__
        outs = _tensors(out)
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        self.total += 1
        self.flops += _flops(name, args, outs)
        if any(t.dtype == torch.float64 for t in outs):
            self.f64_counts[name] = self.f64_counts.get(name, 0) + 1
            if len(self.f64_examples) < _EXAMPLES:
                src = _source_line()
                self.f64_examples.append(f"{name} @ {src}" if src else name)
        cast = _downcast(name, args, outs)
        if cast is not None:
            self.downcasts += 1
            if len(self.downcast_examples) < _EXAMPLES:
                src = _source_line()
                self.downcast_examples.append(
                    f"{cast} @ {src}" if src else cast)
        if _is_host_sync(name, args, outs):
            self.syncs[name] = self.syncs.get(name, 0) + 1

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                rec.see(func, args, out)
                return out

        return _Mode()


def analyze_ops(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the recorder; return the
    findings dict (the counterpart of ``analyze_jaxpr``).  The kernels'
    launches in the run come from their wrappers' counters."""
    from ..kernels import build

    rec = _Recorder()
    before = build.launch_totals()
    with rec.mode():
        fn(*args, **kwargs)
    launches = {k: v - before.get(k, 0)
                for k, v in sorted(build.launch_totals().items())
                if v != before.get(k, 0)}
    sync_total = sum(rec.syncs.values())
    blockers = ["host-syncs"] if sync_total else []
    return {
        "total_ops": rec.total,
        "op_counts": dict(sorted(rec.op_counts.items())),
        "flops_estimate": rec.flops,
        "f64": {"count": sum(rec.f64_counts.values()),
                "op_counts": dict(sorted(rec.f64_counts.items())),
                "examples": rec.f64_examples},
        "downcasts_f64_to_f32": {"count": rec.downcasts,
                                 "examples": rec.downcast_examples},
        "host_syncs": {"count": sync_total,
                       "ops": dict(sorted(rec.syncs.items()))},
        "launches": launches,
        "graph_capturable": not blockers,
        "graph_blockers": blockers,
    }


# ---------------------------------------------------------------------------
# resident programs, built at tiny static sizes
# ---------------------------------------------------------------------------

def _t(x, device, dtype=None):
    import numpy as np
    import torch

    from ..core.numerics import DTYPE

    return torch.as_tensor(np.asarray(x), dtype=dtype or DTYPE,
                           device=device)


def _tiny_nets(device, L: int = 2, n_max: int = 3, cs: bool = False):
    import numpy as np

    from ..core.buzen import NetworkParams, pad_network
    from ..core.events import stack_lanes

    rng = np.random.default_rng(7)
    nets = []
    for i in range(L):
        n = n_max - (i % 2)  # mixed populations exercise the padding path
        net = NetworkParams(
            p=_t(rng.dirichlet(np.ones(n)), device),
            mu_c=_t(rng.uniform(0.5, 4.0, n), device),
            mu_d=_t(rng.uniform(0.5, 4.0, n), device),
            mu_u=_t(rng.uniform(0.5, 4.0, n), device))
        if cs:
            net = net.with_cs(rng.uniform(0.5, 4.0))
        nets.append(pad_network(net, n_max))
    return stack_lanes(nets)


def _tiny_classes(device, L: int = 2, c_max: int = 3):
    import numpy as np
    import torch

    from ..core.buzen import ClassParams, pad_classes
    from ..core.events import stack_lanes

    rng = np.random.default_rng(11)
    lanes = []
    for i in range(L):
        C = c_max - (i % 2)  # mixed class counts exercise pad_classes
        cnt = rng.integers(1, 4, C)
        cls = ClassParams(
            p=_t(rng.dirichlet(np.ones(C)) / cnt, device),
            mu_c=_t(rng.uniform(0.5, 4.0, C), device),
            mu_d=_t(rng.uniform(2.0, 6.0, C), device),
            mu_u=_t(rng.uniform(2.0, 6.0, C), device),
            count=_t(cnt, device, torch.int64))
        lanes.append(pad_classes(cls, c_max))
    return stack_lanes(lanes)


def resident_programs() -> dict[str, tuple[str, Callable]]:
    """name -> (description, builder); ``builder(device)`` prepares the
    inputs and returns the zero-argument run the recorder executes.

    Every resident program of the pipeline: the suite's analyze and
    simulate bucket runners (``batched`` / ``kernel`` / ``sharded`` / the
    per-lane ``reference`` loop), the trainer's lane loop, and the
    hand-written kernels' wrappers (their plain versions on the CPU).
    The names are the JAX package's, its ``pallas`` read as ``kernel``.
    """
    import numpy as np

    L, n_max, m_max = 2, 3, 3

    def suite_analyze(device):
        import torch

        from ..core.complexity import LearningConstants
        from ..core.energy import PowerProfile
        from ..core.events import stack_lanes
        from ..scenario.suite import (_build_analyze, _pad_power,
                                      _stack_consts)

        prm = _tiny_nets(device, L, n_max)
        consts = _stack_consts([LearningConstants(M=2.0, G=5.0)] * L,
                               device)
        power = stack_lanes([
            _pad_power(PowerProfile(
                P_c=_t(np.full(n_max - (i % 2), 1.5), device),
                P_u=_t(np.full(n_max - (i % 2), 1.0), device),
                P_d=_t(np.full(n_max - (i % 2), 0.5), device)), n_max)
            for i in range(L)])
        m_vec = torch.as_tensor([2, 3], dtype=torch.int64, device=device)
        rho = _t([0.3, 0.5], device)
        fn = _build_analyze(m_max, True, False)
        return lambda: fn(prm, m_vec, consts, power, rho)

    def _sim_args(device):
        import torch

        from ..core import prng

        prm = _tiny_nets(device, L, n_max)
        m_vec = torch.as_tensor([2, 3], dtype=torch.int32, device=device)
        keys = prng.seed_keys(range(L), device=device)
        return prm, m_vec, keys

    def lanes_run(backend, chunk=1, trace_events=0):
        def builder(device):
            from ..sim.batched_events import build_lanes_fn

            fn = build_lanes_fn(backend, 6, 2, "exponential", m_max, False,
                                trace_events=trace_events, chunk=chunk)
            prm, m_vec, keys = _sim_args(device)
            return lambda: fn(prm, m_vec, keys, None)

        return builder

    def suite_simulate_sharded(device):
        from ..sim.sharded import build_sharded_lanes_fn

        fn = build_sharded_lanes_fn(6, 2, "exponential", m_max, False)
        prm, m_vec, keys = _sim_args(device)
        return lambda: fn(prm, m_vec, keys, None)

    def simulate_reference_lane(device):
        from ..core.events import lane, simulate_stats

        prm, m_vec, keys = _sim_args(device)
        one = lane(prm, 0)
        return lambda: simulate_stats(one, int(m_vec[0]), 6, warmup=2,
                                      key=keys[0], m_max=m_max,
                                      backend="reference")

    def _trainer(device, trace_updates=0):
        from ..core.buzen import NetworkParams
        from ..fl.engine import DeviceTrainer
        from ..fl.models import mlp_classifier
        from ..fl.trainer import AsyncFLConfig

        rng = np.random.default_rng(9)
        n = 3
        net = NetworkParams(
            p=_t(rng.dirichlet(np.ones(n)), device),
            mu_c=_t(rng.uniform(0.5, 4.0, n), device),
            mu_d=_t(rng.uniform(0.5, 4.0, n), device),
            mu_u=_t(rng.uniform(0.5, 4.0, n), device))
        clients = [(rng.normal(size=(4, 4)).astype(np.float32),
                    rng.integers(0, 2, size=4).astype(np.int32))
                   for _ in range(n)]
        test = (rng.normal(size=(6, 4)).astype(np.float32),
                rng.integers(0, 2, size=6).astype(np.int32))
        model = mlp_classifier(4, 2, hidden=(4,), device=device)
        trainer = DeviceTrainer(
            model, clients, net,
            AsyncFLConfig(eta=0.05, batch_size=2, eval_every_time=2.0,
                          eval_batch=6),
            test_data=test, sim_backend="batched",
            trace_updates=trace_updates, device=device)
        p = net.p.detach().cpu().numpy()
        return trainer, [p] * L

    def trainer_scan(device):
        trainer, ps = _trainer(device)
        return lambda: trainer.run_lanes(ps, [2] * L, [0.05] * L,
                                         list(range(L)), 6.0, max_updates=4)

    def trainer_scan_traced(device):
        trainer, ps = _trainer(device, trace_updates=8)
        return lambda: trainer.run_lanes(ps, [2] * L, [0.05] * L,
                                         list(range(L)), 6.0, max_updates=4)

    def trainer_scan_lane_nets(device):
        from ..core.buzen import NetworkParams, pad_network
        from ..fl.engine import DeviceTrainer
        from ..fl.models import mlp_classifier
        from ..fl.trainer import AsyncFLConfig

        rng = np.random.default_rng(9)
        n_top = 3

        def mk_net(n):
            return NetworkParams(
                p=_t(rng.dirichlet(np.ones(n)), device),
                mu_c=_t(rng.uniform(0.5, 4.0, n), device),
                mu_d=_t(rng.uniform(0.5, 4.0, n), device),
                mu_u=_t(rng.uniform(0.5, 4.0, n), device))

        def mk_clients(n, s):
            return [(rng.normal(size=(s, 4)).astype(np.float32),
                     rng.integers(0, 2, size=s).astype(np.int32))
                    for _ in range(n)]

        test = (rng.normal(size=(6, 4)).astype(np.float32),
                rng.integers(0, 2, size=6).astype(np.int32))
        model = mlp_classifier(4, 2, hidden=(4,), device=device)
        trainer = DeviceTrainer(
            model, mk_clients(n_top, 4), mk_net(n_top),
            AsyncFLConfig(eta=0.05, batch_size=2, eval_every_time=2.0,
                          eval_batch=6),
            test_data=test, sim_backend="batched", device=device)
        # mixed populations: lane 1 is a 2-client net padded to n_top
        sizes_n = [n_top, n_top - 1]
        raw = [mk_net(n) for n in sizes_n]
        nets = [pad_network(net, n_top) for net in raw]
        clients = [mk_clients(n, 3 + n % 2) for n in sizes_n]
        ps = [np.pad(net.p.detach().cpu().numpy(), (0, n_top - net.n))
              for net in raw]
        return lambda: trainer.run_lanes(
            ps, [2] * L, [0.05] * L, list(range(L)), 6.0, max_updates=4,
            nets=nets, lane_clients=clients)

    def suite_analyze_classes(device):
        import torch

        from ..core.complexity import LearningConstants
        from ..scenario.suite import _build_analyze, _stack_consts

        cls = _tiny_classes(device, L, n_max)
        consts = _stack_consts([LearningConstants(M=2.0, G=5.0)] * L,
                               device)
        m_vec = torch.as_tensor([2, 3], dtype=torch.int64, device=device)
        rho = _t([0.3, 0.5], device)
        fn = _build_analyze(m_max, False, True)
        return lambda: fn(cls, m_vec, consts, None, rho)

    def suite_simulate_classes(device):
        import torch

        from ..core import prng
        from ..sim.batched_events import build_class_lanes_fn

        fn = build_class_lanes_fn("batched", 6, 2, "exponential", m_max,
                                  False)
        cls = _tiny_classes(device, L, n_max)
        m_vec = torch.as_tensor([2, 3], dtype=torch.int32, device=device)
        keys = prng.seed_keys(range(L), device=device)
        return lambda: fn(cls, m_vec, keys, None)

    def kernel_buzen(device):
        import torch

        from ..kernels.buzen import buzen_batched

        rng = np.random.default_rng(3)
        log_rho = _t(rng.normal(size=(L, 3 * n_max)), device, torch.float32)
        log_gamma = _t(rng.normal(size=(L,)), device, torch.float32)
        return lambda: buzen_batched(log_rho, log_gamma, m_max)

    def kernel_buzen_classes(device):
        import torch

        from ..kernels.buzen import buzen_classes_batched

        rng = np.random.default_rng(5)
        log_rho = _t(rng.normal(size=(L, n_max)), device)
        counts = _t(rng.integers(1, 4, size=(L, n_max)), device,
                    torch.int64)
        log_gamma = _t(rng.normal(size=(L,)), device)
        return lambda: buzen_classes_batched(log_rho, counts, log_gamma,
                                             m_max)

    def _event_inputs(device, chunk):
        from ..core.events import (EventStream, event_key, init_state, lane,
                                   stack_lanes)

        prm, m_vec, keys = _sim_args(device)
        singles = [lane(prm, i) for i in range(L)]
        st = stack_lanes([
            init_state(p, int(m), k, m_max=m_max,
                       distribution="exponential", warmup=0, cap=8)
            for p, m, k in zip(singles, m_vec.tolist(), keys)])
        stream = EventStream(singles, event_key(keys),
                             distribution="exponential")
        fs, cn, _ = stream.window(chunk)
        return prm, st, fs, cn

    def kernel_events(device):
        from ..kernels.events import event_step_lanes

        prm, st, fs, cn = _event_inputs(device, 1)
        return lambda: event_step_lanes(prm, st, fs[:, 0], cn[:, 0])

    def kernel_events_megastep(device):
        from ..kernels.events import megastep_lanes

        prm, st, fs, cn = _event_inputs(device, 2)
        return lambda: megastep_lanes(prm, st, fs, cn, 2)

    return {
        "suite_analyze": (
            "ScenarioSuite analyze bucket: the padded closed forms over "
            "lane-stacked networks (energy column on)", suite_analyze),
        "suite_simulate_batched": (
            "ScenarioSuite simulate bucket, batched backend: the lock-step "
            "lane loop of plain PyTorch transitions",
            lanes_run("batched")),
        "suite_simulate_batched_traced": (
            "ScenarioSuite simulate bucket with the event telemetry ring "
            "(repro_torch.obs)", lanes_run("batched", trace_events=8)),
        "suite_simulate_kernel": (
            "ScenarioSuite simulate bucket, kernel backend: the lock-step "
            "lane loop around the event lane kernel (one launch an event)",
            lanes_run("kernel")),
        "suite_simulate_batched_megastep": (
            "ScenarioSuite simulate bucket, batched backend, chunk=2 "
            "megastep (bitwise equal to the single-step run)",
            lanes_run("batched", chunk=2)),
        "suite_simulate_kernel_megastep": (
            "ScenarioSuite simulate bucket, kernel backend, chunk=2 "
            "megastep: one lane-kernel launch retires up to 2 events",
            lanes_run("kernel", chunk=2)),
        "suite_analyze_classes": (
            "ScenarioSuite analyze bucket, class networks: the O(#classes) "
            "class closed forms", suite_analyze_classes),
        "suite_simulate_classes": (
            "ScenarioSuite simulate bucket, class networks: the "
            "class-aggregated lane loop", suite_simulate_classes),
        "suite_simulate_sharded": (
            "ScenarioSuite simulate bucket, sharded backend: the lanes "
            "split over the local devices (one device: batched itself)",
            suite_simulate_sharded),
        "simulate_reference_lane": (
            "reference backend per-lane run: simulate_stats of one lane",
            simulate_reference_lane),
        "trainer_scan": (
            "DeviceTrainer lane loop (suite train bucket): "
            "DeviceTrainer.run_lanes through run_streams, the fused update "
            "kernel applying each round", trainer_scan),
        "trainer_scan_traced": (
            "DeviceTrainer lane loop with the update telemetry ring "
            "(repro_torch.obs)", trainer_scan_traced),
        "trainer_scan_lane_nets": (
            "DeviceTrainer lane-mode loop (serve mixed-n train bucket): a "
            "network and a padded client table per lane",
            trainer_scan_lane_nets),
        "kernel_buzen": (
            "Buzen DP kernel wrapper (kernels.buzen.buzen_batched)",
            kernel_buzen),
        "kernel_buzen_classes": (
            "class-space Buzen DP kernel wrapper "
            "(kernels.buzen.buzen_classes_batched)", kernel_buzen_classes),
        "kernel_events": (
            "event lane kernel wrapper, one event "
            "(kernels.events.event_step_lanes)", kernel_events),
        "kernel_events_megastep": (
            "event lane kernel wrapper, chunk=2 "
            "(kernels.events.megastep_lanes)", kernel_events_megastep),
    }


def _device(device):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "audit on cuda needs a CUDA device and none is available; "
            "pass --device cpu to audit the plain versions")
    return dev


def build_report(names=None, device="cuda") -> dict:
    """The full audit report (optionally restricted to ``names``), every
    program run on ``device`` (default the card; raises without one)."""
    import platform

    import torch

    dev = _device(device)
    programs = {}
    registry = resident_programs()
    if names:
        registry = {k: registry[k] for k in names}
    for name, (description, builder) in registry.items():
        run = builder(dev)
        run()  # warm: libraries loaded, memos filled
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        entry = {"description": description}
        entry.update(analyze_ops(run))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        programs[name] = entry
    return {
        "schema": {"name": "repro_torch.analysis.audit",
                   "version": SCHEMA_VERSION},
        "torch_version": torch.__version__,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda"
                        else platform.machine() or "cpu"),
        "programs": programs,
        "summary": {
            "programs": len(programs),
            "capturable": sorted(k for k, v in programs.items()
                                 if v["graph_capturable"]),
            "blocked": sorted(k for k, v in programs.items()
                              if not v["graph_capturable"]),
        },
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis audit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--programs", default=None,
                    help="comma-separated subset of resident programs")
    ap.add_argument("--device", default="cuda",
                    help="device to run the programs on (default cuda; "
                         "raises without a card)")
    args = ap.parse_args(argv)
    names = ([s.strip() for s in args.programs.split(",") if s.strip()]
             if args.programs else None)
    report = build_report(names, device=args.device)
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        blocked = report["summary"]["blocked"]
        print(f"audit: {report['summary']['programs']} programs on "
              f"{report['device']} -> {args.out} ({len(blocked)} with host "
              f"syncs: {blocked})")
    else:
        print(text)
    return 0 if report["programs"] else 1


if __name__ == "__main__":
    sys.exit(main())
