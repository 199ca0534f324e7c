"""``python -m repro_torch.obs`` — telemetry smoke traces and drift gating
(port of ``python -m repro.obs``).

Verbs::

    python -m repro_torch.obs smoke --out TRACE_smoke.json [--device cpu]
        Run the canonical traced smoke scenario (event engine + rings) on
        the card (``--device cuda``, the default) or the CPU, and export
        the simulated-timeline Perfetto trace with the drift report, the
        closed-form predictions AND the raw decoded ring embedded in
        ``metadata`` — the file is self-checking.

    python -m repro_torch.obs check TRACE_smoke.json
        Re-verify an exported trace: validate the event schema, re-run the
        drift comparison from the embedded ring + predictions (never
        trusting the stored verdict), exit 1 on any breach.

    python -m repro_torch.obs report TRACE_smoke.json
        Human-readable summary of the same file.

The file's layout is the JAX package's, so either package's ``check``
reads the other's ``smoke`` export.  Its compile track holds the CUDA
kernels' builds of the run (none on the CPU or when the libraries were
built before).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_REQUIRED_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid", "args")


def _smoke(args) -> int:
    from ..analysis import tracecheck
    from ..scenario import (NetworkSpec, Scenario, ScenarioSuite, SimSpec,
                            TraceSpec)
    from .drift import predict
    from .trace import perfetto_trace

    rng = np.random.default_rng(0)
    n = 4
    net = NetworkSpec(mu_c=(0.8 + 0.4 * rng.random(n)).tolist(),
                      mu_d=[4.0] * n, mu_u=[4.0] * n)
    scn = Scenario(network=net, name="obs_smoke",
                   sim=SimSpec(trace=TraceSpec(events=args.events,
                                               tolerance=args.tolerance)))
    suite = ScenarioSuite({"obs_smoke": scn}, seeds=tuple(range(args.seeds)),
                          device=args.device)
    with tracecheck.watch() as watch:
        res = suite.run(mode="simulate", num_updates=args.updates,
                        warmup=args.warmup)
    decoded = res.traces["obs_smoke"][0]  # seed 0 carries the timeline
    reports = res.drift["obs_smoke"]
    p, m = res.strategies["obs_smoke"]
    preds = predict(scn.params(p, device=args.device), m)
    ring_data = {k: (v.tolist() if isinstance(v, np.ndarray) else int(v))
                 for k, v in decoded.items()}
    doc = perfetto_trace(
        decoded, scn.n, name="obs_smoke",
        host_spans=suite.metrics.spans(),
        compile_spans=watch.spans,
        metadata={"scenario": scn.to_dict(), "seeds": list(suite.seeds),
                  "law": scn.network.law, "tolerance": args.tolerance,
                  "predictions": preds, "drift": reports,
                  "ring_data": ring_data})
    out = json.dumps(doc, indent=None, separators=(",", ":"))
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"wrote {args.out}: {len(doc['traceEvents'])} events, "
              f"{len(out)} bytes")
    else:
        print(out)
    _print_reports(reports)
    return 0 if all(r["ok"] for r in reports) else 1


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _schema_errors(doc: dict) -> list:
    errs = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return [f"traceEvents missing or empty ({type(events).__name__})"]
    for i, ev in enumerate(events):
        missing = [k for k in _REQUIRED_EVENT_KEYS if k not in ev]
        if missing:
            errs.append(f"event {i} missing keys {missing}")
        if len(errs) >= 5:
            break
    return errs


def _recheck(doc: dict) -> dict:
    """Drift re-verification from the embedded ring (see module doc)."""
    from .drift import drift_report

    meta = doc.get("metadata", {})
    ring = meta.get("ring_data")
    preds = meta.get("predictions")
    if not ring or not preds:
        raise SystemExit("trace file has no embedded ring_data/predictions "
                         "(not a `repro_torch.obs smoke` export?)")
    decoded = {k: (np.asarray(v) if isinstance(v, list) else v)
               for k, v in ring.items()}
    return drift_report(decoded, predictions=preds,
                        law=meta.get("law", "exponential"),
                        tolerance=meta.get("tolerance", 0.25))


def _print_reports(reports) -> None:
    for i, rep in enumerate(reports):
        print(f"drift[{i}] law={rep['law']} ok={rep['ok']}")
        for c in rep["checks"]:
            flag = "ok" if c["ok"] else "DRIFT"
            print(f"  {c['metric']:11s} empirical={c['empirical']:10.4f} "
                  f"predicted={c['predicted']:10.4f} "
                  f"rel_err={c['rel_err']:8.3%} tol={c['tol']:.0%} [{flag}]")


def _check(args) -> int:
    doc = _load(args.path)
    errs = _schema_errors(doc)
    if errs:
        for e in errs:
            print(f"schema: {e}", file=sys.stderr)
        return 1
    rep = _recheck(doc)
    _print_reports([rep])
    stored = doc.get("metadata", {}).get("drift") or []
    bad = [r for r in stored if not r.get("ok")]
    if bad:
        print(f"{len(bad)} stored drift report(s) flag breaches",
              file=sys.stderr)
    return 0 if rep["ok"] and not bad else 1


def _report(args) -> int:
    doc = _load(args.path)
    meta = doc.get("metadata", {})
    events = doc.get("traceEvents", [])
    by_ph: dict = {}
    for ev in events:
        by_ph[ev.get("ph", "?")] = by_ph.get(ev.get("ph", "?"), 0) + 1
    ring = meta.get("ring", {})
    print(f"{args.path}: {len(events)} events "
          f"({', '.join(f'{k}={v}' for k, v in sorted(by_ph.items()))})")
    print(f"ring: count={ring.get('count')} capacity={ring.get('capacity')} "
          f"dropped={ring.get('dropped')}  n={meta.get('n')}")
    _print_reports(meta.get("drift") or [])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="telemetry smoke traces and closed-form drift gating")
    sub = ap.add_subparsers(dest="verb", required=True)
    sm = sub.add_parser("smoke", help="run + export the traced smoke scenario")
    sm.add_argument("--out", default=None, help="output JSON path")
    sm.add_argument("--updates", type=int, default=2000)
    sm.add_argument("--warmup", type=int, default=200)
    sm.add_argument("--events", type=int, default=16384)
    sm.add_argument("--seeds", type=int, default=2)
    sm.add_argument("--tolerance", type=float, default=0.25)
    sm.add_argument("--device", default="cuda",
                    help="where the suite runs (default: the card)")
    sm.set_defaults(fn=_smoke)
    ck = sub.add_parser("check", help="re-verify an exported trace; exit 1 "
                                      "on schema error or drift breach")
    ck.add_argument("path")
    ck.set_defaults(fn=_check)
    rp = sub.add_parser("report", help="summarize an exported trace")
    rp.add_argument("path")
    rp.set_defaults(fn=_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
