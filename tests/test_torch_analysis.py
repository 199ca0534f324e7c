"""The port's analysis gates (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

  * contract linter: the same snippets, written once for each package,
    give the same ``(line, rule)`` pairs under both linters (raw
    reductions in marked and unmarked modules, categorical routing,
    stringly dispatch, module-scope environment reads, the suppression
    grammar); the port's own ``jax-import`` rule; the repo lints clean,
    every suppression is justified, the port marks exactly the JAX
    package's modules and the hardcoded registry names are the port's;
  * hygiene: no generated file tracked, the port's output directories
    and the ``hypothesis`` database forbidden, no git → nothing tracked;
  * sentinel: the mixed-population suite of ``tests/test_analysis.py``
    built with ``repro_torch.scenario`` keeps the JAX suite's
    ``programs`` and a budget of 2 runners, and the per-scenario
    re-planning mutation trips it; a cached repeat builds nothing;
  * audit: the resident programs are the JAX package's 17 (``pallas``
    read as ``kernel``), a two-program report matches
    ``tests/data/audit_torch_schema.json`` and agrees with JAX's on which
    program carries float64, and a host sync blocks graph capture.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro_torch.analysis import hygiene, lint

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"


@pytest.fixture
def tracecheck():
    """The build and launch sentinel (``repro_torch.analysis.tracecheck``),
    per test."""
    from repro_torch.analysis import tracecheck as tc

    return tc


def _pairs(violations, suppressed=None):
    return sorted((v.line, v.rule) for v in violations
                  if suppressed is None or v.suppressed == suppressed)


# ---------------------------------------------------------------------------
# linter: the same snippets under both packages
# ---------------------------------------------------------------------------

# (case, JAX snippet, torch snippet, marked, the (line, rule) pairs)
LINT_CASES = [
    ("raw-reduction-marked",
     "import jax.numpy as jnp\ntotal = jnp.sum(x)\n",
     "import torch\ntotal = torch.sum(x)\n",
     True, [(2, "raw-reduction")]),
    ("raw-reduction-unmarked",
     "import jax.numpy as jnp\ntotal = jnp.sum(x)\n",
     "import torch\ntotal = torch.sum(x)\n",
     False, []),
    ("raw-reduction-methods-and-cumsum",
     "a = x.sum()\nb = jnp.cumsum(y)\nc = arr.cumsum(axis=0)\n",
     "a = x.sum()\nb = torch.cumsum(y, 0)\nc = arr.cumsum(dim=0)\n",
     True, [(1, "raw-reduction"), (2, "raw-reduction"),
            (3, "raw-reduction")]),
    ("raw-reduction-logsumexp",
     "from jax.scipy.special import logsumexp\na = logsumexp(x)\n"
     "b = jax.nn.logsumexp(y)\nc = z.logsumexp()\n",
     "import torch\na = torch.logsumexp(x, -1)\n"
     "b = torch.special.logsumexp(y, 0)\nc = z.logsumexp(-1)\n",
     True, [(2, "raw-reduction"), (3, "raw-reduction"),
            (4, "raw-reduction")]),
    ("raw-reduction-numpy",
     "y = np.sum(x)\nz = numpy.cumsum(x)\n",
     "y = np.sum(x)\nz = numpy.cumsum(x)\n",
     True, [(1, "raw-reduction"), (2, "raw-reduction")]),
    ("raw-reduction-seqsum-passes",
     "from repro.core.numerics import seqsum\ntotal = seqsum(x)\n",
     "from repro_torch.core.numerics import seqsum\ntotal = seqsum(x)\n",
     True, []),
    ("marker-autodetected",
     "# contract: padded-n — client-axis reductions live here\n"
     "import jax.numpy as jnp\ntotal = jnp.sum(x)\n",
     "# contract: padded-n — client-axis reductions live here\n"
     "import torch\ntotal = torch.sum(x)\n",
     None, [(3, "raw-reduction")]),
    ("categorical-routing",
     "i = jax.random.categorical(key, logits)\n",
     "i = torch.multinomial(probs, 1)\n",
     False, [(1, "categorical-routing")]),
    ("categorical-routing-imported",
     "from jax.random import categorical\ni = categorical(k, lg)\n",
     "from torch.distributions import Categorical\n"
     "i = Categorical(probs=p).sample()\n",
     None, [(2, "categorical-routing")]),
    ("categorical-routing-method",
     "x = 1\ni = jax.random.categorical(k, lg)\n",
     "x = 1\ni = probs.multinomial(1)\n",
     None, [(2, "categorical-routing")]),
    ("categorical-routing-dotted",
     "i = jax.random.categorical(k, lg)\n",
     "i = torch.distributions.Categorical(logits=lg)\n",
     None, [(1, "categorical-routing")]),
    ("categorical-other-modules-pass",
     "x = pd.categorical(s)\n",
     "x = pd.Categorical(s)\n",
     None, []),
    ("stringly-dispatch-chain",
     'def f(law):\n    if law == "exponential":\n        return 1\n'
     '    elif law == "lognormal":\n        return 2\n',
     None, None, [(2, "stringly-dispatch")]),
    ("stringly-dispatch-membership",
     'def f(s):\n    if s in ("energy_opt", "joint"):\n        return 1\n',
     None, None, [(2, "stringly-dispatch")]),
    ("stringly-dispatch-table",
     'FNS = {"exponential": draw_e, "deterministic": draw_d}\n',
     None, None, [(1, "stringly-dispatch")]),
    ("stringly-dispatch-other-strings-pass",
     'def f(mode):\n    if mode == "fast":\n        return 1\n'
     '    elif mode == "slow":\n        return 2\n'
     'def g(law):\n    if law == "exponential":\n        return 1\n',
     None, None, []),
    ("env-read-module-scope",
     'backend = os.environ.get("REPRO_SIM_BACKEND")\n'
     'flag = os.environ["REPRO_FLAG"]\nmode = os.getenv("REPRO_MODE")\n',
     None, None, [(1, "env-read"), (2, "env-read"), (3, "env-read")]),
    ("env-write-passes",
     'os.environ["XLA_FLAGS"] = "--xla_force_host_platform"\n',
     'os.environ["CUDA_VISIBLE_DEVICES"] = "0"\n', None, []),
    ("env-read-in-a-function-passes",
     'def configure():\n    return os.environ.get("REPRO_SIM_BACKEND")\n',
     None, None, []),
    ("suppression-justified",
     "import jax.numpy as jnp\n"
     "# contract: allow(raw-reduction): exact 0/1 indicator count\n"
     "total = jnp.sum(flags)\n"
     "other = jnp.sum(flags)  # contract: allow(raw-reduction): count\n",
     "import torch\n"
     "# contract: allow(raw-reduction): exact 0/1 indicator count\n"
     "total = torch.sum(flags)\n"
     "other = flags.sum()  # contract: allow(raw-reduction): count\n",
     True, [(3, "raw-reduction"), (4, "raw-reduction")]),
    ("suppression-without-justification",
     "import jax.numpy as jnp\n# contract: allow(raw-reduction)\n"
     "total = jnp.sum(flags)\n",
     "import torch\n# contract: allow(raw-reduction)\n"
     "total = torch.sum(flags)\n",
     True, [(2, "bad-suppression"), (3, "raw-reduction")]),
    ("suppression-of-unknown-rule",
     "# contract: allow(frobnicate): because reasons\nx = 1\n",
     None, None, [(1, "bad-suppression")]),
    ("suppression-of-the-wrong-rule",
     "import jax.numpy as jnp\n"
     "# contract: allow(numpy-in-jit): wrong rule for this line\n"
     "total = jnp.sum(flags)\n",
     "import torch\n"
     "# contract: allow(numpy-in-jit): wrong rule for this line\n"
     "total = torch.sum(flags)\n",
     True, [(3, "raw-reduction")]),
]


@pytest.mark.parametrize("case", LINT_CASES, ids=[c[0] for c in LINT_CASES])
def test_lint_flags_what_the_jax_linter_flags(case):
    _, jsrc, tsrc, marked, want = case
    tsrc = jsrc if tsrc is None else tsrc
    jv = jlint.lint_source(jsrc, marked=marked)
    tv = lint.lint_source(tsrc, marked=marked)
    assert _pairs(tv) == _pairs(jv)
    assert _pairs(tv, suppressed=False) == _pairs(jv, suppressed=False)
    # the expected pairs: suppressed violations listed too, as JAX does
    assert _pairs(tv) == sorted(want)


def test_suppression_keeps_its_justification():
    src = ("import torch\n"
           "# contract: allow(raw-reduction): exact 0/1 indicator count\n"
           "total = torch.sum(flags)\n")
    (v,) = lint.lint_source(src, marked=True)
    assert v.suppressed and v.justification == "exact 0/1 indicator count"
    (jv,) = jlint.lint_source(src.replace("torch.sum", "jnp.sum"),
                              marked=True)
    assert jv.justification == v.justification


@pytest.mark.parametrize("src,flagged", [
    ("import jax\n", True),
    ("import jax.numpy as jnp\n", True),
    ("from repro.core import x\n", True),
    ("import jaxlib\n", True),
    ("import repro.scenario\n", True),
    ("from jax import random\n", True),
    ("import repro_torch\n", False),
    ("from repro_torch.core import x\n", False),
    ("from . import repro\n", False),
    ("from .repro import y\n", False),
    ("import reproducible\n", False),
])
def test_jax_import_rule(src, flagged):
    want = [(1, "jax-import")] if flagged else []
    assert _pairs(lint.lint_source(src)) == want


def test_retargeted_rules_stay_known_and_flag_nothing():
    """``numpy-in-jit`` and ``traced-branch`` went to the audit's host-sync
    count: known names (an ``allow()`` of them is no bad suppression), no
    static check."""
    src = ("import numpy as np\n"
           "def f(x):\n"
           "    # contract: allow(traced-branch): a justified host branch\n"
           "    if x.any():\n"
           "        return np.sin(x)\n"
           "    return x.item()\n")
    assert lint.lint_source(src, marked=True) == []
    assert {"numpy-in-jit", "traced-branch"} <= set(lint.RULES)


# ---------------------------------------------------------------------------
# linter: the repo itself, the markers, the registry names, the CLI
# ---------------------------------------------------------------------------

def test_repo_lints_clean():
    active = [v for v in lint.lint_tree() if not v.suppressed]
    assert not active, "\n".join(v.format() for v in active)


def test_repo_suppressions_all_carry_justifications():
    sup = [v for v in lint.lint_tree() if v.suppressed]
    assert sup
    for v in sup:
        assert v.justification, v.format()


def test_lint_covers_the_port_files():
    targets = {Path(p).resolve() for p in lint.default_targets()}
    assert ROOT / "chip_smoke.py" in targets
    assert ROOT / "examples" / "quickstart_torch.py" in targets
    assert ROOT / "src" / "repro_torch" / "core" / "buzen.py" in targets
    assert not any(p.is_relative_to(ROOT / "src" / "repro")
                   for p in targets)


def _marked(pkg: Path) -> set:
    mark = re.compile(r"#\s*contract:\s*padded-n\b")
    return {str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
            if mark.search(p.read_text())}


def test_port_marks_exactly_the_jax_packages_modules():
    jax_marked = _marked(ROOT / "src" / "repro")
    port_marked = _marked(ROOT / "src" / "repro_torch")
    assert "core/buzen.py" in jax_marked
    assert port_marked == jax_marked


def test_hardcoded_registry_names_match_the_ports_registries():
    import repro_torch.scenario.suite  # noqa: F401 — registers strategies
    from repro_torch.scenario import STRATEGIES, law_names

    assert set(law_names()) == set(lint.LAW_NAMES) == set(jlint.LAW_NAMES)
    assert set(STRATEGIES.names()) == set(lint.STRATEGY_NAMES) \
        == set(jlint.STRATEGY_NAMES)


def test_cli_gate_green_on_repo(capsys):
    from repro_torch.analysis.__main__ import main

    assert main([]) == 0
    out = capsys.readouterr().out
    assert "contract lint: 0 violation(s)" in out
    assert "hygiene OK" in out
    assert main(["frobnicate"]) == 2


def test_lint_and_hygiene_import_no_torch():
    code = ("import sys\n"
            "import repro_torch.analysis\n"
            "from repro_torch.analysis import hygiene, lint\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True)


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_hygiene_tracks_no_junk():
    assert hygiene.tracked_junk() == []
    assert hygiene.main() == 0


@pytest.mark.parametrize("path,junk", [
    (".hypothesis/examples/04e6b3400353b141/5daeddc77d69c66d", True),
    (".hypothesis/patches/2026-10-19--e608735e.patch", True),
    (".hypothesis/constants/a4a91ff9fc593c18", False),
    ("build/libbuzen-0123456789abcdef.so", True),
    ("chiprun_out/.last_call.json", True),
    ("chip_scratch/parent/chip_smoke.py", True),
    ("src/repro_torch/__pycache__/x.cpython-312.pyc", True),
    ("src/repro_torch/kernels/build.py", False),
    ("src/repro_torch/kernels/csrc/buzen.cu", False),
])
def test_hygiene_forbids_the_ports_output(path, junk):
    assert hygiene.is_junk(path) is junk


def test_hygiene_without_git_passes_with_no_files(tmp_path):
    assert hygiene.tracked_files(str(tmp_path)) == []
    assert hygiene.tracked_junk(str(tmp_path)) == []


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------

def _mixed_population_suite(pkg, seeds=(0,), **kw):
    """``tests/test_analysis.py``'s suite, built with ``pkg``'s scenario
    API (``repro.scenario`` or ``repro_torch.scenario``)."""
    consts = pkg.LearningConstants(M=2.0, G=5.0)
    S = pkg.scenario
    scns = {}
    for i, n in enumerate((3, 4, 6)):
        rng = np.random.default_rng(40 + i)
        net = S.NetworkSpec(mu_c=rng.uniform(0.5, 6.0, n),
                            mu_d=rng.uniform(0.5, 6.0, n),
                            mu_u=rng.uniform(0.5, 6.0, n))
        scns[f"n{n}"] = S.Scenario(
            network=net, learning=S.LearningSpec(consts=consts),
            strategy=S.StrategySpec(S.EXPLICIT, p=rng.dirichlet(np.ones(n)),
                                    m=n - 1))
    return S.ScenarioSuite(scns, seeds=seeds, **kw)


class _Pkg:
    def __init__(self, core, scenario):
        self.LearningConstants = core.LearningConstants
        self.scenario = scenario


def _torch_pkg():
    import repro_torch.core as core
    import repro_torch.scenario as scenario

    return _Pkg(core, scenario)


def _torch_suite(seeds=(0,), **kw):
    return _mixed_population_suite(_torch_pkg(), seeds=seeds, device="cpu",
                                   **kw)


# Each planner test uses its own num_updates so the process-wide lane
# memo cannot carry a runner from one test into another.

def test_suite_mixed_population_holds_the_jax_program_budget(tracecheck):
    import repro.core as jcore
    import repro.scenario as jscenario

    jres = _mixed_population_suite(_Pkg(jcore, jscenario)).run(
        mode="simulate", num_updates=7)
    suite = _torch_suite(seeds=(0, 1))
    with tracecheck.expect(max_programs=2,
                           pattern=tracecheck.PLANNER_PROGRAMS,
                           what="mixed-n suite planner") as w:
        res = suite.run(mode="simulate", num_updates=173)
    assert res.programs == jres.programs == 1
    assert w.programs(tracecheck.PLANNER_PROGRAMS) == ["lanes.batched",
                                                       "suite.simulate"]
    assert w.builds == 0 and w.dynamo_compiles == 0
    assert w.launches == {}  # CPU tensors take the plain versions


def test_sentinel_catches_per_scenario_replanning(tracecheck):
    """Mutation: re-plan each scenario in its own suite (one runner per
    population).  The sentinel must fail it."""
    S = _torch_pkg().scenario
    suite = _torch_suite()
    with pytest.raises(tracecheck.TraceBudgetExceeded, match="budget 2"):
        with tracecheck.expect(max_programs=2,
                               pattern=tracecheck.PLANNER_PROGRAMS,
                               what="per-scenario re-planning mutation"):
            for name, scn in suite.scenarios.items():
                S.ScenarioSuite({name: scn}, seeds=(0,), device="cpu").run(
                    mode="simulate", num_updates=179)


def test_forbid_passes_a_cached_repeat(tracecheck):
    from repro_torch.scenario import SuiteCaches

    caches = SuiteCaches()
    suite = _torch_suite(caches=caches)
    first = suite.run(mode="simulate", num_updates=181)
    with tracecheck.forbid("the same run again: result cache"):
        again = suite.run(mode="simulate", num_updates=181)
    assert again.cache_hits == 3 and again.programs == 0
    assert all(torch.equal(a.throughput, b.throughput)
               for k in first.entries
               for a, b in zip(first.entries[k], again.entries[k]))
    # new seeds through the shared caches run the cached runner
    with tracecheck.forbid("new seeds: cached runner") as w:
        res = _torch_suite(seeds=(5,), caches=caches).run(
            mode="simulate", num_updates=181)
    assert res.programs == 0 and res.cache_hits == 0
    assert w.programs() == []
    with pytest.raises(tracecheck.TraceBudgetExceeded, match="runners"):
        with tracecheck.forbid("a fresh suite builds its runner"):
            _torch_suite(seeds=(5,)).run(mode="simulate", num_updates=181)


def test_fresh_clears_the_lane_memo(tracecheck):
    from repro_torch.sim import build_lanes_fn

    build_lanes_fn("batched", 191, 1, "exponential", 4, False)
    with tracecheck.watch() as w:
        build_lanes_fn("batched", 191, 1, "exponential", 4, False)
    assert w.compiled == []
    tracecheck.fresh()
    with tracecheck.watch() as w:
        build_lanes_fn("batched", 191, 1, "exponential", 4, False)
    assert w.compiled == ["lanes.batched"]


def test_watch_counts_builds_reuses_and_launches(tracecheck, monkeypatch):
    """The records of ``repro_torch.kernels.build`` as a card run writes
    them (no nvcc and no launch on the CPU): an nvcc span, a reused
    library, a counted launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels.buzen import buzen_batched

    monkeypatch.setattr(build, "_spans", list(build._spans))
    monkeypatch.setattr(build, "_reuses", list(build._reuses))
    monkeypatch.setattr(build, "_launch_totals", dict(build._launch_totals))
    monkeypatch.setattr(buzen_batched, "launches", buzen_batched.launches)
    with tracecheck.watch() as w:
        build._spans.append(("nvcc:buzen", 1.0, 2.5))
        build._reuses.append("events")
        build.count(buzen_batched)
        build.count(buzen_batched)
        assert w.builds == 1  # live inside the block
    build.count(buzen_batched)  # after the block: not the watch's
    assert w.spans == [("nvcc:buzen", 1.0, 2.5)]
    assert w.builds == 1
    assert w.cache_hits == 1
    assert w.launches == {"buzen_batched": 2}
    with pytest.raises(tracecheck.TraceBudgetExceeded, match="nvcc"):
        with tracecheck.forbid("no build"):
            build._spans.append(("nvcc:events", 3.0, 1.0))


def test_forbid_catches_a_dynamo_compile(tracecheck):
    def f(x):
        return x * 2.0 + 1.0

    compiled = torch.compile(f, backend="eager")
    with pytest.raises(tracecheck.TraceBudgetExceeded, match="Dynamo"):
        with tracecheck.forbid("no torch.compile in the port"):
            compiled(torch.ones(3))


def test_counting_wrapper_counts_calls(tracecheck):
    counted = tracecheck.counting(lambda x: x * 3.0)
    counted(torch.ones(2))
    counted(torch.ones(5))
    assert counted.traces == 2


# ---------------------------------------------------------------------------
# audit
# ---------------------------------------------------------------------------

def test_audit_registry_names_are_the_jax_packages():
    from repro.analysis import audit as jaudit
    from repro_torch.analysis import audit

    want = {n.replace("pallas", "kernel") for n in jaudit.resident_programs()}
    assert len(want) == 17
    assert set(audit.resident_programs()) == want


_SCHEMA_TYPES = {"str": str, "int": int, "number": (int, float),
                 "bool": bool}


def _check_schema(spec, value, path="report"):
    if isinstance(spec, str):
        assert isinstance(value, _SCHEMA_TYPES[spec]), \
            f"{path}: {value!r} is not {spec}"
        if spec in ("int", "number"):
            assert not isinstance(value, bool), f"{path}: bool is not {spec}"
    elif isinstance(spec, list):
        assert isinstance(value, list), f"{path}: {type(value)} != list"
        for i, item in enumerate(value):
            _check_schema(spec[0], item, f"{path}[{i}]")
    elif isinstance(spec, dict):
        assert isinstance(value, dict), f"{path}: {type(value)} != dict"
        if "__each__" in spec:
            for k, v in value.items():
                _check_schema(spec["__each__"], v, f"{path}.{k}")
        else:
            missing = set(spec) - set(value)
            extra = set(value) - set(spec)
            assert not missing, f"{path}: missing keys {sorted(missing)}"
            assert not extra, f"{path}: unexpected keys {sorted(extra)}"
            for k in spec:
                _check_schema(spec[k], value[k], f"{path}.{k}")
    else:  # pragma: no cover - malformed golden file
        raise AssertionError(f"bad schema node at {path}: {spec!r}")


PAIR = ["suite_analyze", "kernel_buzen"]


@pytest.fixture(scope="module")
def audit_report():
    from repro_torch.analysis import audit

    return audit.build_report(names=PAIR, device="cpu")


def test_audit_report_matches_its_schema(audit_report):
    golden = json.loads((DATA / "audit_torch_schema.json").read_text())
    _check_schema(golden, audit_report)
    assert audit_report["schema"] == {"name": "repro_torch.analysis.audit",
                                      "version": 1}
    assert audit_report["device"] == "cpu"
    summary = audit_report["summary"]
    assert summary["programs"] == 2
    assert sorted(summary["capturable"] + summary["blocked"]) == sorted(PAIR)


def test_audit_float64_findings_agree_with_jax(audit_report):
    from repro.analysis import audit as jaudit

    jrep = jaudit.build_report(names=PAIR)
    for name in PAIR:
        mine = audit_report["programs"][name]
        assert (mine["f64"]["count"] > 0) == \
            (jrep["programs"][name]["f64"]["count"] > 0), name
        assert mine["total_ops"] > 0 and mine["flops_estimate"] > 0
    analyze = audit_report["programs"]["suite_analyze"]
    assert analyze["f64"]["examples"]
    assert all("repro_torch/" in e for e in analyze["f64"]["examples"])
    # the closed forms and the kernel wrapper pull nothing to the host
    for entry in audit_report["programs"].values():
        assert entry["host_syncs"]["count"] == 0
        assert entry["graph_capturable"] and entry["graph_blockers"] == []
        assert entry["launches"] == {}  # plain versions on the CPU


def test_analyze_ops_counts_host_syncs_and_downcasts():
    from repro_torch.analysis import audit

    x = torch.arange(6, dtype=torch.float64)
    rep = audit.analyze_ops(lambda: (x.sum().item(), bool(x[0] > 1),
                                     x[x > 2], x.to(torch.float32)))
    assert rep["host_syncs"]["count"] >= 3
    assert rep["host_syncs"]["ops"]["_local_scalar_dense"] == 2
    assert rep["host_syncs"]["ops"]["index"] == 1
    assert rep["graph_capturable"] is False
    assert rep["graph_blockers"] == ["host-syncs"]
    assert rep["downcasts_f64_to_f32"]["count"] == 1
    clean = audit.analyze_ops(lambda a, b: a @ b, torch.ones(2, 3),
                              torch.ones(3, 4))
    assert clean["host_syncs"]["count"] == 0 and clean["graph_capturable"]
    assert clean["op_counts"] == {"mm": 1}
    assert clean["flops_estimate"] == 2.0 * 8 * 3
    assert clean["f64"]["count"] == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_audit_on_cuda_raises_without_a_card():
    from repro_torch.analysis import audit

    with pytest.raises(RuntimeError, match="CUDA device"):
        audit.build_report(names=["kernel_buzen"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        audit.main(["--programs", "kernel_buzen"])
