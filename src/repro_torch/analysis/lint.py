"""Contract linter — the bitwise padding contract as named AST rules (port
of ``repro.analysis.lint``).

The mixed-population story of the port (a padded run == the unpadded run
**bitwise**) holds only while a handful of coding rules hold; this module
checks them over the port's sources (``src/repro_torch``, the
``examples/*_torch.py`` scripts and ``chip_smoke.py``):

``raw-reduction``
    ``torch.sum``/``torch.cumsum``/``torch.logsumexp``/
    ``torch.special.logsumexp`` (or ``np.``/``numpy.`` sums, or the
    ``.sum()``/``.cumsum()``/``.logsumexp()`` methods) in a
    contract-marked module.  Client-axis AND class-axis reductions must
    use ``numerics.seqsum``/``seqcumsum``: ``torch.sum`` on CUDA reduces in
    a tree whose association changes with the array's *length*, so a raw
    sum over a zero-padded axis is not bitwise stable; ``logsumexp`` over
    the padded class axis is the same bug in log space (reductions over
    the static ``m``-convolution axis are fine and say so in an
    ``allow()``).
``categorical-routing``
    ``torch.distributions.Categorical``, ``torch.multinomial`` or a
    ``.multinomial(`` method anywhere.  Their draws depend on the
    probabilities' length; routing must stay inverse-CDF on ONE scalar
    uniform (``repro_torch.core.events``).
``stringly-dispatch``
    ``if``/``elif`` chains or callable dict-dispatch keyed by two or more
    registered law/strategy names.  Law and strategy lookups go through
    the ``repro_torch.scenario.registry`` decorators so extensions and
    error messages stay in one place.
``env-read``
    ``os.environ``/``os.getenv`` read at module scope (frozen at *import*
    time — a server process imports once and then ignores the environment
    forever; read config where it is consumed, or suppress with the why).
    Writes are fine.  Eager PyTorch has no trace, so the JAX rule's
    "inside a traced function" half has no static counterpart.
``jax-import``
    ``import``/``from`` of ``jax``, ``jaxlib`` or ``repro`` (the JAX
    package; ``repro_torch`` is fine): the port keeps its own copy of what
    it needs and runs where JAX is not installed.
``numpy-in-jit``, ``traced-branch``
    Retargeted, not dropped: in eager code the hazards these JAX rules
    guard against (a host value pulled out of a device computation) are
    host syncs — ``.item()``, ``bool(t)``, ``.cpu()``, ``nonzero`` — and
    whether a call syncs depends on where its tensor lives, which no
    static rule can see.  :mod:`repro_torch.analysis.audit` counts them per
    resident program as it runs (``host_syncs``).  The names stay known
    rules, so an ``allow()`` reads the same in both packages.
``bad-suppression``
    a ``# contract: allow(...)`` comment without a justification, or
    naming an unknown rule.

A module opts into the marked-module rules with a ``# contract: padded-n``
comment line.  A violation is suppressed by ``# contract:
allow(<rule>): <justification>`` on the violating line or the line above;
the justification is mandatory.

Pure stdlib (``ast``).  The registered law/strategy names are HARDCODED
here so linting stays import-light; ``tests/test_torch_analysis.py``
cross-checks them against ``repro_torch.scenario.registry``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Iterable, Optional

# Cross-checked against repro_torch.scenario.registry in
# tests/test_torch_analysis.py.
LAW_NAMES = frozenset(
    {"exponential", "deterministic", "lognormal", "hyperexponential"})
STRATEGY_NAMES = frozenset(
    {"asyncsgd", "max_throughput", "round_opt", "time_opt", "energy_opt",
     "joint"})
DISPATCH_NAMES = LAW_NAMES | STRATEGY_NAMES

RULES = {
    "raw-reduction":
        "raw sum/cumsum/logsumexp in a contract-marked module; client- "
        "and class-axis reductions must use numerics.seqsum/seqcumsum",
    "categorical-routing":
        "Categorical/multinomial draws depend on the probabilities' "
        "length; routing must be inverse-CDF on one scalar uniform",
    "stringly-dispatch":
        "law/strategy dispatch on string literals; route through the "
        "repro_torch.scenario.registry decorators",
    "numpy-in-jit":
        "retargeted: host syncs are counted per program by "
        "repro_torch.analysis.audit (no static check in eager code)",
    "traced-branch":
        "retargeted: a Python branch on a device value is a host sync, "
        "counted per program by repro_torch.analysis.audit",
    "env-read":
        "os.environ read at module scope (frozen at import time); "
        "resolve flags where they are consumed",
    "jax-import":
        "the port imports neither jax, jaxlib nor the JAX package repro",
    "bad-suppression":
        "contract: allow(...) without a justification or naming an "
        "unknown rule",
}

_MARK_RE = re.compile(r"#\s*contract:\s*padded-n\b")
_ALLOW_RE = re.compile(
    r"#\s*contract:\s*allow\(([A-Za-z0-9_-]+)\)\s*(?::\s*(\S.*?))?\s*$")

_TORCH_REDUCTIONS = frozenset(
    {"torch.sum", "torch.cumsum", "torch.logsumexp",
     "torch.special.logsumexp"})
_NP_BASES = ("np", "numpy")
_FORBIDDEN_IMPORTS = frozenset({"jax", "jaxlib", "repro"})


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def format(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


def _dotted(node) -> str:
    """``a.b.c`` for an Attribute/Name chain, else ``""``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _suppressions(text: str):
    """line -> (rule, justification|None) for every allow() comment."""
    out = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = (m.group(1), m.group(2))
    return out


def _is_reduction_call(node: ast.Call) -> Optional[str]:
    """Describe a raw sum/cumsum/logsumexp call, else None."""
    if isinstance(node.func, ast.Name):
        # `from torch.special import logsumexp`
        return ("logsumexp(...)" if node.func.id == "logsumexp" else None)
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    name = _dotted(node.func)
    if name in _TORCH_REDUCTIONS:
        return f"{name}(...)"
    if attr not in ("sum", "cumsum", "logsumexp"):
        return None
    base = _dotted(node.func.value)
    if base in _NP_BASES:
        return f"{base}.{attr}(...)"
    # any .sum()/.cumsum()/.logsumexp() method: static analysis cannot
    # prove the receiver is not a padded-axis tensor, so flag
    # conservatively
    return f".{attr}() method call"


def _is_categorical(node: ast.Call) -> Optional[str]:
    """The spelling of a Categorical/multinomial routing draw, else None."""
    callee = _dotted(node.func)
    leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
            else callee)
    if leaf == "Categorical" and (callee == "Categorical"
                                  or ".distributions." in f".{callee}"):
        return f"{callee}(...)"
    if leaf == "multinomial":
        return f"{callee or '.multinomial'}(...)"
    return None


def _if_chain_literals(node: ast.If, seen_ids: set):
    """String literals compared in an if/elif chain (Eq / In tests)."""
    literals: list[tuple[str, int]] = []
    cur: ast.stmt = node
    while isinstance(cur, ast.If):
        seen_ids.add(id(cur))
        for sub in ast.walk(cur.test):
            if not isinstance(sub, ast.Compare):
                continue
            for op, comp in zip(sub.ops, sub.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)) and \
                        isinstance(comp, ast.Constant) and \
                        isinstance(comp.value, str):
                    literals.append((comp.value, cur.lineno))
                elif isinstance(op, (ast.In, ast.NotIn)) and \
                        isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                    for elt in comp.elts:
                        if isinstance(elt, ast.Constant) and \
                                isinstance(elt.value, str):
                            literals.append((elt.value, cur.lineno))
        cur = cur.orelse[0] if (len(cur.orelse) == 1
                                and isinstance(cur.orelse[0], ast.If)) \
            else None
    return literals


def _module_scope_nodes(tree: ast.Module):
    """AST nodes executed at import time: everything outside function
    and lambda bodies (class bodies DO run at import)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _env_read(node) -> Optional[str]:
    """The offending spelling if ``node`` reads the environment."""
    if isinstance(node, ast.Call):
        base = _dotted(node.func)
        if base in ("os.getenv", "os.environ.get"):
            return f"{base}(...)"
    elif isinstance(node, ast.Subscript):
        if _dotted(node.value) == "os.environ" and \
                isinstance(node.ctx, ast.Load):
            return "os.environ[...]"
    return None


def _forbidden_import(node) -> Optional[str]:
    """The module name if ``node`` imports jax, jaxlib or repro."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module or ""]
    else:
        return None
    for name in names:
        if name.split(".")[0] in _FORBIDDEN_IMPORTS:
            return name
    return None


def lint_source(text: str, path: str = "<string>",
                marked: Optional[bool] = None) -> list[Violation]:
    """All violations (suppressed and not) in one module's source."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "bad-suppression",
                          f"unparseable module: {e.msg}")]
    if marked is None:
        marked = bool(_MARK_RE.search(text))
    allows = _suppressions(text)
    raw: list[Violation] = []

    def add(line: int, rule: str, message: str):
        raw.append(Violation(path, line, rule, message))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            spelled = _is_categorical(node)
            if spelled is not None:
                add(node.lineno, "categorical-routing",
                    f"{spelled} — " + RULES["categorical-routing"])
            if marked:
                desc = _is_reduction_call(node)
                if desc is not None:
                    add(node.lineno, "raw-reduction",
                        f"{desc} — " + RULES["raw-reduction"])
        elif isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)]
            hits = sorted(set(keys) & DISPATCH_NAMES)
            callable_vals = sum(
                isinstance(v, (ast.Lambda, ast.Name, ast.Attribute))
                for v in node.values)
            if len(hits) >= 2 and callable_vals >= 2:
                add(node.lineno, "stringly-dispatch",
                    f"dict dispatch over registered names {hits} — "
                    + RULES["stringly-dispatch"])
        else:
            name = _forbidden_import(node)
            if name is not None:
                add(node.lineno, "jax-import",
                    f"imports {name} — " + RULES["jax-import"])

    for node in _module_scope_nodes(tree):
        spelled = _env_read(node)
        if spelled is not None:
            add(node.lineno, "env-read",
                f"{spelled} at module scope — " + RULES["env-read"])

    seen_ifs: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and id(node) not in seen_ifs:
            literals = _if_chain_literals(node, seen_ifs)
            hits = sorted({v for v, _ in literals} & DISPATCH_NAMES)
            if len(hits) >= 2:
                add(node.lineno, "stringly-dispatch",
                    f"if/elif chain over registered names {hits} — "
                    + RULES["stringly-dispatch"])

    # -- apply suppressions --------------------------------------------------
    out: list[Violation] = []
    for v in sorted(raw, key=lambda v: (v.line, v.rule)):
        sup = None
        for line in (v.line, v.line - 1):
            hit = allows.get(line)
            if hit is not None and hit[0] == v.rule:
                sup = hit
                break
        if sup is not None and sup[1]:
            out.append(dataclasses.replace(v, suppressed=True,
                                           justification=sup[1]))
        else:
            out.append(v)
    for line, (rule, just) in sorted(allows.items()):
        if rule not in RULES or rule == "bad-suppression":
            out.append(Violation(path, line, "bad-suppression",
                                 f"allow({rule}) names an unknown rule"))
        elif not just:
            out.append(Violation(
                path, line, "bad-suppression",
                f"allow({rule}) needs a justification: "
                f"`# contract: allow({rule}): <why this is exact>`"))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_file(path: str) -> list[Violation]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path=path)


def default_root() -> str:
    """``src/repro_torch`` relative to this file — the default lint root."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_targets(root: Optional[str] = None) -> list[str]:
    """The port's sources: every ``*.py`` under ``root`` (default
    ``src/repro_torch``), and, for the default root, the repository's
    ``examples/*_torch.py`` and ``chip_smoke.py`` where they exist."""
    files: list[str] = []
    base = root or default_root()
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        files.extend(os.path.join(dirpath, name)
                     for name in sorted(filenames) if name.endswith(".py"))
    if root is None:
        repo = os.path.dirname(os.path.dirname(base))
        examples = os.path.join(repo, "examples")
        if os.path.isdir(examples):
            files.extend(os.path.join(examples, name)
                         for name in sorted(os.listdir(examples))
                         if name.endswith("_torch.py"))
        smoke = os.path.join(repo, "chip_smoke.py")
        if os.path.exists(smoke):
            files.append(smoke)
    return files


def lint_tree(root: Optional[str] = None,
              skip: Iterable[str] = ()) -> list[Violation]:
    """Lint :func:`default_targets` of ``root`` (default: the port's
    package, its examples and ``chip_smoke.py``)."""
    skip = set(skip)
    out: list[Violation] = []
    for path in default_targets(root):
        if os.path.basename(path) not in skip:
            out.extend(lint_file(path))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis lint",
        description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory to lint (default: src/repro_torch, the "
                         "*_torch.py examples and chip_smoke.py)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list suppressed violations")
    args = ap.parse_args(argv)
    violations = lint_tree(args.root)
    active = [v for v in violations if not v.suppressed]
    suppressed = [v for v in violations if v.suppressed]
    for v in active:
        print(v.format(), file=sys.stderr)
    if args.show_suppressed:
        for v in suppressed:
            print(v.format())
    print(f"contract lint: {len(active)} violation(s), "
          f"{len(suppressed)} suppressed")
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
