"""Static and dynamic analysis of the port: the padded-``n`` bitwise
contract, its build budgets and its resident programs' host syncs (port of
``repro.analysis``).

Four tools, wired into tier-1 (``python -m repro_torch.analysis``):

  * :mod:`repro_torch.analysis.lint` — AST contract linter: named rules
    over the port's sources (no raw ``torch.sum``/``.sum()`` in
    contract-marked modules, no ``Categorical``/``multinomial`` routing,
    no stringly-typed law/strategy dispatch, no module-scope
    ``os.environ`` read, no import of ``jax`` or ``repro``) with
    ``# contract: allow(<rule>): <why>`` suppressions;
  * :mod:`repro_torch.analysis.hygiene` — no generated file tracked;
  * :mod:`repro_torch.analysis.tracecheck` — build and launch sentinel:
    ``nvcc`` runs, libraries reused, bucket runners built, kernel launches
    and Dynamo compiles per watched block, with budgets;
  * :mod:`repro_torch.analysis.audit` — program audit: every resident
    program run once under a dispatch recorder at tiny sizes, its aten
    ops, float64 ops, downcasts, host syncs and kernel launches as a JSON
    report.

This package imports nothing heavy: ``lint`` and ``hygiene`` run without
touching PyTorch or the CUDA libraries.
"""
from __future__ import annotations

from .lint import Violation, lint_file, lint_source, lint_tree  # noqa: F401

__all__ = ["Violation", "lint_file", "lint_source", "lint_tree"]
