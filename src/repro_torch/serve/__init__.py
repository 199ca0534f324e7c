"""``repro_torch.serve`` — the always-on suite service (port of
``repro.serve``).

A persistent server (``python -m repro_torch.serve``) accepts scenario
requests over JSON lines (unix socket, stdio fallback), coalesces
concurrent requests into spare lanes of one ``ScenarioSuite`` dispatch on
the card, answers repeats from a ``Scenario.hash()`` response cache, and
restarts warm from the kernels' build directory
(:mod:`repro_torch.serve.build_cache`).

This ``__init__`` stays import-light (``metrics`` only): the server and
the executor pull in the scenario layer only when booted.
"""
from .metrics import Histogram, Metrics

__all__ = ["Histogram", "Metrics"]
