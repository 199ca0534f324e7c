"""repro_torch.obs — observability (port of ``repro.obs``).

  * ``repro_torch.obs.rings`` — the telemetry rings carried through the
    event engine (written by the lane kernel on the ``kernel`` route) and
    the lane trainer; bitwise non-invasive, a no-op at capacity 0;
  * ``repro_torch.obs.metrics`` — the counters/histograms/spans registry;
  * ``repro_torch.obs.trace`` — Chrome-trace/Perfetto JSON export of the
    simulated closed-network timeline plus host spans and kernel builds;
  * ``repro_torch.obs.drift`` — empirical-vs-closed-form drift monitors;
  * ``python -m repro_torch.obs`` — smoke/check/report CLI over saved
    traces.

Tracing is selected per scenario by ``TraceSpec`` on ``Scenario.sim``.
This ``__init__`` stays import-light (metrics only): the rest is imported
on demand.
"""
from .metrics import Histogram, Metrics

__all__ = ["Metrics", "Histogram"]
