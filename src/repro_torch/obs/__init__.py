"""repro_torch.obs — observability (port of ``repro.obs``): the metrics
registry.  The telemetry rings, drift monitors and trace export are not
ported yet."""
from .metrics import Histogram, Metrics

__all__ = ["Metrics", "Histogram"]
