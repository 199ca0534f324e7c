"""The metrics registry of :mod:`repro_torch.obs.metrics`, under the
name the JAX package's serve layer gives it (``repro.serve.metrics``)."""
from ..obs.metrics import _RESERVOIR  # noqa: F401  (tests size reservoirs)
from ..obs.metrics import Histogram, Metrics, _Timer  # noqa: F401

__all__ = ["Histogram", "Metrics"]
