"""Process-wide simulation-backend flag for the event engine (port of
``repro.sim.backend``).

  * ``"reference"`` — one lane at a time through the plain PyTorch table
    transition; results are stacked.  The semantic baseline.
  * ``"batched"``  — all lanes advance together, one event per lane per
    step, through the plain PyTorch transition (the default).
  * ``"kernel"``   — like ``"batched"``, with the per-event table transition
    in the CUDA event kernel (``repro_torch.kernels.events``); its plain
    version for CPU tensors.
  * ``"sharded"``  — ``"batched"`` with the lane axis split into
    contiguous chunks over the local CUDA devices, one worker thread and
    stream a device (:mod:`repro_torch.sim.sharded`); a CPU run, or one
    card, is ``"batched"`` itself.

The four are bitwise equal lane by lane.  Select per call with
``backend=...`` or process-wide with :func:`set_backend`; no environment
variable is read.  ``"kernel"`` takes the place of the JAX package's
``"pallas"``.
"""
from __future__ import annotations

from typing import Optional

BACKENDS = ("reference", "batched", "kernel", "sharded")

_backend = "batched"


def _check(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown sim backend: {name!r}; registered backends: "
            f"{sorted(BACKENDS)}")
    return name


def set_backend(name: str) -> None:
    """Set the process-wide default event-engine backend."""
    global _backend
    _backend = _check(name)


def get_backend() -> str:
    return _backend


def resolve_backend(name: Optional[str] = None) -> str:
    """``name`` if given (validated), else the process-wide default."""
    return get_backend() if name is None else _check(name)
