"""Warm restarts: the kernels' build directory (the port's counterpart of
``repro.serve.xla_cache``).

The JAX server restarts warm through the persistent XLA compilation
cache.  The port's compiles are the ``nvcc`` builds of
:mod:`repro_torch.kernels.build`, whose libraries are named by a digest of
their sources and flags: :func:`enable_build_cache` points the build at
one directory (default the repo's ``build/``), and :func:`prebuild`
builds every kernel of the scenario path there ahead of the first
request.  A restarted server on the same directory then finds every
library on disk and runs no ``nvcc`` at all (a
:func:`repro_torch.analysis.tracecheck.watch` of the boot counts no
build).

Call them before the first kernel launch; both are idempotent.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..analysis import tracecheck
from ..kernels import build

#: the sources whose kernels the scenario path launches: the Buzen
#: forward/backward (per client and per class), the event lane kernel,
#: the fused update and the key chain
SCENARIO_KERNELS = ("buzen", "events", "fused_update", "threefry")


def enable_build_cache(cache_dir: Optional[str] = None) -> str:
    """Point the kernels' build at ``cache_dir`` (default the repo's
    ``build/``); returns the directory."""
    path = build.set_build_dir(cache_dir if cache_dir
                               else build.DEFAULT_BUILD_DIR)
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def prebuild(device="cuda") -> int:
    """Build every scenario-path kernel that is not yet on disk, one
    ``nvcc`` per source at once; returns how many ran.  Nothing to build
    for the CPU, whose tensors take the plain versions."""
    if torch.device(device).type != "cuda":
        return 0
    with tracecheck.watch() as watch:
        build.build_all(SCENARIO_KERNELS)
    return watch.builds
