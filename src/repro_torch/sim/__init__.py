"""repro_torch.sim — the simulation-backend subsystem of the event engine
(port of ``repro.sim``): the backend flag and the lane-batched runs."""
from .backend import BACKENDS, get_backend, resolve_backend, set_backend
from .batched_events import (run_lanes, simulate_stats_classes_lanes,
                             simulate_stats_lanes)

__all__ = ["BACKENDS", "set_backend", "get_backend", "resolve_backend",
           "run_lanes", "simulate_stats_lanes",
           "simulate_stats_classes_lanes"]
