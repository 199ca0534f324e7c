"""repro_torch.sim — the simulation-backend subsystem of the event engine
(port of ``repro.sim``): the backend flag, the lane-batched runs, the
memoized lane runners (``build_lanes_fn``, ``build_class_lanes_fn``) and
the lanes split over the local devices (``sharded``)."""
from .backend import BACKENDS, get_backend, resolve_backend, set_backend
from .batched_events import (build_class_lanes_fn, build_lanes_fn, run_lanes,
                             simulate_stats_classes_lanes,
                             simulate_stats_lanes, stack_lanes)
from .sharded import (build_sharded_class_lanes_fn, build_sharded_lanes_fn,
                      device_count)

__all__ = ["BACKENDS", "set_backend", "get_backend", "resolve_backend",
           "run_lanes", "simulate_stats_lanes",
           "simulate_stats_classes_lanes", "build_lanes_fn",
           "build_class_lanes_fn", "stack_lanes", "device_count",
           "build_sharded_lanes_fn", "build_sharded_class_lanes_fn"]
