"""repro_torch.core — the queueing core: Buzen's DP, the closed forms, the
routing/concurrency optimizer, the device event engine and the host
simulator (port of ``repro.core``, per-client half)."""
from .batched import (batch_log_normalizing_constants,
                      make_time_objective_padded, objective_surface,
                      tau_surface)
from .buzen import (NetworkParams, get_backend, log_normalizing_constants,
                    pad_network, set_backend)
from .complexity import (LearningConstants, eta_max, round_complexity,
                         wallclock_time)
from .energy import (PowerProfile, energy_complexity, energy_per_round,
                     per_task_energy)
from .events import (EventBlocks, EventState, EventStats, EventStream,
                     UpdateOut, draw_event_blocks, init_state, next_update,
                     simulate_stats, step_event, step_event_block)
from .jackson import (analyze, delay_jacobian, expected_relative_delay,
                      throughput, throughput_grad)
from .numerics import DTYPE, NEG_INF, seqcumsum, seqsum
from .optimize import (OptResult, SweepResult, batched_concurrency_sweep,
                       max_throughput, optimize_routing, round_optimal,
                       time_optimal)
