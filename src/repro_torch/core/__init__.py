"""repro_torch.core — the queueing core: Buzen's DP, the closed forms, the
routing/concurrency optimizer, the device event engine and the host
simulator (port of ``repro.core``): per-client and class-aggregated."""
from .batched import (batch_class_log_normalizing_constants,
                      batch_log_normalizing_constants,
                      delay_jacobian_classes, energy_complexity_classes,
                      expand_class_matrix, expected_relative_delay_classes,
                      joint_objective_classes, make_round_objective_classes,
                      make_time_objective_classes,
                      make_time_objective_padded, mean_member_counts_classes,
                      objective_surface, round_complexity_classes,
                      second_moment_classes, tau_surface,
                      wallclock_time_classes)
from .buzen import (ClassParams, NetworkParams,
                    class_log_normalizing_constants, classes_from_network,
                    get_backend, log_normalizing_constants, pad_classes,
                    pad_network, set_backend)
from .complexity import (LearningConstants, eta_max, round_complexity,
                         wallclock_time)
from .energy import (PowerProfile, energy_complexity, energy_per_round,
                     energy_per_round_classes, per_task_energy)
from .events import (ClassEventState, EventBlocks, EventState, EventStats,
                     EventStream, UpdateOut, draw_class_event_blocks,
                     draw_event_blocks, expand_class_stats, init_class_state,
                     init_state, next_update, simulate_stats,
                     simulate_stats_classes, step_class_event,
                     step_class_event_block, step_event, step_event_block)
from .jackson import (analyze, delay_jacobian, expected_relative_delay,
                      throughput, throughput_grad)
from .numerics import DTYPE, NEG_INF, seqcumsum, seqsum
from .optimize import (OptResult, SweepResult, batched_concurrency_sweep,
                       joint_optimal, max_throughput, optimize_routing,
                       round_optimal, time_optimal, time_optimal_classes)
