#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the CPU;
every seed is a ``jax.random`` key, :mod:`repro_torch.core.prng`):

  1. the card (``nvidia-smi`` name and power limit) and the kernels' build,
     from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, at once);
  2. the Buzen kernel against its plain PyTorch version (B = 131 rows,
     S = 100 and 101 stations with padded ``-inf`` columns, m_max = 132,
     rtol/atol 2e-5) and against the float64 DP on Table 1 (rtol 3e-5,
     atol 3e-4); the float64 backward kernel against its plain adjoint on
     the same rows (rtol 1e-9 plus an atol of 1e-12 times the largest
     partial), its padded partials exactly 0; the padded rows without
     their padded columns bitwise the same, forward and real partials;
  3. the ``kernel`` route (the event lane kernel) against ``batched``: 6
     lanes, n = 100, m_max = 132, 2,000 events from the same pre-drawn
     blocks, exponential and deterministic laws (500 under the lognormal
     and hyperexponential laws), with and without a CS station — bitwise;
     for the scale laws the same events through the transition-only
     event kernel and its plain version, each carrying its own tables
     (every event's tables, time and descriptors bitwise); then the
     transition-only megastep kernel against its plain version on random
     tables with
     tied clocks and sequence numbers (m_max up to 1000, both laws, with
     and without CS, chunk 1, 7 and 32, ``stop_on_update`` on and off,
     ``rem < chunk``) — bitwise — and one megastep launch against ``chunk``
     event-kernel launches; then the lane kernels (each event's transition
     with its statistics) against their plain versions (the plain
     transition, then ``replay_event`` per kept event) on every
     ``EventState`` leaf, the event times and the descriptors, bitwise: 6
     lanes at n = 100, m_max = 132, all four laws (the scale, H2 and
     lognormal rate forms of the kernel), CS on and off, power none,
     without and with ``P_cs`` (the energy integral on the card's DFMA
     against the plain version's emulated fused multiply-adds), ``keep``
     masks, chunk 1, 7 and 32 with per-lane ``rem < chunk`` and
     ``stop_on_update`` on and off, the lane staged in shared memory; the
     same at n = 3,000 on 3 lanes (rows past the 227 KB a block may stage,
     so in global memory); a sub-batch of lanes bitwise the full batch's
     rows;
  4. the main path at the paper's size (Table 1, n = 100): the closed forms
     in float64, ``time_optimal(m_max=132, steps=200)`` on the ``kernel``
     and ``torch`` Buzen backends (the sweep values within rtol 1e-4);
     ``simulate_stats_lanes`` at the optimum on 6 seed lanes (1,500 updates
     after 400 of warm-up) on the ``kernel`` backend at chunk E = 1, 8 and
     32, at m* and at m = 132 (every statistic bitwise equal across E;
     lane-mean throughput within 10% of Prop. 4), runs of 300 updates with
     a power profile at E = 1, 8 and 32 and on ``batched`` (bitwise) and
     without it at E = 1, 8 and 32 (the same trajectory) and on
     ``batched`` at E = 1 (bitwise), and ``next_update`` on 6 lanes for
     200 updates at chunk 1 and 8 (the updates and final states bitwise).
     Each ``kernel`` run must launch its lane kernel exactly ceil(events /
     E) times and no transition-only kernel, and every run the key-chain
     kernel once a block of 1,024 events.  The kernels' launch counters are
     zeroed just before this phase and read just after it: each kernel
     must have launched, the Buzen forward 201 times and its backward 200
     (the sweep's Adam steps);
  5. each kernel's time and its plain version's time at the main path's
     shapes, beside the least time the card could take: the device time per
     call from a ``torch.profiler`` trace (the sum of the CUDA kernels'
     device time), and the time per call between CUDA events, which also
     counts the host's launch overhead; the Buzen forward's MUFU floor
     beside its bound; the backward kernel, its plain adjoint and the
     autograd recompute of the float64 DP that it replaces, at the sweep's
     shape (131 rows x 100 stations, m_max = 132); the class Buzen kernel
     at the class sweep's shape (131 rows x 5 classes of Table 1 at n =
     1e6, m_max = 132), its whole call (it builds its series itself)
     beside its plain version's, and the class backward kernel beside its
     plain adjoint and the autograd recompute of the float64 class DP that
     it replaces; the lane kernels at the simulation's shapes (6 lanes of
     m* and of 132 slots, n = 100: one event, and E = 8 and 32, with and
     without the power profile, in place as ``run_events`` runs them),
     beside their plain versions and the transition-only kernels;
  6. the device-busy share of short windows of the sweep (per client and,
     at n = 1e6, per class) and the lane
     simulation on each backend and at E = 1, 8 and 32 (profiler device
     time over the wall time of the same traced call), with the wall time
     per lock-step event of an untraced call, and of
     the ``kernel`` lane simulation with a power profile at E = 1 and 8
     (the energy integral on; its trajectory must equal the run without
     power);
  7. training: the paper's EMNIST CNN at full width (408,767 parameters)
     on the synthetic EMNIST fallback (47 classes x 200 samples, a 0.2
     test split, a Dirichlet(0.2) partition over Table 1's n = 100
     clients), batch 32, ``grad_clip`` 5, through ``run_strategy_grid``:
     ``asyncsgd`` (uniform p, m = n) and ``time_opt`` (phase 4's
     ``(p*, m*)``) x 2 seeds = 4 lanes, ``sim_backend="kernel"``,
     ``sim_chunk=8``, horizon 200 / lambda(p*, m*).  The counts are zeroed
     just before this run and read just after it: the fused update launches
     once per update round and the megastep lane kernel on every
     ``next_update`` (the event lane kernel and the transition-only kernels
     never).  The same grid with the apply done in plain PyTorch
     (``w - s * g`` in place of the kernel's wrapper) gives bitwise the
     same final parameters and logs, and at
     ``sim_chunk=1`` (the event kernel) bitwise the same; every loss is
     finite and each ``time_opt`` lane ends below its loss at t = 0.  Then
     the wall ms per update round split into ``next_update``, gradients
     and apply, and the device-busy share of a shorter window (device
     time and wall time from one traced run);
  8. the class-aggregated path on Table 1's five clusters as classes at
     n = 100 (counts 15/15/20/40/10) and n = 1e6 (counts x 1e4), m_max =
     132: the class Buzen kernel against its plain version (131 rows,
     C = 5 and 6 with the CS station as a count-1 column, two padded
     count-0 columns; rtol/atol 2e-5), against the float64 class DP (rtol
     3e-5, atol 3e-4) and padded == unpadded bitwise; the class backward
     kernel on the same rows against its plain adjoint (rtol 1e-9 plus an
     atol of 1e-12 times the largest partial), its padded partials exactly
     0 and its real partials bitwise the unpadded rows'; the class closed
     forms at n = 100 against the per-client forms on ``expand()`` (rtol
     1e-10: lambda, delays, K_eps, wall-clock time, energy per round);
     then, with the class kernels' counts zeroed just before and read just
     after, ``time_optimal_classes(m_max=132, steps=200)`` on the
     ``kernel`` and ``torch`` backends at both sizes (values within rtol
     1e-4; exactly 402 forward and 400 backward class launches, the two
     ``kernel`` sweeps' 200 Adam steps and final evaluations) and
     ``simulate_stats_classes_lanes`` at the n = 1e6 optimum on 6 seed
     lanes (2,000 updates after 400 of warm-up at chunk 1, ``batched``:
     lane-mean throughput within 10% of Prop. 4; a pair of 300-update runs
     at chunk 1 and 8, bitwise; 300 updates with a per-class power profile:
     the pair's trajectory, finite positive energy), and at the n = 100
     optimum (300 updates) for the wall ms per lock-step event beside
     n = 1e6;
  9. the dense LM's prefill (Qwen3-8B, ``configs/qwen3_8b.py``): (a) the
     flash-attention kernel (bfloat16 on ``wgmma`` with TMA-fed tiles,
     float32 on the FFMA units) against its plain version, float32 within
     2e-5 and bfloat16 within 2e-2 (with q and k at unit scale and at 4x,
     for peaked softmaxes), causal, causal with a 512-token window and
     non-causal, at ``tests/test_kernels.py``'s shapes, Qwen3-8B's (B = 2,
     S = 2048, H = 32, KV = 8, D = 128), granite-34b's MQA (H = 48, KV = 1,
     S = 1024), ragged S = 2047, Sq = 129 against Sk = 191 (ragged against
     the 128-row tiles) and Sq != Sk; (b) Qwen3-8B at full
     width cut to 2 layers in float32: ``prefill`` on the ``kernel`` route
     against the ``ref`` route on the same ``init`` weights (last-token
     logits and the KV cache within atol 1e-4 + rtol 1e-4); (c) Qwen3-8B at
     full width and depth (36 layers, bfloat16, random weights from a
     seeded generator), B = 2 prompts of 2,048 tokens from ``--seed``:
     with the kernel's count zeroed just before and read just after, one
     ``prefill`` on the ``kernel`` route (36 launches), then ``loss_fn``
     on the same batch (finite) and the ``ref`` route's ``prefill`` (the
     next-token logits within a relative L2 distance of 0.1), ms per
     prefill, prompt tokens/s, attention's share of the device time (a
     ``torch.profiler`` trace of one prefill) and peak memory; (d) the
     kernel's time at the main path's shape (B = 2, S = 2048, bfloat16,
     causal), its plain version's and the library call's
     (``scaled_dot_product_attention``, timed here only, never used by the
     port) beside the bound, each with its TFLOP/s and the bound's share of
     its time;
 10. the dense LM's decode and the serve loop (Qwen3-8B): (a) the
     decode-attention kernel (bfloat16 on ``mma.sync`` from a TMA-fed ring,
     the cache split into parts where B * KV leaves half the SMs idle;
     float32 on the FFMA units) against its plain version, float32 within
     2e-5 and bfloat16 within 2e-2, at ``tests/test_kernels.py``'s shapes,
     the serve shape (B = 16, S = 320, H = 32, KV = 8, D = 128),
     granite-34b's MQA (H = 48, KV = 1), ragged S = 1000 and a full
     8,192-entry ring, each with a scalar, the full and per-batch lengths;
     and at the serve shape a bfloat16 cache holding NaN at and past
     per-batch lengths, in one part and split, bitwise the clean cache's
     output; (b) Qwen3-8B at full width cut to 2 layers in float32, B = 2:
     16 decode steps on the ``kernel`` route against ``lm_forward``'s
     logits and against the ``ref`` route (logits and cache), and
     ``window_override=64`` over 100 steps (a ring of 64) against
     ``lm_forward(window=64)``, all within atol 1e-4 + rtol 1e-4; (c)
     Qwen3-8B at full width and depth in bfloat16 through the serve loop
     (``launch.serve.generate``): B = 16 prompts of 256 tokens from
     ``--seed`` stepped one token at a time, then 64 tokens generated
     greedily, with the kernel's counts zeroed just before and read just
     after (36 launches a step; the combine as often as the split plan cuts
     the cache, never at B * KV = 128), finite logits, the logits after the
     prompt within a relative L2 distance of 0.1 of ``prefill``'s (kernel
     6), the ``ref`` route teacher-forced on the generated tokens within
     0.1 at every step, ms per step, generated tokens/s, kernel 7's share
     of a traced step's device time, the top kernels and peak memory; (d)
     the kernel's, its plain version's and the library call's times
     (``scaled_dot_product_attention`` with ``enable_gqa``, timed here
     only) at decode_32k's per-layer shape (B = 128, a full 8,192-entry
     ring, bfloat16: one part) beside its bytes bound, at the serve shape
     (one part; also timed in 2) and at B = 2 with a full 8,192-entry
     ring (the cache split in 8 parts; also timed in one), with the split
     plan of each;
 11. the Scenario API at the paper's size (run after phase 8, with the
     Buzen backend set to ``kernel`` process-wide and restored after): (a)
     ``Scenario(network=Table 1 (n = 100), energy=Table 1,
     strategy=StrategySpec("time_opt", m_max=132, steps=200),
     sim=SimSpec(backend="kernel", chunk=8))`` round-trips its JSON byte for
     byte (its hash printed); (b) ``resolve_strategy`` of it equals phase
     4's ``time_optimal`` bitwise (p* and m*); (c) ``make_strategies`` over
     the six strategies (Table 1's power profile, ``steps=200``, ``m_max =
     132``), each one's wall time, m and launches logged: ``time_opt``
     bitwise phase 4's, ``energy_opt`` bitwise ``energy_optimal_routing``,
     ``joint`` exactly one sweep's Buzen launches (201 forward, 200
     backward: it reuses ``time_opt``'s tau*), and ``joint_optimal`` at 50
     steps on ``kernel`` within rtol 1e-4 of ``torch`` with the same m*;
     (d) the class ``time_opt`` on phase 8's n = 1e6 class set equals phase
     8's ``kernel`` sweep bitwise, kernels 5 and 5b launching; (e)
     ``DeviceTrainer.from_scenario`` with the scenario's ``DataSpec``
     (EMNIST fallback, Dirichlet(0.2), 47 x 200, a 0.2 test split) on the
     full-width CNN, lanes ``asyncsgd`` and ``time_opt`` x seeds 0 and 1,
     horizon 50 / lambda(p*, m*), bitwise a ``DeviceTrainer`` built by hand
     (kernels 3 and 4 launching); (f) ``examples/quickstart_torch.py`` in
     a process of its own exits 0 and prints the m* and tau* of an
     in-process ``time_optimal`` at its settings.  The counts are zeroed
     at the phase's start: kernels 1, 1b, 3, 4, 5 and 5b must each have
     launched by its end.
 12. ``ScenarioSuite`` at the paper's size (run after phase 11, reusing
     its strategies, with the Buzen backend ``kernel`` process-wide and
     restored after): (a) ``ScenarioSuite.strategy_grid`` of Table 1 (n =
     100, its energy spec, phase 11e's EMNIST ``DataSpec``, ``SimSpec(
     backend="kernel", chunk=8)``) over ``asyncsgd``, ``max_throughput``,
     ``round_opt`` and ``time_opt`` x seeds 0 and 1 (``steps=200``,
     ``m_max=132``): ``resolve()`` equals phase 11's ``make_strategies``
     bitwise; (b) ``analyze``: one program, 4 lanes, one launch of kernel 1
     for the bucket, each row within rtol 1e-4 of the same suite on the
     ``torch`` route; (c) ``simulate`` (3,000 updates after 4,000 of
     warm-up): one program, 8 lanes, every lane bitwise
     ``simulate_stats_lanes`` of its scenario alone on ``kernel`` (same
     seed, table size and chunk), each strategy's lane mean within 10% of
     Prop. 4, kernel 3 launching; (d) ``train``: the full-width CNN for
     50 / lambda* (at most 150 rounds), one trainer, 8 lanes, the logs
     bitwise ``DeviceTrainer.run_lanes`` built by hand from the same
     padded nets, clients, powers, backend and chunk, kernels 3 and 4
     launching; (e) Table 1 at scales 10, 2 and 1 (n = 9, 49, 100;
     explicit uniform routing, m = n) with phase 8's n = 1e6 class set
     (``time_opt``, bitwise phase 8's ``kernel`` sweep): ``analyze`` in
     two programs with one launch each of kernels 1 and 5, every
     per-client row bitwise its network alone at the bucket's table size
     and within rtol 1e-4 of a suite of its own (bitwise where the table
     sizes agree); ``simulate`` of the per-client three (600 after 400) in
     one program, each lane bitwise its solo run; (f) a re-run of every
     mode: ``cache_hits == len(suite)``, ``programs == 0``, no launch; (g)
     ``examples/paper_scale_sim_torch.main()`` in process (6 lanes in one
     program, within 10% of Prop. 4, its re-run a cache hit) and
     ``examples/async_fl_emnist_torch.py --horizon 20`` in a process of
     its own (exit 0, "4 lanes in 1 programs").  Each check logs its wall
     time and the launches of kernels 1, 1b, 3, 4, 5 and 5b.
 13. the lognormal and hyperexponential laws on the main path (run after
     phase 12, with the event kernels' counts zeroed just before and read
     just after): (a) for each law, 6 lanes at (p*, m*) of Table 1 (n =
     100) on ``kernel`` at E = 8, 15,000 updates after 400 (exactly
     ceil(events / 8) megastep launches, no other event kernel), their
     pooled throughput within rtol 0.06 of the port's host simulator
     ``AsyncNetworkSim`` on the same law (60,000 updates after 400), Prop.
     4 logged beside them (exact for exponential service only, not a
     gate); (b) a hyperexponential ``ScenarioSuite.simulate`` (``time_opt``
     at (p*, m*) and ``asyncsgd``, 2 seeds, 300 updates after 50, E = 8)
     on ``kernel`` bitwise the same suite on ``batched``, one program each;
     (c) the device ms per lock-step event of the lane kernel's three rate
     forms (scale, H2, lognormal) at E = 1 and 8 (6 lanes x m*, two
     ``torch.profiler`` traces, the larger).
 14. the key streams (the key-chain kernel, ``csrc/threefry.cu``, counted
     on the main path of phase 4, and in phases 7, 12 and 13): (a)
     ``jax.random``'s answers for four seeds, written here as integers
     (split, the key after 1,024 chain steps from the kernel, fold_in,
     randint, the uniform's bits), exact on the card; (b) the kernel
     bitwise its plain version on the host at phase 13's size (6 lanes x
     the events of 15,000 updates after 400, hyperexponential paths, drawn
     block by block as the stream does); (c) ``simulate_stats`` with one
     seed on the card (``kernel`` route) against the host CPU's plain
     route under three laws: discrete leaves exact, floats within ``rtol
     1e-12``; (d) the kernel's device ms per block of 1,024 events x 6
     lanes, the chain alone, the whole stream block beside the
     ``torch.Generator`` draws it replaces, its bound.

Phase 3 also holds the fused-update kernel against its plain version
(bitwise on the new parameters, ``rtol 1e-5`` on the squared norm) at
N = 408,767 and ragged sizes, float32 and bfloat16, 1 and 4 lanes; phase 5
times it at the trainer's shape (4 lanes x 408,767 float32).

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth, both at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# per DP term, two passes: mul-add and max, then mul-add, subtract, exp, add
BUZEN_OPS_PER_TERM = 8
# the MUFU unit's exp2 results per clock on one SM (Hopper)
MUFU_PER_CLOCK = 16
# published H100 SXM float64 peak outside the tensor cores at 700 W (NVIDIA
# data sheet), and the backward's float64 operations per term (an exp
# counted as one): phase A as the forward's term; phase B a mul-add and a
# subtract for the exponent, the exp, the product with g, its add and the
# mul-add of the log_rho partial
PEAK_F64_FLOPS = 34e12
BUZEN_BWD_OPS_PER_TERM = 8
# per class DP term, what the function needs: the add of series[k] and
# U[m - k], the max, the subtract, the exp and the sum (the kernel's second
# pass recomputes the add; the bound leaves that out)
CLASS_OPS_PER_TERM = 5
# the depth of the per-client lane simulations (updates after 400 of
# warm-up in phase 4, with a power profile, and in the phase-6 windows),
# cut so that the whole script, phase 8 included, stays near ten minutes
PHASE4_UPDATES = 1500
POWER_UPDATES = 300
WINDOW_UPDATES = 200
# phase 12's strategy grid on the event engine: deep enough for every
# strategy's lanes to leave their start-up transient (Prop. 4's gate), and
# its CNN lanes' round cap
SUITE_UPDATES, SUITE_WARMUP = 3000, 4000
TRAIN_CAP = 150
# phase 13's depth: the card's 6 lanes and the host simulator (updates
# after 400 of warm-up each), and its H2 suite's on each route.  At
# phase 4's 1,500 updates the H2 lanes' pooled throughput spreads 4.25%
# (one standard deviation over ten seed sets of 6 lanes, tools/
# law_spread.py on the card), too close to the 6% gate; at 15,000 it
# spreads 1.2%, and a 60,000-update host run about as much
LAW_UPDATES = 15_000
HOST_UPDATES = 60_000
SUITE_LAW_UPDATES = 300
# phase 8's class lanes at E = 1 against E = 8 and with a power profile:
# on class lanes the chunk moves only the draw cursor's window, and power
# only adds the energy integral, so short runs check both
PAIR_UPDATES = 300
# published H100 SXM dense bf16 tensor-core peak at 700 W (NVIDIA data
# sheet): the bound of the attention kernel's operations
PEAK_BF16_FLOPS = 989e12

# phase 14's known answers: jax.random on jax 0.9.0 (x64, threefry
# partitionable) for these seeds, computed where JAX is installed:
# split(k, 6), the key after 1,024 steps of the chain split(k, 6)[0],
# fold_in(k, 1) and fold_in(k, 2), randint(k, (3,), 0, 1000003) and the
# float64 bits of uniform(k, (2,))
JAX_ANSWERS = {
    0: dict(
        split6=[1797259609, 2579123966, 928981903, 3453687069, 4146024105,
            2718843009, 2467461003, 3840466878, 2285895361, 433833334,
            1524306142, 1887795613],
        chain1024=[2708596157, 547718659],
        fold12=[928981903, 3453687069, 4146024105, 2718843009],
        randint=[333962, 466642, 300875],
        uniform_bits=[4601209873087491728, 4596960885320641928],
    ),
    1: dict(
        split6=[507451445, 1853169794, 1948878966, 4237131848, 2441914641,
            3819641963, 3568232559, 2761185182, 869452973, 3597360905,
            3243370355, 1313272271],
        chain1024=[3242012521, 2967396320],
        fold12=[1948878966, 4237131848, 2441914641, 3819641963],
        randint=[295633, 633437, 147554],
        uniform_bits=[4593178043172680992, 4601845810764653408],
    ),
    42: dict(
        split6=[1832780943, 270669613, 64467757, 2916123636, 2465931498,
            255383827, 3134548294, 894150801, 2954079971, 3276725750,
            2765691542, 824333390],
        chain1024=[1462872883, 2291380616],
        fold12=[64467757, 2916123636, 2465931498, 255383827],
        randint=[887067, 284202, 871285],
        uniform_bits=[4601358860358518916, 4579806337745978368],
    ),
    4294967303: dict(
        split6=[3751178690, 325998405, 1741727090, 2326748124, 1591882673,
            3522270390, 2836227758, 3199787836, 3575481439, 1729507223,
            2152786599, 114884099],
        chain1024=[642391304, 1820099952],
        fold12=[1741727090, 2326748124, 1591882673, 3522270390],
        randint=[176036, 269114, 483935],
        uniform_bits=[4606042011437526474, 4600976952820673492],
    ),
}
# the 32-bit integer issue rate of one H100 SXM at 700 W: the guide's
# float32 rate counts an FMA as two operations on an SM's 128 float32
# lanes; an SM has 64 INT32 lanes, so a quarter of that rate
PEAK_INT32_OPS = 67e12 / 4
# integer operations of one threefry2x32: 20 rounds of add, rotate and
# xor, 5 key injections of three adds, the key schedule's two xors
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2

# the five tables, the event times and the descriptors a transition returns
TABLE_OUT = ("finish", "phase", "client", "seq", "disp_round", "t", "desc")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mega_tables(rng, K, m_max, n, has_cs, chunk, law):
    """Random megastep inputs: tables whose clocks and sequence numbers tie
    often (a lane with every clock at +inf), the scalars of ``chunk``
    events and a per-lane ``rem`` in ``[0, chunk]``.  Under the
    deterministic law every unit variate is 1 and the rates come from a
    small set, so clocks also tie after transitions."""
    import numpy as np

    phase = rng.choice(np.arange(-1, 6 if has_cs else 4),
                       size=(K, m_max)).astype(np.int32)
    phase[0] = -1
    in_service = np.isin(phase, [0, 2, 3, 5])
    finish = np.where(in_service, rng.choice([0.5, 1.0, 1.5], (K, m_max)),
                      np.inf)
    client = rng.integers(0, n, (K, m_max)).astype(np.int32)
    seq = rng.integers(0, 4, (K, m_max)).astype(np.int32)
    disp = rng.integers(0, 30, (K, m_max)).astype(np.int32)
    if law == "deterministic":
        mu_c = rng.choice([1.0, 2.0], (K, n))
        mu_u = rng.choice([1.0, 2.0], (K, n))
        fscal = np.tile([1.0, 1.0, 0.5, 0.5], (K, chunk))
    else:
        mu_c = rng.uniform(0.3, 4.0, (K, n))
        mu_u = rng.uniform(0.3, 4.0, (K, n))
        fscal = rng.exponential(size=(K, 4 * chunk))
    rem = rng.integers(0, chunk + 1, (K, 1))
    rem[1] = chunk
    iscal = np.concatenate([rng.integers(10, 20, (K, 1)),
                            rng.integers(30, 40, (K, 1)), rem,
                            rng.integers(0, n, (K, chunk))],
                           axis=1).astype(np.int32)
    return finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal


def lane_inputs(dev, net, n, rng, K, m_max, law, with_cs, power):
    """``K`` lanes at ``net``'s rates with Dirichlet routing, their power
    profile (``power`` None, ``"no_pcs"`` or ``"pcs"``), states of
    ``m_max / K`` to ``m_max`` tasks (a window of updates 4 to 24) and a
    function of ``count`` giving ``fs [K, count, W]`` and ``c_new [K,
    count]`` drawn from ``rng`` in the law's rate form (normals for the
    lognormal, the branch factors after the four scalars for the
    hyperexponential)."""
    import numpy as np
    import torch

    from repro_torch.core.energy import PowerProfile
    from repro_torch.core import prng
    from repro_torch.core.events import init_state, stack_lanes
    from repro_torch.scenario.laws import H2_FAST, H2_SLOW

    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    prms, pws, states = [], [], []
    for k in range(K):
        prm = net._replace(p=t(rng.dirichlet(np.full(n, 5.0))))
        prms.append(prm.with_cs(5.0) if with_cs else prm)
        pws.append(PowerProfile(*[t(rng.uniform(1.0, 3.0, n))
                                  for _ in range(3)],
                                P_cs=t(np.float64(2.5)) if power == "pcs"
                                else None))
        key = prng.PRNGKey(500 + k, device=dev)
        states.append(init_state(prms[-1], max(1, m_max * (k + 1) // K),
                                 key, m_max=m_max, distribution=law,
                                 warmup=4, cap=24))

    def events(count):
        unit = ((lambda: np.ones((K, count))) if law == "deterministic"
                else (lambda: rng.exponential(size=(K, count))))
        x = ((lambda: rng.normal(size=(K, count))) if law == "lognormal"
             else unit)
        cols = [x(), x(), unit() / 2.0,
                unit() / 5.0 if with_cs else np.zeros((K, count))]
        if law == "hyperexponential":
            cols += [rng.choice([H2_FAST, H2_SLOW], (K, count))
                     for _ in "uc"]
        return (t(np.stack(cols, -1)),
                t(rng.integers(0, n, (K, count))).to(torch.int32))

    return (stack_lanes(prms), None if power is None else stack_lanes(pws),
            stack_lanes(states), events)


def lane_phase3(dev, net, n, rng) -> float:
    """Phase 3's lane-kernel checks (see the module docstring); returns
    the largest absolute difference over the float leaves (0.0: bitwise)."""
    import torch

    from repro_torch.core import events as E
    from repro_torch.kernels import events as ke

    err = 0.0

    def same(got, want, what):
        nonlocal err
        for name, g, w in zip(E.EventState._fields + ("t", "desc"),
                              (*got[0], got[1], got[2]),
                              (*want[0], want[1], want[2])):
            if g.is_floating_point():
                err = max(err, float((g - w).nan_to_num().abs().max()))
            check(torch.equal(g, w), f"lane kernel vs plain ({what}): {name}")

    def run(net, n, K, m_max, law, with_cs, power, events, chunks):
        """``events`` single steps with keep masks, then megasteps of each
        chunk with per-lane rem, kernel and plain side by side from the
        same state; the kernel works in its own (donated) buffers."""
        params, pw, st, draw = lane_inputs(dev, net, n, rng, K, m_max, law,
                                           with_cs, power)
        what = f"{law}, cs={with_cs}, power={power}, n={n}, K={K}"
        want_st, mine = st, False
        fs, cn = draw(events)
        for i in range(events):
            keep = (None if i % 4 == 0 else
                    torch.as_tensor(rng.random(K) < 0.8, device=dev))
            got = ke.event_step_lanes(params, st, fs[:, i], cn[:, i],
                                      power=pw, keep=keep, donate=mine,
                                      law=law)
            want = E.event_step_lanes_plain(params, want_st, fs[:, i],
                                            cn[:, i], power=pw, keep=keep,
                                            law=law)
            torch.cuda.synchronize()
            same(got, want, f"event {i}, {what}")
            st, want_st, mine = got[0], want[0], True
        for chunk, stop, reps in chunks:
            for _ in range(reps):
                fs, cn = draw(chunk)
                rem = rng.integers(0, chunk + 1, K)
                rem[0] = chunk
                got = ke.megastep_lanes(params, st, fs, cn, rem.tolist(),
                                        power=pw, stop_on_update=stop,
                                        donate=True, law=law)
                want = E.megastep_lanes_plain(params, want_st, fs, cn,
                                              rem.tolist(), power=pw,
                                              stop_on_update=stop, law=law)
                torch.cuda.synchronize()
                same(got, want, f"chunk {chunk}, stop {stop}, {what}")
                st, want_st = got[0], want[0]
        return int(st.round.max())

    cases = [("exponential", False, None), ("exponential", True, "pcs"),
             ("deterministic", True, "no_pcs"),
             ("deterministic", False, "pcs"),
             ("hyperexponential", True, "pcs"),
             ("hyperexponential", False, None),
             ("lognormal", False, "no_pcs"), ("lognormal", True, "pcs")]
    chunks = [(1, False, 4), (7, False, 6), (7, True, 6), (32, False, 2),
              (32, True, 2)]
    rounds = [run(net, n, 6, 132, *case, 60, chunks) for case in cases]
    # n = 3,000: a lane's rows (250 KB, 320 KB with power) pass the 227 KB
    # a block may stage, so the kernel works on them in global memory
    big = net._replace(**{k: getattr(net, k).repeat(30)
                          for k in ("p", "mu_c", "mu_d", "mu_u")})
    big_chunks = [(1, False, 2), (7, False, 2), (7, True, 2), (32, False, 1),
                  (32, True, 1)]
    rounds += [run(big, 3000, 3, 40, *case, 20, big_chunks)
               for case in cases[:3] + cases[4:5] + cases[6:7]]
    # a sub-batch of lanes keeps its rows' bits
    params, pw, st, draw = lane_inputs(dev, net, n, rng, 6, 132,
                                       "exponential", False, "no_pcs")
    fs, cn = draw(8)
    full = ke.megastep_lanes(params, st, fs, cn, 8, power=pw)
    rows = slice(2, 5)

    def cut(tree):
        return type(tree)(*[None if x is None else x[rows].contiguous()
                            for x in tree])

    part = ke.megastep_lanes(cut(params), cut(st), fs[rows], cn[rows], 8,
                             power=cut(pw))
    torch.cuda.synchronize()
    check(all(torch.equal(a[rows], b) for a, b in zip(full[0], part[0]))
          and torch.equal(full[1][rows], part[1])
          and torch.equal(full[2][rows], part[2]),
          "lane kernel: a sub-batch's rows differ from the full batch's")
    log(f"phase 3: lane kernels == plain lane steps bitwise on every "
        f"EventState leaf, time and descriptor (n = {n}, m_max = 132, 6 "
        f"lanes, staged in shared memory: all four laws (the scale, H2 and "
        f"lognormal forms), CS on/off, power none / without / with P_cs on "
        f"DFMA, keep masks, chunk 1/7/32, rem < chunk, stop_on_update "
        f"on/off; n = 3000, m_max = 40, 3 lanes, in global memory: "
        f"exponential with and without CS, deterministic with CS, H2 with "
        f"CS and P_cs, lognormal without CS; a sub-batch bitwise; rounds "
        f"reached {rounds})")
    return err


def time_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn()`` between CUDA events over ``reps``
    calls (includes any time the device waits for the host's launches)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled(fn, reps: int = 1):
    """``reps`` calls of ``fn()`` under a ``torch.profiler`` trace: ``(the
    last call's result, wall ms, {kernel name: (device ms, calls)})`` over
    all the calls, both times from this one traced run (no kernels if the
    profiler recorded no device activity).  Only device activity is
    traced: a trace of the host's operations costs minutes to process for
    the lane simulation's hundreds of thousands of small operations."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message="Warning: Profiler clears")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, calls = split.get(e.key, (0.0, 0))
            split[e.key] = (ms + e.self_device_time_total / 1e3,
                            calls + e.count)
    return out, wall_ms, split


def log_top(split: dict, top: int) -> None:
    """Print the ``top`` kernels of a :func:`profiled` split by device
    time."""
    for name, (ms, calls) in sorted(split.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:10.1f} ms {calls:7d} x {name[:110]}")


def traced(fn, reps: int = 1, top: int = 0):
    """:func:`profiled`, summed: ``(the last call's result, wall ms,
    device ms)`` (device ms 0.0 if the profiler recorded no device
    activity); with ``top`` it also prints the ``top`` kernels."""
    out, wall_ms, split = profiled(fn, reps)
    log_top(split, top)
    return out, wall_ms, sum(ms for ms, _ in split.values())


def busy_share(wall_ms: float, busy_ms: float) -> str:
    """The device-busy share of one traced run, as printed."""
    if busy_ms <= 0:
        return "not measured (no device trace)"
    return (f"{busy_ms:.1f} ms of the traced run's {wall_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%)")


def device_ms(fn, reps: int) -> float:
    """Mean device time per call of ``fn()`` over a traced run of ``reps``
    calls after one untraced call: the largest of three traced runs, since
    a trace late in this long process can drop device records (seen on the
    H100: a kernel's calls missing, a library call at half its time), which
    only lowers the sum."""
    import torch

    fn()
    torch.cuda.synchronize()
    return max(traced(fn, reps)[2] for _ in range(3)) / reps


def train_phase(dev, net, n, p_star, m_star, lam_star) -> dict:
    """Phase 7 (see the module docstring); returns the fused-update
    kernel's record with its launches on this phase's main run."""
    import numpy as np
    import torch

    from repro_torch.data import (dirichlet_partition, load_emnist,
                                  train_test_split)
    from repro_torch.fl import (AsyncFLConfig, DeviceTrainer, cnn_classifier,
                                run_strategy_grid)
    from repro_torch.fl import engine as fl_engine
    from repro_torch.kernels import buzen as kb
    from repro_torch.kernels import events as ke
    from repro_torch.kernels import fused_update as kf
    from repro_torch.kernels import threefry as ktf
    from repro_torch.scenario.spec import DEFAULT_ETA

    t0 = time.perf_counter()
    train, test = train_test_split(
        load_emnist(num_classes=47, samples_per_class=200), 0.2)
    clients = [(train.x[i], train.y[i])
               for i in dirichlet_partition(train.y, n, alpha=0.2)]
    strategies = {"asyncsgd": (np.full(n, 1.0 / n), n),
                  "time_opt": (p_star.p, m_star)}
    horizon = 200.0 / lam_star
    seeds = (0, 1)
    log(f"phase 7: data ready in {time.perf_counter() - t0:.2f} s: "
        f"{len(train.y)} train / {len(test.y)} test samples over {n} "
        f"clients (sizes {min(len(y) for _, y in clients)}.."
        f"{max(len(y) for _, y in clients)}); horizon {horizon:.6g} "
        f"(200 / lambda(p*, m*={m_star}) = 200 / {lam_star:.6g})")

    def trainer(chunk):
        cfg = AsyncFLConfig(eta=DEFAULT_ETA, batch_size=32, grad_clip=5.0,
                            eval_every_time=horizon / 40)
        return DeviceTrainer(cnn_classifier(28, 47, device=dev), clients,
                             net, cfg, test_data=(test.x, test.y),
                             sim_backend="kernel", sim_chunk=chunk,
                             device=dev)

    def grid(tr, h=horizon):
        t0 = time.perf_counter()
        res = run_strategy_grid(tr.model, clients, net, strategies, tr.cfg,
                                horizon_time=h, seeds=seeds, trainer=tr)
        torch.cuda.synchronize()
        logs = [lg for name in strategies for lg in res.logs[name]]
        rounds = max(lg.updates[-1] for lg in logs) + 1
        return res, logs, rounds, time.perf_counter() - t0

    def same(a, b):
        return torch.equal(a[0].final_params, b[0].final_params) and all(
            x.times == y.times and x.losses == y.losses
            and x.accuracies == y.accuracies and x.updates == y.updates
            and x.throughput == y.throughput and x.energy == y.energy
            and np.array_equal(x.mean_delay, y.mean_delay)
            for x, y in zip(a[1], b[1]))

    tr = trainer(8)
    check(sum(p.numel() for p in tr.model.parameters()) == 408767,
          "the CNN is not at full width")
    for counted in (kb.buzen_batched, ke.event_step_lanes, ke.megastep_lanes,
                    ke.event_step_tables, ke.megastep_tables,
                    kf.fused_async_update_flat, ktf.chain_words):
        counted.launches = 0
    main = grid(tr)
    launches = {"fused_update": kf.fused_async_update_flat.launches,
                "threefry": ktf.chain_words.launches,
                "megastep": ke.megastep_lanes.launches,
                "event_step": ke.event_step_lanes.launches,
                "transition_only": ke.event_step_tables.launches
                + ke.megastep_tables.launches,
                "buzen": kb.buzen_batched.launches}
    res, logs, rounds, wall = main
    log(f"phase 7: run_strategy_grid 4 lanes (fused update, chunk 8): "
        f"{rounds} update rounds in {wall:.2f} s "
        f"({1e3 * wall / rounds:.3f} ms per round, eval included); "
        f"updates per lane {[lg.updates[-1] for lg in logs]}; launches "
        f"{launches}")
    for name, (p, m) in strategies.items():
        p = np.asarray(torch.as_tensor(p).cpu())
        for seed, lg in zip(seeds, res.logs[name]):
            log(f"phase 7: {name} (m={m}) seed {seed}: loss "
                f"{lg.losses[0]:.4f} -> {lg.losses[-1]:.4f}, accuracy "
                f"{lg.accuracies[0]:.4f} -> {lg.accuracies[-1]:.4f}, "
                f"throughput {lg.throughput:.6g}, sum p_i E0[R_i] "
                f"{float(np.sum(p * lg.mean_delay)):.4f}")
    check(launches["fused_update"] == rounds,
          f"fused update launched {launches['fused_update']} times for "
          f"{rounds} update rounds")
    check(launches["megastep"] >= rounds and launches["event_step"] == 0
          and launches["transition_only"] == 0,
          f"megastep lane kernel not on every next_update: {launches}")
    # the key chain: the events' blocks and a block of minibatch draws
    # every DRAW_BATCHES rounds
    check(launches["threefry"] >= 1 + -(-rounds // fl_engine.DRAW_BATCHES),
          f"the key-chain kernel did not draw the run's keys: {launches}")
    check(all(np.isfinite(lg.losses).all() for lg in logs),
          "a training loss is not finite")
    check(all(lg.losses[-1] < lg.losses[0] for lg in res.logs["time_opt"]),
          "a time_opt lane did not lower its loss")

    with mock.patch.object(fl_engine, "fused_async_update_flat",
                           lambda w, g, s: (w - s[:, None] * g, None)):
        plain = grid(trainer(8))
    check(same(main, plain), "training with the plain update != fused")
    ke.event_step_lanes.launches = 0
    single = grid(trainer(1))
    check(same(main, single), "training at sim_chunk 1 != sim_chunk 8")
    check(ke.event_step_lanes.launches > 0,
          "the event lane kernel did not launch at sim_chunk 1")
    log(f"phase 7: plain update ({plain[3]:.2f} s) and sim_chunk 1 "
        f"({single[3]:.2f} s, {ke.event_step_lanes.launches} event lane "
        f"kernel launches): final parameters and logs bitwise the main run's")

    # where an update round's wall time goes: each part synchronised
    tr = trainer(8)
    spent = {"next_update": 0.0, "gradients": 0.0, "apply": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    next_update = fl_engine.next_update
    fl_engine.next_update = timed(next_update, "next_update")
    tr._grad = timed(tr._grad, "gradients")
    tr._apply = timed(tr._apply, "apply")
    try:
        split = grid(tr)
    finally:
        fl_engine.next_update = next_update
    check(same(main, split), "the timed run differs from the main run")
    rounds = split[2]
    log(f"phase 7: wall ms per update round (4 lanes, each part "
        f"synchronised; {rounds} rounds, {split[3]:.2f} s in all): "
        + ", ".join(f"{k} {1e3 * v / rounds:.3f}" for k, v in spent.items())
        + f", rest {1e3 * (split[3] - sum(spent.values())) / rounds:.3f}")

    tr = trainer(8)
    window = horizon / 8
    grid(tr, window)
    torch.cuda.synchronize()
    log("phase 7: the training window's top kernels by device time:")
    (_, _, w_rounds, _), wall_ms, busy_ms = traced(
        lambda: grid(tr, window), top=8)
    log(f"phase 7: traced training window (horizon {window:.6g}, "
        f"{w_rounds} rounds): wall {wall_ms:.1f} ms, "
        f"{wall_ms / w_rounds:.3f} ms per round, device busy "
        f"{busy_share(wall_ms, busy_ms)}")
    return {"name": "fused_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_update.cu",
            "replaces": "src/repro/kernels/fused_update.py:28",
            "launches": launches["fused_update"]}


def class_rows(rng, B, counts, mu_c, with_cs, dev):
    """Kernel 5's inputs as the class sweep gives them: ``B`` rows of
    per-member log-loads over the classes of ``counts`` at random masses,
    two padded count-0 columns and, with ``with_cs``, the CS station as a
    count-1 column; random aggregated IS loads."""
    import numpy as np
    import torch

    C = len(counts)
    mass = rng.dirichlet(np.ones(C), size=B)
    lr = np.concatenate([np.log(mass / counts) - np.log(mu_c),
                         np.full((B, 2), -np.inf)], axis=1)
    cnt = np.tile(np.concatenate([counts, [0, 0]]), (B, 1))
    if with_cs:
        lr = np.concatenate([lr, np.log(rng.uniform(0.1, 1.0, (B, 1)))], 1)
        cnt = np.concatenate([cnt, np.ones((B, 1), np.int64)], 1)
    lg = np.log(rng.uniform(0.5, 3.0, B))
    return [torch.as_tensor(x, device=dev)
            for x in (lr, cnt.astype(np.float64), lg)]


def class_phase(dev, consts, net, res_k, M: int) -> tuple:
    """Phase 8 (see the module docstring); returns the records of kernel 5
    and of the class backward kernel, with their launches on this phase's
    main path and their max abs errors against their plain versions, and
    the n = 1e6 class set with its ``kernel`` sweep's result (phase 11
    resolves the same sweep through the Scenario API)."""
    import numpy as np
    import torch

    from repro_torch.core import batched as cb
    from repro_torch.core.buzen import class_log_normalizing_constants
    from repro_torch.core.complexity import round_complexity, wallclock_time
    from repro_torch.core.energy import (PowerProfile, energy_per_round,
                                         energy_per_round_classes)
    from repro_torch.core.events import expand_class_stats
    from repro_torch.core.jackson import expected_relative_delay, throughput
    from repro_torch.core.optimize import time_optimal_classes
    from repro_torch.kernels import buzen as kb
    from repro_torch.scenario.spec import PAPER_CLUSTERS_TABLE1, ClassSpec
    from repro_torch.sim import simulate_stats_classes_lanes

    rng = np.random.default_rng(8)
    base = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1)
    specs = {100: base, 10**6: ClassSpec(mu_c=base.mu_c, mu_d=base.mu_d,
                                         mu_u=base.mu_u,
                                         count=base.count * 10**4)}
    classes = {n: s.class_params(device=dev) for n, s in specs.items()}

    # -- 8.1 kernel 5 against its plain version and the float64 class DP,
    # the class backward kernel against its plain adjoint ---------------
    err_plain = err_f64 = bwd_err = 0.0
    for n, spec in specs.items():
        for with_cs in (False, True):
            lr, cnt, lg = class_rows(rng, M - 1, spec.count, spec.mu_c,
                                     with_cs, dev)
            # a generator of its own, so the shared one's draws stay as
            # they were
            g = torch.as_tensor(np.random.default_rng(n + with_cs).normal(
                size=(M - 1, M + 1)), device=dev)
            got = kb.buzen_classes_batched(lr, cnt, lg, M)
            want = kb.buzen_classes_batched_plain(lr, cnt, lg, M)
            f64 = kb.reference_class_log_Z(lr, cnt, lg, M)
            got_lr, got_lg = kb.buzen_classes_log_Z_backward(lr, cnt, lg, g,
                                                             M)
            want_lr, want_lg = kb.buzen_classes_log_Z_backward_plain(
                lr, cnt, lg, g, M)
            live = [i for i in range(cnt.shape[1])
                    if i not in (spec.C, spec.C + 1)]
            lr_u = lr[:, live].contiguous()
            cnt_u = cnt[:, live].contiguous()
            unpadded = kb.buzen_classes_batched(lr_u, cnt_u, lg, M)
            u_lr, u_lg = kb.buzen_classes_log_Z_backward(lr_u, cnt_u, lg, g,
                                                         M)
            torch.cuda.synchronize()
            e = (got - want).abs()
            check(bool((e <= 2e-5 + 2e-5 * want.abs()).all()),
                  f"class kernel vs plain (n={n}, cs={with_cs}): max err "
                  f"{float(e.max())}")
            e64 = (got.double() - f64).abs()
            check(bool((e64 <= 3e-4 + 3e-5 * f64.abs()).all()),
                  f"class kernel vs float64 DP (n={n}, cs={with_cs}): max "
                  f"err {float(e64.max())}")
            check(torch.equal(unpadded, got),
                  f"class kernel: padded != unpadded (n={n}, cs={with_cs})")
            for x, y in ((got_lr, want_lr), (got_lg, want_lg)):
                e_b = (x - y).abs()
                tol = 1e-9 * y.abs() + 1e-12 * float(y.abs().max())
                check(bool((e_b <= tol).all()), f"class backward vs plain "
                      f"(n={n}, cs={with_cs}): max err {float(e_b.max())}")
                bwd_err = max(bwd_err, float(e_b.max()))
            check(bool((got_lr[:, [spec.C, spec.C + 1]] == 0.0).all()),
                  f"class backward (n={n}, cs={with_cs}): a padded "
                  f"column's partial is not 0")
            check(torch.equal(u_lr, got_lr[:, live])
                  and torch.equal(u_lg, got_lg),
                  f"class backward (n={n}, cs={with_cs}): padded != "
                  f"unpadded on real partials")
            err_plain = max(err_plain, float(e.max()))
            err_f64 = max(err_f64, float(e64.max()))
    log(f"phase 8: class kernel == plain within 2e-5 (max abs err "
        f"{err_plain:.3g}); vs float64 class DP max abs err {err_f64:.3g} "
        f"(n = 100 and 1e6, C = 5 and 6 with CS, two padded columns, "
        f"[{M - 1} rows], m_max={M}); padded == unpadded bitwise; class "
        f"backward == plain adjoint within rtol 1e-9 (max abs err "
        f"{bwd_err:.3g}), padded partials 0, real partials bitwise the "
        f"unpadded run's")

    # -- 8.2 class closed forms == per-client forms on expand() ----------
    power_c = PowerProfile.from_dvfs(
        *[torch.as_tensor(np.array([getattr(c, k) for c in
                                    PAPER_CLUSTERS_TABLE1]), device=dev)
          for k in ("kappa", "mu_c", "P_u", "P_d")])

    def forms_agree(cp, m, label):
        prm = cp.expand()
        cnt = cp.count
        pw = PowerProfile(*[torch.repeat_interleave(x, cnt)
                            for x in power_c[:3]])
        rows = cp._replace(p=cp.p[None])
        mm = torch.tensor([m], device=dev)
        logZ = cb.batch_class_log_normalizing_constants(cp, rows.p, M,
                                                        backend="torch")
        got = {"lambda": cb.throughput_padded(logZ, mm)[0],
               "delays": torch.repeat_interleave(
                   cb.expected_relative_delay_classes(rows, mm, logZ, M)[0],
                   cnt),
               "K_eps": cb.round_complexity_classes(rows, mm, consts, logZ,
                                                    M)[0],
               "tau": cb.wallclock_time_classes(rows, mm, consts, logZ,
                                                M)[0],
               "energy/round": energy_per_round_classes(cp, power_c)}
        want = {"lambda": throughput(prm, m),
                "delays": expected_relative_delay(prm, m),
                "K_eps": round_complexity(prm, m, consts),
                "tau": wallclock_time(prm, m, consts),
                "energy/round": energy_per_round(prm, pw)}
        worst = 0.0
        for k in got:
            rel = float(((got[k] - want[k]).abs() / want[k].abs()).max())
            check(rel <= 1e-10, f"class form {k} vs per-client on expand() "
                  f"({label}): rel err {rel}")
            worst = max(worst, rel)
        return worst, got

    worst, got0 = forms_agree(classes[100], 100, "uniform p, m=100")
    check(abs(float(got0["lambda"]) - float(throughput(net, 100)))
          <= 1e-10 * float(throughput(net, 100)),
          "class lambda != phase 4's per-client lambda")
    log(f"phase 8: class closed forms at n=100, uniform p, m=100 == "
        f"per-client forms on expand() (lambda, delays, K_eps, tau, energy "
        f"per round; max rel err {worst:.3g}); lambda="
        f"{float(got0['lambda']):.12g}, tau={float(got0['tau']):.12g}")

    # -- 8.3 the class path: sweep, then simulate at the optimum ---------
    kb.buzen_classes_batched.launches = 0
    kb.buzen_classes_log_Z_backward.launches = 0
    t_main = time.perf_counter()
    sweeps = {}
    for n, cp in classes.items():
        for be in ("kernel", "torch"):
            t0 = time.perf_counter()
            res = time_optimal_classes(cp, consts, M, steps=200, backend=be)
            torch.cuda.synchronize()
            sweeps[n, be] = (res, time.perf_counter() - t0)
        (rk, sk), (rt, st) = sweeps[n, "kernel"], sweeps[n, "torch"]
        vk = np.array([v for _, v in rk.history])
        vt = np.array([v for _, v in rt.history])
        rel = np.abs(vk - vt) / np.abs(vt)
        check(bool(np.isfinite(vk).all()), f"class sweep n={n}: not finite")
        check(float(rel.max()) <= 1e-4,
              f"class sweep n={n}: kernel vs torch rel diff {rel.max()}")
        mass = (rk.p * cp.count).tolist()
        log(f"phase 8: time_optimal_classes n={n}: kernel m*={rk.m} "
            f"tau*={rk.value:.10g} ({sk:.2f} s); torch m*={rt.m} "
            f"tau*={rt.value:.10g} ({st:.2f} s); sweep max rel diff "
            f"{rel.max():.3g}; class masses p*count = "
            f"{[round(x, 6) for x in mass]}")
    sweep_launches = (kb.buzen_classes_batched.launches,
                      kb.buzen_classes_log_Z_backward.launches)
    # two sweeps on the kernel route: 200 Adam steps and the final
    # evaluation each
    check(sweep_launches == (402, 400),
          f"class sweeps' launches (forward, backward): {sweep_launches}")
    r100 = sweeps[100, "kernel"][0]
    log(f"phase 8: n=100 class optimum m*={r100.m} tau*={r100.value:.10g} "
        f"beside phase 4's per-client m*={res_k.m} tau*={res_k.value:.10g}; "
        f"kernel 5 launched {sweep_launches[0]} times and the class "
        f"backward {sweep_launches[1]} in the four sweeps")
    worst, _ = forms_agree(classes[100]._replace(p=r100.p.detach()), r100.m,
                           "p*, m*")
    log(f"phase 8: class forms == per-client forms at the class optimum "
        f"(n=100; max rel err {worst:.3g})")

    def simulate(n, cp, m, chunk, updates=2000, power=None):
        t0 = time.perf_counter()
        out = simulate_stats_classes_lanes([cp] * 6, [m] * 6, updates,
                                           warmup=400, seeds=range(6),
                                           backend="batched", chunk=chunk,
                                           power=power)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = 3 * (updates + 400) + 3 * m + 8
        log(f"phase 8: simulate_stats_classes_lanes[batched, n={n}, m={m}, "
            f"E={chunk}{', power' if power is not None else ''}] "
            f"{wall:.2f} s, {1e3 * wall / events:.4f} ms per lock-step "
            f"event")
        return out

    rbig = sweeps[10**6, "kernel"][0]
    cp_star = classes[10**6]._replace(p=rbig.p.detach())
    m_star = rbig.m
    # the throughput check on a long E = 1 run; E = 8 changes only the
    # draw cursor's window on class lanes, checked bitwise on a short pair
    e1 = simulate(10**6, cp_star, m_star, 1)
    s1 = simulate(10**6, cp_star, m_star, 1, updates=PAIR_UPDATES)
    s8 = simulate(10**6, cp_star, m_star, 8, updates=PAIR_UPDATES)
    for name, a, b in zip(s1._fields, s1, s8):
        check(torch.equal(a, b), f"class lanes E=8 != E=1 ({name})")
    logZ = class_log_normalizing_constants(cp_star, M, backend="torch")
    lam = float(torch.exp(logZ[m_star - 1] - logZ[m_star]))
    lam_sim = float(e1.throughput.mean())
    check(abs(lam_sim - lam) <= 0.10 * lam,
          f"class lanes throughput {lam_sim} vs Prop. 4 {lam}")
    np.testing.assert_allclose(e1.mean_queue_counts.sum(-1).cpu().numpy(),
                               m_star, rtol=1e-9)
    # the power run against the pair's E = 8 run: the same trajectory
    pw = simulate(10**6, cp_star, m_star, 1, updates=PAIR_UPDATES,
                  power=power_c)
    check(torch.equal(pw.throughput, s8.throughput)
          and torch.equal(pw.mean_queue_counts, s8.mean_queue_counts),
          "power changed the class trajectory")
    check(bool(torch.isfinite(pw.energy).all() and (pw.energy > 0).all()),
          f"class lanes energy {pw.energy.tolist()}")
    small = simulate(100, classes[100]._replace(p=r100.p.detach()), r100.m,
                     8, updates=POWER_UPDATES)
    ex = expand_class_stats(small, classes[100].count)
    check(ex.mean_delay.shape == (6, 100), "expand_class_stats shape")
    main_s = time.perf_counter() - t_main
    launches = (kb.buzen_classes_batched.launches,
                kb.buzen_classes_log_Z_backward.launches)
    check(launches == sweep_launches,
          f"class kernel launches on the class path: {launches}")
    log(f"phase 8: n=1e6 lanes at (p*, m*={m_star}): E = 1 and 8 bitwise on "
        f"every statistic ({PAIR_UPDATES} updates); throughput lanes "
        f"{lam_sim:.6g} vs Prop. 4 {lam:.6g}; with power the same "
        f"trajectory, energy {[round(x, 4) for x in pw.energy.tolist()]}; "
        f"class path "
        f"{main_s:.1f} s; launches {{'buzen_classes': {launches[0]}, "
        f"'buzen_classes_backward': {launches[1]}}}")
    return ({"name": "buzen_classes", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/buzen.cu",
             "replaces": "src/repro/kernels/buzen.py:230",
             "launches": launches[0], "max_abs_err": err_plain},
            {"name": "buzen_classes_backward", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/buzen.cu",
             "replaces": "src/repro/kernels/buzen.py:329",
             "launches": launches[1], "max_abs_err": bwd_err},
            specs[10**6], rbig)


def scenario_phase(dev, card: str, net, res_k, lam_star, big_spec, big_res,
                   M: int) -> dict:
    """Phase 11 (see the module docstring): the Scenario API on the card
    at the paper's size, held against phases 4 and 8 and against a
    hand-built trainer; the Buzen backend is ``kernel`` process-wide for
    the phase, restored after it.  Returns ``make_strategies``' six
    ``(p, m)`` (phase 12 holds the suite's resolution to them)."""
    import numpy as np
    import torch

    from repro_torch.core import buzen as cbz
    from repro_torch.core.energy import energy_optimal_routing, minimal_energy
    from repro_torch.core.optimize import joint_optimal, time_optimal
    from repro_torch.fl import (AsyncFLConfig, DeviceTrainer, cnn_classifier,
                                make_strategies)
    from repro_torch.kernels import buzen as kb
    from repro_torch.kernels import events as ke
    from repro_torch.kernels import fused_update as kf
    from repro_torch.kernels import threefry as ktf
    from repro_torch.scenario import (PAPER_CLUSTERS_TABLE1, STRATEGIES,
                                      DataSpec, EnergySpec, LearningSpec,
                                      NetworkSpec, Scenario, SimSpec,
                                      StrategySpec, resolve_strategy)

    t_phase = time.perf_counter()
    counted = {"buzen": kb.buzen_batched,
               "buzen_backward": kb.buzen_log_Z_backward,
               "buzen_classes": kb.buzen_classes_batched,
               "buzen_classes_backward": kb.buzen_classes_log_Z_backward,
               "event_step": ke.event_step_lanes,
               "megastep": ke.megastep_lanes,
               "fused_update": kf.fused_async_update_flat,
               "threefry": ktf.chain_words}
    for c in counted.values():
        c.launches = 0

    def since(before):
        got = {k: c.launches - before[k] for k, c in counted.items()}
        return {k: v for k, v in got.items() if v}

    def snap():
        return {k: c.launches for k, c in counted.items()}

    saved = cbz.get_backend()
    cbz.set_backend("kernel")
    try:
        # -- 11a. the scenario and its JSON --------------------------------
        scn = Scenario(
            network=NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1),
            energy=EnergySpec.from_clusters(PAPER_CLUSTERS_TABLE1),
            strategy=StrategySpec("time_opt", m_max=M, steps=200),
            sim=SimSpec(backend="kernel", chunk=8))
        text = scn.to_json()
        back = Scenario.from_json(text)
        check(back == scn and back.to_json() == text,
              "Scenario JSON round trip")
        log(f"phase 11: Scenario n={scn.n} round-trips its JSON "
            f"({len(text)} bytes) byte for byte; hash {scn.hash()}")

        # -- 11b. time_opt through the registry == phase 4's sweep ---------
        before = snap()
        t0 = time.perf_counter()
        p, m = resolve_strategy(scn, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(m == res_k.m and np.array_equal(p, res_k.p.cpu().numpy()),
              f"resolve_strategy(time_opt) m={m} != phase 4's m*={res_k.m} "
              f"or p* not bitwise")
        log(f"phase 11: resolve_strategy(time_opt) == phase 4's "
            f"time_optimal bitwise (m*={m}) in {wall:.2f} s; launches "
            f"{since(before)} ({card})")

        # -- 11c. the six strategies through make_strategies ---------------
        power = scn.power(device=dev)
        consts = scn.consts
        six = ("asyncsgd", "max_throughput", "round_opt", "time_opt",
               "energy_opt", "joint")
        spent = {}

        def timed(name, fn):
            def run(ctx):
                b = snap()
                t0 = time.perf_counter()
                out = fn(ctx)
                torch.cuda.synchronize()
                spent[name] = (time.perf_counter() - t0, since(b))
                return out
            return run

        with mock.patch.dict(STRATEGIES._entries, {
                k: timed(k, STRATEGIES.get(k)) for k in six}):
            strategies = make_strategies(net, consts, power, which=six,
                                         steps=200, m_max=M)
        for name in six:
            log(f"phase 11: make_strategies {name}: m={strategies[name][1]}"
                f", {spent[name][0]:.2f} s, launches {spent[name][1]} "
                f"({card})")
        check(strategies["time_opt"][1] == res_k.m and np.array_equal(
            strategies["time_opt"][0], res_k.p.cpu().numpy()),
            "make_strategies time_opt != phase 4's sweep")
        check(np.array_equal(strategies["energy_opt"][0],
                             energy_optimal_routing(net, power).cpu().numpy())
              and strategies["energy_opt"][1] == 1,
              "energy_opt != energy_optimal_routing")
        joint_launches = spent["joint"][1]
        check(joint_launches.get("buzen") == 201
              and joint_launches.get("buzen_backward") == 200,
              f"joint ran more than its own sweep (a second time_opt "
              f"sweep?): {joint_launches}")
        for name in six:
            p_s = strategies[name][0]
            check(bool(np.isfinite(p_s).all())
                  and abs(float(p_s.sum()) - 1.0) < 1e-9,
                  f"{name}: p not a distribution")
        # joint's sweep on kernel against torch, at 50 steps
        tau_star = float(res_k.value)
        e_star = float(minimal_energy(net, consts, power))
        sweeps = {}
        for be in ("kernel", "torch"):
            t0 = time.perf_counter()
            sweeps[be] = joint_optimal(net, consts, power, 0.1, tau_star,
                                       e_star, m_max=M, steps=50,
                                       backend=be)
            torch.cuda.synchronize()
            sweeps[be] = (sweeps[be], time.perf_counter() - t0)
        (jk, sk), (jt, st) = sweeps["kernel"], sweeps["torch"]
        vk = np.array([v for _, v in jk.history])
        vt = np.array([v for _, v in jt.history])
        rel = float((np.abs(vk - vt) / np.abs(vt)).max())
        check(bool(np.isfinite(vk).all()) and rel <= 1e-4 and jk.m == jt.m,
              f"joint sweep kernel vs torch: rel {rel}, m* {jk.m} vs {jt.m}")
        log(f"phase 11: joint_optimal (rho 0.1, m = 1..{M}, 50 steps) "
            f"kernel m*={jk.m} ({sk:.2f} s) == torch m*={jt.m} ({st:.2f} s);"
            f" sweep max rel diff {rel:.3g} (bound 1e-4)")

        # -- 11d. class time_opt through the registry == phase 8's sweep ---
        cls_scn = Scenario(network=NetworkSpec(classes=big_spec),
                           strategy=StrategySpec("time_opt", m_max=M,
                                                 steps=200))
        before = snap()
        t0 = time.perf_counter()
        p, m = resolve_strategy(cls_scn, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = since(before)
        check(m == big_res.m
              and np.array_equal(p, big_res.p.cpu().numpy()),
              f"class resolve_strategy m={m} != phase 8's m*={big_res.m} or "
              f"p* not bitwise")
        check(launched.get("buzen_classes", 0) > 0
              and launched.get("buzen_classes_backward", 0) > 0,
              f"class resolution: kernels 5/5b did not launch: {launched}")
        log(f"phase 11: class resolve_strategy(time_opt), n={cls_scn.n}, "
            f"== phase 8's kernel sweep bitwise (m*={m}) in {wall:.2f} s; "
            f"launches {launched} ({card})")

        # -- 11e. training through DeviceTrainer.from_scenario -------------
        t0 = time.perf_counter()
        train_scn = scn.replace(
            learning=LearningSpec(grad_clip=5.0),
            data=DataSpec(dataset="emnist", partition="dirichlet", alpha=0.2,
                          num_classes=47, samples_per_class=200,
                          test_fraction=0.2))
        clients, test = train_scn.data.build(train_scn.n)
        horizon = 50.0 / lam_star
        over = dict(batch_size=32, eval_every_time=horizon / 10)
        lanes = [("asyncsgd", 0), ("asyncsgd", 1), ("time_opt", 0),
                 ("time_opt", 1)]
        args = ([strategies[k][0] for k, _ in lanes],
                [strategies[k][1] for k, _ in lanes],
                [train_scn.with_strategy(k).eta() for k, _ in lanes],
                [s for _, s in lanes], horizon)
        data_s = time.perf_counter() - t0
        before = snap()
        t0 = time.perf_counter()
        tr = DeviceTrainer.from_scenario(
            train_scn, cnn_classifier(28, 47, device=dev), clients,
            test_data=test, device=dev, **over)
        logs_a, fin_a = tr.run_lanes(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = since(before)
        hand = DeviceTrainer(
            cnn_classifier(28, 47, device=dev), clients,
            train_scn.params(device=dev),
            AsyncFLConfig(eta=0.05, grad_clip=5.0, **over), test_data=test,
            power=train_scn.power(device=dev), sim_backend="kernel",
            sim_chunk=8, device=dev)
        logs_b, fin_b = hand.run_lanes(*args)
        check(torch.equal(fin_a, fin_b) and all(
            (a.times, a.losses, a.accuracies, a.updates, a.throughput,
             a.energy) == (b.times, b.losses, b.accuracies, b.updates,
                           b.throughput, b.energy)
            and np.array_equal(a.mean_delay, b.mean_delay)
            for a, b in zip(logs_a, logs_b)),
            "DeviceTrainer.from_scenario != the hand-built trainer")
        check(launched.get("megastep", 0) > 0
              and launched.get("fused_update", 0) > 0,
              f"training through from_scenario: kernels 3/4 did not launch: "
              f"{launched}")
        check(all(np.isfinite(lg.losses).all() for lg in logs_a),
              "a from_scenario training loss is not finite")
        log(f"phase 11: DeviceTrainer.from_scenario (CNN, 4 lanes asyncsgd/"
            f"time_opt x seeds 0, 1, horizon {horizon:.6g} = 50 / lambda*; "
            f"data built from its DataSpec in {data_s:.2f} s): updates per "
            f"lane {[lg.updates[-1] for lg in logs_a]}, losses "
            f"{[round(lg.losses[-1], 4) for lg in logs_a]}, {wall:.2f} s; "
            f"== the hand-built trainer bitwise; launches {launched} "
            f"({card})")
    finally:
        cbz.set_backend(saved)
    total = snap()
    check(all(total[k] > 0 for k in ("buzen", "buzen_backward",
                                     "buzen_classes",
                                     "buzen_classes_backward", "megastep",
                                     "fused_update", "threefry")),
          f"a kernel of the Scenario path never launched: {total}")

    # -- 11f. the example, in a process of its own ----------------------------
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "quickstart_torch.py")],
                         capture_output=True, text=True, timeout=600)
    ex_s = time.perf_counter() - t0
    check(out.returncode == 0,
          f"examples/quickstart_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    for line in out.stdout.strip().splitlines():
        log(f"phase 11: quickstart | {line}")
    found = re.search(r"time-optimized: m\* = (\d+), tau\* = ([0-9.]+)",
                      out.stdout)
    check(found is not None, "the example printed no m* and tau*")
    small = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10)
    want = time_optimal(small.params(device=dev), LearningSpec().consts,
                        m_max=small.n + 6, steps=200, backend="kernel")
    check(int(found.group(1)) == want.m
          and found.group(2) == f"{want.value:.1f}",
          f"the example's m*, tau* {found.groups()} != in-process "
          f"{want.m}, {want.value:.1f}")
    log(f"phase 11: examples/quickstart_torch.py exited 0 in {ex_s:.1f} s; "
        f"m*={want.m}, tau*={want.value:.1f} as in this process; launches "
        f"{total} ({card}) [{time.perf_counter() - t_phase:.1f} s]")
    return strategies


def suite_phase(dev, card: str, res_k, lam_star, strategies, big_spec,
                big_res, M: int) -> None:
    """Phase 12 (see the module docstring): ``ScenarioSuite`` on the card
    at the paper's size, held against phase 11's resolution, phase 8's
    class sweep and the port's own direct calls on the card; the Buzen
    backend is ``kernel`` process-wide for the phase, restored after
    it."""
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.core import buzen as cbz
    from repro_torch.core.buzen import pad_network
    from repro_torch.core.events import stack_lanes
    from repro_torch.core.jackson import throughput
    from repro_torch.fl import DeviceTrainer, cnn_classifier
    from repro_torch.kernels import buzen as kb
    from repro_torch.kernels import events as ke
    from repro_torch.kernels import fused_update as kf
    from repro_torch.kernels import threefry as ktf
    from repro_torch.scenario import (PAPER_CLUSTERS_TABLE1, DataSpec,
                                      EnergySpec, NetworkSpec, Scenario,
                                      ScenarioSuite, SimSpec, StrategySpec)
    from repro_torch.scenario import suite as ts
    from repro_torch.sim import simulate_stats_lanes

    t_phase = time.perf_counter()
    counted = {"buzen": kb.buzen_batched,
               "buzen_backward": kb.buzen_log_Z_backward,
               "buzen_classes": kb.buzen_classes_batched,
               "buzen_classes_backward": kb.buzen_classes_log_Z_backward,
               "event_step": ke.event_step_lanes,
               "megastep": ke.megastep_lanes,
               "fused_update": kf.fused_async_update_flat,
               "threefry": ktf.chain_words}
    for c in counted.values():
        c.launches = 0

    def snap():
        return {k: c.launches for k, c in counted.items()}

    def since(before):
        got = {k: c.launches - before[k] for k, c in counted.items()}
        return {k: v for k, v in got.items() if v}

    def timed(fn):
        before = snap()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, since(before)

    def same_stats(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in a._fields)

    def same_logs(a, b):
        return ((a.times, a.losses, a.accuracies, a.updates, a.throughput,
                 a.energy) == (b.times, b.losses, b.accuracies, b.updates,
                               b.throughput, b.energy)
                and np.array_equal(a.mean_delay, b.mean_delay))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())

    saved = cbz.get_backend()
    cbz.set_backend("kernel")
    try:
        # -- 12a. the strategy grid resolves as phase 11 did ---------------
        four = ("asyncsgd", "max_throughput", "round_opt", "time_opt")
        data = DataSpec(dataset="emnist", partition="dirichlet", alpha=0.2,
                        num_classes=47, samples_per_class=200,
                        test_fraction=0.2)
        base = Scenario(
            network=NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1),
            energy=EnergySpec.from_clusters(PAPER_CLUSTERS_TABLE1),
            data=data, sim=SimSpec(backend="kernel", chunk=8))
        suite = ScenarioSuite.strategy_grid(base, four, seeds=(0, 1),
                                            steps=200, m_max=M, device=dev)
        resolved, wall, launched = timed(suite.resolve)
        for name in four:
            check(resolved[name][1] == strategies[name][1]
                  and np.array_equal(resolved[name][0], strategies[name][0]),
                  f"suite.resolve()[{name}] != phase 11's make_strategies")
        check(resolved["time_opt"][1] == res_k.m and np.array_equal(
            resolved["time_opt"][0], res_k.p.cpu().numpy()),
            "the suite's time_opt != phase 4's sweep")
        log(f"phase 12: strategy grid (n={base.n}, {len(suite)} strategies "
            f"x 2 seeds): resolve() == phase 11's make_strategies bitwise, "
            f"m {[resolved[k][1] for k in four]} (time_opt = phase 4's "
            f"m*={res_k.m}), {wall:.2f} s; launches {launched}")

        # -- 12b. analyze: one program, one kernel-1 launch ----------------
        ana, wall, launched = timed(lambda: suite.run(mode="analyze"))
        check(ana.programs == 1 and ana.lanes == 4,
              f"analyze: {ana.programs} programs, {ana.lanes} lanes")
        check(launched.get("buzen") == 1,
              f"analyze: kernel 1 launched {launched.get('buzen')} times "
              f"for one bucket")
        cbz.set_backend("torch")
        try:
            ana_t, wall_t, _ = timed(lambda: suite.run(mode="analyze"))
        finally:
            cbz.set_backend("kernel")
        worst = 0.0
        for name in four:
            a, b = ana.entries[name], ana_t.entries[name]
            for f in ("throughput", "K_eps", "tau", "energy", "delays"):
                worst = max(worst, rel(a[f], b[f]))
            check(np.isfinite(a["tau"]) and a["delays"].shape == (base.n,),
                  f"analyze {name}: tau {a['tau']}")
        check(worst <= 1e-4, f"analyze kernel vs torch: max rel {worst}")
        log(f"phase 12: analyze 4 lanes in {ana.programs} program on "
            f"kernel ({wall:.3f} s, launches {launched}) == the torch "
            f"route ({wall_t:.3f} s) within rtol 1e-4 (max rel "
            f"{worst:.3g}); tau "
            f"{[round(ana.entries[k]['tau'], 1) for k in four]}")

        # -- 12c. simulate: one program, each lane its solo run ------------
        # (deeper than paper_scale_sim's 600 after 400: max_throughput's
        # skewed routing at m = 100 is still in its start-up transient
        # there, at two thirds of Prop. 4, so the gate would read that)
        U, W = SUITE_UPDATES, SUITE_WARMUP
        sim, wall, launched = timed(lambda: suite.run(
            mode="simulate", num_updates=U, warmup=W))
        check(sim.programs == 1 and sim.lanes == 8,
              f"simulate: {sim.programs} programs, {sim.lanes} lanes")
        check(launched.get("megastep", 0) > 0
              and launched.get("threefry", 0) > 0,
              f"simulate: kernel 3 or the key chain did not launch: "
              f"{launched}")
        m_top = max(resolved[k][1] for k in four)
        t0 = time.perf_counter()
        gaps = {}
        for name in four:
            scn = suite.scenarios[name]
            p, m = resolved[name]
            for seed, got in zip(suite.seeds, sim.entries[name]):
                alone = simulate_stats_lanes(
                    [scn.params(p, device=dev)], [m], U, warmup=W,
                    seeds=[seed], m_max=m_top, backend="kernel", chunk=8,
                    power=[scn.power(device=dev)])
                check(same_stats(stack_lanes([got]), alone),
                      f"simulate {name} seed {seed} != its solo run")
            lam = float(throughput(scn.params(p, device=dev), m))
            thr = float(np.mean([float(s.throughput)
                                 for s in sim.entries[name]]))
            gaps[name] = abs(thr - lam) / lam
            check(gaps[name] <= 0.1,
                  f"simulate {name}: throughput {thr} vs Prop. 4 {lam}")
        solo_s = time.perf_counter() - t0
        log(f"phase 12: simulate 8 lanes ({U} updates after {W}, kernel, "
            f"E = 8, m_max {m_top}) in {sim.programs} program, {wall:.2f} "
            f"s, launches {launched}; every lane == its solo "
            f"simulate_stats_lanes bitwise ({solo_s:.2f} s); throughput vs "
            f"Prop. 4 {({k: round(v, 4) for k, v in gaps.items()})}")

        # -- 12d. train: one trainer, 8 lanes, == run_lanes by hand --------
        # about 50 updates at lambda*; max_throughput runs 30x faster, so
        # its lanes are capped at TRAIN_CAP rounds
        horizon = 50.0 / lam_star
        over = dict(batch_size=32, eval_every_time=horizon / 10)
        model = cnn_classifier(28, 47, device=dev)
        tr, wall, launched = timed(lambda: suite.run(
            mode="train", model=model, horizon_time=horizon,
            max_updates=TRAIN_CAP, **over))
        check(tr.programs == 1 and tr.lanes == 8,
              f"train: {tr.programs} trainers, {tr.lanes} lanes")
        check(launched.get("megastep", 0) > 0
              and launched.get("fused_update", 0) > 0,
              f"train: kernels 3/4 did not launch: {launched}")
        clients, test = suite._client_data(base, "base")
        n = base.n
        lanes = [(k, s) for k in four for s in suite.seeds]
        hand = DeviceTrainer(cnn_classifier(28, 47, device=dev), clients,
                             pad_network(base.params(device=dev), n),
                             base.fl_config(**over), test_data=test,
                             sim_backend="kernel", sim_chunk=8, device=dev)
        t0 = time.perf_counter()
        logs_b, _ = hand.run_lanes(
            [resolved[k][0] for k, _ in lanes],
            [resolved[k][1] for k, _ in lanes],
            [suite.scenarios[k].eta() for k, _ in lanes],
            [s for _, s in lanes], horizon, max_updates=TRAIN_CAP,
            nets=[pad_network(base.params(device=dev), n)] * 8,
            lane_clients=[clients] * 8,
            lane_powers=[base.power(device=dev)] * 8)
        torch.cuda.synchronize()
        hand_s = time.perf_counter() - t0
        logs_a = [lg for k in four for lg in tr.entries[k]]
        check(all(same_logs(a, b) for a, b in zip(logs_a, logs_b)),
              "train: the suite's logs != DeviceTrainer.run_lanes by hand")
        check(all(np.isfinite(lg.losses).all() for lg in logs_a),
              "train: a loss is not finite")
        log(f"phase 12: train 8 CNN lanes (horizon {horizon:.6g} = 50 / "
            f"lambda*, at most {TRAIN_CAP} rounds) on {tr.programs} trainer "
            f"in {wall:.2f} s: updates "
            f"{[lg.updates[-1] for lg in logs_a]}; == run_lanes by hand "
            f"bitwise ({hand_s:.2f} s); launches {launched}")

        # -- 12e. a mixed population and a class set -----------------------
        per = {}
        for scale in (10, 2, 1):
            net_s = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale)
            per[f"n{net_s.n}"] = Scenario(
                network=net_s,
                strategy=StrategySpec("explicit",
                                      p=np.full(net_s.n, 1.0 / net_s.n),
                                      m=net_s.n),
                sim=SimSpec(backend="kernel", chunk=8))
        cls_scn = Scenario(network=NetworkSpec(classes=big_spec),
                           strategy=StrategySpec("time_opt", m_max=M,
                                                 steps=200))
        mixed = ScenarioSuite({**per, "classes": cls_scn}, seeds=(0,),
                              device=dev)
        res_m, wall_r, _ = timed(mixed.resolve)
        check(res_m["classes"][1] == big_res.m and np.array_equal(
            res_m["classes"][0], big_res.p.cpu().numpy()),
            "the suite's class time_opt != phase 8's kernel sweep")
        ana_m, wall, launched = timed(lambda: mixed.run(mode="analyze"))
        check(ana_m.programs == 2, f"mixed analyze: {ana_m.programs} programs")
        check(launched.get("buzen") == 1
              and launched.get("buzen_classes") == 1,
              f"mixed analyze: one launch of kernels 1 and 5 each, got "
              f"{launched}")
        table = max(res_m[k][1] for k in per)
        drift = {}
        for name, scn in per.items():
            p, m = res_m[name]
            row = ana_m.entries[name]
            # the padding contract: the row is its network alone, unpadded,
            # at the bucket's table size, bitwise
            fn = ts._build_analyze(table, False, False)
            alone = fn(stack_lanes([scn.params(p, device=dev)]),
                       torch.tensor([m], device=dev),
                       ts._stack_consts([scn.consts], dev), None,
                       torch.zeros(1, dtype=torch.float64, device=dev))
            check(all(row[f] == float(alone[f][0])
                      for f in ("throughput", "K_eps", "tau"))
                  and np.array_equal(row["delays"],
                                      alone["delays"][0].cpu().numpy()),
                  f"mixed analyze {name} != its network alone at m_max "
                  f"{table}")
            solo = ScenarioSuite({name: scn}, device=dev).run(
                mode="analyze")
            s_row = solo.entries[name]
            if m == table:
                check(s_row["tau"] == row["tau"] and np.array_equal(
                    s_row["delays"], row["delays"]),
                    f"mixed analyze {name} != a suite of its own")
            drift[name] = max(rel(s_row[f], row[f])
                              for f in ("throughput", "K_eps", "tau",
                                        "delays"))
            check(drift[name] <= 1e-4,
                  f"mixed analyze {name} vs a suite of its own: "
                  f"{drift[name]}")
        crow = ana_m.entries["classes"]
        check(np.isfinite(crow["tau"]) and crow["m"] == big_res.m
              and crow["delays"].shape == (big_spec.C,),
              f"class analyze row {crow['tau']}, m {crow['m']}")
        log(f"phase 12: mixed suite n = {list(per)} + classes (n = "
            f"{cls_scn.n}): class time_opt == phase 8 bitwise (m*="
            f"{res_m['classes'][1]}, {wall_r:.2f} s); analyze "
            f"{ana_m.programs} programs in {wall:.3f} s, launches "
            f"{launched}; each per-client row == its network alone at m_max "
            f"{table} bitwise; against a suite of its own (its own m_max) "
            f"max rel {drift} (bound 1e-4; bitwise at m = {table})")
        per_suite = ScenarioSuite(per, seeds=(0,), device=dev)
        U, W = 600, 400  # paper_scale_sim's depth: bitwise checks only
        sim_m, wall, launched = timed(lambda: per_suite.run(
            mode="simulate", num_updates=U, warmup=W))
        check(sim_m.programs == 1 and sim_m.lanes == 3,
              f"mixed simulate: {sim_m.programs} programs")
        for name, scn in per.items():
            p, m = res_m[name]
            alone = simulate_stats_lanes(
                [scn.params(p, device=dev)], [m], U, warmup=W, seeds=[0],
                m_max=table, backend="kernel", chunk=8)
            check(same_stats(stack_lanes(sim_m.entries[name]), alone),
                  f"mixed simulate {name} != its solo run")
        log(f"phase 12: mixed simulate 3 lanes (n padded to "
            f"{max(s.n for s in per.values())}) in {sim_m.programs} program, "
            f"{wall:.2f} s, launches {launched}; each lane == its solo run "
            f"at m_max {table} bitwise")

        # -- 12f. re-runs come from the caches -----------------------------
        for what, s_, mode, kw in (
                ("grid", suite, "analyze", {}),
                ("grid", suite, "simulate",
                 dict(num_updates=SUITE_UPDATES, warmup=SUITE_WARMUP)),
                ("grid", suite, "train",
                 dict(model=model, horizon_time=horizon,
                      max_updates=TRAIN_CAP, **over)),
                ("mixed", mixed, "analyze", {}),
                ("per-client", per_suite, "simulate",
                 dict(num_updates=U, warmup=W))):
            again, wall, launched = timed(lambda: s_.run(mode=mode, **kw))
            check(again.cache_hits == len(s_) and again.programs == 0
                  and not launched,
                  f"re-run {what} {mode}: {again.cache_hits} hits, "
                  f"{again.programs} programs, launches {launched}")
        log(f"phase 12: re-runs of every mode: cache_hits == len(suite), "
            f"programs 0, no launch; counters "
            f"{suite.metrics.snapshot()['counters']}")
    finally:
        cbz.set_backend(saved)
    total = snap()
    check(all(total[k] > 0 for k in ("buzen", "buzen_classes", "megastep",
                                     "fused_update")),
          f"a kernel of the suite path never launched: {total}")

    # -- 12g. the examples -------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "paper_scale_sim_torch",
        ROOT / "examples" / "paper_scale_sim_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got, wall, launched = timed(lambda: mod.main(device=dev))
    check(got["lanes"] == 6 and got["programs"] == 1
          and got["cache_hits"] == 1
          and abs(got["throughput"] - got["closed_form"])
          <= 0.1 * got["closed_form"],
          f"paper_scale_sim_torch.main(): {got}")
    log(f"phase 12: paper_scale_sim_torch.main() (n={got['n']}, m={got['m']},"
        f" 6 lanes, {got['backend']}) in {wall:.2f} s: throughput "
        f"{got['throughput']:.4f} vs Prop. 4 {got['closed_form']:.4f}; "
        f"launches {launched}")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "async_fl_emnist_torch.py"),
                          "--horizon", "20"],
                         capture_output=True, text=True, timeout=600)
    ex_s = time.perf_counter() - t0
    check(out.returncode == 0,
          f"examples/async_fl_emnist_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    for line in out.stdout.strip().splitlines():
        log(f"phase 12: async_fl_emnist | {line}")
    found = re.search(r"lane trainer on cuda: (\d+) lanes in (\d+) programs",
                      out.stdout)
    check(found is not None and found.groups() == ("4", "1"),
          "the EMNIST example printed no '4 lanes in 1 programs' line")
    log(f"phase 12: examples/async_fl_emnist_torch.py --horizon 20 exited 0 "
        f"in {ex_s:.1f} s; launches {total} ({card}) "
        f"[{time.perf_counter() - t_phase:.1f} s]")


def laws_phase(dev, card: str, net, n: int, p_star, m_star: int,
               lam_star: float) -> None:
    """Phase 13 (see the module docstring): the lognormal and
    hyperexponential laws on the main path at the paper's size, their lane
    kernel instantiations' device time beside the scale form's."""
    import numpy as np
    import torch

    from repro_torch.core import prng
    from repro_torch.core.events import (DRAW_EVENTS, EventState,
                                         EventStream, event_key, init_state,
                                         stack_lanes)
    from repro_torch.core.simulator import AsyncNetworkSim
    from repro_torch.kernels import events as ke
    from repro_torch.kernels import threefry as ktf
    from repro_torch.scenario import (NetworkSpec, Scenario, ScenarioSuite,
                                      SimSpec, StrategySpec)
    from repro_torch.sim import simulate_stats_lanes

    t_phase = time.perf_counter()
    counted = (ke.event_step_lanes, ke.megastep_lanes, ke.event_step_tables,
               ke.megastep_tables)
    for c in counted + (ktf.chain_words,):
        c.launches = 0
    U, W = LAW_UPDATES, 400
    events = 3 * (U + W) + 3 * m_star + 8
    for law in ("hyperexponential", "lognormal"):
        # -- 13a. 6 lanes at (p*, m*) on the kernel route, E = 8 ------------
        before = [c.launches for c in counted]
        chains = ktf.chain_words.launches
        t0 = time.perf_counter()
        st = simulate_stats_lanes([p_star] * 6, [m_star] * 6, U, warmup=W,
                                  seeds=range(6), distribution=law,
                                  backend="kernel", chunk=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [c.launches - b for c, b in zip(counted, before)]
        check(got == [0, -(-events // 8), 0, 0],
              f"simulate[{law}, kernel, E=8]: launches (event lanes, "
              f"megastep lanes, event, megastep) {got}")
        chains = ktf.chain_words.launches - chains
        check(chains == -(-events // DRAW_EVENTS),
              f"simulate[{law}]: {chains} key-chain launches for "
              f"{events} events of 6 lanes")
        check(bool(torch.isfinite(st.mean_delay).all()
                   and (st.updates == U).all()),
              f"simulate[{law}]: updates {st.updates.tolist()}")
        # pooled over the lanes: the updates over the summed horizon
        thr = float(st.updates.sum() / st.time.sum())
        t0 = time.perf_counter()
        host = AsyncNetworkSim(p_star, m_star, distribution=law,
                               seed=7).run(HOST_UPDATES, warmup=W)
        host_s = time.perf_counter() - t0
        rel = abs(thr - host.throughput) / host.throughput
        check(rel <= 0.06, f"{law}: the card's lanes' throughput {thr} vs "
              f"the host simulator's {host.throughput} (rel {rel:.4f})")
        log(f"phase 13: {law}: 6 lanes x {U} updates after {W} at (p*, "
            f"m*={m_star}) on kernel, E = 8: {wall:.2f} s, "
            f"{1e3 * wall / events:.4f} ms per lock-step event, "
            f"{got[1]} megastep launches; throughput {thr:.6g} vs "
            f"AsyncNetworkSim {host.throughput:.6g} ({HOST_UPDATES} "
            f"updates after {W}, {host_s:.2f} s): rel {rel:.4f} (gate "
            f"0.06); Prop. 4 (exact for exponential service only) "
            f"{lam_star:.6g}: card {thr / lam_star - 1:+.4f}, host "
            f"{host.throughput / lam_star - 1:+.4f}")

    # -- 13b. an H2 ScenarioSuite on kernel == the same suite on batched ---
    spec = NetworkSpec(mu_c=net.mu_c.tolist(), mu_d=net.mu_d.tolist(),
                       mu_u=net.mu_u.tolist(), law="hyperexponential")
    scns = {"time_opt": Scenario(network=spec, strategy=StrategySpec(
                "explicit", p=p_star.p.tolist(), m=m_star),
                sim=SimSpec(chunk=8)),
            "asyncsgd": Scenario(network=spec,
                                 strategy=StrategySpec("asyncsgd"),
                                 sim=SimSpec(chunk=8))}
    out = {}
    for be in ("kernel", "batched"):
        before = ke.megastep_lanes.launches
        t0 = time.perf_counter()
        out[be] = ScenarioSuite(scns, seeds=(0, 1), device=dev).run(
            mode="simulate", num_updates=SUITE_LAW_UPDATES, warmup=50,
            backend=be)
        torch.cuda.synchronize()
        out[be + "_s"] = time.perf_counter() - t0
        out[be + "_launches"] = ke.megastep_lanes.launches - before
        check(out[be].programs == 1 and out[be].lanes == 4,
              f"H2 suite[{be}]: {out[be].programs} programs, "
              f"{out[be].lanes} lanes")
    check(out["kernel_launches"] > 0 and out["batched_launches"] == 0,
          f"H2 suite: megastep launches {out['kernel_launches']} on kernel, "
          f"{out['batched_launches']} on batched")
    for name in scns:
        for a, b in zip(out["kernel"].entries[name],
                        out["batched"].entries[name]):
            check(all(torch.equal(getattr(a, f), getattr(b, f))
                      for f in a._fields),
                  f"H2 suite: {name} on kernel != batched")
    log(f"phase 13: H2 ScenarioSuite.simulate (time_opt m={m_star} and "
        f"asyncsgd m={n}, 2 seeds, {SUITE_LAW_UPDATES} updates after 50, "
        f"E = 8): one program, 4 lanes, kernel ({out['kernel_s']:.2f} s, "
        f"{out['kernel_launches']} megastep launches) == batched "
        f"({out['batched_s']:.2f} s) bitwise on every lane")
    counts = [c.launches for c in counted]
    check(counts[1] > 0 and counts[2] == 0 and counts[3] == 0,
          f"phase 13's launches (event lanes, megastep lanes, event, "
          f"megastep): {counts}")

    # -- 13c. device ms of each law form's lane kernel, E = 1 and 8 --------
    lane_params = stack_lanes([p_star] * 6)
    forms = {"exponential": "0", "hyperexponential": "1", "lognormal": "2"}
    per_event = {}
    for chunk, reps in ((1, 200), (8, 50)):
        calls = []
        for law in forms:
            keys = prng.seed_keys(range(900, 906), device=dev)
            st = stack_lanes([init_state(p_star, m_star, k, m_max=m_star,
                                         distribution=law) for k in keys])
            own = EventState(*[x.clone() for x in st])
            fs, cn, _ = EventStream([p_star] * 6, event_key(keys),
                                    distribution=law).window(chunk)
            if chunk == 1:
                calls.append(lambda s=own, f=fs[:, 0], c=cn[:, 0], lw=law:
                             ke.event_step_lanes(lane_params, s, f, c,
                                                 donate=True, law=lw))
            else:
                calls.append(lambda s=own, f=fs, c=cn, lw=law:
                             ke.megastep_lanes(lane_params, s, f, c, 8,
                                               donate=True, law=lw))

        def run(calls=calls, reps=reps):
            for fn in calls:
                for _ in range(reps):
                    fn()

        run()
        torch.cuda.synchronize()
        best = {}
        for _ in range(2):  # the larger of two traces (records may drop)
            for name, (ms, k) in profiled(run)[2].items():
                if "lanes_kernel" in name:
                    form = re.search(r"(\d)>", name).group(1)
                    best[form] = max(best.get(form, (0.0, 0)), (ms, k))
        for law, form in forms.items():
            ms, k = best.get(form, (0.0, 0))
            per_event[(law, chunk)] = (ms / k / chunk if k
                                       else float("nan"))
    log(f"phase 13: lane kernel device ms per lock-step event (6 lanes x "
        f"m*={m_star}, n={n}, one launch retires E events; {card}): "
        + ", ".join(f"{law} E={e} {v:.6f}"
                    for (law, e), v in per_event.items()))
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


def keys_phase(dev, card: str, p_star, m_star: int, main_launches: int,
               sm_clock_mhz: float) -> dict:
    """Phase 14 (see the module docstring): the key streams.  Returns the
    key-chain kernel's record."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.events import (DRAW_EVENTS, _unit_scalars,
                                         block_paths, blocks_from_words,
                                         event_key, simulate_stats)
    from repro_torch.core.numerics import seqcumsum
    from repro_torch.kernels import threefry as ktf

    t_phase = time.perf_counter()
    # -- 14a. jax.random's known answers on the card ----------------------
    for seed, want in JAX_ANSWERS.items():
        key = prng.PRNGKey(seed, device=dev)
        chain, _ = ktf.chain_words(key[None], 1024,
                                   ktf.paths_tensor([(1, 0)], dev))
        folds = torch.stack([prng.fold_in(key, 1), prng.fold_in(key, 2)])
        got = dict(
            split6=prng.split(key, 6).reshape(-1).tolist(),
            chain1024=chain[0, -1].tolist(),
            fold12=folds.reshape(-1).tolist(),
            randint=prng.randint(key, (3,), 0, 1000003).tolist(),
            uniform_bits=prng.uniform(key, (2,)).view(torch.int64).tolist())
        check(got == want, f"jax.random known answers, seed {seed}: {got}")
    log(f"phase 14: jax.random's known answers for seeds "
        f"{list(JAX_ANSWERS)} exact on the card (split, the 1,024-step "
        f"chain from the kernel, fold_in, randint, uniform)")

    # -- 14b. the kernel == its plain version at phase 13's size ----------
    events = 3 * (LAW_UPDATES + 400) + 3 * m_star + 8
    paths_h2 = ktf.paths_tensor(block_paths("hyperexponential", False)[0],
                                dev)
    keys = event_key(prng.seed_keys(range(6), device=dev))
    t0 = time.perf_counter()
    start, chains, words = keys, [], []
    for lo in range(0, events, DRAW_EVENTS):  # as the stream draws them
        c, w = ktf.chain_words(start, min(DRAW_EVENTS, events - lo),
                               paths_h2)
        chains.append(c)
        words.append(w)
        start = c[:, -1]
    chain_k, words_k = torch.cat(chains, 1).cpu(), torch.cat(words, 1).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain_p, words_p = ktf.chain_words_plain(keys.cpu(), events,
                                             paths_h2.cpu())
    plain_s = time.perf_counter() - t0
    check(torch.equal(chain_k, chain_p) and torch.equal(words_k, words_p),
          "the key-chain kernel != its plain version at phase 13's size")
    log(f"phase 14: key-chain kernel == plain bitwise: 6 lanes x {events} "
        f"events ({len(chains)} blocks of {DRAW_EVENTS}, "
        f"{paths_h2.shape[0]} hyperexponential paths an event): card "
        f"{card_s:.2f} s with the copies, plain on the host {plain_s:.2f} s")

    # -- 14c. same seed: simulate_stats on the card == on the host CPU ----
    U, W = 300, 50
    cpu_net = type(p_star)(*[None if x is None else x.cpu()
                             for x in p_star])
    for law in ("exponential", "hyperexponential", "lognormal"):
        kw = dict(warmup=W, seed=11, distribution=law, backend="kernel",
                  chunk=8)
        card_stats = simulate_stats(p_star, m_star, U, **kw)
        host = simulate_stats(cpu_net, m_star, U, **kw)
        for name, a, b in zip(host._fields, card_stats, host):
            a = a.cpu()
            if b.dtype.is_floating_point:
                ok = bool(torch.isclose(a, b, rtol=1e-12, atol=1e-12).all())
            else:
                ok = torch.equal(a, b)
            check(ok, f"simulate_stats[{law}] card != host CPU: {name}")
        log(f"phase 14: simulate_stats[{law}, seed 11] at (p*, "
            f"m*={m_star}), {U} updates after {W}: card (kernel route) == "
            f"host CPU (plain route): discrete leaves exact, floats within "
            f"rtol 1e-12 (throughput {float(card_stats.throughput):.10g})")

    # -- 14d. times at the main path's block: 6 lanes x DRAW_EVENTS -------
    paths_e = ktf.paths_tensor(block_paths("exponential", False)[0], dev)
    n_ev = DRAW_EVENTS
    ms = time_ms(lambda: ktf.chain_words(keys, n_ev, paths_e), 50)
    ms_h2 = time_ms(lambda: ktf.chain_words(keys, n_ev, paths_h2), 50)
    no_paths = ktf.paths_tensor([], dev)
    chain_ms = time_ms(lambda: ktf.chain_words(keys, n_ev, no_paths), 50)
    host_keys, host_paths = keys.cpu(), paths_e.cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        ktf.chain_words_plain(host_keys, n_ev, host_paths)
    plain_ms = 1e3 * (time.perf_counter() - t0) / 3

    # the whole block draw of the stream on the card (the kernel, the
    # uniforms and the law's variates, the routing), per law, beside the
    # generator draws it replaces (one generator a lane: the routing
    # uniforms, then the downlink, uplink and computation exponentials)
    prefixes = [seqcumsum(p_star.p)] * 6

    def stream_block(law, paths):
        _, words = ktf.chain_words(keys, n_ev, paths)
        _unit_scalars(blocks_from_words([p_star] * 6, words,
                                        distribution=law,
                                        route_prefixes=prefixes), law)

    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(6)]

    def generator_block():
        for g in gens:
            torch.rand(n_ev, generator=g, dtype=torch.float64, device=dev)
            for _ in range(3):
                torch.empty(n_ev, dtype=torch.float64,
                            device=dev).exponential_(generator=g)

    stream_ms = {law: time_ms(lambda: stream_block(law, ktf.paths_tensor(
        block_paths(law, False)[0], dev)), 20)
        for law in ("exponential", "hyperexponential", "lognormal")}
    gen_ms = time_ms(generator_block, 20)
    P = paths_e.shape[0]
    hashes = 6 * n_ev * (1 + sum(1 + int((row[1:] >= 0).sum())
                                 for row in paths_e.cpu()))
    bound_ops = hashes * THREEFRY_OPS / PEAK_INT32_OPS
    bound_bytes = (6 * 2 * 8 + P * 4 * 4 + 6 * n_ev * 2 * 8
                   + 6 * n_ev * P * 2 * 8) / PEAK_BYTES
    floor_ms = 1e3 * n_ev * THREEFRY_OPS * 4 / (1e6 * sm_clock_mhz)
    log(f"phase 14: key-chain kernel, 6 lanes x {n_ev} events: "
        f"{ms:.4f} ms a block (exponential, {P} paths), {ms_h2:.4f} ms "
        f"(hyperexponential, {paths_h2.shape[0]} paths), {chain_ms:.4f} ms "
        f"the chain alone; plain on the host {plain_ms:.2f} ms; bound "
        f"{1e3 * max(bound_ops, bound_bytes):.6f} ms "
        f"({'operations' if bound_ops >= bound_bytes else 'bytes'}); the "
        f"chain's latency floor at 4 cycles an operation {floor_ms:.4f} ms; "
        f"a whole stream block (kernel + conversions + routing) "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stream_ms.items())
        + f" beside {gen_ms:.3f} ms for the torch.Generator draws it "
        f"replaces; {card}")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "threefry_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry.cu",
        "replaces": "src/repro/core/events.py:236 (XLA's threefry2x32 "
                    "through jax.random.split; no Pallas kernel)",
        "launches": main_launches, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": 1e3 * max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None}


def lm_phase(dev, card: str, seed: int) -> dict:
    """Phase 9 (see the module docstring); returns kernel 6's record with
    its launches on one full-depth prefill."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import build_model
    from repro_torch.models.lm import tree_map

    def n_params(tree):
        sizes = []
        tree_map(lambda x: sizes.append(x.numel()), tree)
        return sum(sizes)

    t_phase = time.perf_counter()
    # the plain version and the "ref" route hold the kernel to float32
    # products: no TF32 in any matrix product
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matrix products are not full float32")
    log("phase 9: torch.backends.cuda.matmul.allow_tf32 = False, "
        "float32 matmul precision 'highest'")
    gen = torch.Generator(device=dev).manual_seed(seed)

    # -- 9a. kernel 6 against its plain version -----------------------------
    shapes = [(1, 128, 128, 4, 4, 64), (2, 100, 100, 8, 2, 64),
              (1, 33, 257, 4, 1, 128),     # tests/test_kernels.py
              (2, 2048, 2048, 32, 8, 128),  # Qwen3-8B
              (2, 1024, 1024, 48, 1, 128),  # granite-34b, MQA
              (1, 2047, 2047, 32, 8, 128),  # ragged
              (1, 129, 191, 4, 1, 128),     # ragged against 128-row tiles
              (1, 300, 700, 8, 2, 128)]     # Sq != Sk
    # bfloat16 also with q and k at 4x unit scale: peaked softmaxes
    kinds = ((torch.float32, 1.0, 2e-5), (torch.bfloat16, 1.0, 2e-2),
             (torch.bfloat16, 4.0, 2e-2))
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, Sq, Sk, H, KV, D in shapes:
        for dtype, scale, tol in kinds:
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       for shape in ((B, Sq, H, D), (B, Sk, KV, D),
                                     (B, Sk, KV, D)))
            q, k, v = (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)
            for causal, window in ((True, None), (True, 512), (False, None)):
                got = kfa.flash_attention(q, k, v, causal=causal,
                                          window=window).float()
                want = kfa.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window).float()
                torch.cuda.synchronize()
                e = (got - want).abs()
                check(bool((e <= tol + tol * want.abs()).all()),
                      f"flash attention kernel vs plain ({dtype}, x{scale}, "
                      f"{(B, Sq, Sk, H, KV, D)}, causal={causal}, "
                      f"window={window}): max err {float(e.max())}")
                err[dtype] = max(err[dtype], float(e.max()))
    log(f"phase 9: flash attention kernel == plain ({len(shapes)} shapes x "
        f"3 masks, float32 and bfloat16 at 1x and 4x input scale; max abs "
        f"err float32 {err[torch.float32]:.3g} (bound 2e-5), bfloat16 "
        f"{err[torch.bfloat16]:.3g} (bound 2e-2)) "
        f"[{time.perf_counter() - t_phase:.1f} s]")

    rng = np.random.default_rng(seed)
    B, S = 2, 2048

    def batch_for(cfg):
        toks = rng.integers(0, cfg.vocab, (2, B, S))
        return {"tokens": torch.as_tensor(toks[0], device=dev),
                "targets": torch.as_tensor(toks[1], device=dev)}

    # -- 9b. full width, 2 layers, float32: kernel route == ref route -------
    cfg2 = dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                               dtype="float32", param_dtype="float32")
    ker2 = build_model(cfg2, attention_impl="kernel", device=dev)
    ref2 = build_model(cfg2, device=dev)
    params = ker2.init(gen)
    batch = batch_for(cfg2)
    (lk, ck), (lr, cr) = ker2.prefill(params, batch), ref2.prefill(params,
                                                                   batch)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in (("logits", lk, lr),
                       ("cache k", ck["groups"]["slot0"].k,
                        cr["groups"]["slot0"].k),
                       ("cache v", ck["groups"]["slot0"].v,
                        cr["groups"]["slot0"].v)):
        e = (a - b).abs()
        check(bool((e <= 1e-4 + 1e-4 * b.abs()).all()),
              f"Qwen3-8B 2 layers float32: kernel vs ref {name} max err "
              f"{float(e.max())}")
        worst = max(worst, float(e.max()))
    log(f"phase 9: Qwen3-8B full width x 2 layers, float32 "
        f"({n_params(params)} parameters), B = {B}, "
        f"S = {S}: prefill kernel route == ref route (last-token logits, "
        f"cache k and v; max abs err {worst:.3g}, bound atol 1e-4 + rtol "
        f"1e-4)")
    del params, lk, ck, lr, cr
    torch.cuda.empty_cache()

    # -- 9c. full width and depth, bfloat16 ---------------------------------
    cfg = get_config("qwen3-8b")
    ker = build_model(cfg, attention_impl="kernel", device=dev)
    ref = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = ker.init(gen)
    torch.cuda.synchronize()
    count = n_params(params)
    check(cfg.n_layers == 36 and cfg.d_model == 4096
          and params["groups"]["slot0"]["ffn_dense"]["w_up"].shape
          == (36, 4096, 12288), "Qwen3-8B not at full width and depth")
    log(f"phase 9: Qwen3-8B at full width and depth ({cfg.n_layers} "
        f"layers), {count} bfloat16 parameters "
        f"({2 * count / 1e9:.2f} GB), drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = batch_for(cfg)
    ker.prefill(params, batch)  # warm: cuBLAS picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = ker.prefill(params, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = kfa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == cfg.n_layers,
          f"flash attention launched {launches} times in one prefill")
    check(logits.shape == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    kc = cache["groups"]["slot0"].k
    check(kc.shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
          and kc.dtype == torch.bfloat16, f"cache k {tuple(kc.shape)}")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        ker.prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / reps
    loss, _ = ker.loss_fn(params, batch)
    check(bool(torch.isfinite(loss)), f"loss_fn {float(loss)}")
    want, _ = ref.prefill(params, batch)
    torch.cuda.synchronize()
    rel = float((logits - want).norm() / want.norm())
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    check(rel <= 0.1, f"kernel vs ref next-token logits: relative L2 {rel}")
    _, wall_ms, split = profiled(lambda: ker.prefill(params, batch))
    busy = sum(ms for ms, _ in split.values())
    attn = sum(ms for name, (ms, _) in split.items()
               if "flash_wgmma_kernel" in name or "flash_kernel" in name)
    gemm = sum(ms for name, (ms, _) in split.items()
               if any(w in name for w in ("nvjet", "gemm", "cutlass")))
    log("phase 9: one prefill's top kernels by device time:")
    log_top(split, 8)
    share = (f"{attn:.2f} ms of {busy:.2f} ms device time "
             f"({100 * attn / busy:.1f}%), matrix products {gemm:.2f} ms, "
             f"the rest {busy - attn - gemm:.2f} ms" if busy > 0
             else "not measured (no device trace)")
    log(f"phase 9: prefill B = {B} x S = {S} on the kernel route: "
        f"{prefill_ms:.2f} ms per prefill (mean of {reps}; the counted one "
        f"{first_ms:.2f} ms), {B * S / (prefill_ms / 1e3):.1f} prompt "
        f"tokens/s, peak memory {peak:.2f} GB; flash attention launches "
        f"{launches}; attention {share}; traced wall {wall_ms:.2f} ms; "
        f"loss_fn {float(loss):.6f}; ref route next-token logits relative "
        f"L2 {rel:.4g} (bound 0.1), argmax agreement {agree:.3f} ({card})")
    del params, logits, cache, want
    torch.cuda.empty_cache()

    # -- 9d. kernel 6's times at the main path's shape ----------------------
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).bfloat16()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    window = cfg.sliding_window  # as prefill passes it; >= S, so causal
    calls = {
        "kernel": (lambda: kfa.flash_attention(q, k, v, window=window), 20),
        "plain": (lambda: kfa.flash_attention_plain(q, k, v, window=window),
                  3),
        "library": (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)}
    lib = calls["library"][0]().transpose(1, 2).float()
    e = (lib - calls["kernel"][0]().float()).abs()
    check(bool((e <= 2e-2 + 2e-2 * lib.abs()).all()),
          f"the library call disagrees with the kernel: {float(e.max())}")

    times = {name: (device_ms(fn, r), time_ms(fn, r))
             for name, (fn, r) in calls.items()}
    ops = 4 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)
    bound_ops = 1e3 * ops / PEAK_BF16_FLOPS
    bound_bytes = 1e3 * nbytes / PEAK_BYTES
    _, _, lib_split = profiled(calls["library"][0], 10)
    log("phase 9: the library call's kernels (10 calls traced):")
    log_top(lib_split, 4)
    log(f"phase 9: flash attention q [{B}x{S}x{H}x{D}], k/v "
        f"[{B}x{S}x{KV}x{D}] bfloat16, causal: "
        + "; ".join(f"{name} device {d:.4f} ms / between events {w:.4f} ms"
                    for name, (d, w) in times.items())
        + f"; bound {max(bound_ops, bound_bytes):.6f} ms ({ops / 1e9:.2f} "
        f"GFLOP at 989 TFLOP/s {bound_ops:.6f} ms, {nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s {bound_bytes:.6f} ms); library vs kernel max abs err "
        f"{float(e.max()):.3g} ({card}); the record's ms are between-event "
        f"times")
    bound = max(bound_ops, bound_bytes)
    for name, (d, w) in times.items():
        on_device = (f" ({ops / d / 1e9:.1f} TFLOP/s and {100 * bound / d:.1f}"
                     f"% on device time)" if d > 0 else "")
        log(f"phase 9: {name}: {ops / w / 1e9:.1f} TFLOP/s between events, "
            f"the bound {100 * bound / w:.1f}% of its time{on_device}")
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:66",
            "launches": launches, "max_abs_err": max(err.values()),
            # between-event times: back-to-back calls of the kernel and of
            # the library keep the device busy (the host enqueues a library
            # call in about a third of its device time), while traces late
            # in this long process have read the library call at 0.087 ms
            # against the 0.133 to 0.137 ms a fresh process traces (H100)
            "ms": times["kernel"][1], "plain_ms": times["plain"][1],
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes
            else "bytes", "library_ms": times["library"][1]}


def rel_l2(a, b) -> float:
    """``|a - b| / |b|`` over all elements, in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def decode_phase(dev, card: str, seed: int) -> dict:
    """Phase 10 (see the module docstring); returns kernel 7's record with
    its launches on the serve loop's run at full depth."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.lm import lm_forward

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)

    # -- 10a. kernel 7 against its plain version ----------------------------
    shapes = [(2, 256, 8, 2, 64, 200), (1, 100, 4, 4, 128, 100),
              (3, 513, 4, 1, 64, 77),        # tests/test_kernels.py
              (16, 320, 32, 8, 128, 257),    # Qwen3-8B, the serve shape
              (2, 1024, 48, 1, 128, 700),    # granite-34b, MQA
              (4, 1000, 32, 8, 128, 999),    # ragged S
              (8, 8192, 32, 8, 128, 8192)]   # a full 8,192-entry ring
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for B, S, H, KV, D, n in shapes:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            per_batch = torch.randint(0, S + 1, (B,), generator=gen,
                                      device=dev, dtype=torch.int32)
            for length in (n, S, per_batch):
                got = kda.decode_attention(q, k, v, length).float()
                want = kda.decode_attention_plain(q, k, v, length).float()
                torch.cuda.synchronize()
                e = (got - want).abs()
                form = "per-batch" if torch.is_tensor(length) else length
                check(bool((e <= tol + tol * want.abs()).all()),
                      f"decode attention kernel vs plain ({dtype}, "
                      f"{(B, S, H, KV, D)}, length {form}): max err "
                      f"{float(e.max())}")
                err[dtype] = max(err[dtype], float(e.max()))
                cases += 1
    # a tail poisoned with NaN at and past each length (TMA loads the last
    # tile's rows past it): the same output, bitwise, as the clean cache,
    # in one part and with the cache split in three
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, S, H, KV, D = 16, 320, 32, 8, 128
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    per_batch = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
    past = (torch.arange(S, device=dev)[None, :]
            >= per_batch[:, None])[:, :, None, None]
    k_bad, v_bad = (torch.where(past, float("nan"), x) for x in (k, v))
    plans = [(1, 5), (3, 2)]
    combines = kda.decode_attention.combine_launches
    for plan in plans:
        got = kda._launch(q, k_bad, v_bad, per_batch, plan=plan)
        clean = kda._launch(q, k, v, per_batch, plan=plan)
        want = kda.decode_attention_plain(q, k, v, per_batch).float()
        torch.cuda.synchronize()
        e = (got.float() - want).abs()
        check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
              f"decode attention kernel, NaN past the lengths, plan {plan}: "
              f"not the clean cache's output")
        check(bool((e <= 2e-2 + 2e-2 * want.abs()).all()),
              f"decode attention kernel, NaN past the lengths, plan {plan}: "
              f"max err {float(e.max())}")
        err[torch.bfloat16] = max(err[torch.bfloat16], float(e.max()))
        cases += 1
    check(kda.decode_attention.combine_launches == combines + 2,
          "the split plan's two calls did not launch the combine twice")
    log(f"phase 10: decode attention kernel == plain ({cases} cases: "
        f"{len(shapes)} shapes x 2 types x scalar, full and per-batch "
        f"lengths, and a bfloat16 cache with NaN at and past per-batch "
        f"lengths under plans (parts, tiles a part) {plans}: bitwise the "
        f"clean cache's output; max abs err float32 "
        f"{err[torch.float32]:.3g} (bound 2e-5), bfloat16 "
        f"{err[torch.bfloat16]:.3g} (bound 2e-2)) "
        f"[{time.perf_counter() - t_phase:.1f} s]")
    rng = np.random.default_rng(seed)

    def decode(bundle, params, tokens, cache_len):
        cache = bundle.init_cache(tokens.shape[0], cache_len)
        logits = []
        for t in range(tokens.shape[1]):
            lg, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1],
                                           t)
            logits.append(lg[:, 0])
        torch.cuda.synchronize()
        return torch.stack(logits, dim=1), cache

    def close(what, a, b, atol, rtol):
        e = (a - b).abs()
        check(bool((e <= atol + rtol * b.abs()).all()),
              f"{what}: max err {float(e.max())}")
        return float(e.max())

    # -- 10b. full width, 2 layers, float32 ---------------------------------
    cfg2 = dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                               dtype="float32", param_dtype="float32")
    ker2 = build_model(cfg2, attention_impl="kernel", device=dev)
    ref2 = build_model(cfg2, device=dev)
    params = ker2.init(gen)
    B, T = 2, 16
    tokens = torch.as_tensor(rng.integers(0, cfg2.vocab, (B, 100)),
                             device=dev)
    kda.decode_attention.launches = 0
    lk, ck = decode(ker2, params, tokens[:, :T], T)
    launches2 = kda.decode_attention.launches
    check(launches2 == T * cfg2.n_layers,
          f"decode attention launched {launches2} times in {T} steps")
    lr, cr = decode(ref2, params, tokens[:, :T], T)
    full = lm_forward(params, cfg2, tokens[:, :T]).logits
    worst = {"forward": close("2 layers: decode vs lm_forward logits", lk,
                              full, 1e-4, 1e-4)}
    worst["ref route"] = max(
        close("2 layers: kernel vs ref route logits", lk, lr, 1e-4, 1e-4),
        *(close(f"2 layers: kernel vs ref route cache {name}",
                getattr(ck["groups"]["slot0"], name),
                getattr(cr["groups"]["slot0"], name), 1e-4, 1e-4)
          for name in ("k", "v")))
    ring = build_model(cfg2, attention_impl="kernel", window_override=64,
                       device=dev)
    lw, cw = decode(ring, params, tokens, 100)
    check(cw["groups"]["slot0"].k.shape[2] == 64, "ring of 64 entries")
    worst["ring"] = close("2 layers: ring decode vs lm_forward(window=64)",
                          lw, lm_forward(params, cfg2, tokens,
                                         window=64).logits, 1e-4, 1e-4)
    log(f"phase 10: Qwen3-8B full width x 2 layers, float32, B = {B}: "
        f"{T} decode steps on the kernel route ({launches2} launches) == "
        f"lm_forward (max abs err {worst['forward']:.3g}) and == the ref "
        f"route on logits and cache ({worst['ref route']:.3g}); "
        f"window_override=64 over 100 steps (a ring of 64) == "
        f"lm_forward(window=64) ({worst['ring']:.3g}); bound atol 1e-4 + "
        f"rtol 1e-4 [{time.perf_counter() - t_phase:.1f} s]")
    del params, lk, ck, lr, cr, full, lw, cw
    torch.cuda.empty_cache()

    # -- 10c. full width and depth, bfloat16, through the serve loop -----
    cfg = get_config("qwen3-8b")
    ker = build_model(cfg, attention_impl="kernel", device=dev)
    ref = build_model(cfg, device=dev)
    params = ker.init(gen)
    B, P, N = 16, 256, 64
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kda.decode_attention.launches = 0
    kda.decode_attention.combine_launches = 0
    out = generate(ker, params, prompts, N, keep_logits=True)
    launches = kda.decode_attention.launches
    combines = kda.decode_attention.combine_launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    kept_gb = out.step_logits.numel() * 4 / 1e9
    steps = P + N - 1
    check(launches == cfg.n_layers * steps,
          f"decode attention launched {launches} times in {steps} steps")
    # step t attends to t + 1 entries: split wherever the plan says so
    want_combines = cfg.n_layers * sum(
        kda.split_plan(B, cfg.n_kv_heads, P + N, t + 1, sms)[0] > 1
        for t in range(steps))
    check(combines == want_combines,
          f"the combine launched {combines} times, not {want_combines}")
    check(out.tokens.shape == (B, N) and out.step_logits.shape
          == (B, steps, cfg.vocab)
          and bool(torch.isfinite(out.step_logits).all()),
          "decode logits not finite or of the wrong shape")
    pre_logits, _ = ker.prefill(params, {"tokens": prompts})
    rel_prefill = rel_l2(out.prompt_logits, pre_logits[:, -1])
    check(rel_prefill <= 0.1, f"stepped vs prefill logits at t = P - 1: "
          f"relative L2 {rel_prefill}")
    agree = float((out.prompt_logits.argmax(-1)
                   == pre_logits[:, -1].argmax(-1)).float().mean())
    del pre_logits
    forced = generate(ref, params, prompts, N, forced=out.tokens,
                      keep_logits=True)
    diff = (out.step_logits - forced.step_logits).norm(dim=(0, 2))
    rel_ref = float((diff / forced.step_logits.norm(dim=(0, 2))).max())
    check(rel_ref <= 0.1, f"kernel vs ref route, teacher-forced: worst "
          f"step's relative L2 {rel_ref}")
    del forced
    toks = out.tokens[:, -1:]

    def step():
        return ker.decode_step(params, out.cache, toks, P + N - 1)

    reps = 5
    _, wall_ms, split = profiled(step, reps)
    busy = sum(ms for ms, _ in split.values())
    attn = sum(ms for name, (ms, _) in split.items()
               if re.match(r"(void )?(mma::)?decode_", name))
    gemm = sum(ms for name, (ms, _) in split.items()
               if any(w in name for w in ("nvjet", "gemm", "cutlass")))
    log(f"phase 10: {reps} decode steps' top kernels by device time:")
    log_top(split, 8)
    share = (f"kernel 7 {attn / reps:.3f} ms of {busy / reps:.3f} ms device "
             f"time a step ({100 * attn / busy:.1f}%), matrix products "
             f"{gemm / reps:.3f} ms, the rest "
             f"{(busy - attn - gemm) / reps:.3f} ms; traced wall "
             f"{wall_ms / reps:.2f} ms a step (device busy "
             f"{100 * busy / wall_ms:.1f}%)" if busy > 0
             else "not measured (no device trace)")
    step_ms = 1e3 * out.decode_s / (N - 1)
    log(f"phase 10: Qwen3-8B at full width and depth ({cfg.n_layers} "
        f"layers, bfloat16) through serve.generate: B = {B} prompts of "
        f"P = {P} tokens stepped in {1e3 * out.prefill_s / P:.2f} ms a "
        f"step, then N = {N} new tokens: {step_ms:.2f} ms per decode step, "
        f"{B * (N - 1) / out.decode_s:.1f} generated tokens/s; decode "
        f"attention launches {launches} ({launches // steps} per step over "
        f"{steps} steps), its combine {combines}; peak memory "
        f"{peak:.2f} GB ({kept_gb:.2f} GB of it "
        f"the kept float32 logits of every step); {share}; stepped vs "
        f"prefill logits at t = P - 1 relative L2 {rel_prefill:.4g} (bound "
        f"0.1, argmax agreement {agree:.3f}); ref route teacher-forced on "
        f"the generated tokens, worst step's relative L2 {rel_ref:.4g} "
        f"(bound 0.1) ({card}) [{time.perf_counter() - t_phase:.1f} s]")
    del params, out
    torch.cuda.empty_cache()

    # -- 10d. kernel 7's times at decode_32k's per-layer shape -------------
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def shape_times(B, S, reps, other_plan=None):
        q = torch.randn((B, 1, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {
            "kernel": (lambda: kda.decode_attention(q, k, v, S), reps),
            "plain": (lambda: kda.decode_attention_plain(q, k, v, S), 3),
            "library": (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True), reps)}
        if other_plan:  # the same kernel with the cache cut otherwise
            calls[f"kernel with plan {other_plan}"] = (lambda: kda._launch(
                q, k, v, S, plan=other_plan), reps)
        _, _, lib_split = profiled(calls["library"][0], 10)
        log(f"phase 10: the library call's kernels at B = {B}, S = {S} (10 "
            f"calls traced):")
        log_top(lib_split, 3)
        lib = calls["library"][0]().transpose(1, 2).float()
        e = (lib - calls["kernel"][0]().float()).abs()
        check(bool((e <= 2e-2 + 2e-2 * lib.abs()).all()),
              f"the library call disagrees with the kernel: {float(e.max())}")
        times = {name: (device_ms(fn, r), time_ms(fn, r))
                 for name, (fn, r) in calls.items()}
        nbytes = 2 * (2 * B * S * KV * D + 2 * B * H * D)
        ops = 4 * B * H * S * D
        bounds = (1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_BF16_FLOPS)
        log(f"phase 10: decode attention q [{B}x1x{H}x{D}], caches "
            f"[{B}x{S}x{KV}x{D}] bfloat16, length {S}, split plan (parts, "
            f"tiles a part) {kda.split_plan(B, KV, S, S, sms)}: "
            + "; ".join(f"{name} device {d:.4f} ms / between events "
                        f"{w:.4f} ms" for name, (d, w) in times.items())
            + f"; bound {max(bounds):.6f} ms ({nbytes / 1e9:.4f} GB at 3.35 "
            f"TB/s {bounds[0]:.6f} ms, {ops / 1e9:.3f} GFLOP at 989 TFLOP/s "
            f"{bounds[1]:.6f} ms); library vs kernel max abs err "
            f"{float(e.max()):.3g} ({card})")
        return times, bounds

    # the serve shape (one part), and a long context at a small batch (8
    # parts), each beside the other choice, logged beside the record
    shape_times(16, 320, 50, other_plan=(2, 3))
    shape_times(2, 8192, 20, other_plan=(1, 128))
    times, bounds = shape_times(128, 8192, 20)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:55",
            "launches": launches, "max_abs_err": max(err.values()),
            # between-event times, as phase 9's record (traces late in this
            # long process can lose device records)
            "ms": times["kernel"][1], "plain_ms": times["plain"][1],
            "bound_ms": max(bounds),
            "bound_by": "bytes" if bounds[0] >= bounds[1] else "operations",
            "library_ms": times["library"][1]}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phases 9 and 10's prompts and "
                        "weights")
    seed = parser.parse_args().seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.batched import batch_log_normalizing_constants
    from repro_torch.core.buzen import aggregate_log_Z
    from repro_torch.core.complexity import wallclock_time
    from repro_torch.core.energy import PowerProfile
    from repro_torch.core import prng
    from repro_torch.core.events import (DRAW_EVENTS, EventState,
                                         EventStream, draw_event_blocks,
                                         event_key, event_step_lanes_plain,
                                         init_state, megastep_lanes_plain,
                                         next_update, run_event_blocks,
                                         stack_blocks, stack_lanes)
    from repro_torch.core.jackson import expected_relative_delay, throughput
    from repro_torch.core.optimize import time_optimal, time_optimal_classes
    from repro_torch.kernels import build
    from repro_torch.kernels import buzen as kb
    from repro_torch.kernels import events as ke
    from repro_torch.kernels import fused_update as kf
    from repro_torch.kernels import threefry as ktf
    from repro_torch.scenario.spec import (PAPER_CLUSTERS_TABLE1, ClassSpec,
                                           LearningSpec, NetworkSpec)
    from repro_torch.sim import simulate_stats_lanes

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # -- 1. the card and the build ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    sm_clock_mhz = float(clk.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    spec = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1)
    net = spec.params(device=dev)
    n = spec.n
    consts = LearningSpec().consts
    rng = np.random.default_rng(0)

    # -- 2. the Buzen kernels against their plain versions ----------------
    M = 132
    buzen_err = bwd_err = 0.0
    for S in (100, 101):
        lr = np.log(rng.dirichlet(np.ones(S), size=131)) - np.log(
            rng.uniform(0.1, 12.0, (131, S)))
        lr[::7, -3:] = -np.inf  # padded (load-0) stations
        lg = np.log(rng.uniform(0.05, 5.0, 131))
        a = torch.as_tensor(lr, device=dev)
        b = torch.as_tensor(lg, device=dev)
        # a generator of its own, so the shared one's draws stay as they were
        g = torch.as_tensor(np.random.default_rng(S).normal(
            size=(131, M + 1)), device=dev)
        got = kb.buzen_batched(a, b, M)
        want = kb.buzen_batched_plain(a, b, M)
        got_lr, got_lg = kb.buzen_log_Z_backward(a, b, g, M)
        want_lr, want_lg = kb.buzen_log_Z_backward_plain(a, b, g, M)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= 2e-5 + 2e-5 * want.abs()).all()),
              f"buzen kernel vs plain (S={S}): max err {float(err.max())}")
        buzen_err = max(buzen_err, float(err.max()))
        for x, y in ((got_lr, want_lr), (got_lg, want_lg)):
            err = (x - y).abs()
            tol = 1e-9 * y.abs() + 1e-12 * float(y.abs().max())
            check(bool((err <= tol).all()), f"buzen backward vs plain "
                  f"(S={S}): max err {float(err.max())}")
            bwd_err = max(bwd_err, float(err.max()))
        check(bool((got_lr[~torch.isfinite(a)] == 0.0).all()),
              f"buzen backward (S={S}): a padded station's partial is not 0")
        # the padded rows without their padded columns: bitwise the same
        pr = slice(0, None, 7)
        a_u, b_u, g_u = a[pr, :-3].contiguous(), b[pr].contiguous(), g[pr]
        u_lr, u_lg = kb.buzen_log_Z_backward(a_u, b_u, g_u.contiguous(), M)
        check(torch.equal(kb.buzen_batched(a_u, b_u, M), got[pr]),
              f"buzen kernel (S={S}): padded != unpadded")
        check(torch.equal(u_lr, got_lr[pr, :-3])
              and torch.equal(u_lg, got_lg[pr]),
              f"buzen backward (S={S}): padded != unpadded on real partials")
    p_rows = torch.as_tensor(np.vstack([np.full(n, 1.0 / n),
                                        rng.dirichlet(np.full(n, 5.0), 7)]),
                             device=dev)
    f64 = batch_log_normalizing_constants(net, p_rows, M, backend="torch")
    k32 = batch_log_normalizing_constants(net, p_rows, M, backend="kernel")
    err = (k32 - f64).abs()
    check(bool((err <= 3e-4 + 3e-5 * f64.abs()).all()),
          f"buzen kernel vs float64 DP: max err {float(err.max())}")
    log(f"phase 2: buzen kernel == plain within 2e-5 (max abs err "
        f"{buzen_err:.3g}); vs float64 DP max abs err {float(err.max()):.3g}; "
        f"buzen backward == plain adjoint within rtol 1e-9 (max abs err "
        f"{bwd_err:.3g}); padded stations: partials 0, both kernels "
        f"bitwise the unpadded rows")

    # -- 3. the event kernels against their plain versions -----------------
    # run_event_blocks on the kernel route: the event lane kernel, 2,000
    # times from the same blocks as the batched route (500 times under the
    # lognormal and hyperexponential laws: the batched route takes about
    # 2.5 ms an event); then, for the scale laws, the same events through
    # the transition-only event kernel and its plain version (the TPU
    # kernels' contract, the scale form only)
    K = 6
    for law in ("exponential", "deterministic", "lognormal",
                "hyperexponential"):
        scale = law in ("exponential", "deterministic")
        EV = 2000 if scale else 500
        for mu_cs in (None, 5.0):
            lanes = []
            for _ in range(K):
                prm = net._replace(p=torch.as_tensor(
                    rng.dirichlet(np.full(n, 5.0)), device=dev))
                lanes.append(prm if mu_cs is None else prm.with_cs(mu_cs))
            keys = prng.seed_keys(range(100, 100 + K), device=dev)
            st0 = stack_lanes([init_state(prm, M, k, m_max=M,
                                          distribution=law)
                               for prm, k in zip(lanes, keys)])
            blocks = stack_blocks([draw_event_blocks(prm, k, EV,
                                                     distribution=law)[1]
                                   for prm, k in zip(lanes,
                                                     event_key(keys))])
            lane_params = stack_lanes(lanes)
            outs = [run_event_blocks(lane_params, st0, blocks,
                                     distribution=law, backend=be)
                    for be in ("kernel", "batched")]
            torch.cuda.synchronize()
            for name in EventState._fields:
                x, y = getattr(outs[0], name), getattr(outs[1], name)
                check(torch.equal(x, y),
                      f"event lane kernel vs batched ({law}, cs={mu_cs}): "
                      f"{name}")
            log(f"phase 3: event lane kernel == batched bitwise ({law}, "
                f"mu_cs={mu_cs}, {EV} events x {K} lanes, round "
                f"{outs[0].round.tolist()})")
            if not scale:
                continue
            # the transition alone on the same events: the event kernel
            # and its plain version, each carrying its own tables and
            # counters from st0
            fs, cn, _ = EventStream.from_blocks(
                blocks, distribution=law).window(EV)
            rates = (lane_params.mu_c, lane_params.mu_u)
            runs = []
            for step in (ke.event_step_tables, ke.event_step_tables_plain):
                rows = (st0.finish, st0.phase, st0.client, st0.seq,
                        st0.disp_round)
                seq_ctr, rnd = st0.seq_ctr, st0.round
                ts, ds = [], []
                for i in range(EV):
                    *rows, t_col, d = step(
                        *rows, *rates, fs[:, i],
                        torch.stack([cn[:, i], seq_ctr, rnd], dim=-1),
                        has_cs=mu_cs is not None)
                    seq_ctr, rnd = d[:, 4], d[:, 5]
                    ts.append(t_col)
                    ds.append(d)
                runs.append((*rows, torch.cat(ts, 1), torch.cat(ds, 1)))
            torch.cuda.synchronize()
            for name, x, y in zip(TABLE_OUT, *runs):
                check(torch.equal(x, y), f"event kernel vs plain ({law}, "
                      f"cs={mu_cs}): {name}")
            log(f"phase 3: event kernel (transition only) == plain bitwise "
                f"({law}, mu_cs={mu_cs}, {EV} events x {K} lanes: tables, "
                f"times and descriptors of every event)")

    cases = 0
    for law in ("exponential", "deterministic"):
        for has_cs in (False, True):
            for chunk, m_max in ((1, 132), (7, 1000), (32, 132)):
                for stop in (False, True):
                    args = [torch.as_tensor(a, device=dev) for a in
                            mega_tables(rng, 64, m_max, n, has_cs, chunk,
                                        law)]
                    kw = dict(has_cs=has_cs, chunk=chunk,
                              stop_on_update=stop)
                    got = ke.megastep_tables(*args, **kw)
                    want = ke.megastep_tables_plain(*args, **kw)
                    torch.cuda.synchronize()
                    for name, x, y in zip(TABLE_OUT, got, want):
                        check(torch.equal(x, y),
                              f"megastep kernel vs plain ({law}, cs="
                              f"{has_cs}, chunk={chunk}, m_max={m_max}, "
                              f"stop={stop}): {name}")
                    cases += 1
    log(f"phase 3: megastep kernel == plain bitwise ({cases} cases: both "
        f"laws, CS on/off, chunk 1/7/32, m_max up to 1000, stop_on_update "
        f"on/off, rem < chunk)")
    chunk = 8
    args = [torch.as_tensor(a, device=dev) for a in
            mega_tables(rng, 6, M, n, True, chunk, "deterministic")]
    args[-1][:, 2] = chunk
    got = ke.megastep_tables(*args, has_cs=True, chunk=chunk)
    tbl = args[:5]
    seq_ctr, rnd = args[-1][:, 0], args[-1][:, 1]
    for i in range(chunk):
        one = torch.stack([args[-1][:, 3 + i], seq_ctr, rnd], dim=-1)
        *tbl, t, d = ke.event_step_tables(*tbl, args[5], args[6],
                                          args[7][:, 4 * i:4 * i + 4], one,
                                          has_cs=True)
        seq_ctr, rnd = d[:, 4], d[:, 5]
        check(torch.equal(got[5][:, i], t[:, 0])
              and torch.equal(got[6][:, 10 * i:10 * i + 9], d),
              f"megastep event {i} != event kernel")
    check(all(torch.equal(g, w) for g, w in zip(got[:5], tbl)),
          "megastep tables != event kernel tables")
    log(f"phase 3: one megastep launch (chunk {chunk}) == {chunk} event "
        f"kernel launches, bitwise")
    lane_err = lane_phase3(dev, net, n, rng)
    fused_err = fused_rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for N in (408767, 1, 4097, 1001):
            for L in (1, 4):
                w = torch.randn(L, N, device=dev).to(dtype)
                g = torch.randn(L, N, device=dev).to(dtype)
                sc = torch.rand(L, device=dev)
                got, sq = kf.fused_async_update_flat(w, g, sc)
                want, want_sq = kf.fused_async_update_flat_plain(w, g, sc)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"fused update kernel vs plain ({dtype}, N={N}, "
                      f"L={L}): new parameters differ")
                rel = float(((sq - want_sq).abs() / want_sq.abs()).max())
                check(rel <= 1e-5, f"fused update kernel vs plain ({dtype}, "
                      f"N={N}, L={L}): squared norm rel err {rel}")
                fused_err = max(fused_err, float(
                    (got.float() - want.float()).abs().max()))
                fused_rel = max(fused_rel, rel)
    log(f"phase 3: fused update kernel == plain bitwise on w' (float32 and "
        f"bfloat16, N = 408767, 1, 4097, 1001, L = 1, 4); squared norm max "
        f"rel err {fused_rel:.3g}")

    # -- 4. the main path at the paper's size ------------------------------
    counted = (kb.buzen_batched, kb.buzen_log_Z_backward,
               ke.event_step_lanes, ke.megastep_lanes, ke.event_step_tables,
               ke.megastep_tables, ktf.chain_words)
    for c in counted:
        c.launches = 0
    t_main = time.perf_counter()
    m0 = n
    delays = expected_relative_delay(net, m0)
    lam0 = throughput(net, m0)
    tau0 = wallclock_time(net, m0, consts)
    check(bool(torch.isfinite(delays).all()) and delays.shape == (n,),
          "closed forms: delays")
    check(abs(float(delays.sum()) - (m0 - 1)) <= 1e-9 * m0,
          "closed forms: sum of delays != m - 1")
    log(f"phase 4: closed forms at m={m0}: lambda={float(lam0):.6g}, "
        f"E0[tau]={float(tau0):.6g}, sum E0[D]={float(delays.sum()):.12g}")

    t0 = time.perf_counter()
    res_k = time_optimal(net, consts, m_max=M, steps=200, backend="kernel")
    torch.cuda.synchronize()
    sweep_k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_t = time_optimal(net, consts, m_max=M, steps=200, backend="torch")
    torch.cuda.synchronize()
    sweep_t_s = time.perf_counter() - t0
    ms = np.array([m for m, _ in res_k.history])
    vk = np.array([v for _, v in res_k.history])
    vt = np.array([v for _, v in res_t.history])
    check(bool(np.isfinite(vk).all()), "sweep values not finite")
    rel = np.abs(vk - vt) / np.abs(vt)
    tau_rel = abs(res_k.value - res_t.value) / res_t.value
    log(f"phase 4: time_optimal kernel m*={res_k.m} tau*={res_k.value:.8g} "
        f"({sweep_k_s:.2f} s); torch m*={res_t.m} tau*={res_t.value:.8g} "
        f"({sweep_t_s:.2f} s); tau* rel diff {tau_rel:.3g}; sweep max rel "
        f"diff {rel.max():.3g}; rows over 1e-4 at m = "
        f"{ms[rel > 1e-4].tolist()}")
    check(float(rel.max()) <= 1e-4,
          f"kernel vs torch sweep: rel diff {rel.max()}")

    p_star = net._replace(p=res_k.p.detach())
    m_star = res_k.m
    sim_kw = dict(warmup=400, seeds=range(6))
    sim_ms = {}  # wall ms per lock-step event

    def simulate(m, be, chunk, updates=PHASE4_UPDATES, **kw):
        before = [c.launches for c in counted]
        t0 = time.perf_counter()
        out = simulate_stats_lanes([p_star] * 6, [m] * 6, updates,
                                   backend=be, chunk=chunk, **sim_kw, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = 3 * (updates + 400) + 3 * m + 8
        sim_ms[(m, be, chunk, "power" in kw)] = 1e3 * wall / events
        # the kernel route: one lane-kernel launch per chunk of events, no
        # transition-only launch; the plain route launches nothing
        got = [c.launches - b for c, b in zip(counted, before)]
        chains, got = got[6], got[2:6]
        lane = -(-events // chunk)
        want = ([0] * 4 if be != "kernel" else
                [lane, 0, 0, 0] if chunk == 1 else [0, lane, 0, 0])
        check(got == want, f"simulate[{be}, m={m}, E={chunk}]: launches "
              f"(event lanes, megastep lanes, event, megastep) {got}, "
              f"expected {want} for {events} events")
        # every route draws on the card: one key-chain launch a block of
        # events for all lanes (a lane at a time on "reference")
        blocks = -(-events // DRAW_EVENTS) * (6 if be == "reference" else 1)
        check(chains == blocks, f"simulate[{be}, m={m}, E={chunk}]: "
              f"{chains} key-chain launches, expected {blocks}")
        log(f"phase 4: simulate_stats_lanes[{be}, m={m}, E={chunk}"
            f"{', power' if kw else ''}] {wall:.2f} s, "
            f"{1e3 * wall / events:.4f} ms per lock-step event, "
            f"{sum(got)} lane-kernel launches")
        return out

    lam_star = float(throughput(p_star, m_star))
    for m in (m_star, M):
        base = simulate(m, "kernel", 1)
        for chunk in (8, 32):
            got = simulate(m, "kernel", chunk)
            for name, a, b in zip(base._fields, base, got):
                check(torch.equal(a, b),
                      f"simulate m={m}: E={chunk} != E=1 ({name})")
        lam = float(throughput(p_star, m))
        lam_sim = float(base.throughput.mean())
        check(abs(lam_sim - lam) <= 0.10 * lam,
              f"simulated throughput {lam_sim} vs Prop. 4 {lam} at m={m}")
        log(f"phase 4: m={m}: E = 1, 8, 32 bitwise on every statistic; "
            f"throughput lanes {lam_sim:.6g} vs Prop. 4 {lam:.6g}")
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    power = PowerProfile(P_c=2.0 * ones, P_u=ones, P_d=0.5 * ones)
    pw1 = simulate(m_star, "kernel", 1, updates=POWER_UPDATES, power=power)
    for chunk in (8, 32):
        got = simulate(m_star, "kernel", chunk, updates=POWER_UPDATES,
                       power=power)
        check(all(torch.equal(a, b) for a, b in zip(pw1, got)),
              f"simulate with power: E={chunk} != E=1")
    # the energy integral on the card's DFMA against the plain route's
    # emulated fused multiply-adds
    got = simulate(m_star, "batched", 1, updates=POWER_UPDATES, power=power)
    check(all(torch.equal(a, b) for a, b in zip(pw1, got)),
          "simulate with power: kernel != batched")
    for chunk in (1, 8, 32):  # the same depth without power, for the ratio
        got = simulate(m_star, "kernel", chunk, updates=POWER_UPDATES)
        check(torch.equal(got.throughput, pw1.throughput)
              and torch.equal(got.mean_queue_counts, pw1.mean_queue_counts),
              f"power changed the simulated trajectory (E={chunk})")
        if chunk == 1:  # the plain route, at this depth
            plain = simulate(m_star, "batched", 1, updates=POWER_UPDATES)
            check(all(torch.equal(a, b) for a, b in zip(got, plain)),
                  "simulate kernel vs batched not bitwise")
    check(bool(torch.isfinite(pw1.energy).all() and (pw1.energy > 0).all()),
          f"simulated energy {pw1.energy.tolist()}")

    def updates_run(chunk, count=200):
        keys = prng.seed_keys(range(300, 306), device=dev)
        st = stack_lanes([init_state(p_star, m_star, k, m_max=m_star)
                          for k in keys])
        stream = EventStream([p_star] * 6, event_key(keys))
        lanes = stack_lanes([p_star] * 6)
        t0 = time.perf_counter()
        outs = []
        for _ in range(count):
            st, upd = next_update(lanes, st, stream, chunk=chunk,
                                  backend="kernel")
            outs.append(upd)
        torch.cuda.synchronize()
        log(f"phase 4: next_update x {count} on 6 lanes, chunk {chunk}: "
            f"{time.perf_counter() - t0:.2f} s")
        return st, [torch.stack(x, 1) for x in zip(*outs)]

    st1, upd1 = updates_run(1)
    st8, upd8 = updates_run(8)
    check(all(torch.equal(a, b) for a, b in zip(upd1, upd8))
          and all(torch.equal(a, b) for a, b in zip(st1, st8)),
          "next_update chunk 8 != chunk 1")
    check(bool((upd1[0].diff(dim=1) > 0).all()
               and (upd1[4] > 0).all() and (st1.round == 200).all()),
          "next_update: times not increasing or updates missing")
    log(f"phase 4: next_update chunk 8 == chunk 1 bitwise (200 updates x 6 "
        f"lanes, {int(upd1[4].sum())} events)")
    main_s = time.perf_counter() - t_main
    launches = {"buzen": kb.buzen_batched.launches,
                "buzen_backward": kb.buzen_log_Z_backward.launches,
                "event_step": ke.event_step_lanes.launches,
                "megastep": ke.megastep_lanes.launches,
                "threefry": ktf.chain_words.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(ke.event_step_tables.launches == 0
          and ke.megastep_tables.launches == 0,
          "a transition-only kernel ran on the main path")
    # the sweep: 200 Adam steps and the final evaluation
    check(launches["buzen"] == 201 and launches["buzen_backward"] == 200,
          f"the sweep's Buzen launches: {launches}")
    threefry_main = launches["threefry"]
    log(f"phase 4: throughput at (p*, m*={m_star}): Prop. 4 "
        f"{lam_star:.6g}; main path {main_s:.1f} s; launches {launches}")
    log("phase 4: ms per lock-step event (6 lanes; m, backend, E, power): "
        + ", ".join(f"{k}: {v:.4f}" for k, v in sim_ms.items()))

    # -- 5. kernel times at the main path's shapes -------------------------
    # the Buzen kernel as the sweep calls it: rows m = 2..132 at (p*)
    B = M - 1
    lr = (torch.log(p_star.p) - torch.log(net.mu_c)).expand(B, n).contiguous()
    lg = torch.log((p_star.p * (1.0 / net.mu_d + 1.0 / net.mu_u)).sum()
                   ).expand(B).contiguous()
    lane_params = stack_lanes([p_star] * 6)

    def lane_tables(m, seed):
        keys = prng.seed_keys(range(seed, seed + 6), device=dev)
        st = stack_lanes([init_state(p_star, m, k, m_max=m) for k in keys])
        return st, (st.finish, st.phase, st.client, st.seq, st.disp_round,
                    lane_params.mu_c, lane_params.mu_u)

    # the event kernel as the simulation calls it: 6 lanes of m* slots
    st, tbl = lane_tables(m_star, 200)
    tbl = tbl + (torch.rand(6, 4, dtype=torch.float64, device=dev),
                 torch.stack([torch.zeros(6, dtype=torch.int32, device=dev),
                              st.seq_ctr, st.round], dim=-1))
    g5 = torch.as_tensor(np.random.default_rng(5).normal(size=(B, M + 1)),
                         device=dev)

    def autograd_recompute():
        """What the backward kernel replaces: PyTorch autograd through the
        float64 DP recomputed at the primal point."""
        with torch.enable_grad():
            x = lr.detach().requires_grad_(True)
            y = lg.detach().requires_grad_(True)
            return torch.autograd.grad(aggregate_log_Z(x, y, M), (x, y), g5)

    calls = {
        "buzen": (lambda: kb.buzen_batched(lr, lg, M),
                  lambda: kb.buzen_batched_plain(lr, lg, M), 20, 3),
        "buzen_backward": (
            lambda: kb.buzen_log_Z_backward(lr, lg, g5, M),
            lambda: kb.buzen_log_Z_backward_plain(lr, lg, g5, M), 20, 3),
        "event transition": (
            lambda: ke.event_step_tables(*tbl, has_cs=False),
            lambda: ke.event_step_tables_plain(*tbl, has_cs=False), 200, 50)}
    labels = {"buzen": f"[{B}x{n}], m_max={M}",
              "buzen_backward": f"[{B}x{n}], m_max={M}, float64",
              "event transition": f"[6x{m_star}], n={n} (transition only, "
                                  f"off the main path)"}
    # the lane kernels as the simulation calls them: 6 lanes of m* (and of
    # 132) slots, n = 100, one event, or E = 8 and 32 every one kept, with
    # and without the power profile; the kernel works on a copy of the
    # state in place (donated), as run_events does after its first launch
    lane_pw = stack_lanes([power] * 6)
    lane_shapes = {}
    for m, chunk, pw in [(m_star, 1, None), (m_star, 1, lane_pw),
                         (m_star, 8, None), (m_star, 8, lane_pw),
                         (m_star, 32, None), (m_star, 32, lane_pw),
                         (M, 8, None), (M, 32, None)]:
        st_m = lane_tables(m, 600)[0]
        own = EventState(*[x.clone() for x in st_m])
        fs_m = torch.rand(6, chunk, 4, dtype=torch.float64, device=dev)
        cn_m = torch.randint(0, n, (6, chunk), dtype=torch.int32, device=dev)
        name = (f"{'event_step' if chunk == 1 else 'megastep'} m={m} "
                f"E={chunk}{' power' if pw is not None else ''}")
        labels[name] = (f"[6x{m}], n={n}, {chunk} event"
                        f"{'s' if chunk > 1 else ''}"
                        f"{', power' if pw is not None else ''}")
        lane_shapes[name] = (m, chunk, pw is not None)
        if chunk == 1:
            calls[name] = (
                lambda s=own, f=fs_m[:, 0], c=cn_m[:, 0], p=pw:
                ke.event_step_lanes(lane_params, s, f, c, power=p,
                                    donate=True),
                lambda s=st_m, f=fs_m[:, 0], c=cn_m[:, 0], p=pw:
                event_step_lanes_plain(lane_params, s, f, c, power=p),
                200, 20)
        else:
            calls[name] = (
                lambda s=own, f=fs_m, c=cn_m, p=pw, e=chunk:
                ke.megastep_lanes(lane_params, s, f, c, e, power=p,
                                  donate=True),
                lambda s=st_m, f=fs_m, c=cn_m, p=pw, e=chunk:
                megastep_lanes_plain(lane_params, s, f, c, e, power=p),
                200, 3)
    # the transition-only megastep (off the main path) at (m*, E = 8)
    mega_shapes = {}
    st_m, tbl_m = lane_tables(m_star, 400)
    iscal = torch.cat([st_m.seq_ctr[:, None], st_m.round[:, None],
                       torch.full((6, 1), 8, dtype=torch.int32, device=dev),
                       torch.randint(0, n, (6, 8), dtype=torch.int32,
                                     device=dev)], dim=1)
    args = tbl_m + (torch.rand(6, 32, dtype=torch.float64, device=dev), iscal)
    name = "megastep transition"
    labels[name] = (f"[6x{m_star}], n={n}, 8 events (transition only, off "
                    f"the main path)")
    mega_shapes[name] = (m_star, 8)
    calls[name] = (
        lambda: ke.megastep_tables(*args, has_cs=False, chunk=8),
        lambda: ke.megastep_tables_plain(*args, has_cs=False, chunk=8),
        200, 5)
    # the class Buzen kernels as the class sweep calls them: rows m =
    # 2..132 over Table 1's five classes at n = 1e6 (uniform per-member
    # routing); the forward kernel builds its series itself, so its time is
    # the wrapper's whole call, beside the plain version's whole call; the
    # backward beside its plain adjoint and the autograd recompute of the
    # float64 class DP that it replaces
    cls_big = ClassSpec(mu_c=[c.mu_c for c in PAPER_CLUSTERS_TABLE1],
                        mu_d=[c.mu_d for c in PAPER_CLUSTERS_TABLE1],
                        mu_u=[c.mu_u for c in PAPER_CLUSTERS_TABLE1],
                        count=[c.count * 10**4 for c in PAPER_CLUSTERS_TABLE1]
                        ).class_params(device=dev)
    C5 = cls_big.C
    c_lr = cls_big.log_rho.expand(B, C5).contiguous()
    c_cnt = cls_big.count.to(torch.float64).expand(B, C5).contiguous()
    c_lg = cls_big.log_gamma_total.expand(B).contiguous()
    c_g = torch.as_tensor(np.random.default_rng(6).normal(size=(B, M + 1)),
                          device=dev)

    def class_recompute():
        """What the class backward kernel replaces: PyTorch autograd
        through the float64 class DP recomputed at the primal point."""
        with torch.enable_grad():
            x = c_lr.detach().requires_grad_(True)
            y = c_lg.detach().requires_grad_(True)
            return torch.autograd.grad(
                kb.reference_class_log_Z(x, c_cnt, y, M), (x, y), c_g)

    calls["buzen_classes"] = (
        lambda: kb.buzen_classes_batched(c_lr, c_cnt, c_lg, M),
        lambda: kb.buzen_classes_batched_plain(c_lr, c_cnt, c_lg, M), 50, 5)
    calls["buzen_classes_backward"] = (
        lambda: kb.buzen_classes_log_Z_backward(c_lr, c_cnt, c_lg, c_g, M),
        lambda: kb.buzen_classes_log_Z_backward_plain(c_lr, c_cnt, c_lg,
                                                      c_g, M), 50, 5)
    labels["buzen_classes"] = f"[{B}x{C5}], m_max={M}, n=1e6"
    labels["buzen_classes_backward"] = (f"[{B}x{C5}], m_max={M}, n=1e6, "
                                        f"float64")
    # the fused update as the trainer calls it: 4 lanes of the CNN
    L4, N4 = 4, 408767
    fu_args = (torch.randn(L4, N4, device=dev),
               torch.randn(L4, N4, device=dev), torch.rand(L4, device=dev))
    calls["fused_update"] = (lambda: kf.fused_async_update_flat(*fu_args),
                             lambda: kf.fused_async_update_flat_plain(
                                 *fu_args), 200, 50)
    labels["fused_update"] = f"[{L4}x{N4}] float32"
    times = {}
    for name, (kern, plain, rk, rp) in calls.items():
        times[name] = {"kernel": (device_ms(kern, rk), time_ms(kern, rk)),
                       "plain": (device_ms(plain, rp), time_ms(plain, rp))}
    recompute = (device_ms(autograd_recompute, 3),
                 time_ms(autograd_recompute, 3))
    c_recompute = (device_ms(class_recompute, 5), time_ms(class_recompute, 5))
    profiled = all(t["kernel"][0] > 0 and t["plain"][0] > 0
                   for t in times.values())
    pick = 0 if profiled else 1  # device time when the profiler saw the card

    terms = B * n * (M + 1) * (M + 2) / 2
    bound_ops = BUZEN_OPS_PER_TERM * terms / PEAK_F32_FLOPS
    bound_bytes = 4 * (B * n + 2 * B * (M + 1)) / PEAK_BYTES
    # every exp of the forward goes to the MUFU unit: 16 a clock on each SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_ms = 1e3 * terms / (MUFU_PER_CLOCK * sms * 1e6 * sm_clock_mhz)
    # the backward: both phases' terms; log_rho, g and log_gamma_total in,
    # their partials out, float64
    bwd_ops = BUZEN_BWD_OPS_PER_TERM * 2 * terms / PEAK_F64_FLOPS
    bwd_bytes = 8 * (2 * B * n + B * (M + 1) + 2 * B) / PEAK_BYTES
    K6 = 6

    def transition_bytes(m, chunk, n_desc):
        """The five rows read and written, the scalars in, the times and
        descriptors out, and one 32-byte sector per rate gather (two per
        event and lane)."""
        return (2 * K6 * m * (8 + 4 * 4) + K6 * (4 * chunk * 8)
                + K6 * (3 + (chunk if n_desc == 10 else 0)) * 4
                + K6 * chunk * (8 + n_desc * 4) + 2 * K6 * chunk * 32)

    def lane_bytes(m, chunk, with_power, n_desc):
        """What a lane kernel must move: the table rows and the statistics
        rows (occ and occ_int [3n+1], serving and delay_sum [n] float64,
        delay_cnt [n] int32) read and written once, the power rows read
        once, the lane's scalars in and out, the events' scalars in, their
        times and descriptors out, one 32-byte sector per rate gather."""
        S = 3 * n + 1
        rows = 2 * (m * (8 + 4 * 4) + 2 * S * 8 + n * (2 * 8 + 4))
        scalars = (5 * 8 + 4 * 4 + 1) + (4 * 8 + 2 * 4 + 1)
        pw_rows = 3 * n * 8 + 8 if with_power else 0
        events = chunk * (4 * 8 + 4 + 8 + n_desc * 4 + 2 * 32)
        return K6 * (rows + scalars + pw_rows + events)

    buzen_rec = {
        "name": "buzen", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/buzen.cu",
        "replaces": "src/repro/kernels/buzen.py:85",
        "launches": launches["buzen"], "max_abs_err": buzen_err,
        "ms": times["buzen"]["kernel"][pick],
        "plain_ms": times["buzen"]["plain"][pick],
        "bound_ms": 1e3 * max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None}
    bwd_rec = {
        "name": "buzen_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/buzen.cu",
        "replaces": "src/repro/kernels/buzen.py:163",
        "launches": launches["buzen_backward"], "max_abs_err": bwd_err,
        "ms": times["buzen_backward"]["kernel"][pick],
        "plain_ms": times["buzen_backward"]["plain"][pick],
        "bound_ms": 1e3 * max(bwd_ops, bwd_bytes),
        "bound_by": "operations" if bwd_ops >= bwd_bytes else "bytes",
        "library_ms": None}
    event_rec = {
        "name": "event_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/events.cu",
        "replaces": "src/repro/kernels/events.py:205",
        "launches": launches["event_step"], "max_abs_err": lane_err,
        "ms": times[f"event_step m={m_star} E=1"]["kernel"][pick],
        "plain_ms": times[f"event_step m={m_star} E=1"]["plain"][pick],
        "bound_ms": 1e3 * lane_bytes(m_star, 1, False, 9) / PEAK_BYTES,
        "bound_by": "bytes", "library_ms": None}
    # the record is the megastep lane kernel at (m*, E = 8); phase 5
    # prints every shape
    rec_key = f"megastep m={m_star} E=8"
    mega_rec = {
        "name": "megastep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/events.cu",
        "replaces": "src/repro/kernels/events.py:311",
        "launches": launches["megastep"], "max_abs_err": lane_err,
        "ms": times[rec_key]["kernel"][pick],
        "plain_ms": times[rec_key]["plain"][pick],
        "bound_ms": 1e3 * lane_bytes(m_star, 8, False, 10) / PEAK_BYTES,
        "bound_by": "bytes", "library_ms": None}
    # w and g read once, w' written once, the scales in and the squared
    # norms out; four float32 operations per element
    fu_bytes = 3 * 4 * L4 * N4 + 2 * 4 * L4
    fu_ops = 4 * L4 * N4
    fu_bound_ms = 1e3 * max(fu_bytes / PEAK_BYTES, fu_ops / PEAK_F32_FLOPS)
    # the class kernel: the same terms over C5 columns; log_rho, counts
    # and log_gamma_total (float64) read, the output row written (float32)
    c_terms = B * C5 * (M + 1) * (M + 2) / 2
    c_ops = CLASS_OPS_PER_TERM * c_terms / PEAK_F32_FLOPS
    c_bytes = (8 * (2 * B * C5 + B) + 4 * B * (M + 1)) / PEAK_BYTES
    # its backward: both phases' float64 terms; log_rho, counts,
    # log_gamma_total and g in, their partials out
    cb_ops = BUZEN_BWD_OPS_PER_TERM * 2 * c_terms / PEAK_F64_FLOPS
    cb_bytes = 8 * (3 * B * C5 + 2 * B + B * (M + 1)) / PEAK_BYTES
    class_times, class_bwd_times = [{
        "ms": times[name]["kernel"][pick],
        "plain_ms": times[name]["plain"][pick],
        "bound_ms": 1e3 * max(ops, nbytes),
        "bound_by": "operations" if ops >= nbytes else "bytes",
        "library_ms": None} for name, ops, nbytes in (
            ("buzen_classes", c_ops, c_bytes),
            ("buzen_classes_backward", cb_ops, cb_bytes))]
    for name, t in times.items():
        extra = ""
        if name == "buzen":
            extra = (f"; bound {buzen_rec['bound_ms']:.6f} ms "
                     f"({BUZEN_OPS_PER_TERM} float32 operations a term, an "
                     f"exp counted as one, at 67 TFLOP/s); MUFU floor "
                     f"{mufu_ms:.6f} ms ({terms / 1e6:.1f} M exp2 at "
                     f"{MUFU_PER_CLOCK} a clock on {sms} SMs at "
                     f"{sm_clock_mhz:.0f} MHz)")
        if name == "buzen_backward":
            extra = (f"; bound {bwd_rec['bound_ms']:.6f} ms "
                     f"({2 * terms / 1e6:.1f} M float64 terms, "
                     f"{BUZEN_BWD_OPS_PER_TERM} operations each, an exp "
                     f"counted as one, at 34 TFLOP/s); the autograd "
                     f"recompute it replaces device {recompute[0]:.4f} ms / "
                     f"between events {recompute[1]:.4f} ms")
        if name in mega_shapes:
            bound = transition_bytes(*mega_shapes[name], 10) / PEAK_BYTES
            extra = f"; bound {1e3 * bound:.6f} ms (bytes)"
        if name == "event transition":
            bound = transition_bytes(m_star, 1, 9) / PEAK_BYTES
            extra = f"; bound {1e3 * bound:.6f} ms (bytes)"
        if name in lane_shapes:
            m, chunk, with_power = lane_shapes[name]
            bound = lane_bytes(m, chunk, with_power,
                               9 if chunk == 1 else 10) / PEAK_BYTES
            extra = (f"; bound {1e3 * bound:.6f} ms (bytes; a launch is "
                     f"the real floor)")
        if name == "fused_update":
            extra = f"; bound {fu_bound_ms:.6f} ms (bytes)"
        if name == "buzen_classes":
            extra = (f"; bound {class_times['bound_ms']:.6f} ms "
                     f"({class_times['bound_by']}; {1e3 * c_ops:.6f} by "
                     f"operations, {CLASS_OPS_PER_TERM} float32 operations "
                     f"a term at 67 TFLOP/s, {1e3 * c_bytes:.6f} by bytes); "
                     f"the whole call, series built in the kernel (the "
                     f"earlier design, fed a series built in PyTorch, on an "
                     f"H100 80GB HBM3 at 700 W: the whole call device "
                     f"0.0631 ms / between events 0.4490 ms, its DP alone "
                     f"device 0.0188 ms)")
        if name == "buzen_classes_backward":
            extra = (f"; bound {class_bwd_times['bound_ms']:.6f} ms "
                     f"({2 * c_terms / 1e6:.2f} M float64 terms, "
                     f"{BUZEN_BWD_OPS_PER_TERM} operations each, an exp "
                     f"counted as one, at 34 TFLOP/s); the autograd "
                     f"recompute it replaces device {c_recompute[0]:.4f} ms "
                     f"/ between events {c_recompute[1]:.4f} ms")
        log(f"phase 5: {name} {labels[name]}: "
            f"kernel device {t['kernel'][0]:.4f} ms / between events "
            f"{t['kernel'][1]:.4f} ms; plain device {t['plain'][0]:.4f} ms "
            f"/ between events {t['plain'][1]:.4f} ms{extra} ({card})")
    log(f"phase 5: the record's ms are "
        f"{'device' if profiled else 'between-event'} times")

    # -- 6. where the main path's time goes: device-busy share -------------
    results = {}
    windows = [
        ("sweep[kernel] 5 Adam steps",
         lambda: time_optimal(net, consts, m_max=M, steps=5,
                              backend="kernel"), None),
        ("sweep[torch] 5 Adam steps",
         lambda: time_optimal(net, consts, m_max=M, steps=5,
                              backend="torch"), None),
        ("class sweep[kernel, n=1e6] 5 Adam steps",
         lambda: time_optimal_classes(cls_big, consts, M, steps=5,
                                      backend="kernel"), None)]
    W = WINDOW_UPDATES
    sim_events = 3 * W + 3 * m_star + 8
    for be, chunk, pw in (("kernel", 1, None), ("kernel", 8, None),
                          ("kernel", 32, None), ("batched", 1, None),
                          ("kernel", 1, power), ("kernel", 8, power)):
        windows.append((
            f"simulate[{be}, E={chunk}{', power' if pw else ''}] 6 lanes "
            f"x {W} updates",
            lambda be=be, chunk=chunk, pw=pw: simulate_stats_lanes(
                [p_star] * 6, [m_star] * 6, W, seeds=range(6), power=pw,
                backend=be, chunk=chunk), sim_events))
    for name, fn, events in windows:
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        _, traced_ms, busy_ms = traced(fn)
        per_event = (f", {wall_ms / events:.4f} ms per lock-step event"
                     if events else "")
        log(f"phase 6: {name}: wall {wall_ms:.1f} ms{per_event}; device "
            f"busy {busy_share(traced_ms, busy_ms)}")
    # the energy integral rides along: same trajectory, finite energy
    plain_run = results[f"simulate[kernel, E=1] 6 lanes x {W} updates"]
    power_run = results[f"simulate[kernel, E=1, power] 6 lanes x {W} "
                        f"updates"]
    check(torch.equal(plain_run.throughput, power_run.throughput)
          and torch.equal(plain_run.mean_queue_counts,
                          power_run.mean_queue_counts),
          "power changed the simulated trajectory")
    check(bool(torch.isfinite(power_run.energy).all()
               and (power_run.energy > 0).all()),
          f"simulated energy {power_run.energy.tolist()}")
    for chunk in (8, 32):
        check(all(torch.equal(a, b) for a, b in zip(
            plain_run, results[f"simulate[kernel, E={chunk}] 6 lanes x {W} "
                               f"updates"])), f"window E={chunk} != E=1")

    # -- 7. training: AsyncSGD on the paper's CNN --------------------------
    fused_rec = train_phase(dev, net, n, p_star, m_star, lam_star)
    fused_rec.update({
        "max_abs_err": fused_err,
        "ms": times["fused_update"]["kernel"][pick],
        "plain_ms": times["fused_update"]["plain"][pick],
        "bound_ms": fu_bound_ms, "bound_by": "bytes", "library_ms": None})

    # -- 8. the class-aggregated path: n = 100 and n = 1e6 ----------------
    class_rec, class_bwd_rec, big_spec, big_res = class_phase(
        dev, consts, net, res_k, M)
    class_rec.update(class_times)
    class_bwd_rec.update(class_bwd_times)

    # -- 11. the Scenario API: resolution, from_scenario, the quickstart ---
    strategies = scenario_phase(dev, card, net, res_k, lam_star, big_spec,
                                big_res, M)

    # -- 12. ScenarioSuite: analyze, simulate, train, the examples ---------
    suite_phase(dev, card, res_k, lam_star, strategies, big_spec, big_res, M)

    # -- 13. the lognormal and hyperexponential laws ----------------------
    laws_phase(dev, card, net, n, p_star, m_star, lam_star)

    # -- 14. the key streams ----------------------------------------------
    threefry_rec = keys_phase(dev, card, p_star, m_star, threefry_main,
                              sm_clock_mhz)

    # -- 9. the dense LM's prefill: Qwen3-8B, kernel 6 ---------------------
    flash_rec = lm_phase(dev, card, seed)

    # -- 10. the dense LM's decode and the serve loop, kernel 7 -----------
    decode_rec = decode_phase(dev, card, seed)
    log(f"chip_smoke: phases 1-14 passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [buzen_rec, bwd_rec, event_rec, mega_rec,
                                  fused_rec, class_rec, class_bwd_rec,
                                  flash_rec, decode_rec, threefry_rec]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
