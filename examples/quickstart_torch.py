"""Quickstart on the PyTorch port: the paper's queueing analysis in ten lines
(port of ``examples/quickstart.py``).

Builds the paper's Table-1 client population, computes closed-form relative
delays / throughput / wall-clock complexity, optimizes routing+concurrency,
and cross-checks against the discrete-event simulator.  On the card (the
default) the Buzen sweep and the event engine take the hand-written CUDA
kernels (``core.buzen.set_backend("kernel")``, ``sim.set_backend("kernel")``);
``--device cpu`` runs the plain PyTorch versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import sim as sim_backend
from repro_torch.core import buzen
from repro_torch.core import (expected_relative_delay, simulate_stats,
                              throughput, time_optimal, wallclock_time)
from repro_torch.core.simulator import AsyncNetworkSim
from repro_torch.scenario import (NetworkSpec, PAPER_CLUSTERS_TABLE1,
                                  Scenario, StrategySpec)


def main(device="cuda", steps: int = 200, updates: int = 40_000) -> dict:
    """Run the quickstart on ``device``; ``steps`` Adam steps for the
    sweep, ``updates`` simulated updates (after ``updates // 8`` of
    warm-up).  Returns the printed numbers."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    saved = buzen.get_backend(), sim_backend.get_backend()
    if dev.type == "cuda":
        buzen.set_backend("kernel")
        sim_backend.set_backend("kernel")
    try:
        return _run(dev, name, steps, updates)
    finally:
        buzen.set_backend(saved[0])
        sim_backend.set_backend(saved[1])


def _run(dev, name, steps, updates) -> dict:
    # the paper's heterogeneous population (Table 1), scaled to 11 clients,
    # as ONE declarative spec (network + constants + strategy)
    scn = Scenario(
        network=NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10),
        strategy=StrategySpec("time_opt", steps=steps),
        name="quickstart")
    net, consts = scn.params(device=dev), scn.consts
    n, m = scn.n, scn.n

    # closed-form stationary analysis (Theorem 2 / Proposition 4)
    delays = expected_relative_delay(net, m)
    lam = float(throughput(net, m))
    tau = float(wallclock_time(net, m, consts))
    print(f"n={n} clients, m={m} tasks (AsyncSGD defaults) [{name}]")
    print(f"  E0[D_i] = {np.round(delays.cpu().numpy(), 2)}  "
          f"(sum = {float(torch.sum(delays)):.2f} = m-1)")
    print(f"  throughput lambda = {lam:.3f} updates/unit-time")
    print(f"  E0[tau_eps]      = {tau:.1f}")

    # validate against both simulators: the device event engine (the hot
    # path) and the exact per-task-identity host reference
    warmup = updates // 8
    dev_stats = simulate_stats(net, m, updates, warmup=warmup, seed=0)
    host = AsyncNetworkSim(net, m, seed=0).run(updates, warmup=warmup)
    lam_dev = float(dev_stats.throughput)
    print(f"  device-engine lambda = {lam_dev:.3f}, "
          f"host-reference lambda = {host.throughput:.3f}  "
          f"(closed form {lam:.3f}) [{name}]")

    # jointly optimize routing + concurrency for wall-clock time (Section 5):
    # one batched sweep over every candidate m
    res = time_optimal(net, consts, m_max=n + 6, steps=steps)
    print(f"\ntime-optimized: m* = {res.m}, "
          f"tau* = {res.value:.1f} vs uniform {tau:.1f} "
          f"({100 * (1 - res.value / tau):.0f}% faster) [{name}]")
    p_star = res.p.detach().cpu().numpy()
    print(f"  p* = {np.round(p_star, 4)}")
    return {"n": n, "m": m, "delays": delays.cpu().numpy(), "lambda": lam,
            "tau": tau, "device_lambda": lam_dev,
            "host_lambda": float(host.throughput), "m_star": res.m,
            "tau_star": float(res.value), "p_star": p_star,
            "device": name}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--updates", type=int, default=40_000)
    args = ap.parse_args()
    main(args.device, args.steps, args.updates)
