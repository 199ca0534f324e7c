"""Paper-scale simulation on the PyTorch port: the full n = 100 population,
m = 132 tasks, through the ``repro_torch.sim`` backends (port of
``examples/paper_scale_sim.py``).

The Section-6 experiments need stationary statistics of the Fig. 1 closed
network at its real size.  One lane is inherently sequential (one event at
a time), so the run batches lanes — seeds here — into one lock-step loop
(``ScenarioSuite`` buckets them into one program).  On the card (the
default) the scenario pins ``SimSpec(backend="kernel")``, the event lane
kernels of ``repro_torch.kernels.events``; ``--device cpu`` pins
``"batched"``, the plain PyTorch transition.  The ``reference`` backend
runs the same lanes one by one and is the semantic (bitwise) baseline.

Run:  PYTHONPATH=src python examples/paper_scale_sim_torch.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import buzen, jackson
from repro_torch.scenario import (NetworkSpec, PAPER_CLUSTERS_TABLE1,
                                  Scenario, ScenarioSuite, SimSpec,
                                  StrategySpec)

N_SEEDS = 6
M = 132
UPDATES, WARMUP = 600, 400


def main(device="cuda", scale: int = 1, m: int = M, n_seeds: int = N_SEEDS,
         updates: int = UPDATES, warmup: int = WARMUP) -> dict:
    """Simulate Table 1 at ``scale`` (1: n = 100) with ``m`` tasks on
    ``n_seeds`` seed lanes; returns the printed numbers."""
    dev = torch.device(device)
    saved = buzen.get_backend()
    if dev.type == "cuda":
        buzen.set_backend("kernel")
    try:
        return _run(dev, scale, m, n_seeds, updates, warmup)
    finally:
        buzen.set_backend(saved)


def _run(dev, scale, M, n_seeds, updates, warmup) -> dict:
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=scale)
    sim = (SimSpec(backend="kernel", chunk=8) if dev.type == "cuda"
           else SimSpec(backend="batched"))  # pinned: survives to_dict/hash
    scn = Scenario(
        network=net,
        strategy=StrategySpec("explicit", p=np.full(net.n, 1.0 / net.n),
                              m=M),
        sim=sim, name="paper_scale")
    print(f"n={scn.n} clients, m={M} in-flight tasks, "
          f"{n_seeds} seed lanes, backend={scn.sim.backend!r}")

    suite = ScenarioSuite(scn, seeds=range(n_seeds), device=dev)
    t0 = time.time()
    res = suite.run(mode="simulate", num_updates=updates, warmup=warmup,
                    m_max=M)
    stats = res.entries["paper_scale"]
    thr = np.mean([float(s.throughput) for s in stats])  # waits for the card
    seconds = time.time() - t0
    print(f"  {res.lanes} lanes in {res.programs} program(s), "
          f"{seconds:.1f}s")

    lam = float(jackson.throughput(scn.params(scn.strategy.p, device=dev),
                                   M))
    p = np.asarray(scn.strategy.p)
    stale = np.mean([float(np.sum(p / p.sum()
                                  * s.mean_delay.cpu().numpy()))
                     for s in stats])
    print(f"  throughput {thr:.3f} vs closed form {lam:.3f} "
          f"({abs(thr - lam) / lam:.1%})")
    print(f"  staleness sum p_i E0[R_i] = {stale:.1f} vs m-1 = {M - 1} "
          f"({abs(stale - (M - 1)) / (M - 1):.1%})")

    # identical re-run: served from the suite-level result cache
    t0 = time.time()
    res2 = suite.run(mode="simulate", num_updates=updates, warmup=warmup,
                     m_max=M)
    rerun = time.time() - t0
    print(f"  re-run: {res2.cache_hits} cache hit(s) in {rerun:.3f}s")
    return {"n": scn.n, "m": M, "lanes": res.lanes, "programs": res.programs,
            "seconds": seconds, "throughput": float(thr),
            "closed_form": lam, "staleness": float(stale),
            "cache_hits": res2.cache_hits, "rerun_programs": res2.programs,
            "rerun_seconds": rerun, "backend": scn.sim.backend}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device)
