"""Wall time of the pruned concurrency search against the full sweep.

Times ``batched_concurrency_sweep`` (every ``m`` of ``2..m_max``) and
``pruned_concurrency_sweep`` (a strided coarse pass, then a warm-started
refinement) on Table 1 at ``--scale`` (1: n = 100), in turns (full,
pruned, pruned, full), on ``--device`` with the ``--backend`` Buzen route,
and prints each run's seconds, the rows each evaluated and both optima.
The card's numbers come from ``chip_smoke.py`` phase 15a; this script is
for the host's plain route, where the work grows with the rows.

    PYTHONPATH=src python tools/pruned_vs_full.py --device cpu --steps 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (batched_concurrency_sweep,
                              make_time_objective_padded,
                              pruned_concurrency_sweep)
from repro_torch.scenario.spec import (PAPER_CLUSTERS_TABLE1, LearningSpec,
                                       NetworkSpec)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "kernel"))
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--m-max", type=int, default=132)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    dev = torch.device(args.device)
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1,
                                    args.scale).params(device=dev)
    obj = make_time_objective_padded(net, LearningSpec().consts, args.m_max)
    kw = dict(m_grid=np.arange(2, args.m_max + 1), m_max=args.m_max,
              steps=args.steps, backend=args.backend)
    engines = {"full": batched_concurrency_sweep,
               "pruned": pruned_concurrency_sweep}
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"n={net.n}, m = 2..{args.m_max}, {args.steps} steps, "
          f"{args.backend} route on {name}")
    for which in ("full", "pruned", "pruned", "full"):
        t0 = time.perf_counter()
        res = engines[which](obj, net, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"  {which}: {time.perf_counter() - t0:.3f} s, "
              f"{len(res.values)} rows, m*={res.best.m}, "
              f"tau*={res.best.value:.10g}", flush=True)


if __name__ == "__main__":
    main()
