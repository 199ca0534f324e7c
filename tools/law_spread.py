"""Spread of the event engine's pooled lane throughput across seed sets.

For each timing law, ``--sets`` sets of 6 lanes (seeds ``6k .. 6k + 5``)
run at Table 1's time-optimal ``(p*, m*)`` (n = 100, ``time_optimal``
with ``m_max = 132``, 200 steps) for each depth in ``--updates`` (after
400 updates of warm-up, E = 8, the ``kernel`` route), and the script
prints each set's pooled throughput (updates over summed horizon), their
mean against Prop. 4 and their relative standard deviation: how far one
set of 6 lanes may read from another by chance.  On a card it uses the
CUDA kernels; with ``--device cpu`` their plain versions (the sweep then
takes about 12 minutes).

    PYTHONPATH=src python tools/law_spread.py [--device cpu]
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from repro_torch.core.jackson import throughput
from repro_torch.core.optimize import time_optimal
from repro_torch.scenario.spec import (PAPER_CLUSTERS_TABLE1, LearningSpec,
                                       NetworkSpec)
from repro_torch.sim import simulate_stats_lanes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sets", type=int, default=10)
    ap.add_argument("--updates", type=int, nargs="+", default=[1500, 15000])
    ap.add_argument("--laws", nargs="+",
                    default=["exponential", "hyperexponential", "lognormal"])
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).params(device=dev)
    res = time_optimal(net, LearningSpec().consts, m_max=132, steps=200,
                       backend="kernel" if dev.type == "cuda" else "torch")
    p_star = net._replace(p=res.p.detach())
    lam = float(throughput(p_star, res.m))
    print(f"(p*, m*={res.m}) on {dev}: Prop. 4 {lam:.6g}")
    for law in args.laws:
        for updates in args.updates:
            thr = []
            for k in range(args.sets):
                st = simulate_stats_lanes(
                    [p_star] * 6, [res.m] * 6, updates, warmup=400,
                    seeds=range(6 * k, 6 * k + 6), distribution=law,
                    backend="kernel", chunk=8)
                thr.append(float(st.updates.sum() / st.time.sum()))
            thr = np.asarray(thr)
            print(f"{law} {updates} updates x 6 lanes, {args.sets} sets: "
                  f"mean {thr.mean():.6g} (Prop. 4 {thr.mean() / lam - 1:+.4f}"
                  f"), relative std {thr.std(ddof=1) / thr.mean():.4f}; "
                  f"sets {np.round(thr, 5).tolist()}")


if __name__ == "__main__":
    main()
