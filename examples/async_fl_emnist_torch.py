"""End-to-end example on the PyTorch port: Generalized AsyncSGD training on
synthetic-EMNIST (port of ``examples/async_fl_emnist.py``).

Reproduces the paper's Section 5.3 comparison (Figure 3 / Table 3): four
scheduling strategies training the same CNN on a Dirichlet(0.2) non-IID
heterogeneous client population, measured in *virtual wall-clock time*.

The whole experiment is FIVE lines of declarative Scenario API (network
spec -> strategy grid -> ``suite.run(mode="train")``): the strategy
registry resolves each (p, m), and the strategies x seeds grid runs as the
lanes of one lock-step trainer (``repro_torch.fl.engine``).  On the card
(the default) the Buzen sweeps and the event engine take the hand-written
CUDA kernels (``core.buzen.set_backend("kernel")``, ``SimSpec(backend=
"kernel")``); ``--device cpu`` runs the plain PyTorch versions.
``--backend host`` runs the event-at-a-time reference loop driven by the
exact per-task-identity simulator (``AsyncFLTrainer.from_scenario``).
``--scale 1`` is the paper's n = 100 population.

Run:  PYTHONPATH=src python examples/async_fl_emnist_torch.py [--horizon 240]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import buzen
from repro_torch.data import (dirichlet_partition,
                              make_synthetic_image_dataset, train_test_split)
from repro_torch.fl import AsyncFLTrainer, cnn_classifier
from repro_torch.scenario import (LearningSpec, NetworkSpec,
                                  PAPER_CLUSTERS_TABLE1, Scenario,
                                  ScenarioSuite, SimSpec)

STRATEGIES = ("asyncsgd", "max_throughput", "round_opt", "time_opt")


def main(device="cuda", horizon: float = 240.0, scale: int = 10,
         target: float = 0.6, distribution: str = "exponential",
         seeds: int = 1, backend: str = "device", steps: int = 200,
         samples_per_class: int = 120) -> dict:
    """Run the comparison on ``device``; returns, per strategy, ``m``,
    the final accuracy, the updates and the time to ``target`` accuracy,
    and the suite's ``lanes`` and ``programs``."""
    dev = torch.device(device)
    saved = buzen.get_backend()
    if dev.type == "cuda":
        buzen.set_backend("kernel")
    try:
        return _run(dev, horizon, scale, target, distribution, seeds,
                    backend, steps, samples_per_class)
    finally:
        buzen.set_backend(saved)


def _run(dev, horizon, scale, target, distribution, seeds, backend, steps,
         samples_per_class) -> dict:
    sim = SimSpec(backend="kernel", chunk=8) if dev.type == "cuda" else None
    # the 5-line declarative setup: one spec drives everything below
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale,
                                    law=distribution)
    base = Scenario(network=net, learning=LearningSpec(grad_clip=5.0),
                    sim=sim)
    suite = ScenarioSuite.strategy_grid(base, STRATEGIES,
                                        seeds=range(seeds), steps=steps,
                                        m_max=net.n + 6, device=dev)

    full = make_synthetic_image_dataset(num_classes=10,
                                        samples_per_class=samples_per_class)
    train, test = train_test_split(full, 0.2, seed=1)
    parts = dirichlet_partition(train.y, net.n, alpha=0.2, seed=0)
    clients = [(train.x[i], train.y[i]) for i in parts]

    results, out = {}, {"n": net.n, "strategies": {}}
    if backend == "device":
        grid = suite.run(mode="train", model=cnn_classifier(28, 10,
                                                            device=dev),
                         clients=clients, test_data=(test.x, test.y),
                         horizon_time=horizon, batch_size=32,
                         eval_every_time=horizon / 40)
        out.update(lanes=grid.lanes, programs=grid.programs)
        print(f"[lane trainer on {dev.type}: {grid.lanes} lanes in "
              f"{grid.programs} programs]")
        for name, logs in grid.entries.items():
            t_hit = float(np.mean([lg.time_to_accuracy(target)
                                   for lg in logs]))
            results[name] = t_hit
            acc = float(np.mean([lg.accuracies[-1] for lg in logs]))
            upd = int(np.mean([lg.updates[-1] for lg in logs]))
            m = grid.strategies[name][1]
            out["strategies"][name] = dict(m=m, final_acc=acc, updates=upd,
                                           t_hit=t_hit)
            print(f"{name:>15}: m={m:3d}  final_acc={acc:.3f}  "
                  f"updates={upd:6d}  t(acc>={target})={t_hit:.1f}")
    else:
        for name, scn in suite.scenarios.items():
            tr = AsyncFLTrainer.from_scenario(
                scn, cnn_classifier(28, 10, device=dev), clients,
                test_data=(test.x, test.y), backend="host", batch_size=32,
                eval_every_time=horizon / 40, device=dev)
            log = tr.run(horizon_time=horizon)
            t_hit = log.time_to_accuracy(target)
            results[name] = t_hit
            out["strategies"][name] = dict(
                m=tr.m, final_acc=log.accuracies[-1],
                updates=log.updates[-1], t_hit=t_hit)
            print(f"{name:>15}: m={tr.m:3d}  "
                  f"final_acc={log.accuracies[-1]:.3f}  "
                  f"updates={log.updates[-1]:6d}  "
                  f"t(acc>={target})={t_hit:.1f}")

    base_t = results.get("asyncsgd", float("inf"))
    if np.isfinite(results.get("time_opt", np.inf)) and np.isfinite(base_t):
        out["faster"] = 100 * (1 - results["time_opt"] / base_t)
        print(f"\ntime-optimized reaches {target:.0%} "
              f"{out['faster']:.1f}% faster than AsyncSGD (paper Table 3: "
              "29-46%)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizon", type=float, default=240.0)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--target", type=float, default=0.6)
    ap.add_argument("--distribution", default="exponential")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per strategy (each a lane of the trainer)")
    ap.add_argument("--backend", choices=("device", "host"), default="device")
    args = ap.parse_args()
    main(args.device, args.horizon, args.scale, args.target,
         args.distribution, args.seeds, args.backend)
