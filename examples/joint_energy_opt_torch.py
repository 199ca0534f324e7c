"""Energy-aware scheduling on the PyTorch port (Section 6): trace the
time-energy Pareto frontier over rho and print the rho=0.1 operating point
the paper recommends (port of ``examples/joint_energy_opt.py``).

One energy-aware Scenario supplies the network, power profile and
constants; the strategy registry resolves the time-optimal reference and
the closed-form energy optimum through ``ScenarioSuite.run(mode=
"analyze")``, and the whole frontier, every (rho, m) pair, runs as one
further batched sweep (``pareto_sweep``).  On the card (the default) the
Buzen DP takes the hand-written CUDA kernels (``core.buzen.set_backend(
"kernel")``); ``--device cpu`` runs the plain float64 route.

Run:  PYTHONPATH=src python examples/joint_energy_opt_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import buzen
from repro_torch.core import (energy_complexity, minimal_energy,
                              pareto_sweep, wallclock_time)
from repro_torch.scenario import (EnergySpec, NetworkSpec,
                                  PAPER_CLUSTERS_TABLE1, Scenario,
                                  ScenarioSuite, StrategySpec)

RHOS = (0.0, 0.1, 0.3, 0.5, 0.8, 1.0)


def main(device="cuda", steps: int = 200) -> dict:
    """Trace the frontier on ``device`` with ``steps`` Adam steps per
    sweep; returns the printed numbers."""
    dev = torch.device(device)
    saved = buzen.get_backend()
    if dev.type == "cuda":
        buzen.set_backend("kernel")
    try:
        return _run(dev, steps)
    finally:
        buzen.set_backend(saved)


def _run(dev, steps) -> dict:
    scn = Scenario(
        network=NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10),
        energy=EnergySpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10),
        strategy=StrategySpec("time_opt", steps=steps, m_max=None),
        name="joint_energy")
    net, power, consts = (scn.params(device=dev), scn.power(device=dev),
                          scn.consts)
    labels = np.array(scn.network.labels)
    m_max = scn.n + 6
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    # the registry resolves both reference points ((p*_tau, m*_tau) by one
    # sweep over m = 2..n+6; (p*_E, m=1) in closed form)
    suite = ScenarioSuite.strategy_grid(scn, ("time_opt", "energy_opt"),
                                        device=dev, m_max=m_max)
    ana = suite.run(mode="analyze")
    tau_star = ana.entries["time_opt"]["tau"]
    m_star = ana.entries["time_opt"]["m"]
    e_star = float(minimal_energy(net, consts, power))
    print(f"time-optimal:   m*={m_star} tau*={tau_star:.1f} [{name}]")
    print(f"energy-optimal: m=1 E*={e_star:.1f} "
          f"(closed form p_i ∝ 1/sqrt(E_i), Eq. 16)")

    # the whole frontier, every (rho, m) pair, in one further sweep, with
    # rho as the batched objective's row context
    _, per_rho = pareto_sweep(net, consts, power, RHOS, tau_star, e_star,
                              m_max=m_max, steps=steps)

    print("\nPareto frontier (Eq. 18):")
    print(f"{'rho':>5} {'m*':>4} {'tau':>9} {'energy':>10}  type-E weight")
    frontier = []
    for rho, res in zip(RHOS, per_rho):
        prm = net._replace(p=res.p)
        tau = float(wallclock_time(prm, res.m, consts))
        en = float(energy_complexity(prm, res.m, consts, power))
        pE = float(res.p.cpu().numpy()[labels == "E"].mean())
        print(f"{rho:5.1f} {res.m:4d} {tau:9.1f} {en:10.1f}  {pE * 100:.2f}%")
        frontier.append({"rho": rho, "m": res.m, "tau": tau, "energy": en,
                         "pE": pE})
    return {"n": scn.n, "m_star": int(m_star), "tau_star": float(tau_star),
            "e_star": e_star, "frontier": frontier, "device": name}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    main(args.device, args.steps)
