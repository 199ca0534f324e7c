"""The JAX package's answers for ``chip_smoke.py`` phase 15's claims.

Runs, with the JAX package on the CPU, the configurations of the JAX
benches that phase 15 rebuilds on the port (``benchmarks/
bench_concurrency_sweep.py::run(scale=10, steps=150)``, ``bench_pareto.py::
run(scale=10, steps=150)``, ``bench_tau_surface.py``, ``bench_routing_table.
py::run(scale=5, steps=250)`` and ``bench_round_optimization.py::run(scale=5,
steps=300)``), each bench's computation written out so that the discrete
optima and the values behind its claims come back as numbers, and prints
them as the Python literal that ``chip_smoke.py`` holds as
``JAX_SEARCH_ANSWERS``.  It takes a few minutes.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/jax_search_answers.py
"""
from __future__ import annotations

import pprint

import jax.numpy as jnp
import numpy as np

import repro.core.numerics  # noqa: F401  (float64 mode)
from benchmarks.scenarios import (table1_scenario, table6_scenario,
                                  two_client_scenario)
from repro.core import (batched_concurrency_sweep, expected_relative_delay,
                        make_energy_objective_padded,
                        make_time_objective_padded, minimal_energy,
                        objective_surface, pareto_sweep,
                        pruned_concurrency_sweep)
from repro.core.batched import tau_surface
from repro.scenario import ScenarioSuite, get_objective

RHOS = (0.0, 0.1, 0.3, 0.5, 0.8, 1.0)
STRATEGIES = ("asyncsgd", "max_throughput", "round_opt", "time_opt")


def fig8(scale=10, steps=150) -> dict:
    scn = table1_scenario(scale, strategy="time_opt", steps=steps)
    params, n = scn.params(), scn.n
    m_max = n + 5
    obj = get_objective(scn.objective.name).padded(
        params, scn.consts, scn.power(), None, m_max)
    full = batched_concurrency_sweep(obj, params,
                                     m_grid=jnp.arange(1, m_max + 1),
                                     m_max=m_max, steps=steps)
    pruned = pruned_concurrency_sweep(obj, params,
                                      m_grid=jnp.arange(1, m_max + 1),
                                      m_max=m_max, steps=steps)
    vals = dict(full.best.history)
    return {"n": n, "m_max": m_max, "m_star": full.best.m,
            "tau_star": full.best.value, "tau_m1": vals[1],
            "tau_mn": vals[n], "pruned_m": pruned.best.m,
            "pruned_rows": len(pruned.values),
            "pruned_value": pruned.best.value}


def fig4(scale=10, steps=150) -> dict:
    scn = table1_scenario(scale, strategy="joint", with_power=True,
                          steps=steps)
    params, power, consts, n = scn.params(), scn.power(), scn.consts, scn.n
    labels = np.array(scn.network.labels)
    m_max = n + 6
    tau_res = batched_concurrency_sweep(
        make_time_objective_padded(params, consts, m_max), params,
        m_grid=jnp.arange(2, m_max + 1), steps=steps)
    e_star = float(minimal_energy(params, consts, power))
    _, per_rho = pareto_sweep(params, consts, power, RHOS,
                              tau_res.best.value, e_star, m_max=m_max,
                              steps=steps)
    p_rows = jnp.stack([r.p for r in per_rho])
    m_rows = jnp.asarray([r.m for r in per_rho])
    taus = objective_surface(make_time_objective_padded(params, consts,
                                                        m_max),
                             params, p_rows, m_rows, m_max=m_max)
    ens = objective_surface(make_energy_objective_padded(params, consts,
                                                         power, m_max),
                            params, p_rows, m_rows, m_max=m_max)
    return {"n": n, "m_max": m_max, "tau_m": tau_res.best.m,
            "tau_star": tau_res.best.value, "e_star": e_star,
            "m_rho": [r.m for r in per_rho],
            "tau_rho": [float(x) for x in np.asarray(taus)],
            "energy_rho": [float(x) for x in np.asarray(ens)],
            "pE_rho": [float(np.asarray(r.p)[labels == "E"].mean())
                       for r in per_rho]}


def fig2() -> dict:
    out = {}
    p1s = np.linspace(0.1, 0.9, 17)
    ms = np.arange(1, 25)
    for mu2 in (1.0, 3.0):
        scn = two_client_scenario(mu2)
        grid = np.asarray(tau_surface(scn.params(p=[0.5, 0.5]), scn.consts,
                                      ms, np.stack([p1s, 1.0 - p1s], -1)))
        mi, pj = np.unravel_index(int(np.argmin(grid)), grid.shape)
        out[mu2] = {"m_star": int(ms[mi]), "p1_index": int(pj),
                    "tau_star": float(grid.min()),
                    "tau_m1": float(grid[0].min())}
    return out


def table2(scale=5, steps=250) -> dict:
    base = table1_scenario(scale, strategy="time_opt", steps=steps)
    suite = ScenarioSuite.strategy_grid(base, STRATEGIES, m_max=base.n + 8)
    res = suite.run(mode="analyze")
    return {"n": base.n, "programs": res.programs,
            "m": {k: int(res.entries[k]["m"]) for k in STRATEGIES},
            "lambda": {k: float(res.entries[k]["throughput"])
                       for k in STRATEGIES}}


def table7(scale=5, steps=300) -> dict:
    base = table6_scenario(scale, steps=steps)
    params, n = base.params(), base.n
    labels = np.array(base.network.labels)
    suite = ScenarioSuite.strategy_grid(base, ("asyncsgd", "round_opt"), m=n)
    res = suite.run(mode="analyze")
    p = np.asarray(res.entries["round_opt"]["p"])

    def max_impact(pv):
        d = np.asarray(expected_relative_delay(
            params._replace(p=jnp.asarray(pv)), n))
        return float((d / np.maximum(np.asarray(pv), 1e-12) ** 2).max())

    return {"n": n, "K_uni": float(res.entries["asyncsgd"]["K_eps"]),
            "K_opt": float(res.entries["round_opt"]["K_eps"]),
            "pD": float(p[labels == "D"].mean()),
            "pE": float(p[labels == "E"].mean()),
            "impact_uni": max_impact(res.entries["asyncsgd"]["p"]),
            "impact_opt": max_impact(p)}


if __name__ == "__main__":
    pprint.pprint({"fig8": fig8(), "fig4": fig4(), "fig2": fig2(),
                   "table2": table2(), "table7": table7()}, sort_dicts=False,
                  width=76)
