"""Closed-form drift monitors: ring empirics against the product-form
theory (port of ``repro.obs.drift``).

The planning surface (``repro_torch.core.batched``) predicts the
stationary behaviour of the closed queueing network in closed form —
throughput ``lambda(p, m)`` (Thm 1), the expected relative delays
``E0[R_i]`` (Thm 2) and the task-conservation invariant (the closed
network holds exactly ``m`` tasks at all times).  The telemetry rings
(``repro_torch.obs.rings``) record what the event engine did.
:func:`drift_report` estimates the same quantities from a decoded ring
and flags any that leave the relative-tolerance band around the
prediction.

A drift breach means one of three things, all worth an alarm:

  * the simulated scale is too small for stationarity (tolerance or
    warmup too tight for the run length — a *configuration* problem);
  * the engine and the closed forms have diverged (a *correctness*
    problem);
  * the scenario left the closed forms' domain (non-exponential law:
    the throughput/staleness checks are skipped — Thm 1/2 are
    product-form results — and only conservation is asserted).

Everything but :func:`predict` is host-side numpy on decoded rings, the
JAX package's code as it stands.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["predict", "empirical", "drift_report"]

_TINY = 1e-12


def predict(params, m, *, m_max: Optional[int] = None) -> dict:
    """Closed-form predictions for one client network at concurrency ``m``.

    ``throughput`` and the per-client relative delays ``delays``
    (``E0[D_i] = p_i E0[R_i]``, Thm 2) come from the padded product-form
    functions of ``repro_torch.core.batched`` on the process-wide Buzen
    backend; ``occupancy`` is the conservation constant ``m``.  NOT
    predicted: the update-weighted mean staleness — it is identically ``m
    - 1`` for any law (each completion sees the other ``m - 1`` in-flight
    tasks finish exactly once in between), so the staleness drift check
    compares the per-client *profile* instead.  Valid for the exponential
    law (see the module docstring).
    """
    import torch

    from ..core.batched import (expected_relative_delay_padded,
                                throughput_padded)
    from ..core.buzen import log_normalizing_constants
    from ..core.events import stack_lanes

    mx = int(m) if m_max is None else int(m_max)
    one = stack_lanes([params])
    m_t = torch.as_tensor([int(m)], device=params.p.device)
    logZ = log_normalizing_constants(one, mx)
    thr = float(throughput_padded(logZ, m_t)[0])
    delays = expected_relative_delay_padded(one, m_t, logZ, mx)[0]
    return {"throughput": thr,
            "delays": [float(d) for d in delays.detach().cpu().tolist()],
            "occupancy": float(int(m))}


def empirical(decoded: dict, *, n: Optional[int] = None,
              burn: float = 0.25) -> dict:
    """Ring estimates of the predicted quantities.

    ``decoded`` is one lane's :func:`repro_torch.obs.rings.decode` output.  The
    first ``burn`` fraction of recorded *update* events is discarded
    (transient suppression — the ring usually starts at the simulation's
    own warmup, but a wrapped ring starts wherever it wrapped).
    ``delays`` is the per-client ``E0[D_i]`` estimator ``(updates from
    i / updates) * mean(R | client i)`` — i.e. client ``i``'s share of
    the total recorded staleness — sized by ``n`` (default: largest
    client index seen + 1).  Keys missing when inestimable (fewer than
    two post-burn updates).
    """
    t = np.asarray(decoded["time"], dtype=np.float64)
    upd = np.asarray(decoded["update"]) != 0
    out: dict = {}
    if t.size:
        occ = _mean_total_occupancy(decoded)
        if occ is not None:
            out["occupancy"] = occ
    ut = t[upd]
    ud = np.asarray(decoded["delay"], dtype=np.float64)[upd]
    uc = np.asarray(decoded["client"])[upd]
    skip = int(len(ut) * float(burn))
    ut, ud, uc = ut[skip:], ud[skip:], uc[skip:]
    if len(ut) >= 2 and ut[-1] > ut[0]:
        out["throughput"] = float((len(ut) - 1) / (ut[-1] - ut[0]))
        n_eff = int(uc.max()) + 1 if n is None else int(n)
        d = np.bincount(uc, weights=ud, minlength=n_eff) / len(ut)
        out["delays"] = [float(v) for v in d[:n_eff]]
    return out


def _mean_total_occupancy(decoded: dict) -> Optional[float]:
    """Time-averaged number of in-flight tasks reconstructed from the ring.

    Each event row moves task ``slot`` from ``station`` to ``station_to``
    at ``time``; between consecutive events of a slot the task sits at the
    later event's *from*-station, and that from-station also extends back
    past the window start (it is wherever the previous — unrecorded —
    event left the task).  Integrating the per-slot coverage over the
    window therefore counts every slot that produced at least one event:
    for a healthy engine this equals ``m`` exactly (task conservation),
    and any gap means events were lost or mis-attributed.
    """
    t = np.asarray(decoded["time"], dtype=np.float64)
    slots = np.asarray(decoded["slot"])
    if t.size < 2:
        return None
    t0, t1 = float(t[0]), float(t[-1])
    if int(decoded.get("dropped", 0)) == 0:
        t0 = 0.0  # full history: the window opens at the simulation start
    if not t1 > t0:
        return None
    covered = 0.0
    for j in np.unique(slots):
        tj = t[slots == j]
        # [t0, first event]: the from-station span reaching back into the
        # window; [last event, t1]: the station_to tail
        covered += (min(float(tj[0]), t1) - t0) + (t1 - min(float(tj[-1]), t1))
        if len(tj) > 1:
            covered += float(tj[-1] - tj[0])
    return covered / (t1 - t0)


def drift_report(decoded: dict, *, params=None, m: Optional[int] = None,
                 predictions: Optional[dict] = None,
                 law: str = "exponential", tolerance: float = 0.25,
                 burn: float = 0.25) -> dict:
    """Compare one lane's ring against the closed forms.

    Predictions come from ``predictions`` (a prior :func:`predict` output,
    e.g. re-checking an exported trace file) or are computed from
    ``(params, m)``.  Non-exponential laws keep only the conservation
    check.  Returns a JSON-friendly report::

        {"ok": bool, "law": str, "tolerance": float,
         "checks": [{"metric", "empirical", "predicted",
                     "rel_err", "tol", "ok"}, ...]}

    Check semantics: ``throughput`` — plain relative error;
    ``staleness`` — total-variation distance between the per-client
    delay profiles, ``sum_i |D_emp_i - D_pred_i| / sum_i D_pred_i``
    (the scalars report the profile sums, both ``~ m - 1`` by the
    conservation identity — the *profile* carries the Thm 2 signal);
    ``occupancy`` — held to the tighter of ``tolerance`` and 1%, since
    conservation is exact in theory and a loose user band must not mask
    a broken ring.
    """
    if predictions is None:
        if params is None or m is None:
            raise ValueError("drift_report needs either predictions= or "
                             "both params= and m=")
        predictions = predict(params, m)
    n = (len(predictions["delays"])
         if isinstance(predictions.get("delays"), (list, tuple)) else None)
    emp = empirical(decoded, n=n, burn=burn)
    tol = float(tolerance)
    checks = []
    exp_law = law == "exponential"  # product-form domain (module docstring)
    if exp_law and "throughput" in predictions and "throughput" in emp:
        pred, got = float(predictions["throughput"]), float(emp["throughput"])
        rel = abs(got - pred) / max(abs(pred), _TINY)
        checks.append({"metric": "throughput", "empirical": got,
                       "predicted": pred, "rel_err": float(rel),
                       "tol": tol, "ok": bool(rel <= tol)})
    if exp_law and "delays" in predictions and "delays" in emp:
        dp = np.asarray(predictions["delays"], dtype=np.float64)
        de = np.asarray(emp["delays"], dtype=np.float64)
        k = min(len(dp), len(de))
        dp, de = dp[:k], de[:k]
        rel = float(np.sum(np.abs(de - dp)) / max(np.sum(dp), _TINY))
        checks.append({"metric": "staleness", "empirical": float(de.sum()),
                       "predicted": float(dp.sum()), "rel_err": rel,
                       "tol": tol, "ok": bool(rel <= tol)})
    if "occupancy" in predictions and "occupancy" in emp:
        t_m = min(tol, 0.01)
        pred, got = float(predictions["occupancy"]), float(emp["occupancy"])
        rel = abs(got - pred) / max(abs(pred), _TINY)
        checks.append({"metric": "occupancy", "empirical": got,
                       "predicted": pred, "rel_err": float(rel),
                       "tol": t_m, "ok": bool(rel <= t_m)})
    return {"ok": all(c["ok"] for c in checks), "law": str(law),
            "tolerance": tol, "checks": checks}
