"""JSON-lines wire protocol for the suite server (port of
``repro.serve.protocol``; the same wire format).

One request per line, one JSON object per line back; the same bitwise
format ``Scenario.to_json`` already guarantees (Python ``json`` emits
``repr``-exact floats, so every float in a response round-trips
bit-identically — the serve tests compare payloads against direct
``ScenarioSuite.run`` results for equality, not tolerance).

Requests::

    {"id": "r1", "verb": "run", "mode": "simulate",
     "scenario": {...Scenario.to_dict()...}, "seeds": [0, 1],
     "options": {"num_updates": 200}}
    {"id": "s1", "verb": "stats"}
    {"id": "m1", "verb": "metrics"}
    {"id": "d1", "verb": "shutdown"}

Streamed responses for a ``run`` (all tagged with the request id)::

    {"id": "r1", "event": "accepted"}
    {"id": "r1", "event": "scheduled", "requests": 2, "lanes": 4}
    {"id": "r1", "event": "result", "cached": false, "value": ...}

Any failure becomes ``{"event": "error", "error": {"type", "message"}}``
— a structured reply on the wire, never a dead server process.  The
port's eager spec validation refuses what only the JAX package runs (the
``pallas`` sim backend, a non-null ``SimSpec.interpret``) the same way, as
a structured error; ``sharded`` runs, its lanes split over the server's
local CUDA devices (:mod:`repro_torch.sim.sharded`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..scenario import Scenario

MODES = ("analyze", "simulate", "train")
VERBS = ("run", "stats", "metrics", "shutdown")

#: options accepted per mode (anything else is a structured error — an
#: unknown knob silently ignored would poison bitwise reproducibility)
RUN_OPTIONS = {
    "analyze": frozenset(),
    "simulate": frozenset({"num_updates", "warmup", "m_max", "backend"}),
    "train": frozenset({"horizon_time", "model", "max_updates",
                        "batch_size", "eval_every_time", "eval_batch"}),
}

#: admission bound on any requested/resolved task-table size: a huge
#: ``m_max`` would build (and resident-cache) an absurd runner
MAX_M = 4096
#: admission bound on request-line length (8 MiB)
MAX_LINE = 8 * 1024 * 1024


class WireError(Exception):
    """A structured protocol error: ``type`` + ``message`` (+ the request
    id when one could be parsed)."""

    def __init__(self, etype: str, message: str,
                 req_id: Optional[str] = None):
        super().__init__(message)
        self.etype = etype
        self.req_id = req_id

    def to_msg(self) -> dict:
        return {"id": self.req_id, "event": "error",
                "error": {"type": self.etype, "message": str(self)}}


@dataclasses.dataclass
class Request:
    """A validated ``run`` request (``stats``/``shutdown`` never build
    one — they are answered inline by the connection reader)."""

    id: str
    mode: str
    scenario: Scenario
    seeds: tuple
    options: dict
    # filled by the server: admission timestamp for latency accounting,
    # and the originating transport to stream responses back through
    t_admit: float = 0.0
    transport: object = None


def encode(msg: dict) -> bytes:
    """One response line (compact separators, trailing newline)."""
    return (json.dumps(msg, separators=(",", ":")) + "\n").encode()


def decode_line(line: bytes) -> dict:
    if len(line) > MAX_LINE:
        raise WireError("ProtocolError",
                        f"request line exceeds {MAX_LINE} bytes")
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        raise WireError("ProtocolError", f"malformed JSON: {e}") from e
    if not isinstance(msg, dict):
        raise WireError("ProtocolError",
                        f"expected a JSON object, got {type(msg).__name__}")
    return msg


def parse_request(msg: dict) -> Request:
    """Validate a decoded ``run`` message into a :class:`Request`.

    Raises :class:`WireError` (carrying the request id whenever one is
    present) for every malformed field — unknown verbs/modes/options,
    non-Scenario payloads, unknown law/strategy names (surfaced by the
    spec's eager validation), and oversized ``m_max``.
    """
    req_id = msg.get("id")
    if not isinstance(req_id, str) or not req_id:
        raise WireError("ProtocolError", "request needs a string 'id'")
    mode = msg.get("mode", "analyze")
    if mode not in MODES:
        raise WireError("ProtocolError",
                        f"unknown mode {mode!r}; expected one of {MODES}",
                        req_id)
    scn_dict = msg.get("scenario")
    if not isinstance(scn_dict, dict):
        raise WireError("ProtocolError",
                        "request needs a 'scenario' object "
                        "(Scenario.to_dict() format)", req_id)
    try:
        scenario = Scenario.from_dict(scn_dict)
    except Exception as e:  # eager spec validation: unknown law/strategy/...
        raise WireError(type(e).__name__, str(e), req_id) from e
    seeds = msg.get("seeds", [0])
    if (not isinstance(seeds, list) or not seeds
            or not all(isinstance(s, int) for s in seeds)):
        raise WireError("ProtocolError",
                        "'seeds' must be a non-empty list of ints", req_id)
    options = msg.get("options", {})
    if not isinstance(options, dict):
        raise WireError("ProtocolError", "'options' must be an object",
                        req_id)
    unknown = set(options) - RUN_OPTIONS[mode]
    if unknown:
        raise WireError(
            "ProtocolError",
            f"unknown option(s) for mode {mode!r}: {sorted(unknown)}; "
            f"accepted: {sorted(RUN_OPTIONS[mode])}", req_id)
    if mode == "simulate" and "num_updates" not in options:
        raise WireError("ProtocolError",
                        "mode 'simulate' needs options.num_updates", req_id)
    if mode == "train":
        for need in ("horizon_time", "model"):
            if need not in options:
                raise WireError("ProtocolError",
                                f"mode 'train' needs options.{need}", req_id)
    m_req = options.get("m_max")
    if m_req is not None and int(m_req) > MAX_M:
        raise WireError("ProtocolError",
                        f"m_max={m_req} exceeds the server bound {MAX_M}",
                        req_id)
    if scenario.strategy.name == "explicit" and scenario.strategy.m and \
            int(scenario.strategy.m) > MAX_M:
        raise WireError("ProtocolError",
                        f"strategy m={scenario.strategy.m} exceeds the "
                        f"server bound {MAX_M}", req_id)
    if mode == "train" and scenario.data is None:
        raise WireError("ProtocolError",
                        "mode 'train' over the wire needs a DataSpec on "
                        "the scenario (client datasets are built "
                        "server-side)", req_id)
    return Request(id=req_id, mode=mode, scenario=scenario,
                   seeds=tuple(int(s) for s in seeds), options=dict(options))


# -- result payload encoding (mode-specific, repr-exact floats) -------------


def _listify(x) -> list:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).tolist()


def encode_entry(mode: str, entry) -> object:
    """A suite entry as a JSON-able payload.

    Tensors come to the host before they are listified, each in its own
    dtype, so the same JSON types go out as from the JAX package: ints as
    ints, float64 as ``repr``-exact floats.

    ``analyze``: the closed-form dict with arrays listified.
    ``simulate``: per-seed list of EventStats field dicts.
    ``train``: per-seed list of TrainLog field dicts.
    """
    if mode == "analyze":
        out = dict(entry)
        out["p"] = _listify(out["p"])
        out["delays"] = _listify(out["delays"])
        out["m"] = int(out["m"])
        return out
    if mode == "simulate":
        return [{"updates": int(st.updates), "time": float(st.time),
                 "throughput": float(st.throughput),
                 "mean_delay": _listify(st.mean_delay),
                 "delay_counts": _listify(st.delay_counts),
                 "energy": float(st.energy),
                 "mean_queue_counts": _listify(st.mean_queue_counts)}
                for st in entry]
    if mode == "train":
        return [{"times": _listify(log.times),
                 "accuracies": _listify(log.accuracies),
                 "losses": _listify(log.losses),
                 "updates": _listify(log.updates),
                 "mean_delay": (None if log.mean_delay is None
                                else _listify(log.mean_delay)),
                 "throughput": float(log.throughput),
                 "energy": float(log.energy)}
                for log in entry]
    raise ValueError(f"unknown mode: {mode!r}")
