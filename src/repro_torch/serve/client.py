"""Blocking JSON-lines client for the suite server (port of
``repro.serve.client``; the standard library only).

One :class:`ServeClient` per connection; requests may be pipelined
(submit several, then collect) — responses are demultiplexed by request
id.  Used by the tests, ``chip_smoke.py`` and
``examples/serve_client_torch.py``.
"""
from __future__ import annotations

import itertools
import json
import socket
from typing import Optional

from .protocol import encode


class ServeError(RuntimeError):
    """A structured server-side error, re-raised client-side."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype


class ServeClient:
    def __init__(self, socket_path: str, timeout: Optional[float] = 300.0):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._rfile = self._sock.makefile("rb")
        self._ids = itertools.count()
        self._done: dict = {}      # id -> terminal (result/error) message
        self._events: dict = {}    # id -> non-terminal events seen

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low level ----------------------------------------------------------

    def send(self, msg: dict) -> None:
        self._sock.sendall(encode(msg))

    def send_raw(self, line: bytes) -> None:
        """Ship arbitrary bytes (protocol-error tests)."""
        self._sock.sendall(line)

    def _read_msg(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def collect(self, req_id: str) -> dict:
        """Block until the terminal (result/error) message for ``req_id``;
        non-terminal events (accepted/scheduled) are recorded in
        ``events_for``."""
        while req_id not in self._done:
            msg = self._read_msg()
            mid = msg.get("id")
            if msg.get("event") in ("result", "error"):
                self._done[mid] = msg
            else:
                self._events.setdefault(mid, []).append(msg)
        return self._done.pop(req_id)

    def events_for(self, req_id: str) -> list:
        return self._events.get(req_id, [])

    # -- verbs --------------------------------------------------------------

    def submit(self, scenario, mode: str = "analyze", seeds=(0,),
               **options) -> str:
        """Fire a run request; returns its id (collect later)."""
        req_id = f"r{next(self._ids)}"
        scn = scenario if isinstance(scenario, dict) else scenario.to_dict()
        self.send({"id": req_id, "verb": "run", "mode": mode,
                   "scenario": scn, "seeds": list(seeds),
                   "options": options})
        return req_id

    def run(self, scenario, mode: str = "analyze", seeds=(0,), **options):
        """Submit + block for the payload; raises :class:`ServeError` on a
        structured error."""
        msg = self.collect(self.submit(scenario, mode, seeds, **options))
        return self.unwrap(msg)

    @staticmethod
    def unwrap(msg: dict):
        if msg.get("event") == "error":
            err = msg.get("error", {})
            raise ServeError(err.get("type", "Error"),
                             err.get("message", ""))
        return msg["value"]

    def stats(self) -> dict:
        req_id = f"r{next(self._ids)}"
        self.send({"id": req_id, "verb": "stats"})
        return self.unwrap(self.collect(req_id))

    def metrics(self) -> str:
        """Prometheus text exposition of the server's metric registry."""
        req_id = f"r{next(self._ids)}"
        self.send({"id": req_id, "verb": "metrics"})
        return self.unwrap(self.collect(req_id))

    def shutdown(self) -> str:
        req_id = f"r{next(self._ids)}"
        self.send({"id": req_id, "verb": "shutdown"})
        return self.unwrap(self.collect(req_id))
