"""The persistent suite server: sockets, admission, dispatch, drain
(port of ``repro.serve.server``).

Thread model (single-threaded torch use by construction):

- one **reader thread per connection** parses JSON lines; ``stats``,
  ``metrics`` and ``shutdown`` are answered inline; valid ``run``
  requests get an
  ``accepted`` event and enter the admission queue.  Parse errors are
  structured ``error`` events — the connection (and server) keep going.
- ONE **dispatcher thread** owns every torch call: it makes the
  executor's device its current device, drains micro-batch windows
  (:class:`repro_torch.serve.batcher.MicroBatcher`), coalesces
  equal-bucket requests into one ``ScenarioSuite`` dispatch over the
  shared :class:`repro_torch.serve.executor.Executor` caches, and streams
  ``scheduled`` → ``result`` events back per request.  The readers never
  call torch: they parse, hash and answer from the response cache.
- a client that vanished mid-flight (killed in-flight request) surfaces
  as a send failure, which is swallowed per-connection: the dispatch
  still completes, caches stay warm, the server keeps serving.

Graceful shutdown: the ``shutdown`` verb (or SIGTERM) stops admission,
the dispatcher drains in-flight requests, then the listener closes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import socket
import sys
import threading
import time
from typing import Optional

from .batcher import MicroBatcher
from .executor import Executor
from .metrics import Metrics
from .protocol import (Request, WireError, decode_line, encode,
                       parse_request)


@dataclasses.dataclass
class ServeConfig:
    """Server knobs (the CLI reads env defaults — see ``__main__``)."""

    socket_path: str = ""            # unix socket; "" = stdio fallback
    max_wait: float = 0.02           # micro-batch window (seconds)
    max_lanes: int = 64              # lane budget per dispatch window
    backlog: int = 64
    device: str = "cuda"             # where the executor runs (no fallback)


class _Transport:
    """One connection: a line iterator plus a locked writer.  Send
    failures mark the transport dead and are not raised — the peer
    walked away; the server must not."""

    def __init__(self, rfile, wfile, name: str):
        self._rfile = rfile
        self._wfile = wfile
        self._lock = threading.Lock()
        self.name = name
        self.alive = True

    def lines(self):
        return self._rfile

    def send(self, msg: dict) -> bool:
        if not self.alive:
            return False
        try:
            with self._lock:
                self._wfile.write(encode(msg))
                self._wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError, OSError, ValueError):
            self.alive = False
            return False


class Server:
    """``Server(config).serve_forever()`` — or ``start()``/``stop()``
    from tests.  Raises at construction when ``config.device`` is
    ``cuda`` and no card is present."""

    def __init__(self, config: Optional[ServeConfig] = None,
                 executor: Optional[Executor] = None):
        self.config = config or ServeConfig()
        self.metrics = (executor.metrics if executor is not None
                        else Metrics())
        self.executor = executor or Executor(metrics=self.metrics,
                                             device=self.config.device)
        self.admission: "queue.Queue" = queue.Queue()
        self.batcher = MicroBatcher(self.admission,
                                    self.executor.bucket_key,
                                    max_wait=self.config.max_wait,
                                    max_lanes=self.config.max_lanes)
        self._listener: Optional[socket.socket] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._threads: list = []
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._t0 = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Bind the socket and start the dispatcher (non-blocking)."""
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        if self.config.socket_path:
            path = self.config.socket_path
            if os.path.exists(path):
                os.unlink(path)
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(path)
            self._listener.listen(self.config.backlog)
            accept = threading.Thread(target=self._accept_loop,
                                      name="serve-accept", daemon=True)
            accept.start()
            self._threads.append(accept)

    def serve_forever(self) -> None:
        self.start()
        if not self.config.socket_path:
            # stdio fallback: serve the single implicit connection
            tr = _Transport(sys.stdin.buffer, sys.stdout.buffer, "stdio")
            self._serve_connection(tr)
            self._drain_and_stop()
        self._stopped.wait()

    def stop(self) -> None:
        """Immediate stop (tests); ``shutdown`` verb drains first."""
        self._drain_and_stop()

    def _drain_and_stop(self) -> None:
        self._draining.set()
        self.admission.put(None)  # wake the dispatcher
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=60)
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                if os.path.exists(self.config.socket_path):
                    os.unlink(self.config.socket_path)
        self._stopped.set()

    # -- admission ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            tr = _Transport(conn.makefile("rb"), conn.makefile("wb"),
                            f"conn-{len(self._threads)}")
            t = threading.Thread(target=self._serve_connection,
                                 args=(tr,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_connection(self, tr: _Transport) -> None:
        for line in tr.lines():
            if not line.strip():
                continue
            try:
                msg = decode_line(line)
                verb = msg.get("verb", "run")
                if verb == "stats":
                    tr.send({"id": msg.get("id"), "event": "result",
                             "value": self.stats()})
                    continue
                if verb == "metrics":
                    # Prometheus text exposition of the shared registry
                    tr.send({"id": msg.get("id"), "event": "result",
                             "value": self.metrics.exposition()})
                    continue
                if verb == "shutdown":
                    tr.send({"id": msg.get("id"), "event": "result",
                             "value": "draining"})
                    threading.Thread(target=self._drain_and_stop,
                                     daemon=True).start()
                    return
                if verb != "run":
                    raise WireError("ProtocolError",
                                    f"unknown verb {verb!r}",
                                    msg.get("id"))
                if self._draining.is_set():
                    raise WireError("Unavailable", "server is draining",
                                    msg.get("id"))
                req = parse_request(msg)
                req.t_admit = time.monotonic()
                req.transport = tr
                cached = self.executor.cached_response(req)
                if cached is not None:
                    # repeat request: answered straight from the response
                    # cache — no admission, no dispatch
                    self.metrics.inc("serve.cache_hits", mode=req.mode)
                    self.metrics.observe("serve.request_latency", 0.0,
                                         mode=req.mode)
                    tr.send({"id": req.id, "event": "result",
                             "cached": True, "value": cached})
                    continue
                self.metrics.inc("serve.requests", mode=req.mode)
                tr.send({"id": req.id, "event": "accepted"})
                self.admission.put(req)
            except WireError as e:
                self.metrics.inc("serve.errors", where="admission")
                tr.send(e.to_msg())
            except Exception as e:  # never let a connection kill the server
                self.metrics.inc("serve.errors", where="admission")
                tr.send(WireError(type(e).__name__, str(e)).to_msg())

    # -- dispatch -----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        self.executor.bind()
        while True:
            batch = self.batcher.next_window(timeout=0.25)
            if not batch:
                if self._draining.is_set() and self.admission.empty():
                    return
                continue
            for err, group in self.batcher.group(batch):
                if err is not None:
                    for req in group:
                        self._send_error(req, err)
                    continue
                try:
                    self._dispatch_group(group)
                except Exception as e:  # dispatcher must outlive any group
                    for req in group:
                        self._send_error(req, e)

    def _dispatch_group(self, group: list) -> None:
        mode = group[0].mode
        lanes = sum(len(r.seeds) for r in group)
        for req in group:
            req.transport.send({"id": req.id, "event": "scheduled",
                                "requests": len(group), "lanes": lanes})
        self.metrics.observe("serve.requests_per_dispatch", len(group),
                             mode=mode)
        self.metrics.observe("serve.lanes_per_dispatch", lanes, mode=mode)
        with self.metrics.timed("serve.dispatch", mode=mode):
            completions = self.executor.run_group(group)
        for done in completions:
            req = done.request
            if done.error is not None:
                self._send_error(req, done.error)
                continue
            self.metrics.observe("serve.request_latency",
                                 time.monotonic() - req.t_admit,
                                 mode=req.mode)
            req.transport.send({"id": req.id, "event": "result",
                                "cached": False, "value": done.value})

    def _send_error(self, req: Request, err: Exception) -> None:
        self.metrics.inc("serve.errors", where="dispatch")
        if isinstance(err, WireError):
            msg = WireError(err.etype, str(err), req.id).to_msg()
        else:
            msg = WireError(type(err).__name__, str(err), req.id).to_msg()
        req.transport.send(msg)

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        return {"uptime": time.monotonic() - self._t0,
                "queued": self.admission.qsize(),
                "response_cache_size": len(self.executor._responses),
                "counters": snap["counters"],
                "latency": snap["latency"],
                "drift": dict(self.executor.drift)}


def run_stdio_server() -> None:
    Server(ServeConfig(socket_path="")).serve_forever()


def main(argv=None) -> None:  # thin alias used by __main__
    from .__main__ import main as _main

    _main(argv)


if __name__ == "__main__":
    main()
