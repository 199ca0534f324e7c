"""Admission queue → micro-batches of coalescible requests (port of
``repro.serve.batcher``).

The batcher owns the window policy only (no torch, no sockets): it blocks
on the admission queue for the first request, then keeps collecting
until ``max_wait`` elapses or ``max_lanes`` requests are in hand —
partial batches fire on timeout.  Grouping by the executor's bucket key
happens after the window closes, so one window can yield several groups
(each group = one suite dispatch; requests in a group become spare lanes
of the same resident program).

Lane accounting: a request contributes ``len(seeds)`` lanes, so
``max_lanes`` bounds the dispatch width, not the request count.
"""
from __future__ import annotations

import queue
import time
from typing import Callable, Optional


class MicroBatcher:
    """Pulls :class:`repro_torch.serve.protocol.Request`s from a queue and
    yields lists of requests that may share one dispatch."""

    def __init__(self, admission: "queue.Queue",
                 bucket_key: Callable, *,
                 max_wait: float = 0.02, max_lanes: int = 64):
        self.admission = admission
        self.bucket_key = bucket_key
        self.max_wait = float(max_wait)
        self.max_lanes = int(max_lanes)

    def next_window(self, timeout: Optional[float] = None) -> list:
        """Block for the first request (up to ``timeout``; None = forever),
        then drain the window.  Returns [] on timeout or when a ``None``
        sentinel (shutdown) was queued."""
        try:
            first = self.admission.get(timeout=timeout)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        lanes = len(first.seeds)
        deadline = time.monotonic() + self.max_wait
        while lanes < self.max_lanes:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.admission.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break  # shutdown sentinel: fire what we have
            batch.append(nxt)
            lanes += len(nxt.seeds)
        return batch

    def group(self, batch: list) -> list:
        """Partition a window into dispatch groups by bucket key; key
        errors (e.g. oversized resolved m) split into error singletons
        marked by a ``WireError`` in place of the key."""
        groups: dict = {}
        order: list = []
        for req in batch:
            try:
                key = ("ok", self.bucket_key(req))
            except Exception as e:
                key = ("err", id(req), e)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(req)
        return [(key[2] if key[0] == "err" else None, groups[key])
                for key in order]
