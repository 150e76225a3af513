"""Server-side node liveness via heartbeat TTL timers.

Semantics follow reference ``nomad/heartbeat.go`` — each registered node has
a TTL timer reset on every heartbeat; expiry marks the node down and spawns
node-update evals so its allocs are marked lost and rescheduled.

Copied from ``nomad_tpu/server/heartbeat.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. One change: the reference arms one
``threading.Timer`` per node per heartbeat, and starting a thread waits
for the new thread to take the GIL — under busy scheduler threads a
pass over a few hundred nodes then outlasts the TTL itself, nodes expire
while their heartbeats queue, and every expiry and recovery spawns
node-update evals. Here each node has a deadline in one table, and one
reaper thread (started with leadership, stopped with it) expires the
deadlines that pass; re-arming a TTL is a dict write and a heap push.
And, as Nomad's heartbeat.go does (``HeartbeatGrace``, 10 s by
default), a node's deadline is its TTL plus ``grace``: the TTL handed
back to the client is what it must beat within, the grace covers the
network and a busy server. The reference has none, so on a loaded host a
heartbeat a moment late marked its node down.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos.injector import fire as chaos_fire
from ..structs.structs import (
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_NODE_UPDATE,
    NODE_STATUS_DOWN,
    Evaluation,
)
from .fsm import EVAL_UPDATE, NODE_STATUS_UPDATE
from ..utils.lock_witness import witness_lock


class HeartbeatTimers:
    def __init__(self, server, min_ttl: float = 10.0, max_ttl: float = 30.0,
                 grace: float = 0.0) -> None:
        self.server = server
        self.min_ttl = min_ttl
        self.max_ttl = max_ttl
        self.grace = grace
        self.logger = logging.getLogger("nomad_tpu_torch.heartbeat")
        self._lock = witness_lock("heartbeat.HeartbeatTimers._lock")
        self._cond = threading.Condition(self._lock)
        # node id -> (monotonic deadline, arm sequence); the heap holds
        # (deadline, sequence, node id), stale entries skipped on pop
        self._deadlines: Dict[str, Tuple[float, int]] = {}
        self._heap: List[Tuple[float, int, str]] = []
        self._seq = itertools.count()
        self._reaper: Optional[threading.Thread] = None
        self.enabled = False

    def set_enabled(self, enabled: bool) -> None:
        """Leadership on: start the reaper. Off: drop every deadline and
        wake the reaper, which exits (not joined: it may be inside an
        expiry's raft apply, which the leadership change holds up)."""
        with self._cond:
            self.enabled = enabled
            if enabled:
                if self._reaper is None or not self._reaper.is_alive():
                    self._reaper = threading.Thread(
                        target=self._reap, name="heartbeat-reaper", daemon=True)
                    self._reaper.start()
                return
            self._deadlines.clear()
            self._heap.clear()
            self._reaper = None
            self._cond.notify_all()

    def reset_heartbeat_timer(self, node_id: str) -> float:
        """(Re)arm a node's TTL; returns the TTL handed back to the client."""
        # chaos hook: a fault here is a DROPPED heartbeat — the node's
        # TTL timer keeps its old deadline; enough drops in a row and it
        # expires, marking the node down (the real failure this models)
        chaos_fire("heartbeat", node_id=node_id)
        ttl = self.min_ttl + random.random() * (self.max_ttl - self.min_ttl)
        with self._cond:
            if not self.enabled:
                return ttl
            deadline, seq = time.monotonic() + ttl + self.grace, next(self._seq)
            self._deadlines[node_id] = (deadline, seq)
            heapq.heappush(self._heap, (deadline, seq, node_id))
            if self._heap[0][1] == seq:
                # the earliest deadline moved up: the reaper re-plans its wait
                self._cond.notify()
        return ttl

    def num_active(self) -> int:
        with self._lock:
            return len(self._deadlines)

    def clear_heartbeat_timer(self, node_id: str) -> None:
        with self._lock:
            self._deadlines.pop(node_id, None)

    def _reap(self) -> None:
        """The reaper thread: sleep until the earliest live deadline, and
        expire every node whose deadline has passed (a heartbeat that
        re-armed the TTL made the older heap entry stale)."""
        while True:
            with self._cond:
                expired = None
                while expired is None:
                    if not self.enabled or self._reaper is not threading.current_thread():
                        return
                    while self._heap:
                        deadline, seq, node_id = self._heap[0]
                        if self._deadlines.get(node_id) != (deadline, seq):
                            heapq.heappop(self._heap)   # re-armed or cleared
                            continue
                        break
                    if not self._heap:
                        self._cond.wait()
                        continue
                    wait = self._heap[0][0] - time.monotonic()
                    if wait > 0:
                        self._cond.wait(timeout=wait)
                        continue
                    _deadline, _seq, expired = heapq.heappop(self._heap)
                    del self._deadlines[expired]
            self._invalidate(expired)

    def _invalidate(self, node_id: str) -> None:
        """Missed TTL: node down + evals for each job with allocs on it."""
        with self._lock:
            if not self.enabled:
                return
        self.logger.warning("node %s missed heartbeat, marking down", node_id)
        try:
            self.server.raft_apply(NODE_STATUS_UPDATE, (node_id, NODE_STATUS_DOWN))
        except Exception:  # noqa: BLE001 — lost leadership etc.
            self.logger.exception("failed to invalidate heartbeat for %s", node_id)
            return
        self.server.create_node_evals(node_id)
