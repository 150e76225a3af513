"""Server-side node liveness via heartbeat TTL timers.

Semantics follow reference ``nomad/heartbeat.go`` — each registered node has
a TTL timer reset on every heartbeat; expiry marks the node down and spawns
node-update evals so its allocs are marked lost and rescheduled.

Copied from ``nomad_tpu/server/heartbeat.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
import random
import threading
from typing import Dict

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
    def __init__(self, server, min_ttl: float = 10.0, max_ttl: float = 30.0) -> None:
        self.server = server
        self.min_ttl = min_ttl
        self.max_ttl = max_ttl
        self.logger = logging.getLogger("nomad_tpu_torch.heartbeat")
        self._lock = witness_lock("heartbeat.HeartbeatTimers._lock")
        self._timers: Dict[str, threading.Timer] = {}
        self.enabled = False

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self.enabled = enabled
            if not enabled:
                for t in self._timers.values():
                    t.cancel()
                self._timers.clear()

    def reset_heartbeat_timer(self, node_id: str) -> float:
        """(Re)arm a node's TTL; returns the TTL handed back to the client."""
        # chaos hook: a fault here is a DROPPED heartbeat — the node's
        # TTL timer keeps its old deadline; enough drops in a row and it
        # expires, marking the node down (the real failure this models)
        chaos_fire("heartbeat", node_id=node_id)
        ttl = self.min_ttl + random.random() * (self.max_ttl - self.min_ttl)
        with self._lock:
            if not self.enabled:
                return ttl
            old = self._timers.pop(node_id, None)
            if old is not None:
                old.cancel()
            cell = []
            timer = threading.Timer(ttl, self._invalidate, args=(node_id, cell))
            cell.append(timer)
            timer.daemon = True
            self._timers[node_id] = timer
            timer.start()
        return ttl

    def num_active(self) -> int:
        with self._lock:
            return len(self._timers)

    def clear_heartbeat_timer(self, node_id: str) -> None:
        with self._lock:
            old = self._timers.pop(node_id, None)
            if old is not None:
                old.cancel()

    def _invalidate(self, node_id: str, cell) -> None:
        """Missed TTL: node down + evals for each job with allocs on it."""
        with self._lock:
            current = self._timers.get(node_id)
            if not cell or current is not cell[0]:
                # A racing heartbeat re-armed the TTL; this expiry is stale.
                return
            del self._timers[node_id]
            if not self.enabled:
                return
        self.logger.warning("node %s missed heartbeat, marking down", node_id)
        try:
            self.server.raft_apply(NODE_STATUS_UPDATE, (node_id, NODE_STATUS_DOWN))
        except Exception:  # noqa: BLE001 — lost leadership etc.
            self.logger.exception("failed to invalidate heartbeat for %s", node_id)
            return
        self.server.create_node_evals(node_id)
