"""Leader-side autoscaler: capacity chases blocked demand.

Reference Nomad delegates this loop to an external autoscaler agent
watching ``/v1/metrics``; here the same policy runs as a leader task so
the saturated regime closes its own loop. Each tick reads
``BlockedEvals.stats()`` — the identical surface the external agent
scrapes as ``nomad.blocked_evals.*`` gauges — and drives the node fleet
through two callbacks the embedding harness supplies:

- ``scale_up_fn(n) -> int`` — provision and register up to ``n`` nodes,
  returning how many actually joined (each registration lands in the FSM
  and fires the capacity-change trigger, so the blocked evals storm out
  through the coalesced unblock path on their own);
- ``scale_down_fn(n) -> int`` — drain/retire up to ``n`` of the nodes
  this autoscaler added, returning how many.

Policy, deliberately simple (proportional step, rate-limited):

- *scale up* when blocked depth >= ``blocked_threshold``: request
  ``ceil(blocked / evals_per_node)`` nodes, capped at ``max_step``, at
  most once per ``cooldown_s``;
- *scale down* after ``drain_idle_ticks`` consecutive ticks with zero
  blocked evals, stepping back at most ``max_step`` of its own nodes per
  cooldown — capacity it never added is never drained.

Armed/disarmed with leadership like the watchdog and flight recorder:
followers hold a disabled instance, and `set_enabled(False)` resets the
burst state so a re-elected leader starts from a clean cooldown.

Copied from ``nomad_tpu/server/autoscaler.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..trace import capacity
from ..utils import metrics
from ..utils.lock_witness import witness_lock

_MAX_HISTORY = 256


class Autoscaler:
    def __init__(
        self,
        stats_fn: Callable[[], Dict[str, int]],
        scale_up_fn: Optional[Callable[[int], int]] = None,
        scale_down_fn: Optional[Callable[[int], int]] = None,
        *,
        blocked_threshold: int = 1,
        evals_per_node: int = 2,
        max_step: int = 8,
        cooldown_s: float = 3.0,
        drain_idle_ticks: int = 3,
    ) -> None:
        self.stats_fn = stats_fn
        self.scale_up_fn = scale_up_fn
        self.scale_down_fn = scale_down_fn
        self.blocked_threshold = max(1, int(blocked_threshold))
        self.evals_per_node = max(1, int(evals_per_node))
        self.max_step = max(1, int(max_step))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.drain_idle_ticks = max(1, int(drain_idle_ticks))

        self._lock = witness_lock("autoscaler.Autoscaler._lock")
        self._enabled = False
        self._last_action_t = float("-inf")
        self._idle_ticks = 0
        self.nodes_added = 0          # net nodes this autoscaler owns
        self.scale_ups = 0
        self.scale_downs = 0
        self.ticks = 0
        self.history: List[Dict[str, object]] = []

    # -- lifecycle -------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = bool(enabled)
            # fresh leadership starts from a clean cooldown: the first
            # pressured tick may act immediately
            self._last_action_t = float("-inf")
            self._idle_ticks = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- the loop --------------------------------------------------------

    def tick(self) -> Optional[Dict[str, object]]:
        """One policy evaluation; returns the action record if it acted.
        Scheduled as a leader task — exceptions from the callbacks
        propagate to the task wrapper's log-and-continue."""
        with self._lock:
            if not self._enabled:
                return None
            self.ticks += 1
        stats = self.stats_fn() or {}
        blocked = int(stats.get("total_blocked", 0) or 0)
        capacity.note_blocked_depth(blocked)
        metrics.set_gauge("nomad.autoscaler.blocked_depth", blocked)

        now = time.monotonic()
        action: Optional[Dict[str, object]] = None
        if blocked >= self.blocked_threshold:
            with self._lock:
                self._idle_ticks = 0
                in_cooldown = now - self._last_action_t < self.cooldown_s
            if not in_cooldown and self.scale_up_fn is not None:
                want = min(self.max_step,
                           -(-blocked // self.evals_per_node))
                added = int(self.scale_up_fn(want) or 0)
                if added > 0:
                    metrics.incr_counter("nomad.autoscaler.scale_up", added)
                    action = {"action": "scale_up", "blocked": blocked,
                              "requested": want, "nodes": added}
                    with self._lock:
                        self.nodes_added += added
                        self.scale_ups += 1
                        self._last_action_t = now
        else:
            with self._lock:
                self._idle_ticks += 1
                drainable = (
                    self._idle_ticks >= self.drain_idle_ticks
                    and self.nodes_added > 0
                    and now - self._last_action_t >= self.cooldown_s
                )
                step = min(self.max_step, self.nodes_added)
            if drainable and self.scale_down_fn is not None:
                removed = int(self.scale_down_fn(step) or 0)
                if removed > 0:
                    metrics.incr_counter(
                        "nomad.autoscaler.scale_down", removed)
                    action = {"action": "scale_down", "blocked": blocked,
                              "requested": step, "nodes": removed}
                    with self._lock:
                        self.nodes_added -= removed
                        self.scale_downs += 1
                        self._last_action_t = now
                        self._idle_ticks = 0
        if action is not None:
            with self._lock:
                self.history.append(action)
                del self.history[:-_MAX_HISTORY]
        metrics.set_gauge("nomad.autoscaler.nodes_added", self.nodes_added)
        return action

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "enabled": int(self._enabled),
                "ticks": self.ticks,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "nodes_added": self.nodes_added,
                "idle_ticks": self._idle_ticks,
            }
