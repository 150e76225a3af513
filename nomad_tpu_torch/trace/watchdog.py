"""Liveness watchdog: self-diagnosing dump when placement flatlines.

Round 5's failure mode was a server that LOOKED idle: 5-6 evals sat
unacked for minutes, placement throughput flat, and nothing fired. The
watchdog is the inverse of a health check — it alarms on the
combination "no placement progress" + "evals in flight", which healthy
systems never hold for long (either the broker drains or placements
land).

It is a tick function, not a thread: the leader schedules ``tick()`` on
its existing timer loop (Server._schedule_leader_task), so the watchdog
dies with leadership and costs nothing on followers. Each tick samples
the desired-run alloc count (the scheduler's output) and broker depth
(its input); when output is flat for ``stall_after`` seconds while input
is nonzero, it logs ONE dump — broker stats, per-worker current span,
the slowest in-flight eval traces, and a full thread stack dump — to the
framework logger, which the agent monitor's ring buffer captures for
``/v1/agent/monitor`` pollers. Repeat dumps are rate-limited to one per
``stall_after`` window so a long stall doesn't flood the buffer — and
deduplicated within a stall episode: the FIRST alarm gets the full dump
(thread stacks and all); while the same flatline persists, later alarms
emit one compact heartbeat line each (a chaos run's long injected stall
would otherwise fill the ring buffer with identical stack dumps). Any
progress starts a fresh episode with a fresh full dump.

Copied from ``nomad_tpu/trace/watchdog.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. The
thread dump is its own copy of ``nomad_tpu/agent/monitor.py``
``thread_dump`` (the port has no agent).
"""
from __future__ import annotations

import json
import logging
import time
from typing import Dict, Optional

from ..utils import metrics
from . import lifecycle


class LivenessWatchdog:
    def __init__(self, server, stall_after: float = 30.0,
                 logger: Optional[logging.Logger] = None) -> None:
        self.server = server
        self.stall_after = float(stall_after)
        self.logger = logger or logging.getLogger("nomad_tpu_torch.trace.watchdog")
        self.fired = 0
        self._last_placed: Optional[int] = None
        self._last_progress_t: Optional[float] = None
        self._dumped_at: Optional[float] = None
        # alarms emitted for the CURRENT stall episode; >0 means the full
        # dump already went out and repeats degrade to heartbeat lines
        self._episode_alarms = 0

    # -- probes ----------------------------------------------------------

    def _placed_count(self) -> Optional[int]:
        try:
            return self.server.fsm.state.count_allocs_desired_run()
        except Exception:  # noqa: BLE001 — probe must never kill the timer
            return None

    def worker_spans(self) -> list:
        spans = []
        for w in getattr(self.server, "workers", []):
            cur = getattr(w, "current", None)
            if cur is not None:
                cur = dict(cur)
                cur["busy_s"] = round(time.monotonic() - cur.pop("since"), 3)
            spans.append({"worker": getattr(w, "id", "?"), "span": cur})
        return spans

    # -- tick ------------------------------------------------------------

    def tick(self) -> bool:
        """Sample; returns True when a dump was emitted this tick."""
        now = time.monotonic()
        placed = self._placed_count()
        try:
            broker = self.server.eval_broker.stats()
        except Exception:  # noqa: BLE001
            return False
        in_flight = int(broker.get("total_unacked", 0)) \
            + int(broker.get("total_ready", 0))

        if self._last_placed is None or placed != self._last_placed:
            self._last_placed = placed
            self._last_progress_t = now
            self._dumped_at = None
            self._episode_alarms = 0
            return False
        if in_flight == 0:
            # flat but empty: nothing owed, not a stall
            self._last_progress_t = now
            self._dumped_at = None
            self._episode_alarms = 0
            return False
        stalled = now - (self._last_progress_t or now)
        metrics.set_gauge("nomad.watchdog.stalled_s", round(stalled, 1))
        if stalled < self.stall_after:
            return False
        if self._dumped_at is not None and now - self._dumped_at < self.stall_after:
            return False
        self._dumped_at = now
        self.fired += 1
        self._episode_alarms += 1
        metrics.incr_counter("nomad.watchdog.fired")
        if self._episode_alarms == 1:
            self._dump(stalled, placed, broker)
        else:
            # same flatline, dump already on record: one compact line
            metrics.incr_counter("nomad.watchdog.heartbeat")
            self.logger.warning(
                "liveness watchdog: still stalled (%.1fs flat at %s "
                "desired-run allocs, %d in flight; alarm %d of this "
                "episode, suppressing repeat dumps)",
                stalled, placed, in_flight, self._episode_alarms,
            )
        return True

    def _dump(self, stalled: float, placed: Optional[int],
              broker: Dict[str, object]) -> None:
        from ..utils import lock_witness

        # the flight recorder's tail shows what the system was doing
        # LEADING INTO the stall, which the instantaneous probes can't
        flight = getattr(self.server, "flight", None)
        flight_tail = flight.frames(recent=8) if flight is not None else []
        # when the lock witness is armed, which thread holds which locks
        # is often the entire stall story (empty table when disarmed)
        held = lock_witness.held_snapshot()
        self.logger.warning(
            "liveness watchdog: placement flat at %s desired-run allocs "
            "for %.1fs with evals in flight\n"
            "broker stats: %s\n"
            "worker spans: %s\n"
            "slowest in-flight evals: %s\n"
            "last flight frames: %s\n"
            "witnessed held locks per thread: %s\n"
            "thread stacks:\n%s",
            placed, stalled,
            json.dumps(broker, sort_keys=True, default=str),
            json.dumps(self.worker_spans(), sort_keys=True, default=str),
            json.dumps(lifecycle.slowest_inflight(5), sort_keys=True,
                       default=str),
            json.dumps(flight_tail, sort_keys=True, default=str),
            json.dumps(held, sort_keys=True, default=str)
            if held else "(witness disarmed)",
            thread_dump(),
        )


def thread_dump() -> str:
    """Per-thread stack dump (the goroutine-profile analog)."""
    import sys
    import threading
    import traceback

    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)
