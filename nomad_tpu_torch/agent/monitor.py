"""Agent monitor + debug introspection.

Fills the role of reference ``command/agent/monitor/`` (live log
streaming over /v1/agent/monitor) and the pprof endpoints gated on
``enable_debug`` (command/agent/http.go:220). The monitor attaches a
ring-buffer handler to the framework's logger tree; requests drain the
buffer from an offset, so a polling client gets a live tail (the
reference streams frames — same data, poll transport). Debug dumps are
the Python equivalents of goroutine/heap profiles: per-thread stacks and
object census.

Copied from ``nomad_tpu/agent/monitor.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Change: the monitor captures the
``nomad_tpu_torch`` logger.
"""
from __future__ import annotations

import logging
import sys
import threading
import traceback
from collections import deque
from typing import List, Tuple

LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


class RingBufferHandler(logging.Handler):
    """Bounded in-memory log capture with monotonically increasing
    sequence numbers so pollers can resume where they left off."""

    def __init__(self, capacity: int = 2048) -> None:
        super().__init__(level=logging.DEBUG)
        self.capacity = capacity
        self._lock2 = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        ))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # noqa: BLE001
            return
        with self._lock2:
            self._seq += 1
            self._buf.append((self._seq, record.levelno, line))

    def since(self, seq: int, min_level: int = logging.DEBUG) -> Tuple[List[str], int]:
        """Lines after ``seq`` at/above ``min_level``; returns (lines,
        newest_seq)."""
        with self._lock2:
            lines = [l for s, lvl, l in self._buf if s > seq and lvl >= min_level]
            newest = self._seq
        return lines, newest


class AgentMonitor:
    def __init__(self, capacity: int = 2048) -> None:
        self.handler = RingBufferHandler(capacity)
        self.logger = logging.getLogger("nomad_tpu_torch")
        self._attached = False

    def attach(self) -> "AgentMonitor":
        """Attach the capture handler WITHOUT changing the logger's level:
        forcing DEBUG here would flood the operator's own console handler.
        The buffer captures whatever verbosity the process runs at."""
        if not self._attached:
            self.logger.addHandler(self.handler)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            self.logger.removeHandler(self.handler)
            self._attached = False

    def tail(self, seq: int = 0, level: str = "info") -> dict:
        lines, newest = self.handler.since(
            seq, LEVELS.get(level.lower(), logging.INFO)
        )
        return {"Lines": lines, "Seq": newest}


def thread_dump() -> str:
    """Per-thread stack dump (the goroutine-profile analog)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)


def heap_dump(top: int = 30) -> dict:
    """Object census (the heap-profile analog)."""
    import gc
    from collections import Counter

    counts = Counter(type(o).__name__ for o in gc.get_objects())
    return {
        "TotalObjects": sum(counts.values()),
        "TopTypes": dict(counts.most_common(top)),
        "GCStats": gc.get_stats(),
    }
