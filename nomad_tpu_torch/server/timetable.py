"""Raft-index <-> wall-clock witness table (reference ``nomad/timetable.go``).

GC thresholds are expressed in time but state is stamped with indexes; the
TimeTable records (index, time) witnesses so "older than 1h" translates to
"index below X".

Copied from ``nomad_tpu/server/timetable.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Tuple
from ..utils.lock_witness import witness_lock

DEFAULT_MAX_ENTRIES = 512


class TimeTable:
    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES) -> None:
        self._lock = witness_lock("timetable.TimeTable._lock")
        self._entries: List[Tuple[int, int]] = []  # (index, time_ns) ascending
        self.max_entries = max_entries

    def witness(self, index: int, when_ns: int = 0) -> None:
        when_ns = when_ns or time.time_ns()
        with self._lock:
            if self._entries and index <= self._entries[-1][0]:
                return
            self._entries.append((index, when_ns))
            if len(self._entries) > self.max_entries:
                # keep every other old entry (coarsen history, keep range)
                self._entries = self._entries[::2] + self._entries[-1:]

    def nearest_index(self, when_ns: int) -> int:
        """Largest index witnessed at or before ``when_ns`` (0 if none)."""
        with self._lock:
            best = 0
            for index, t in self._entries:
                if t <= when_ns:
                    best = index
                else:
                    break
            return best
