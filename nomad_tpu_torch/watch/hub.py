"""Watch hub: per-table / per-key wakeup registry for blocking queries.

Fills the role of the reference's memdb watchsets (``state_store.go``
``ws.Add`` channels): every raft apply notifies the hub with the
(table, key) pairs it touched, and parked blocking queries wake when
their table — or their specific key — moves. Two deliberate departures
from channel-per-row watchsets:

* **Coalesced wakeups.** Notifies stage into a pending set that one
  persistent flusher thread drains after a short window
  (``coalesce_ms``), so an apply storm (a plan-results batch, an
  unblock storm) wakes each watcher ONCE per window instead
  of once per write. The blocked-evals flusher uses the same shape for
  the same reason (blocked_evals.py ``_flush_pending_locked``).
* **Bounded registry.** ``subscribe`` refuses past ``max_watchers``
  (:class:`WatchLimitError`) — a million clients must degrade to plain
  polling, not park unbounded server threads.

Handles are one-shot: a flush that wakes a handle also removes it from
the registry; the blocking engine re-subscribes before every re-query
(subscribe BEFORE read, park after — the watchset ordering that makes
missed-wakeup races impossible: a write landing between the read and
the park still sets the already-registered handle's event).

The ``watch_notify`` chaos point fires at the top of :meth:`notify`: a
dropped notify loses AT MOST one flush window of wakeups, and parked
watchers degrade to their ``max_query_time`` deadline re-query — the
fault-armed test in tests/test_watch.py holds the never-wedge bound.

Callbacks registered with :meth:`add_callback` run on the flusher
thread OUTSIDE the hub lock and must be read-only observers — no state
writes, no store-lock acquisition (lint: ``blocking-read-discipline``).

Copied from ``nomad_tpu/watch/hub.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..chaos.injector import fire as chaos_fire
from ..utils import metrics
from ..utils.lock_witness import witness_lock
from ..utils.race_witness import tracked_dict

# the watched table namespace (one name per StateStore table with a
# read endpoint; blocking_read validates against this set)
WATCH_TABLES = ("nodes", "jobs", "evals", "allocs", "deployments")


class WatchLimitError(RuntimeError):
    """subscribe() past ``max_watchers`` — callers fall back to polling."""


class WatchHandle:
    """One parked watcher. ``wait`` blocks until the hub's flusher sets
    the event (or timeout). ``wake_index``/``wake_time`` are stamped by
    the flusher BEFORE the event is set, so a waiter that observed
    ``wait() == True`` reads them race-free (Event provides the
    happens-before edge)."""

    __slots__ = ("table", "key", "_event", "wake_index", "wake_time")

    def __init__(self, table: str, key=None) -> None:
        self.table = table
        self.key = key
        self._event = threading.Event()
        # written by the flusher before Event.set, read by the waiter
        # after wait() returns True — Event is the happens-before edge
        self.wake_index = 0
        self.wake_time = 0.0

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def triggered(self) -> bool:
        return self._event.is_set()


class WatchHub:
    """Notification registry keyed on (table, key); ``key=None`` rows are
    table-level watchers (List endpoints), concrete keys are row-level
    (Get* endpoints). All registry state is guarded by ``_lock``; event
    sets and callbacks run outside it so a slow waiter thread never
    serializes the FSM apply path."""

    def __init__(self, coalesce_ms: float = 5.0,
                 max_watchers: int = 100_000) -> None:
        self.coalesce_s = max(float(coalesce_ms), 0.0) / 1000.0
        self.max_watchers = int(max_watchers)
        self._lock = witness_lock("watch.WatchHub._lock")
        self._cond = threading.Condition(self._lock)
        # (table, key) -> set of WatchHandle   # guarded-by: _lock
        self._watchers: Dict[Tuple[str, object], Set[WatchHandle]] = (
            tracked_dict("watch.WatchHub._watchers", {})
        )
        self._n_watchers = 0  # guarded-by: _lock
        # staged notifies: table -> set of keys, or None = whole table
        self._pending: Dict[str, Optional[set]] = {}  # guarded-by: _lock
        self._pending_index = 0  # guarded-by: _lock
        # ONE persistent flusher thread services every coalesce window.
        # notify() runs inside the FSM apply path (often under the raft
        # lock) — spawning a thread there per window is tens of ms of
        # apply latency on a loaded box, which is exactly the budget a
        # synchronous replication loop doesn't have. The flusher starts
        # lazily on the first staged notify and exits on close().
        self._flusher: Optional[threading.Thread] = None  # guarded-by: _lock
        self._flush_deadline: Optional[float] = None  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._callbacks: List[Callable] = []  # guarded-by: _lock
        # counters (all guarded-by: _lock)
        self.stats_notifies = 0
        self.stats_flushes = 0
        self.stats_wakeups = 0
        self.stats_dropped_notifies = 0
        self.stats_rejected = 0
        self.stats_subscribes = 0

    # -- registry --------------------------------------------------------

    def subscribe(self, table: str, key=None) -> WatchHandle:
        handle = WatchHandle(table, key)
        with self._lock:
            if self._n_watchers >= self.max_watchers:
                self.stats_rejected += 1
                metrics.incr_counter("nomad.watch.rejected")
                raise WatchLimitError(
                    f"watch registry full ({self._n_watchers} >= "
                    f"{self.max_watchers})"
                )
            self._watchers.setdefault((table, key), set()).add(handle)
            self._n_watchers += 1
            self.stats_subscribes += 1
            depth = self._n_watchers
        metrics.set_gauge("nomad.watch.watchers", depth)
        return handle

    def unsubscribe(self, handle: WatchHandle) -> None:
        """Idempotent removal (a handle woken by a flush is already gone)."""
        with self._lock:
            self._discard_locked(handle)
            depth = self._n_watchers
        metrics.set_gauge("nomad.watch.watchers", depth)

    def _discard_locked(self, handle: WatchHandle) -> None:
        slot = self._watchers.get((handle.table, handle.key))
        if slot is not None and handle in slot:
            slot.discard(handle)
            self._n_watchers -= 1
            if not slot:
                del self._watchers[(handle.table, handle.key)]

    def add_callback(self, fn: Callable[[Tuple[str, ...], int], None]) -> None:
        """``fn(tables, index)`` runs on every flush, outside the hub
        lock. Callbacks are observers ONLY: writing state or taking the
        store lock from here deadlocks the apply path (lint-enforced)."""
        with self._lock:
            self._callbacks.append(fn)

    # -- notify (FSM apply side) ----------------------------------------

    def notify(self, index: int, touched: Iterable[Tuple[str, object]]) -> None:
        """Stage wakeups for the (table, key) pairs a raft apply touched
        (``key=None`` = bulk write, wakes the whole table). Called from
        ``NomadFSM.apply`` on every replica."""
        touched = tuple(touched)
        if not touched:
            return
        try:
            # ChaosFault subclasses RuntimeError; a dropped notify must
            # degrade to the watchers' deadline re-query, never corrupt
            # the apply path that called us
            chaos_fire("watch_notify", index=index)
        except RuntimeError:
            with self._lock:
                self.stats_dropped_notifies += 1
            metrics.incr_counter("nomad.watch.dropped_notifies")
            return
        wake: List[WatchHandle] = []
        cbs: List[Callable] = []
        tables: Tuple[str, ...] = ()
        with self._lock:
            self.stats_notifies += len(touched)
            self._pending_index = max(self._pending_index, int(index))
            for table, key in touched:
                staged = self._pending.get(table, _ABSENT)
                if staged is None:
                    continue  # whole table already staged
                if key is None:
                    self._pending[table] = None
                elif staged is _ABSENT:
                    self._pending[table] = {key}
                else:
                    staged.add(key)
            if self.coalesce_s <= 0:
                wake, cbs, tables, index = self._drain_locked()
            else:
                self._schedule_flush_locked(self.coalesce_s)
                return
        self._wake(wake, cbs, tables, index)

    def notify_all(self, index: int) -> None:
        """Wake every watcher (snapshot restore replaced the whole store)."""
        self.notify(index, [(t, None) for t in WATCH_TABLES])

    # -- coalesced flush -------------------------------------------------

    def _schedule_flush_locked(self, delay: float) -> None:
        if self._closed:
            return
        if self._flusher is None:
            self._flusher = threading.Thread(
                target=self._flusher_main, name="watch-flush", daemon=True
            )
            self._flusher.start()
        if self._flush_deadline is None:
            self._flush_deadline = time.monotonic() + delay
            self._cond.notify()

    def _flusher_main(self) -> None:
        while True:
            with self._lock:
                while not self._closed and self._flush_deadline is None:
                    self._cond.wait()
                # sleep out the coalesce window; notifies landing inside
                # it merge into this flush without moving the deadline
                while not self._closed:
                    remaining = self._flush_deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._closed:
                    return
                self._flush_deadline = None
                wake, cbs, tables, index = self._drain_locked()
            self._wake(wake, cbs, tables, index)

    def _drain_locked(self):
        """Collect the handles the staged notifies wake (removing them —
        handles are one-shot) and reset the pending set."""
        if not self._pending:
            return [], [], (), 0
        wake: Set[WatchHandle] = set()
        for table, keys in self._pending.items():
            # table-level watchers wake on ANY touched key of their table
            wake.update(self._watchers.get((table, None), ()))
            if keys is None:
                # bulk write: every row-level watcher of this table too
                for (t, k), handles in self._watchers.items():
                    if t == table and k is not None:
                        wake.update(handles)
            else:
                for key in keys:
                    wake.update(self._watchers.get((table, key), ()))
        tables = tuple(sorted(self._pending))
        index = self._pending_index
        self._pending = {}
        self._pending_index = 0
        self.stats_flushes += 1
        self.stats_wakeups += len(wake)
        for handle in wake:
            self._discard_locked(handle)
        return list(wake), list(self._callbacks), tables, index

    def _wake(self, handles: List[WatchHandle], cbs: List[Callable],
              tables: Tuple[str, ...], index: int) -> None:
        if handles:
            now = time.monotonic()
            metrics.incr_counter("nomad.watch.wakeups", len(handles))
            for handle in handles:
                handle.wake_index = index
                handle.wake_time = now
                handle._event.set()
        for cb in cbs:
            try:
                cb(tables, index)
            except Exception:  # noqa: BLE001 — observer bug stays its own
                pass

    # -- observability ---------------------------------------------------

    def watcher_count(self) -> int:
        with self._lock:
            return self._n_watchers

    def stats(self) -> Dict[str, object]:
        """Depth/wakeup gauges (flight-recorder ``watch`` probe and the
        ``Watch.Stats`` RPC — per-replica, callers pass no_forward)."""
        with self._lock:
            per_table: Dict[str, int] = {}
            for (table, _key), handles in self._watchers.items():
                per_table[table] = per_table.get(table, 0) + len(handles)
            flushes = self.stats_flushes
            return {
                "watchers": self._n_watchers,
                "max_watchers": self.max_watchers,
                "per_table": per_table,
                "subscribes": self.stats_subscribes,
                "notifies": self.stats_notifies,
                "flushes": flushes,
                "wakeups": self.stats_wakeups,
                "coalesce_ratio": (
                    self.stats_notifies / flushes if flushes else 0.0
                ),
                "dropped_notifies": self.stats_dropped_notifies,
                "rejected": self.stats_rejected,
                "pending_tables": len(self._pending),
            }

    def close(self) -> None:
        """Flush what's staged, wake everything parked, stop the flusher.
        The hub is unusable afterwards (notifies no-op into drops)."""
        with self._lock:
            self._closed = True
            self._flush_deadline = None
            self._cond.notify_all()
            flusher = self._flusher
            self._flusher = None
            wake, cbs, tables, index = self._drain_locked()
        self._wake(wake, cbs, tables, index)
        if flusher is not None and flusher is not threading.current_thread():
            flusher.join(timeout=2.0)


_ABSENT = object()  # sentinel distinguishing "no staged keys" from wildcard
