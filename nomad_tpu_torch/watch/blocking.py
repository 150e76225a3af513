"""Blocking-query engine (reference ``blocking_query.go`` semantics).

``blocking_read`` is the ONE wrapper the read endpoints funnel through
(lint: ``blocking-read-discipline``): run the query, return immediately
when the store has moved past the client's ``min_query_index``, else
subscribe on the watch hub, park until notify or deadline, and re-run.
Every response carries a stamped :class:`QueryMeta` so clients chain
``meta.index`` back as the next ``min_query_index``.

Ordering is the load-bearing part: the hub handle is subscribed BEFORE
the query runs, so a write landing between the read and the park sets
the already-registered handle's event — the same ordering memdb
watchsets give the reference (acquire the watch channel inside the read
transaction, select on it after). A deadline expiry re-runs the query
one final time, so a deadline return still reports the CURRENT index —
that is what makes a dropped ``watch_notify`` degrade to a late answer
instead of a stale one.

The store is re-resolved through ``state_fn`` on every iteration: a
snapshot install on a rejoining replica REPLACES the FSM's StateStore,
and a watcher parked across the install must re-query the new store,
not the orphaned one.

Copied from ``nomad_tpu/watch/blocking.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change but this paragraph.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..structs.structs import QueryMeta, QueryOptions
from .hub import WatchHub, WatchLimitError

# a blocking request that names no max_query_time waits this long
# (reference defaultQueryTime=300s is sized for production agents; the
# harness-scale default keeps an abandoned watcher's server thread
# bounded to one test timeout)
DEFAULT_MAX_QUERY_TIME = 10.0
# hard cap regardless of what the client asked for (queryTimeLimit)
MAX_QUERY_TIME_CAP = 300.0


def blocking_read(
    state_fn: Callable[[], object],
    hub: Optional[WatchHub],
    run: Callable[[object], object],
    table: str,
    query_opts: Optional[QueryOptions] = None,
    key=None,
    meta: Optional[QueryMeta] = None,
):
    """Serve one read with reference blocking semantics.

    Returns ``[result, meta]``. ``run(store)`` must be a pure read —
    it executes under the store's read lock via ``read_with_index`` so
    the result and ``meta.index`` are exactly consistent. ``key`` narrows
    the hub subscription to one row (Get* endpoints); table-level reads
    pass ``key=None`` and wake on any write to the table.
    """
    opts = query_opts or QueryOptions()
    meta = meta if meta is not None else QueryMeta()
    blocking = opts.min_query_index > 0 and hub is not None
    max_t = opts.max_query_time if opts.max_query_time > 0 else DEFAULT_MAX_QUERY_TIME
    deadline = time.monotonic() + min(max_t, MAX_QUERY_TIME_CAP)
    while True:
        handle = None
        if blocking:
            try:
                # subscribe BEFORE reading (see module docstring)
                handle = hub.subscribe(table, key)
            except WatchLimitError:
                # registry full: degrade to a plain read — a bounded
                # answer now beats an unbounded park
                blocking = False
        result, index = state_fn().read_with_index(run)
        meta.index = index
        if not blocking or index > opts.min_query_index:
            if handle is not None:
                hub.unsubscribe(handle)
            return [result, meta]
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            # deadline: the read above already re-ran, so the client gets
            # the current index (its next min_query_index) even when every
            # notify in between was dropped
            hub.unsubscribe(handle)
            return [result, meta]
        handle.wait(remaining)
        hub.unsubscribe(handle)
