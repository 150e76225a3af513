"""nomad-watch: the read-serving layer — watch hub, blocking queries,
follower stale reads.

Fills the role of the reference read path: ``state_store.go`` watchsets
(per-table/per-key notification channels), ``blocking_query.go``
(``blockingOptions``/``SnapshotMinIndex`` park-and-requery), and
``rpc.go``'s ``allowStaleRead`` forwarding bypass. The hub hangs off
``NomadFSM`` so every applied raft entry notifies the tables it
touched; ``blocking_read`` is the one wrapper every read endpoint
funnels through (lint-enforced: ``blocking-read-discipline``).

Copied from ``nomad_tpu/watch/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``; the serving harness
(``watch/serve.py``) is imported from its module, as there.
"""
from .hub import WatchHandle, WatchHub, WatchLimitError, WATCH_TABLES
from .blocking import blocking_read, DEFAULT_MAX_QUERY_TIME, MAX_QUERY_TIME_CAP
from .stale import StaleReader, follower_lag_ms, read_meta

__all__ = [
    "WatchHandle",
    "WatchHub",
    "WatchLimitError",
    "WATCH_TABLES",
    "blocking_read",
    "DEFAULT_MAX_QUERY_TIME",
    "MAX_QUERY_TIME_CAP",
    "StaleReader",
    "follower_lag_ms",
    "read_meta",
]
