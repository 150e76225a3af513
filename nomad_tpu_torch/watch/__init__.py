"""nomad-watch, trimmed to the watch hub the server builds.

``NomadFSM`` notifies the hub of every table an applied raft entry
touched. Blocking queries and follower stale reads (``blocking``,
``stale``, ``serve`` in ``nomad_tpu/watch/``) serve the HTTP/RPC read
path, which the port does not have yet.

Trimmed copy of ``nomad_tpu/watch/__init__.py``.
"""
from .hub import WatchHandle, WatchHub, WatchLimitError, WATCH_TABLES

__all__ = [
    "WatchHandle",
    "WatchHub",
    "WatchLimitError",
    "WATCH_TABLES",
]
