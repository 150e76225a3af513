"""Follower stale reads (reference ``rpc.go`` allowStale forwarding bypass).

Server side: :func:`read_meta` builds the :class:`QueryMeta` prototype a
read endpoint stamps — ``known_leader`` / ``last_contact_ms`` on every
read, plus the measured ``follower_lag_ms`` when a follower serves
locally instead of forwarding. The transport carries ``allow_stale`` as
an envelope flag (``RPCClient.call(..., stale=True)``): ``_dispatch``
skips leader forwarding for flagged requests, so the follower's own FSM
answers. Index consistency is preserved the same way it is on the
leader — the client's ``min_query_index`` parks on the FOLLOWER's hub
until the follower's replication stream catches up, so a stale read is
stale-but-index-consistent, never time-traveling backwards for a client
that chains ``meta.index``.

Client side: :class:`StaleReader` pins one replica and chains
``min_query_index`` across calls — the serving bench's watcher army and
follower-throughput readers are built on it.

Copied from ``nomad_tpu/watch/stale.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change but this paragraph.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from ..structs.structs import QueryMeta, QueryOptions


def follower_lag_ms(server) -> float:
    """Measured replication-stream age on this replica: ms since the
    last leader contact (AppendEntries/InstallSnapshot). 0 on the leader
    and on raft implementations without contact tracking (in-proc)."""
    if server.is_leader:
        return 0.0
    age_fn = getattr(server.raft, "last_contact_age_s", None)
    if age_fn is None:
        return 0.0
    return max(age_fn(), 0.0) * 1000.0


def read_meta(server, rpc=None) -> QueryMeta:
    """QueryMeta prototype for one read served by ``server``. The caller
    (the endpoint's blocking_read) fills ``index``."""
    leader_known = server.is_leader or (
        rpc is not None and rpc.leader_addr is not None
    )
    lag = follower_lag_ms(server)
    return QueryMeta(
        index=0,
        known_leader=bool(leader_known),
        last_contact_ms=lag,
        follower_lag_ms=lag,
    )


class StaleReader:
    """Client helper pinned to ONE replica: issues ``allow_stale`` reads
    with a chained ``min_query_index``. ``read`` returns
    ``(result, meta)``; ``watch`` is the blocking form the watcher army
    uses (park until the key moves or ``max_query_time``)."""

    def __init__(self, client, stale: bool = True) -> None:
        self.client = client
        self.stale = stale
        self.last_index = 0

    def read(self, method: str, *args: Any,
             timeout: Optional[float] = None) -> Tuple[Any, QueryMeta]:
        opts = QueryOptions(allow_stale=self.stale)
        result, meta = self.client.call(
            method, *args, opts, stale=self.stale, timeout=timeout
        )
        self.last_index = max(self.last_index, meta.index)
        return result, meta

    def watch(self, method: str, *args: Any, max_query_time: float = 10.0,
              timeout: Optional[float] = None) -> Tuple[Any, QueryMeta]:
        opts = QueryOptions(
            min_query_index=self.last_index,
            max_query_time=max_query_time,
            allow_stale=self.stale,
        )
        result, meta = self.client.call(
            method, *args, opts, stale=self.stale,
            timeout=timeout if timeout is not None else max_query_time + 15.0,
        )
        self.last_index = max(self.last_index, meta.index)
        return result, meta
