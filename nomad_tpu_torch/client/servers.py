"""Per-call server failover for client agents.

Fills the role of reference ``client/servers/manager.go``: the client
keeps the full candidate server list, every RPC goes to the current best
server, and a failed call rotates the list and retries the remaining
servers before surfacing the error — so a dead server costs one timeout,
not the client.

Copied from ``nomad_tpu/client/servers.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change: it runs on the port's
``rpc.endpoints.RemoteServerProxy`` and ``rpc.transport.RPCError``.
"""
from __future__ import annotations

import random
import threading
from typing import List, Optional, Tuple

from ..rpc.endpoints import RemoteServerProxy
from ..rpc.transport import RPCError


class ServersManager:
    """Ordered candidate list with rotate-on-failure (manager.go
    NotifyFailedServer) and an initial shuffle so a fleet of clients
    doesn't pile onto the first configured server (rebalance)."""

    def __init__(self, addrs: List[Tuple[str, int]], shuffle: bool = True) -> None:
        if not addrs:
            raise ValueError("at least one server address required")
        self._lock = threading.Lock()
        self._addrs = list(addrs)
        if shuffle and len(self._addrs) > 1:
            random.shuffle(self._addrs)

    def current(self) -> Tuple[str, int]:
        with self._lock:
            return self._addrs[0]

    def all(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._addrs)

    def notify_failed(self, addr: Tuple[str, int]) -> None:
        """Cycle the failed server to the back (manager.go:303)."""
        with self._lock:
            if self._addrs and self._addrs[0] == addr:
                self._addrs.append(self._addrs.pop(0))

    def set_servers(self, addrs: List[Tuple[str, int]]) -> None:
        with self._lock:
            self._addrs = list(addrs) or self._addrs


class FailoverServerProxy:
    """RemoteServerProxy facade that routes every call through the
    ServersManager: use the current server, and on connection failure
    rotate and retry each remaining candidate once."""

    def __init__(self, manager: ServersManager, tls=None) -> None:
        self.manager = manager
        self.tls = tls
        self._lock = threading.Lock()
        # one proxy per server address, kept for the agent's lifetime
        # (bounded by the configured server count). Never closed during
        # failover: closing a proxy whose blocking RPC another thread is
        # inside would serialize every caller behind that 90s timeout.
        self._proxies: dict = {}

    def _proxy_for(self, addr: Tuple[str, int]) -> RemoteServerProxy:
        with self._lock:
            proxy = self._proxies.get(addr)
            if proxy is None:
                proxy = self._proxies[addr] = RemoteServerProxy(*addr, tls=self.tls)
            return proxy

    def _call(self, name: str, *args):
        attempts = max(1, len(self.manager.all()))
        last_err: Optional[BaseException] = None
        for _ in range(attempts):
            addr = self.manager.current()
            proxy = self._proxy_for(addr)
            try:
                return getattr(proxy, name)(*args)
            except (ConnectionError, OSError, TimeoutError) as e:
                last_err = e
                self.manager.notify_failed(addr)
            except RPCError as e:
                # leadership errors rotate like the reference's
                # canRetry (client/rpc.go IsErrNoLeader); other
                # application errors surface to the caller
                msg = str(e)
                if "NotLeaderError" in msg or "not the leader" in msg \
                        or "no known leader" in msg:
                    last_err = e
                    self.manager.notify_failed(addr)
                    continue
                raise e
        raise last_err  # type: ignore[misc]

    # -- ServerProxy surface --------------------------------------------

    def register_node(self, node):
        return self._call("register_node", node)

    def heartbeat(self, node_id: str):
        return self._call("heartbeat", node_id)

    def pull_allocs(self, node_id: str, min_index: int, timeout: float):
        return self._call("pull_allocs", node_id, min_index, timeout)

    def update_allocs(self, allocs):
        return self._call("update_allocs", allocs)

    def derive_vault_token(self, alloc_id, task_name, node_id="", node_secret=""):
        return self._call(
            "derive_vault_token", alloc_id, task_name, node_id, node_secret
        )

    def alloc_info(self, alloc_id: str):
        return self._call("alloc_info", alloc_id)

    def close(self) -> None:
        with self._lock:
            proxies = list(self._proxies.values())
            self._proxies.clear()
        for proxy in proxies:
            proxy.close()
