"""Server gossip membership: peer discovery, leader tags, federation.

Fills the role of reference ``nomad/serf.go`` (serf event loop →
``reconcileCh`` → peer add/remove, leader.go:859/:952) plus the ``peers``
region map (server.go:156) that powers cross-region RPC forwarding
(rpc.go:502 forwardRegion). Each server joins the gossip pool with tags
identifying its region/datacenter/RPC address, mirroring the reference's
serf tags (serf.go members are "<name>.<region>"); the current leader
re-tags itself ``leader=1`` so followers learn the forwarding target
without a separate election channel (the reference derives this from raft;
until the wire raft lands — see raft.py — gossip tags carry it).

Copied from ``nomad_tpu/server/membership.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.membership.<name>``.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..gossip.memberlist import Member, Memberlist, MemberlistConfig
from ..utils.lock_witness import witness_rlock


@dataclass
class ServerMeta:
    """A gossiped nomad server (reference nomad/util.go serverParts)."""

    name: str
    region: str
    datacenter: str
    rpc_host: str
    rpc_port: int
    expect: int
    is_leader: bool

    @property
    def rpc_addr(self) -> Tuple[str, int]:
        return (self.rpc_host, self.rpc_port)


def _parse_server(member: Member) -> Optional[ServerMeta]:
    tags = member.tags
    if tags.get("role") != "nomad":
        return None
    rpc = tags.get("rpc_addr", "")
    if ":" not in rpc:
        return None
    host, port = rpc.rsplit(":", 1)
    try:
        return ServerMeta(
            name=member.name,
            region=tags.get("region", "global"),
            datacenter=tags.get("dc", "dc1"),
            rpc_host=host,
            rpc_port=int(port),
            expect=int(tags.get("expect", "1")),
            is_leader=tags.get("leader") == "1",
        )
    except ValueError:
        return None


class ServerMembership:
    """Gossip participant for one server; maintains the region→servers map."""

    def __init__(
        self,
        name: str,
        region: str,
        datacenter: str,
        rpc_addr: Tuple[str, int],
        bind_host: str = "127.0.0.1",
        bind_port: int = 0,
        advertise_host: str = "",
        expect: int = 1,
        config: Optional[MemberlistConfig] = None,
        encrypt_key: bytes = b"",
    ) -> None:
        self.region = region
        self.logger = logging.getLogger(f"nomad_tpu_torch.membership.{name}")
        self._lock = witness_rlock("membership.ServerMembership._lock")
        # region → {member name → ServerMeta}; includes ourselves
        self.peers: Dict[str, Dict[str, ServerMeta]] = {}
        self._tags = {
            "role": "nomad",
            "region": region,
            "dc": datacenter,
            "rpc_addr": f"{rpc_addr[0]}:{rpc_addr[1]}",
            "expect": str(expect),
            "build": "0.10.2-tpu",
        }
        cfg = config or MemberlistConfig()
        cfg.name = f"{name}.{region}"
        cfg.bind_host = bind_host
        cfg.bind_port = bind_port
        cfg.advertise_host = advertise_host
        if encrypt_key:
            cfg.encrypt_key = encrypt_key
        self.memberlist = Memberlist(cfg, self._tags)
        self.memberlist.on_join = self._on_change
        self.memberlist.on_update = self._on_change
        self.memberlist.on_leave = self._on_gone
        self.memberlist.on_fail = self._on_gone
        # fires (meta, status) whenever the server set changes, status one
        # of "alive" | "failed" | "left" — the reference's reconcileCh
        # consumer (leader.go:836 reconcileMember). The distinction
        # matters: only a graceful leave may shrink the raft peer set;
        # removing voters on failure suspicion invites split-brain.
        self.on_server_change: Optional[Callable[[ServerMeta, str], None]] = None
        self._ingest(self.memberlist.local_member())

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ServerMembership":
        self.memberlist.start()
        return self

    def join(self, seeds: List[Tuple[str, int]]) -> int:
        n = self.memberlist.join(seeds)
        # seed states arrive via the push-pull merge → _on_change hooks
        return n

    def leave(self) -> None:
        self.memberlist.leave()

    @property
    def gossip_addr(self) -> Tuple[str, int]:
        return self.memberlist.addr

    # -- leadership tag --------------------------------------------------

    def set_leader(self, is_leader: bool) -> None:
        with self._lock:
            want = "1" if is_leader else ""
            if self._tags.get("leader", "") == want:
                return
            if is_leader:
                self._tags["leader"] = "1"
            else:
                self._tags.pop("leader", None)
            tags = dict(self._tags)
        self.memberlist.set_tags(tags)
        self._ingest(self.memberlist.local_member())

    # -- queries ---------------------------------------------------------

    def regions(self) -> List[str]:
        with self._lock:
            return sorted(r for r, servers in self.peers.items() if servers)

    def servers_in_region(self, region: Optional[str] = None) -> List[ServerMeta]:
        with self._lock:
            return list(self.peers.get(region or self.region, {}).values())

    def leader_in_region(self, region: Optional[str] = None) -> Optional[ServerMeta]:
        for s in self.servers_in_region(region):
            if s.is_leader:
                return s
        return None

    def num_servers(self) -> int:
        return len(self.servers_in_region())

    def members(self) -> List[Member]:
        return self.memberlist.all_members()

    # -- membership hooks ------------------------------------------------

    def _ingest(self, member: Member) -> Optional[ServerMeta]:
        meta = _parse_server(member)
        if meta is None:
            return None
        with self._lock:
            self.peers.setdefault(meta.region, {})[meta.name] = meta
        return meta

    def _on_change(self, member: Member) -> None:
        meta = self._ingest(member)
        if meta is not None and self.on_server_change is not None:
            self.on_server_change(meta, "alive")

    def _on_gone(self, member: Member) -> None:
        from ..gossip.memberlist import STATUS_LEFT

        meta = _parse_server(member)
        if meta is None:
            return
        with self._lock:
            self.peers.get(meta.region, {}).pop(meta.name, None)
        if self.on_server_change is not None:
            status = "left" if member.status == STATUS_LEFT else "failed"
            self.on_server_change(meta, status)
