"""Autopilot: server health tracking + dead-server cleanup.

Fills the role of reference ``nomad/autopilot.go`` (+ vendored
hashicorp/consul autopilot): the leader periodically scores every known
server's health (gossip liveness + raft replication lag) and, when
``cleanup_dead_servers`` is on, removes servers that gossip reports
failed — but only while a quorum of healthy voters remains, so cleanup
can never cause the loss of availability it exists to prevent. The
config is raft-replicated like SchedulerConfiguration and mutable at
runtime via /v1/operator/autopilot/configuration.

Copied from ``nomad_tpu/server/autopilot.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.autopilot``.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("nomad_tpu_torch.autopilot")

AUTOPILOT_CONFIG = "autopilot-config"


@dataclass
class AutopilotConfig:
    """structs/operator.go AutopilotConfig."""

    cleanup_dead_servers: bool = True
    last_contact_threshold_s: float = 10.0
    server_stabilization_time_s: float = 10.0
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ServerHealth:
    """structs/operator.go ServerHealth."""

    id: str = ""
    name: str = ""
    address: str = ""
    serf_status: str = "none"
    leader: bool = False
    voter: bool = True
    healthy: bool = False
    last_contact_s: float = -1.0
    last_index: int = 0
    stable_since: float = field(default_factory=time.monotonic)


class Autopilot:
    def __init__(self, server, membership=None, wire_raft=None,
                 interval: float = 2.0) -> None:
        self.server = server
        self.membership = membership
        self.wire_raft = wire_raft
        self.interval = interval
        self._health: Dict[str, ServerHealth] = {}
        # name → (raw_healthy, raw_since): stabilization clock input
        self._raw: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- config (raft-replicated) ----------------------------------------

    def config(self) -> AutopilotConfig:
        cfg = getattr(self.server.fsm.state, "autopilot_config_entry", None)
        return cfg if cfg is not None else AutopilotConfig()

    # -- health ----------------------------------------------------------

    def server_health(self) -> List[ServerHealth]:
        """Health snapshot for /v1/operator/autopilot/health."""
        out: List[ServerHealth] = []
        if self.membership is None:
            # single-server dev mode: we are trivially healthy
            return [ServerHealth(
                id=self.server.name, name=self.server.name,
                serf_status="alive", leader=self.server.is_leader,
                healthy=True, last_contact_s=0.0,
                last_index=self.server.fsm.state.latest_index,
            )]
        cfg = self.config()
        local_name = self.membership.memberlist.config.name
        members = {m.name: m for m in self.membership.members()}
        # health covers every nomad server gossip knows about — including
        # failed ones (the region map drops them; the operator must still
        # see WHY the cluster is degraded)
        from .membership import ServerMeta, _parse_server

        rows: Dict[str, ServerMeta] = {
            meta.name: meta for meta in self.membership.servers_in_region()
        }
        for member in members.values():
            if member.name in rows:
                continue
            meta = _parse_server(member)
            if meta is not None and meta.region == self.membership.region:
                rows[meta.name] = meta
        now = time.monotonic()
        for meta in rows.values():
            member = members.get(meta.name)
            serf_status = member.status if member is not None else "none"
            alive = serf_status == "alive"
            health = ServerHealth(
                id=meta.name,
                name=meta.name,
                address=f"{meta.rpc_host}:{meta.rpc_port}",
                serf_status=serf_status,
                leader=meta.is_leader,
                healthy=alive,
                last_contact_s=0.0 if alive else -1.0,
            )
            raw = alive
            if self.wire_raft is not None and self.server.is_leader:
                if meta.name == local_name:
                    health.last_index = self.wire_raft.commit_index
                else:
                    health.last_index = self.wire_raft.match_index.get(meta.name, 0)
                    lag = self.wire_raft.commit_index - health.last_index
                    if lag > 512:  # replication badly behind
                        raw = False
            # stabilization hold-down tracks RAW transitions (never the
            # reported value, which the hold-down itself suppresses — that
            # would reset the clock every tick and pin a recovered server
            # unhealthy forever). First sighting counts stable already.
            prev = self._raw.get(meta.name)
            if prev is None:
                since = now - cfg.server_stabilization_time_s
            elif prev[0] != raw:
                since = now
            else:
                since = prev[1]
            self._raw[meta.name] = (raw, since)
            health.stable_since = since
            health.healthy = raw and (now - since >= cfg.server_stabilization_time_s)
            out.append(health)
            self._health[meta.name] = health
        return out

    # -- dead server cleanup (autopilot.go pruneDeadServers) -------------

    def prune_dead_servers(self) -> List[str]:
        if (
            self.membership is None
            or self.wire_raft is None
            or not self.server.is_leader
            or not self.config().cleanup_dead_servers
        ):
            return []
        peers = dict(self.wire_raft.peers)
        cluster = len(peers) + 1
        quorum = cluster // 2 + 1
        alive = {m.name for m in self.membership.members() if m.status == "alive"}
        dead = [peer_id for peer_id in peers if peer_id not in alive]
        # never remove more servers than keeps a healthy quorum
        removable = max(0, cluster - quorum)
        removed = []
        remove = getattr(
            self.wire_raft, "remove_peer_replicated", self.wire_raft.remove_peer
        )
        for peer_id in dead[:removable]:
            logger.warning("autopilot removing dead server %s", peer_id)
            try:
                remove(peer_id)
            except Exception as e:  # noqa: BLE001 — e.g. lost leadership mid-prune
                logger.warning("removal of %s failed: %s", peer_id, e)
                continue
            removed.append(peer_id)
        return removed

    # -- loop ------------------------------------------------------------

    def start(self) -> "Autopilot":
        self._thread = threading.Thread(
            target=self._loop, name="autopilot", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.server_health()
                self.prune_dead_servers()
            except Exception:  # noqa: BLE001
                logger.exception("autopilot tick failed")

    def stop(self) -> None:
        self._stop.set()
