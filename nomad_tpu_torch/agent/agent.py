"""The agent: embeds a server and/or client plus the HTTP front-end.

Fills the role of the reference's ``command/agent/agent.go`` (NewAgent
:90, setupServer :560, setupClient :735): one process that can be a
server, a client, or both (dev mode), serving /v1 over HTTP. The
in-process wiring (client dials the embedded server directly) matches
the reference's dev-mode agent; distributed wiring rides the RPC
transport (``rpc``).

Copied from ``nomad_tpu/agent/agent.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: ``AgentConfig.device``
(default ``"cuda"``) is the torch device the embedded server places on
(``ServerConfig.device``), and an agent asked for CUDA on a host without
it raises before it binds a port (nothing falls back to the CPU); the
leader address that gossip reports is set and cleared under a lock of
the agent's (the reference does it unlocked from two gossip threads).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..client.client import Client, ClientConfig, ServerProxy
from ..server.server import Server, ServerConfig
from .http import HTTPServer, Request
from .routes import Routes


@dataclass
class AgentConfig:
    name: str = "agent-1"
    region: str = "global"
    datacenter: str = "dc1"
    server_enabled: bool = True
    client_enabled: bool = False
    dev_mode: bool = False
    http_bind: str = "127.0.0.1"
    http_port: int = 0  # 0 = ephemeral; reference default 4646
    rpc_bind: str = "127.0.0.1"
    rpc_port: int = 0  # reference default 4647
    serf_bind: str = "127.0.0.1"
    serf_port: int = 0  # reference default 4648
    advertise_addr: str = ""  # routable host gossiped to peers; required with 0.0.0.0 binds
    gossip_enabled: bool = True
    retry_join: List[str] = field(default_factory=list)  # "host:port" gossip addrs
    retry_join_interval: float = 3.0
    bootstrap_expect: int = 1
    num_schedulers: int = 2
    # seconds a node may stay past its heartbeat TTL before it is marked
    # down (the server stanza's heartbeat_grace; ServerConfig's default)
    heartbeat_grace: float = 10.0
    scheduler_algorithm: str = "tpu_binpack"
    # torch device of the embedded server's placement engine ("cuda" or
    # "cpu"); "cuda" without a card raises
    device: str = "cuda"
    # chunked-tier knobs (default_scheduler_config stanza); only read
    # when scheduler_algorithm = "tpu_binpack_chunked"
    chunk_k: int = 128
    parity_sample_rate: float = 0.05
    acl_enabled: bool = False
    # gossip encryption key (reference agent `encrypt` option): base64 of
    # 16/24/32 bytes; all servers must share it — plaintext packets drop
    encrypt: str = ""
    # federation: non-authoritative regions mirror ACL policies + global
    # tokens from here (reference authoritative_region + replication_token)
    authoritative_region: str = ""
    replication_token: str = ""
    acl_replication_interval: float = 30.0
    node_class: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    # client host_volume stanzas: name -> host path (reference client
    # config host_volume blocks)
    host_volumes: Dict[str, str] = field(default_factory=dict)
    # telemetry push sinks (reference command/agent/command.go:976-1018:
    # statsite/statsd/DataDog fan-out next to the inmem sink).
    # "host:port" UDP addresses; statsite speaks the statsd line protocol
    telemetry_statsd_address: str = ""
    telemetry_datadog_address: str = ""
    telemetry_datadog_tags: Dict[str, str] = field(default_factory=dict)
    telemetry_prefix: str = ""
    # flight recorder (telemetry stanza): leader-owned ~250ms sampler
    # behind GET /v1/flight; <= 0 interval disables the thread entirely
    flight_interval_s: float = 0.25
    flight_retain: int = 1024
    flight_spill_dir: str = ""
    # multi-process consensus: real raft over the RPC transport instead of
    # the in-proc shared log. Requires gossip; with bootstrap_expect > 1
    # the raft holds elections only once that many servers are known
    # (reference server.go bootstrap_expect semantics).
    wire_raft: bool = False
    data_dir: str = ""  # durable raft log + snapshots (and client state)
    enable_debug: bool = False  # /v1/agent/pprof dumps (http.go:220)
    # client-only agents dial these server RPC addrs ("host:port") —
    # reference client config `servers` list
    servers: List[str] = field(default_factory=list)
    # mutual TLS for the RPC plane (reference agent `tls` stanza +
    # helper/tlsutil): all three paths required to enable
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_http: bool = False  # also serve the /v1 API over HTTPS (mTLS)
    # verify the dialed server's cert SAN is "server.<region>.nomad" so a
    # client-cert holder can't pose as a server (verify_server_hostname);
    # requires role-named certs — disable for legacy address-named certs
    tls_verify_server_hostname: bool = True


class _LeaderFailoverProxy:
    """Client⇆server surface for a client colocated with a wire-raft
    server: local calls first; writes rejected with NotLeader retry over
    RPC against the gossip-learned leader (the reference client always
    RPCs and the transport forwards — this keeps the fast local path for
    reads and leader-mode)."""

    def __init__(self, agent: "Agent", local) -> None:
        self._agent = agent
        self._local = local
        self._remote = None
        self._remote_lock = threading.Lock()

    def _leader_remote(self):
        from ..rpc.endpoints import RemoteServerProxy

        addr = self._agent.rpc.leader_addr if self._agent.rpc else None
        if addr is None:
            raise RuntimeError("no known leader")
        addr = tuple(addr)
        # locked check-close-create: heartbeat/sync/vault threads all come
        # through here concurrently, and a leader flap must not leak conns
        with self._remote_lock:
            if self._remote is not None and self._remote.rpc.addr != addr:
                self._remote.close()
                self._remote = None
            if self._remote is None:
                self._remote = RemoteServerProxy(
                    *addr, tls=self._agent.tls
                )
            return self._remote

    def close(self) -> None:
        with self._remote_lock:
            if self._remote is not None:
                self._remote.close()
                self._remote = None

    def _call(self, name, *args):
        # writes carry leader-side effects (heartbeat TTL timers live on
        # the leader): route them there whenever we aren't it
        if self._agent.server is not None and self._agent.server.is_leader:
            return getattr(self._local, name)(*args)
        return getattr(self._leader_remote(), name)(*args)

    def register_node(self, node):
        return self._call("register_node", node)

    def heartbeat(self, node_id):
        return self._call("heartbeat", node_id)

    def pull_allocs(self, node_id, min_index, timeout):
        return self._local.pull_allocs(node_id, min_index, timeout)  # local read

    def update_allocs(self, allocs):
        return self._call("update_allocs", allocs)

    def alloc_info(self, alloc_id):
        return self._local.alloc_info(alloc_id)

    def derive_vault_token(self, alloc_id, task_name, node_id="", node_secret=""):
        return self._call(
            "derive_vault_token", alloc_id, task_name, node_id, node_secret
        )


class Agent:
    def __init__(
        self,
        config: Optional[AgentConfig] = None,
        server: Optional[Server] = None,
        client: Optional[Client] = None,
    ) -> None:
        self.config = config or AgentConfig()
        if self.config.dev_mode:
            self.config.server_enabled = True
            self.config.client_enabled = True

        if server is None and self.config.server_enabled:
            from ..tpu.convert import resolve_device

            resolve_device(self.config.device)
        self.server: Optional[Server] = server
        self.client: Optional[Client] = client
        self.wire_raft = None
        self.tls = None
        tls_parts = (self.config.tls_ca_file, self.config.tls_cert_file,
                     self.config.tls_key_file)
        if any(tls_parts):
            if not all(tls_parts):
                # a half-configured stanza silently serving plaintext is
                # the worst failure mode mTLS can have
                raise ValueError(
                    "TLS requires all of tls_ca_file, tls_cert_file and "
                    "tls_key_file (got a partial set)"
                )
            from ..rpc.transport import TLSConfig

            self.tls = TLSConfig(
                *tls_parts,
                server_name=f"server.{self.config.region}.nomad",
                verify_server_hostname=self.config.tls_verify_server_hostname,
            )
        if self.config.tls_http and self.tls is None:
            raise ValueError(
                "tls_http requires tls_ca_file/tls_cert_file/tls_key_file"
            )
        # the RPC listener binds before the server exists: wire raft needs
        # its address to register handlers, and peers need it to dial us
        self.rpc = None
        if self.config.server_enabled or self.server is not None:
            from ..rpc.transport import RPCServer

            self.rpc = RPCServer(
                self.config.rpc_bind, self.config.rpc_port,
                region=self.config.region, tls=self.tls,
            )
        if self.server is None and self.config.server_enabled:
            raft = None
            if self.config.wire_raft:
                from ..server.wire_raft import WireRaft, WireRaftConfig

                data_dir = self.config.data_dir or None
                self.wire_raft = WireRaft(
                    self.rpc,
                    peers={},  # filled from gossip before election starts
                    # raft ids match gossip member names ("<name>.<region>")
                    # so serf→raft reconciliation is a straight map
                    config=WireRaftConfig(
                        node_id=f"{self.config.name}.{self.config.region}"
                    ),
                    data_dir=data_dir,
                )
                raft = self.wire_raft
            elif self.config.data_dir:
                # single-server durability: the in-proc raft persists its
                # log/snapshots so a restarted agent replays server state
                import os as _os

                from ..server.raft import InProcRaft

                raft = InProcRaft(
                    data_dir=_os.path.join(self.config.data_dir, "raft")
                )
            self.server = Server(
                ServerConfig(
                    num_schedulers=self.config.num_schedulers,
                    heartbeat_grace=self.config.heartbeat_grace,
                    scheduler_algorithm=self.config.scheduler_algorithm,
                    device=self.config.device,
                    chunk_k=self.config.chunk_k,
                    parity_sample_rate=self.config.parity_sample_rate,
                    region=self.config.region,
                    authoritative_region=self.config.authoritative_region,
                    replication_token=self.config.replication_token,
                    replication_interval=self.config.acl_replication_interval,
                    flight_interval_s=self.config.flight_interval_s,
                    flight_retain=self.config.flight_retain,
                    flight_spill_dir=self.config.flight_spill_dir,
                ),
                raft=raft,
                name=self.config.name,
            )
        if self.client is None and self.config.client_enabled:
            if self.server is not None:
                proxy = ServerProxy(self.server)
                if self.config.wire_raft:
                    # a colocated client on a FOLLOWER can't write through
                    # the in-process server; wrap with leader-RPC failover
                    proxy = _LeaderFailoverProxy(self, proxy)
            elif self.config.servers:
                from ..client.servers import FailoverServerProxy, ServersManager

                addrs = []
                for a in self.config.servers:
                    host, sep, port = a.rpartition(":")
                    if not sep or not port.isdigit():
                        raise ValueError(
                            f"server address {a!r} must be host:port"
                        )
                    addrs.append((host, int(port)))
                # per-call failover over the full candidate list (the
                # reference's client/servers manager): every RPC uses the
                # current best server; a failed call rotates and retries
                proxy = FailoverServerProxy(ServersManager(addrs), tls=self.tls)
            else:
                raise ValueError(
                    "client-only agents need -servers addresses or a server"
                )
            client_cfg = ClientConfig(
                datacenter=self.config.datacenter,
                node_class=self.config.node_class,
                meta=dict(self.config.meta),
                host_volumes=dict(self.config.host_volumes),
                tls=self.tls,
            )
            if self.config.data_dir:
                import os as _os

                client_cfg.state_dir = _os.path.join(self.config.data_dir, "client")
                client_cfg.persist_state = True
            self.client = Client(proxy, client_cfg)

        self.http = HTTPServer(
            self.config.http_bind, self.config.http_port,
            tls=self.tls if self.config.tls_http else None,
        )
        self.routes = Routes(self)
        self.routes.register_all(self.http)
        self.acl_resolver = None
        if self.config.acl_enabled:
            if self.server is None:
                raise ValueError("ACLs require a server-mode agent")
            from ..acl import ACLResolver

            self.acl_resolver = ACLResolver(lambda: self.server.fsm.state)
        from .acl_routes import ACLRoutes
        from .fs_routes import FSRoutes

        self.acl_routes = ACLRoutes(self)
        self.acl_routes.register_all(self.http)
        self.fs_routes = FSRoutes(self)
        self.fs_routes.register_all(self.http)
        from .ui import register_ui

        register_ui(self.http, self)

        # distributed wiring: RPC endpoints + gossip membership
        # (reference agent.go:560 setupServer → nomad.NewServer → setupRPC/Serf)
        self.membership = None
        if self.server is not None:
            from ..rpc.endpoints import bind_server
            from ..server.membership import ServerMembership

            bind_server(self.server, self.rpc)
            self.rpc.register("Region.List", self.regions)
            self.rpc.is_leader = lambda: self.server.is_leader  # race-ok: set before rpc.start(); no dispatch thread runs yet
            # follower workers dequeue from the leader through this
            # (worker.go:161 Eval.Dequeue; address learned via gossip)
            self.server.get_leader_rpc_addr = lambda: self.rpc.leader_addr
            self.server.rpc_tls = self.tls
            if self.config.gossip_enabled:
                from ..gossip.memberlist import resolve_advertise_host

                rpc_host = resolve_advertise_host(
                    self.config.advertise_addr or self.rpc.addr[0]
                )
                self.membership = ServerMembership(
                    name=self.config.name,
                    region=self.config.region,
                    datacenter=self.config.datacenter,
                    rpc_addr=(rpc_host, self.rpc.addr[1]),
                    bind_host=self.config.serf_bind,
                    bind_port=self.config.serf_port,
                    advertise_host=self.config.advertise_addr,
                    expect=self.config.bootstrap_expect,
                    encrypt_key=self.config.encrypt.encode()
                    if self.config.encrypt else b"",
                )
                self.rpc.region_servers = lambda region: [  # race-ok: set before rpc.start(); no dispatch thread runs yet
                    s.rpc_addr for s in self.membership.servers_in_region(region)
                ]
                # cross-region RPC for the server's leader loops (ACL
                # replication): rides the transport's region forwarding
                self.server.region_rpc = (
                    lambda method, region, *args:
                    self.rpc._forward_region(region, method, args)
                )
                self.membership.on_server_change = self._on_server_change
                self.server.raft.leadership_observers.append(self._on_raft_leadership)
        # monitor + autopilot (reference command/agent/monitor, autopilot.go)
        from .monitor import AgentMonitor

        self.monitor = AgentMonitor().attach()
        self.autopilot = None
        if self.server is not None:
            from ..server.autopilot import Autopilot

            self.autopilot = Autopilot(
                self.server, membership=self.membership, wire_raft=self.wire_raft
            )

        self._started = False
        self._join_done = None
        self._raft_started = False
        self._raft_boot_lock = threading.Lock()
        self._leader_lock = threading.Lock()
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Agent":
        with self._lock:
            if self._started:
                return self
            self._setup_telemetry_sinks()
            if self.rpc is not None:
                self.rpc.start()
            if self.server is not None:
                self.server.start()
            if self.membership is not None:
                self.membership.start()
                if self.server.is_leader:
                    self.membership.set_leader(True)
                if self.config.retry_join:
                    self._start_retry_join()
            self._maybe_bootstrap_raft()
            if self.autopilot is not None:
                self.autopilot.start()
            # HTTP before the client: the node registration advertises this
            # agent's HTTP address for cross-node fs/logs proxying
            self.http.start()
            if self.client is not None:
                from ..gossip.memberlist import resolve_advertise_host

                http_host = resolve_advertise_host(
                    self.config.advertise_addr or self.http.addr[0]
                )
                addr = f"{http_host}:{self.http.addr[1]}"
                if self.http.tls is not None:
                    addr = f"https://{addr}"
                self.client.node.http_addr = addr
                self.client.start()
            # register telemetry sinks LAST: a failure anywhere above
            # leaves nothing process-global behind (shutdown only runs
            # once _started is set)
            from ..utils import metrics as _metrics

            for sink in getattr(self, "_telemetry_sinks", []):
                _metrics.register_sink(sink)
            self._started = True
        return self

    def _maybe_bootstrap_raft(self) -> None:
        if self.wire_raft is None:
            return
        with self._raft_boot_lock:
            self._maybe_bootstrap_raft_locked()

    def _maybe_bootstrap_raft_locked(self) -> None:
        """Start wire-raft elections once bootstrap_expect servers are
        known via gossip (reference: serf handler bootstraps the raft peer
        set at expect, nomad/serf.go nodeJoin → maybeBootstrap). Caller
        holds _raft_boot_lock."""
        if self._raft_started:
            return
        if self.membership is None:
            self.wire_raft.start()  # no gossip: solo (dev) raft
            self._raft_started = True
            return
        known = self.membership.servers_in_region()
        if len(known) < self.config.bootstrap_expect:
            return
        for meta in known:
            self.wire_raft.add_peer(meta.name, meta.rpc_addr)
        self.wire_raft.start()
        self._raft_started = True

    @staticmethod
    def _parse_addr(addr: str) -> Tuple[str, int]:
        host, port = addr.rsplit(":", 1)
        return (host, int(port))

    def _start_retry_join(self) -> None:
        """Join the gossip pool, retrying until at least one seed responds
        (the reference's retry_join loop, command/agent/command.go
        retryJoin). Runs in the background so startup isn't blocked by
        seeds that boot later."""
        seeds = [self._parse_addr(a) for a in self.config.retry_join]
        self._join_done = threading.Event()

        def loop() -> None:
            while not self._join_done.is_set():
                if self.membership.join(seeds) > 0:
                    self._join_done.set()
                    return
                self._join_done.wait(self.config.retry_join_interval)

        t = threading.Thread(target=loop, name="retry-join", daemon=True)
        t.start()

    def _setup_telemetry_sinks(self) -> None:
        """Fan metrics out to the configured push sinks (the reference's
        setupTelemetry, command.go:976-1018)."""
        from ..utils import metrics as _metrics

        # construct everything FIRST: a bad address raises before any
        # sink registers, so a failed start leaks nothing process-global
        sinks = []
        if self.config.telemetry_statsd_address:
            sinks.append(_metrics.StatsdSink(
                self.config.telemetry_statsd_address,
                prefix=self.config.telemetry_prefix,
            ))
        if self.config.telemetry_datadog_address:
            sinks.append(_metrics.StatsdSink(
                self.config.telemetry_datadog_address,
                prefix=self.config.telemetry_prefix,
                datadog=True, tags=self.config.telemetry_datadog_tags,
            ))
        self._telemetry_sinks = sinks

    def shutdown(self) -> None:
        with self._lock:
            if not self._started:
                return
            from ..utils import metrics as _metrics

            for sink in getattr(self, "_telemetry_sinks", []):
                _metrics.deregister_sink(sink)
            self._telemetry_sinks = []
            self.http.stop()
            if self.client is not None:
                self.client.shutdown()
            if self.autopilot is not None:
                self.autopilot.stop()
            self.monitor.detach()
            if getattr(self, "_join_done", None) is not None:
                self._join_done.set()  # stop an unfinished retry-join loop
            if self.membership is not None:
                self.membership.leave()
            if self.rpc is not None:
                self.rpc.stop()
            if self.server is not None:
                self.server.stop()
            if self.wire_raft is not None:
                self.wire_raft.close()
            self._started = False

    # -- membership hooks ------------------------------------------------

    def _on_raft_leadership(self, peer: int, is_leader: bool) -> None:
        if self.server is not None and peer == self.server.peer:
            if self.membership is not None:
                self.membership.set_leader(is_leader)
        # a NEW leader reconciles gossip membership into the replicated
        # configuration (leader.go:836 reconcile): members that joined
        # while there was no leader (or during a partition) get their
        # staged add now
        if is_leader and self.wire_raft is not None and self.membership is not None:
            for meta in self.membership.servers_in_region():
                if meta.name != self.config.name:
                    self.wire_raft.add_peer_staged(meta.name, meta.rpc_addr)

    def _on_server_change(self, meta, status: str) -> None:
        """Track the local region's leader for RPC forwarding
        (reference serf.go → leader forwarding via raft; here the leader
        tag gossips the address)."""
        if meta.region != self.config.region or self.rpc is None:
            return
        alive = status == "alive"
        # the gossip listener and prober both report changes: the
        # check-then-clear below must not interleave with a new leader's set
        with self._leader_lock:
            self._track_leader_locked(meta, alive)
        # serf → raft peer reconciliation (leader.go:859/:952). The boot
        # lock serializes against an in-flight bootstrap so a server whose
        # join races it still lands in the peer set. Only a graceful LEAVE
        # shrinks the voter set — removing peers on failure suspicion would
        # let a partitioned minority elect itself (split-brain); a failed
        # peer stays a voter and simply doesn't ack (reference: serf
        # Leave/Reap remove peers, failures don't).
        if self.wire_raft is not None:
            if alive:
                with self._raft_boot_lock:
                    if self._raft_started:
                        # post-bootstrap additions are LOG-REPLICATED: the
                        # leader stages the peer nonvoter -> voter; other
                        # nodes only retarget addresses of known peers and
                        # learn new ones from the committed config entries
                        # — a minority partition can never grow its own
                        # voter set
                        if not self.wire_raft.add_peer_staged(
                            meta.name, meta.rpc_addr
                        ):
                            self.wire_raft.note_peer_address(
                                meta.name, meta.rpc_addr
                            )
                    else:
                        self._maybe_bootstrap_raft_locked()
            elif status == "left":
                self.wire_raft.remove_peer(meta.name)

    def _track_leader_locked(self, meta, alive: bool) -> None:
        """Point RPC forwarding at the region's leader. Caller holds
        ``_leader_lock``."""
        if alive and meta.is_leader:
            self.rpc.leader_addr = meta.rpc_addr
        elif self.rpc.leader_addr == meta.rpc_addr:
            # the leader died, or stepped down while staying alive — either
            # way, stop forwarding writes to it
            self.rpc.leader_addr = None

    @property
    def http_scheme(self) -> str:
        return "https" if self.http.tls is not None else "http"

    @property
    def http_addr(self) -> str:
        host, port = self.http.addr
        return f"{self.http_scheme}://{host}:{port}"

    # -- surface used by routes ------------------------------------------

    def authorize(self, req: Request, capabilities, namespace: str) -> None:
        """ACL choke point: every handler passes through here. A no-op
        until ACLs are enabled (reference: aclObj checks in every
        endpoint, e.g. job_endpoint.go:100)."""
        if self.acl_resolver is not None:
            self.acl_resolver.check_http(req, capabilities, namespace)

    def peer_names(self) -> List[str]:
        if self.server is None:
            return []
        if self.membership is not None:
            return [s.name for s in self.membership.servers_in_region()]
        return [f"{self.config.name}"]

    def remove_raft_peer(self, peer_id: str) -> None:
        """Replicated removal of a consensus peer (reference
        operator_endpoint.go RaftRemovePeerByID). Wire-raft only; the
        in-proc dev raft has no membership to mutate."""
        if self.wire_raft is None:
            raise ValueError("raft peer removal requires wire raft (-raft)")
        if peer_id == self.wire_raft.node_id:
            raise ValueError("refusing to remove self; run on another server")
        if peer_id not in self.wire_raft.peers:
            raise ValueError(f"unknown raft peer {peer_id!r}")
        self.wire_raft.remove_peer_replicated(peer_id)

    def raft_servers(self) -> List[Tuple[str, str, bool]]:
        if self.server is None:
            return []
        if self.wire_raft is not None:
            # the actual consensus configuration — this is what autopilot's
            # dead-server cleanup mutates
            out = [(
                self.wire_raft.node_id,
                "{}:{}".format(*self.rpc.addr),
                self.server.is_leader,
            )]
            leader_id = self.wire_raft.leader_id
            # snapshot: autopilot prunes peers concurrently
            for peer_id, addr in dict(self.wire_raft.peers).items():
                out.append((peer_id, "{}:{}".format(*addr), peer_id == leader_id))
            return out
        if self.membership is not None:
            return [
                (s.name, f"{s.rpc_host}:{s.rpc_port}", s.is_leader)
                for s in self.membership.servers_in_region()
            ]
        addr = (
            "{}:{}".format(*self.rpc.addr) if self.rpc is not None else self.http_addr
        )
        return [(self.config.name, addr, self.server.is_leader)]

    def _memberlist(self):
        if self.membership is None:
            raise ValueError("gossip is not enabled on this agent")
        return self.membership.memberlist

    def join(self, addrs: List[str]) -> int:
        """Runtime gossip join (reference agent Join): 'host:port' list,
        returns how many seeds responded."""
        seeds = []
        for a in addrs:
            host, _, port = a.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"join address {a!r} must be host:port")
            seeds.append((host, int(port)))
        return self._memberlist().join(seeds)

    def force_leave(self, name: str) -> bool:
        """Evict a (failed) gossip member (serf RemoveFailedNode)."""
        return self._memberlist().force_leave(name)

    def keyring(self, op: str, key: str):
        """Gossip keyring ops: list/install/use/remove. Mutations
        propagate cluster-wide over sealed gossip (serf's keyring ops
        are cluster queries)."""
        ml = self._memberlist()
        if op == "list":
            return ml.keyring_list()
        ml.keyring_broadcast(op, key)
        return None

    def known_servers(self) -> List[str]:
        if self.membership is not None:
            return [
                f"{s.rpc_host}:{s.rpc_port}"
                for s in self.membership.servers_in_region()
            ]
        return [self.http_addr] if self.server is not None else []

    def members(self) -> List[dict]:
        if self.server is None:
            return []
        if self.membership is not None:
            return [
                {
                    "Name": m.name,
                    "Addr": m.host,
                    "Port": m.port,
                    "Status": m.status,
                    "Leader": m.tags.get("leader") == "1",
                    "Tags": dict(m.tags),
                }
                for m in self.membership.members()
            ]
        return [
            {
                "Name": f"{self.config.name}.{self.config.region}",
                "Addr": self.http.addr[0],
                "Port": self.http.addr[1],
                "Status": "alive",
                "Leader": self.server.is_leader,
                "Tags": {
                    "region": self.config.region,
                    "dc": self.config.datacenter,
                    "role": "nomad",
                },
            }
        ]

    def regions(self) -> List[str]:
        if self.membership is not None:
            return self.membership.regions()
        return [self.config.region]

    def self_info(self) -> dict:
        stats = {}
        if self.server is not None:
            stats["nomad"] = {
                "server": "true",
                "leader": str(self.server.is_leader).lower(),
            }
        if self.client is not None:
            stats["client"] = {
                "node_id": self.client.node.id,
                "known_servers": ",".join(self.known_servers()),
            }
        return {
            "config": {
                "Region": self.config.region,
                "Datacenter": self.config.datacenter,
                "NodeName": self.config.name,
                "Server": {"Enabled": self.config.server_enabled},
                "Client": {"Enabled": self.config.client_enabled},
                "ACL": {"Enabled": self.config.acl_enabled},
                "Version": {"Version": "0.10.2-tpu"},
            },
            "stats": stats,
            "member": (self.members() or [{}])[0],
        }
