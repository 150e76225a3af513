"""Crash-recovery chaos: real-process SIGKILL failover for wire raft.

Where :class:`~nomad_tpu_torch.chaos.replay.ChurnReplay` *simulates* leader
loss with an in-proc leadership transfer, :class:`CrashReplay` spawns a
real N-server wire-raft cluster as separate OS processes (one
``data_dir`` each — durable log, term/vote meta, snapshot; see
:mod:`.crash_server`), drives the churn trace at the leader over RPC,
and realizes ``leader_kill`` as ``SIGKILL -9`` of the leader process
mid-wave. Recovery is then measured, not assumed:

- **time_to_new_leader_ms** — kill to a survivor reporting ``leader``
  at a HIGHER term (polled per-replica with ``no_forward=True``);
- **time_to_first_commit_ms** — kill to the first write committed
  through the new leader;
- **rejoin via InstallSnapshot** — after the trace, the new leader
  snapshots under load (compacting its log past the killed node's
  durable tail — forcing the compacted-log path), the killed process
  restarts from its ``data_dir`` and must catch up; the harness asserts
  ``snapshots_installed >= 1`` and applied-index convergence;
- the surviving cluster passes the same invariant sweep as the in-proc
  replay, with per-replica alloc counts fetched over RPC.

Timings publish as ``nomad.chaos.failover.*`` gauges via
:mod:`nomad_tpu_torch.trace.failover` and are bounded by
:class:`~nomad_tpu_torch.chaos.slo.SLOGate`'s failover thresholds.

Process-boundary limits (validated at construction): injector fault
windows are per-process and cannot arm across the boundary, canaried
rollouts need the in-proc deployment nurse, and compile warmup would
spawn a JAX storm per subprocess — crash traces carry none of these.

Copied from ``nomad_tpu/chaos/crash.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: :class:`ServerProcess` spawns
the port's ``crash_server`` and passes it ``--device`` (``device``,
default ``cuda``; :class:`CrashReplay` takes ``device`` and hands it to
every process), and sets no JAX environment; ``_free_port`` draws the
port from below the kernel's ephemeral range
(``/proc/sys/net/ipv4/ip_local_port_range``), where no ``bind(0)`` of
another process can take it between the check and the child's bind;
and the heartbeat pump runs in a process of its own (:mod:`.pump`,
fed by ``CrashReplay._pump_heartbeats``) and fails over within a pass:
as a thread of the harness it shared the GIL and each replica's one
connection with the measurement's bulk reads, and a whole pass went
through one server even while a restarted replica knew no leader; on a
slow host the fleet's TTLs ran out at once, and the node-update evals
that followed showed as lost allocs and diverging replicas.
"""
from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..rpc import transport as rpc_transport
from ..rpc.transport import RPCClient, RPCError
from ..trace import context as xtrace
from ..trace import failover
from ..trace.flight import FlightRecorder
from .pump import HeartbeatPump
from .replay import _RETRYABLE, ChurnReplay
from .trace import ChaosEvent

_READY_TIMEOUT_S = 45.0
# one heartbeat's bound: a relay slower than this hands the rest of the
# pump's pass to the next server (the nodes' TTLs are 4-6 s)
_PUMP_CALL_S = 1.0
_REAP_TIMEOUT_S = 10.0
_ELECTION_TIMEOUT_S = 30.0


_PORT_FLOOR = 10_000


def _ephemeral_low() -> int:
    """The first port of the kernel's ephemeral range (32768 where the
    range cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port() -> int:
    """A free loopback port for a child to bind, released for it.

    The port comes from below the kernel's ephemeral range: ``bind(0)``
    (every RPC server and client socket of another process) never hands
    those out, so between this check and the child's bind only another
    harness drawing from the same range could take it. The fixed port
    map is what lets a killed node restart at the same address."""
    import random

    hi = max(_ephemeral_low(), _PORT_FLOOR + 1)
    rng = random.SystemRandom()
    for _ in range(256):
        port = rng.randrange(_PORT_FLOOR, hi)
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
            return port
        except OSError:
            continue
        finally:
            s.close()
    raise RuntimeError(f"no free loopback port in [{_PORT_FLOOR}, {hi})")


class ServerProcess:
    """One crash-server OS process plus its RPC client.

    Owns the spawn / SIGKILL / graceful-terminate / restart lifecycle.
    Every spawn is reaped with a bounded ``wait`` (the
    ``subprocess-discipline`` lint rule) — an unkillable child raises
    instead of silently orphaning a nomad process."""

    def __init__(
        self,
        node_id: str,
        port: int,
        peers: Dict[str, Tuple[str, int]],
        data_dir: str,
        extra_args: Sequence[str] = (),
        device: str = "cuda",
    ) -> None:
        self.node_id = node_id
        self.device = device
        self.port = port
        self.peers = dict(peers)   # other members, excluding self
        self.data_dir = data_dir
        self.extra_args = tuple(extra_args)
        self.proc: Optional[subprocess.Popen] = None
        self._client: Optional[RPCClient] = None
        # made lazily by whichever harness thread calls first
        self._clients_lock = threading.Lock()
        self._logf = None

    def spawn(self) -> None:
        os.makedirs(self.data_dir, exist_ok=True)
        peers_arg = ",".join(
            f"{pid}={host}:{port}"
            for pid, (host, port) in sorted(self.peers.items())
        )
        cmd = [
            sys.executable, "-m", "nomad_tpu_torch.chaos.crash_server",
            "--node-id", self.node_id,
            "--rpc-port", str(self.port),
            "--peers", peers_arg,
            "--data-dir", self.data_dir,
            "--device", self.device,
            *self.extra_args,
        ]
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self._logf = open(os.path.join(self.data_dir, "server.log"), "ab")
        self.proc = subprocess.Popen(
            cmd, stdout=self._logf, stderr=subprocess.STDOUT, env=env,
        )

    def wait_ready(self, timeout: float = _READY_TIMEOUT_S) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"{self.node_id} exited rc={self.proc.returncode} "
                    f"during startup; tail: {self._log_tail()}"
                )
            try:
                if self.call("Status.ping", no_forward=True,
                             timeout=1.0) == "pong":
                    return
            except (RPCError, OSError):
                time.sleep(0.1)
        raise RuntimeError(
            f"{self.node_id} not ready after {timeout}s; "
            f"tail: {self._log_tail()}"
        )

    def _log_tail(self, n: int = 5) -> str:
        try:
            with open(os.path.join(self.data_dir, "server.log"), "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-n:]
                ).decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    def client(self) -> RPCClient:
        with self._clients_lock:
            if self._client is None:
                self._client = RPCClient("127.0.0.1", self.port, timeout=10.0)
            return self._client

    def call(self, method: str, *args, **kwargs):
        return self.client().call(method, *args, **kwargs)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _drop_client(self) -> None:
        with self._clients_lock:
            client, self._client = self._client, None
        if client is not None:
            client.close()

    def kill_hard(self) -> None:
        """SIGKILL -9: no shutdown path runs; the durable state is
        whatever already reached the disk."""
        if self.proc is None:
            return
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait(timeout=_REAP_TIMEOUT_S)
        self._drop_client()

    def terminate(self) -> None:
        """Graceful SIGTERM, escalating to SIGKILL on timeout. Always
        reaps (bounded) and closes the log handle."""
        try:
            if self.proc is not None and self.proc.poll() is None:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=_REAP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait(timeout=_REAP_TIMEOUT_S)
        finally:
            self._drop_client()
            if self._logf is not None:
                self._logf.close()
                self._logf = None

    def restart(self) -> None:
        """Re-spawn on the same port over the same data_dir (the
        durable-restart path: meta + log tail + snapshot reload)."""
        if self.alive():
            raise RuntimeError(f"{self.node_id} is still running")
        if self._logf is not None:
            self._logf.close()
            self._logf = None
        self._drop_client()
        self.spawn()


class RemoteState:
    """Read-side facade over the leader RPC surface, shaped like the
    slice of ``StateStore`` the replay driver actually reads."""

    def __init__(self, call) -> None:
        self._call = call

    def job_by_id(self, namespace: str, job_id: str):
        return self._call("Job.GetJob", namespace, job_id)

    def allocs_by_job(self, namespace: str, job_id: str, any_version: bool = True):
        return self._call("Job.Allocations", namespace, job_id)

    def allocs(self):
        return self._call("Alloc.List")


class RemoteLeader:
    """The ``Server`` methods ChurnReplay drives, over the wire."""

    def __init__(self, proc: ServerProcess) -> None:
        self.proc = proc
        self.name = proc.node_id
        self.fsm_state = RemoteState(proc.call)

    def register_node(self, node):
        return self.proc.call("Node.Register", node)

    def heartbeat(self, node_id: str):
        return self.proc.call("Node.Heartbeat", node_id)

    def register_job(self, job):
        return self.proc.call("Job.Register", job)

    def deregister_job(self, namespace: str, job_id: str, purge: bool = False):
        return self.proc.call("Job.Deregister", namespace, job_id, purge)

    def evaluate_job(self, namespace: str, job_id: str):
        return self.proc.call("Job.Evaluate", namespace, job_id)

    def update_node_drain(self, node_id: str, drain):
        return self.proc.call("Node.UpdateDrain", node_id, drain)


class CrashReplay(ChurnReplay):
    """Churn replay against a real multi-process wire-raft cluster.

    Construction kwargs beyond :class:`ChurnReplay` (whose ``config``,
    in-proc server objects and warmup do not apply here):

    - ``base_dir``: parent directory for per-node data dirs (a temp dir
      is created and removed when omitted);
    - ``server_args``: extra ``crash_server`` CLI flags, e.g.
      ``("--num-schedulers", "1")``;
    - ``restart_killed``: restart SIGKILLed servers after the trace and
      require snapshot-install catch-up (default True);
    - ``device``: every server process's ``--device`` (default ``cuda``;
      ``cpu`` for the plain path).
    """

    def __init__(
        self,
        seed: int = 0,
        trace: Optional[List[ChaosEvent]] = None,
        n_servers: int = 3,
        n_nodes: int = 50,
        settle_timeout_s: float = 60.0,
        trace_kwargs: Optional[dict] = None,
        base_dir: Optional[str] = None,
        server_args: Sequence[str] = (),
        restart_killed: bool = True,
        device: str = "cuda",
    ) -> None:
        kw = dict(trace_kwargs or {})
        # injector windows are per-process and cannot cross the boundary
        kw.setdefault("n_fault_windows", 0)
        super().__init__(
            seed=seed, trace=trace, n_servers=n_servers, n_nodes=n_nodes,
            settle_timeout_s=settle_timeout_s, trace_kwargs=kw,
        )
        bad = sorted({ev.kind for ev in self.trace
                      if ev.kind in ("arm_fault", "disarm_fault")})
        if bad:
            raise ValueError(
                f"crash traces cannot carry {bad}: the fault injector is "
                f"per-process and the servers are separate processes"
            )
        if any(ev.kind == "rollout" and ev.args.get("canary")
               for ev in self.trace):
            raise ValueError(
                "canaried rollouts need the in-proc deployment nurse; "
                "use ChurnReplay for canary scenarios"
            )
        self._nurse_enabled = False
        # the capacity monitor reads in-proc leader state; the replicas
        # here are separate processes
        self._capacity_monitor_enabled = False
        self.procs: Dict[str, ServerProcess] = {}
        self._leader_proc: Optional[ServerProcess] = None
        self._killed: List[str] = []
        self.restart_killed = bool(restart_killed)
        self.server_args = tuple(server_args)
        self.device = device
        self._owns_base = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="nomad-crash-")
        self.failover_info: Dict[str, object] = {}
        # parent-side flight recorder: the replicas are separate
        # processes, so the harness samples them over RPC (RaftStats +
        # BrokerStats per replica, no_forward) — the frame ring is the
        # failover's black box: which term each replica saw, when the
        # broker drained, when the killed node went dark
        self.harness_flight: Optional[FlightRecorder] = None
        # nomad-xtrace collector: incremental Trace.Export drains on the
        # flight-probe cadence, per-replica seq cursors so a re-poll
        # never double-counts and ring eviction only loses what the
        # collector was too slow to read
        self._trace_cursors: Dict[str, int] = {}
        self._collected_spans: Dict[str, List[Dict[str, object]]] = {}
        self._replica_rpc: Dict[str, Dict[str, object]] = {}
        self._trace_dropped: Dict[str, int] = {}
        self._collect_lock = threading.Lock()
        self._pump: Optional[HeartbeatPump] = None

    # -- cluster plumbing overrides ---------------------------------------

    def _start_cluster(self) -> None:
        ids = [f"crash-s{i}" for i in range(self.n_servers)]
        addr = {nid: ("127.0.0.1", _free_port()) for nid in ids}
        for nid in ids:
            peers = {other: a for other, a in addr.items() if other != nid}
            sp = ServerProcess(
                nid, addr[nid][1], peers,
                os.path.join(self.base_dir, nid),
                extra_args=self.server_args, device=self.device,
            )
            self.procs[nid] = sp
            sp.spawn()
        for sp in self.procs.values():
            sp.wait_ready()
        # warm before the fleet registers: the nodes' TTLs start then
        self._pump = HeartbeatPump(max(0.05, self.config.heartbeat_min_ttl / 3.0),
                                   _PUMP_CALL_S, os.path.join(self.base_dir, "pump.log"))
        self._pump.start()
        failover.reset()
        self.harness_flight = FlightRecorder(interval_s=1.0, retain=512)
        for nid, sp in self.procs.items():
            self.harness_flight.add_probe(
                f"replica:{nid}", self._mk_replica_probe(sp))
        # span collection rides the same cadence: each tick drains every
        # live replica's ring incrementally, so a later SIGKILL loses at
        # most one tick's worth of spans
        self.harness_flight.add_probe("xtrace", self._drain_traces)
        self.harness_flight.arm()

    def _mk_replica_probe(self, sp: ServerProcess):
        def probe() -> Dict[str, object]:
            if not sp.alive():
                return {"alive": False}
            # a mid-failover replica answers slowly or not at all; the
            # 1s RPC bound keeps the tick loop live and the recorder
            # stores the raised error as the frame's value
            raft = sp.call("Operator.RaftStats", no_forward=True, timeout=1.0)
            broker = sp.call("Eval.BrokerStats", no_forward=True, timeout=1.0)
            return {"alive": True, "raft": raft, "broker": broker}
        return probe

    def _flight_stats(self) -> Dict[str, object]:
        fl = self.harness_flight
        if fl is None:
            return {}
        return {"harness": dict(armed=fl.armed, **fl.overhead())}

    # -- nomad-xtrace collection ------------------------------------------

    def _drain_traces(self) -> Dict[str, object]:
        """One incremental collection pass: drain every live replica's
        span ring past this collector's cursor, plus its per-method RPC
        table. Doubles as a flight probe (the returned brief lands in
        the frame ring)."""
        with self._collect_lock:
            for nid, sp in self.procs.items():
                if not sp.alive():
                    continue
                try:
                    out = sp.call(
                        "Trace.Export", self._trace_cursors.get(nid, 0),
                        no_forward=True, timeout=2.0,
                    )
                except (RPCError, OSError):
                    continue
                spans = out.get("spans") or []
                if spans:
                    self._collected_spans.setdefault(nid, []).extend(spans)
                self._trace_cursors[nid] = int(
                    out.get("next_seq", self._trace_cursors.get(nid, 0)))
                self._trace_dropped[nid] = int(out.get("dropped", 0))
                self._replica_rpc[nid] = out.get("rpc") or {}
            return {
                "collected": sum(
                    len(v) for v in self._collected_spans.values()),
                "dropped": dict(self._trace_dropped),
            }

    def _span_sets(self) -> List[List[Dict[str, object]]]:
        """Final drain, then every replica's accumulated spans plus the
        driver's own ring (the RemoteLeader client spans live there)."""
        self._drain_traces()
        with self._collect_lock:
            sets = [list(xtrace.export()["spans"])]
            sets.extend(list(v) for v in self._collected_spans.values())
        return sets

    def _rpc_result(self) -> Dict[str, object]:
        """Cluster-wide per-method table: every replica's wire-form
        table merged (histogram buckets add; percentiles recomputed from
        the merged histogram), plus the per-replica views."""
        with self._collect_lock:
            per_replica = {
                nid: table for nid, table in sorted(self._replica_rpc.items())
            }
        return {
            "cluster": rpc_transport.merge_rpc_tables(per_replica.values()),
            "replicas": {
                nid: {
                    m: {k: v for k, v in row.items() if k != "latency_hist"}
                    for m, row in table.items()
                }
                for nid, table in per_replica.items()
            },
        }

    def _pump_heartbeats(self) -> None:
        """Feeds the heartbeat pump process (:mod:`.pump`) the harness's
        view: the nodes, the muted ones, the live followers and the
        leader. The reference heartbeats from this thread itself
        (``ChurnReplay._pump_heartbeats``, kept for the in-process
        replay)."""
        while not self._pump_stop.wait(0.1):
            with self._mute_lock:
                muted = set(self._muted)
            lp = self._leader_proc
            followers = [("127.0.0.1", sp.port) for sp in list(self.procs.values())
                         if sp.alive() and sp is not lp]
            leader = ("127.0.0.1", lp.port) if lp is not None and lp.alive() else None
            if self._pump is not None:
                self._pump.update(list(self.node_ids), muted, followers, leader)

    def _find_leader_proc(self, timeout: float = 5.0,
                          min_term: int = 0) -> ServerProcess:
        """Poll every LIVE replica's raft stats locally (no_forward —
        leader forwarding would answer for the wrong node) until one
        reports leadership at term > min_term."""
        deadline = time.monotonic() + timeout
        while True:
            for sp in self.procs.values():
                if not sp.alive():
                    continue
                try:
                    st = sp.call("Operator.RaftStats", no_forward=True,
                                 timeout=1.0)
                except (RPCError, OSError):
                    continue
                if st.get("state") == "leader" and st.get("term", 0) > min_term:
                    self._leader_proc = sp
                    return sp
            if time.monotonic() > deadline:
                raise RuntimeError("no leader within timeout")
            time.sleep(0.05)

    def _leader(self, timeout: float = 5.0) -> RemoteLeader:
        lp = self._leader_proc
        if lp is not None and lp.alive():
            try:
                st = lp.call("Operator.RaftStats", no_forward=True,
                             timeout=1.0)
                if st.get("state") == "leader":
                    return RemoteLeader(lp)
            except (RPCError, OSError):
                pass
            self._leader_proc = None
        return RemoteLeader(self._find_leader_proc(timeout=timeout))

    def _leader_state(self):
        return self._leader().fsm_state

    def _broker_stats(self) -> Dict[str, int]:
        return self._leader().proc.call("Eval.BrokerStats")

    def _kill_leader(self) -> None:
        if self._killed:
            return   # at most one real kill per run; retries are no-ops
        lp = self._find_leader_proc()
        try:
            pre = lp.call("Operator.RaftStats", no_forward=True, timeout=1.0)
        except (RPCError, OSError):
            pre = {}
        old_term = int(pre.get("term", 0))
        t0 = time.monotonic()
        lp.kill_hard()
        self._killed.append(lp.node_id)
        self._leader_proc = None
        self.leader_kills += 1
        try:
            new_leader = self._find_leader_proc(
                timeout=_ELECTION_TIMEOUT_S, min_term=old_term)
        except RuntimeError:
            self.errors.append(  # race-ok: GIL-atomic append; harness list, read after threads settle
                f"failover: no new leader within {_ELECTION_TIMEOUT_S}s")
            return
        t_leader_ms = (time.monotonic() - t0) * 1000.0
        # first post-failover commit: a real write through the new leader
        # (re-evaluating a known job goes through raft_apply)
        t_commit_ms = None
        probe = next(iter(self._expected), None)
        if probe is not None:
            deadline = t0 + _ELECTION_TIMEOUT_S
            leader = RemoteLeader(new_leader)
            while time.monotonic() < deadline:
                try:
                    leader.evaluate_job(*probe)
                    t_commit_ms = (time.monotonic() - t0) * 1000.0
                    break
                except (RPCError, OSError):
                    time.sleep(0.05)
        self.failover_info = failover.record(
            killed=lp.node_id,
            new_leader=new_leader.node_id,
            old_term=old_term,
            time_to_new_leader_ms=round(t_leader_ms, 1),
            time_to_first_commit_ms=(
                round(t_commit_ms, 1) if t_commit_ms is not None else None),
        )

    def _post_trace(self) -> None:
        """Force the compacted-log path, then bring the corpse back.

        Snapshotting the NEW leader while the killed node is still down
        compacts the leader's log past the killed node's durable tail,
        so catch-up cannot ride AppendEntries — it must go through
        InstallSnapshot, the path this harness exists to exercise."""
        if not self._killed or not self.restart_killed:
            return
        snap_index = 0
        for _ in range(40):
            try:
                snap_index = int(
                    self._leader().proc.call("Operator.SnapshotSave"))
                break
            except _RETRYABLE:
                time.sleep(0.25)
        t0 = time.monotonic()
        for nid in self._killed:
            sp = self.procs[nid]
            try:
                sp.restart()
                sp.wait_ready()
            except (RuntimeError, OSError) as e:
                self.errors.append(f"restart {nid}: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
                return
        rejoined = False
        installs = 0
        deadline = time.monotonic() + self.settle_timeout_s
        while time.monotonic() < deadline:
            try:
                stats = [
                    self.procs[nid].call("Operator.RaftStats",
                                         no_forward=True, timeout=1.0)
                    for nid in self._killed
                ]
            except (RPCError, OSError):
                time.sleep(0.1)
                continue
            installs = sum(int(s.get("snapshots_installed", 0))
                           for s in stats)
            if snap_index > 0 and all(
                int(s.get("applied_index", 0)) >= snap_index for s in stats
            ):
                rejoined = True
                break
            time.sleep(0.1)
        self.failover_info = failover.note(
            snapshot_index=snap_index,
            snapshot_installs=installs,
            rejoined=rejoined,
            restart_catchup_ms=(
                round((time.monotonic() - t0) * 1000.0, 1)
                if rejoined else None),
        )
        if not rejoined:
            self.errors.append(  # race-ok: GIL-atomic append; harness list, read after threads settle
                f"restarted {self._killed} did not catch up to snapshot "
                f"index {snap_index} (installs={installs})"
            )

    def _replica_run_counts(self) -> Dict[str, Optional[int]]:
        from ..structs.structs import ALLOC_DESIRED_RUN

        # wait (bounded) for applied-index convergence first: a replica
        # a few heartbeats behind is lag, not divergence
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            applied = []
            for sp in self.procs.values():
                if not sp.alive():
                    continue
                try:
                    st = sp.call("Operator.RaftStats", no_forward=True,
                                 timeout=1.0)
                    applied.append(int(st.get("applied_index", -1)))
                except (RPCError, OSError):
                    applied.append(-1)
            if len(set(applied)) <= 1 and (not applied or applied[0] >= 0):
                break
            time.sleep(0.1)

        counts: Dict[str, Optional[int]] = {}
        for nid, sp in sorted(self.procs.items()):
            if not sp.alive():
                counts[nid] = None   # permanently dead: excluded
                continue
            try:
                allocs = sp.call("Alloc.List", no_forward=True, timeout=15.0)
            except (RPCError, OSError) as e:
                self.errors.append(f"replica count {nid}: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
                counts[nid] = None
                continue
            counts[nid] = sum(
                1 for a in allocs if a.desired_status == ALLOC_DESIRED_RUN
            )
        return counts

    def _extra_result(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "failover": dict(self.failover_info),
            "killed_servers": list(self._killed),
            "heartbeat_pump": self._pump.report() if self._pump is not None else [],
        }
        if self.harness_flight is not None:
            # last few frames: per-replica raft/broker state leading into
            # measurement (the kill + re-election are visible here)
            out["flight_tail"] = self.harness_flight.frames(recent=4)
        return out

    def _set_service_preemption(self) -> None:
        from ..structs.structs import PreemptionConfig, SchedulerConfiguration

        lp = self._leader().proc
        _, cfg = lp.call("Operator.SchedulerGetConfiguration")
        if cfg is None:
            cfg = SchedulerConfiguration()
        if cfg.preemption_config is None:
            cfg.preemption_config = PreemptionConfig()
        cfg.preemption_config.service_scheduler_enabled = True
        lp.call("Operator.SchedulerSetConfiguration", cfg)

    def _shutdown(self) -> None:
        if self.harness_flight is not None:
            self.harness_flight.disarm()
        super()._shutdown()   # stops the pump's feeder (servers list is empty)
        if self._pump is not None:
            self._pump.stop()
        for sp in self.procs.values():
            try:
                sp.terminate()
            except Exception as e:  # noqa: BLE001 — reap every process
                self.errors.append(f"shutdown {sp.node_id}: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
        if self._owns_base:
            shutil.rmtree(self.base_dir, ignore_errors=True)
