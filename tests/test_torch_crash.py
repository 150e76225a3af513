"""Crash-recovery tests: durable snapshot/restore under load, restart
semantics, leadership-loss nacks, and the real-process SIGKILL E2E.

Three layers, matching the harness's trust chain:

1. raft-level — snapshots taken while apply traffic is live must never
   lose or duplicate entries (both raft impls), and a SIGKILLed server's
   durable meta must prevent double-voting and replay its log tail;
2. engine-level — the async applier nacks (never redispatches) a wave
   whose plan apply lost leadership, and the SLO gate bounds the
   failover MTTR gauges;
3. end-to-end — ``CrashReplay`` SIGKILLs a real leader process mid-wave
   and the surviving cluster elects, recovers, rejoins via
   InstallSnapshot, and passes the invariant sweep (``@pytest.mark.slow``:
   spawns real server processes).

Ports of tests/test_crash_recovery.py onto the PyTorch port, every server
on the CPU (``device="cpu"``, ``--device cpu`` for the real processes).
Beside them: the failover ledger against the JAX package's, the crash
harness's port choice, and, unmarked, a small real-process SIGKILL
replay and a small real-process serving replay.
"""
import shutil
import tempfile
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc.transport import RPCServer
from nomad_tpu_torch.server.fsm import NODE_REGISTER, NomadFSM
from nomad_tpu_torch.server.raft import InProcRaft
from nomad_tpu_torch.server.wire_raft import LEADER, WireRaft, WireRaftConfig


def _cpu_config():
    """ChurnReplay's default server config, on the CPU."""
    from nomad_tpu_torch.server import ServerConfig

    return ServerConfig(heartbeat_min_ttl=1.5, heartbeat_max_ttl=2.5, heartbeat_grace=0.0,
                        eval_gc_interval=3600.0, device="cpu")


def fast_config(node_id: str) -> WireRaftConfig:
    return WireRaftConfig(
        node_id=node_id,
        election_timeout_min=0.15,
        election_timeout_max=0.3,
        heartbeat_interval=0.03,
        rpc_timeout=0.5,
        apply_timeout=5.0,
    )


def wait_until(fn, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class WireNode:
    """One wire-raft participant with its own RPC endpoint and FSM."""

    def __init__(self, node_id: str, data_dir=None):
        self.node_id = node_id
        self.rpc = RPCServer()
        self.fsm = NomadFSM()
        self.data_dir = data_dir
        self.raft = None

    def wire(self, all_nodes, start=True):
        peers = {
            n.node_id: n.rpc.addr for n in all_nodes if n.node_id != self.node_id
        }
        self.raft = WireRaft(
            self.rpc, peers, fast_config(self.node_id), data_dir=self.data_dir
        )
        self.raft.join(self.fsm)
        self.rpc.start()
        if start:
            self.raft.start()
        return self

    def stop(self):
        if self.raft is not None:
            self.raft.close()
        self.rpc.stop()


# ---------------------------------------------------------------------------
# 1a. snapshot under concurrent apply — InProcRaft
# ---------------------------------------------------------------------------


def test_inproc_snapshot_under_concurrent_apply():
    """Hammer apply() from a thread while snapshot() runs in a loop: every
    snapshot must capture a consistent (state, index) pair, the log
    compaction must never eat an entry the snapshot doesn't contain, and
    a fresh join from disk must see every applied entry."""
    tmp = tempfile.mkdtemp(prefix="inproc-snap-")
    n_entries = 150
    try:
        raft = InProcRaft(data_dir=tmp)
        fsm = NomadFSM()
        peer = raft.join(fsm)
        registered = [mock.node() for _ in range(n_entries)]
        errors = []

        def apply_loop():
            try:
                for n in registered:
                    raft.apply(peer, NODE_REGISTER, n)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=apply_loop, daemon=True)
        t.start()
        indexes = []
        while t.is_alive():
            indexes.append(raft.snapshot(peer))
            time.sleep(0.002)
        t.join(timeout=10.0)
        final = raft.snapshot(peer)
        raft.close()

        assert not errors, errors
        assert indexes == sorted(indexes), "snapshot index went backwards"
        assert final == n_entries

        # a rebooted process restores snapshot + tail and sees everything
        raft2 = InProcRaft(data_dir=tmp)
        fsm2 = NomadFSM()
        raft2.join(fsm2)
        for n in registered:
            assert fsm2.state.node_by_id(n.id) is not None, "entry lost"
        assert raft2.last_index == n_entries
        raft2.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_inproc_snapshot_stats_surface():
    raft = InProcRaft()
    peer = raft.join(NomadFSM())
    st = raft.stats(peer)
    assert st["state"] == "leader"
    assert st["snapshot_index"] == 0
    assert st["snapshots_installed"] == 0


# ---------------------------------------------------------------------------
# 1b. snapshot under concurrent apply — WireRaft
# ---------------------------------------------------------------------------


def test_wire_raft_snapshot_under_concurrent_apply():
    tmp = tempfile.mkdtemp(prefix="wire-snap-")
    n_entries = 120
    try:
        node = WireNode("solo", data_dir=tmp).wire([])
        try:
            wait_until(lambda: node.raft.state == LEADER, msg="solo leader")
            registered = [mock.node() for _ in range(n_entries)]
            errors = []

            def apply_loop():
                try:
                    for n in registered:
                        node.raft.apply(0, NODE_REGISTER, n)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            t = threading.Thread(target=apply_loop, daemon=True)
            t.start()
            indexes = []
            while t.is_alive():
                indexes.append(node.raft.snapshot(0))
                time.sleep(0.002)
            t.join(timeout=15.0)
            assert not errors, errors
            assert indexes == sorted(indexes), "snapshot index went backwards"
            wait_until(lambda: node.raft.last_applied >= node.raft.commit_index,
                       msg="applied caught up")
            final = node.raft.snapshot(0)
            assert final >= max(indexes or [0])
        finally:
            node.stop()

        # restart from disk: snapshot restore + durable tail replay must
        # reconstruct every entry
        node2 = WireNode("solo", data_dir=tmp).wire([])
        try:
            wait_until(lambda: node2.raft.state == LEADER, msg="solo re-leader")
            for n in registered:
                assert node2.fsm.state.node_by_id(n.id) is not None, "entry lost"
        finally:
            node2.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 1c. durable restart semantics: vote + log tail
# ---------------------------------------------------------------------------


def test_wire_raft_restart_preserves_vote():
    """raft_meta.json survives a crash: a restarted server that granted
    its vote at term T must refuse a DIFFERENT candidate at T — the
    double-vote that durable (term, voted_for) exists to prevent
    (hashicorp/raft persistent state; raft thesis §3.6)."""
    tmp = tempfile.mkdtemp(prefix="wire-vote-")
    try:
        # start=False: no election timer — the node is a pure voter
        node = WireNode("voter", data_dir=tmp)
        node.wire([node], start=False)
        try:
            term, granted = node.raft._handle_request_vote(5, "candA", 10, 5)
            assert granted and term == 5
        finally:
            node.stop()

        node2 = WireNode("voter", data_dir=tmp)
        node2.wire([node2], start=False)
        try:
            assert node2.raft.current_term == 5, "term not persisted"
            assert node2.raft.voted_for == "candA", "vote not persisted"
            # same term, different candidate: must be refused
            term, granted = node2.raft._handle_request_vote(5, "candB", 10, 5)
            assert not granted, "double vote after restart"
            # same candidate retrying is fine (idempotent grant)
            term, granted = node2.raft._handle_request_vote(5, "candA", 10, 5)
            assert granted
        finally:
            node2.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_wire_raft_restart_replays_log_tail_to_same_index():
    tmp = tempfile.mkdtemp(prefix="wire-tail-")
    try:
        node = WireNode("solo", data_dir=tmp).wire([])
        try:
            wait_until(lambda: node.raft.state == LEADER, msg="solo leader")
            registered = [mock.node() for _ in range(7)]
            for n in registered:
                node.raft.apply(0, NODE_REGISTER, n)
            last = node.raft._last_index()
            applied = node.raft.last_applied
            assert applied == last
        finally:
            node.stop()

        node2 = WireNode("solo", data_dir=tmp).wire([])
        try:
            # re-election appends its own no-op entry, so the log may
            # GROW past `last` — but nothing before it may be lost
            wait_until(lambda: node2.raft.state == LEADER, msg="solo re-leader")
            assert node2.raft._last_index() >= last, "log tail lost"
            wait_until(lambda: node2.raft.last_applied >= last,
                       msg="tail replayed")
            for n in registered:
                assert node2.fsm.state.node_by_id(n.id) is not None, \
                    "durable entry missing after replay"
        finally:
            node2.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 2a. applier nacks on leadership loss
# ---------------------------------------------------------------------------


class _RecordingBroker:
    def __init__(self):
        self.acks = []
        self.nacks = []

    def ack(self, eval_id, token):
        self.acks.append((eval_id, token))

    def nack(self, eval_id, token):
        self.nacks.append((eval_id, token))


class _FailedFuture:
    def __init__(self, exc):
        self._exc = exc

    def result(self, timeout=None):
        raise self._exc


def test_applier_nacks_wave_on_leadership_loss():
    """NotLeaderError from the plan apply means this node can commit
    nothing: the wave must be nacked back (for the new leader's eval
    restore to redeliver), never redispatched on the dead pipeline."""
    from types import SimpleNamespace

    from nomad_tpu_torch.pipeline import AsyncApplier
    from nomad_tpu_torch.pipeline.applier import _Wave
    from nomad_tpu_torch.server.raft import NotLeaderError
    from nomad_tpu_torch.structs.structs import Plan

    broker = _RecordingBroker()
    applier = AsyncApplier(server=SimpleNamespace(eval_broker=broker))
    applier._enabled = True
    rec = _Wave(Plan(eval_id="e-lost", async_ok=True), "tok",
                time.monotonic() + 30.0)
    applier._waves[rec.plan.eval_id] = rec
    applier._slots.acquire(blocking=False)

    applier._handle(rec, _FailedFuture(NotLeaderError("leadership lost")))

    assert broker.nacks == [("e-lost", "tok")]
    assert broker.acks == []
    assert rec.done
    assert applier._waves == {}
    # the slot was released exactly once: all inflight_max are available
    assert applier.stats()["slots_free"] == applier.inflight_max


# ---------------------------------------------------------------------------
# 2b. SLO gate failover thresholds
# ---------------------------------------------------------------------------


def test_slo_gate_failover_thresholds():
    from nomad_tpu_torch.chaos import SLOGate, SLOThresholds

    gate = SLOGate(SLOThresholds(
        eval_ms_p99_max=None, slowest_inflight_ms_max=None,
        throughput_min_allocs_per_s=None,
        failover_new_leader_ms_max=5000.0,
        failover_first_commit_ms_max=10000.0,
        require_rejoin=True,
    ))
    base = {
        "trace_summary": {},
        "invariants": {"lost": 0, "duplicated": 0, "converged": True},
    }

    good = dict(base, failover={
        "time_to_new_leader_ms": 900.0, "time_to_first_commit_ms": 950.0,
        "rejoined": True,
    })
    verdict = gate.evaluate(good)
    assert verdict["passed"], verdict["checks"]
    names = {c["name"] for c in verdict["checks"]}
    assert {"failover_time_to_new_leader_ms",
            "failover_time_to_first_commit_ms",
            "killed_server_rejoined"} <= names

    # slow election fails the bound
    slow = dict(base, failover={
        "time_to_new_leader_ms": 9000.0, "time_to_first_commit_ms": 9500.0,
        "rejoined": True,
    })
    assert not gate.evaluate(slow)["passed"]

    # a missing measurement is a failure, not a skip: headless-time
    # that was never measured must not read as "fast"
    unmeasured = dict(base, failover={"rejoined": True})
    assert not gate.evaluate(unmeasured)["passed"]

    # no rejoin fails require_rejoin
    norejoin = dict(base, failover={
        "time_to_new_leader_ms": 900.0, "time_to_first_commit_ms": 950.0,
    })
    assert not gate.evaluate(norejoin)["passed"]


# ---------------------------------------------------------------------------
# 2c. crash-trace validation
# ---------------------------------------------------------------------------


def test_crash_replay_rejects_fault_window_traces():
    from nomad_tpu_torch.chaos import CrashReplay, generate_trace

    tr = generate_trace(1, n_fault_windows=2)
    with pytest.raises(ValueError, match="fault injector is per-process"):
        CrashReplay(seed=1, trace=tr, device="cpu")


def test_crash_replay_rejects_canaried_rollouts():
    from nomad_tpu_torch.chaos import CrashReplay, generate_trace

    tr = generate_trace(1, n_fault_windows=0, canary_frac=1.0)
    with pytest.raises(ValueError, match="deployment nurse"):
        CrashReplay(seed=1, trace=tr, device="cpu")


# ---------------------------------------------------------------------------
# 3a. in-proc replay: canaried rollout + preemption-pressure events
# ---------------------------------------------------------------------------


def test_churn_replay_canaried_rollout_promotes_and_converges():
    from nomad_tpu_torch.chaos import ChurnReplay
    from nomad_tpu_torch.chaos.trace import ChaosEvent

    trace = [
        ChaosEvent(0.1, "register_job",
                   {"job_id": "canary-app", "count": 6, "cpu": 150,
                    "memory_mb": 64, "priority": 50}),
        ChaosEvent(1.5, "rollout",
                   {"job_id": "canary-app", "cpu": 200, "canary": 2}),
    ]
    rep = ChurnReplay(seed=3, trace=trace, n_servers=2, n_nodes=10,
                      settle_timeout_s=60.0, config=_cpu_config())
    res = rep.run()
    assert res["invariants"]["converged"], res["invariants"]["violations"]
    # the rollout really was a canaried deployment, and the nurse
    # promoted it (staged canaries -> healthy -> promote -> full roll)
    deps = rep.servers[0].fsm.state.deployments()
    assert any(
        tg.desired_canaries > 0 and tg.promoted
        for d in deps for tg in d.task_groups.values()
    ), [d.status for d in deps]


def test_churn_replay_preempt_pressure_wave_converges():
    from nomad_tpu_torch.chaos import ChurnReplay
    from nomad_tpu_torch.chaos.trace import ChaosEvent

    trace = [
        ChaosEvent(0.1, "register_job",
                   {"job_id": "steady", "count": 4, "cpu": 150,
                    "memory_mb": 64, "priority": 50}),
        ChaosEvent(1.0, "preempt_pressure",
                   {"wave": 0, "filler_count": 8, "filler_cpu": 600,
                    "memory_mb": 64}),
        ChaosEvent(2.0, "hipri_job",
                   {"job_id": "preempt-hi-0", "count": 2, "cpu": 400,
                    "memory_mb": 64, "priority": 90}),
        ChaosEvent(4.0, "preempt_release", {"wave": 0}),
    ]
    rep = ChurnReplay(seed=4, trace=trace, n_servers=2, n_nodes=8,
                      settle_timeout_s=60.0, config=_cpu_config())
    res = rep.run()
    assert res["invariants"]["converged"], res["invariants"]["violations"]
    # the wave flipped service-scheduler preemption on, through raft
    cfg = rep.servers[0].fsm.state.scheduler_config()[1]
    assert cfg is not None and cfg.preemption_config.service_scheduler_enabled
    # the priority-90 burst placed (into a cluster the fillers saturated)
    run_allocs = [
        a for a in rep.servers[0].fsm.state.allocs_by_job(
            "default", "preempt-hi-0", True)
        if a.desired_status == "run"
    ]
    assert len(run_allocs) == 2


# ---------------------------------------------------------------------------
# 3b. the real thing: SIGKILL a real leader process mid-wave
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_real_process_sigkill_failover_and_snapshot_rejoin():
    """Spawn a real 3-process wire-raft cluster, SIGKILL -9 the leader
    mid-trace, and require the full recovery story: a new leader at a
    higher term, a first post-failover commit, the killed server
    restarted from its data_dir and caught up via InstallSnapshot (the
    new leader snapshots while it is down, compacting the log past its
    durable tail), and an invariant-clean, replica-identical cluster."""
    from nomad_tpu_torch.chaos import CrashReplay, generate_trace

    tr = generate_trace(5, n_jobs=5, n_nodes=15, duration_s=10.0,
                        n_fault_windows=0, n_drains=1, n_expiries=1,
                        leader_kill=True)
    rep = CrashReplay(seed=5, trace=tr, n_servers=3, n_nodes=15,
                      settle_timeout_s=90.0, device="cpu")
    res = rep.run()

    assert res["leader_kills"] == 1
    assert len(res["killed_servers"]) == 1
    fo = res["failover"]
    assert fo["time_to_new_leader_ms"] is not None
    assert fo["time_to_first_commit_ms"] is not None
    assert fo["rejoined"], res["errors"]
    assert fo["snapshot_installs"] >= 1, \
        "rejoin rode AppendEntries — compacted-log path not exercised"
    inv = res["invariants"]
    assert inv["lost"] == 0 and inv["duplicated"] == 0 and inv["orphaned"] == 0
    assert inv["converged"], inv["violations"]
    counts = {k: v for k, v in res["replica_run_counts"].items()
              if v is not None}
    assert len(counts) == 3, "killed server did not come back readable"
    assert len(set(counts.values())) == 1, counts


# ---------------------------------------------------------------------------
# 4. beside the reference: the ledger, the port choice, small real runs
# ---------------------------------------------------------------------------


def test_failover_ledger_equals_reference():
    from nomad_tpu.trace import failover as jfailover
    from nomad_tpu_torch.trace import failover as tfailover

    for mod in (tfailover, jfailover):
        mod.reset()
    try:
        steps = [("record", dict(killed="s1", new_leader="s0", old_term=3,
                                 time_to_new_leader_ms=412.5, time_to_first_commit_ms=None)),
                 ("note", dict(snapshot_index=59, snapshot_installs=1, rejoined=True,
                               restart_catchup_ms=2524.2)),
                 ("record", dict(killed="s0", time_to_new_leader_ms=90.0))]
        for _ in range(70):  # past the ring's 64 episodes
            steps.append(("record", dict(killed="x", time_to_new_leader_ms=1.0)))
        for name, kw in steps:
            assert getattr(tfailover, name)(**kw) == getattr(jfailover, name)(**kw)
        assert tfailover.episodes() == jfailover.episodes()
        assert tfailover.summary() == jfailover.summary()
        assert tfailover.latest() == jfailover.latest()
    finally:
        for mod in (tfailover, jfailover):
            mod.reset()


def test_free_port_is_below_the_ephemeral_range():
    """The harness hands each child a port no ``bind(0)`` of another
    process can take in the meantime."""
    import socket

    from nomad_tpu_torch.chaos import crash

    low = crash._ephemeral_low()
    ports = {crash._free_port() for _ in range(20)}
    assert all(crash._PORT_FLOOR <= p < low for p in ports), (ports, low)
    for p in ports:
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p))
        finally:
            s.close()


def test_crash_server_without_its_native_log_exits_nonzero(tmp_path):
    """No fallback: a server process that cannot build its durable log's
    library (no compiler, a fresh build dir) exits non-zero before it
    serves, printing no READY line."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    from nomad_tpu_torch.chaos.crash import _free_port

    repo = str(Path(__file__).resolve().parent.parent)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {repo!r})
        from nomad_tpu_torch import native
        native.BUILD_DIR = {str(tmp_path / "build")!r}
        from nomad_tpu_torch.chaos import crash_server
        sys.exit(crash_server.main(["--node-id", "s0", "--rpc-port", "{_free_port()}",
                                    "--data-dir", {str(tmp_path / "s0")!r},
                                    "--device", "cpu"]))
    """)
    env = dict(os.environ, CXX="false")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert "NativeBuildError" in out.stderr, out.stderr[-2000:]
    assert "READY" not in out.stdout


def _assert_recovered(res, n_servers=3):
    assert res["leader_kills"] == 1
    assert len(res["killed_servers"]) == 1
    fo = res["failover"]
    assert fo["time_to_new_leader_ms"] is not None
    assert fo["time_to_first_commit_ms"] is not None
    assert fo["rejoined"], res["errors"]
    assert fo["snapshot_installs"] >= 1, \
        "rejoin rode AppendEntries — compacted-log path not exercised"
    inv = res["invariants"]
    assert inv["lost"] == 0 and inv["duplicated"] == 0 and inv["orphaned"] == 0
    assert inv["converged"], inv["violations"]
    counts = {k: v for k, v in res["replica_run_counts"].items() if v is not None}
    assert len(counts) == n_servers, "killed server did not come back readable"
    assert len(set(counts.values())) == 1, counts


def test_small_real_process_sigkill_replay_on_the_cpu():
    """The slow case's story at a third of its size, unmarked: three real
    ``crash_server --device cpu`` processes, the leader SIGKILLed
    mid-trace, a new leader, a first commit, the killed process back from
    its data dir through InstallSnapshot, every replica equal."""
    from nomad_tpu_torch.chaos import CrashReplay, generate_trace

    tr = generate_trace(5, n_jobs=3, n_nodes=8, duration_s=5.0, tg_count=4,
                        n_fault_windows=0, n_drains=1, n_expiries=1, leader_kill=True)
    rep = CrashReplay(seed=5, trace=tr, n_servers=3, n_nodes=8,
                      settle_timeout_s=90.0, device="cpu")
    res = rep.run()
    _assert_recovered(res)
    assert not any(sp.alive() for sp in rep.procs.values())


def test_small_real_process_serve_replay_on_the_cpu():
    """serve-100Kwatch's harness at a small size: watchers parked in
    blocking ``Eval.GetEval`` reads on three real processes, two thirds
    of them stale reads on followers; every wakeup arrives, none is lost,
    the followers serve most reads, and the army drains."""
    from nomad_tpu_torch.chaos import generate_trace
    from nomad_tpu_torch.watch.serve import ServeReplay

    tr = generate_trace(seed=0, duration_s=5.0, n_nodes=10, n_jobs=3, tg_count=4,
                        stop_frac=0.2, rollout_frac=0.15, n_drains=1, n_expiries=1,
                        n_hipri=1, n_fault_windows=0, leader_kill=False)
    rep = ServeReplay(seed=0, trace=tr, n_servers=3, n_nodes=10, settle_timeout_s=90.0,
                      n_watchers=60, n_beacons=12, watch_query_time=5.0, device="cpu")
    res = rep.run()
    serve = res["serve"]
    assert not res["errors"], res["errors"]
    assert serve["peak_concurrent_watchers"] >= 60
    assert serve["lost_wakeups"] == 0 and serve["stragglers"] == 0
    assert serve["wakeups"] > 0 and serve["watcher_errors"] == 0
    assert serve["follower_read_share"] >= 0.5
    inv = res["invariants"]
    assert inv["lost"] == 0 and inv["duplicated"] == 0 and inv["converged"], inv


def _leadership_seen_before_old_entries_apply(raft_mod, fsm_cls, rpc_cls, mock_mod):
    """A raft node holding an entry of term 1 it has not applied wins
    term 2 and cannot commit its barrier (its one peer is unreachable).
    Returns what its leadership observer saw: whether it was told, and
    whether the entry was in its FSM when it was."""
    import threading

    rpc = rpc_cls()
    rpc.start()
    raft = raft_mod.WireRaft(rpc, {"peer": ("127.0.0.1", 1)},
                             raft_mod.WireRaftConfig(node_id="n0", rpc_timeout=0.2))
    fsm = fsm_cls()
    raft.join(fsm)
    node = mock_mod.node()
    seen, told = [], threading.Event()

    def observer(peer, gained):
        if gained:
            seen.append(fsm.state.node_by_id(node.id) is not None)
            told.set()

    raft.leadership_observers.append(observer)
    raft._handle_append_entries(1, "old-leader", 0, 0, [[1, 1, NODE_REGISTER, node]], 0)
    with raft._lock:
        raft._become_leader_locked(2)
    told_before_commit = told.wait(0.5)
    # the peer leaves: the barrier commits alone, entry 1 with it
    raft.remove_peer("peer")
    with raft._lock:
        raft._advance_commit_locked()
    told.wait(5.0)
    raft.close()
    rpc.stop()
    return told_before_commit, seen


def test_new_leader_tells_observers_after_its_barrier_applies():
    """The port's new leader tells its server only once every entry of
    the old term is in its FSM (Nomad's raft barrier before
    establishLeadership); the reference's tells it at once, before the
    old leader's entry is applied: the state a server restores its evals
    from, and the crash harness's doubled slots."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.rpc.transport import RPCServer as JaxRPCServer
    from nomad_tpu.server import wire_raft as jwire
    from nomad_tpu.server.fsm import NomadFSM as JaxFSM
    from nomad_tpu_torch.server import wire_raft as twire

    early, seen = _leadership_seen_before_old_entries_apply(twire, NomadFSM, RPCServer, mock)
    assert not early and seen == [True]
    early, seen = _leadership_seen_before_old_entries_apply(jwire, JaxFSM, JaxRPCServer, jmock)
    assert early and seen == [False]


def _pump(tmp_path, nodes, followers, leader):
    from nomad_tpu_torch.chaos.pump import HeartbeatPump

    pump = HeartbeatPump(0.2, 1.0, str(tmp_path / "pump.log"))
    pump.start()
    pump.update(nodes, set(), followers, leader)
    return pump


def test_heartbeat_pump_never_waits_behind_a_bulk_read(tmp_path):
    """The crash harness's heartbeats come from a process of their own:
    they keep arriving while the harness's connection to the server is
    held by a slow read (on the reference's one connection, and under its
    GIL, a heartbeat waited the read out)."""
    import threading

    from nomad_tpu_torch.chaos.crash import ServerProcess

    beats = []
    rpc = RPCServer()
    rpc.register("Alloc.List", lambda: (time.sleep(3.0), [])[1])
    rpc.register("Node.Heartbeat", lambda node_id: (beats.append(time.monotonic()), 5.0)[1])
    rpc.start()
    sp = ServerProcess("s0", rpc.addr[1], {}, str(tmp_path))
    pump = _pump(tmp_path, ["n1", "n2"], [], ("127.0.0.1", rpc.addr[1]))
    try:
        wait_until(lambda: len(beats) >= 2, timeout=30, msg="the pump process beating")
        bulk = threading.Thread(target=sp.call, args=("Alloc.List",))
        t0 = time.monotonic()
        bulk.start()
        bulk.join(timeout=10)
        during = [t for t in beats if t0 < t < t0 + 2.5]
        assert len(during) >= 4, during
    finally:
        pump.stop()
        sp._drop_client()
        rpc.stop()
    assert pump.proc.returncode == 0


def test_follower_refuses_a_heartbeat_it_cannot_record():
    """Only the leader keeps TTLs: the port's follower raises
    NotLeaderError for a heartbeat (Nomad's forward() fails without a
    leader); the reference's answers with a TTL and records nothing."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.server import InProcRaft as JaxInProcRaft
    from nomad_tpu.server import Server as JaxServer
    from nomad_tpu.server import ServerConfig as JaxServerConfig
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.raft import NotLeaderError

    raft = InProcRaft()
    leader = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s1")
    follower = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s2")
    node = mock.node()
    leader.register_node(node)
    try:
        assert leader.heartbeat(node.id) > 0
        with pytest.raises(NotLeaderError):
            follower.heartbeat(node.id)
    finally:
        leader.stop()
        follower.stop()
    jraft = JaxInProcRaft()
    jleader = JaxServer(JaxServerConfig(num_schedulers=0), raft=jraft, name="j1")
    jfollower = JaxServer(JaxServerConfig(num_schedulers=0), raft=jraft, name="j2")
    jnode = jmock.node()
    jleader.register_node(jnode)
    try:
        assert jfollower.heartbeat(jnode.id) > 0  # answered, and lost
    finally:
        jleader.stop()
        jfollower.stop()


def test_heartbeat_pump_fails_over_within_a_pass(tmp_path):
    """A pass that meets a server knowing no leader moves the rest of its
    heartbeats to the next server: every node is heard in the first
    pass, and the leaderless server is tried once a pass by each of the
    pump's workers."""
    from nomad_tpu_torch.server.raft import NotLeaderError

    seen = {"a": [], "b": []}

    def leaderless(node_id):
        seen["a"].append(node_id)
        raise NotLeaderError("no leader known")

    def leader(node_id):
        seen["b"].append(node_id)
        return 5.0

    rpcs = []
    for fn in (leaderless, leader):
        rpc = RPCServer()
        rpc.register("Node.Heartbeat", fn)
        rpc.start()
        rpcs.append(rpc)
    nodes = [f"n{i}" for i in range(6)]
    pump = _pump(tmp_path, nodes, [("127.0.0.1", rpcs[0].addr[1])],
                 ("127.0.0.1", rpcs[1].addr[1]))
    try:
        wait_until(lambda: set(seen["b"]) == set(nodes), timeout=30, msg="every node heard")
        # each of the pump's 4 workers tries the leaderless server once a
        # pass, then moves its share of the nodes to the next server
        assert sorted(seen["b"][:6]) == nodes and len(seen["a"]) <= 8
    finally:
        pump.stop()
        for rpc in rpcs:
            rpc.stop()


def test_broker_runs_the_newest_blocked_eval_and_cancels_the_rest():
    """Three evals of one job wait behind the one in flight: on its ack
    the port's broker (as Nomad's since 1.4.3) hands out the newest and
    sets the two older aside as cancelable; the reference's hands out
    every one in turn. The leader's tick marks them canceled in the FSM."""
    from nomad_tpu.server.eval_broker import EvalBroker as JaxBroker
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.eval_broker import EvalBroker
    from nomad_tpu_torch.structs.structs import EVAL_STATUS_CANCELLED, Evaluation

    def evals(cls):
        out = []
        for i in range(4):
            out.append(cls(id=f"e{i}", namespace="default", job_id="web", type="service",
                           priority=50, triggered_by="node-update", status="pending",
                           create_index=10 + i, modify_index=10 + i))
        return out

    from nomad_tpu.structs.structs import Evaluation as JaxEvaluation

    for broker, made, newest_only in ((EvalBroker(), evals(Evaluation), True),
                                      (JaxBroker(), evals(JaxEvaluation), False)):
        broker.set_enabled(True)
        for ev in made:
            broker.enqueue(ev)
        got, order = [], []
        while True:
            ev, token = broker.dequeue(["service"], timeout=0.2)
            if ev is None:
                break
            order.append(ev.id)
            broker.ack(ev.id, token)
        if newest_only:
            assert order == ["e0", "e3"]
            assert sorted(e.id for e in broker.take_cancelable()) == ["e1", "e2"]
        else:
            assert order == ["e0", "e1", "e2", "e3"]
        broker.set_enabled(False)

    srv = Server(ServerConfig(num_schedulers=0, device="cpu"))
    try:
        srv.start()
        made = evals(Evaluation)
        srv.raft_apply("eval-update", made)
        ev, token = srv.eval_broker.dequeue(["service"], timeout=1.0)
        srv.eval_broker.ack(ev.id, token)
        srv._reap_cancelable_evals()
        status = {e.id: e.status for e in srv.fsm.state.evals()}
        assert status["e1"] == status["e2"] == EVAL_STATUS_CANCELLED
        assert status["e3"] == "pending"
    finally:
        srv.stop()


def test_node_goes_down_a_grace_past_its_ttl():
    """Nomad's heartbeat_grace: a silent node is marked down its grace
    after its TTL, not at it (the reference, with none, marks it down at
    the TTL; tests/test_torch_chaos.py holds that timing at grace 0)."""
    from nomad_tpu_torch.server import Server, ServerConfig

    srv = Server(ServerConfig(device="cpu", num_schedulers=0, heartbeat_min_ttl=0.3,
                              heartbeat_max_ttl=0.4, heartbeat_grace=1.0,
                              eval_gc_interval=3600.0))
    try:
        srv.start()
        node = mock.node()
        ttl = srv.register_node(node)
        assert 0.3 <= ttl <= 0.4
        time.sleep(ttl + 0.5)   # past the TTL, inside the grace
        assert srv.fsm.state.node_by_id(node.id).status == "ready"
        wait_until(lambda: srv.fsm.state.node_by_id(node.id).status == "down", timeout=5.0,
                   msg="down after the grace")
        assert ServerConfig().heartbeat_grace == 10.0
    finally:
        srv.stop()


def test_boot_write_retries_past_a_leader_change(monkeypatch):
    """A boot-time write (the fleet's registration, the warmup jobs) that
    meets a leader which stepped down after the harness resolved it (a
    NotLeaderError in process, the same as an RPCError over the wire)
    re-resolves the leader and goes on; with no leader coming back it
    gives up after ``_BOOT_WRITE_S``. The serve test failed on a loaded
    host with "crash-s2 is not the leader (leader=crash-s2)" at boot."""
    from nomad_tpu_torch.chaos import replay
    from nomad_tpu_torch.rpc.transport import RPCError
    from nomad_tpu_torch.server.raft import NotLeaderError

    calls = []

    class StepsDown:
        def __init__(self, name, error):
            self.name, self.error = name, error

        def register_node(self, n):
            calls.append((self.name, n))
            raise self.error

    class Leader:
        def register_node(self, n):
            calls.append(("new", n))

    new = Leader()

    class Harness:
        def __init__(self, leaders):
            self.leaders = list(leaders)

        def _leader(self):
            return self.leaders.pop(0)

    for error in (NotLeaderError("crash-s2 is not the leader (leader=crash-s2)"),
                  RPCError("NotLeaderError: crash-s2 is not the leader (leader=crash-s2)")):
        calls.clear()
        got = replay.ChurnReplay._boot_write(
            Harness([StepsDown("candidate", error), new]), StepsDown("old", error),
            lambda ldr: ldr.register_node("n1"))
        assert got is new
        assert calls == [("old", "n1"), ("candidate", "n1"), ("new", "n1")]

    class Leaderless:
        def _leader(self):
            raise RuntimeError("no leader within timeout")

    monkeypatch.setattr(replay, "_BOOT_WRITE_S", 0.3)
    with pytest.raises(RuntimeError, match="no leader"):
        replay.ChurnReplay._boot_write(Leaderless(), None, lambda ldr: ldr.register_node("n1"))
