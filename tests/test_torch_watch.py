"""The port's read path: the watch hub's wakeup registry, blocking-query
semantics through the real FSM notify wiring, follower stale reads over
the wire, the dropped-notify chaos degradation and the 5K-watcher stress
with the race witness armed — ports of tests/test_watch.py, every server
on the CPU (``ServerConfig(device="cpu")``). Each server's hub is closed
by its fixture; every wait is on a condition, bounded."""
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.chaos.injector import ChaosInjector
from nomad_tpu_torch.rpc import RPCClient, RPCError, RPCServer, bind_server
from nomad_tpu_torch.server import InProcRaft, Server, ServerConfig
from nomad_tpu_torch.server.fsm import EVAL_UPDATE
from nomad_tpu_torch.structs.structs import (
    EVAL_STATUS_COMPLETE,
    QueryMeta,
    QueryOptions,
)
from nomad_tpu_torch.watch import WatchHub, WatchLimitError, blocking_read
from nomad_tpu_torch.watch.stale import StaleReader, follower_lag_ms, read_meta


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _beacon(i=0):
    ev = mock.eval()
    ev.id = f"watch-beacon-{i:04d}"
    ev.status = EVAL_STATUS_COMPLETE  # terminal: the broker ignores it
    return ev


# ---------------------------------------------------------------------------
# hub units
# ---------------------------------------------------------------------------


def test_hub_per_key_vs_per_table_wakeup():
    hub = WatchHub(coalesce_ms=0)  # synchronous drain
    try:
        h_table = hub.subscribe("evals")
        h_a = hub.subscribe("evals", key="a")
        h_b = hub.subscribe("evals", key="b")
        h_other = hub.subscribe("nodes")
        assert hub.watcher_count() == 4

        hub.notify(5, [("evals", "a")])
        assert h_table.triggered() and h_table.wake_index == 5
        assert h_a.triggered() and h_a.wake_index == 5
        assert not h_b.triggered()
        assert not h_other.triggered()
        # woken handles are one-shot: removed from the registry
        assert hub.watcher_count() == 2

        # key=None touch = bulk write: wakes the remaining row-level too
        hub.notify(6, [("evals", None)])
        assert h_b.triggered() and h_b.wake_index == 6
        assert not h_other.triggered()
        assert hub.watcher_count() == 1
    finally:
        hub.close()


def test_hub_coalesces_notify_storm():
    hub = WatchHub(coalesce_ms=40)
    try:
        handle = hub.subscribe("evals")
        seen = []
        hub.add_callback(lambda tables, index: seen.append((tables, index)))
        for i in range(1, 21):
            hub.notify(i, [("evals", f"k{i}")])
        assert handle.wait(5.0), "coalesced flush never fired"
        assert handle.wake_index == 20  # flush carries the LATEST index
        wait_for(lambda: hub.stats()["pending_tables"] == 0,
                 msg="pending drained")
        st = hub.stats()
        assert st["notifies"] == 20
        # 20 notifies inside one 40ms window flush once or twice, not 20x
        assert 1 <= st["flushes"] <= 3, st
        assert st["coalesce_ratio"] >= 20 / 3
        assert st["wakeups"] == 1  # the single parked handle woke ONCE
        assert seen and seen[-1][0] == ("evals",) and seen[-1][1] == 20
    finally:
        hub.close()


def test_hub_bounded_registry_rejects_then_recovers():
    hub = WatchHub(coalesce_ms=0, max_watchers=4)
    try:
        handles = [hub.subscribe("jobs") for _ in range(4)]
        with pytest.raises(WatchLimitError):
            hub.subscribe("jobs")
        assert hub.stats()["rejected"] == 1
        hub.unsubscribe(handles[0])
        hub.subscribe("jobs")  # slot freed
        assert hub.watcher_count() == 4
        # unsubscribe is idempotent, including for already-woken handles
        hub.notify(1, [("jobs", None)])
        for h in handles[1:]:
            hub.unsubscribe(h)
        assert hub.watcher_count() == 0
    finally:
        hub.close()


# ---------------------------------------------------------------------------
# blocking semantics (in-process, through the real FSM notify wiring)
# ---------------------------------------------------------------------------


@pytest.fixture
def quiet_server():
    s = Server(ServerConfig(num_schedulers=0, device="cpu"))
    yield s
    s.watch_hub.close()


def _read_evals(server, opts):
    return blocking_read(
        lambda: server.fsm.state, server.watch_hub,
        lambda st: {e.id for e in st.evals()}, "evals", opts,
    )


def test_blocking_read_immediate_when_index_passed(quiet_server):
    s = quiet_server
    idx, _ = s.raft_apply(EVAL_UPDATE, [_beacon(0)])
    t0 = time.monotonic()
    result, meta = _read_evals(s, QueryOptions(min_query_index=idx - 1,
                                               max_query_time=10.0))
    assert time.monotonic() - t0 < 1.0  # no park
    assert "watch-beacon-0000" in result
    assert meta.index == idx
    assert isinstance(meta, QueryMeta)


def test_blocking_read_parks_then_wakes_on_apply(quiet_server):
    s = quiet_server
    idx, _ = s.raft_apply(EVAL_UPDATE, [_beacon(0)])
    out = {}

    def park():
        out["result"], out["meta"] = _read_evals(
            s, QueryOptions(min_query_index=idx, max_query_time=30.0))

    t = threading.Thread(target=park)
    t0 = time.monotonic()
    t.start()
    wait_for(lambda: s.watch_hub.watcher_count() == 1, msg="watcher parked")
    s.raft_apply(EVAL_UPDATE, [_beacon(1)])
    t.join(timeout=10.0)
    assert not t.is_alive(), "watcher never woke"
    elapsed = time.monotonic() - t0
    assert elapsed < 10.0  # woke via notify, nowhere near max_query_time
    assert "watch-beacon-0001" in out["result"]
    assert out["meta"].index > idx


def test_blocking_read_deadline_returns_current_index(quiet_server):
    s = quiet_server
    idx, _ = s.raft_apply(EVAL_UPDATE, [_beacon(0)])
    t0 = time.monotonic()
    result, meta = _read_evals(
        s, QueryOptions(min_query_index=idx + 100, max_query_time=0.4))
    elapsed = time.monotonic() - t0
    assert 0.3 <= elapsed < 5.0  # held until deadline, then answered
    assert meta.index == idx  # CURRENT index, the client's next floor
    assert "watch-beacon-0000" in result


def test_blocking_read_full_registry_degrades_to_plain_read(quiet_server):
    s = quiet_server
    idx, _ = s.raft_apply(EVAL_UPDATE, [_beacon(0)])
    s.watch_hub.max_watchers = 0  # force WatchLimitError on subscribe
    t0 = time.monotonic()
    result, meta = _read_evals(
        s, QueryOptions(min_query_index=idx, max_query_time=30.0))
    assert time.monotonic() - t0 < 1.0  # answered now, no unbounded park
    assert meta.index == idx
    assert s.watch_hub.stats()["rejected"] == 1


# ---------------------------------------------------------------------------
# chaos: dropped watch_notify degrades to the deadline re-query
# ---------------------------------------------------------------------------


def test_dropped_notify_degrades_to_deadline_requery(quiet_server):
    """Arm watch_notify at prob=1.0: every post-apply notification is
    dropped. A parked watcher must still return by its max_query_time —
    late, but with the CURRENT index and fresh data (never wedged, never
    stale)."""
    s = quiet_server
    idx, _ = s.raft_apply(EVAL_UPDATE, [_beacon(0)])
    # drain beacon-0's coalesce window first: its pending flush would
    # otherwise deliver the wakeup the armed fault is supposed to drop
    wait_for(lambda: s.watch_hub.stats()["pending_tables"] == 0,
             msg="pre-arm flush drained")
    inj = ChaosInjector(seed=7)
    inj.arm("watch_notify", mode="fail", prob=1.0)
    try:
        out = {}

        def park():
            out["result"], out["meta"] = _read_evals(
                s, QueryOptions(min_query_index=idx, max_query_time=1.2))

        t = threading.Thread(target=park)
        t0 = time.monotonic()
        t.start()
        wait_for(lambda: s.watch_hub.watcher_count() == 1,
                 msg="watcher parked")
        s.raft_apply(EVAL_UPDATE, [_beacon(1)])  # notify dropped
        t.join(timeout=15.0)
        assert not t.is_alive(), "dropped notify wedged the watcher"
        elapsed = time.monotonic() - t0
        assert elapsed >= 1.0  # no wakeup arrived: it rode the deadline
        # ... and the deadline re-query still surfaced the new write
        assert "watch-beacon-0001" in out["result"]
        assert out["meta"].index > idx
        assert inj.fires("watch_notify") >= 1
        assert s.watch_hub.stats()["dropped_notifies"] >= 1
    finally:
        inj.disarm_all()


# ---------------------------------------------------------------------------
# over the wire: QueryMeta stamping + follower stale reads
# ---------------------------------------------------------------------------


@pytest.fixture
def wire_pair():
    """Leader + follower sharing an InProcRaft, each behind a real
    RPCServer (the test_rpc.py forwarding topology)."""
    raft = InProcRaft()
    leader = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s1")
    follower = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s2")
    rpc_l = RPCServer()
    bind_server(leader, rpc_l)
    rpc_l.is_leader = lambda: leader.is_leader
    rpc_l.start()
    rpc_f = RPCServer()
    bind_server(follower, rpc_f)
    rpc_f.is_leader = lambda: follower.is_leader
    rpc_f.leader_addr = rpc_l.addr
    rpc_f.start()
    yield leader, follower, rpc_l, rpc_f
    rpc_f.stop()
    rpc_l.stop()
    leader.watch_hub.close()
    follower.watch_hub.close()


def test_rpc_reads_stamp_query_meta_and_stay_back_compat(wire_pair):
    leader, follower, rpc_l, rpc_f = wire_pair
    c = RPCClient(*rpc_l.addr)
    try:
        idx = c.call("Eval.Update", [_beacon(0)])
        # legacy shape: no query_opts -> bare result, old callers untouched
        bare = c.call("Eval.GetEval", "watch-beacon-0000")
        assert bare.id == "watch-beacon-0000"
        # opted-in shape: [result, QueryMeta] with the index stamped
        ev, meta = c.call("Eval.GetEval", "watch-beacon-0000", QueryOptions())
        assert ev.id == "watch-beacon-0000"
        assert isinstance(meta, QueryMeta)
        assert meta.index == idx
        assert meta.known_leader
        assert meta.follower_lag_ms == 0.0  # served by the leader
    finally:
        c.close()


def test_follower_serves_stale_reads_locally(wire_pair):
    leader, follower, rpc_l, rpc_f = wire_pair
    lead_c = RPCClient(*rpc_l.addr)
    foll_c = RPCClient(*rpc_f.addr)
    try:
        idx = lead_c.call("Eval.Update", [_beacon(0)])
        # point the follower's forwarding at a dead address: any request
        # that still forwards now fails, so a success PROVES local serving
        rpc_f.leader_addr = ("127.0.0.1", 1)
        with pytest.raises(RPCError):
            foll_c.call("Eval.List", QueryOptions(), timeout=3.0)
        evs, meta = foll_c.call("Eval.List", QueryOptions(), stale=True)
        assert any(e.id == "watch-beacon-0000" for e in evs)
        assert meta.index == idx
        assert meta.known_leader  # leader_addr is set (even if dead)
        assert meta.follower_lag_ms >= 0.0
        assert follower_lag_ms(leader) == 0.0
        assert read_meta(leader).known_leader
    finally:
        rpc_f.leader_addr = rpc_l.addr
        foll_c.close()
        lead_c.close()


def test_follower_stale_watch_wakes_on_replication(wire_pair):
    """min_query_index on a stale read parks on the FOLLOWER's hub and
    wakes when the follower's own FSM applies the write — the
    stale-but-index-consistent contract."""
    leader, follower, rpc_l, rpc_f = wire_pair
    lead_c = RPCClient(*rpc_l.addr)
    try:
        idx = lead_c.call("Eval.Update", [_beacon(0)])
        out = {}

        def park():
            c = RPCClient(*rpc_f.addr)
            try:
                reader = StaleReader(c)
                reader.last_index = idx
                out["result"], out["meta"] = reader.watch(
                    "Eval.List", max_query_time=30.0)
                out["chained"] = reader.last_index
            finally:
                c.close()

        t = threading.Thread(target=park)
        t0 = time.monotonic()
        t.start()
        wait_for(lambda: follower.watch_hub.watcher_count() == 1,
                 msg="watcher parked on the follower's hub")
        lead_c.call("Eval.Update", [_beacon(1)])
        t.join(timeout=15.0)
        assert not t.is_alive(), "follower watcher never woke"
        assert time.monotonic() - t0 < 15.0
        assert any(e.id == "watch-beacon-0001" for e in out["result"])
        assert out["meta"].index > idx
        assert out["chained"] == out["meta"].index
    finally:
        lead_c.close()


# ---------------------------------------------------------------------------
# 5K-watcher stress: zero lost wakeups, race-witness armed
# ---------------------------------------------------------------------------


def test_5k_watchers_zero_lost_wakeups_race_armed():
    """Park 5000 blocking readers on one hub, land ONE write, and require
    every single reader to wake with the new index well before its
    deadline — a lost wakeup shows up as a deadline-length straggler.
    The Eraser race witness is armed for the whole run (the hub's
    registry dict is minted through tracked_dict AFTER arming), so the
    wakeup storm is also a data-race proof over the hub's shared state."""
    from nomad_tpu_torch.utils import race_witness

    witness = race_witness.arm()
    old_stack = threading.stack_size(256 * 1024)  # 5K threads, small stacks
    try:
        server = Server(ServerConfig(num_schedulers=0, device="cpu"))
        try:
            idx, _ = server.raft_apply(EVAL_UPDATE, [_beacon(0)])
            n = 5000
            results = [None] * n
            deadline_s = 120.0

            def park(slot):
                results[slot] = _read_evals(
                    server, QueryOptions(min_query_index=idx,
                                         max_query_time=deadline_s))

            threads = [threading.Thread(target=park, args=(i,), daemon=True)
                       for i in range(n)]
            for t in threads:
                t.start()
            wait_for(lambda: server.watch_hub.watcher_count() == n,
                     timeout=90.0, msg=f"{n} watchers parked")

            t_commit = time.monotonic()
            new_idx, _ = server.raft_apply(EVAL_UPDATE, [_beacon(1)])
            for t in threads:
                t.join(timeout=60.0)
            wake_s = time.monotonic() - t_commit
            stragglers = [t for t in threads if t.is_alive()]
            assert not stragglers, f"{len(stragglers)} watchers lost wakeup"
            # every reader saw the post-commit index — none rode the
            # deadline, none returned the stale pre-commit view
            assert wake_s < deadline_s / 2, wake_s
            for i, out in enumerate(results):
                assert out is not None, f"watcher {i} returned nothing"
                result, meta = out
                assert meta.index >= new_idx, (i, meta.index, new_idx)
                assert "watch-beacon-0001" in result, i
            st = server.watch_hub.stats()
            assert st["watchers"] == 0  # registry fully drained
            assert st["wakeups"] >= n
        finally:
            server.watch_hub.close()

        rw = witness.stats()
        assert rw["violations"] == 0, witness.field_report()
        assert rw["accesses"] > 0
    finally:
        threading.stack_size(old_stack)
        race_witness.disarm()
