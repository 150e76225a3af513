"""The port's cross-process tracing on the wire: the log-bucketed
histogram, trace context propagation through the RPC envelope,
client/server span pairing, the per-method RPC table, frame errors,
``Evaluation.trace_ctx`` riding the codec and the ``Trace.Export`` cursor
drain — ports of tests/test_xtrace.py. Its stitching and stitched-report
cases are held against the JAX package in tests/test_torch_chaos.py; the
histogram, the Prometheus text and the merged RPC table are held against
the JAX package's here too."""
import socket
import threading

import pytest

from nomad_tpu.rpc import transport as jtransport
from nomad_tpu.utils.metrics import InmemSink as JaxInmemSink
from nomad_tpu.utils.metrics import LogHistogram as JaxLogHistogram

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import RPCClient, RPCServer, bind_server, decode, encode
from nomad_tpu_torch.rpc import transport
from nomad_tpu_torch.server import InProcRaft, Server, ServerConfig
from nomad_tpu_torch.trace import context as xtrace
from nomad_tpu_torch.utils.metrics import InmemSink, LogHistogram


@pytest.fixture(autouse=True)
def _clean_trace_state():
    xtrace.reset()
    transport.reset_rpc_stats()
    yield
    xtrace.reset()
    transport.reset_rpc_stats()


# ---------------------------------------------------------------------------
# LogHistogram
# ---------------------------------------------------------------------------


def test_histogram_percentile_within_bucket_factor():
    h, j = LogHistogram(), JaxLogHistogram()
    values = [0.3, 1.5, 7.0, 40.0, 900.0, 900.0, 900.0, 12_000.0]
    for v in values:
        h.add(v)
        j.add(v)
    assert h.count == len(values)
    p50 = h.percentile(0.5)
    assert 7.0 / 2 <= p50 <= 40.0 * 2
    p99 = h.percentile(0.99)
    assert 12_000.0 / 2 <= p99 <= 12_000.0 * 2
    assert h.to_wire() == j.to_wire()
    assert [h.percentile(q) for q in (0.5, 0.9, 0.99)] == \
        [j.percentile(q) for q in (0.5, 0.9, 0.99)]


def test_histogram_merge_equals_combined():
    a, b, both = LogHistogram(), LogHistogram(), LogHistogram()
    for i in range(1, 200):
        v = i * 0.7
        (a if i % 2 else b).add(v)
        both.add(v)
    a.merge(b)
    assert a.count == both.count
    assert a.to_wire() == both.to_wire()
    for q in (0.5, 0.9, 0.99):
        assert a.percentile(q) == both.percentile(q)


def test_histogram_wire_roundtrip_and_extremes():
    h = LogHistogram()
    h.add(0.0)          # underflow bucket
    h.add(1e-12)        # underflow bucket
    h.add(2.0 ** 40)    # overflow bucket
    rebuilt = LogHistogram(h.to_wire())
    assert rebuilt.count == 3
    assert rebuilt.to_wire() == h.to_wire()
    assert rebuilt.percentile(1.0) == 2.0 ** (LogHistogram.MAX_EXP + 1)
    # the JAX package reads the port's wire form and gives the same answer
    assert JaxLogHistogram(h.to_wire()).percentile(1.0) == rebuilt.percentile(1.0)


def test_histogram_concurrent_adds_under_witness():
    """Drive the real embedder (_record_dispatch under _rpc_lock, which
    then publishes through the metrics sink lock) from N threads with the
    runtime lock witness armed: every add lands and no lock-order
    violation is recorded."""
    from nomad_tpu_torch.utils import lock_witness as _lw

    witness = _lw.arm()
    try:
        n_threads, per_thread = 8, 200

        def pound(tid):
            for i in range(per_thread):
                transport._record_dispatch(
                    "Witness.test", 0.001 * ((tid + i) % 7 + 1), None)

        threads = [threading.Thread(target=pound, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = witness.stats()
        assert st["violations"] == 0
        row = transport.rpc_stats()["Witness.test"]
        assert row["calls"] == n_threads * per_thread
    finally:
        _lw.disarm()


def test_prometheus_exposition_has_le_buckets():
    s, j = InmemSink(interval=100), JaxInmemSink(interval=100)
    for v in (0.5, 3.0, 3.0, 50.0):
        s.add_sample("nomad.rpc.Ping.latency_ms", v)
        j.add_sample("nomad.rpc.Ping.latency_ms", v)
    text = s.prometheus()
    assert "# TYPE nomad_rpc_Ping_latency_ms histogram" in text
    assert 'nomad_rpc_Ping_latency_ms_bucket{le="+Inf"} 4' in text
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("nomad_rpc_Ping_latency_ms_bucket")]
    assert cums == sorted(cums) and cums[-1] == 4
    assert "nomad_rpc_Ping_latency_ms_sum" in text
    assert "nomad_rpc_Ping_latency_ms_count 4" in text
    assert text == j.prometheus()


# ---------------------------------------------------------------------------
# trace context: propagation, span ring, export cursor
# ---------------------------------------------------------------------------


def test_span_nesting_and_ambient_context():
    with xtrace.span("outer") as _:
        outer = xtrace.current()
        with xtrace.span("inner"):
            inner = xtrace.current()
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    spans = {s["name"]: s for s in xtrace.snapshot()}
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["inner"]["trace_id"] == spans["outer"]["trace_id"]
    assert spans["outer"]["parent_id"] is None


def test_activate_carries_wire_context():
    token = xtrace.activate({"trace_id": "t" * 16, "span_id": "s" * 16})
    try:
        ctx = xtrace.inject()
        assert ctx == {"trace_id": "t" * 16, "span_id": "s" * 16}
        with xtrace.span("child"):
            pass
    finally:
        xtrace.deactivate(token)
    assert xtrace.inject() is None
    (child,) = xtrace.snapshot()
    assert child["trace_id"] == "t" * 16
    assert child["parent_id"] == "s" * 16


def test_export_cursor_is_incremental_and_idempotent():
    for i in range(5):
        xtrace.record_span(f"s{i}", 0.0, 1.0)
    first = xtrace.export()
    assert [s["name"] for s in first["spans"]] == [f"s{i}" for i in range(5)]
    cursor = first["next_seq"]
    assert xtrace.export(after_seq=cursor)["spans"] == []
    xtrace.record_span("late", 1.0, 2.0)
    second = xtrace.export(after_seq=cursor)
    assert [s["name"] for s in second["spans"]] == ["late"]
    again = xtrace.export(after_seq=cursor)
    assert [s["name"] for s in again["spans"]] == ["late"]


def test_error_spans_tag_exception_type():
    with pytest.raises(ValueError):
        with xtrace.span("boom"):
            raise ValueError("nope")
    (s,) = xtrace.snapshot()
    assert s["attrs"]["error"] == "ValueError"


# ---------------------------------------------------------------------------
# RPC layer: envelope propagation, per-method stats, frame errors
# ---------------------------------------------------------------------------


def test_rpc_call_links_client_and_server_spans():
    rpc = RPCServer()
    rpc.register("Math.add", lambda a, b: a + b)
    rpc.start()
    try:
        c = RPCClient(*rpc.addr)
        with xtrace.span("driver.op"):
            assert c.call("Math.add", 2, 3) == 5
        c.close()
    finally:
        rpc.stop()
    spans = {s["name"]: s for s in xtrace.snapshot()}
    root = spans["driver.op"]
    client = spans["rpc.client.Math.add"]
    server = spans["rpc.server.Math.add"]
    assert client["trace_id"] == server["trace_id"] == root["trace_id"]
    assert client["parent_id"] == root["span_id"]
    assert server["parent_id"] == client["span_id"]
    assert client["kind"] == "client" and server["kind"] == "server"
    assert client["attrs"]["req_bytes"] > 0
    assert client["start"] <= server["start"] <= server["end"] <= client["end"]


def test_rpc_stats_table_and_unknown_methods_unrecorded():
    rpc = RPCServer()
    rpc.register("Math.add", lambda a, b: a + b)
    rpc.start()
    try:
        c = RPCClient(*rpc.addr)
        for i in range(3):
            c.call("Math.add", i, i)
        with pytest.raises(Exception):
            c.call("Totally.bogus")
        c.close()
    finally:
        rpc.stop()
    table = transport.rpc_stats(wire=True)
    assert set(table) == {"Math.add"}   # bogus methods never enter
    row = table["Math.add"]
    assert row["calls"] == 3 and row["errors"] == 0
    assert row["req_bytes"] > 0 and row["resp_bytes"] > 0
    assert row["latency_ms_p99"] >= row["latency_ms_p50"] > 0
    assert sum(row["latency_hist"]) == 3


def test_merge_rpc_tables_recomputes_percentiles():
    fast, slow = LogHistogram(), LogHistogram()
    for _ in range(90):
        fast.add(1.0)
    for _ in range(10):
        slow.add(4000.0)
    tables = [
        {"M.x": {"calls": 90, "errors": 0, "not_leader": 0,
                 "req_bytes": 10, "resp_bytes": 10,
                 "latency_hist": fast.to_wire()}},
        {"M.x": {"calls": 10, "errors": 1, "not_leader": 1,
                 "req_bytes": 5, "resp_bytes": 5,
                 "latency_hist": slow.to_wire()}},
    ]
    merged = transport.merge_rpc_tables(tables)
    row = merged["M.x"]
    assert row["calls"] == 100 and row["errors"] == 1
    assert row["req_bytes"] == 15
    assert row["latency_ms_p99"] >= 2000.0
    assert row["latency_ms_p50"] <= 2.0
    assert merged == jtransport.merge_rpc_tables(tables)


def test_frame_errors_carry_method_and_peer_context():
    a, b = socket.socketpair()
    b.close()
    with pytest.raises(transport.FrameError) as ei:
        transport._read_exact(a, 8, peer="1.2.3.4:99", what="resp header")
    a.close()
    msg = str(ei.value)
    assert "1.2.3.4:99" in msg and "resp header" in msg and "/8 bytes" in msg
    assert isinstance(ei.value, ConnectionError)


# ---------------------------------------------------------------------------
# Evaluation.trace_ctx: the eval payload carrier
# ---------------------------------------------------------------------------


def test_eval_stamps_and_carries_trace_ctx():
    with xtrace.span("submit"):
        ev = mock.eval()
        expected = xtrace.inject()
    assert ev.trace_ctx == expected
    # rides the codec (raft log / RPC body) unchanged
    assert decode(encode(ev)).trace_ctx == expected
    assert ev.copy().trace_ctx == expected


def test_eval_outside_trace_has_none_ctx_and_derived_ids():
    from nomad_tpu_torch.trace import lifecycle

    ev = mock.eval()
    assert ev.trace_ctx is None
    trace_id, parent = lifecycle.eval_trace_ids(ev.id, ev.trace_ctx)
    assert trace_id == ev.id.replace("-", "")[:16]
    assert parent is None
    assert (trace_id, parent) == lifecycle.eval_trace_ids(ev.id, None)


# ---------------------------------------------------------------------------
# Trace.Export endpoint over the wire
# ---------------------------------------------------------------------------


def test_trace_export_rpc_drains_ring_with_cursor():
    s = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=InProcRaft(), name="s1")
    rpc = RPCServer()
    bind_server(s, rpc)
    rpc.start()
    try:
        c = RPCClient(*rpc.addr)
        node = mock.node()
        c.call("Node.Register", node)
        out = c.call("Trace.Export", 0, no_forward=True)
        assert out["spans"], "ring should hold the Node.Register span"
        names = {sp["name"] for sp in out["spans"]}
        assert "rpc.server.Node.Register" in names
        assert "Node.Register" in out["rpc"]
        cursor = out["next_seq"]
        out2 = c.call("Trace.Export", cursor, no_forward=True)
        assert all(sp["seq"] > cursor for sp in out2["spans"])
        c.close()
    finally:
        rpc.stop()
        s.stop()
