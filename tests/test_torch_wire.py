"""The port on the wire: its own msgpack format against ``msgpack``, its
codec against the JAX package's, the RPC transport and endpoints, and
wire raft — ports of tests/test_rpc.py (the client-agent case waits for
the client) and tests/test_wire_raft.py (the agent case waits for the
agent), then the two packages against each other over TCP.

1. ``wirefmt.packb`` gives ``msgpack.packb(obj, use_bin_type=True)``'s
   bytes (hypothesis over nested values, and every width and length
   boundary), ``wirefmt.unpackb`` gives ``msgpack.unpackb(..., raw=False,
   strict_map_key=False)``'s values, and both refuse what msgpack refuses
   with the same exception class.
2. The port's ``codec.encode`` of seeded mock structs is the JAX codec's
   bytes for the same struct.
3. A JAX-package ``RPCClient`` registers nodes and jobs on a port server
   bound by ``bind_server``; its plan is the JAX server's.
4. Three port servers on ``WireRaft`` (int arm) place the same allocs on
   every FSM as three JAX servers on the JAX ``WireRaft``.

Every wait is on a condition, bounded; every server, raft and RPC
endpoint is stopped in a ``finally`` or a fixture.
"""
import random
import shutil
import tempfile
import time

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nomad_tpu import mock as jmock
from nomad_tpu.rpc import RPCClient as JaxRPCClient
from nomad_tpu.rpc import RPCServer as JaxRPCServer
from nomad_tpu.rpc import bind_server as jax_bind_server
from nomad_tpu.rpc import codec as jcodec
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig
from nomad_tpu.server.wire_raft import WireRaft as JaxWireRaft
from nomad_tpu.server.wire_raft import WireRaftConfig as JaxWireRaftConfig

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import (
    RPCClient,
    RPCError,
    RPCServer,
    bind_server,
    codec,
    decode,
    encode,
    wirefmt,
)
from nomad_tpu_torch.rpc.transport import RPCServer as TransportRPCServer
from nomad_tpu_torch.server import InProcRaft, Server, ServerConfig
from nomad_tpu_torch.server.fsm import JOB_REGISTER, NODE_REGISTER, NomadFSM
from nomad_tpu_torch.server.raft import NotLeaderError
from nomad_tpu_torch.server.wire_raft import LEADER, WireRaft, WireRaftConfig
from nomad_tpu_torch.structs.structs import ALLOC_DESIRED_RUN, Job, Node


def wait_until(fn, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def mp_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def mp_unpack(data):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


# ---------------------------------------------------------------------------
# 1. wirefmt against msgpack
# ---------------------------------------------------------------------------

_INTS = st.one_of(
    st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1),
    st.sampled_from([0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
                     (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769,
                     -(1 << 31), -(1 << 31) - 1, -(1 << 63)]),
)
_SCALARS = st.one_of(
    st.none(), st.booleans(), _INTS,
    st.floats(allow_nan=False), st.text(max_size=40), st.binary(max_size=40),
)
_KEYS = st.one_of(st.text(max_size=12), _INTS, st.booleans(), st.none())
_VALUES = st.recursive(
    _SCALARS,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.tuples(inner, inner),
        st.dictionaries(_KEYS, inner, max_size=20),
    ),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_VALUES)
def test_packb_bytes_equal_msgpack(value):
    want = mp_pack(value)
    assert wirefmt.packb(value) == want
    assert wirefmt.unpackb(want) == mp_unpack(want)


@settings(max_examples=100, deadline=None)
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_floats_pack_as_float64_like_msgpack(x):
    want = mp_pack(x)
    assert wirefmt.packb(x) == want and want[0] == 0xCB
    back = wirefmt.unpackb(want)
    assert (back != back and x != x) or back == x


def _boundary_values():
    out = {}
    for n in (0, 31, 32, 255, 256, 65535, 65536, 70000):
        out[f"str{n}"] = "s" * n
        out[f"str_utf8_{n}"] = "é" * (n // 2)
        out[f"bin{n}"] = b"b" * n
    for n in (0, 15, 16, 65535, 65536):
        out[f"array{n}"] = list(range(n % 200)) * (n // 200) + list(range(n % 200))
        out[f"map{n}"] = {f"k{i}": i for i in range(n)}
    for n in (0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32, (1 << 64) - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1, -(1 << 63)):
        out[f"int{n}"] = n
    out["tuple"] = (1, "a", None, [b"x"])
    out["bytearray"] = bytearray(b"abc")
    out["memoryview"] = memoryview(b"abcd")
    out["nested"] = {"a": [{"b": ({"c": [1.5, -0.0, float("inf")]},)}], 7: None, None: True}
    return out


@pytest.mark.parametrize("name", sorted(_boundary_values()))
def test_every_length_and_width_class_equals_msgpack(name):
    value = _boundary_values()[name]
    want = mp_pack(value)
    assert wirefmt.packb(value) == want
    assert wirefmt.unpackb(want) == mp_unpack(want)


def _nested(depth, leaf):
    out = leaf
    for _ in range(depth):
        out = [out]
    return out


_PACK_REFUSALS = {
    "numpy_int64": lambda: np.int64(3),
    "numpy_bool": lambda: np.bool_(True),
    "uint64_overflow": lambda: 1 << 64,
    "int64_underflow": lambda: -(1 << 63) - 1,
    "set": lambda: {1, 2},
    "complex": lambda: 1 + 2j,
    "object": lambda: object(),
    "surrogate": lambda: "a\ud800",
    "too_deep": lambda: _nested(512, []),
    "too_deep_leaf": lambda: _nested(512, 1),
    "too_deep_map": lambda: {"a": _nested(511, {"b": 1})},
}


@pytest.mark.parametrize("name", sorted(_PACK_REFUSALS))
def test_packb_refuses_what_msgpack_refuses(name):
    value = _PACK_REFUSALS[name]()
    with pytest.raises(Exception) as want:
        mp_pack(value)
    with pytest.raises(Exception) as got:
        wirefmt.packb(value)
    assert type(got.value).__name__ == type(want.value).__name__


def test_packb_accepts_the_deepest_nesting_msgpack_accepts():
    for value in (_nested(511, []), _nested(510, 1), _nested(510, {"a": 1})):
        assert wirefmt.packb(value) == mp_pack(value)


_UNPACK_REFUSALS = {
    "empty": b"",
    "incomplete_array": b"\x92\x01",
    "incomplete_str": b"\xa5ab",
    "incomplete_uint32": b"\xce\x00\x01",
    "extra_data": b"\x01\x02",
    "reserved_c1": b"\xc1",
    "bad_utf8": b"\xa2\xff\xfe",
    "list_key": b"\x81\x91\x01\x02",
    "map_key": b"\x81\x81\x01\x02\x03",
    "too_deep": b"\x91" * 1025 + b"\x01",
}


@pytest.mark.parametrize("name", sorted(_UNPACK_REFUSALS))
def test_unpackb_refuses_what_msgpack_refuses(name):
    data = _UNPACK_REFUSALS[name]
    with pytest.raises(Exception) as want:
        mp_unpack(data)
    with pytest.raises(Exception) as got:
        wirefmt.unpackb(data)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, type(want.value).__mro__[1]) or \
        type(want.value).__mro__[1] is Exception


def test_unpackb_reads_what_msgpack_reads_but_never_writes():
    deepest = b"\x91" * 1024 + b"\x01"
    assert wirefmt.unpackb(deepest) == mp_unpack(deepest)
    for data in (b"\xca\x3f\xc0\x00\x00", b"\xd4\x05\x01", b"\xc7\x03\x07abc",
                 b"\xd8\x01" + b"x" * 16):
        got, want = wirefmt.unpackb(data), mp_unpack(data)
        assert got == want and type(got) in (float, wirefmt.ExtType)
    ext = wirefmt.ExtType(5, b"payload")
    assert wirefmt.packb(ext) == mp_pack(msgpack.ExtType(5, b"payload"))


# ---------------------------------------------------------------------------
# 2. the codec against the JAX package's
# ---------------------------------------------------------------------------


def _seeded_structs(seed, mock_mod):
    rng = np.random.default_rng(seed)
    random.seed(seed)
    node = mock_mod.node()
    node.node_resources.cpu_shares = int(rng.integers(1000, 64000))
    node.node_resources.memory_mb = int(rng.integers(1024, 1 << 20))
    node.attributes["rack"] = f"r{int(rng.integers(0, 9))}"
    job = mock_mod.job()
    job.task_groups[0].count = int(rng.integers(1, 5000))
    job.priority = int(rng.integers(1, 100))
    alloc = mock_mod.alloc()
    alloc.job = job
    alloc.node_id = node.id
    ev = mock_mod.eval()
    ev.job_id = job.id
    return {"node": node, "job": job, "alloc": alloc, "eval": ev,
            "envelope": {"seq": int(rng.integers(0, 1 << 40)), "method": "Job.Register",
                         "body": (job,), "trace": {"trace_id": "t" * 16, "span_id": "s" * 16}},
            "raft_entry": [int(rng.integers(1, 1 << 32)), int(rng.integers(1, 9)),
                           "node-register", node],
            "containers": {("default", job.id): {1, 2}, "t": (alloc, None), "l": [ev]}}


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("what", ["node", "job", "alloc", "eval", "envelope", "raft_entry",
                                  "containers"])
def test_codec_bytes_equal_the_jax_codec(what, seed):
    """A struct made by the port's mock, and the same struct moved into
    the JAX package's classes, encode to the same bytes; either side
    decodes the other's bytes to an equal value."""
    port_obj = _seeded_structs(seed, mock)[what]
    wire = encode(port_obj)
    jax_obj = jcodec.decode(wire)
    assert jcodec.encode(jax_obj) == wire
    assert decode(jcodec.encode(jax_obj)) == port_obj
    # and from the JAX package's mock the other way round
    jax_made = _seeded_structs(seed, jmock)[what]
    jwire = jcodec.encode(jax_made)
    assert encode(decode(jwire)) == jwire


def test_codec_imports_no_msgpack():
    import ast
    import inspect

    for mod in (codec, wirefmt):
        tree = ast.parse(inspect.getsource(mod))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(str(n).split(".")[0] == "msgpack" for n in names), names


# ---------------------------------------------------------------------------
# 3. ports of tests/test_rpc.py
# ---------------------------------------------------------------------------


def test_codec_roundtrips_structs():
    job = mock.job()
    out = decode(encode(job))
    assert isinstance(out, Job)
    assert out.id == job.id
    assert out.task_groups[0].tasks[0].resources.cpu == \
        job.task_groups[0].tasks[0].resources.cpu
    assert out.task_groups[0].constraints == job.task_groups[0].constraints

    node = mock.node()
    out = decode(encode(node))
    assert isinstance(out, Node)
    assert out.node_resources.networks[0].cidr == node.node_resources.networks[0].cidr

    alloc = mock.alloc()
    alloc.job = job
    out = decode(encode(alloc))
    assert out.job.id == job.id

    # containers: tuples, sets, tuple-keyed dicts
    payload = {("ns", "job"): [1, 2], "plain": {"x": (1, "two")}}
    out = decode(encode(payload))
    assert out[("ns", "job")] == [1, 2]
    assert out["plain"]["x"] == (1, "two")


def test_codec_rejects_unknown_types():
    with pytest.raises(ValueError):
        decode(encode({"ok": 1}).replace(b"ok", b"__t"))  # crafted tag


def test_rpc_call_and_error():
    rpc = RPCServer()
    rpc.register("Math.add", lambda a, b: a + b)

    def boom():
        raise ValueError("nope")

    rpc.register("Math.boom", boom)
    rpc.start()
    try:
        c = RPCClient(*rpc.addr)
        assert c.call("Math.add", 2, 3) == 5
        with pytest.raises(RPCError, match="nope"):
            c.call("Math.boom")
        with pytest.raises(RPCError, match="unknown method"):
            c.call("Math.missing")
        c.close()
    finally:
        rpc.stop()


def test_timed_out_call_cannot_poison_the_next_response():
    """A call whose reconnect retry ALSO dies must tear the connection
    down: leaving it open strands an in-flight request whose late
    response would answer the NEXT call on the socket."""
    rpc = RPCServer()
    rpc.register("Slow.echo", lambda x, delay: (time.sleep(delay), x)[1])
    rpc.start()
    try:
        c = RPCClient(*rpc.addr)
        with pytest.raises(OSError):
            # first attempt and the retry both time out; the server is
            # still cooking the retried request when this call returns
            c.call("Slow.echo", "A", 1.5, timeout=0.3)
        # the poisoned-connection failure mode was this returning "A"
        assert c.call("Slow.echo", "B", 0.0, timeout=5.0) == "B"
        c.close()
    finally:
        rpc.stop()


def test_follower_forwards_to_leader():
    """Writes against a follower transparently reach the leader
    (rpc.go:409 forward)."""
    raft = InProcRaft()
    leader = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s1")
    follower = Server(ServerConfig(num_schedulers=0, device="cpu"), raft=raft, name="s2")

    rpc_leader = RPCServer()
    bind_server(leader, rpc_leader)
    rpc_leader.is_leader = lambda: leader.is_leader
    rpc_leader.start()

    rpc_follower = RPCServer()
    bind_server(follower, rpc_follower)
    rpc_follower.is_leader = lambda: follower.is_leader
    rpc_follower.leader_addr = rpc_leader.addr
    rpc_follower.start()

    try:
        c = RPCClient(*rpc_follower.addr)
        node = mock.node()
        ttl = c.call("Node.Register", node)  # forwarded to the leader
        assert ttl > 0
        # replicated to both FSMs
        assert leader.fsm.state.node_by_id(node.id) is not None
        assert follower.fsm.state.node_by_id(node.id) is not None
        c.close()
    finally:
        rpc_leader.stop()
        rpc_follower.stop()
        leader.stop()
        follower.stop()


# ---------------------------------------------------------------------------
# 4. the JAX package's client against a port server, over TCP
# ---------------------------------------------------------------------------


def _fleet_and_jobs():
    """JAX-package structs with fixed ids: the same objects go over the
    wire to both servers."""
    rng = random.Random(3)
    nodes = []
    for i in range(24):
        n = jmock.node()
        n.id = f"00000000-0000-4000-8000-{i:012d}"
        n.name = f"node-{i}"
        n.node_resources.cpu_shares = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.compute_class()
        nodes.append(n)
    web = jmock.job()
    web.id = "web"
    web.task_groups[0].count = 30
    batch = jmock.batch_job()
    batch.id = "batch"
    batch.task_groups[0].count = 25
    return nodes, [web, batch]


def _place_over_the_wire(server):
    """Register the fleet and the jobs on ``server`` through a JAX
    ``RPCClient``; return {(job, alloc name): node name} as the server's
    FSM holds it, read back over the wire too."""
    nodes, jobs = _fleet_and_jobs()
    rpc = TransportRPCServer() if isinstance(server, Server) else JaxRPCServer()
    (bind_server if isinstance(server, Server) else jax_bind_server)(server, rpc)
    rpc.is_leader = lambda: server.is_leader
    rpc.start()
    server.start()
    client = JaxRPCClient(*rpc.addr)
    try:
        for n in nodes:
            assert client.call("Node.Register", n) > 0
        for job in jobs:
            assert client.call("Job.Register", job)
        want = sum(j.task_groups[0].count for j in jobs)

        def placed():
            return sum(1 for j in jobs
                       for a in client.call("Job.Allocations", j.namespace, j.id)
                       if a.desired_status == ALLOC_DESIRED_RUN)

        wait_until(lambda: placed() == want, timeout=120.0, msg=f"{want} allocs placed")
        names = {n.id: n.name for n in nodes}
        view = {}
        for j in jobs:
            for a in client.call("Job.Allocations", j.namespace, j.id):
                assert type(a).__module__ == "nomad_tpu.structs.structs"
                view[(j.id, a.name)] = names[a.node_id]
        _, cfg = client.call("Operator.SchedulerGetConfiguration")
        return view, cfg
    finally:
        client.close()
        rpc.stop()
        server.stop()


def test_jax_client_drives_a_port_server_to_the_jax_servers_plan():
    kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
              pipeline_async=False, heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    jax_view, jax_cfg = _place_over_the_wire(JaxServer(JaxServerConfig(**kw)))
    port_view, port_cfg = _place_over_the_wire(Server(ServerConfig(device="cpu", **kw)))
    assert port_view == jax_view
    assert len(port_view) == 55
    assert jcodec.encode(port_cfg) == jcodec.encode(jax_cfg)


# ---------------------------------------------------------------------------
# 5. ports of tests/test_wire_raft.py
# ---------------------------------------------------------------------------


def fast_config(node_id: str) -> WireRaftConfig:
    return WireRaftConfig(
        node_id=node_id,
        election_timeout_min=0.15,
        election_timeout_max=0.3,
        heartbeat_interval=0.03,
        rpc_timeout=0.5,
        apply_timeout=5.0,
    )


class RaftNode:
    """One raft participant with its own RPC endpoint and FSM."""

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


@pytest.fixture
def cluster():
    nodes = []

    def make(n, data_dirs=None, defer=()):
        for i in range(n):
            nodes.append(RaftNode(f"n{i}", data_dirs[i] if data_dirs else None))
        for node in nodes:
            node.wire(nodes, start=node.node_id not in defer)
        return nodes

    yield make
    for node in nodes:
        node.stop()


def leader_of(nodes):
    leaders = [n for n in nodes if n.raft.state == LEADER]
    return leaders[0] if len(leaders) == 1 else None


class TestWireRaft:
    def test_single_leader_elected(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None, msg="leader election")
        leader = leader_of(nodes)
        wait_until(
            lambda: all(n.raft.leader_id == leader.node_id for n in nodes),
            msg="leader agreement",
        )

    def test_replication_to_all_fsms(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None)
        leader = leader_of(nodes)
        node = mock.node()
        index, _ = leader.raft.apply(0, NODE_REGISTER, node)
        assert index > 0
        wait_until(
            lambda: all(n.fsm.state.node_by_id(node.id) is not None for n in nodes),
            msg="replication to all FSMs",
        )

    def test_follower_rejects_apply(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None)
        follower = next(n for n in nodes if n.raft.state != LEADER)
        with pytest.raises(NotLeaderError):
            follower.raft.apply(0, NODE_REGISTER, mock.node())

    def test_leader_failover(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None)
        leader = leader_of(nodes)
        n1 = mock.node()
        leader.raft.apply(0, NODE_REGISTER, n1)

        leader.stop()
        rest = [n for n in nodes if n is not leader]
        wait_until(lambda: leader_of(rest) is not None, msg="re-election")
        new_leader = leader_of(rest)
        assert new_leader is not leader
        assert new_leader.fsm.state.node_by_id(n1.id) is not None
        n2 = mock.node()
        new_leader.raft.apply(0, NODE_REGISTER, n2)
        wait_until(
            lambda: all(n.fsm.state.node_by_id(n2.id) is not None for n in rest),
            msg="post-failover replication",
        )

    def test_late_follower_catches_up(self, cluster):
        nodes = cluster(3, defer=("n2",))
        active = nodes[:2]
        late = nodes[2]
        wait_until(lambda: leader_of(active) is not None)
        leader = leader_of(active)
        registered = [mock.node() for _ in range(5)]
        for n in registered:
            leader.raft.apply(0, NODE_REGISTER, n)
        late.raft.start()
        wait_until(
            lambda: all(late.fsm.state.node_by_id(n.id) is not None for n in registered),
            msg="late follower catch-up",
        )

    def test_snapshot_install_for_compacted_follower(self, cluster):
        nodes = cluster(3, defer=("n2",))
        active = nodes[:2]
        late = nodes[2]
        wait_until(lambda: leader_of(active) is not None)
        leader = leader_of(active)
        registered = [mock.node() for _ in range(5)]
        for n in registered:
            leader.raft.apply(0, NODE_REGISTER, n)
        job = mock.job()
        leader.raft.apply(0, JOB_REGISTER, job)
        snap_index = leader.raft.snapshot(0)
        assert snap_index > 0
        assert leader.raft._entries_from(1) is None
        late.raft.start()
        wait_until(
            lambda: late.fsm.state.job_by_id("default", job.id) is not None
            and all(late.fsm.state.node_by_id(n.id) is not None for n in registered),
            msg="snapshot install",
        )

    def test_snapshot_blob_is_codec_not_pickle(self):
        """InstallSnapshot ships msgpack through the typed codec, never
        pickle. Round-trips the state tables the port has (its structs;
        the ACL structs come with the modules that define them)."""
        import inspect
        import pickle

        from nomad_tpu_torch.server import wire_raft as wr
        from nomad_tpu_torch.state import StateStore

        store = StateStore()
        n = mock.node()
        store.upsert_node(1, n)
        j = mock.job()
        store.upsert_job(2, j)
        a = mock.alloc()
        a.job, a.node_id = j, n.id
        store.upsert_allocs(3, [a])

        blob = wr._encode_fsm_state(store.snapshot())
        with pytest.raises(Exception):
            wr._decode_fsm_state(pickle.dumps({"__reduce__": "nope"}))

        restored = wr._decode_fsm_state(blob)
        assert restored.node_by_id(n.id).name == n.name
        assert restored.job_by_id("default", j.id).id == j.id
        assert restored.alloc_by_id(a.id).node_id == n.id
        assert restored.latest_index == store.latest_index
        for fn in (wr._encode_fsm_state, wr._decode_fsm_state,
                   wr.WireRaft._handle_install_snapshot,
                   wr.WireRaft._handle_append_entries,
                   wr.WireRaft._append_locked,
                   wr.WireRaft.snapshot):
            src = inspect.getsource(fn)
            for needle in ("import pickle", "pickle.loads", "pickle.dumps"):
                assert needle not in src, f"{fn.__name__}: {needle}"

    def test_restart_recovers_from_disk(self):
        tmp = tempfile.mkdtemp(prefix="wire-raft-")
        try:
            node = RaftNode("solo", data_dir=tmp).wire([])
            wait_until(lambda: node.raft.state == LEADER, msg="solo leader")
            registered = [mock.node() for _ in range(3)]
            for n in registered:
                node.raft.apply(0, NODE_REGISTER, n)
            term_before = node.raft.current_term
            node.stop()

            node2 = RaftNode("solo", data_dir=tmp).wire([])
            wait_until(lambda: node2.raft.state == LEADER, msg="solo re-leader")
            assert node2.raft.current_term >= term_before
            for n in registered:
                assert node2.fsm.state.node_by_id(n.id) is not None, "log replay"
            node2.stop()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


_FAST_ELECTIONS = dict(election_timeout_min=0.15, election_timeout_max=0.3,
                       heartbeat_interval=0.03, rpc_timeout=0.5, apply_timeout=5.0)
# the JAX engine's first compile holds the GIL for seconds on a loaded
# host: elections slow enough that it never reads as a dead leader
_STEADY_ELECTIONS = dict(election_timeout_min=3.0, election_timeout_max=6.0,
                         heartbeat_interval=0.1, rpc_timeout=2.0, apply_timeout=60.0)


def _wire_servers(rpc_cls, raft_cls, raft_cfg_cls, server_cls, cfg, data_dirs=None,
                  timing=_FAST_ELECTIONS):
    rpcs = [rpc_cls() for _ in range(3)]
    rafts = []
    for i, rpc in enumerate(rpcs):
        peers = {f"s{j}": rpcs[j].addr for j in range(3) if j != i}
        rafts.append(raft_cls(rpc, peers, raft_cfg_cls(node_id=f"s{i}", **timing),
                              data_dir=data_dirs[i] if data_dirs else None))
    servers = [server_cls(cfg, raft=rafts[i], name=f"s{i}") for i in range(3)]
    return rpcs, rafts, servers


def _stop_wire_servers(rpcs, rafts, servers):
    for s in servers:
        s.stop()
    for r in rafts:
        r.close()
    for rpc in rpcs:
        rpc.stop()


class TestServerOnWireRaft:
    def test_three_servers_schedule_and_replicate(self):
        """Three servers' runtime on wire raft: writes on the leader
        replicate; the leader's scheduler places allocs (on the CPU,
        through the batcher); the follower FSMs see them."""
        rpcs, rafts, servers = _wire_servers(
            RPCServer, WireRaft, WireRaftConfig, Server,
            ServerConfig(num_schedulers=1, deterministic=True, device="cpu"))
        try:
            for rpc in rpcs:
                rpc.start()
            for s in servers:
                s.start()
            for r in rafts:
                r.start()
            wait_until(lambda: sum(1 for r in rafts if r.state == LEADER) == 1,
                       msg="server leader")
            leader = next(s for s, r in zip(servers, rafts) if r.state == LEADER)
            followers = [s for s in servers if s is not leader]

            leader.register_node(mock.node())
            leader.register_node(mock.node())
            job = mock.job()
            leader.register_job(job)
            wait_until(
                lambda: len(leader.fsm.state.allocs_by_job("default", job.id, True)) == 10,
                timeout=30, msg="placement on leader")
            wait_until(
                lambda: all(len(f.fsm.state.allocs_by_job("default", job.id, True)) == 10
                            for f in followers),
                msg="alloc replication to followers")
        finally:
            _stop_wire_servers(rpcs, rafts, servers)

    def test_port_cluster_places_as_the_jax_cluster(self, tmp_path):
        """Three port servers on the port's WireRaft (int arm, durable data
        dirs) and three JAX servers on the JAX package's: the same fleet
        and jobs (JAX structs with fixed ids, moved into each package's
        classes through its codec) give the same alloc -> node map, and
        every FSM of a cluster holds it."""
        nodes, jobs = _fleet_and_jobs()
        wires = [jcodec.encode(x) for x in nodes + jobs]
        # nobody heartbeats these nodes: TTLs past the run keep them ready
        kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
                  pipeline_async=False, heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
        views = {}
        for side in ("jax", "port"):
            if side == "jax":
                parts = _wire_servers(JaxRPCServer, JaxWireRaft, JaxWireRaftConfig, JaxServer,
                                      JaxServerConfig(**kw), timing=_STEADY_ELECTIONS)
                objs = [jcodec.decode(w) for w in wires]
            else:
                parts = _wire_servers(RPCServer, WireRaft, WireRaftConfig, Server,
                                      ServerConfig(device="cpu", **kw),
                                      [str(tmp_path / f"s{i}") for i in range(3)],
                                      timing=_STEADY_ELECTIONS)
                objs = [decode(w) for w in wires]
            rpcs, rafts, servers = parts
            try:
                for rpc in rpcs:
                    rpc.start()
                for s in servers:
                    s.start()
                for r in rafts:
                    r.start()
                wait_until(lambda: sum(1 for r in rafts if r.state == LEADER) == 1,
                           timeout=30, msg=f"{side} leader")
                leader = next(s for s, r in zip(servers, rafts) if r.state == LEADER)
                for n in objs[:len(nodes)]:
                    leader.register_node(n)
                for j in objs[len(nodes):]:
                    leader.register_job(j)
                want = sum(j.task_groups[0].count for j in jobs)
                names = {n.id: n.name for n in nodes}

                def view(s):
                    return {(a.job_id, a.name): names[a.node_id]
                            for a in s.fsm.state.allocs()
                            if a.desired_status == ALLOC_DESIRED_RUN}

                wait_until(lambda: all(len(view(s)) == want for s in servers), timeout=120,
                           msg=f"{side}: {want} allocs on every FSM")
                assert all(r.current_term == rafts[0].current_term for r in rafts), \
                    f"{side}: leadership moved during the run"
                per_fsm = [view(s) for s in servers]
                assert per_fsm[0] == per_fsm[1] == per_fsm[2]
                views[side] = per_fsm[0]
            finally:
                _stop_wire_servers(rpcs, rafts, servers)
        assert views["port"] == views["jax"]


class TestReplicatedPeerRemoval:
    def test_remove_peer_replicated_shrinks_all_views(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None)
        leader = leader_of(nodes)
        followers = [n for n in nodes if n is not leader]
        victim = followers[0]
        victim.stop()
        leader.raft.remove_peer_replicated(victim.node_id)
        survivor = followers[1]
        wait_until(
            lambda: victim.node_id not in leader.raft.peers
            and victim.node_id not in survivor.raft.peers,
            msg="peer removed on every replica",
        )
        n = mock.node()
        leader.raft.apply(0, NODE_REGISTER, n)
        wait_until(lambda: survivor.fsm.state.node_by_id(n.id) is not None,
                   msg="post-removal commit")


class TestStagedMembership:
    """Log-replicated peer ADDITION: adds commit through the log, so every
    replica grows its configuration at the same position and a minority
    partition can never grow its own voter set."""

    @staticmethod
    def _sever(node, peer_id):
        """Cut node's OUTBOUND RPC to peer_id; returns a restore fn."""
        orig = node.raft._client

        def gated(pid, _orig=orig):
            if pid == peer_id:
                raise RPCError("partitioned")
            return _orig(pid)

        node.raft._client = gated
        return lambda: setattr(node.raft, "_client", orig)

    def test_staged_add_promotes_to_voter(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None, msg="leader")
        leader = leader_of(nodes)
        leader.raft.apply(0, NODE_REGISTER, mock.node())

        d = RaftNode("n3")
        nodes.append(d)  # fixture cleanup
        d.wire(nodes[:3] + [d])
        assert leader.raft.add_peer_staged("n3", d.rpc.addr)
        wait_until(
            lambda: all(len(n.raft.peers) == 3 and not n.raft.nonvoters
                        and not n.raft._self_nonvoter for n in nodes),
            timeout=12, msg="staged add promoted everywhere",
        )
        wait_until(lambda: len(d.fsm.state.nodes()) == 1, msg="catch-up")

    def test_add_during_partition_heals_to_single_config(self, cluster):
        """The partition is cut once every node follows one leader (a
        victim picked during an election could be the next leader), and
        it heals by undoing the cuts in reverse order: each cut wraps the
        one before it, so undoing them in order would leave the victim's
        outbound calls to two peers cut after the heal."""
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None and all(
            n.raft.leader_id == leader_of(nodes).node_id for n in nodes),
            msg="every node follows one leader")
        leader = leader_of(nodes)
        victim = next(n for n in nodes if n.raft.state != LEADER)
        others = [n for n in nodes if n is not victim]

        restores = []
        for other in others:
            restores.append(self._sever(other, victim.node_id))
            restores.append(self._sever(victim, other.node_id))

        d = RaftNode("n3")
        nodes.append(d)
        d.wire(nodes[:3] + [d])
        restores.append(self._sever(victim, "n3"))
        restores.append(self._sever(d, victim.node_id))
        assert leader.raft.add_peer_staged("n3", d.rpc.addr)
        majority = others + [d]
        wait_until(
            lambda: all("n3" in (set(n.raft.peers) | {n.node_id}) and not n.raft.nonvoters
                        for n in majority),
            timeout=12, msg="add committed on the majority side",
        )
        assert "n3" not in victim.raft.peers
        assert victim.raft.add_peer_staged("n3", d.rpc.addr) is False
        assert "n3" not in victim.raft.peers

        for restore in reversed(restores):
            restore()
        wait_until(
            lambda: set(victim.raft.peers) | {victim.node_id} == {"n0", "n1", "n2", "n3"}
            and not victim.raft.nonvoters,
            timeout=12, msg="healed minority adopts the replicated config",
        )
        wait_until(lambda: leader_of(nodes) is not None, timeout=12,
                   msg="single leader after heal")
        final_leader = leader_of(nodes)
        marker = mock.node()
        final_leader.raft.apply(0, NODE_REGISTER, marker)
        wait_until(
            lambda: all(n.fsm.state.node_by_id(marker.id) is not None for n in nodes),
            timeout=12, msg="post-heal replication to all four",
        )

    def test_snapshot_carries_membership_config(self, cluster):
        nodes = cluster(3)
        wait_until(lambda: leader_of(nodes) is not None, msg="leader")
        leader = leader_of(nodes)
        victim = next(n for n in nodes if n.raft.state != LEADER)
        others = [n for n in nodes if n is not victim]

        restores = []
        for other in others:
            restores.append(self._sever(other, victim.node_id))
            restores.append(self._sever(victim, other.node_id))

        d = RaftNode("n3")
        nodes.append(d)
        d.wire(nodes[:3] + [d])
        restores.append(self._sever(victim, "n3"))
        restores.append(self._sever(d, victim.node_id))
        assert leader.raft.add_peer_staged("n3", d.rpc.addr)
        majority = others + [d]
        wait_until(
            lambda: all(not n.raft.nonvoters and "n3" in (set(n.raft.peers) | {n.node_id})
                        for n in majority),
            timeout=12, msg="staged add committed+promoted",
        )
        for _ in range(3):
            leader2 = leader_of(majority)
            leader2.raft.apply(0, NODE_REGISTER, mock.node())
        leader2 = leader_of(majority)
        assert leader2.raft.snapshot() > 0
        leader2.raft.apply(0, NODE_REGISTER, mock.node())

        for restore in restores:
            restore()
        wait_until(
            lambda: "n3" in victim.raft.peers and not victim.raft.nonvoters,
            timeout=12, msg="snapshot-installed config includes the add",
        )
        wait_until(
            lambda: len(victim.fsm.state.nodes()) == len(leader2.fsm.state.nodes()),
            timeout=12, msg="victim state caught up",
        )


# ---------------------------------------------------------------------------
# 6. a slow follower cannot depose a working leader (the port's raft)
# ---------------------------------------------------------------------------


def _follower(raft_mod, rpc_cls, fsm_cls):
    rpc = rpc_cls()
    rpc.start()
    raft = raft_mod.WireRaft(rpc, {"leader": ("127.0.0.1", 1), "cand": ("127.0.0.1", 2)},
                             raft_mod.WireRaftConfig(node_id="f", election_timeout_min=0.3,
                                                     election_timeout_max=0.6))
    raft.join(fsm_cls())
    # one heartbeat of the term-3 leader
    assert raft._handle_append_entries(3, "leader", 0, 0, [], 0)[1]
    return rpc, raft


def test_follower_with_a_live_leader_rejects_a_disruptive_vote():
    """A follower that heard from its leader within the minimum election
    timeout neither grants a vote nor takes the candidate's term (Raft
    §6); once the leader has been silent that long it votes. The
    reference's follower takes the term and votes at once, deposing the
    leader."""
    from nomad_tpu.rpc.transport import RPCServer as JaxRPCServer
    from nomad_tpu.server import wire_raft as jwire
    from nomad_tpu.server.fsm import NomadFSM as JaxFSM
    from nomad_tpu_torch.server import wire_raft as twire

    rpc, raft = _follower(twire, RPCServer, NomadFSM)
    try:
        assert raft._handle_request_vote(9, "cand", 0, 0) == [3, False]
        assert raft.current_term == 3 and raft.leader_id == "leader"
        time.sleep(0.35)  # the leader silent past the minimum timeout
        assert raft._handle_request_vote(9, "cand", 0, 0) == [9, True]
    finally:
        raft.close()
        rpc.stop()
    rpc, raft = _follower(jwire, JaxRPCServer, JaxFSM)
    try:
        assert raft._handle_request_vote(9, "cand", 0, 0) == [9, True]
    finally:
        raft.close()
        rpc.stop()


def test_election_timer_starts_when_the_leaders_call_is_done():
    """A snapshot install that outlasts the election timeout leaves the
    follower's timer a full timeout ahead when it returns: it does not
    campaign against the leader whose call it was handling."""
    from nomad_tpu_torch.server import wire_raft as twire
    from nomad_tpu_torch.state import StateStore

    rpc, raft = _follower(twire, RPCServer, NomadFSM)
    try:
        restore = raft.fsm.restore
        raft.fsm.restore = lambda store: (time.sleep(0.7), restore(store))
        blob = twire._encode_fsm_state(StateStore().snapshot())
        assert raft._handle_install_snapshot(3, "leader", 5, 3, blob, None) == 3
        now = time.monotonic()
        assert raft._election_deadline >= now + 0.3 - 0.05
        assert raft.last_contact_age_s() < 0.1
    finally:
        raft.close()
        rpc.stop()


def test_a_follower_cut_off_from_the_leader_cannot_raise_its_term(cluster):
    """A follower that stops hearing the leader while the others still
    do loses every pre-vote round: its term never moves past the
    cluster's, and when the leader's calls reach it again it follows
    the same leader at the same term (no election, no deposed leader)."""
    nodes = cluster(3)
    wait_until(lambda: leader_of(nodes) is not None, msg="leader")
    leader = leader_of(nodes)
    term = leader.raft.current_term
    victim = next(n for n in nodes if n is not leader)
    restore = TestStagedMembership._sever(leader, victim.node_id)
    try:
        time.sleep(1.5)  # five election timeouts and more
        assert victim.raft.current_term == term
        assert leader.raft.state == LEADER and leader.raft.current_term == term
    finally:
        restore()
    marker = mock.node()
    leader.raft.apply(0, NODE_REGISTER, marker)
    wait_until(lambda: victim.fsm.state.node_by_id(marker.id) is not None,
               msg="the victim follows the same leader again")
    assert leader.raft.current_term == term == victim.raft.current_term
    assert leader_of(nodes) is leader
