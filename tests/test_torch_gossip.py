"""Gossip membership + federation tests.

Covers the serf/memberlist slot (reference nomad/serf.go, server.go:1250):
SWIM convergence, failure detection, refutation, tag dissemination, the
server region map, and cross-region RPC forwarding — all over real UDP/TCP
sockets on loopback, the same single-machine multi-node strategy the
reference uses (SURVEY §4.2).

The port's copy of ``tests/test_gossip.py``: every agent and server on
the CPU (``device="cpu"``). The membership case waits for the leader tag
to reach the other region's member too (the reference asserts it at
once, a race).
"""
import time

import pytest

from nomad_tpu_torch.gossip.memberlist import (
    STATUS_ALIVE,
    STATUS_DEAD,
    STATUS_LEFT,
    Memberlist,
    MemberlistConfig,
)


def fast_config(name: str) -> MemberlistConfig:
    return MemberlistConfig(
        name=name,
        probe_interval=0.05,
        probe_timeout=0.05,
        suspicion_timeout=0.3,
        push_pull_interval=0.2,
    )


def wait_until(fn, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def pool():
    lists = []

    def make(name, tags=None):
        ml = Memberlist(fast_config(name), tags=tags)
        lists.append(ml)
        return ml.start()

    yield make
    for ml in lists:
        ml.shutdown()


class TestMemberlist:
    def test_three_way_convergence(self, pool):
        a, b, c = pool("a"), pool("b"), pool("c")
        assert b.join([a.addr]) == 1
        assert c.join([a.addr]) == 1
        for ml in (a, b, c):
            wait_until(lambda ml=ml: ml.num_alive() == 3, msg="3 alive members")
        assert {m.name for m in a.alive_members()} == {"a", "b", "c"}

    def test_join_events_fire(self, pool):
        a = pool("a")
        joined = []
        a.on_join = lambda m: joined.append(m.name)
        b = pool("b")
        b.join([a.addr])
        wait_until(lambda: "b" in joined, msg="join event")

    def test_tag_update_propagates(self, pool):
        a, b = pool("a", tags={"v": "1"}), pool("b")
        b.join([a.addr])
        wait_until(lambda: b.num_alive() == 2)
        updated = []
        b.on_update = lambda m: updated.append((m.name, dict(m.tags)))
        a.set_tags({"v": "2"})
        wait_until(lambda: ("a", {"v": "2"}) in updated, msg="tag update")

    def test_failure_detection(self, pool):
        a, b, c = pool("a"), pool("b"), pool("c")
        b.join([a.addr])
        c.join([a.addr])
        wait_until(lambda: a.num_alive() == 3 and b.num_alive() == 3)
        failed = []
        a.on_fail = lambda m: failed.append(m.name)
        c.shutdown()  # crash, no leave intent
        wait_until(lambda: "c" in failed, msg="failure detection")
        dead = [m for m in a.all_members() if m.name == "c"]
        assert dead and dead[0].status == STATUS_DEAD

    def test_graceful_leave(self, pool):
        a, b = pool("a"), pool("b")
        b.join([a.addr])
        wait_until(lambda: a.num_alive() == 2)
        left = []
        a.on_leave = lambda m: left.append(m.name)
        b.leave()
        wait_until(lambda: "b" in left, msg="leave event")
        gone = [m for m in a.all_members() if m.name == "b"]
        assert gone and gone[0].status == STATUS_LEFT

    def test_restart_with_same_name_rejoins(self, pool):
        """A restarted member (incarnation reset to 1) must outbid the
        cluster's memory of its old, higher incarnation — for both dead
        and gracefully-left predecessors."""
        a = pool("a")
        b = pool("b")
        b.join([a.addr])
        wait_until(lambda: a.num_alive() == 2)
        # age b's incarnation well past a fresh instance's
        for _ in range(5):
            b.set_tags({"gen": "old"})
        wait_until(
            lambda: any(m.name == "b" and m.incarnation >= 5 for m in a.all_members()),
            msg="aged incarnation",
        )
        b.leave()  # predecessor leaves gracefully (status=left, high inc)
        wait_until(
            lambda: any(m.name == "b" and m.status == STATUS_LEFT for m in a.all_members()),
            msg="left recorded",
        )
        b2 = pool("b")  # fresh instance, same name, incarnation 1
        b2.join([a.addr])
        wait_until(
            lambda: any(m.name == "b" and m.status == STATUS_ALIVE for m in a.all_members()),
            msg="restarted member alive again",
        )

    def test_refutes_false_death_rumor(self, pool):
        a, b = pool("a"), pool("b")
        b.join([a.addr])
        wait_until(lambda: a.num_alive() == 2 and b.num_alive() == 2)
        # inject a false dead rumor about b into a
        b_inc = b.local_member().incarnation
        a._on_dead_msg("b", b_inc, STATUS_DEAD)
        # b hears the rumor via gossip, refutes with a higher incarnation,
        # and a resurrects it
        wait_until(
            lambda: any(
                m.name == "b" and m.status == STATUS_ALIVE and m.incarnation > b_inc
                for m in a.all_members()
            ),
            msg="refutation",
        )


class TestServerMembership:
    def test_region_map_and_leader_tag(self, pool):
        from nomad_tpu_torch.server.membership import ServerMembership

        cfgs = {}
        members = []

        def make(name, region, leader=False):
            m = ServerMembership(
                name=name, region=region, datacenter="dc1",
                rpc_addr=("127.0.0.1", 4000 + len(members)),
                config=fast_config(name),
            )
            m.start()
            members.append(m)
            cfgs[name] = m
            return m

        try:
            s1 = make("s1", "east")
            s2 = make("s2", "east")
            s3 = make("s3", "west")
            s2.join([s1.gossip_addr])
            s3.join([s1.gossip_addr])
            for m in members:
                wait_until(lambda m=m: set(m.regions()) == {"east", "west"},
                           msg="region map")
            assert {s.name for s in s3.servers_in_region("east")} == \
                {"s1.east", "s2.east"}
            s1.set_leader(True)
            wait_until(
                lambda: s2.leader_in_region() is not None
                and s2.leader_in_region().name == "s1.east",
                msg="leader tag propagation",
            )
            # s3 learns the tag by gossip too, after s2 or before it
            wait_until(lambda: s3.leader_in_region("east") is not None,
                       msg="leader tag reaches the other region")
            assert s3.leader_in_region("east").rpc_addr == ("127.0.0.1", 4000)
        finally:
            for m in members:
                m.memberlist.shutdown()


class TestFederatedAgents:
    def test_leader_forwarding_and_regions(self):
        """Two servers sharing a raft: the follower's RPC transparently
        forwards writes to the leader (rpc.go:409)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig
        from nomad_tpu_torch.rpc.transport import RPCClient
        from nomad_tpu_torch.server.raft import InProcRaft
        from nomad_tpu_torch.server.server import Server, ServerConfig

        raft = InProcRaft()
        s1 = Server(ServerConfig(device="cpu", num_schedulers=0), raft=raft, name="s1")
        s2 = Server(ServerConfig(device="cpu", num_schedulers=0), raft=raft, name="s2")
        assert s1.is_leader and not s2.is_leader

        def agent_cfg(name):
            return AgentConfig(device="cpu",
                name=name, server_enabled=True, gossip_enabled=True,
            )

        a1 = Agent(agent_cfg("s1"), server=s1)
        a2 = Agent(agent_cfg("s2"), server=s2)
        try:
            a1.start()
            a2.config.retry_join = [
                "{}:{}".format(*a1.membership.gossip_addr)
            ]
            a2.start()
            wait_until(lambda: a2.membership.num_servers() == 2, msg="peers")
            wait_until(
                lambda: a2.rpc.leader_addr == a1.rpc.addr,
                msg="leader addr learned via gossip",
            )
            # write through the follower: must land in the shared raft
            cli = RPCClient(*a2.rpc.addr)
            cli.call("Node.Register", mock.node())
            assert len(s1.fsm.state.nodes()) == 1
            assert len(s2.fsm.state.nodes()) == 1  # replicated via shared raft

            # leadership transfer: tags flip, follower retargets forwarding
            raft.transfer_leadership(s2.peer)
            wait_until(
                lambda: a1.rpc.leader_addr == a2.rpc.addr,
                msg="new leader learned after transfer",
            )
            cli1 = RPCClient(*a1.rpc.addr)
            cli1.call("Node.Register", mock.node())  # forwarded to new leader
            assert len(s2.fsm.state.nodes()) == 2
            cli1.close()
            cli.close()
        finally:
            a2.shutdown()
            a1.shutdown()

    def test_cross_region_forwarding(self):
        """A request tagged with another region hops there (rpc.go:502)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig
        from nomad_tpu_torch.rpc.transport import RPCClient

        a_east = Agent(AgentConfig(device="cpu", name="e1", region="east"))
        a_west = Agent(AgentConfig(device="cpu", name="w1", region="west"))
        try:
            a_east.start()
            a_west.config.retry_join = [
                "{}:{}".format(*a_east.membership.gossip_addr)
            ]
            a_west.start()
            wait_until(
                lambda: set(a_east.regions()) == {"east", "west"}
                and set(a_west.regions()) == {"east", "west"},
                msg="federated regions",
            )
            # register a job in east by calling west with region=east
            cli = RPCClient(*a_west.rpc.addr)
            job = mock.job()
            cli.call("Job.Register", job, region="east")
            assert a_east.server.fsm.state.job_by_id("default", job.id) is not None
            assert a_west.server.fsm.state.job_by_id("default", job.id) is None
            # reads hop too
            got = cli.call("Job.GetJob", "default", job.id, region="east")
            assert got is not None and got.id == job.id
            cli.close()
        finally:
            a_west.shutdown()
            a_east.shutdown()


class TestGossipEncryption:
    def test_encrypted_cluster_converges(self):
        """Members sharing an encrypt key form a cluster; their datagrams
        on the wire are AES-GCM sealed (serf keyring slot)."""
        import base64
        import os

        key = base64.b64encode(os.urandom(32)).decode().encode()
        lists = []
        try:
            for name in ("enc-a", "enc-b"):
                cfg = fast_config(name)
                cfg.encrypt_key = key
                lists.append(Memberlist(cfg).start())
            lists[1].join([lists[0].addr])
            for m in lists:
                wait_until(lambda m=m: m.num_alive() == 2,
                           msg="encrypted cluster convergence")
            # wire format check: sealed frames carry the version byte and
            # never the msgpack map marker a plaintext message starts with
            sealed = lists[0]._seal(b"probe")
            assert sealed[0:1] == b"\x01" and sealed != b"probe"
            assert lists[1]._unseal(sealed) == b"probe"
        finally:
            for m in lists:
                m.shutdown()

    def test_plaintext_and_wrong_key_dropped(self):
        """A member without the key (or with a different key) cannot join
        or poison an encrypted cluster."""
        import base64
        import os

        key = base64.b64encode(os.urandom(32)).decode().encode()
        cfg = fast_config("enc-secure")
        cfg.encrypt_key = key
        secure = Memberlist(cfg).start()

        plain = Memberlist(fast_config("enc-plain")).start()
        wrong_cfg = fast_config("enc-wrong")
        wrong_cfg.encrypt_key = base64.b64encode(os.urandom(32)).decode().encode()
        wrong = Memberlist(wrong_cfg).start()
        try:
            plain.join([secure.addr])
            wrong.join([secure.addr])
            time.sleep(1.0)
            assert secure.num_alive() == 1, "unauthenticated members must not join"
            # and the secure node's unseal drops both foreign wire formats
            assert secure._unseal(b"\x81\xa1t\xa4ping") is None  # plaintext msgpack
            assert secure._unseal(wrong._seal(b"x")) is None     # wrong key
        finally:
            secure.shutdown()
            plain.shutdown()
            wrong.shutdown()
