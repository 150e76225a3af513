"""Cluster operations: runtime join, force-leave, gossip key rotation,
client GC (VERDICT r3 #6; reference command/agent/http.go:176-185,
serf keyring protocol, client/gc.go).

The port's copy of ``tests/test_cluster_ops.py``: every agent and server
on the CPU (``device="cpu"``).
"""

import base64
import os
import time

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import Client, Config
from nomad_tpu_torch.gossip.memberlist import Memberlist, MemberlistConfig


def wait_until(fn, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def fast_ml(name, key=b"") -> MemberlistConfig:
    return MemberlistConfig(
        name=name, probe_interval=0.05, probe_timeout=0.05,
        suspicion_timeout=0.3, push_pull_interval=0.2, encrypt_key=key,
    )


class TestKeyring:
    def test_rolling_rotation_never_partitions(self):
        """serf keyring protocol: install new everywhere -> use new
        everywhere -> remove old. Gossip flows at every step."""
        key_a = base64.b64encode(os.urandom(32)).decode()
        key_b = base64.b64encode(os.urandom(32)).decode()
        a = Memberlist(fast_ml("ka", key_a.encode())).start()
        b = Memberlist(fast_ml("kb", key_a.encode())).start()
        try:
            assert b.join([a.addr]) == 1
            wait_until(lambda: a.num_alive() == 2, msg="joined under key A")

            for ml in (a, b):
                ml.keyring_install(key_b)
            a.keyring_use(key_b)  # a seals with B; b unseals via ring
            assert b._unseal(a._seal(b"x")) == b"x"
            assert a._unseal(b._seal(b"x")) == b"x"  # b still seals with A
            b.keyring_use(key_b)
            for ml in (a, b):
                ml.keyring_remove(key_a)
            assert a.keyring_list() == [key_b]
            # old-key traffic is now dropped; new-key traffic flows
            old = Memberlist(fast_ml("kold", key_a.encode()))
            try:
                assert a._unseal(old._seal(b"x")) is None
            finally:
                old.shutdown()
            assert b._unseal(a._seal(b"y")) == b"y"
            # liveness survives the rotation
            time.sleep(0.3)
            assert a.num_alive() == 2 and b.num_alive() == 2
        finally:
            a.shutdown()
            b.shutdown()

    def test_keyring_broadcast_propagates(self):
        """Mutations issued on ONE node reach the cluster over sealed
        gossip (serf's keyring queries): install+use+remove via
        keyring_broadcast on `a` converge `b`'s ring too."""
        key_a = base64.b64encode(os.urandom(32)).decode()
        key_b = base64.b64encode(os.urandom(32)).decode()
        a = Memberlist(fast_ml("kba", key_a.encode())).start()
        b = Memberlist(fast_ml("kbb", key_a.encode())).start()
        try:
            assert b.join([a.addr]) == 1
            wait_until(lambda: a.num_alive() == 2, msg="joined")
            a.keyring_broadcast("install", key_b)
            wait_until(lambda: key_b in b.keyring_list(),
                       msg="install propagated")
            a.keyring_broadcast("use", key_b)
            wait_until(lambda: b.keyring_list()[0] == key_b,
                       msg="use propagated")
            a.keyring_broadcast("remove", key_a)
            wait_until(lambda: b.keyring_list() == [key_b],
                       msg="remove propagated")
            assert a.keyring_list() == [key_b]
            time.sleep(0.3)
            assert a.num_alive() == 2 and b.num_alive() == 2
        finally:
            a.shutdown()
            b.shutdown()

    def test_keyring_guards(self):
        key = base64.b64encode(os.urandom(16)).decode()
        ml = Memberlist(fast_ml("kg", key.encode()))
        try:
            with pytest.raises(ValueError, match="primary"):
                ml.keyring_remove(key)
            with pytest.raises(ValueError, match="not installed"):
                ml.keyring_use(base64.b64encode(os.urandom(16)).decode())
            plain = Memberlist(fast_ml("kp"))
            try:
                with pytest.raises(ValueError, match="encryption"):
                    plain.keyring_install(key)
            finally:
                plain.shutdown()
        finally:
            ml.shutdown()


class TestJoinForceLeave:
    def test_runtime_join_then_force_leave(self):
        """Two servers with NO retry_join find each other via
        /v1/agent/join at runtime; force-leave evicts one."""
        a1 = Agent(AgentConfig(device="cpu", name="ops1", bootstrap_expect=1))
        a1.start()
        a2 = Agent(AgentConfig(device="cpu", name="ops2", bootstrap_expect=1))
        a2.start()
        try:
            api1 = Client(Config(address=a1.http_addr))
            assert len(api1.agent.members()["Members"]) == 1

            serf_addr = "{}:{}".format(*a2.membership.memberlist.addr)
            out = api1.agent.join([serf_addr])
            assert out["num_joined"] == 1
            wait_until(
                lambda: len(api1.agent.members()["Members"]) == 2,
                msg="both members visible after runtime join",
            )

            # stop 2's gossip without a graceful leave, then evict it
            a2.membership.memberlist.shutdown()
            api1.agent.force_leave("ops2.global")
            wait_until(
                lambda: any(
                    m["Name"] == "ops2.global" and m["Status"] == "left"
                    for m in api1.agent.members()["Members"]
                ),
                msg="forced member marked left",
            )
        finally:
            a1.shutdown()
            a2.shutdown()

    def test_keyring_http_surface(self):
        key_a = base64.b64encode(os.urandom(32)).decode()
        key_b = base64.b64encode(os.urandom(32)).decode()
        a = Agent(AgentConfig(device="cpu", name="keyr1", encrypt=key_a))
        a.start()
        try:
            api = Client(Config(address=a.http_addr))
            assert list(api.agent.keyring_list()["Keys"]) == [key_a]
            api.agent.keyring_op("install", key_b)
            api.agent.keyring_op("use", key_b)
            api.agent.keyring_op("remove", key_a)
            assert list(api.agent.keyring_list()["Keys"]) == [key_b]
        finally:
            a.shutdown()


class TestClientGC:
    @pytest.fixture
    def dev(self):
        a = Agent(AgentConfig(device="cpu", dev_mode=True, name="gc-dev", num_schedulers=2))
        a.start()
        yield a
        a.shutdown()

    def test_gc_collects_dead_alloc_dir(self, dev):
        api = Client(Config(address=dev.http_addr))
        job = {
            "ID": "gc-job", "Name": "gc-job", "Type": "batch",
            "Datacenters": ["dc1"],
            "TaskGroups": [{
                "Name": "g", "Count": 1,
                "Tasks": [{
                    "Name": "t", "Driver": "mock",
                    "Config": {"run_for": "0s"},
                    "Resources": {"CPU": 50, "MemoryMB": 32},
                }],
            }],
        }
        api.jobs.register(job)

        def terminal_alloc():
            allocs, _ = api.jobs.allocations("gc-job")
            return [a for a in allocs or [] if a["ClientStatus"] == "complete"]

        wait_until(lambda: terminal_alloc(), msg="alloc complete")
        alloc_id = terminal_alloc()[0]["ID"]
        alloc_dir = dev.client.alloc_dir_base
        path = os.path.join(alloc_dir, alloc_id)
        assert os.path.isdir(path), "alloc dir exists before GC"
        assert dev.client.num_allocs() == 1

        out = api.agent.client_gc()
        assert out["Collected"] == 1
        assert not os.path.exists(path), "terminal alloc dir removed"
        assert dev.client.num_allocs() == 0

    def test_gc_loop_respects_max_allocs(self, dev):
        """The background sweep only collects when past thresholds."""
        c = dev.client
        # below thresholds: nothing to collect even with force=False
        assert c.garbage_collect(force=False) == 0
