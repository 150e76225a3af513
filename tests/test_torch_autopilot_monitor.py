"""Autopilot + agent monitor + debug endpoint tests (reference
nomad/autopilot.go, command/agent/monitor, http.go pprof gating).

The port's copy of ``tests/test_autopilot_monitor.py``: every agent and
server on the CPU (``device="cpu"``).
"""
import json
import logging
import time
import urllib.error
import urllib.request

import pytest

from nomad_tpu_torch.agent.agent import Agent, AgentConfig
from nomad_tpu_torch.server.autopilot import Autopilot, AutopilotConfig


def wait_until(fn, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def http(agent, path, method="GET", body=None, raw=False):
    req = urllib.request.Request(
        agent.http_addr + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
    )
    with urllib.request.urlopen(req) as r:
        data = r.read()
    return data if raw else json.loads(data)


@pytest.fixture
def agent():
    a = Agent(AgentConfig(device="cpu", name="ap", gossip_enabled=False, enable_debug=True,
                          num_schedulers=0)).start()
    yield a
    a.shutdown()


class TestAutopilotEndpoints:
    def test_config_get_set(self, agent):
        cfg = http(agent, "/v1/operator/autopilot/configuration")
        assert cfg["CleanupDeadServers"] is True
        http(agent, "/v1/operator/autopilot/configuration", method="PUT",
             body={"CleanupDeadServers": False, "LastContactThresholdS": 5.0})
        cfg = http(agent, "/v1/operator/autopilot/configuration")
        assert cfg["CleanupDeadServers"] is False
        # raft-replicated: visible in state
        _, stored = agent.server.fsm.state.autopilot_config()
        assert stored.cleanup_dead_servers is False

    def test_health_single_server(self, agent):
        out = http(agent, "/v1/operator/autopilot/health")
        assert out["Healthy"] is True
        assert len(out["Servers"]) == 1
        assert out["Servers"][0]["SerfStatus"] == "alive"


class TestDeadServerCleanup:
    def test_prunes_failed_peer_within_quorum(self):
        """Leader removes a gossip-failed raft peer only while quorum
        holds (autopilot.go pruneDeadServers)."""

        class FakeRaft:
            def __init__(self):
                self.peers = {"a.global": 1, "b.global": 2, "c.global": 3,
                              "d.global": 4}
                self.commit_index = 10
                self.match_index = {}
                self.removed = []

            def remove_peer(self, pid):
                self.peers.pop(pid, None)
                self.removed.append(pid)

        class FakeMember:
            def __init__(self, name, status):
                self.name, self.status = name, status

        class FakeMembership:
            class memberlist:
                class config:
                    name = "self.global"

            def members(self):
                return [FakeMember("self.global", "alive"),
                        FakeMember("a.global", "alive"),
                        FakeMember("b.global", "alive"),
                        FakeMember("c.global", "dead"),
                        FakeMember("d.global", "dead")]

            def servers_in_region(self):
                return []

        class FakeServer:
            is_leader = True

            class fsm:
                class state:
                    autopilot_config_entry = None
                    latest_index = 10

            name = "self"

        raft = FakeRaft()
        ap = Autopilot(FakeServer(), membership=FakeMembership(), wire_raft=raft)
        removed = ap.prune_dead_servers()
        # cluster of 5 (4 peers + self), quorum 3 → at most 2 removable
        assert sorted(removed) == ["c.global", "d.global"]
        assert "a.global" in raft.peers and "b.global" in raft.peers

    def test_never_breaks_quorum(self):
        class FakeRaft:
            def __init__(self):
                self.peers = {"a.global": 1, "b.global": 2}
                self.commit_index = 0
                self.match_index = {}

            def remove_peer(self, pid):
                self.peers.pop(pid, None)

        class FakeMember:
            def __init__(self, name, status):
                self.name, self.status = name, status

        class FakeMembership:
            class memberlist:
                class config:
                    name = "self.global"

            def members(self):
                # both peers dead: removing both would leave a 1-node
                # "cluster" — only one removal keeps quorum semantics
                return [FakeMember("self.global", "alive"),
                        FakeMember("a.global", "dead"),
                        FakeMember("b.global", "dead")]

            def servers_in_region(self):
                return []

        class FakeServer:
            is_leader = True

            class fsm:
                class state:
                    autopilot_config_entry = None
                    latest_index = 0

            name = "self"

        raft = FakeRaft()
        ap = Autopilot(FakeServer(), membership=FakeMembership(), wire_raft=raft)
        removed = ap.prune_dead_servers()
        assert len(removed) == 1, "3-node cluster, quorum 2: only 1 removable"


class TestMonitorAndDebug:
    def test_monitor_tails_logs(self, agent):
        out = http(agent, "/v1/agent/monitor?log_level=warn")
        seq = out["Seq"]
        logging.getLogger("nomad_tpu_torch.test").warning("monitor-probe-123")
        wait_until(
            lambda: any("monitor-probe-123" in l for l in http(
                agent, f"/v1/agent/monitor?log_level=warn&seq={seq}")["Lines"]),
            msg="log line visible in monitor",
        )
        # polling from the returned seq doesn't replay old lines
        out2 = http(agent, f"/v1/agent/monitor?log_level=warn&seq={seq}")
        out3 = http(agent, f"/v1/agent/monitor?log_level=warn&seq={out2['Seq']}")
        assert not any("monitor-probe-123" in l for l in out3["Lines"])

    def test_pprof_threads_and_heap(self, agent):
        dump = http(agent, "/v1/agent/pprof?type=threads", raw=True)
        assert b"--- thread" in dump and b"MainThread" in dump
        heap = http(agent, "/v1/agent/pprof?type=heap")
        assert heap["TotalObjects"] > 0 and heap["TopTypes"]

    def test_pprof_gated(self):
        a = Agent(AgentConfig(device="cpu", name="nodebug", gossip_enabled=False,
                              num_schedulers=0)).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                http(a, "/v1/agent/pprof?type=threads", raw=True)
            assert e.value.code == 404
        finally:
            a.shutdown()
