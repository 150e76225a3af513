"""``tests/test_wire_raft.py::TestAgentsOnWireRaft`` on the port: three
agents on wire raft (bootstrap through gossip, a write forwarded to the
leader and replicated), each agent on the CPU. The wire raft's own cases
are ported in ``tests/test_torch_wire.py``.
"""
import time

from nomad_tpu_torch import mock


def wait_until(fn, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class TestAgentsOnWireRaft:
    def test_three_agent_cluster_bootstrap_and_write(self):
        """Three full agents with gossip + wire raft: membership converges,
        raft bootstraps at expect=3, exactly one leader emerges, and a
        write through any agent's RPC lands on every FSM."""
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig
        from nomad_tpu_torch.rpc.transport import RPCClient
        from nomad_tpu_torch.server.wire_raft import WireRaftConfig

        agents = []
        try:
            for i in range(3):
                cfg = AgentConfig(device="cpu",
                    name=f"a{i}", server_enabled=True, wire_raft=True,
                    bootstrap_expect=3, num_schedulers=0,
                )
                a = Agent(cfg)
                # speed up elections for the test
                a.wire_raft.config = WireRaftConfig(
                    node_id=a.wire_raft.node_id,
                    election_timeout_min=0.15, election_timeout_max=0.3,
                    heartbeat_interval=0.03, rpc_timeout=0.5,
                )
                agents.append(a)
            agents[0].start()
            seed = "{}:{}".format(*agents[0].membership.gossip_addr)
            for a in agents[1:]:
                a.config.retry_join = [seed]
                a.start()
            wait_until(
                lambda: all(a._raft_started for a in agents),
                msg="raft bootstrap at expect=3",
            )
            wait_until(
                lambda: sum(1 for a in agents if a.server.is_leader) == 1,
                msg="single leader among agents",
            )
            # gossip leader tag → follower forwarding works
            leader = next(a for a in agents if a.server.is_leader)
            follower = next(a for a in agents if not a.server.is_leader)
            wait_until(
                lambda: follower.rpc.leader_addr == leader.rpc.addr,
                msg="leader tag propagated",
            )
            node = mock.node()
            cli = RPCClient(*follower.rpc.addr)
            cli.call("Node.Register", node)
            wait_until(
                lambda: all(
                    a.server.fsm.state.node_by_id(node.id) is not None
                    for a in agents
                ),
                msg="write replicated to every agent FSM",
            )
            cli.close()
        finally:
            for a in agents:
                a.shutdown()
