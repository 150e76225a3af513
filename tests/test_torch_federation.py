"""Federation: cross-region ACL replication + per-call server failover.

Mirrors reference leader.go:997 replicateACLPolicies / :1138
replicateACLTokens (non-authoritative leaders mirror policies and GLOBAL
tokens from the authoritative region over cross-region RPC) and
client/servers/manager.go (every client RPC fails over across the full
server list).

The port's copy of ``tests/test_federation.py``: every agent and server
on the CPU (``device="cpu"``).
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.agent import Agent, AgentConfig
from nomad_tpu_torch.structs.acl import ACLPolicy, ACLToken


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


class TestACLReplication:
    def test_policies_and_global_tokens_mirror(self):
        """Policies and GLOBAL tokens written in the authoritative region
        appear in the other region; local tokens stay local; deletes
        propagate."""
        east = Agent(AgentConfig(device="cpu",
            name="east-1", region="east", authoritative_region="east",
            replication_token="repl-secret", num_schedulers=0,
        ))
        west = Agent(AgentConfig(device="cpu",
            name="west-1", region="west", authoritative_region="east",
            replication_token="repl-secret", acl_replication_interval=0.3,
            num_schedulers=0,
        ))
        try:
            east.start()
            west.config.retry_join = [
                "{}:{}".format(*east.membership.gossip_addr)
            ]
            west.start()
            wait_until(
                lambda: set(west.regions()) == {"east", "west"},
                msg="region map",
            )

            # authoritative writes
            east.server.upsert_acl_policies([ACLPolicy(
                name="readonly",
                rules='namespace "default" { policy = "read" }',
            )])
            global_tok = ACLToken(name="global-tok", type="client",
                                  policies=["readonly"], global_=True)
            local_tok = ACLToken(name="local-tok", type="client",
                                 policies=["readonly"], global_=False)
            east.server.upsert_acl_tokens([global_tok, local_tok])

            west_state = west.server.fsm.state
            wait_until(
                lambda: "readonly" in west_state.acl_policies_table,
                msg="policy replicated to west",
            )
            assert west_state.acl_policies_table["readonly"].rules
            wait_until(
                lambda: west_state.acl_token_by_accessor(global_tok.accessor_id)
                is not None,
                msg="global token replicated",
            )
            # the mirrored token keeps its secret (it must authenticate in
            # every region), the local token never crosses
            mirrored = west_state.acl_token_by_accessor(global_tok.accessor_id)
            assert mirrored.secret_id == global_tok.secret_id
            time.sleep(1.0)  # a few replication rounds
            assert west_state.acl_token_by_accessor(local_tok.accessor_id) is None

            # policy update propagates (content diff)
            east.server.upsert_acl_policies([ACLPolicy(
                name="readonly",
                rules='namespace "default" { policy = "write" }',
            )])
            wait_until(
                lambda: "write" in west_state.acl_policies_table["readonly"].rules,
                msg="policy update replicated",
            )

            # deletes propagate
            east.server.delete_acl_policies(["readonly"])
            east.server.delete_acl_tokens([global_tok.accessor_id])
            wait_until(
                lambda: "readonly" not in west_state.acl_policies_table,
                msg="policy delete replicated",
            )
            wait_until(
                lambda: west_state.acl_token_by_accessor(global_tok.accessor_id)
                is None,
                msg="token delete replicated",
            )
        finally:
            west.shutdown()
            east.shutdown()

    def test_replication_endpoint_requires_token(self):
        """Once tokens exist, the replication list RPC refuses callers
        without the replication/management token (token secrets cross this
        endpoint)."""
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(device="cpu",
            num_schedulers=0, replication_token="repl-secret",
        ))
        try:
            # before bootstrap: open (nothing secret yet)
            policies, tokens = server.list_acl_for_replication("")
            assert policies == [] and tokens == []
            mgmt = ACLToken(name="mgmt", type="management", global_=True)
            server.upsert_acl_tokens([mgmt])
            with pytest.raises(PermissionError):
                server.list_acl_for_replication("")
            with pytest.raises(PermissionError):
                server.list_acl_for_replication("wrong")
            # the replication token and a management secret both pass
            _, toks = server.list_acl_for_replication("repl-secret")
            assert len(toks) == 1
            _, toks = server.list_acl_for_replication(mgmt.secret_id)
            assert len(toks) == 1
        finally:
            server.stop()


class TestServerFailover:
    def test_client_rpc_fails_over_per_call(self):
        """A client agent keeps working when the server it is using dies:
        the next RPC rotates to a surviving server (client/servers)."""
        from nomad_tpu_torch.server.raft import InProcRaft
        from nomad_tpu_torch.server.server import Server, ServerConfig

        raft = InProcRaft()
        s1 = Server(ServerConfig(device="cpu", num_schedulers=0, heartbeat_min_ttl=3600,
                                 heartbeat_max_ttl=7200), raft=raft, name="s1")
        s2 = Server(ServerConfig(device="cpu", num_schedulers=0, heartbeat_min_ttl=3600,
                                 heartbeat_max_ttl=7200), raft=raft, name="s2")
        a1 = Agent(AgentConfig(device="cpu", name="fo-1", gossip_enabled=False), server=s1)
        a2 = Agent(AgentConfig(device="cpu", name="fo-2", gossip_enabled=False), server=s2)
        client_agent = None
        try:
            a1.start()
            a2.start()
            client_agent = Agent(AgentConfig(device="cpu",
                name="fo-client", server_enabled=False, client_enabled=True,
                gossip_enabled=False,
                servers=[
                    "{}:{}".format(*a1.rpc.addr),
                    "{}:{}".format(*a2.rpc.addr),
                ],
            ))
            client_agent.start()
            # generous: suite-context CPU contention (jax compiles on all
            # cores) can starve the register/retry threads for a while
            wait_until(lambda: len(s1.fsm.state.nodes()) == 1,
                       timeout=90, msg="node registered")
            node_id = client_agent.client.node.id

            # pin the client to the FOLLOWER (a2), then kill it: the next
            # RPC must rotate to the surviving leader (a1) — in-proc raft
            # writes only land on the leader, so survival proves rotation
            manager = client_agent.client.proxy.manager
            manager.set_servers([a2.rpc.addr, a1.rpc.addr])
            assert manager.current() == a2.rpc.addr
            a2.rpc.stop()

            # a write through the proxy fails over and succeeds end-to-end
            client_agent.client.proxy.heartbeat(node_id)
            assert manager.current() == a1.rpc.addr
            assert s1.fsm.state.node_by_id(node_id) is not None
        finally:
            if client_agent is not None:
                client_agent.shutdown()
            a2.shutdown()
            a1.shutdown()
