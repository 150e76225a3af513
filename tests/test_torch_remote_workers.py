"""Follower-worker tests (reference worker.go: schedulers run on every
server, dequeuing from the leader's broker over RPC).

The decisive setup: the LEADER runs zero workers — every placement must
have been computed by a follower's scheduler and submitted back over
Plan.Submit.

The port's copy of ``tests/test_remote_workers.py``: every agent and
server on the CPU (``device="cpu"``).
"""
import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.agent import Agent, AgentConfig
from nomad_tpu_torch.server.raft import InProcRaft
from nomad_tpu_torch.server.server import Server, ServerConfig


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class TestFollowerWorkers:
    def test_followers_schedule_for_an_idle_leader(self):
        raft = InProcRaft()
        leader = Server(
            ServerConfig(device="cpu", num_schedulers=0, deterministic=True,
                         heartbeat_min_ttl=600, heartbeat_max_ttl=600),
            raft=raft, name="lead",
        )
        follower = Server(
            ServerConfig(device="cpu", num_schedulers=2, deterministic=True),
            raft=raft, name="foll",
        )
        assert leader.is_leader and not follower.is_leader

        a_lead = Agent(AgentConfig(device="cpu", name="lead", num_schedulers=0), server=leader)
        a_foll = Agent(AgentConfig(device="cpu", name="foll", num_schedulers=2), server=follower)
        try:
            a_lead.start()
            a_foll.config.retry_join = [
                "{}:{}".format(*a_lead.membership.gossip_addr)
            ]
            a_foll.start()
            wait_until(lambda: a_foll.rpc.leader_addr == a_lead.rpc.addr,
                       msg="leader addr via gossip")

            leader.register_node(mock.node())
            leader.register_node(mock.node())
            job = mock.job()
            leader.register_job(job)
            wait_until(
                lambda: len(leader.fsm.state.allocs_by_job(
                    "default", job.id, True)) == 10,
                timeout=90, msg="placement by follower workers",
            )
            # the follower's workers did the scheduling (stats tick just
            # after the plan lands — poll, don't assert instantly)
            wait_until(
                lambda: sum(w.stats["evals_processed"] for w in follower.workers) >= 1
                and sum(w.stats["plans_submitted"] for w in follower.workers) >= 1,
                msg="follower worker stats",
            )
            assert sum(w.stats["evals_processed"] for w in leader.workers) == 0

            # blocked-eval flow still works through the remote path: fill
            # capacity, then free it
            big = mock.job()
            big.task_groups[0].count = 30  # exceeds remaining capacity
            leader.register_job(big)
            wait_until(
                lambda: leader.blocked_evals.stats()["total_blocked"] >= 1,
                timeout=60, msg="partial placement blocks",
            )
        finally:
            a_foll.shutdown()
            a_lead.shutdown()
