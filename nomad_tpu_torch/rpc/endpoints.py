"""RPC endpoint surface: binds a Server to the transport.

Fills the role of the reference's ``nomad/*_endpoint.go`` files — one
registry entry per noun (server.go:236 ``endpoints`` struct), method names
matching the reference RPC names ("Node.Register", "Job.Register",
"Eval.Dequeue"...). ``RemoteServerProxy`` is the client-side counterpart
the agent dials (client/rpc.go), satisfying the same interface as the
in-process ``ServerProxy``.

Copied from ``nomad_tpu/rpc/endpoints.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change but this paragraph: every
endpoint binds to the port's ``Server``, whose placements run on its
``ServerConfig.device``.
"""
from __future__ import annotations

from typing import List, Optional

from ..structs.structs import Allocation, Job, Node
from ..trace import context as xtrace
from ..watch.blocking import blocking_read
from ..watch.stale import read_meta
from . import transport
from .transport import RPCClient, RPCServer


def bind_server(server, rpc: RPCServer) -> None:
    """Register every server endpoint on the transport."""

    def state():
        # resolved per-call, never captured: fsm.restore() (snapshot
        # install on a rejoining replica) REPLACES server.fsm.state, and
        # endpoints bound to the old store would answer from pre-restore
        # state forever (empty, on a crash-restarted follower)
        return server.fsm.state

    def serve_read(table, run, query_opts, key=None):
        """The one funnel every read endpoint routes through
        (lint: blocking-read-discipline). Without ``query_opts`` the
        response is the legacy bare result — old callers are untouched.
        With a QueryOptions the read gets reference blocking semantics
        (min_query_index park on the watch hub, max_query_time deadline)
        and returns ``[result, QueryMeta]`` with the index stamped under
        the same lock hold as the query."""
        if query_opts is None:
            return run(state())
        return blocking_read(
            state, server.watch_hub, run, table, query_opts, key=key,
            meta=read_meta(server, rpc),
        )

    # -- Status --------------------------------------------------------
    rpc.register("Status.ping", lambda: "pong")
    rpc.register("Status.leader", lambda: list(rpc.leader_addr or rpc.addr))

    # -- Node ----------------------------------------------------------
    rpc.register("Node.Register", server.register_node)
    rpc.register("Node.Deregister", server.deregister_node)
    rpc.register("Node.Heartbeat", server.heartbeat)
    rpc.register("Node.UpdateStatus", server.update_node_status)
    rpc.register("Node.UpdateDrain", server.update_node_drain)
    rpc.register("Node.UpdateEligibility", server.update_node_eligibility)
    rpc.register("Node.UpdateAlloc", server.update_allocs_from_client)
    rpc.register(
        "Node.List",
        lambda query_opts=None: serve_read(
            "nodes",
            lambda s: [n.without_secret() for n in s.nodes()],
            query_opts,
        ),
    )
    rpc.register(
        "Node.GetNode",
        lambda node_id, query_opts=None: serve_read(
            "nodes",
            lambda s: (lambda n: n.without_secret() if n else None)(
                s.node_by_id(node_id)
            ),
            query_opts, key=node_id,
        ),
    )

    def get_client_allocs(node_id: str, min_index: int, timeout: float):
        def run(s):
            out = []
            for a in s.allocs_by_node(node_id):
                if a.job is None:
                    a = a.copy_skip_job()
                    a.job = s.job_by_id(a.namespace, a.job_id)
                out.append(a)
            return out

        allocs, index = state().blocking_query(run, min_index, timeout=timeout)
        return [allocs, index]

    # blocking-read-waiver: pre-watch long-poll protocol — carries its own
    # min_index/timeout args through StateStore.blocking_query, and the
    # client agents' pull loop depends on the bare [allocs, index] shape
    rpc.register("Node.GetClientAllocs", get_client_allocs)
    rpc.register("Node.DeriveVaultToken", server.derive_vault_token)

    # -- Job -----------------------------------------------------------
    rpc.register("Job.Register", server.register_job)
    rpc.register("Job.Deregister", server.deregister_job)
    rpc.register(
        "Job.GetJob",
        lambda ns, job_id, query_opts=None: serve_read(
            "jobs", lambda s: s.job_by_id(ns, job_id),
            query_opts, key=(ns, job_id),
        ),
    )
    rpc.register(
        "Job.List",
        lambda query_opts=None: serve_read(
            "jobs", lambda s: s.jobs(), query_opts,
        ),
    )
    rpc.register(
        "Job.Allocations",
        lambda ns, job_id, query_opts=None: serve_read(
            "allocs", lambda s: s.allocs_by_job(ns, job_id, True), query_opts,
        ),
    )
    rpc.register(
        "Job.Evaluations",
        lambda ns, job_id, query_opts=None: serve_read(
            "evals", lambda s: s.evals_by_job(ns, job_id), query_opts,
        ),
    )
    rpc.register(
        "Job.GetJobVersions",
        lambda ns, job_id, query_opts=None: serve_read(
            "jobs", lambda s: s.job_versions.get((ns, job_id), []),
            query_opts, key=(ns, job_id),
        ),
    )
    rpc.register(
        "Job.Summary",
        lambda ns, job_id, query_opts=None: serve_read(
            # summaries are alloc-status rollups: the allocs table is
            # what moves them, so that's the watched table
            "allocs", lambda s: s.job_summary(ns, job_id), query_opts,
        ),
    )
    # write endpoints the HTTP agent reaches through leader_forward when
    # serving on a follower (reference job_endpoint.go Evaluate/Dispatch/
    # Revert/Stable, alloc_endpoint.go Stop, node_endpoint.go Evaluate,
    # core GC trigger)
    rpc.register("Job.Evaluate", server.evaluate_job)
    rpc.register("Job.Dispatch", server.dispatch_job)
    rpc.register("Job.Revert", server.revert_job)
    rpc.register("Job.Stability", server.set_job_stability)
    rpc.register("Alloc.Stop", server.stop_alloc)
    rpc.register("Node.Evaluate", server.create_node_evals)
    rpc.register("System.GC", server.force_gc)

    # -- Eval ----------------------------------------------------------
    rpc.register(
        "Eval.GetEval",
        lambda eval_id, query_opts=None: serve_read(
            "evals", lambda s: s.eval_by_id(eval_id), query_opts, key=eval_id,
        ),
    )
    rpc.register(
        "Eval.List",
        lambda query_opts=None: serve_read(
            "evals", lambda s: s.evals(), query_opts,
        ),
    )
    rpc.register(
        "Eval.Allocations",
        lambda eval_id, query_opts=None: serve_read(
            "allocs", lambda s: s.allocs_by_eval(eval_id), query_opts,
        ),
    )

    # -- worker protocol (follower workers dequeue from the leader's
    #    broker and submit plans to its queue: worker.go:161 Eval.Dequeue,
    #    :277 Plan.Submit — the reference's horizontal scheduler scaling)
    def eval_dequeue(schedulers, timeout: float):
        ev, token = server.eval_broker.dequeue(schedulers, timeout=min(timeout, 2.0))
        return [ev, token or ""]

    rpc.register("Eval.Dequeue", eval_dequeue)
    rpc.register("Eval.Ack", server.eval_broker.ack)
    rpc.register("Eval.Nack", server.eval_broker.nack)

    def eval_update(evals):
        return server.raft_apply("eval-update", evals)[0]

    rpc.register("Eval.Update", eval_update)

    def eval_reblock(evaluation, token: str):
        if server.eval_broker.outstanding(evaluation.id) != token:
            raise ValueError(f"eval {evaluation.id} token mismatch")
        server.raft_apply("eval-update", [evaluation])
        server.blocked_evals.reblock(evaluation, token)

    rpc.register("Eval.Reblock", eval_reblock)

    def plan_submit(plan):
        # pause the nack timer while the plan waits in the queue, exactly
        # as the colocated worker does (worker.go:277)
        server.eval_broker.pause_nack_timeout(plan.eval_id, plan.eval_token)
        try:
            pending = server.plan_queue.enqueue(plan)
            return pending.future.result(timeout=60)
        finally:
            try:
                server.eval_broker.resume_nack_timeout(plan.eval_id, plan.eval_token)
            except Exception:  # noqa: BLE001 — eval may have been acked
                pass

    rpc.register("Plan.Submit", plan_submit)

    # -- Alloc ---------------------------------------------------------
    rpc.register(
        "Alloc.GetAlloc",
        lambda alloc_id, query_opts=None: serve_read(
            "allocs", lambda s: s.alloc_by_id(alloc_id),
            query_opts, key=alloc_id,
        ),
    )
    rpc.register(
        "Alloc.List",
        lambda query_opts=None: serve_read(
            "allocs", lambda s: s.allocs(), query_opts,
        ),
    )

    # -- Deployment ----------------------------------------------------
    dw = server.deployment_watcher
    rpc.register(
        "Deployment.List",
        lambda query_opts=None: serve_read(
            "deployments", lambda s: s.deployments(), query_opts,
        ),
    )
    rpc.register(
        "Deployment.GetDeployment",
        lambda deployment_id, query_opts=None: serve_read(
            "deployments", lambda s: s.deployment_by_id(deployment_id),
            query_opts, key=deployment_id,
        ),
    )
    rpc.register("Deployment.Promote", dw.promote)
    rpc.register("Deployment.Pause", dw.pause)
    rpc.register("Deployment.Fail", dw.fail)
    rpc.register("Deployment.SetAllocHealth", dw.set_alloc_health)

    # -- Periodic ------------------------------------------------------
    rpc.register("Periodic.Force", server.periodic_dispatcher.force_launch)

    # -- ACL federation (leader.go:997/:1138 replication source) -------
    # blocking-read-waiver: cross-region replication pull with its own
    # cursor protocol; replicators poll, they never park
    rpc.register("ACL.ListReplication", server.list_acl_for_replication)

    # -- Operator ------------------------------------------------------
    def scheduler_get_config():
        index, config = state().scheduler_config()
        return [index, config]

    rpc.register("Operator.SchedulerGetConfiguration", scheduler_get_config)
    rpc.register(
        "Operator.SchedulerSetConfiguration",
        lambda config: server.raft_apply("scheduler-config", config)[0],
    )
    # raft introspection + snapshot trigger (operator_endpoint.go
    # RaftGetConfiguration / the `nomad operator snapshot save` surface).
    # Callers probing a SPECIFIC replica (the chaos crash harness polling
    # each survivor for leadership/catch-up) must pass no_forward=True,
    # or leader forwarding answers for the wrong node.
    rpc.register("Operator.RaftStats",
                 lambda: server.raft.stats(server.peer))
    rpc.register("Operator.SnapshotSave",
                 lambda: server.raft.snapshot(server.peer))
    rpc.register("Eval.BrokerStats", server.eval_broker.stats)

    # -- Trace (nomad-xtrace collector surface) ------------------------
    # Drains THIS replica's span ring + per-method RPC table. Collectors
    # keep a per-replica ``after_seq`` cursor (the returned ``next_seq``)
    # so repeated drains are incremental and idempotent — and like
    # RaftStats they must pass no_forward=True, or leader forwarding
    # exports the wrong node's ring.
    def trace_export(after_seq: int = 0):
        out = xtrace.export(after_seq=after_seq)
        out["rpc"] = transport.rpc_stats(wire=True)
        return out

    rpc.register("Trace.Export", trace_export)

    # -- Watch (nomad-watch hub introspection) -------------------------
    # THIS replica's parked-watcher depth + wakeup/coalesce counters;
    # like RaftStats, probers of a specific replica pass no_forward=True
    rpc.register("Watch.Stats", server.watch_hub.stats)


class RemoteServerProxy:
    """Client-side server connection over the wire (client/rpc.go) —
    drop-in for the in-process ``client.ServerProxy``."""

    def __init__(self, host: str, port: int, tls=None) -> None:
        self.rpc = RPCClient(host, port, tls=tls)
        # a second connection so long-poll pulls don't block status syncs
        self.rpc_blocking = RPCClient(host, port, timeout=90.0, tls=tls)

    def register_node(self, node: Node) -> float:
        return self.rpc.call("Node.Register", node)

    def heartbeat(self, node_id: str) -> float:
        return self.rpc.call("Node.Heartbeat", node_id)

    def pull_allocs(self, node_id: str, min_index: int, timeout: float):
        allocs, index = self.rpc_blocking.call(
            "Node.GetClientAllocs", node_id, min_index, timeout
        )
        return allocs, index

    def update_allocs(self, allocs: List[Allocation]) -> None:
        self.rpc.call("Node.UpdateAlloc", allocs)

    def derive_vault_token(
        self, alloc_id: str, task_name: str, node_id: str = "", node_secret: str = ""
    ) -> str:
        tokens = self.rpc.call(
            "Node.DeriveVaultToken", alloc_id, [task_name], node_id, node_secret
        )
        return tokens[task_name]

    def alloc_info(self, alloc_id: str):
        alloc = self.rpc.call("Alloc.GetAlloc", alloc_id)
        if alloc is None:
            return None
        node = self.rpc.call("Node.GetNode", alloc.node_id)
        return {
            "client_status": alloc.client_status,
            "node_http_addr": node.http_addr if node is not None else "",
        }

    def close(self) -> None:
        self.rpc.close()
        self.rpc_blocking.close()
