"""Node drainer: migrates allocations off draining nodes.

Fills the role of reference ``nomad/drainer/`` (drainer.go:130 NodeDrainer,
watch_jobs.go per-job drain batching, watch_nodes.go:19, drain_heap.go
deadline heap). Same reshaping as the deployment watcher: instead of
per-node/per-job goroutines plus a deadline heap, one thread wakes on every
state bump (and on a short interval for wall-clock deadlines) and computes
every draining node's next action in a single pass.

Reference semantics reproduced:
- service allocs drain in batches of the task group's ``migrate.max_parallel``,
  waiting for replacements to come up before draining more
  (watch_jobs.go handleTaskGroup); migration rides
  ``DesiredTransition{migrate=True}`` raft ops + an eval, and the generic
  reconciler does the actual stop+place (reconcile_util filter_by_tainted).
- batch allocs are left to finish until the drain deadline
  (drainer.go: batch jobs on draining nodes cut off only at deadline).
- system allocs drain only after everything else is off the node, unless
  ``ignore_system_jobs`` (drainer.go handleDeadlinedNodes / system handling).
- at ``force_deadline_ns`` everything remaining is migrated at once
  (drainer.go:243 handleDeadlinedNodes).
- when nothing drainable remains the drain is marked complete with the node
  left ineligible (watch_nodes.go deregister + batch drain-complete raft op).

Copied from ``nomad_tpu/server/drainer.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs.structs import (
    ALLOC_CLIENT_RUNNING,
    ALLOC_DESIRED_RUN,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_NODE_DRAIN,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    Allocation,
    DesiredTransition,
    Evaluation,
    Node,
)
from ..utils.lock_witness import witness_lock


class NodeDrainer:
    """Leader-only drain driver."""

    def __init__(self, server, poll_interval: float = 1.0) -> None:
        self.server = server
        self.poll_interval = poll_interval
        self.logger = logging.getLogger("nomad_tpu_torch.drainer")
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        self._generation = 0
        self._lock = witness_lock("drainer.NodeDrainer._lock")

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            self._generation += 1
            gen = self._generation
        if enabled:
            t = threading.Thread(target=self._run, args=(gen,), name="drainer", daemon=True)
            self._thread = t
            t.start()

    def _run(self, gen: int) -> None:
        state = self.server.fsm.state
        last_index = 0
        while True:
            with self._lock:
                if not self._enabled or self._generation != gen:
                    return
            try:
                self.tick()
            except Exception:  # noqa: BLE001
                self.logger.exception("drainer tick failed")
            _, last_index = state.blocking_query(
                lambda s: None, last_index, timeout=self.poll_interval
            )

    # ------------------------------------------------------------------

    def tick(self, now_ns: Optional[int] = None) -> None:
        now_ns = now_ns if now_ns is not None else time.time_ns()
        state = self.server.fsm.state
        draining = [n for n in state.nodes() if n.drain and n.drain_strategy is not None]
        if not draining:
            return

        to_migrate: List[Allocation] = []
        drain_complete: Dict[str, Tuple[None, bool]] = {}
        # service allocs pool across ALL draining nodes, so max_parallel is
        # a per-task-group budget, not per-node (two draining nodes holding
        # the same group must share one batch)
        service_pool: Dict[Tuple[str, str, str], List[Allocation]] = {}
        for node in draining:
            migrate, service, complete = self._handle_node(state, node, now_ns)
            to_migrate.extend(migrate)
            for a in service:
                service_pool.setdefault((a.namespace, a.job_id, a.task_group), []).append(a)
            if complete:
                drain_complete[node.id] = (None, False)  # stay ineligible

        # force-marked allocs aren't in state yet this tick; the batch
        # calculation must still see them as unavailable
        force_marked_ids = {a.id for a in to_migrate}
        for (namespace, job_id, tg_name), group in service_pool.items():
            to_migrate.extend(
                self._drain_batch_for_group(
                    state, namespace, job_id, tg_name, group, force_marked_ids
                )
            )

        if to_migrate:
            self._apply_migrations(state, to_migrate)
        if drain_complete:
            self.server.raft_apply("batch-node-update-drain", drain_complete)
            for node_id in drain_complete:
                self.logger.info("node %s drain complete", node_id[:8])

    def _handle_node(
        self, state, node: Node, now_ns: int
    ) -> Tuple[List[Allocation], List[Allocation], bool]:
        """Returns (allocs to migrate-mark now, service allocs for the
        cross-node batching pool, drain complete?)."""
        strategy = node.drain_strategy
        allocs = [
            a
            for a in state.allocs_by_node(node.id)
            if not a.terminal_status() and a.desired_status == ALLOC_DESIRED_RUN
        ]
        remaining = [a for a in allocs if not a.desired_transition.should_migrate()]

        def job_type(alloc: Allocation) -> str:
            job = alloc.job or state.job_by_id(alloc.namespace, alloc.job_id)
            return job.type if job is not None else JOB_TYPE_SERVICE

        system = [a for a in remaining if job_type(a) == JOB_TYPE_SYSTEM]
        batch = [a for a in remaining if job_type(a) == JOB_TYPE_BATCH]
        service = [a for a in remaining if job_type(a) == JOB_TYPE_SERVICE]

        forced = strategy.deadline_passed(now_ns)
        if forced:
            # deadline: everything left goes at once
            marked = service + batch + ([] if strategy.ignore_system_jobs else system)
            drainable_left = [a for a in allocs if a.desired_transition.should_migrate()]
            return marked, [], not marked and not drainable_left

        # pre-deadline: service allocs go to the shared batching pool; batch
        # allocs run to completion; system waits for the rest
        marked: List[Allocation] = []
        others_active = bool(service or batch) or any(
            a.desired_transition.should_migrate() and job_type(a) != JOB_TYPE_SYSTEM
            for a in allocs
        )
        if not others_active and system and not strategy.ignore_system_jobs:
            marked.extend(system)

        in_flight = [a for a in allocs if a.desired_transition.should_migrate()]
        ignored_system = system if strategy.ignore_system_jobs else []
        complete = (
            not marked
            and not in_flight
            and not service
            and not batch
            and len(system) == len(ignored_system)
        )
        return marked, service, complete

    def _drain_batch_for_group(
        self,
        state,
        namespace: str,
        job_id: str,
        tg_name: str,
        on_node: List[Allocation],
        force_marked_ids,
    ) -> List[Allocation]:
        """Pick the next drain batch for one task group: keep at least
        ``count - max_parallel`` healthy allocs at all times (reference
        watch_jobs.go handleTaskGroup threshold count). ``force_marked_ids``
        are allocs another node's passed deadline marked this same tick."""
        job = on_node[0].job or state.job_by_id(namespace, job_id)
        tg = job.lookup_task_group(tg_name) if job is not None else None
        if tg is None:
            return on_node  # job gone: nothing to protect
        max_parallel = tg.migrate.max_parallel if tg.migrate is not None else 1

        healthy = 0
        for a in state.allocs_by_job(namespace, job_id, False):
            if a.task_group != tg_name or a.terminal_status():
                continue
            if a.desired_transition.should_migrate() or a.id in force_marked_ids:
                continue  # scheduled to stop
            if a.client_status != ALLOC_CLIENT_RUNNING:
                continue  # replacement still coming up
            if a.deployment_status is not None and a.deployment_status.is_unhealthy():
                continue
            healthy += 1

        threshold = tg.count - max_parallel
        num_to_drain = healthy - threshold
        if num_to_drain <= 0:
            return []
        return on_node[:num_to_drain]

    def _apply_migrations(self, state, allocs: List[Allocation]) -> None:
        """Raft-apply migrate transitions + one drain eval per job
        (reference drainer.go:357 batchDrainAllocs / drainer_util.go)."""
        transitions = {a.id: DesiredTransition(migrate=True) for a in allocs}
        evals: List[Evaluation] = []
        seen = set()
        for a in allocs:
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = a.job or state.job_by_id(a.namespace, a.job_id)
            ev = Evaluation(
                namespace=a.namespace,
                priority=job.priority if job is not None else 50,
                type=job.type if job is not None else JOB_TYPE_SERVICE,
                triggered_by=EVAL_TRIGGER_NODE_DRAIN,
                job_id=a.job_id,
                status=EVAL_STATUS_PENDING,
            )
            ev.update_modify_time()
            evals.append(ev)
        self.server.raft_apply(
            "alloc-update-desired-transition", (transitions, evals)
        )
