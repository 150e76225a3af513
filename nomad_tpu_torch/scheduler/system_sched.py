"""SystemScheduler: one alloc per eligible node.

Semantics follow reference ``scheduler/system_sched.go`` — Process :54,
computeJobAllocs :183, computePlacements :268, addBlocked :406.

Copied from ``nomad_tpu/scheduler/system_sched.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. One
addition: the ``device`` attribute, which the port's engine runs on.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..structs.funcs import filter_terminal_allocs
from ..structs.structs import (
    ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    EVAL_TRIGGER_ALLOC_STOP,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_PREEMPTION,
    EVAL_TRIGGER_QUEUED_ALLOCS,
    EVAL_TRIGGER_ROLLING_UPDATE,
    AllocMetric,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    Evaluation,
    Node,
)
from .context import EvalContext
from .stack import SystemStack
from .util import (
    ALLOC_LOST,
    ALLOC_NODE_TAINTED,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    SetStatusError,
    adjust_queued_allocations,
    desired_updates,
    diff_system_allocs,
    evict_and_place,
    inplace_update,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5

_VALID_TRIGGERS = {
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_ROLLING_UPDATE,
    EVAL_TRIGGER_PREEMPTION,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_ALLOC_STOP,
    EVAL_TRIGGER_QUEUED_ALLOCS,
}


class SystemScheduler:
    def __init__(self, logger, state, planner, deterministic: bool = False) -> None:
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler.system")
        self.state = state
        self.planner = planner
        self.deterministic = deterministic
        # torch device of the placement engine (tpu/integration.py):
        # CUDA unless the caller asks for the CPU
        self.device = "cuda"

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.nodes: List[Node] = []
        self.nodes_by_dc: Dict[str, int] = {}
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, AllocMetric]] = None
        self.queued_allocs: Dict[str, int] = {}

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation

        if evaluation.triggered_by not in _VALID_TRIGGERS:
            desc = f"scheduler cannot handle '{evaluation.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, EVAL_STATUS_FAILED, desc, self.queued_allocs, "",
            )
            return

        try:
            retry_max(
                MAX_SYSTEM_SCHEDULE_ATTEMPTS, self._process,
                lambda: progress_made(self.plan_result),
            )
        except SetStatusError as err:
            set_status(
                self.logger, self.planner, self.eval, self.next_eval, None,
                self.failed_tg_allocs, err.eval_status, str(err), self.queued_allocs, "",
            )
            return

        set_status(
            self.logger, self.planner, self.eval, self.next_eval, None,
            self.failed_tg_allocs, EVAL_STATUS_COMPLETE, "", self.queued_allocs, "",
        )

    def _process(self) -> bool:
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)
        self.queued_allocs = {}

        if self.job is not None and not self.job.stopped():
            self.nodes, self.nodes_by_dc = ready_nodes_in_dcs(
                self.state, self.job.datacenters
            )

        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = None
        self.ctx = EvalContext(self.state, self.plan, self.logger,
                               deterministic=self.deterministic)
        self.stack = SystemStack(self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if self.plan.is_noop() and not self.eval.annotate_plan:
            return True

        if self.limit_reached and self.next_eval is None:
            stagger = self.job.update.stagger_ns if self.job.update else 0
            self.next_eval = self.eval.next_rolling_eval(stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(self.logger, result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, _, _ = result.full_commit(self.plan)
        if not full_commit:
            return False
        return True

    def _compute_job_allocs(self) -> None:
        allocs = self.state.allocs_by_job(self.eval.namespace, self.eval.job_id, True)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        allocs, terminal_allocs = filter_terminal_allocs(allocs)
        diff = diff_system_allocs(self.job, self.nodes, tainted, allocs, terminal_allocs)

        for e in diff.stop:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_NOT_NEEDED, "")
        for e in diff.migrate:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_NODE_TAINTED, "")
        for e in diff.lost:
            self.plan.append_stopped_alloc(e.alloc, ALLOC_LOST, ALLOC_CLIENT_LOST)

        destructive_updates, inplace_updates = inplace_update(
            self.ctx, self.eval, self.job, self.stack, diff.update
        )
        diff.update = destructive_updates

        if self.eval.annotate_plan:
            from ..structs.structs import PlanAnnotations

            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=desired_updates(diff, inplace_updates, destructive_updates)
            )

        limit = [len(diff.update)]
        if self.job is not None and not self.job.stopped() and self.job.update is not None \
                and self.job.update.rolling():
            limit = [self.job.update.max_parallel]

        self.limit_reached = evict_and_place(self.ctx, diff, diff.update, ALLOC_UPDATING, limit)

        if not diff.place:
            if self.job is not None and not self.job.stopped():
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return

        for tup in diff.place:
            self.queued_allocs[tup.task_group.name] = (
                self.queued_allocs.get(tup.task_group.name, 0) + 1
            )

        self._compute_placements(diff.place)

    def _compute_placements(self, place) -> None:
        # tpu_binpack: one dense forced-node pass over the whole placement
        # list (the system analog of the generic engine path). The host
        # loop below remains the semantically complete fallback (and the
        # preemption path).
        from ..structs.structs import (
            SCHED_ALG_TPU_BINPACK,
            SCHED_ALG_TPU_BINPACK_CHUNKED,
        )

        _, sched_config = self.state.scheduler_config()
        # the chunked tier only changes the generic scheduler's scan; the
        # system forced-node pass is already one dense dispatch and stays
        # on the bit-parity kernel under either algorithm
        if sched_config is not None and sched_config.scheduler_algorithm in (
            SCHED_ALG_TPU_BINPACK,
            SCHED_ALG_TPU_BINPACK_CHUNKED,
        ):
            from ..tpu.integration import compute_system_placements_with_engine

            from ..trace import lifecycle as _trace_lc

            res = compute_system_placements_with_engine(self, place, sched_config)
            if res is True:
                _trace_lc.set_path(self.eval.id, "device")
                # device-built system plan: async-pipeline eligible (the
                # applier's eligibility shape-check still excludes plans
                # carrying stops/preemptions)
                self.plan.async_ok = True
                return
            if isinstance(res, list):
                # the device committed every clean placement; only the
                # preemption-needing nodes fall through to the host
                # per-node stack below (BinPackIterator evict path)
                place = res

        from ..trace import lifecycle as _trace_lc
        from ..utils import phases as _phases

        _trace_lc.set_path(self.eval.id, "host")
        with _phases.track("place"):
            self._host_placement_loop(place)

    def _host_placement_loop(self, place) -> None:
        node_by_id = {node.id: node for node in self.nodes}

        for missing in place:
            node = node_by_id.get(missing.alloc.node_id)
            if node is None:
                raise KeyError(f"could not find node {missing.alloc.node_id!r}")

            self.stack.set_nodes([node])
            option = self.stack.select(missing.task_group, None)

            if option is None:
                if self.ctx.metrics.nodes_filtered > 0:
                    # Constraint mismatch on this node: not a failure, the node
                    # just isn't in the job's domain.
                    self.queued_allocs[missing.task_group.name] -= 1
                    if (
                        self.eval.annotate_plan
                        and self.plan.annotations is not None
                        and missing.task_group.name in self.plan.annotations.desired_tg_updates
                    ):
                        self.plan.annotations.desired_tg_updates[
                            missing.task_group.name
                        ].place -= 1
                    continue

                if self.failed_tg_allocs and missing.task_group.name in self.failed_tg_allocs:
                    self.failed_tg_allocs[missing.task_group.name].coalesced_failures += 1
                    continue

                self.ctx.metrics.nodes_available = self.nodes_by_dc
                self.ctx.metrics.populate_score_meta_data()
                if self.failed_tg_allocs is None:
                    self.failed_tg_allocs = {}
                self.failed_tg_allocs[missing.task_group.name] = self.ctx.metrics
                self._add_blocked(node)
                continue

            self.ctx.metrics.nodes_available = self.nodes_by_dc
            self.ctx.metrics.populate_score_meta_data()

            resources = AllocatedResources(
                tasks=dict(option.task_resources),
                shared=AllocatedSharedResources(
                    disk_mb=missing.task_group.ephemeral_disk.size_mb
                ),
            )
            if option.alloc_resources is not None:
                resources.shared.networks = option.alloc_resources.networks

            alloc = Allocation(
                namespace=self.job.namespace,
                eval_id=self.eval.id,
                name=missing.name,
                job_id=self.job.id,
                task_group=missing.task_group.name,
                metrics=self.ctx.metrics,
                node_id=option.node.id,
                node_name=option.node.name,
                allocated_resources=resources,
                desired_status=ALLOC_DESIRED_RUN,
                client_status=ALLOC_CLIENT_PENDING,
            )

            if missing.alloc is not None and missing.alloc.id:
                alloc.previous_allocation = missing.alloc.id

            if option.preempted_allocs is not None:
                preempted_ids = []
                for stop in option.preempted_allocs:
                    self.plan.append_preempted_alloc(stop, alloc.id)
                    preempted_ids.append(stop.id)
                alloc.preempted_allocations = preempted_ids

            self.plan.append_alloc(alloc)

    def _add_blocked(self, node: Node) -> None:
        e = self.ctx.get_eligibility()
        escaped = e.has_escaped()
        class_eligibility = None if escaped else e.get_classes()
        blocked = self.eval.create_blocked_eval(class_eligibility, escaped, e.quota_limit_reached())
        blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        blocked.node_id = node.id
        self.planner.create_eval(blocked)


def new_system_scheduler(logger, state, planner):
    return SystemScheduler(logger, state, planner)
