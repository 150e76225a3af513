"""GenericScheduler: service and batch evaluation processing.

Semantics follow reference ``scheduler/generic_sched.go`` — Process :122,
process :212, computeJobAllocs :323, computePlacements :426,
findPreferredNode :630. The placement backend is pluggable: ``binpack``
walks the host iterator stack per placement; ``tpu_binpack`` batches all
placements for the eval through the JAX engine (nomad_tpu/tpu/engine.py).

Copied from ``nomad_tpu/scheduler/generic_sched.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. One
addition: the ``device`` attribute, which the port's engine runs on.
``from ..tpu.integration import ...`` resolves to the port's engine.
One change: the scheduler works on a copy of the job's latest
deployment, so recording a placed canary never writes into the state
store's own object (the reference appended to it, outside raft and on
the leader only, also for plans that never committed).
"""
from __future__ import annotations

import logging
import time as _time
from typing import Dict, List, Optional

from ..structs.structs import (
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    EVAL_TRIGGER_ALLOC_STOP,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_MAX_PLANS,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_PERIODIC_JOB,
    EVAL_TRIGGER_PREEMPTION,
    EVAL_TRIGGER_QUEUED_ALLOCS,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    EVAL_TRIGGER_ROLLING_UPDATE,
    SCHED_ALG_TPU_BINPACK,
    SCHED_ALG_TPU_BINPACK_CHUNKED,
    AllocMetric,
    AllocatedResources,
    AllocatedSharedResources,
    Allocation,
    Evaluation,
    Node,
    RescheduleEvent,
    RescheduleTracker,
    deployment_get_id,
)
from ..trace import lifecycle as _trace_lc
from .context import EvalContext
from .reconcile import AllocReconciler
from .reconcile_util import AllocPlaceResult
from .stack import GenericStack, SelectOptions
from .util import (
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    BLOCKED_EVAL_MAX_PLAN_DESC,
    MAX_PAST_RESCHEDULE_EVENTS,
    SetStatusError,
    adjust_queued_allocations,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    tasks_updated,
    update_non_terminal_allocs_to_lost,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

_VALID_TRIGGERS = {
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_NODE_DRAIN,
    EVAL_TRIGGER_NODE_UPDATE,
    EVAL_TRIGGER_ALLOC_STOP,
    EVAL_TRIGGER_ROLLING_UPDATE,
    EVAL_TRIGGER_QUEUED_ALLOCS,
    EVAL_TRIGGER_PERIODIC_JOB,
    EVAL_TRIGGER_MAX_PLANS,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    EVAL_TRIGGER_FAILED_FOLLOW_UP,
    EVAL_TRIGGER_PREEMPTION,
}


class GenericScheduler:
    def __init__(self, logger, state, planner, batch: bool,
                 deterministic: bool = False) -> None:
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler.generic")
        self.state = state
        self.planner = planner
        self.batch = batch
        self.deterministic = deterministic
        # torch device of the placement engine (tpu/integration.py):
        # "cuda" runs the CUDA kernel, "cpu" its plain PyTorch version
        self.device = "cuda"
        # per-eval candidate-ring seeding in deterministic mode (the
        # reference's shuffle analog; EvalContext.ring_seed). Off by
        # default so the parity harness keeps its fixed insertion-order
        # frame; the production server turns it on.
        self.ring_decorrelate = False
        # evals below this placement count skip the device and run the
        # host iterator stack (engine.compute_placements); 0 = always
        # device. Set by the production server.
        self.device_min_placements = 0

        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.followup_evals: List[Evaluation] = []
        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Optional[Dict[str, AllocMetric]] = None
        self.queued_allocs: Dict[str, int] = {}

    # ------------------------------------------------------------------

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation

        if evaluation.triggered_by not in _VALID_TRIGGERS:
            desc = f"scheduler cannot handle '{evaluation.triggered_by}' evaluation reason"
            set_status(
                self.logger, self.planner, self.eval, None, self.blocked,
                self.failed_tg_allocs, EVAL_STATUS_FAILED, desc, self.queued_allocs,
                deployment_get_id(self.deployment),
            )
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as err:
            # Max plan attempts: blocked eval so we retry when capacity frees.
            self._create_blocked_eval(plan_failure=True)
            set_status(
                self.logger, self.planner, self.eval, None, self.blocked,
                self.failed_tg_allocs, err.eval_status, str(err), self.queued_allocs,
                deployment_get_id(self.deployment),
            )
            return

        if self.eval.status == EVAL_STATUS_BLOCKED and self.failed_tg_allocs:
            e = self.ctx.get_eligibility()
            new_eval = self.eval.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            new_eval.quota_limit_reached = e.quota_limit_reached()
            self.planner.reblock_eval(new_eval)
            return

        set_status(
            self.logger, self.planner, self.eval, None, self.blocked,
            self.failed_tg_allocs, EVAL_STATUS_COMPLETE, "", self.queued_allocs,
            deployment_get_id(self.deployment),
        )

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        e = self.ctx.get_eligibility()
        escaped = e.has_escaped()
        class_eligibility = None if escaped else e.get_classes()
        self.blocked = self.eval.create_blocked_eval(
            class_eligibility, escaped, e.quota_limit_reached()
        )
        if plan_failure:
            self.blocked.triggered_by = EVAL_TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    # ------------------------------------------------------------------

    def _process(self) -> bool:
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)

        self.queued_allocs = {}
        self.followup_evals = []
        self.plan = self.eval.make_plan(self.job)

        if not self.batch:
            # a copy: placing a canary appends its id to the deployment's
            # placed_canaries below, and the stored deployment is the live
            # state store's object — appending to it would record, outside
            # raft and on the leader only, canaries whose plan may never
            # commit (the store appends each committed canary itself,
            # ``_update_deployment_placements``)
            self.deployment = self.state.latest_deployment_by_job_id(
                self.eval.namespace, self.eval.job_id
            )
            if self.deployment is not None:
                self.deployment = self.deployment.copy()

        self.failed_tg_allocs = None
        ring_seed = 0
        if self.deterministic and self.ring_decorrelate:
            import zlib

            ring_seed = zlib.crc32(self.eval.id.encode()) & 0x7FFFFFFF
        self.ctx = EvalContext(self.state, self.plan, self.logger,
                               deterministic=self.deterministic,
                               ring_seed=ring_seed)
        self.stack = GenericStack(self.batch, self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if (
            self.eval.status != EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_noop() and not self.eval.annotate_plan:
            return True

        for followup in self.followup_evals:
            followup.previous_eval = self.eval.id
            self.planner.create_eval(followup)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(self.logger, result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug(
                "plan didn't fully commit: attempted %d placed %d", expected, actual
            )
            # A partial commit without a state refresh means we'd retry
            # against the same stale data forever.
            raise RuntimeError("missing state refresh after partial commit")

        return True

    # ------------------------------------------------------------------

    def _compute_job_allocs(self) -> None:
        # reconcile tracked separately from placement: placement blocks
        # on the device dispatch and must not pollute host-phase shares.
        # The host-work semaphore parks excess worker threads (GIL
        # convoy guard — utils/hostwork.py); it is released before
        # placement, which may block on the batched device dispatch.
        from ..utils import phases as _phases
        from ..utils.hostwork import HOST_WORK_SEM

        with HOST_WORK_SEM:
            with _phases.track("reconcile"):
                results = self._reconcile_job_allocs()
        if results is not None:
            self._compute_placements(results.destructive_update, results.place)

    def _reconcile_job_allocs(self):
        allocs = self.state.allocs_by_job(self.eval.namespace, self.eval.job_id, True)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        reconciler = AllocReconciler(
            self.logger,
            self._generic_alloc_update_fn(),
            self.batch,
            self.eval.job_id,
            self.job,
            self.deployment,
            allocs,
            tainted,
            self.eval.id,
        )
        from ..utils import metrics as _metrics

        _t0 = _metrics.now()
        results = reconciler.compute()
        _metrics.measure_since("nomad.sched.reconcile", _t0)

        if self.eval.annotate_plan:
            from ..structs.structs import PlanAnnotations

            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates
            )

        self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates

        for evals in results.desired_followup_evals.values():
            self.followup_evals.extend(evals)

        if results.deployment is not None:
            self.deployment = results.deployment

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status
            )

        for update in results.inplace_update:
            if update.deployment_id != deployment_get_id(self.deployment):
                update.deployment_id = deployment_get_id(self.deployment)
                update.deployment_status = None
            self.plan.append_alloc(update)

        for update in results.attribute_updates.values():
            self.plan.append_alloc(update)

        if not results.place and not results.destructive_update:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return None

        for place in results.place:
            self.queued_allocs[place.task_group.name] = (
                self.queued_allocs.get(place.task_group.name, 0) + 1
            )
        for destructive in results.destructive_update:
            self.queued_allocs[destructive.place_task_group.name] = (
                self.queued_allocs.get(destructive.place_task_group.name, 0) + 1
            )

        return results

    # ------------------------------------------------------------------

    def _compute_placements(self, destructive: List, place: List) -> None:
        nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id

        self.stack.set_nodes(nodes)
        self._nodes_by_dc = by_dc

        # tpu_binpack: batch the whole placement list through one device scan.
        # tpu_binpack_chunked: same entry, but the engine may run the eval
        # through the chunked top-K throughput tier (sampled parity) when
        # it is chunk-eligible; ineligible evals — preempting, destructive,
        # int-mode — take the bit-parity scan exactly as tpu_binpack.
        _, sched_config = self.state.scheduler_config()
        if sched_config is not None and sched_config.scheduler_algorithm in (
            SCHED_ALG_TPU_BINPACK,
            SCHED_ALG_TPU_BINPACK_CHUNKED,
        ):
            from ..tpu.integration import compute_placements_with_engine

            self.chunked_tier = (
                sched_config.scheduler_algorithm == SCHED_ALG_TPU_BINPACK_CHUNKED
            )
            self.chunk_k = getattr(sched_config, "chunk_k", 128)
            self.parity_sample_rate = getattr(
                sched_config, "parity_sample_rate", 0.0
            )
            if compute_placements_with_engine(self, destructive, place) is True:
                _trace_lc.set_path(self.eval.id, "device")
                # device-built plan: eligible for the async eval-lifecycle
                # pipeline (the worker may hand commit + ack to the async
                # applier instead of blocking on the plan future)
                self.plan.async_ok = True
                return

        # falling through = the python iterator stack places this eval
        # (small-eval gate, unsupported features, or host algorithm)
        _trace_lc.set_path(self.eval.id, "host")

        from ..utils import phases as _phases

        with _phases.track("place"):
            self._host_placement_loop(destructive, place, by_dc,
                                      deployment_id)

    def _host_placement_loop(self, destructive: List, place: List,
                             by_dc, deployment_id: str) -> None:
        now = _time.time_ns()

        # Config-gated preemption for generic (service/batch) evals: the
        # same switch the device encode consults, so host fallback and
        # device scan agree on whether this eval may evict.
        from .preemption import preemption_enabled

        _, sched_config = self.state.scheduler_config()
        preempt = preemption_enabled(sched_config, self.job.type)

        # Destructive before place: their resources must be discounted first.
        for results in (destructive, place):
            for missing in results:
                tg = missing.get_task_group()

                if self.failed_tg_allocs and tg.name in self.failed_tg_allocs:
                    self.failed_tg_allocs[tg.name].coalesced_failures += 1
                    continue

                preferred_node = self._find_preferred_node(missing)

                stop_prev_alloc, stop_prev_alloc_desc = missing.stop_previous_alloc()
                prev_allocation = missing.get_previous_allocation()
                if stop_prev_alloc:
                    self.plan.append_stopped_alloc(prev_allocation, stop_prev_alloc_desc, "")

                select_options = get_select_options(
                    prev_allocation, preferred_node, preempt=preempt
                )
                option = self.select_next_option(tg, select_options)

                self.ctx.metrics.nodes_available = by_dc
                self.ctx.metrics.populate_score_meta_data()

                if option is not None:
                    resources = AllocatedResources(
                        tasks=dict(option.task_resources),
                        shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb),
                    )
                    if option.alloc_resources is not None:
                        resources.shared.networks = option.alloc_resources.networks

                    alloc = Allocation(
                        namespace=self.job.namespace,
                        eval_id=self.eval.id,
                        name=missing.get_name(),
                        job_id=self.job.id,
                        task_group=tg.name,
                        metrics=self.ctx.metrics,
                        node_id=option.node.id,
                        node_name=option.node.name,
                        deployment_id=deployment_id,
                        allocated_resources=resources,
                        desired_status=ALLOC_DESIRED_RUN,
                        client_status=ALLOC_CLIENT_PENDING,
                    )

                    if prev_allocation is not None:
                        alloc.previous_allocation = prev_allocation.id
                        if missing.is_rescheduling():
                            update_reschedule_tracker(alloc, prev_allocation, now)

                    if missing.is_canary() and self.deployment is not None:
                        state = self.deployment.task_groups.get(tg.name)
                        if state is not None:
                            state.placed_canaries.append(alloc.id)
                        from ..structs.structs import AllocDeploymentStatus

                        alloc.deployment_status = AllocDeploymentStatus(canary=True)

                    self._handle_preemptions(option, alloc, missing)
                    self.plan.append_alloc(alloc)
                else:
                    if self.failed_tg_allocs is None:
                        self.failed_tg_allocs = {}
                    self.failed_tg_allocs[tg.name] = self.ctx.metrics
                    if stop_prev_alloc:
                        self.plan.pop_update(prev_allocation)

    def select_next_option(self, tg, select_options: SelectOptions):
        """Host placement backend (subclass/monkeypatch point for tests)."""
        return self.stack.select(tg, select_options)

    def _handle_preemptions(self, option, alloc: Allocation, missing) -> None:
        if option.preempted_allocs is None:
            return
        preempted_ids = []
        for stop in option.preempted_allocs:
            self.plan.append_preempted_alloc(stop, alloc.id)
            preempted_ids.append(stop.id)
        alloc.preempted_allocations = preempted_ids

    def _find_preferred_node(self, place) -> Optional[Node]:
        prev = place.get_previous_allocation()
        if prev is not None and place.get_task_group().ephemeral_disk.sticky:
            preferred = self.state.node_by_id(prev.node_id)
            if preferred is not None and preferred.ready():
                return preferred
        return None

    def _generic_alloc_update_fn(self):
        """Reference util.go:944 genericAllocUpdateFn."""

        def update_fn(existing: Allocation, new_job, new_tg):
            if existing.job is not None and existing.job.job_modify_index == new_job.job_modify_index:
                return True, False, None
            if existing.job is None or tasks_updated(new_job, existing.job, new_tg.name):
                return False, True, None
            if existing.terminal_status():
                return True, False, None

            node = self.state.node_by_id(existing.node_id)
            if node is None:
                return False, True, None

            from .util import ALLOC_IN_PLACE

            self.stack.set_nodes([node])
            self.ctx.plan.append_stopped_alloc(existing, ALLOC_IN_PLACE, "")
            option = self.stack.select(new_tg, None)
            self.ctx.plan.pop_update(existing)

            if option is None:
                return False, True, None

            for task, resources in option.task_resources.items():
                networks = []
                if existing.allocated_resources is not None:
                    tr = existing.allocated_resources.tasks.get(task)
                    if tr is not None:
                        networks = tr.networks
                resources.networks = networks

            new_alloc = existing.copy_skip_job()
            new_alloc.eval_id = self.eval.id
            new_alloc.job = None
            new_alloc.allocated_resources = AllocatedResources(
                tasks=dict(option.task_resources),
                shared=AllocatedSharedResources(
                    disk_mb=new_tg.ephemeral_disk.size_mb,
                    networks=(
                        existing.allocated_resources.shared.networks
                        if existing.allocated_resources is not None
                        else []
                    ),
                ),
            )
            new_alloc.metrics = existing.metrics.copy() if existing.metrics else AllocMetric()
            return False, False, new_alloc

        return update_fn


def get_select_options(prev_allocation: Optional[Allocation], preferred_node,
                       preempt: bool = False) -> SelectOptions:
    options = SelectOptions(preempt=preempt)
    if prev_allocation is not None:
        penalty = set()
        if prev_allocation.client_status == ALLOC_CLIENT_FAILED:
            penalty.add(prev_allocation.node_id)
        if prev_allocation.reschedule_tracker is not None:
            for ev in prev_allocation.reschedule_tracker.events:
                penalty.add(ev.prev_node_id)
        options.penalty_node_ids = penalty
    if preferred_node is not None:
        options.preferred_nodes = [preferred_node]
    return options


def update_reschedule_tracker(alloc: Allocation, prev: Allocation, now_ns: int) -> None:
    """Carry over in-window reschedule events and append this one."""
    policy = prev.reschedule_policy()
    events: List[RescheduleEvent] = []
    if prev.reschedule_tracker is not None:
        interval = policy.interval_ns if policy else 0
        if policy is not None and policy.attempts > 0:
            for ev in prev.reschedule_tracker.events:
                if interval > 0 and now_ns - ev.reschedule_time_ns <= interval:
                    events.append(ev)
        else:
            events.extend(prev.reschedule_tracker.events[-MAX_PAST_RESCHEDULE_EVENTS:])
    next_delay = prev.next_delay_ns()
    events.append(
        RescheduleEvent(
            reschedule_time_ns=now_ns,
            prev_alloc_id=prev.id,
            prev_node_id=prev.node_id,
            delay_ns=next_delay,
        )
    )
    alloc.reschedule_tracker = RescheduleTracker(events=events)


def new_service_scheduler(logger, state, planner):
    return GenericScheduler(logger, state, planner, batch=False)


def new_batch_scheduler(logger, state, planner):
    return GenericScheduler(logger, state, planner, batch=True)
