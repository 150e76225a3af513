"""The allocation reconciler: desired-vs-actual diff per task group.

Semantics follow reference ``scheduler/reconcile.go`` (allocReconciler :39,
Compute :184, computeGroup :306, computeLimit :618, computePlacements :662,
computeStop :699, computeUpdates :810, handleDelayedReschedules :833). Pure
host-side logic — no device work.

Copied from ``nomad_tpu/scheduler/reconcile.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. One
change: once a deployment's canaries are promoted, ``_compute_stop``
stops every older alloc that shares a canary's name, also when the group
is not over its count (the reference stopped only as many as the group
was over, so after an alloc was lost or preempted a destructive update
re-placed a canary's name a second time).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..structs.structs import (
    ALLOC_CLIENT_LOST,
    DEPLOYMENT_STATUS_CANCELLED,
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_RETRY_FAILED_ALLOC,
    Allocation,
    Deployment,
    DeploymentState,
    DeploymentStatusUpdate,
    DesiredUpdates,
    Evaluation,
    Job,
    Node,
    TaskGroup,
)
from .reconcile_util import (
    AllocDestructiveResult,
    AllocNameIndex,
    AllocPlaceResult,
    AllocSet,
    AllocStopResult,
    DelayedRescheduleInfo,
    alloc_index,
    filter_by_terminal,
    new_alloc_matrix,
)
from .util import (
    ALLOC_LOST,
    ALLOC_MIGRATING,
    ALLOC_NOT_NEEDED,
    ALLOC_RESCHEDULED,
    ALLOC_UPDATING,
    RESCHEDULING_FOLLOWUP_EVAL_DESC,
)

BATCHED_FAILED_ALLOC_WINDOW_NS = 5 * 10**9  # batch follow-up evals within 5s

# allocUpdateFn: (existing, new_job, new_tg) -> (ignore, destructive, updated)
AllocUpdateFn = Callable[
    [Allocation, Job, TaskGroup], Tuple[bool, bool, Optional[Allocation]]
]


@dataclass
class ReconcileResults:
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    place: List[AllocPlaceResult] = field(default_factory=list)
    destructive_update: List[AllocDestructiveResult] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    stop: List[AllocStopResult] = field(default_factory=list)
    attribute_updates: Dict[str, Allocation] = field(default_factory=dict)
    desired_tg_updates: Dict[str, DesiredUpdates] = field(default_factory=dict)
    desired_followup_evals: Dict[str, List[Evaluation]] = field(default_factory=dict)

    def changes(self) -> int:
        return len(self.place) + len(self.inplace_update) + len(self.stop)


def _update_is_empty(u) -> bool:
    return u is None or u.max_parallel == 0


def new_deployment(job: Job) -> Deployment:
    return Deployment(
        namespace=job.namespace,
        job_id=job.id,
        job_version=job.version,
        job_modify_index=job.job_modify_index,
        job_create_index=job.create_index,
        status="running",
        status_description="Deployment is running",
    )


class AllocReconciler:
    def __init__(
        self,
        logger,
        alloc_update_fn: AllocUpdateFn,
        batch: bool,
        job_id: str,
        job: Optional[Job],
        deployment: Optional[Deployment],
        existing_allocs: List[Allocation],
        tainted_nodes: Dict[str, Optional[Node]],
        eval_id: str,
        now_ns: Optional[int] = None,
    ) -> None:
        self.logger = logger
        self.alloc_update_fn = alloc_update_fn
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.old_deployment: Optional[Deployment] = None
        self.deployment = deployment.copy() if deployment is not None else None
        self.deployment_paused = False
        self.deployment_failed = False
        self.tainted_nodes = tainted_nodes
        self.existing_allocs = existing_allocs
        self.eval_id = eval_id
        self.now_ns = now_ns if now_ns is not None else _time.time_ns()
        self.result = ReconcileResults()

    # ------------------------------------------------------------------

    def compute(self) -> ReconcileResults:
        m = new_alloc_matrix(self.job, self.existing_allocs)

        self._cancel_deployments()

        if self.job is None or self.job.stopped():
            self._handle_stop(m)
            return self.result

        if self.deployment is not None:
            self.deployment_paused = self.deployment.status == DEPLOYMENT_STATUS_PAUSED
            self.deployment_failed = self.deployment.status == DEPLOYMENT_STATUS_FAILED

        complete = True
        for group, allocs in m.items():
            group_complete = self._compute_group(group, allocs)
            complete = complete and group_complete

        if self.deployment is not None and complete:
            self.result.deployment_updates.append(
                DeploymentStatusUpdate(
                    deployment_id=self.deployment.id,
                    status=DEPLOYMENT_STATUS_SUCCESSFUL,
                    status_description="Deployment completed successfully",
                )
            )

        d = self.result.deployment
        if d is not None and d.requires_promotion():
            # Auto-promotion only happens when EVERY group opts in
            # (reference Deployment.HasAutoPromote).
            auto = all(s.auto_promote for s in d.task_groups.values())
            d.status_description = (
                "Deployment is running pending automatic promotion"
                if auto
                else "Deployment is running but requires manual promotion"
            )

        return self.result

    # ------------------------------------------------------------------

    def _cancel_deployments(self) -> None:
        if self.job is None or self.job.stopped():
            if self.deployment is not None and self.deployment.active():
                self.result.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=self.deployment.id,
                        status=DEPLOYMENT_STATUS_CANCELLED,
                        status_description="Cancelled because job is stopped",
                    )
                )
            self.old_deployment = self.deployment
            self.deployment = None
            return

        d = self.deployment
        if d is None:
            return

        if d.job_create_index != self.job.create_index or d.job_version != self.job.version:
            if d.active():
                self.result.deployment_updates.append(
                    DeploymentStatusUpdate(
                        deployment_id=d.id,
                        status=DEPLOYMENT_STATUS_CANCELLED,
                        status_description="Cancelled due to newer version of job",
                    )
                )
            self.old_deployment = d
            self.deployment = None

        elif d.status == DEPLOYMENT_STATUS_SUCCESSFUL:
            self.old_deployment = d
            self.deployment = None

    def _handle_stop(self, m: Dict[str, AllocSet]) -> None:
        for group, allocs in m.items():
            allocs = filter_by_terminal(allocs)
            untainted, migrate, lost = allocs.filter_by_tainted(self.tainted_nodes)
            self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)
            desired = DesiredUpdates()
            desired.stop = len(allocs)
            self.result.desired_tg_updates[group] = desired

    def _mark_stop(self, allocs: AllocSet, client_status: str, status_description: str) -> None:
        for alloc in allocs.values():
            self.result.stop.append(
                AllocStopResult(
                    alloc=alloc,
                    client_status=client_status,
                    status_description=status_description,
                )
            )

    # ------------------------------------------------------------------

    def _compute_group(self, group: str, all_allocs: AllocSet) -> bool:
        desired_changes = DesiredUpdates()
        self.result.desired_tg_updates[group] = desired_changes

        tg = self.job.lookup_task_group(group)
        if tg is None:
            untainted, migrate, lost = all_allocs.filter_by_tainted(self.tainted_nodes)
            self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)
            desired_changes.stop = len(untainted) + len(migrate) + len(lost)
            return True

        dstate: Optional[DeploymentState] = None
        existing_deployment = False
        if self.deployment is not None:
            dstate = self.deployment.task_groups.get(group)
            existing_deployment = dstate is not None
        if not existing_deployment:
            dstate = DeploymentState()
            if not _update_is_empty(tg.update):
                dstate.auto_revert = tg.update.auto_revert
                dstate.auto_promote = tg.update.auto_promote
                dstate.progress_deadline_ns = tg.update.progress_deadline_ns

        all_allocs, ignore = self._filter_old_terminal_allocs(all_allocs)
        desired_changes.ignore += len(ignore)

        canaries, all_allocs = self._handle_group_canaries(all_allocs, desired_changes)

        untainted, migrate, lost = all_allocs.filter_by_tainted(self.tainted_nodes)

        untainted, reschedule_now, reschedule_later = untainted.filter_by_rescheduleable(
            self.batch, self.now_ns, self.eval_id, self.deployment
        )

        self._handle_delayed_reschedules(reschedule_later, all_allocs, tg.name)

        name_index = AllocNameIndex(
            self.job_id, group, tg.count, untainted.union(migrate, reschedule_now)
        )

        canary_state = dstate is not None and dstate.desired_canaries != 0 and not dstate.promoted
        stop = self._compute_stop(
            tg, name_index, untainted, migrate, lost, canaries, canary_state
        )
        desired_changes.stop += len(stop)
        untainted = untainted.difference(stop)

        ignore2, inplace, destructive = self._compute_updates(tg, untainted)
        desired_changes.ignore += len(ignore2)
        desired_changes.in_place_update += len(inplace)
        if not existing_deployment:
            dstate.desired_total += len(destructive) + len(inplace)

        if canary_state:
            untainted = untainted.difference(canaries)

        num_destructive = len(destructive)
        strategy = tg.update
        canaries_promoted = dstate is not None and dstate.promoted
        require_canary = (
            num_destructive != 0
            and strategy is not None
            and len(canaries) < strategy.canary
            and not canaries_promoted
        )
        if require_canary and not self.deployment_paused and not self.deployment_failed:
            number = strategy.canary - len(canaries)
            desired_changes.canary += number
            if not existing_deployment:
                dstate.desired_canaries = strategy.canary
            for name in name_index.next_canaries(number, canaries, destructive):
                self.result.place.append(
                    AllocPlaceResult(name=name, canary=True, task_group=tg)
                )

        canary_state = dstate is not None and dstate.desired_canaries != 0 and not dstate.promoted
        limit = self._compute_limit(tg, untainted, destructive, migrate, canary_state)

        place = self._compute_placements(tg, name_index, untainted, migrate, reschedule_now)
        if not existing_deployment:
            dstate.desired_total += len(place)

        deployment_place_ready = (
            not self.deployment_paused and not self.deployment_failed and not canary_state
        )

        if deployment_place_ready:
            desired_changes.place += len(place)
            self.result.place.extend(place)
            self._mark_stop(reschedule_now, "", ALLOC_RESCHEDULED)
            desired_changes.stop += len(reschedule_now)
            limit -= min(len(place), limit)
        else:
            if lost:
                allowed = min(len(lost), len(place))
                desired_changes.place += allowed
                self.result.place.extend(place[:allowed])
            if reschedule_now:
                for p in place:
                    prev = p.get_previous_allocation()
                    if p.is_rescheduling() and not (
                        self.deployment_failed
                        and prev is not None
                        and self.deployment is not None
                        and self.deployment.id == prev.deployment_id
                    ):
                        self.result.place.append(p)
                        desired_changes.place += 1
                        self.result.stop.append(
                            AllocStopResult(alloc=prev, status_description=ALLOC_RESCHEDULED)
                        )
                        desired_changes.stop += 1

        if deployment_place_ready:
            dmin = min(len(destructive), limit)
            desired_changes.destructive_update += dmin
            desired_changes.ignore += len(destructive) - dmin
            for alloc in destructive.name_order()[:dmin]:
                self.result.destructive_update.append(
                    AllocDestructiveResult(
                        place_name=alloc.name,
                        place_task_group=tg,
                        stop_alloc=alloc,
                        stop_status_description=ALLOC_UPDATING,
                    )
                )
        else:
            desired_changes.ignore += len(destructive)

        desired_changes.migrate += len(migrate)
        for alloc in migrate.name_order():
            self.result.stop.append(
                AllocStopResult(alloc=alloc, status_description=ALLOC_MIGRATING)
            )
            self.result.place.append(
                AllocPlaceResult(
                    name=alloc.name, canary=False, task_group=tg, previous_alloc=alloc
                )
            )

        updating_spec = len(destructive) != 0 or len(self.result.inplace_update) != 0
        had_running = any(
            alloc.job is not None
            and alloc.job.version == self.job.version
            and alloc.job.create_index == self.job.create_index
            for alloc in all_allocs.values()
        )

        if (
            not existing_deployment
            and not _update_is_empty(strategy)
            and dstate.desired_total != 0
            and (not had_running or updating_spec)
        ):
            if self.deployment is None:
                self.deployment = new_deployment(self.job)
                self.result.deployment = self.deployment
            self.deployment.task_groups[group] = dstate

        deployment_complete = (
            len(destructive)
            + len(inplace)
            + len(place)
            + len(migrate)
            + len(reschedule_now)
            + len(reschedule_later)
            == 0
            and not require_canary
        )

        if deployment_complete and self.deployment is not None:
            ds = self.deployment.task_groups.get(group)
            if ds is not None:
                if ds.healthy_allocs < max(ds.desired_total, ds.desired_canaries) or (
                    ds.desired_canaries > 0 and not ds.promoted
                ):
                    deployment_complete = False

        return deployment_complete

    # ------------------------------------------------------------------

    def _filter_old_terminal_allocs(self, all_allocs: AllocSet) -> Tuple[AllocSet, AllocSet]:
        if not self.batch:
            return all_allocs, AllocSet()
        filtered, ignored = AllocSet(), AllocSet()
        for aid, alloc in all_allocs.items():
            older = alloc.job is not None and (
                alloc.job.version < self.job.version
                or alloc.job.create_index < self.job.create_index
            )
            if older and alloc.terminal_status():
                ignored[aid] = alloc
            else:
                filtered[aid] = alloc
        return filtered, ignored

    def _handle_group_canaries(
        self, all_allocs: AllocSet, desired_changes: DesiredUpdates
    ) -> Tuple[AllocSet, AllocSet]:
        stop: List[str] = []
        if self.old_deployment is not None:
            for s in self.old_deployment.task_groups.values():
                if not s.promoted:
                    stop.extend(s.placed_canaries)
        if self.deployment is not None and self.deployment.status == DEPLOYMENT_STATUS_FAILED:
            for s in self.deployment.task_groups.values():
                if not s.promoted:
                    stop.extend(s.placed_canaries)

        stop_set = all_allocs.from_keys(stop)
        self._mark_stop(stop_set, "", ALLOC_NOT_NEEDED)
        desired_changes.stop += len(stop_set)
        all_allocs = all_allocs.difference(stop_set)

        canaries = AllocSet()
        if self.deployment is not None:
            canary_ids: List[str] = []
            for s in self.deployment.task_groups.values():
                canary_ids.extend(s.placed_canaries)
            canaries = all_allocs.from_keys(canary_ids)
            untainted, migrate, lost = canaries.filter_by_tainted(self.tainted_nodes)
            self._mark_stop(migrate, "", ALLOC_MIGRATING)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)
            canaries = untainted
            all_allocs = all_allocs.difference(migrate, lost)

        return canaries, all_allocs

    def _compute_limit(
        self,
        group: TaskGroup,
        untainted: AllocSet,
        destructive: AllocSet,
        migrate: AllocSet,
        canary_state: bool,
    ) -> int:
        if _update_is_empty(group.update) or len(destructive) + len(migrate) == 0:
            return group.count
        if self.deployment_paused or self.deployment_failed:
            return 0
        if canary_state:
            return 0
        limit = group.update.max_parallel
        if self.deployment is not None:
            part_of, _ = untainted.filter_by_deployment(self.deployment.id)
            for alloc in part_of.values():
                if alloc.deployment_status is not None and alloc.deployment_status.is_unhealthy():
                    return 0
                if alloc.deployment_status is None or not alloc.deployment_status.is_healthy():
                    limit -= 1
        return max(limit, 0)

    def _compute_placements(
        self,
        group: TaskGroup,
        name_index: AllocNameIndex,
        untainted: AllocSet,
        migrate: AllocSet,
        reschedule: AllocSet,
    ) -> List[AllocPlaceResult]:
        place: List[AllocPlaceResult] = []
        for alloc in reschedule.values():
            place.append(
                AllocPlaceResult(
                    name=alloc.name,
                    task_group=group,
                    previous_alloc=alloc,
                    reschedule=True,
                    canary=alloc.deployment_status is not None
                    and alloc.deployment_status.canary,
                )
            )
        existing = len(untainted) + len(migrate) + len(reschedule)
        if existing < group.count:
            for name in name_index.next(group.count - existing):
                place.append(AllocPlaceResult(name=name, task_group=group))
        return place

    def _compute_stop(
        self,
        group: TaskGroup,
        name_index: AllocNameIndex,
        untainted: AllocSet,
        migrate: AllocSet,
        lost: AllocSet,
        canaries: AllocSet,
        canary_state: bool,
    ) -> AllocSet:
        stop = AllocSet()
        stop = stop.union(lost)
        self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)

        if canary_state:
            untainted = untainted.difference(canaries)

        remove = len(untainted) + len(migrate) - group.count

        if not canary_state and canaries:
            # promoted: an older alloc that shares a canary's name is the
            # one that canary replaces. Stop every such alloc, also when
            # the group is not over its count (an alloc lost or preempted
            # since the canaries were placed leaves it at or under): the
            # reference stopped only ``remove`` of them, and a destructive
            # update then re-placed the rest under names the canaries hold
            canary_names = canaries.name_set()
            for aid, alloc in list(filter_by_terminal(untainted.difference(canaries)).items()):
                if alloc.name in canary_names:
                    stop[aid] = alloc
                    self.result.stop.append(
                        AllocStopResult(alloc=alloc, status_description=ALLOC_NOT_NEEDED)
                    )
                    del untainted[aid]
                    remove -= 1

        if remove <= 0:
            return stop

        untainted = filter_by_terminal(untainted)

        if migrate:
            mnames = AllocNameIndex(self.job_id, group.name, group.count, migrate)
            remove_names = mnames.highest(remove)
            for aid, alloc in list(migrate.items()):
                if alloc.name not in remove_names:
                    continue
                self.result.stop.append(
                    AllocStopResult(alloc=alloc, status_description=ALLOC_NOT_NEEDED)
                )
                del migrate[aid]
                stop[aid] = alloc
                name_index.unset_index(alloc_index(alloc.name))
                remove -= 1
                if remove == 0:
                    return stop

        remove_names = name_index.highest(remove)
        for aid, alloc in list(untainted.items()):
            if alloc.name in remove_names:
                stop[aid] = alloc
                self.result.stop.append(
                    AllocStopResult(alloc=alloc, status_description=ALLOC_NOT_NEEDED)
                )
                del untainted[aid]
                remove -= 1
                if remove == 0:
                    return stop

        # Duplicate names fallback.
        for aid, alloc in list(untainted.items()):
            stop[aid] = alloc
            self.result.stop.append(
                AllocStopResult(alloc=alloc, status_description=ALLOC_NOT_NEEDED)
            )
            del untainted[aid]
            remove -= 1
            if remove == 0:
                return stop

        return stop

    def _compute_updates(
        self, group: TaskGroup, untainted: AllocSet
    ) -> Tuple[AllocSet, AllocSet, AllocSet]:
        ignore, inplace, destructive = AllocSet(), AllocSet(), AllocSet()
        for alloc in untainted.values():
            ignore_change, destructive_change, inplace_alloc = self.alloc_update_fn(
                alloc, self.job, group
            )
            if ignore_change:
                ignore[alloc.id] = alloc
            elif destructive_change:
                destructive[alloc.id] = alloc
            else:
                inplace[alloc.id] = alloc
                self.result.inplace_update.append(inplace_alloc)
        return ignore, inplace, destructive

    def _handle_delayed_reschedules(
        self,
        reschedule_later: List[DelayedRescheduleInfo],
        all_allocs: AllocSet,
        tg_name: str,
    ) -> None:
        if not reschedule_later:
            return

        reschedule_later.sort(key=lambda info: info.reschedule_time_ns)

        evals: List[Evaluation] = []
        next_resched_time = reschedule_later[0].reschedule_time_ns
        alloc_to_eval: Dict[str, str] = {}

        def make_eval(wait_until: int) -> Evaluation:
            return Evaluation(
                namespace=self.job.namespace,
                priority=self.job.priority,
                type=self.job.type,
                triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                job_id=self.job.id,
                job_modify_index=self.job.modify_index,
                status=EVAL_STATUS_PENDING,
                status_description=RESCHEDULING_FOLLOWUP_EVAL_DESC,
                wait_until_ns=wait_until,
            )

        current = make_eval(next_resched_time)
        evals.append(current)
        for info in reschedule_later:
            if info.reschedule_time_ns - next_resched_time < BATCHED_FAILED_ALLOC_WINDOW_NS:
                alloc_to_eval[info.alloc_id] = current.id
            else:
                next_resched_time = info.reschedule_time_ns
                current = make_eval(next_resched_time)
                evals.append(current)
                alloc_to_eval[info.alloc_id] = current.id

        self.result.desired_followup_evals[tg_name] = evals

        for alloc_id, eval_id in alloc_to_eval.items():
            existing = all_allocs[alloc_id]
            updated = existing.copy_skip_job()
            updated.followup_eval_id = eval_id
            self.result.attribute_updates[updated.id] = updated
