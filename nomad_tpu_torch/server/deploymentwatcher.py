"""Deployment watcher: drives rolling/canary deployments to completion.

Fills the role of reference ``nomad/deploymentwatcher/`` (deployments_watcher.go:60
Watcher, deployment_watcher.go per-deployment goroutine, batcher.go). Instead
of one goroutine per deployment, one watcher thread wakes on every state-store
index bump (blocking query, state_store.go:188 analog) and evaluates every
active deployment in a single pass — cheaper at C1M deployment counts and
naturally batched, which is the same reshaping applied to the scheduler
(per-node iterators → one vectorized pass).

Per-deployment logic reproduced from the reference:
- cancel when the job is stopped/removed or a newer job version supersedes it
  (deployment_watcher.go getDeploymentStatusUpdate / watchJobVersion)
- fail on unhealthy allocs, with optional auto-revert to the latest stable
  job version (deployment_watcher.go:FailDeployment, handleAllocUpdate)
- fail when a group misses its progress deadline (watchDeadline)
- auto-promote once every desired canary is placed and healthy
  (deployments_watcher.go autoPromoteDeployments)
- mark successful + flag the job version stable when all groups are done
  (deployment_watcher.go watchAllocs → setDeploymentStatus)

State mutations ride raft ops (DEPLOYMENT_STATUS_UPDATE / DEPLOYMENT_PROMOTE /
DEPLOYMENT_ALLOC_HEALTH / JOB_STABILITY) so followers replay identically, and
every transition emits an eval (EVAL_TRIGGER_DEPLOYMENT_WATCHER) so the
scheduler reacts — same protocol as the reference's shims
(deployment_watcher_shims.go).

Copied from ``nomad_tpu/server/deploymentwatcher.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from ..structs.structs import (
    DEPLOYMENT_STATUS_CANCELLED,
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    Deployment,
    DeploymentStatusUpdate,
    Evaluation,
    Job,
)
from ..utils.lock_witness import witness_lock

# status descriptions (reference structs.go DeploymentStatusDescription*)
DESC_RUNNING = "Deployment is running"
DESC_PAUSED = "Deployment is paused"
DESC_SUCCESSFUL = "Deployment completed successfully"
DESC_STOPPED_JOB = "Cancelled because job is stopped"
DESC_NEWER_JOB = "Cancelled due to newer version of job"
DESC_FAILED_ALLOCS = "Failed due to unhealthy allocations"
DESC_FAILED_BY_USER = "Deployment marked as failed"
DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_AUTO_PROMOTE = "Deployment promoted automatically"


def _rollback_suffix(desc: str, version: int) -> str:
    return f"{desc} - rolling back to job version {version}"


class DeploymentsWatcher:
    """Leader-only monitor of active deployments."""

    def __init__(self, server, poll_interval: float = 1.0) -> None:
        self.server = server
        self.poll_interval = poll_interval
        self.logger = logging.getLogger("nomad_tpu_torch.deploymentwatcher")
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        self._generation = 0
        self._lock = witness_lock("deploymentwatcher.DeploymentsWatcher._lock")
        # deployment id → last observed healthy-alloc total, for detecting
        # mid-rollout health transitions that must kick the scheduler
        self._last_healthy: dict = {}

    # -- lifecycle -------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            self._generation += 1
            gen = self._generation
        if enabled:
            t = threading.Thread(
                target=self._run, args=(gen,), name="deploymentwatcher", daemon=True
            )
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
                self.logger.exception("deployment watcher tick failed")
            # Wake on any state change (allocs/health land as index bumps) or
            # after poll_interval to re-check wall-clock progress deadlines.
            _, last_index = state.blocking_query(
                lambda s: None, last_index, timeout=self.poll_interval
            )

    # -- one evaluation pass over all active deployments -----------------

    def tick(self, now_ns: Optional[int] = None) -> None:
        now_ns = now_ns if now_ns is not None else time.time_ns()
        state = self.server.fsm.state
        active_ids = set()
        for d in state.deployments():
            if not d.active():
                continue
            active_ids.add(d.id)
            try:
                self._check_deployment(state, d, now_ns)
            except Exception:  # noqa: BLE001
                self.logger.exception("deployment %s check failed", d.id)
        # failed/cancelled deployments must not leak health counters
        for did in list(self._last_healthy):
            if did not in active_ids:
                self._last_healthy.pop(did, None)

    def _check_deployment(self, state, d: Deployment, now_ns: int) -> None:
        job = state.job_by_id(d.namespace, d.job_id)
        # cancelled: job stopped/removed or superseded by a newer version
        if job is None or job.stopped():
            self._update_status(d, DEPLOYMENT_STATUS_CANCELLED, DESC_STOPPED_JOB)
            return
        if job.version != d.job_version:
            self._update_status(d, DEPLOYMENT_STATUS_CANCELLED, DESC_NEWER_JOB)
            return
        if d.status == DEPLOYMENT_STATUS_PAUSED:
            return

        # failed: unhealthy allocation appeared
        if any(ds.unhealthy_allocs > 0 for ds in d.task_groups.values()):
            self._fail(d, DESC_FAILED_ALLOCS)
            return

        # failed: a group missed its progress deadline
        for ds in d.task_groups.values():
            done = ds.healthy_allocs >= ds.desired_total and (
                ds.desired_canaries == 0 or ds.promoted
            )
            if (
                not done
                and ds.require_progress_by_ns > 0
                and now_ns > ds.require_progress_by_ns
            ):
                self._fail(d, DESC_PROGRESS_DEADLINE)
                return

        # auto-promote: every canary group opted in, all canaries healthy
        if d.requires_promotion():
            canary_groups = [
                ds for ds in d.task_groups.values() if ds.desired_canaries > 0
            ]
            if all(ds.auto_promote for ds in canary_groups) and all(
                len(ds.placed_canaries) >= ds.desired_canaries
                and ds.healthy_allocs >= ds.desired_canaries
                for ds in canary_groups
            ):
                self.promote(d.id, description=DESC_AUTO_PROMOTE)
            return  # promotion (manual or auto) gates completion

        # success: every group fully healthy and promoted where required
        if d.task_groups and all(
            ds.healthy_allocs >= ds.desired_total for ds in d.task_groups.values()
        ):
            self._last_healthy.pop(d.id, None)
            self._update_status(d, DEPLOYMENT_STATUS_SUCCESSFUL, DESC_SUCCESSFUL)
            self.server.raft_apply(
                "job-stability", (d.namespace, d.job_id, d.job_version, True)
            )
            return

        # progress: an alloc newly became healthy mid-rollout — kick the
        # scheduler so the next max_parallel batch places (reference
        # deployment_watcher.go createBatchedUpdateEvaluation on alloc
        # health transitions; without this a rolling update stalls after
        # its first batch)
        total_healthy = sum(ds.healthy_allocs for ds in d.task_groups.values())
        # default 0, not None: a deployment first observed with healthy
        # allocs already recorded (health landed before our first tick)
        # must still kick the scheduler, or the rollout stalls forever
        prev = self._last_healthy.get(d.id, 0)
        self._last_healthy[d.id] = total_healthy
        if total_healthy > prev:
            ev = self._make_eval(d, job)
            self.server.raft_apply("eval-update", [ev])

    # -- transitions -----------------------------------------------------

    def _make_eval(self, d: Deployment, job: Optional[Job] = None) -> Evaluation:
        ev = Evaluation(
            namespace=d.namespace,
            priority=job.priority if job is not None else 50,
            type=job.type if job is not None else "service",
            triggered_by=EVAL_TRIGGER_DEPLOYMENT_WATCHER,
            job_id=d.job_id,
            deployment_id=d.id,
            status=EVAL_STATUS_PENDING,
        )
        ev.update_modify_time()
        return ev

    def _update_status(
        self, d: Deployment, status: str, description: str, job: Optional[Job] = None
    ) -> None:
        update = DeploymentStatusUpdate(
            deployment_id=d.id, status=status, status_description=description
        )
        state_job = self.server.fsm.state.job_by_id(d.namespace, d.job_id)
        ev = self._make_eval(d, state_job) if status != DEPLOYMENT_STATUS_CANCELLED else None
        self.server.raft_apply("deployment-status-update", (update, job, ev))
        self.logger.info("deployment %s -> %s (%s)", d.id[:8], status, description)

    def _latest_stable_job(self, d: Deployment) -> Optional[Job]:
        """Newest job version flagged stable, below the deployment's version
        (reference deployment_watcher.go latestStableJob)."""
        versions = self.server.fsm.state.job_versions.get((d.namespace, d.job_id), [])
        stable = [j for j in versions if j.stable and j.version < d.job_version]
        if not stable:
            return None
        return max(stable, key=lambda j: j.version).copy()

    def _fail(self, d: Deployment, description: str) -> None:
        rollback = None
        if any(ds.auto_revert for ds in d.task_groups.values()):
            stable = self._latest_stable_job(d)
            if stable is not None:
                description = _rollback_suffix(description, stable.version)
                rollback = stable  # re-upsert bumps it to a fresh version
        self._update_status(d, DEPLOYMENT_STATUS_FAILED, description, job=rollback)

    # -- endpoint surface (Deployment.* RPCs) ----------------------------

    def promote(
        self,
        deployment_id: str,
        groups: Optional[List[str]] = None,
        description: str = DESC_RUNNING,
    ) -> None:
        """Deployment.Promote (deployments_watcher.go PromoteDeployment)."""
        state = self.server.fsm.state
        d = state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal ({d.status})")
        if not d.requires_promotion():
            raise ValueError(f"deployment {deployment_id} has nothing to promote")
        job = state.job_by_id(d.namespace, d.job_id)
        ev = self._make_eval(d, job)
        self.server.raft_apply(
            "deployment-promote", (deployment_id, groups, description, ev)
        )

    def pause(self, deployment_id: str, pause: bool) -> None:
        """Deployment.Pause (deployments_watcher.go PauseDeployment)."""
        d = self.server.fsm.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal ({d.status})")
        if pause:
            update = DeploymentStatusUpdate(
                deployment_id=d.id,
                status=DEPLOYMENT_STATUS_PAUSED,
                status_description=DESC_PAUSED,
            )
            self.server.raft_apply("deployment-status-update", (update, None, None))
        else:
            self._update_status(d, DEPLOYMENT_STATUS_RUNNING, DESC_RUNNING)

    def fail(self, deployment_id: str) -> None:
        """Deployment.Fail (deployments_watcher.go FailDeployment)."""
        state = self.server.fsm.state
        d = state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        if not d.active():
            raise ValueError(f"deployment {deployment_id} is terminal ({d.status})")
        self._fail(d, DESC_FAILED_BY_USER)

    def set_alloc_health(
        self,
        deployment_id: str,
        healthy: Optional[List[str]] = None,
        unhealthy: Optional[List[str]] = None,
    ) -> None:
        """Deployment.SetAllocHealth — explicit health reports (the
        reference batches these per 250ms, batcher.go; raft op is cheap
        enough here to apply directly)."""
        state = self.server.fsm.state
        d = state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        self.server.raft_apply(
            "deployment-alloc-health",
            (deployment_id, healthy or [], unhealthy or [], time.time_ns(), None, None),
        )
