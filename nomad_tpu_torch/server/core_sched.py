"""Core scheduler: internal GC jobs (reference ``nomad/core_sched.go``).

Thresholds are ages; the server's TimeTable translates them to raft-index
cutoffs (objects with modify_index below the cutoff are old enough).

Copied from ``nomad_tpu/server/core_sched.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
import time
from typing import List

from ..structs.structs import (
    CORE_JOB_DEPLOYMENT_GC,
    CORE_JOB_EVAL_GC,
    CORE_JOB_FORCE_GC,
    CORE_JOB_JOB_GC,
    CORE_JOB_NODE_GC,
    JOB_STATUS_DEAD,
    Evaluation,
)
from .fsm import DEPLOYMENT_DELETE, EVAL_DELETE, JOB_DEREGISTER, NODE_DEREGISTER

EVAL_GC_THRESHOLD_NS = 3600 * 10**9  # 1h
JOB_GC_THRESHOLD_NS = 4 * 3600 * 10**9
NODE_GC_THRESHOLD_NS = 24 * 3600 * 10**9
DEPLOYMENT_GC_THRESHOLD_NS = 3600 * 10**9


class CoreScheduler:
    def __init__(self, server, snapshot) -> None:
        self.server = server
        self.snapshot = snapshot
        self.logger = logging.getLogger("nomad_tpu_torch.core_sched")

    def process(self, evaluation: Evaluation) -> None:
        job_id = evaluation.job_id
        force = job_id.startswith(CORE_JOB_FORCE_GC)
        if job_id.startswith(CORE_JOB_EVAL_GC) or force:
            self._eval_gc(force)
        if job_id.startswith(CORE_JOB_JOB_GC) or force:
            self._job_gc(force)
        if job_id.startswith(CORE_JOB_NODE_GC) or force:
            self._node_gc(force)
        if job_id.startswith(CORE_JOB_DEPLOYMENT_GC) or force:
            self._deployment_gc(force)

    def _cutoff_index(self, threshold_ns: int, force: bool) -> int:
        """Objects with modify_index <= cutoff are older than the threshold."""
        if force:
            return self.snapshot.latest_index
        return self.server.timetable.nearest_index(time.time_ns() - threshold_ns)

    def _eval_gc(self, force: bool) -> None:
        cutoff = self._cutoff_index(EVAL_GC_THRESHOLD_NS, force)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for ev in self.snapshot.evals():
            if not ev.terminal_status() or ev.modify_index > cutoff:
                continue
            allocs = self.snapshot.allocs_by_eval(ev.id)
            if any(
                not a.terminal_status() or a.modify_index > cutoff for a in allocs
            ):
                continue
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals or gc_allocs:
            self.server.raft_apply(EVAL_DELETE, (gc_evals, gc_allocs))

    def _job_gc(self, force: bool) -> None:
        cutoff = self._cutoff_index(JOB_GC_THRESHOLD_NS, force)
        for job in self.snapshot.jobs():
            if not (job.stopped() or job.status == JOB_STATUS_DEAD):
                continue
            if job.is_periodic() or job.is_parameterized():
                continue
            if job.modify_index > cutoff:
                continue
            allocs = self.snapshot.allocs_by_job(job.namespace, job.id, True)
            if any(not a.terminal_status() for a in allocs):
                continue
            evals = self.snapshot.evals_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evals):
                continue
            self.server.raft_apply(JOB_DEREGISTER, (job.namespace, job.id, True))

    def _node_gc(self, force: bool) -> None:
        cutoff = self._cutoff_index(NODE_GC_THRESHOLD_NS, force)
        for node in self.snapshot.nodes():
            if not node.terminal_status() or node.modify_index > cutoff:
                continue
            allocs = self.snapshot.allocs_by_node(node.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            self.server.raft_apply(NODE_DEREGISTER, node.id)

    def _deployment_gc(self, force: bool) -> None:
        cutoff = self._cutoff_index(DEPLOYMENT_GC_THRESHOLD_NS, force)
        gc: List[str] = []
        for d in self.snapshot.deployments():
            if d.active() or d.modify_index > cutoff:
                continue
            gc.append(d.id)
        if gc:
            self.server.raft_apply(DEPLOYMENT_DELETE, gc)
