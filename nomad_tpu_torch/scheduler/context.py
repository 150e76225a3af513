"""Evaluation context and computed-class eligibility memoization.

Semantics follow reference ``scheduler/context.go`` (EvalContext :75,
ProposedAllocs :120, EvalEligibility :191).

Copied from ``nomad_tpu/scheduler/context.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import enum
import logging
from typing import Dict, List, Optional

from ..structs.node_class import escaped_constraints
from ..structs.structs import Allocation, AllocMetric, Job, Plan
from ..structs.funcs import remove_allocs


class ComputedClassFeasibility(enum.Enum):
    UNKNOWN = 0
    INELIGIBLE = 1
    ELIGIBLE = 2
    ESCAPED = 3


class EvalEligibility:
    """Tracks per-computed-class eligibility over the course of an eval.

    This is the reference's key O(classes) << O(nodes) optimization; the TPU
    engine reuses it to compute feasibility masks per class and gather them
    per node.
    """

    def __init__(self) -> None:
        self.job: Dict[str, ComputedClassFeasibility] = {}
        self.job_escaped = False
        self.task_groups: Dict[str, Dict[str, ComputedClassFeasibility]] = {}
        self.tg_escaped_constraints: Dict[str, bool] = {}
        self.quota_reached = ""

    def set_job(self, job: Job) -> None:
        self.job_escaped = len(escaped_constraints(job.constraints)) != 0
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for task in tg.tasks:
                constraints.extend(task.constraints)
            self.tg_escaped_constraints[tg.name] = len(escaped_constraints(constraints)) != 0

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped_constraints.values())

    def get_classes(self) -> Dict[str, bool]:
        elig: Dict[str, bool] = {}
        for classes in self.task_groups.values():
            for cls, feas in classes.items():
                if feas == ComputedClassFeasibility.ELIGIBLE:
                    elig[cls] = True
                elif feas == ComputedClassFeasibility.INELIGIBLE:
                    elig.setdefault(cls, False)
        for cls, feas in self.job.items():
            if feas == ComputedClassFeasibility.ELIGIBLE:
                elig.setdefault(cls, True)
            elif feas == ComputedClassFeasibility.INELIGIBLE:
                elig[cls] = False
        return elig

    def job_status(self, cls: str) -> ComputedClassFeasibility:
        if self.job_escaped:
            return ComputedClassFeasibility.ESCAPED
        return self.job.get(cls, ComputedClassFeasibility.UNKNOWN)

    def set_job_eligibility(self, eligible: bool, cls: str) -> None:
        self.job[cls] = (
            ComputedClassFeasibility.ELIGIBLE if eligible else ComputedClassFeasibility.INELIGIBLE
        )

    def task_group_status(self, tg: str, cls: str) -> ComputedClassFeasibility:
        if self.tg_escaped_constraints.get(tg, False):
            return ComputedClassFeasibility.ESCAPED
        return self.task_groups.get(tg, {}).get(cls, ComputedClassFeasibility.UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, cls: str) -> None:
        self.task_groups.setdefault(tg, {})[cls] = (
            ComputedClassFeasibility.ELIGIBLE if eligible else ComputedClassFeasibility.INELIGIBLE
        )

    def set_quota_limit_reached(self, quota: str) -> None:
        self.quota_reached = quota

    def quota_limit_reached(self) -> str:
        return self.quota_reached


class EvalContext:
    """Contextual state for one evaluation (state snapshot, plan, metrics)."""

    def __init__(self, state, plan: Plan, logger: Optional[logging.Logger] = None,
                 deterministic: bool = False, ring_seed: int = 0) -> None:
        self.state = state
        self.plan = plan
        self.logger = logger or logging.getLogger("nomad_tpu_torch.scheduler")
        self.metrics = AllocMetric()
        self.eligibility: Optional[EvalEligibility] = None
        # caches
        self.regexp_cache: Dict[str, object] = {}
        self.version_constraint_cache: Dict[str, object] = {}
        self.semver_constraint_cache: Dict[str, object] = {}
        # deterministic scheduling (no shuffle, lowest-index dynamic ports);
        # used by the host/TPU parity harness
        self.deterministic = deterministic
        # Per-node memoization across one eval's placements. The snapshot
        # is immutable for the eval's lifetime, so a node's proposed set
        # (and the NetworkIndex built from it) only changes when THIS
        # plan touches the node — keyed by the plan-shape token below.
        self._proposed_cache: Dict[str, tuple] = {}
        self._netidx_cache: Dict[str, tuple] = {}
        # Deterministic-mode analog of the reference's per-eval node
        # shuffle (stack.go:67 SetNodes -> util.go:329 shuffleNodes):
        # a per-eval starting offset for the candidate ring. Without it,
        # optimistically-concurrent evals sharing one snapshot walk
        # identical rings and collide at plan apply. 0 = insertion order
        # (the parity harness's fixed frame); same seed on the host stack
        # and the TPU scan keeps them plan-identical per eval.
        self.ring_seed = ring_seed

    def reset(self) -> None:
        self.metrics = AllocMetric()

    def _plan_token(self, node_id: str) -> tuple:
        """Shape of this plan's mutations for one node; any placement,
        eviction or preemption appended for the node changes a length
        and invalidates that node's cached proposed/NetworkIndex state."""
        return (
            len(self.plan.node_allocation.get(node_id, ())),
            len(self.plan.node_update.get(node_id, ())),
            len(self.plan.node_preemptions.get(node_id, ())),
        )

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Existing non-terminal allocs - planned evictions - preemptions
        + planned placements (reference context.go:120), memoized per
        node for the duration of the eval (invalidated when the plan
        touches the node)."""
        from ..utils import phases as _phases

        token = self._plan_token(node_id)
        hit = self._proposed_cache.get(node_id)
        if hit is not None and hit[0] == token:
            return list(hit[1])
        with _phases.track("proposed"):
            existing = self.state.allocs_by_node_terminal(node_id, False)
            proposed = existing
            update = self.plan.node_update.get(node_id, [])
            if update:
                proposed = remove_allocs(existing, update)
            preempted = self.plan.node_preemptions.get(node_id, [])
            if preempted:
                proposed = remove_allocs(proposed, preempted)
            # Index by ID so in-place updates override rather than
            # double count.
            by_id = {a.id: a for a in proposed}
            for alloc in self.plan.node_allocation.get(node_id, []):
                by_id[alloc.id] = alloc
            out = list(by_id.values())
            self._proposed_cache[node_id] = (token, out)
            return list(out)

    def network_index(self, node, proposed: List[Allocation]):
        """Base NetworkIndex for ``node`` with ``proposed`` folded in,
        memoized like proposed_allocs; callers get a fork so their
        add_reserved calls never mutate the cached base. ``proposed``
        MUST be the ctx.proposed_allocs set for the node (the cache key
        assumes it)."""
        from ..structs.network import NetworkIndex

        token = self._plan_token(node.id)
        hit = self._netidx_cache.get(node.id)
        if hit is not None and hit[0] == token:
            return hit[1].fork()
        base = NetworkIndex(deterministic=self.deterministic)
        base.set_node(node)
        base.add_allocs(proposed)
        self._netidx_cache[node.id] = (token, base)
        return base.fork()

    def get_eligibility(self) -> EvalEligibility:
        if self.eligibility is None:
            self.eligibility = EvalEligibility()
        return self.eligibility
