"""Scheduler test harness (reference ``scheduler/testing.go:42``).

A real in-memory StateStore plus a fake Planner that applies plans
synchronously — the parity oracle for host-vs-TPU plan diffing.

Copied from ``nomad_tpu/scheduler/testing.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. One
addition: ``device`` (default ``"cuda"``), handed to every scheduler as
``deterministic`` is. Asking for CUDA where there is none raises at
construction; nothing falls back to the CPU.
"""
from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from ..state import StateStore
from ..structs.structs import Evaluation, Plan, PlanResult
from ..tpu.convert import DeviceLike, resolve_device
from .scheduler import new_scheduler


class Harness:
    def __init__(self, state: Optional[StateStore] = None,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.state = state or StateStore()
        self.planner = None  # optional custom planner override
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self._lock = threading.Lock()
        self._next_index = 1
        self.logger = logging.getLogger("nomad_tpu_torch.scheduler.harness")

    def next_index(self) -> int:
        with self._lock:
            idx = self._next_index
            self._next_index += 1
            return idx

    # -- Planner -----------------------------------------------------------

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[StateStore]]:
        if self.planner is not None:
            self.plans.append(plan)
            return self.planner.submit_plan(plan)

        # The harness applies plans as classic per-alloc objects so tests
        # (the host-vs-TPU parity oracle above all) diff one shape.
        plan.inflate_dense()
        self.plans.append(plan)

        index = self.next_index()

        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=index,
        )

        # Stamp indexes + re-attach the plan's job the way shared pointers do
        # in the reference (UpsertPlanResults mutates the same structs).
        allocs_updated = []
        for alloc_list in plan.node_allocation.values():
            for alloc in alloc_list:
                existing = self.state.alloc_by_id(alloc.id)
                alloc.create_index = existing.create_index if existing else index
                alloc.modify_index = index
                if alloc.job is None:
                    alloc.job = plan.job
                allocs_updated.append(alloc)
        allocs_stopped = []
        for alloc_list in plan.node_update.values():
            for alloc in alloc_list:
                alloc.modify_index = index
                allocs_stopped.append(alloc)
        allocs_preempted = []
        for alloc_list in plan.node_preemptions.values():
            for alloc in alloc_list:
                alloc.modify_index = index
                allocs_preempted.append(alloc)

        self.state.upsert_plan_results(
            index,
            alloc_updates=allocs_updated,
            allocs_stopped=allocs_stopped,
            allocs_preempted=allocs_preempted,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            eval_id=plan.eval_id,
        )
        return result, None

    def update_eval(self, evaluation: Evaluation) -> None:
        self.evals.append(evaluation)
        if self.planner is not None:
            self.planner.update_eval(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        self.create_evals.append(evaluation)
        if self.planner is not None:
            self.planner.create_eval(evaluation)

    def reblock_eval(self, evaluation: Evaluation) -> None:
        self.reblock_evals.append(evaluation)
        if self.planner is not None:
            self.planner.reblock_eval(evaluation)

    # -- driving -----------------------------------------------------------

    def snapshot(self) -> StateStore:
        return self.state.snapshot()

    def process(self, scheduler_name: str, evaluation: Evaluation,
                deterministic: bool = True) -> None:
        """Process an eval with a scheduler created against a state snapshot."""
        sched = new_scheduler(scheduler_name, self.logger, self.snapshot(), self)
        if hasattr(sched, "deterministic"):
            sched.deterministic = deterministic
        if hasattr(sched, "device"):
            sched.device = self.device
        sched.process(evaluation)

    def assert_eval_status(self, expected: str) -> None:
        assert len(self.evals) == 1, f"expected one eval update, got {len(self.evals)}"
        assert self.evals[0].status == expected, (
            f"expected status {expected}, got {self.evals[0].status}"
        )
