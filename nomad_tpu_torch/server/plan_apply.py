"""Plan queue and plan applier: the cluster's serialization point.

Semantics follow reference ``nomad/plan_queue.go`` and ``nomad/plan_apply.go``:
workers submit plans optimistically; the leader's single applier thread
re-validates every touched node against current state (AllocsFit,
plan_apply.go:628), partially commits what fits, and returns a RefreshIndex
forcing stale workers to re-plan.

Two of the reference's throughput mechanisms are reproduced here:

* **Pipelined commit** (plan_apply.go:45–70): while plan N's raft apply is
  in flight, plan N+1 is evaluated against an OPTIMISTIC snapshot that
  already includes N's results. Before dispatching N+1's apply we wait for
  N to commit; the worker's response is delivered asynchronously from the
  apply waiter, so the applier thread is never parked on raft latency
  while work is queued.
* **Batched node re-check**: the per-node feasibility fan-out the
  reference does over a goroutine pool (plan_apply_pool.go) is one
  numpy pass here — every touched node's cpu/mem/disk totals vs proposed
  usage compare at once; only nodes that pass capacity run the discrete
  port-collision / device host checks.

Copied from ``nomad_tpu/server/plan_apply.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. Two
changes: ``PlanQueue.dequeue(timeout)`` on a disabled (follower's) queue
waits out its timeout instead of returning at once, so a follower's
planner does not spin while another server leads; and a plan rejected
whole is answered only once the applies its evaluation saw have
committed, its refresh index raised to theirs (``_respond_rejected``).
The reference answers it at once with the committed index: a worker
then re-plans from a snapshot without the in-flight plan it conflicted
with (two evals' deterministic dynamic ports on one node), is rejected
again, and its batch eval, out of attempts, waits blocked for the
periodic retry of failed evals (60 s).
"""
from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chaos.injector import fire as chaos_fire
from ..structs.funcs import remove_allocs
from ..structs.network import NetworkIndex
from ..trace import lifecycle as _lifecycle
from ..utils import metrics, phases
from ..structs.structs import (
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_PREEMPTION,
    Allocation,
    Evaluation,
    Plan,
    PlanResult,
)
from .fsm import APPLY_PLAN_RESULTS, APPLY_PLAN_RESULTS_BATCH  # noqa: F401 — single-plan op kept for wire compat
from ..utils.lock_witness import witness_lock


class PendingPlan:
    def __init__(self, plan: Plan) -> None:
        self.plan = plan
        self.future: Future = Future()


class PlanQueue:
    """Leader-only priority queue of submitted plans (reference plan_queue.go)."""

    def __init__(self) -> None:
        self._lock = witness_lock("plan_apply.PlanQueue._lock")
        self._cond = threading.Condition(self._lock)
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._counter = itertools.count()
        self.enabled = False

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev = self.enabled
            self.enabled = enabled
            if prev and not enabled:
                for _, _, pending in self._heap:
                    pending.future.set_exception(RuntimeError("plan queue disabled"))
                self._heap.clear()
            self._cond.notify_all()

    def enqueue(self, plan: Plan) -> PendingPlan:
        with self._lock:
            if not self.enabled:
                raise RuntimeError("plan queue is disabled")
            pending = PendingPlan(plan)
            heapq.heappush(self._heap, (-plan.priority, next(self._counter), pending))
            self._cond.notify()
            return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._heap:
                if not self.enabled:
                    # a follower's queue: wait out the timeout (set_enabled
                    # wakes it) rather than return at once, or the planner's
                    # poll loop spins on every follower and holds the GIL
                    # against the leader's threads (the reference returns
                    # at once)
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is None or remaining <= 0:
                        return None
                    self._cond.wait(timeout=remaining)
                    continue
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(timeout=remaining)
            return heapq.heappop(self._heap)[2]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"depth": len(self._heap)}


class Planner:
    """The leader's plan applier loop (reference planner.planApply)."""

    def __init__(self, raft, peer: int, fsm, plan_queue: PlanQueue, logger=None,
                 batch_max: int = 32) -> None:
        self.raft = raft
        self.peer = peer
        self.fsm = fsm
        self.plan_queue = plan_queue
        self.logger = logger or logging.getLogger("nomad_tpu_torch.planner")
        # max queued plans grouped into one raft entry (see _run)
        self.batch_max = max(1, int(batch_max))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="plan-apply", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        # Pipelined applier (plan_apply.go:45–70): track one outstanding
        # raft apply (apply_future resolves to its committed index, 0 on
        # failure) and an optimistic snapshot that already includes it.
        #
        # Snapshot retention: taking a fresh snapshot per plan is O(store)
        # and was the drain bottleneck at C1M rates. The store's
        # capacity_epoch counts every capacity-relevant write (nodes,
        # allocs, dense blocks, jobs); as long as the live epoch equals
        # our prediction (snapshot epoch + our own dispatched applies),
        # the only writes that landed since are eval-status noise and the
        # retained optimistic snapshot is capacity-identical to committed
        # state — index staleness checks may be bypassed safely.
        apply_future: Optional[Future] = None
        snap = None
        prev_plan_result_index = 0
        expected_epoch: Optional[int] = None

        def epoch_current() -> bool:
            live = self.fsm.state
            return (
                snap is not None
                and expected_epoch is not None
                and getattr(snap, "store_id", None) == live.store_id
                and live.capacity_epoch == expected_epoch
            )

        carry: List[PendingPlan] = []
        while not self._stop.is_set():
            if carry:
                batch = carry
                carry = []
            else:
                first = self.plan_queue.dequeue(timeout=0.2)
                if first is None:
                    continue
                batch = [first]
            # Greedy batch gather: at C1M commit rates the per-plan
            # round trip (waiter thread, raft dispatch, FSM lock) is the
            # drain bottleneck, so queued plans are grouped into ONE
            # raft entry (APPLY_PLAN_RESULTS_BATCH). Each plan is still
            # evaluated sequentially against a snapshot containing its
            # predecessors' folds, so per-plan semantics are unchanged
            # (reference serialization point: plan_apply.go:45–70).
            while len(batch) < self.batch_max:
                nxt = self.plan_queue.dequeue(timeout=0)
                if nxt is None:
                    break
                batch.append(nxt)
            metrics.set_gauge("nomad.plan.queue_depth", self.plan_queue.stats().get("depth", 0))
            try:
                # Previous batch committed during dequeue? Keep the
                # optimistic view only if the commit was exactly what we
                # predicted (no interleaved capacity writes).
                if apply_future is not None and apply_future.done():
                    idx = self._future_index(apply_future)
                    prev_plan_result_index = max(prev_plan_result_index, idx)
                    apply_future = None
                    if idx == 0 or not epoch_current():
                        snap = None
                        expected_epoch = None

                min_index = max(
                    [prev_plan_result_index]
                    + [p.plan.snapshot_index for p in batch]
                )
                # Retention invariant: a retained snapshot is capacity-
                # identical to committed state iff epoch_current(). With
                # no apply in flight there is no post-wait re-evaluation
                # to correct a bad evaluation, so ANY epoch mismatch must
                # discard the snapshot outright — independent of index
                # staleness (the mismatch means a foreign capacity write
                # landed: node drain/down, client sync, eval-GC delete).
                # With an apply in flight the mismatch may just be our own
                # uncommitted delta; keep the optimistic view unless it is
                # also index-stale, and rely on the post-wait re-check.
                if snap is not None and not epoch_current():
                    if apply_future is None or snap.latest_index < min_index:
                        snap = None
                        expected_epoch = None
                # Does the evaluation snapshot include the in-flight batch's
                # results? Only the retained optimistic snapshot does; a
                # fresh snapshot taken while an apply is still in flight
                # may lack them, and an evaluation against it cannot be
                # trusted not to double-commit the same capacity.
                saw_inflight = True
                if snap is None:
                    snap = self._snapshot_min_index(min_index)
                    expected_epoch = snap.capacity_epoch
                    saw_inflight = apply_future is None

                items, batch_delta, snap_ok, leftovers, rejected = (
                    self._evaluate_and_fold(batch, snap)
                )
                carry = leftovers

                # Ensure any parallel apply completed before dispatching
                # the next one (bounds how stale the optimism can get).
                if apply_future is not None:
                    idx = self._future_index(apply_future, wait=True)
                    prev_plan_result_index = max(prev_plan_result_index, idx)
                    apply_future = None
                    if idx == 0 or not saw_inflight or not epoch_current():
                        # Re-validate against committed state whenever the
                        # evaluations could not be trusted: they ran blind
                        # to the in-flight batch, or a failed apply
                        # (idx == 0) never delivered its optimism, or a
                        # foreign capacity write (node drain, client sync)
                        # interleaved with the retained snapshot —
                        # dispatching unchecked in any of these would
                        # commit placements against capacity state that
                        # never existed.
                        snap = self._snapshot_min_index(
                            max(prev_plan_result_index, min_index)
                        )
                        expected_epoch = snap.capacity_epoch
                        redo = [it[0] for it in items]
                        items, batch_delta, snap_ok, leftovers, again = (
                            self._evaluate_and_fold(redo, snap)
                        )
                        rejected += again
                        carry = leftovers + carry

                if not items:
                    self._respond_rejected(rejected, prev_plan_result_index)
                    if not snap_ok:
                        snap = None
                        expected_epoch = None
                    continue
                apply_future = self._dispatch_batch(items, rejected)
                if expected_epoch is not None:
                    expected_epoch += batch_delta
                if not snap_ok:
                    # an optimistic fold-in failed partway: the snapshot
                    # is inconsistent — never evaluate against it again
                    snap = None
                    expected_epoch = None
            except Exception as e:  # noqa: BLE001 — workers get the error
                self.logger.exception("plan apply failed")
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(e)
                carry = []

        if apply_future is not None:
            apply_future.result()

    @staticmethod
    def _future_index(future: Future, wait: bool = False) -> int:
        try:
            return future.result() if wait else future.result(timeout=0)
        except Exception:  # noqa: BLE001 — failed apply: index unknown
            return 0

    def _snapshot_min_index(self, min_index: int):
        start = metrics.now()
        snap = self.fsm.state.snapshot_min_index(min_index)
        metrics.measure_since("nomad.plan.wait_for_index", start)
        return snap

    # ------------------------------------------------------------------

    def evaluate_plan(self, snapshot, plan: Plan) -> PlanResult:
        """Re-check every touched node against current state; keep what fits
        (reference plan_apply.go:399/:436/:628).

        The capacity math for ALL touched nodes runs as one numpy batch
        (the vectorized analog of plan_apply_pool.go's goroutine fan-out);
        only nodes that pass capacity run the discrete port-collision and
        device checks host-side."""
        # chaos hook: a fault here is THIS plan's failure only — the
        # batched waiter's per-payload isolation resolves this plan's
        # future with the error while its batch-mates commit normally
        chaos_fire("plan_apply", eval_id=getattr(plan, "eval_id", None))
        result = PlanResult(
            node_update=plan.node_update,
            node_allocation={},
            node_preemptions={},
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
        )
        partial = False

        node_ids: List[str] = []
        proposed_by_node: List[Optional[List[Allocation]]] = []
        nodes = []
        for node_id in plan.node_allocation:
            new_allocs = plan.node_allocation[node_id]
            node = snapshot.node_by_id(node_id)
            if node is None:
                if new_allocs:
                    partial = True
                continue
            if node.drain or not node.ready():
                partial = True
                continue
            existing = snapshot.allocs_by_node(node_id)
            existing = [a for a in existing if not a.terminal_status()]
            # Remove planned evictions, preemptions, AND prior versions of
            # the planned allocations (in-place updates must not double
            # count).
            remove = list(plan.node_update.get(node_id, []))
            remove.extend(plan.node_preemptions.get(node_id, []))
            remove.extend(new_allocs)
            if remove:
                existing = remove_allocs(existing, remove)
            node_ids.append(node_id)
            nodes.append(node)
            proposed_by_node.append(existing + new_allocs)

        fit_mask = self._batch_capacity_check(nodes, proposed_by_node)

        for i, node_id in enumerate(node_ids):
            ok = bool(fit_mask[i])
            if ok:
                ok = self._node_discrete_checks(nodes[i], proposed_by_node[i])
            if ok:
                result.node_allocation[node_id] = plan.node_allocation[node_id]
                if node_id in plan.node_preemptions:
                    result.node_preemptions[node_id] = plan.node_preemptions[node_id]
            else:
                self.logger.debug("plan for node %s rejected", node_id)
                partial = True

        if plan.dense_placements:
            dense_out, dense_partial = self._evaluate_dense(snapshot, plan, result)
            result.dense_placements = dense_out
            if dense_partial:
                partial = True

        if partial:
            # Invalid placements: cancel deployment bits if everything failed
            if not result.node_allocation and not result.dense_placements:
                result.deployment = None
                result.deployment_updates = []
            # COMMITTED state only: an optimistic (uncommitted) index here
            # could strand the re-planning worker waiting for an index that
            # never lands if the in-flight apply fails. For dispatched
            # plans the apply waiter raises this to the real alloc_index.
            result.refresh_index = self.fsm.state.latest_index
        return result

    def _evaluate_dense(self, snapshot, plan: Plan, result: PlanResult):
        """Re-check dense placement blocks against current state without
        materializing a single Allocation: per touched node, committed
        usage comes from the state store's incremental mirror, this
        plan's stops/preemptions subtract, and each block's placements
        add count x ask_vec. Per-node all-or-nothing, like the object
        path's evaluateNodePlan (reference plan_apply.go:628).

        Returns (committed_blocks, partial)."""
        from ..structs.funcs import alloc_usage_vec

        # capacity this plan's committed stops/preemptions free per node
        freed: Dict[str, List[float]] = {}

        def _free(alloc) -> None:
            base = snapshot.alloc_by_id(alloc.id)
            if base is None or base.terminal_status():
                return
            u = alloc_usage_vec(base)
            row = freed.setdefault(base.node_id, [0.0, 0.0, 0.0, 0.0])
            for d in range(4):
                row[d] += u[d]

        for allocs in result.node_update.values():
            for alloc in allocs:
                _free(alloc)
        for allocs in result.node_preemptions.values():
            for alloc in allocs:
                _free(alloc)

        # Dense-path preemptions: plan.node_preemptions rows for nodes the
        # object path never touched are credited (and later committed)
        # here. Object-path nodes were already folded above — accepted ones
        # are in result.node_preemptions, rejected ones must stay dropped.
        dense_pre: Dict[str, list] = {
            nid: allocs
            for nid, allocs in plan.node_preemptions.items()
            if allocs and nid not in plan.node_allocation
        }
        for allocs in dense_pre.values():
            for alloc in allocs:
                _free(alloc)

        mirror = getattr(snapshot, "_node_usage", {})
        # adds accumulated across blocks (and the object-path placements
        # committed above, which the mirror does not include yet)
        pending: Dict[str, List[float]] = {}
        for allocs in result.node_allocation.values():
            for alloc in allocs:
                if alloc.terminal_status():
                    continue
                u = alloc_usage_vec(alloc)
                row = pending.setdefault(alloc.node_id, [0.0, 0.0, 0.0, 0.0])
                base = snapshot.alloc_by_id(alloc.id)
                for d in range(4):
                    row[d] += u[d]
                if base is not None and not base.terminal_status():
                    bu = alloc_usage_vec(base)
                    for d in range(4):
                        row[d] -= bu[d]

        # Per-node ALL-OR-NOTHING across the WHOLE plan (the object
        # path's evaluateNodePlan semantics): aggregate every block's
        # asks per node first, check each node once against the combined
        # addition, then trim every block by the failing-node set. Every
        # per-placement step here is vectorized numpy over the blocks'
        # parallel arrays — the evaluate stage of the eval-lifecycle
        # pipeline shares one interpreter with encode/apply, so a Python
        # loop over 1M placements would serialize the whole pipeline.
        zero4 = (0.0, 0.0, 0.0, 0.0)
        # freed/pending are empty for pure dense plans (the C1M commit
        # shape): skip their lookups entirely on that path
        has_adj = bool(freed) or bool(pending)

        blocks = plan.dense_placements
        id_arrs = [np.asarray(b.node_ids) for b in blocks]
        counts = np.array([a.shape[0] for a in id_arrs], np.int64)
        offs = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        all_ids = np.concatenate(id_arrs)
        # inv maps placement row -> unique-node row; the per-node added
        # load is one scatter-add of count x ask_vec
        uids, inv = np.unique(all_ids, return_inverse=True)
        asks = np.repeat(
            np.array([b.ask_vec for b in blocks], np.float64).reshape(-1, 4),
            counts, axis=0,
        )
        k = int(uids.shape[0])
        add = np.zeros((k, 4), np.float64)
        np.add.at(add, inv, asks)

        from ..structs.funcs import node_capacity_vecs

        # per-unique-node rows: node objects live behind Python dicts, so
        # this loop is O(touched nodes), not O(placements) — the capacity
        # vecs are memoized per node (structs.funcs)
        totals = np.zeros((k, 4), np.float64)
        res = np.zeros((k, 4), np.float64)
        used = np.zeros((k, 4), np.float64)
        adj = np.zeros((k, 4), np.float64) if has_adj else None
        alive = np.ones(k, bool)
        nodes_tbl = snapshot.nodes_table
        for i in range(k):
            node_id = uids[i]
            node = nodes_tbl.get(node_id)
            if node is None or node.drain or not node.ready():
                alive[i] = False
                continue
            totals[i], res[i] = node_capacity_vecs(node)
            used[i] = mirror.get(node_id, zero4)
            if has_adj:
                fr = freed.get(node_id, zero4)
                pend = pending.get(node_id, zero4)
                adj[i] = (pend[0] - fr[0], pend[1] - fr[1],
                          pend[2] - fr[2], pend[3] - fr[3])

        load = used + res + add if not has_adj else used + adj + res + add
        ok = alive & np.all(load <= totals, axis=1)
        bad_mask = ~ok

        out = []
        partial = bool(bad_mask.any())
        if partial:
            metrics.incr_counter(
                "nomad.plan.dense_nodes_rejected", int(bad_mask.sum())
            )
            if self.logger.isEnabledFor(logging.DEBUG):
                for i in np.nonzero(bad_mask & alive)[0]:
                    self.logger.debug(
                        "dense re-check rejected node %s: used=%s add=%s totals=%s",
                        str(uids[i])[:8], used[i], add[i], totals[i],
                    )
        # Commit dense-node preemptions only when the node's dense
        # placements survived (per-node all-or-nothing, same as the
        # object path: a rejected node keeps its victims running).
        if dense_pre:
            uid_ok = {str(uids[i]): bool(ok[i]) for i in range(k)}
            for nid, allocs in dense_pre.items():
                if uid_ok.get(nid):
                    result.node_preemptions[nid] = allocs
        for bi, block in enumerate(blocks):
            if not partial:
                out.append(block)
                continue
            bmask = bad_mask[inv[offs[bi]:offs[bi + 1]]]
            if not bmask.any():
                out.append(block)
                continue
            keep = np.nonzero(~bmask)[0]
            if keep.size:
                out.append(block.select([int(x) for x in keep]))
        return out, partial

    @staticmethod
    def _batch_capacity_check(nodes, proposed_by_node) -> np.ndarray:
        """One vectorized cpu/mem/disk superset check over all touched
        nodes (the math of funcs.allocs_fit/ComparableResources.superset,
        columnized). Returns a [M] bool mask."""
        m = len(nodes)
        if m == 0:
            return np.zeros(0, bool)
        totals = np.zeros((m, 3), np.float64)
        used = np.zeros((m, 3), np.float64)
        for i, node in enumerate(nodes):
            nr = node.node_resources
            totals[i, 0] = nr.cpu_shares
            totals[i, 1] = nr.memory_mb
            totals[i, 2] = nr.disk_mb
            rr = node.reserved_resources
            if rr is not None:
                used[i, 0] += rr.cpu_shares
                used[i, 1] += rr.memory_mb
                used[i, 2] += rr.disk_mb
            for alloc in proposed_by_node[i]:
                if alloc.terminal_status():
                    continue
                cr = alloc.comparable_resources()
                used[i, 0] += cr.flattened.cpu_shares
                used[i, 1] += cr.flattened.memory_mb
                used[i, 2] += cr.shared.disk_mb
        return np.all(used <= totals, axis=1)

    @staticmethod
    def _node_discrete_checks(node, proposed) -> bool:
        """Port-collision / per-device-bandwidth / device-count checks —
        the parts of allocs_fit that are discrete structures, run only for
        nodes that passed the batched capacity check and only when the
        proposed set actually uses networks/devices."""
        has_networks = False
        has_devices = False
        for alloc in proposed:
            ar = alloc.allocated_resources
            if ar is None:
                continue
            if ar.shared.networks:
                has_networks = True
            for tr in ar.tasks.values():
                if tr.networks:
                    has_networks = True
                if getattr(tr, "devices", None):
                    has_devices = True
        if has_networks:
            net_idx = NetworkIndex()
            if net_idx.set_node(node) or net_idx.add_allocs(proposed):
                return False
            if net_idx.overcommitted():
                return False
        if has_devices:
            from ..structs.devices import DeviceAccounter

            accounter = DeviceAccounter(node)
            if accounter.add_allocs(proposed):
                return False
        return True

    def _build_payload(self, snapshot, plan: Plan, result: PlanResult) -> dict:
        """Flatten + stamp, attaching the plan's job (the same struct-sharing
        the reference relies on in UpsertPlanResults)."""
        alloc_updates: List[Allocation] = []
        for allocs in result.node_allocation.values():
            for alloc in allocs:
                existing = snapshot.alloc_by_id(alloc.id)
                alloc.create_index = existing.create_index if existing else 0
                if alloc.job is None:
                    alloc.job = plan.job
                alloc_updates.append(alloc)
        allocs_stopped: List[Allocation] = []
        for allocs in result.node_update.values():
            allocs_stopped.extend(allocs)
        allocs_preempted: List[Allocation] = []
        preemption_evals: List[Evaluation] = []
        preempted_job_ids = set()
        for allocs in result.node_preemptions.values():
            for alloc in allocs:
                allocs_preempted.append(alloc)
                existing = snapshot.alloc_by_id(alloc.id)
                if existing is not None:
                    preempted_job_ids.add((existing.namespace, existing.job_id))
        for namespace, job_id in preempted_job_ids:
            job = snapshot.job_by_id(namespace, job_id)
            if job is None:
                continue
            preemption_evals.append(
                Evaluation(
                    namespace=namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=EVAL_TRIGGER_PREEMPTION,
                    job_id=job_id,
                    status=EVAL_STATUS_PENDING,
                )
            )

        return {
            "alloc_updates": alloc_updates,
            "allocs_stopped": allocs_stopped,
            "allocs_preempted": allocs_preempted,
            # dense blocks ride the raft payload as-is (parallel arrays;
            # the FSM upserts them without materializing allocs)
            "dense_placements": result.dense_placements,
            "deployment": result.deployment,
            "deployment_updates": result.deployment_updates,
            "eval_id": plan.eval_id,
            "preemption_evals": preemption_evals,
            # stamped pre-apply so every replica arms identical deployment
            # progress deadlines
            "timestamp_ns": time.time_ns(),
        }

    def _evaluate_and_fold(self, batch: List[PendingPlan], snap):
        """Evaluate each queued plan against ``snap``, folding every
        non-noop result in so plan k+1 sees plan k's expected outcome
        (the pipelined optimism of plan_apply.go:45–70, applied within a
        batch). Noop results are responded immediately. Returns
        (items, capacity_delta, snap_ok, leftovers): ``items`` is the
        list of (pending, result, payload) to commit as one raft entry;
        ``capacity_delta`` predicts the epoch bumps their FSM apply will
        perform; ``snap_ok`` False means a fold failed and the snapshot
        must be discarded after dispatch — the un-evaluated remainder of
        the batch is handed back as ``leftovers``. A plan whose every
        placement was rejected (a noop result with a refresh index) is
        not answered here but returned in ``rejected``: its rejection may
        come from a plan whose apply is still in flight (the retained
        snapshot holds it, or an earlier plan of this batch folded in),
        and its worker must refresh to that apply's index, which only
        its commit gives (``_respond_rejected``)."""
        items: List[Tuple[PendingPlan, PlanResult, dict]] = []
        delta_total = 0
        snap_ok = True
        leftovers: List[PendingPlan] = []
        rejected: List[Tuple[PendingPlan, PlanResult]] = []
        for bi, pending in enumerate(batch):
            try:
                start = metrics.now()
                with phases.track("plan_evaluate"), \
                        _lifecycle.pipeline_stage("evaluate",
                                                  pending.plan.eval_id):
                    result = self.evaluate_plan(snap, pending.plan)
                metrics.measure_since("nomad.plan.evaluate", start)
                if result.is_noop():
                    if result.refresh_index:
                        rejected.append((pending, result))
                        continue
                    _lifecycle.on_apply(pending.plan.eval_id)
                    pending.future.set_result(result)
                    continue
                payload = self._build_payload(snap, pending.plan, result)
                # one bump for the combined object-alloc upsert (when
                # non-empty) plus one per dense block
                # (state_store.upsert_plan_results)
                delta = len(payload["dense_placements"])
                if (
                    payload["alloc_updates"] or payload["allocs_stopped"]
                    or payload["allocs_preempted"]
                ):
                    delta += 1
                if not self._fold_optimistic(snap, payload):
                    # a half-mutated snapshot cannot host further
                    # evaluations: commit what we have, re-run the rest
                    # of the batch on a fresh snapshot next iteration
                    snap_ok = False
                    delta_total += delta
                    items.append((pending, result, payload))
                    leftovers = list(batch[bi + 1:])
                    break
                delta_total += delta
                items.append((pending, result, payload))
            except Exception as e:  # noqa: BLE001 — isolate to this plan
                self.logger.exception("plan evaluation failed")
                if not pending.future.done():
                    pending.future.set_exception(e)
        return items, delta_total, snap_ok, leftovers, rejected

    @staticmethod
    def _respond_rejected(rejected: List[Tuple[PendingPlan, PlanResult]],
                          index: int) -> None:
        """Answer fully rejected plans with a refresh index no older than
        ``index``, the commit of every plan the evaluation saw as
        applied: a worker that re-plans from a snapshot at the committed
        index alone can miss the in-flight plan it conflicted with, pick
        the same ports or capacity again and be rejected again, until
        its attempts run out and its eval waits, blocked, for the
        periodic retry of failed evals."""
        for pending, result in rejected:
            result.refresh_index = max(result.refresh_index, index)
            _lifecycle.on_apply(pending.plan.eval_id)
            if not pending.future.done():
                pending.future.set_result(result)

    def _fold_optimistic(self, snap, payload: dict) -> bool:
        """Optimistic application to the applier's private snapshot: the
        raft log is the pessimistic truth; this view lets the next plan
        verify against this one's expected outcome during apply latency.
        Returns False when the fold failed (snapshot must be discarded)."""
        guess_index = self.fsm.state.latest_index + 1
        try:
            # deployment COPIED: the store keeps (and index-stamps) the
            # object it is given, and this one is also headed into the
            # real FSM via raft — sharing it would alias two state stores
            # to one mutable instance across threads
            deployment = payload["deployment"]
            snap.upsert_plan_results(
                guess_index,
                alloc_updates=payload["alloc_updates"],
                allocs_stopped=payload["allocs_stopped"],
                allocs_preempted=payload["allocs_preempted"],
                # dense blocks CLONED for the same aliasing reason: the
                # in-proc raft hands the payload's block objects straight
                # to the FSM store, whose commit stamp must not race with
                # snapshot readers materializing against our provisional
                # guess-index stamp
                dense_placements=[
                    b.clone_for_snapshot()
                    for b in payload["dense_placements"]
                ],
                deployment=deployment.copy() if deployment is not None else None,
                deployment_updates=payload["deployment_updates"],
                eval_id=payload["eval_id"],
                timestamp_ns=payload["timestamp_ns"],
            )
            return True
        except Exception:  # noqa: BLE001 — optimism only; raft is truth,
            # but a half-mutated snapshot must not be reused
            self.logger.exception("optimistic snapshot apply failed")
            return False

    def _dispatch_batch(self, items: List[Tuple[PendingPlan, PlanResult, dict]],
                        rejected: Sequence[Tuple[PendingPlan, PlanResult]] = ()) -> Future:
        """Fire ONE raft apply for the whole batch (plan_apply.go
        applyPlan + asyncPlanWait, batched): respond to every waiting
        worker from the apply waiter; the returned future resolves to
        the committed index (0 on failure). The plans of the same
        evaluation that were rejected whole (``rejected``) are answered
        after the commit, their refresh index raised to it."""
        payloads = [payload for _, _, payload in items]
        index_future: Future = Future()

        def waiter() -> None:
            try:
                start = metrics.now()
                commit_t0 = _lifecycle.pipeline_now()
                with phases.track("raft_fsm"):
                    index, errors = self.raft.apply(
                        self.peer, APPLY_PLAN_RESULTS_BATCH, payloads
                    )
                metrics.measure_since("nomad.plan.apply", start)
                commit_t1 = _lifecycle.pipeline_now()
                for i, (pending, result, payload) in enumerate(items):
                    # one commit-stage span per wave in the batched entry
                    _lifecycle.pipeline_record(
                        "commit", payload["eval_id"], commit_t0, commit_t1
                    )
                    # per-payload isolation (fsm._apply_plan_results_batch):
                    # a failed payload must not be reported as committed,
                    # and committed ones must not be reported as failed
                    err = errors[i] if isinstance(errors, list) else None
                    if err is not None:
                        pending.future.set_exception(
                            RuntimeError(f"plan apply failed in FSM: {err}")
                        )
                        continue
                    result.alloc_index = index
                    if result.refresh_index:
                        result.refresh_index = max(result.refresh_index, index)
                    # Stamp result allocs (the scheduler checks
                    # create==modify for "new")
                    for alloc in payload["alloc_updates"]:
                        stored = self.fsm.state.alloc_by_id(alloc.id)
                        if stored is not None:
                            alloc.create_index = stored.create_index
                            alloc.modify_index = stored.modify_index
                    _lifecycle.on_apply(payload["eval_id"])
                    pending.future.set_result(result)
                self._respond_rejected(rejected, index)
                index_future.set_result(index)
            except Exception as e:  # noqa: BLE001
                self.logger.exception("raft apply of plan batch failed")
                for pending, _, _ in items:
                    if not pending.future.done():
                        pending.future.set_exception(e)
                self._respond_rejected(rejected, 0)
                index_future.set_result(0)

        threading.Thread(target=waiter, name="plan-apply-wait", daemon=True).start()
        return index_future

    def apply_plan(self, plan: Plan) -> PlanResult:
        """Synchronous evaluate+apply (tests / direct callers); the
        pipelined loop in _run is the production path."""
        snapshot = self.fsm.state.snapshot()
        start = metrics.now()
        result = self.evaluate_plan(snapshot, plan)
        metrics.measure_since("nomad.plan.evaluate", start)
        if result.is_noop():
            return result
        pending = PendingPlan(plan)
        payload = self._build_payload(snapshot, plan, result)
        self._fold_optimistic(snapshot, payload)
        self._dispatch_batch([(pending, result, payload)])
        return pending.future.result(timeout=60)
