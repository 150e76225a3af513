"""Blocked-evaluations tracker: unblocks on capacity changes.

Semantics follow reference ``nomad/blocked_evals.go`` — evals that failed
placement wait keyed by computed node class (captured vs escaped), and are
re-enqueued when new capacity (node updates, alloc stops) appears. The
system-scheduler variant tracks per-node blocks (blocked_evals_system.go).

Unblock storms: one capacity burst (a wave of node registrations, a big
plan's stopped allocs) arrives as MANY triggers — per-class, per-node and
per-quota capacity changes, each of which would re-enqueue its interested
evals immediately. With ``coalesce_window_s > 0`` the triggers instead
stage their evals into a pending batch; a flush timer drains the batch as
ONE ``enqueue_all`` per window, deduped across triggers (an eval collected
by both a class and a node trigger re-enqueues once, carrying the highest
capacity index it witnessed). Each flush is capped at ``max_batch`` evals —
the remainder defers to the next window — so a 10K-eval storm reaches the
broker as bounded batches instead of one giant lock-hold + wakeup spike.
The flush path carries the ``unblock_enqueue`` chaos fire point: an
injected fault parks the batch and retries on a bounded-backoff timer
(degrade, never drop).

Copied from ``nomad_tpu/server/blocked_evals.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..chaos.injector import fire as chaos_fire
from ..structs.structs import EVAL_STATUS_PENDING, EVAL_TRIGGER_MAX_PLANS, Evaluation
from ..trace import capacity
from ..utils import metrics
from ..utils.lock_witness import witness_rlock
from ..utils.race_witness import tracked_dict

UNBLOCK_FAILED_INTERVAL = 60.0  # periodic retry of max-plan-failed evals

# retry backoff for a flush whose enqueue faulted (chaos or transient):
# bounded, so a flapping enqueue path degrades to spaced batches
FLUSH_RETRY_BACKOFF_S = 0.05


class BlockedEvals:
    def __init__(self, eval_broker, coalesce_window_s: float = 0.0,
                 max_batch: int = 512) -> None:
        self.eval_broker = eval_broker
        self.coalesce_window_s = max(0.0, float(coalesce_window_s))
        self.max_batch = max(1, int(max_batch))
        self._lock = witness_rlock("blocked_evals.BlockedEvals._lock")
        self.enabled = False

        # eval id -> eval
        self.captured: Dict[str, Evaluation] = {}
        # evals whose constraints escaped computed classes: unblock on any change
        self.escaped: Dict[str, Evaluation] = {}
        # eval id -> broker token held when the eval was blocked; a non-empty
        # token means the eval is still outstanding in the broker and must be
        # re-enqueued via the requeue-after-ack path (reference wrappedEval)
        self.tokens: Dict[str, str] = {}
        # (namespace, job id) -> eval id, to dedup per job
        self.job_blocks: Dict[Tuple[str, str], str] = {}
        # node id -> eval ids (system scheduler per-node blocks)
        self.system_blocks: Dict[str, Set[str]] = {}
        # class -> eval ids interested
        self.capacity_classes: Dict[str, Set[str]] = {}
        # evals blocked due to max plan attempts, retried periodically
        self.failed: Dict[str, Evaluation] = {}
        # capacity witnesses, to catch events racing the block window:
        # class -> index, node id -> index, quota -> index
        self.unblock_indexes: Dict[str, int] = {}
        self.node_unblock_indexes: Dict[str, int] = {}
        self.quota_unblock_indexes: Dict[str, int] = {}
        self.stats_blocked = 0

        # coalesced unblock staging: eval id -> (eval, token, index).
        # Triggers land evals here; the flush timer (or a synchronous
        # flush when coalesce_window_s == 0) drains it in bounded batches.
        self._pending: Dict[str, Tuple[Evaluation, str, int]] = tracked_dict(
            "blocked_evals.BlockedEvals._pending", {})
        self._flush_timer: Optional[threading.Timer] = None
        # cumulative storm counters (EmitStats parity + artifact fields)
        self.stats_unblocks = 0          # evals re-enqueued through flushes
        self.stats_unblock_batches = 0   # enqueue_all batches issued
        self.stats_dups_coalesced = 0    # cross-trigger dedup hits
        self.stats_unblock_deferred = 0  # flushes deferred (cap or fault)

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev = self.enabled
            self.enabled = enabled
        if prev and not enabled:
            self.flush()

    # ------------------------------------------------------------------

    def block(self, evaluation: Evaluation) -> None:
        """Track a blocked eval (no broker token — use ``reblock`` when the
        eval is still outstanding in the broker)."""
        with self._lock:
            self._process_block(evaluation, "")

    def reblock(self, evaluation: Evaluation, token: str) -> None:
        """Worker reblock of a still-outstanding eval (reference
        blocked_evals.go Reblock). On the leader the FSM eval-upsert hook has
        usually already captured the eval with an empty token; this records
        the delivery token on the tracked entry."""
        with self._lock:
            self._process_block(evaluation, token)

    def _process_block(self, evaluation: Evaluation, token: str) -> None:
        if not self.enabled:
            return
        if (
            evaluation.id in self.captured
            or evaluation.id in self.escaped
            or evaluation.id in self.failed
        ):
            # Already tracked (e.g. the FSM hook captured it before the
            # worker's reblock): record the non-empty token so the unblock
            # path can requeue-after-ack.
            if token:
                self.tokens[evaluation.id] = token
            return

        # Missed-unblock check (reference blocked_evals.go:202): if
        # relevant capacity appeared after the eval's snapshot, don't
        # block — re-enqueue right away.
        if self._missed_unblock(evaluation):
            new_eval = evaluation.copy()
            new_eval.status = EVAL_STATUS_PENDING
            self.eval_broker.enqueue_all({new_eval.id: (new_eval, token)})
            return

        # Dedup by job: keep the latest eval per job. Token is stored only
        # once the eval is actually tracked, so dropped evals don't leak
        # token entries.
        namespaced = (evaluation.namespace, evaluation.job_id)
        existing_id = self.job_blocks.get(namespaced)
        if existing_id is not None:
            existing = self.captured.get(existing_id) or self.escaped.get(existing_id)
            if existing is not None and existing.create_index >= evaluation.create_index:
                return
            self._remove(existing_id)
        self.job_blocks[namespaced] = evaluation.id
        if token:
            self.tokens[evaluation.id] = token

        if evaluation.triggered_by == EVAL_TRIGGER_MAX_PLANS:
            self.failed[evaluation.id] = evaluation
            return

        if evaluation.node_id:
            self.system_blocks.setdefault(evaluation.node_id, set()).add(evaluation.id)
            self.captured[evaluation.id] = evaluation
            return

        if evaluation.escaped_computed_class:
            self.escaped[evaluation.id] = evaluation
            return

        self.captured[evaluation.id] = evaluation
        # Index interest: eligible classes and unseen classes both unblock.
        for cls, eligible in (evaluation.class_eligibility or {}).items():
            if eligible:
                self.capacity_classes.setdefault(cls, set()).add(evaluation.id)

    def _missed_unblock(self, evaluation: Evaluation) -> bool:
        if evaluation.triggered_by == EVAL_TRIGGER_MAX_PLANS:
            return False
        snapshot = evaluation.snapshot_index
        if (
            evaluation.node_id
            and self.node_unblock_indexes.get(evaluation.node_id, 0) > snapshot
        ):
            return True
        if (
            evaluation.quota_limit_reached
            and self.quota_unblock_indexes.get(evaluation.quota_limit_reached, 0)
            > snapshot
        ):
            return True
        elig = evaluation.class_eligibility or {}
        for cls, index in self.unblock_indexes.items():
            if index <= snapshot:
                continue
            if evaluation.escaped_computed_class:
                return True
            # capacity in an eligible class, or a class the eval never saw
            if elig.get(cls, None) is not False:
                return True
        return False

    def _remove(self, eval_id: str) -> None:
        ev = self.captured.pop(eval_id, None) or self.escaped.pop(eval_id, None) \
            or self.failed.pop(eval_id, None)
        self.tokens.pop(eval_id, None)
        if ev is not None:
            self.job_blocks.pop((ev.namespace, ev.job_id), None)
        for ids in self.capacity_classes.values():
            ids.discard(eval_id)
        for ids in self.system_blocks.values():
            ids.discard(eval_id)

    def untrack(self, namespace: str, job_id: str) -> None:
        """Stop tracking blocked evals for a job (e.g. on deregister)."""
        with self._lock:
            eval_id = self.job_blocks.get((namespace, job_id))
            if eval_id:
                self._remove(eval_id)

    # ------------------------------------------------------------------

    def unblock(self, computed_class: str, index: int) -> None:
        """New capacity in a computed class: re-enqueue interested evals."""
        with self._lock:
            if not self.enabled:
                return
            self.unblock_indexes[computed_class] = index
            unblock: List[Evaluation] = []
            # escaped evals unblock on any change
            unblock.extend(self.escaped.values())
            self.escaped.clear()
            # captured evals: eligible for this class, or class unseen
            seen_ids = self.capacity_classes.pop(computed_class, set())
            for eval_id in list(self.captured):
                ev = self.captured[eval_id]
                elig = ev.class_eligibility or {}
                if eval_id in seen_ids or computed_class not in elig:
                    unblock.append(ev)
                    del self.captured[eval_id]
            self._enqueue(unblock, index)

    def unblock_node(self, node_id: str, index: int) -> None:
        with self._lock:
            if not self.enabled:
                return
            self.node_unblock_indexes[node_id] = index
            ids = self.system_blocks.pop(node_id, set())
            unblock = [self.captured.pop(i) for i in ids if i in self.captured]
            self._enqueue(unblock, index)

    def unblock_failed(self) -> None:
        """Periodic retry of plan-conflict (max-plans) blocked evals."""
        with self._lock:
            if not self.enabled:
                return
            unblock = list(self.failed.values())
            self.failed.clear()
            self._enqueue(unblock, 0)

    def unblock_quota(self, quota: str, index: int) -> None:
        with self._lock:
            if not self.enabled:
                return
            self.quota_unblock_indexes[quota] = index
            unblock = []
            for eval_id in list(self.captured):
                ev = self.captured[eval_id]
                if ev.quota_limit_reached == quota:
                    unblock.append(ev)
                    del self.captured[eval_id]
            self._enqueue(unblock, index)

    def _enqueue(self, evals: List[Evaluation], index: int) -> None:
        """Stage unblocked evals for a coalesced broker re-enqueue.

        Called under the lock by every trigger (class/node/quota/failed).
        An eval two triggers both collected inside one window dedups here
        and keeps the highest capacity index it witnessed (its refreshed
        snapshot_index must cover every capacity change that unblocked
        it, or the next block would spuriously look missed)."""
        for ev in evals:
            self.job_blocks.pop((ev.namespace, ev.job_id), None)
            token = self.tokens.pop(ev.id, "")
            ev_index = index
            prev = self._pending.get(ev.id)
            if prev is not None:
                self.stats_dups_coalesced += 1
                token = token or prev[1]
                ev_index = max(ev_index, prev[2])
            self._pending[ev.id] = (ev, token, ev_index)
        if not self._pending:
            return
        if self.coalesce_window_s <= 0:
            self._flush_pending_locked()
        else:
            self._schedule_flush_locked(self.coalesce_window_s)

    def _schedule_flush_locked(self, delay: float) -> None:
        if self._flush_timer is not None:
            return
        t = threading.Timer(delay, self._flush_timer_fire)
        t.daemon = True
        self._flush_timer = t
        t.start()

    def _flush_timer_fire(self) -> None:
        with self._lock:
            self._flush_timer = None
            if not self.enabled:
                self._pending.clear()
                return
            self._flush_pending_locked()

    def _flush_pending_locked(self) -> None:
        """Drain the staged batch into the broker, ``max_batch`` evals per
        ``enqueue_all``. In windowed mode the remainder past the cap defers
        to the next window tick (the spike bound); synchronous mode loops
        so callers that expect unblock-then-ready semantics keep them. An
        injected ``unblock_enqueue`` fault re-parks the batch and retries
        on a bounded-backoff timer."""
        while self._pending:
            chunk_ids = list(self._pending)[: self.max_batch]
            batch = {}
            for eid in chunk_ids:
                ev, token, index = self._pending[eid]
                new_eval = ev.copy()
                new_eval.status = EVAL_STATUS_PENDING
                new_eval.snapshot_index = index
                batch[eid] = (new_eval, token)
            try:
                # ChaosFault subclasses RuntimeError; production stays on
                # the fire-only import surface and catches the base
                chaos_fire("unblock_enqueue", batch=len(batch))
            except RuntimeError:
                self.stats_unblock_deferred += 1
                metrics.incr_counter("nomad.blocked_evals.unblock_deferred")
                self._schedule_flush_locked(
                    max(self.coalesce_window_s, FLUSH_RETRY_BACKOFF_S))
                return
            for eid in chunk_ids:
                del self._pending[eid]
            self.eval_broker.enqueue_all(batch)
            self.stats_unblock_batches += 1
            self.stats_unblocks += len(batch)
            capacity.record_batch(len(batch))
            capacity.mark_unblocked(batch)
            if self._pending and self.coalesce_window_s > 0:
                self.stats_unblock_deferred += 1
                metrics.incr_counter("nomad.blocked_evals.unblock_deferred")
                self._schedule_flush_locked(self.coalesce_window_s)
                return

    # ------------------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            self.captured.clear()
            self.escaped.clear()
            self.job_blocks.clear()
            self.system_blocks.clear()
            self.capacity_classes.clear()
            self.failed.clear()
            self.unblock_indexes.clear()
            self.node_unblock_indexes.clear()
            self.quota_unblock_indexes.clear()
            self.tokens.clear()
            # staged-but-unflushed unblocks die with leadership: the new
            # leader's eval restore re-enqueues anything non-terminal
            self._pending.clear()
            timer = self._flush_timer
            self._flush_timer = None
        if timer is not None:
            timer.cancel()

    def stats(self) -> Dict[str, int]:
        """EmitStats parity (blocked_evals.go:774): depth gauges plus the
        storm counters the capacity-pressure SLO gate reads."""
        with self._lock:
            return {
                "total_blocked": len(self.captured) + len(self.escaped),
                "total_escaped": len(self.escaped),
                "total_failed": len(self.failed),
                "total_captured": len(self.captured),
                "total_system_blocked": sum(
                    len(ids) for ids in self.system_blocks.values()
                ),
                "pending_unblocks": len(self._pending),
                "unblocks_total": self.stats_unblocks,
                "unblock_batches": self.stats_unblock_batches,
                "unblock_dups_coalesced": self.stats_dups_coalesced,
                "unblock_deferred": self.stats_unblock_deferred,
            }
