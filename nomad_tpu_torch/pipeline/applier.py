"""Async applier: streams completed device waves into batched raft
entries off the dispatch thread, and hands the ack back to the broker.

The classic eval lifecycle parks the scheduler worker on the plan
future for the whole evaluate -> raft-commit tail, so a worker thread
can hold at most one wave in the pipeline at a time — at C1M scale the
fast device convoys behind the slow host tail. Here the worker hands a
device-built dense plan to ``try_submit`` and immediately returns to
the broker for the next eval; this applier owns the wave from plan
enqueue to broker ack:

  worker (dispatch stage)                 applier thread
    try_submit(plan, token) ──────────────► plan_queue.enqueue
      · pauses the broker nack timer          │ (Planner evaluates +
      · worker does NOT ack; returns          │  batches raft commits)
        to the broker immediately             ▼
                                          completion queue (bounded)
                                              │
                          full commit ◄───────┴──► partial commit
                              │                        │
                    wait_min_index(alloc_index)   redispatch (bounded
                              │                   attempts; cached
                        broker.ack                encode re-entry) or
                                                  broker.nack

Per-payload failure isolation comes from the Planner's batched waiter
(one raft entry per batch, per-payload error list from the FSM): a
poisoned wave resolves its OWN future with the error and is nacked
here; its batch-mates commit and ack normally. The watchdog sweep
bounds how long any accepted wave can sit unacked — ``ack_timeout_s``
after its last (re)enqueue it is force-nacked back to the broker, so a
stuck pipeline degrades to the classic retry path instead of
stranding evals.

Stage discipline (enforced by the ``pipeline-stage-discipline`` lint
rule): nothing in this package applies raft entries or writes the state
store directly — commits go through the plan queue, acks through the
broker, and stage handoff only through bounded queues.

Copied from ``nomad_tpu/pipeline/applier.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..server.eval_broker import NotOutstandingError, TokenMismatchError
from ..server.raft import NotLeaderError
from ..structs.structs import Plan, PlanResult
from ..utils import metrics
from .queues import BoundedStageQueue
from .redispatch import Redispatcher, WaveEncodeRegistry
from ..utils.lock_witness import witness_lock
from ..utils.race_witness import tracked_dict, tracked_list

logger = logging.getLogger("nomad_tpu_torch.pipeline.applier")


class _Wave:
    """One eval's dense plan in flight between submit and ack."""

    __slots__ = ("plan", "token", "attempts", "deadline", "not_before",
                 "done")

    def __init__(self, plan: Plan, token: str, deadline: float) -> None:
        self.plan = plan
        self.token = token
        self.attempts = 0
        self.deadline = deadline
        self.not_before = 0.0   # redispatch backoff gate (monotonic)
        self.done = False


class AsyncApplier:
    """Owns the evaluate/commit/ack tail of device-built dense plans.

    One instance per server; enabled only while leader (the plan queue
    and broker it drives are leader-only too). All state is bounded:
    ``inflight_max`` concurrent waves (a counting semaphore the worker
    polls non-blockingly — a full pipeline falls back to the classic
    synchronous submit, never queues unboundedly), one bounded
    completion queue, and a bounded per-wave redispatch budget.
    """

    def __init__(self, server, inflight_max: int = 128,
                 redispatch_max: int = 2,
                 ack_timeout_s: float = 30.0,
                 redispatch_backoff_s: float = 0.05,
                 redispatch_backoff_max_s: float = 1.0,
                 backpressure_wait_s: float = 0.02) -> None:
        self.server = server
        self.inflight_max = max(1, int(inflight_max))
        self.redispatch_max = max(0, int(redispatch_max))
        self.ack_timeout_s = float(ack_timeout_s)
        self.redispatch_backoff_s = max(0.0, float(redispatch_backoff_s))
        self.redispatch_backoff_max_s = max(
            self.redispatch_backoff_s, float(redispatch_backoff_max_s))
        self.backpressure_wait_s = max(0.0, float(backpressure_wait_s))

        self.registry = WaveEncodeRegistry()
        self.redispatcher = Redispatcher(server, self.registry)

        self._slots = threading.Semaphore(self.inflight_max)
        # every completion entry corresponds to a held slot, so the
        # queue can never actually fill past inflight_max — puts are
        # effectively non-blocking, the bound is the discipline
        self._completions = BoundedStageQueue(
            self.inflight_max + 1, name="wave-completions")
        self._lock = witness_lock("applier.AsyncApplier._lock")
        self._waves: Dict[str, _Wave] = tracked_dict(
            "applier.AsyncApplier._waves", {})
        # waves parked between redispatches (backoff); drained by _sweep
        self._deferred: List[_Wave] = tracked_list(
            "applier.AsyncApplier._deferred", [])
        self._enabled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        if enabled:
            with self._lock:
                if self._enabled:
                    return
                self._enabled = True
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pipeline-applier", daemon=True)
            self._thread.start()
        else:
            with self._lock:
                if not self._enabled:
                    return
                self._enabled = False
                waves = list(self._waves.values())
                self._deferred.clear()
            self._stop.set()
            # leadership is gone: the broker flush already closed the
            # unacks; just release the slots and drop the bookkeeping.
            # _mark_done arbitrates with a racing _finish so each slot
            # is released exactly once.
            for rec in waves:
                if self._mark_done(rec):
                    self._slots.release()
            self.registry.clear()
            t = self._thread
            self._thread = None
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- dispatch-stage entry point (worker thread) ----------------------

    def try_submit(self, plan: Plan, token: str) -> bool:
        """Take ownership of a dense plan's commit + ack, or return False
        so the worker falls back to the classic synchronous submit.
        Called on the worker (dispatch-stage) thread; everything here is
        bounded — the longest wait is one ``backpressure_wait_s`` slot
        wait when the pipeline is full."""
        if not self._enabled or not getattr(plan, "async_ok", False):
            return False
        # async-eligible shape: device-built dense placements only. Any
        # object-path cargo (stops, preemptions, deployments,
        # annotations) keeps the worker's synchronous path, whose caller
        # inspects those results in ways a deferred commit can't honor.
        if (
            not plan.dense_placements
            or plan.node_allocation or plan.node_update
            or plan.node_preemptions
            or plan.deployment is not None or plan.deployment_updates
            or plan.annotations is not None
        ):
            return False
        if not self._slots.acquire(blocking=False):
            # explicit backpressure: the pipeline is full (an unblock
            # storm re-enqueued more waves than inflight_max). Defer with
            # one bounded wait for a slot instead of immediately falling
            # back — a transient spike degrades to a slightly-delayed
            # async submit; only sustained saturation convoys onto the
            # classic synchronous path below.
            metrics.incr_counter("nomad.pipeline.backpressure")
            if (self.backpressure_wait_s <= 0 or not self._slots.acquire(
                    timeout=self.backpressure_wait_s)):
                metrics.incr_counter("nomad.pipeline.slots_exhausted")
                return False
        try:
            # the broker must not redeliver while the wave sits in the
            # plan queue; the watchdog sweep below is the new bound
            self.server.eval_broker.pause_nack_timeout(plan.eval_id, token)
        except (NotOutstandingError, TokenMismatchError):
            self._slots.release()
            return False
        rec = _Wave(plan, token, time.monotonic() + self.ack_timeout_s)
        with self._lock:
            if not self._enabled:
                self._slots.release()
                return False
            self._waves[plan.eval_id] = rec
        if not self._enqueue(rec):
            if self._mark_done(rec):
                self._slots.release()
            return False
        metrics.incr_counter("nomad.pipeline.submitted")
        return True

    def remember_wave(self, eval_id: str, enc, job, node_epoch: int) -> None:
        """Engine hook: stash the wave's encode for possible re-dispatch
        (engine._pipeline_remember)."""
        if self._enabled:
            self.registry.remember(eval_id, enc, job, node_epoch)

    # -- applier thread --------------------------------------------------

    def _enqueue(self, rec: _Wave) -> bool:
        try:
            pending = self.server.plan_queue.enqueue(rec.plan)
        except Exception:  # noqa: BLE001 — queue disabled (leader churn)
            return False
        pending.future.add_done_callback(
            lambda fut, r=rec: self._completions.put((r, fut))
        )
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                rec, fut = self._completions.get(timeout=0.25)
            except Exception:  # queue.Empty
                self._sweep()
                continue
            try:
                self._handle(rec, fut)
            except Exception:  # noqa: BLE001 — never kill the applier
                logger.exception("wave handling failed")
                self._finish(rec, ack=False, why="handler_error")
            self._sweep()

    def _handle(self, rec: _Wave, fut) -> None:
        if rec.done:
            return  # watchdog or shutdown got here first
        try:
            result: PlanResult = fut.result()
        except NotLeaderError:
            # leadership lost mid-apply: this node can no longer commit
            # anything, so redispatching would only re-fail — or worse,
            # double-commit after the new leader reruns the eval. Nack
            # straight back (best-effort: the revoke-time broker flush may
            # already have closed the unack) and let the new leader's
            # eval restore redeliver the wave.
            metrics.incr_counter("nomad.pipeline.not_leader")
            self._finish(rec, ack=False, why="not_leader")
            return
        except Exception:  # noqa: BLE001 — per-payload FSM error
            metrics.incr_counter("nomad.pipeline.apply_error")
            self._finish(rec, ack=False, why="apply_error")
            return
        committed, expected, actual = result.full_commit(rec.plan)
        if committed:
            self._finish_ack(rec, result)
            return
        metrics.incr_counter("nomad.pipeline.partial_commit")
        logger.debug("partial commit for %s: attempted %d placed %d",
                     rec.plan.eval_id[:8], expected, actual)
        if rec.attempts >= self.redispatch_max:
            self._finish(rec, ack=False, why="redispatch_exhausted")
            return
        retry = None
        try:
            retry = self.redispatcher.build_retry(rec.plan, result)
        except Exception:  # noqa: BLE001
            logger.exception("redispatch failed for %s", rec.plan.eval_id[:8])
        if retry is None:
            self._finish(rec, ack=False, why="no_redispatch")
            return
        rec.plan = retry
        rec.attempts += 1
        # exponential backoff between redispatches: a flapping apply path
        # (OCC livelock, injected faults) degrades to spaced retries
        # instead of hot-looping device dispatches. The ack-timeout clock
        # restarts AFTER the backoff so the watchdog bound stays
        # per-attempt, not per-wave.
        delay = min(self.redispatch_backoff_s * (2 ** (rec.attempts - 1)),
                    self.redispatch_backoff_max_s)
        now = time.monotonic()
        rec.deadline = now + delay + self.ack_timeout_s
        if delay > 0:
            rec.not_before = now + delay
            metrics.incr_counter("nomad.pipeline.redispatch_deferred")
            with self._lock:
                if not self._enabled or rec.done:
                    return
                self._deferred.append(rec)
            return
        if not self._enqueue(rec):
            self._finish(rec, ack=False, why="queue_disabled")

    def _finish_ack(self, rec: _Wave, result: PlanResult) -> None:
        # wait-index handoff: the worker never blocked on this commit,
        # so make sure the local store observed the commit index before
        # the ack releases the next same-job eval to a worker that will
        # immediately snapshot
        idx = result.alloc_index or result.refresh_index
        if idx:
            try:
                self.server.fsm.state.wait_min_index(idx, timeout=5.0)
            except Exception:  # noqa: BLE001 — ack anyway; workers
                pass           # re-wait via shared_snapshot_min_index
        self._finish(rec, ack=True)

    def _mark_done(self, rec: _Wave) -> bool:
        """Exactly-once done transition, arbitrated under the lock. The
        caller that wins owns the wave's slot release / broker token —
        every other path (watchdog, shutdown, completion) loses the race
        cleanly instead of double-releasing."""
        with self._lock:
            if rec.done:
                return False
            rec.done = True
            self._waves.pop(rec.plan.eval_id, None)
            return True

    def _finish(self, rec: _Wave, ack: bool, why: str = "") -> None:
        if not self._mark_done(rec):
            return
        self.registry.forget(rec.plan.eval_id)
        broker = self.server.eval_broker
        try:
            if ack:
                broker.ack(rec.plan.eval_id, rec.token)
                metrics.incr_counter("nomad.pipeline.acked")
            else:
                broker.nack(rec.plan.eval_id, rec.token)
                metrics.incr_counter("nomad.pipeline.nacked")
                if why:
                    metrics.incr_counter(f"nomad.pipeline.nack.{why}")
        except (NotOutstandingError, TokenMismatchError):
            pass  # broker flushed (leader churn) or timer already fired
        except Exception:  # noqa: BLE001
            logger.exception("broker %s failed for %s",
                             "ack" if ack else "nack", rec.plan.eval_id[:8])
        finally:
            self._slots.release()

    def _sweep(self) -> None:
        """Watchdog + backoff pump: re-enqueue deferred redispatches whose
        backoff has elapsed, then force-nack any accepted wave sitting
        unacked past its deadline back to the broker's classic retry
        path. Runs at least every 0.25s (the completion-get timeout), so
        that is the effective backoff granularity."""
        now = time.monotonic()
        with self._lock:
            due = [r for r in self._deferred
                   if not r.done and r.not_before <= now]
            self._deferred[:] = [r for r in self._deferred
                                 if not r.done and r.not_before > now]
        for rec in due:
            if not self._enqueue(rec):
                self._finish(rec, ack=False, why="queue_disabled")
        with self._lock:
            overdue = [r for r in self._waves.values()
                       if not r.done and now > r.deadline]
        for rec in overdue:
            metrics.incr_counter("nomad.pipeline.watchdog_nack")
            logger.warning("wave %s unacked past %.1fs; force-nacking",
                           rec.plan.eval_id[:8], self.ack_timeout_s)
            self._finish(rec, ack=False, why="watchdog")

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            inflight = len(self._waves)
            deferred = len(self._deferred)
        out = {
            "inflight": inflight,
            "deferred": deferred,
            "completion_depth": self._completions.depth(),
            "encode_registry": len(self.registry),
            "slots_free": self.inflight_max - inflight,
        }
        batcher = getattr(self.server, "device_batcher", None)
        if batcher is not None:
            out["batcher_queue_depth"] = batcher.queue_depth()
        return out
