"""Evaluation broker: leader-only priority queue with at-least-once delivery.

Semantics follow reference ``nomad/eval_broker.go`` — per-scheduler priority
heaps, per-job serialization, Nack timers with compounding re-enqueue delay,
a delivery limit feeding the ``_failed`` queue, and a delay heap for
``wait_until`` evals.

Copied from ``nomad_tpu/server/eval_broker.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. One
change, Nomad's own since 1.4.3 (eval_broker.go): when a job's eval in
flight is acked, the newest of the evals blocked behind it runs next and
the older ones it supersedes become cancelable (``take_cancelable``; the
leader marks them canceled through raft), where the reference ran every
one in turn. A fleet's heartbeats lost at once make an eval per job per
node; run one by one they kept a crashed-and-rejoined cluster busy past
its settle (thousands blocked in the broker), each run reconciling the
same job state the newest one reads.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos.injector import fire as chaos_fire
from ..structs.structs import Evaluation, generate_uuid
from ..trace import capacity as _capacity
from ..trace import lifecycle as _trace
from ..utils.lock_witness import witness_rlock
from ..utils.race_witness import tracked_dict

FAILED_QUEUE = "_failed"

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
DEFAULT_INITIAL_NACK_DELAY = 1.0
DEFAULT_SUBSEQUENT_NACK_DELAY = 20.0


class NotOutstandingError(Exception):
    pass


class TokenMismatchError(Exception):
    pass


class _PendingHeap:
    """Priority heap: higher priority first, FIFO within a priority."""

    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, Evaluation]] = []
        self._counter = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._heap, (-ev.priority, next(self._counter), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def drain_newest_first(self) -> List[Evaluation]:
        """Empty the heap; the evals newest first (highest modify index,
        then the latest pushed)."""
        items = sorted(self._heap, key=lambda e: (e[2].modify_index, e[1]), reverse=True)
        self._heap = []
        return [e[2] for e in items]

    def peek(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)


class _Unack:
    __slots__ = ("eval", "token", "nack_timer")

    def __init__(self, eval: Evaluation, token: str, nack_timer: threading.Timer):
        self.eval = eval
        self.token = token
        self.nack_timer = nack_timer


class EvalBroker:
    def __init__(
        self,
        nack_timeout: float = DEFAULT_NACK_TIMEOUT,
        delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
        initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
        subsequent_nack_delay: float = DEFAULT_SUBSEQUENT_NACK_DELAY,
    ) -> None:
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay

        self._lock = witness_rlock("eval_broker.EvalBroker._lock")
        self._cond = threading.Condition(self._lock)
        self.enabled = False

        # eval id -> delivery attempts
        self.evals: Dict[str, int] = tracked_dict(
            "eval_broker.EvalBroker.evals", {})
        # (namespace, job id) -> eval id currently queued/outstanding
        self.job_evals: Dict[Tuple[str, str], str] = {}
        # (namespace, job id) -> heap of blocked-behind evals
        self.blocked: Dict[Tuple[str, str], _PendingHeap] = {}
        # blocked evals a newer one superseded, for the leader to cancel
        self.cancelable: List[Evaluation] = []
        # scheduler type -> ready heap
        self.ready: Dict[str, _PendingHeap] = {}
        # eval id -> unack record
        self.unack: Dict[str, _Unack] = tracked_dict(
            "eval_broker.EvalBroker.unack", {})
        # token -> eval to requeue on Ack
        self.requeue: Dict[str, Evaluation] = {}
        # eval id -> wait timer (Evaluation.wait_ns)
        self.time_wait: Dict[str, threading.Timer] = {}
        # delayed evals (wait_until) handled by a timer per eval too
        self._delayed: Dict[str, threading.Timer] = {}
        # workers currently parked in dequeue() waiting for a ready eval
        # (flight-recorder probe: high waiters + nonzero ready = dequeue
        # contention; high waiters + zero ready = starvation upstream)
        self._dequeue_waiters = 0

    # ------------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev = self.enabled
            self.enabled = enabled
        if prev and not enabled:
            self.flush()

    # ------------------------------------------------------------------

    def enqueue(self, evaluation: Evaluation) -> None:
        with self._lock:
            self._process_enqueue(evaluation, "")

    def enqueue_all(self, evals: Dict[str, Tuple[Evaluation, str]]) -> None:
        """{eval_id: (eval, token)} — token set means requeue-after-ack."""
        with self._lock:
            for _, (evaluation, token) in evals.items():
                self._process_enqueue(evaluation, token)

    def _process_enqueue(self, evaluation: Evaluation, token: str) -> None:
        if not self.enabled:
            return
        if evaluation.id in self.evals:
            if token == "":
                return
            # Updating an outstanding eval: requeue once the current
            # delivery acks.
            self.requeue[token] = evaluation
            return

        if evaluation.wait_until_ns and evaluation.wait_until_ns > time.time_ns():
            delay = (evaluation.wait_until_ns - time.time_ns()) / 1e9
            timer = threading.Timer(delay, self._wait_done, args=(evaluation,))
            timer.daemon = True
            self._delayed[evaluation.id] = timer
            self.evals[evaluation.id] = 0
            timer.start()
            return

        if evaluation.wait_ns:
            delay = evaluation.wait_ns / 1e9
            timer = threading.Timer(delay, self._wait_done, args=(evaluation,))
            timer.daemon = True
            self.time_wait[evaluation.id] = timer
            self.evals[evaluation.id] = 0
            timer.start()
            return

        self.evals[evaluation.id] = 0
        self._enqueue_locked(evaluation, evaluation.type)

    def _wait_done(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.time_wait.pop(evaluation.id, None)
            self._delayed.pop(evaluation.id, None)
            if not self.enabled:
                return
            self._enqueue_locked(evaluation, evaluation.type)

    def _enqueue_locked(self, evaluation: Evaluation, queue: str) -> None:
        if not self.enabled:
            return
        namespaced = (evaluation.namespace, evaluation.job_id)
        if evaluation.job_id:
            existing = self.job_evals.get(namespaced)
            if existing is None:
                self.job_evals[namespaced] = evaluation.id
            elif existing != evaluation.id:
                self.blocked.setdefault(namespaced, _PendingHeap()).push(evaluation)
                return
        self.ready.setdefault(queue, _PendingHeap()).push(evaluation)
        if queue != FAILED_QUEUE:
            # trace record opens when the eval becomes READY (nack
            # re-enqueues open a fresh one; the failed queue never
            # delivers, so it gets none)
            _trace.on_enqueue(evaluation)
        # ONE eval became ready: wake a bounded number of waiters, not
        # the whole worker pool — notify_all turns a C1M registration
        # storm into O(workers x evals) spurious wakeups all contending
        # for the broker lock (and the GIL). Waking 2 covers the case
        # where the first woken waiter's scheduler filter skips this
        # queue; any residual miss self-heals within the dequeue loop's
        # 1s re-scan timeout.
        self._cond.notify(2)

    # ------------------------------------------------------------------

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                ev_token = self._scan(schedulers)
                if ev_token is not None:
                    return ev_token
                if deadline is None:
                    self._dequeue_waiters += 1
                    try:
                        self._cond.wait(timeout=1.0)
                    finally:
                        self._dequeue_waiters -= 1
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None, ""
                    self._dequeue_waiters += 1
                    try:
                        self._cond.wait(timeout=remaining)
                    finally:
                        self._dequeue_waiters -= 1
                if not self.enabled:
                    return None, ""

    def _scan(self, schedulers: List[str]) -> Optional[Tuple[Evaluation, str]]:
        if not self.enabled:
            return None
        best_queue = None
        best_priority = -1
        for sched in schedulers:
            heap = self.ready.get(sched)
            if heap and len(heap):
                ev = heap.peek()
                if ev.priority > best_priority:
                    best_priority = ev.priority
                    best_queue = sched
        if best_queue is None:
            return None
        evaluation = self.ready[best_queue].pop()
        token = generate_uuid()
        self.evals[evaluation.id] = self.evals.get(evaluation.id, 0) + 1
        # the delivery counter doubles as the OCC retry count on the trace
        _trace.on_dequeue(evaluation.id, self.evals[evaluation.id])
        timer = threading.Timer(self.nack_timeout, self._nack_expired, args=(evaluation.id, token))
        timer.daemon = True
        self.unack[evaluation.id] = _Unack(evaluation, token, timer)
        timer.start()
        return evaluation, token

    def _nack_expired(self, eval_id: str, token: str) -> None:
        try:
            self.nack(eval_id, token)
        except (NotOutstandingError, TokenMismatchError):
            pass

    # ------------------------------------------------------------------

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            unack = self.unack.get(eval_id)
            return unack.token if unack else None

    def ack(self, eval_id: str, token: str) -> None:
        # chaos hook: a fault here is a LOST ack — the delivery stays
        # unacked and the nack timer redelivers it (every caller survives
        # an ack exception; the applier releases its slot in a finally)
        chaos_fire("broker_ack", eval_id=eval_id)
        with self._lock:
            unack = self.unack.get(eval_id)
            if unack is None:
                raise NotOutstandingError(eval_id)
            if unack.token != token:
                raise TokenMismatchError(eval_id)
            unack.nack_timer.cancel()
            del self.unack[eval_id]
            del self.evals[eval_id]
            # close BEFORE the requeue below may reopen the same id
            _trace.on_ack(eval_id)
            # close the unblock->place storm sample (no-op for evals
            # that never sat in BlockedEvals)
            _capacity.observe_placed(eval_id)

            namespaced = (unack.eval.namespace, unack.eval.job_id)
            if self.job_evals.get(namespaced) == eval_id:
                del self.job_evals[namespaced]
                # unblock the newest eval for this job; the older ones it
                # supersedes become cancelable (Nomad eval_broker.go)
                blocked = self.blocked.pop(namespaced, None)
                if blocked is not None and len(blocked):
                    nxt, *older = blocked.drain_newest_first()
                    for ev in older:
                        self.evals.pop(ev.id, None)
                    self.cancelable.extend(older)
                    self._enqueue_locked(nxt, nxt.type)

            requeued = self.requeue.pop(token, None)
            if requeued is not None:
                self._process_enqueue(requeued, "")

    def nack(self, eval_id: str, token: str) -> None:
        with self._lock:
            self.requeue.pop(token, None)
            unack = self.unack.get(eval_id)
            if unack is None:
                raise NotOutstandingError(eval_id)
            if unack.token != token:
                raise TokenMismatchError(eval_id)
            unack.nack_timer.cancel()
            del self.unack[eval_id]

            prev_dequeues = self.evals.get(eval_id, 0)
            if prev_dequeues >= self.delivery_limit:
                _trace.on_nack(eval_id, failed=True)
                self._enqueue_locked(unack.eval, FAILED_QUEUE)
                return
            _trace.on_nack(eval_id)

            delay = self._nack_reenqueue_delay(prev_dequeues)
            timer = threading.Timer(delay, self._wait_done, args=(unack.eval,))
            timer.daemon = True
            self.time_wait[eval_id] = timer
            timer.start()

    def _nack_reenqueue_delay(self, prev_dequeues: int) -> float:
        if prev_dequeues <= 1:
            return self.initial_nack_delay
        return float(prev_dequeues - 1) * self.subsequent_nack_delay

    # ------------------------------------------------------------------

    def pause_nack_timeout(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self.unack.get(eval_id)
            if unack is None:
                raise NotOutstandingError(eval_id)
            if unack.token != token:
                raise TokenMismatchError(eval_id)
            unack.nack_timer.cancel()

    def resume_nack_timeout(self, eval_id: str, token: str) -> None:
        with self._lock:
            unack = self.unack.get(eval_id)
            if unack is None:
                raise NotOutstandingError(eval_id)
            if unack.token != token:
                raise TokenMismatchError(eval_id)
            timer = threading.Timer(self.nack_timeout, self._nack_expired, args=(eval_id, token))
            timer.daemon = True
            unack.nack_timer = timer
            timer.start()

    # ------------------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            for unack in self.unack.values():
                unack.nack_timer.cancel()
            for timer in self.time_wait.values():
                timer.cancel()
            for timer in self._delayed.values():
                timer.cancel()
            self.evals.clear()
            self.job_evals.clear()
            self.blocked.clear()
            self.cancelable.clear()
            self.ready.clear()
            self.unack.clear()
            self.requeue.clear()
            self.time_wait.clear()
            self._delayed.clear()
            self._cond.notify_all()
        _trace.on_flush()

    def take_cancelable(self, limit: int = 728) -> List[Evaluation]:
        """Up to ``limit`` superseded evals, removed from the list (the
        leader cancels them in batches of Nomad's size, 728)."""
        with self._lock:
            out, self.cancelable = self.cancelable[:limit], self.cancelable[limit:]
            return out

    def stats(self) -> Dict[str, object]:
        with self._lock:
            by_sched = {}
            total_ready = 0
            for sched, heap in self.ready.items():
                by_sched[sched] = len(heap)
                total_ready += len(heap)
            return {
                "total_ready": total_ready,
                "total_unacked": len(self.unack),
                "total_blocked": sum(len(h) for h in self.blocked.values()),
                "total_cancelable": len(self.cancelable),
                "total_waiting": len(self.time_wait) + len(self._delayed),
                "dequeue_waiters": self._dequeue_waiters,
                "by_scheduler": by_sched,
            }
