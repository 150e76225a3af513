"""Scheduling worker: dequeues evals, invokes a scheduler, submits plans.

Semantics follow reference ``nomad/worker.go`` — N workers per server
(leader and followers), each scheduling optimistically against a state
snapshot at least as fresh as the eval (SnapshotMinIndex, worker.go:228),
acting as the scheduler's Planner and Ack/Nacking the broker.

Copied from ``nomad_tpu/server/worker.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. The
follower-mode RPC client (``rpc.transport.LeaderConn``) is built only
when a leader address is known (``server.get_leader_rpc_addr``, which the
agent sets); an in-process server never reaches it. Each scheduler gets
the server's ``device`` as it gets ``deterministic``.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..scheduler.scheduler import new_scheduler
from ..trace import context as _xcontext
from ..trace import lifecycle as _lifecycle
from ..utils import metrics, phases
from ..structs.structs import Evaluation, Plan, PlanResult
from .eval_broker import NotOutstandingError, TokenMismatchError
from .fsm import EVAL_UPDATE

BUILTIN_SCHEDULERS = ["service", "batch", "system"]
CORE_SCHEDULER = "_core"


class Worker:
    def __init__(self, server, worker_id: int) -> None:
        self.server = server
        self.id = worker_id
        self.logger = logging.getLogger(f"nomad_tpu_torch.worker.{worker_id}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set per-eval while scheduling
        self._eval_token = ""
        self._snapshot_index = 0
        # True when submit_plan handed commit + ack to the async
        # applier (nomad_tpu/pipeline): the run loop must NOT ack —
        # the applier acks after the raft commit lands
        self._handed_off = False
        # follower mode: RPC connection to the leader's broker/plan queue,
        # built on the first known leader address (_leader_rpc)
        self._remote = None
        self._active_remote = None
        self.stats = {"evals_processed": 0, "plans_submitted": 0, "nacks": 0}
        # what this worker is doing RIGHT NOW — {eval_id, phase, since} or
        # None when idle; single-writer (the worker thread), read racily
        # by the liveness watchdog's dump
        self.current: Optional[Dict[str, object]] = None

    @contextmanager
    def _span(self, phase: str, eval_id: str):
        """Mark the worker's current span for the watchdog; restores the
        enclosing span on exit so nesting (submit inside invoke) works."""
        prev = self.current
        self.current = {
            "eval_id": eval_id, "phase": phase, "since": time.monotonic()
        }
        try:
            yield
        finally:
            self.current = prev

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"worker-{self.id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._close_remote()

    # ------------------------------------------------------------------

    # -- remote (follower) mode ------------------------------------------
    # Followers run schedulers too (worker.go runs on every server): they
    # dequeue from the LEADER's broker and submit plans to its queue over
    # RPC, scheduling against their own replicated state snapshot.

    def _leader_rpc(self):
        """RPC client to the current leader, or None when we are the
        leader / no leader is known. Reconnects on leader change."""
        if self.server.is_leader:
            self._close_remote()
            return None
        get_addr = getattr(self.server, "get_leader_rpc_addr", None)
        addr = get_addr() if get_addr is not None else None
        if not addr:
            self._close_remote()
            return None
        if self._remote is None:
            from ..rpc.transport import LeaderConn

            self._remote = LeaderConn(
                timeout=30.0, tls=getattr(self.server, "rpc_tls", None)
            )
        return self._remote.get(addr)

    def _close_remote(self) -> None:
        if self._remote is not None:
            self._remote.close()

    @staticmethod
    def _map_remote_error(e) -> None:
        """Benign broker token races cross the wire as error strings;
        re-raise them as their local exception types so the run loop's
        handling stays identical in both modes."""
        msg = str(e)
        if "NotOutstandingError" in msg:
            raise NotOutstandingError(msg) from e
        if "TokenMismatchError" in msg or "token mismatch" in msg:
            raise TokenMismatchError(msg) from e
        raise e

    def _run(self) -> None:
        schedulers = BUILTIN_SCHEDULERS + [CORE_SCHEDULER]
        # Coalesced idle accounting: consecutive empty dequeues accumulate
        # into ONE pending period, flushed as a single lifecycle IDLE_STAGE
        # span when work finally arrives. One span per busy->idle->busy
        # transition keeps the span ring at O(transitions) regardless of
        # poll cadence, and gives attribution direct evidence for the
        # "workers alive but starved" residual instead of an unattributed
        # hole.
        idle_t0: Optional[float] = None
        while not self._stop.is_set():
            try:
                remote = self._leader_rpc()
            except Exception:  # noqa: BLE001
                remote = None
            self._active_remote = remote
            poll_t0 = _lifecycle.pipeline_now()
            try:
                if remote is not None:
                    # core (GC) evals mutate raft directly and only run on
                    # the leader; followers dequeue the builtin types only
                    evaluation, token = remote.call(
                        "Eval.Dequeue", BUILTIN_SCHEDULERS, 1.0, no_forward=True
                    )
                    token = token or ""
                else:
                    evaluation, token = self.server.eval_broker.dequeue(
                        schedulers, timeout=0.25
                    )
            except Exception:  # noqa: BLE001 — leader gone mid-poll
                self._close_remote()
                self._stop.wait(0.5)
                continue
            if evaluation is None:
                if idle_t0 is None:
                    idle_t0 = poll_t0
                if remote is not None:
                    self._stop.wait(0.1)
                continue
            if idle_t0 is not None:
                _lifecycle.pipeline_record(
                    _lifecycle.IDLE_STAGE, f"worker-{self.id}",
                    idle_t0, _lifecycle.pipeline_now(),
                )
                idle_t0 = None
            metrics.incr_counter("nomad.worker.dequeue_eval")
            _lifecycle.on_worker(evaluation.id, self.id)
            self._eval_token = token
            self._handed_off = False
            # re-enter the eval's distributed trace (carried in
            # Evaluation.trace_ctx across raft AND the Eval.Dequeue wire
            # hop): outbound RPCs below — Plan.Submit, Eval.Ack — become
            # children of the span that created the eval
            trace_token = _xcontext.activate(
                getattr(evaluation, "trace_ctx", None)
            )
            try:
                # worker_busy is the coverage denominator: everything the
                # worker does between dequeue and ack should be explained
                # by some fine phase (phases.coverage)
                with phases.track("worker_busy"):
                    self._process(evaluation, token)
                if not self._handed_off:
                    self._ack(evaluation.id, token)
                self.stats["evals_processed"] += 1
            except (NotOutstandingError, TokenMismatchError):
                pass
            except Exception:  # noqa: BLE001
                self.logger.exception("eval %s failed", evaluation.id)
                self.stats["nacks"] += 1
                try:
                    self._nack(evaluation.id, token)
                except Exception:  # noqa: BLE001
                    pass
            finally:
                _xcontext.deactivate(trace_token)

    def _ack(self, eval_id: str, token: str) -> None:
        if self._active_remote is not None:
            from ..rpc.transport import RPCError

            try:
                self._active_remote.call("Eval.Ack", eval_id, token, no_forward=True)
            except RPCError as e:
                self._map_remote_error(e)
        else:
            self.server.eval_broker.ack(eval_id, token)

    def _nack(self, eval_id: str, token: str) -> None:
        if self._active_remote is not None:
            from ..rpc.transport import RPCError

            try:
                self._active_remote.call("Eval.Nack", eval_id, token, no_forward=True)
            except RPCError as e:
                self._map_remote_error(e)
        else:
            self.server.eval_broker.nack(eval_id, token)

    def _process(self, evaluation: Evaluation, token: str) -> None:
        if evaluation.type == CORE_SCHEDULER:
            from .core_sched import CoreScheduler

            snapshot = self.server.fsm.state.snapshot_min_index(
                max(evaluation.modify_index, evaluation.snapshot_index)
            )
            CoreScheduler(self.server, snapshot).process(evaluation)
            return

        from ..utils.hostwork import HOST_WORK_SEM

        # worker-side spans are emitted HERE, in the worker's process:
        # in follower mode the leader's lifecycle record never sees these
        # stamps, and the stitched trace is the only place the invoke
        # appears at all. role tags feed the follower_lag component.
        trace_id, trace_parent = _lifecycle.eval_trace_ids(
            evaluation.id, getattr(evaluation, "trace_ctx", None)
        )
        span_attrs = {
            "eval_id": evaluation.id, "worker": self.id,
            "role": "follower" if self._active_remote is not None
            else "leader",
        }

        wait_index = max(evaluation.modify_index, evaluation.snapshot_index)
        start = metrics.now()
        with self._span("wait_for_index", evaluation.id):
            # wait for the raft index WITHOUT the host-work permit (it can
            # block seconds); the snapshot COPY is a pure-GIL table clone —
            # park excess threads for that part only
            wait_t0 = _lifecycle.pipeline_now()
            with phases.track("wait_index"):
                self.server.fsm.state.wait_min_index(wait_index)
            # per-eval SnapshotMinIndex wait span on the lifecycle clock:
            # the attribution engine joins these against the wave windows
            # ("wait_min_index: 41% of makespan" names this exact block)
            wait_t1 = _lifecycle.pipeline_now()
            _lifecycle.pipeline_record(
                "wait_min_index", evaluation.id, wait_t0, wait_t1,
            )
            _xcontext.record_span(
                "eval.wait_min_index",
                _xcontext.wall_from_monotonic(wait_t0),
                _xcontext.wall_from_monotonic(wait_t1),
                trace_id=trace_id, parent_id=trace_parent,
                attrs=span_attrs,
            )
            with HOST_WORK_SEM:
                with phases.track("snapshot"):
                    # read-only shared view: a burst of evals at one state
                    # version shares one table clone (schedulers never
                    # mutate their snapshot; the plan applier, which does,
                    # takes private ones)
                    snapshot = self.server.fsm.state.shared_snapshot_min_index(
                        wait_index
                    )
        metrics.measure_since("nomad.worker.wait_for_index", start)
        self._snapshot_index = snapshot.latest_index
        sched = new_scheduler(evaluation.type, self.logger, snapshot, self)
        if hasattr(sched, "deterministic"):
            sched.deterministic = self.server.config.deterministic
        if hasattr(sched, "ring_decorrelate"):
            sched.ring_decorrelate = getattr(
                self.server.config, "ring_decorrelate", True
            )
        if hasattr(sched, "device_min_placements"):
            sched.device_min_placements = getattr(
                self.server.config, "device_min_placements", 0
            )
        if hasattr(sched, "device"):
            sched.device = self.server.config.device
        start = metrics.now()
        _lifecycle.on_invoke_start(evaluation.id)
        invoke_t0 = _lifecycle.pipeline_now()
        try:
            with self._span("invoke_scheduler", evaluation.id):
                sched.process(evaluation)
        finally:
            _lifecycle.on_invoke_end(evaluation.id)
            _xcontext.record_span(
                "eval.invoke",
                _xcontext.wall_from_monotonic(invoke_t0),
                _xcontext.wall_from_monotonic(_lifecycle.pipeline_now()),
                trace_id=trace_id, parent_id=trace_parent,
                attrs=span_attrs,
            )
        metrics.measure_since(
            f"nomad.worker.invoke_scheduler.{evaluation.type}", start
        )

    # -- Planner protocol ------------------------------------------------

    @property
    def device_batcher(self):
        """The server's eval-batcher: schedulers route their placement
        scans through it so concurrent evals share one device dispatch
        (works identically in leader and follower mode — scheduling is
        local; only plan submission crosses the wire)."""
        return getattr(self.server, "device_batcher", None)

    @property
    def pipeline(self):
        """The leader-local async applier (nomad_tpu/pipeline), or None
        in follower mode — a follower's plan submission crosses the wire
        and must stay synchronous (the leader-side handler owns the
        response)."""
        if self._active_remote is not None:
            return None
        return getattr(self.server, "pipeline", None)

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[object]]:
        plan.eval_token = self._eval_token
        # stamp the snapshot the scheduler actually saw (worker.go:277), not
        # the newest index — the plan applier uses this to decide how much
        # optimistic re-validation the plan needs
        plan.snapshot_index = self._snapshot_index
        _lifecycle.on_plan_submit(plan.eval_id)
        if self._active_remote is not None:
            # the leader-side handler waits up to 60s on the plan queue;
            # the socket must outlast it, and a resend would enqueue the
            # plan twice — fail instead
            result: PlanResult = self._active_remote.call(
                "Plan.Submit", plan, no_forward=True, timeout=90.0, no_retry=True
            )
        else:
            pipe = self.pipeline
            if pipe is not None and pipe.try_submit(plan, self._eval_token):
                # Async handoff (nomad_tpu/pipeline): the applier owns
                # commit + ack from here; this worker thread goes straight
                # back to the broker so wave N+1's encode overlaps wave
                # N's evaluate/commit tail. The scheduler sees the plan's
                # own placements as a full-commit result — the optimistic
                # contract; a partial commit comes back later as a
                # re-dispatch or broker redelivery, both of which
                # reconcile against fresh state.
                self._handed_off = True
                metrics.incr_counter("nomad.worker.async_handoff")
                result = PlanResult(dense_placements=plan.dense_placements)
            else:
                self.server.eval_broker.pause_nack_timeout(
                    plan.eval_id, self._eval_token
                )
                try:
                    with self._span("submit_plan", plan.eval_id):
                        with phases.track("plan_submit"):
                            pending = self.server.plan_queue.enqueue(plan)
                            result = pending.future.result(timeout=60)
                finally:
                    try:
                        self.server.eval_broker.resume_nack_timeout(
                            plan.eval_id, self._eval_token
                        )
                    except (NotOutstandingError, TokenMismatchError):
                        pass
        self.stats["plans_submitted"] += 1

        srv = self.server
        if (
            not getattr(srv, "_first_job_latency_recorded", True)
            and srv._first_job_t0 is not None
            and not result.is_noop()
        ):
            # first plan commit after the first registration: the boot-
            # warmup latency the operator actually feels
            import time as _time

            srv._first_job_latency_recorded = True
            metrics.set_gauge(
                "nomad.server.first_job_latency_ms",
                (_time.monotonic() - srv._first_job_t0) * 1000.0,
            )

        if result.refresh_index:
            # the follower's replicated state catches up to the leader's
            # commit; schedulers always refresh from LOCAL state
            # (read-only shared view — see _process)
            new_state = self.server.fsm.state.shared_snapshot_min_index(
                result.refresh_index
            )
            self._snapshot_index = new_state.latest_index
            return result, new_state
        return result, None

    def update_eval(self, evaluation: Evaluation) -> None:
        evaluation.update_modify_time()
        if self._active_remote is not None:
            self._active_remote.call("Eval.Update", [evaluation], no_forward=True)
            return
        self.server.raft_apply(EVAL_UPDATE, [evaluation])

    def create_eval(self, evaluation: Evaluation) -> None:
        # Stamp the worker's snapshot index (worker.go:385): the blocked-
        # evals tracker compares it against per-class unblock indexes, and
        # without it every new blocked eval looks like it "missed" an old
        # unblock and is re-enqueued forever.
        if not evaluation.snapshot_index:
            evaluation.snapshot_index = self._snapshot_index
        evaluation.update_modify_time()
        if self._active_remote is not None:
            self._active_remote.call("Eval.Update", [evaluation], no_forward=True)
            return
        self.server.raft_apply(EVAL_UPDATE, [evaluation])

    def reblock_eval(self, evaluation: Evaluation) -> None:
        # Update in raft so a leader change re-blocks it, then re-insert
        # into the in-memory tracker (reference worker.go:426).
        if self._active_remote is not None:
            from ..rpc.transport import RPCError

            evaluation.update_modify_time()
            try:
                self._active_remote.call(
                    "Eval.Reblock", evaluation, self._eval_token, no_forward=True
                )
            except RPCError as e:
                self._map_remote_error(e)
            return
        token = self.server.eval_broker.outstanding(evaluation.id)
        if token != self._eval_token:
            raise TokenMismatchError(evaluation.id)
        evaluation.update_modify_time()
        self.server.raft_apply(EVAL_UPDATE, [evaluation])
        # Pass the delivery token: the eval is still outstanding in the
        # broker, so an unblock racing this worker's ack must requeue
        # through the ack path rather than be dropped as a duplicate. The
        # raft apply above already captured the eval via the FSM hook
        # (empty token); reblock records the token on that entry.
        self.server.blocked_evals.reblock(evaluation, token)
