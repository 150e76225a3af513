"""The server: wires raft/FSM, broker, plan pipeline, workers, heartbeats.

Fills the role of reference ``nomad/server.go`` + ``nomad/leader.go``: on
gaining leadership the broker/blocked-tracker/plan-queue enable and pending
evals restore from state (leader.go:180 establishLeadership); on losing it
everything disables. Endpoint methods (register_*, update_*) are the
in-process equivalents of the RPC endpoint layer; a transport front-end
(msgpack/gRPC) binds to them at the process boundary.

Copied from ``nomad_tpu/server/server.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. Changes:
``ServerConfig.device`` (default ``"cuda"``) is the torch device
the placement engine, the workers' schedulers and the ``DeviceBatcher``
run on, and asking for CUDA where there is none raises at construction
(pass ``"cpu"`` for the plain PyTorch path); ``device_mesh=True`` with
more than one visible CUDA device shards each batch's evals, and where
the grid has ``nodes > 1`` their node tables, over them
(``parallel.sharding``; the reference's ``except Exception`` that ran
unsharded on any error is gone), while a CPU server or a single card
runs unsharded, as a JAX server on one device does;
the leader drains the broker's failed queue every
``FAILED_EVAL_REAP_INTERVAL_S`` (1 s) instead of on the 60 s unblock
cadence, and on the same tick cancels the evals the broker superseded
(Nomad's reapCancelableEvaluations; see ``eval_broker``); a heartbeat
that reaches a follower raises ``NotLeaderError``; a node is marked
down ``heartbeat_grace`` (Nomad's 10 s) after its TTL, not at it; and the stats sweep reads the batcher's table through
``DeviceBatcher.stats_snapshot()``, under its lock.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs.structs import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_CANCELLED,
    EVAL_STATUS_FAILED,
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_JOB_DEREGISTER,
    EVAL_TRIGGER_JOB_REGISTER,
    EVAL_TRIGGER_NODE_UPDATE,
    JOB_TYPE_SERVICE,
    NODE_STATUS_DOWN,
    NODE_STATUS_READY,
    Allocation,
    Evaluation,
    Job,
    Node,
    SchedulerConfiguration,
    generate_uuid,
)
from ..chaos.injector import fire as chaos_fire
from .blocked_evals import BlockedEvals
from .eval_broker import EvalBroker
from .fsm import (
    ALLOC_CLIENT_UPDATE,
    EVAL_UPDATE,
    JOB_DEREGISTER,
    JOB_REGISTER,
    NODE_DEREGISTER,
    NODE_DRAIN_UPDATE,
    NODE_ELIGIBILITY_UPDATE,
    NODE_REGISTER,
    NODE_STATUS_UPDATE,
    SCHEDULER_CONFIG,
    NomadFSM,
)
from .heartbeat import HeartbeatTimers
from .plan_apply import Planner, PlanQueue
from .raft import InProcRaft, NotLeaderError
from .worker import Worker
from ..utils.lock_witness import witness_rlock


def leader_forward(rpc_method: str):
    """Follower-side write forwarding (reference nomad/rpc.go forward():
    every write endpoint relays to the leader before touching raft). A
    wire-raft FOLLOWER re-issues the call as the equivalent RPC — the
    transport routes it to the leader — so the method executes ENTIRELY
    on the leader and its read-after-write never races local replication.
    In-proc / leader / leaderless states run the local method unchanged
    (leaderless writes still fail with NotLeaderError, as the reference's
    forward() fails without a known leader)."""
    import functools
    import inspect

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            get_addr = getattr(self, "get_leader_rpc_addr", None)
            if get_addr is not None and not self.is_leader:
                addr = get_addr()
                if addr:
                    bound = sig.bind(self, *args, **kwargs)
                    bound.apply_defaults()
                    pos = list(bound.arguments.values())[1:]
                    return self.leader_conn.get(addr).call(rpc_method, *pos)
            return fn(self, *args, **kwargs)

        return wrapper

    return deco


# how often the leader drains the broker's failed queue (marks each eval
# that exhausted its deliveries failed and creates its follow-up, which
# itself waits 60 s). Nomad drains it at once (a blocking dequeue,
# leader.go reapFailedEvaluations); the JAX package drains it on the 60 s
# unblock cadence, which left a failed eval in the ready table for up to
# a minute before its follow-up even started waiting
FAILED_EVAL_REAP_INTERVAL_S = 1.0


@dataclass
class ServerConfig:
    num_schedulers: int = 2
    deterministic: bool = False
    # deterministic-mode per-eval candidate-ring seeding (the reference's
    # per-eval shuffle analog, util.go:329): decorrelates concurrent
    # evals so optimistic concurrency doesn't funnel every eval onto one
    # ring prefix. Harness/parity contexts leave it off.
    ring_decorrelate: bool = True
    # evals smaller than this skip the device dispatch and place on the
    # host iterator stack (reference-latency path for small jobs and
    # partial-commit retries); the device engine amortizes above it
    device_min_placements: int = 24
    heartbeat_min_ttl: float = 10.0
    heartbeat_max_ttl: float = 30.0
    # time past a node's TTL before it is marked down (Nomad's
    # heartbeat_grace, 10 s by default; the reference has none: 0 gives
    # its timing)
    heartbeat_grace: float = 10.0
    eval_gc_interval: float = 300.0
    unblock_failed_interval: float = 60.0
    # -- capacity pressure (nomad_tpu/server/blocked_evals + autoscaler) --
    # unblock coalescing: capacity triggers landing within this window
    # merge into one batched, cross-trigger-deduped broker re-enqueue;
    # 0 flushes synchronously per trigger (the pre-storm behavior)
    unblock_coalesce_window_s: float = 0.05
    # per-flush cap on the re-enqueue batch — a 10K-eval unblock storm
    # reaches the broker as bounded batches, the remainder deferring one
    # window at a time
    unblock_max_batch: int = 512
    # leader autoscaler loop: reads blocked_evals.stats() every interval
    # and drives node registration/drain through harness-supplied
    # callbacks (Autoscaler.scale_up_fn / scale_down_fn; without them the
    # loop observes but never acts). interval <= 0 disables the tick.
    autoscaler_interval_s: float = 0.0
    autoscaler_cooldown_s: float = 3.0
    autoscaler_max_step: int = 8
    autoscaler_blocked_threshold: int = 1
    autoscaler_evals_per_node: int = 2
    autoscaler_drain_idle_ticks: int = 3
    # liveness watchdog (nomad-trace): when placement throughput is flat
    # for watchdog_stall_s while evals are in flight, dump broker stats,
    # per-worker current spans and thread stacks to the monitor stream.
    # watchdog_interval <= 0 disables the tick entirely.
    watchdog_interval: float = 10.0
    watchdog_stall_s: float = 30.0
    # flight recorder (nomad-flightrec): leader-owned background sampler
    # snapshotting gauges + direct probes every flight_interval_s into a
    # bounded ring of flight_retain frames, optionally spilling JSONL
    # under flight_spill_dir. <= 0 disables (strict no-op: no thread).
    flight_interval_s: float = 0.25
    flight_retain: int = 1024
    flight_spill_dir: str = ""
    scheduler_algorithm: str = "tpu_binpack"
    # chunked throughput tier (scheduler_algorithm = "tpu_binpack_chunked"):
    # top-K chunk size per scan step, and the fraction of chunk-placed
    # evals re-run through the bit-parity scan as a divergence spot-check
    chunk_k: int = 128
    parity_sample_rate: float = 0.05
    vault: Optional[object] = None  # integrations.vault.VaultConfig
    # Eval-batched device scheduling (SURVEY §2.6 row 1): up to this many
    # concurrently-scheduling evals share ONE device dispatch of the
    # batched placement scan. 0/1 disables batching (per-eval dispatch).
    device_batch: int = 8
    # how long the batcher waits for co-arriving evals before dispatching
    # (the total CAP when idle-gap or demand-aware gathering is on).
    # Sized as a pure BACKSTOP, not the gather pacing: with demand-aware
    # gathering (DeviceBatcher.expect) a wave dispatches the moment its
    # announced cohort has arrived — typically bounded by the concurrent
    # encode time, tens of ms — and this cap only bites when an announced
    # encode stalls. The old 25ms default silently amputated any cohort
    # whose encodes took longer than 25ms to trickle in, which at C1M
    device_batch_window_ms: float = 2000.0
    # adaptive gather: keep the batch growing while requests keep arriving
    # within this gap of each other (a burst's encodes trickle in);
    # 0 disables (fixed window only). ON by default: a lone eval pays at
    # most the idle gap (~3ms, well under one device dispatch), a burst
    # gathers into one dispatch, and window_ms caps the worst case —
    # the trickle-arrival latency bound is asserted by
    # tests/test_device_batcher.py::test_trickle_arrivals_latency.
    device_batch_idle_ms: float = 3.0
    # shard the eval batch over an ("evals", "nodes") device mesh when
    # several CUDA devices are visible (parallel.sharding.make_mesh with
    # eval_parallel = min(device_batch, devices); the rest of the devices
    # split each eval's node tables)
    device_mesh: bool = False
    # torch device of the placement engine, the schedulers and the
    # device batcher: CUDA unless the caller asks for the CPU
    device: str = "cuda"
    # -- asynchronous eval-lifecycle pipeline (nomad_tpu/pipeline) -----
    # master switch: leader-local workers hand device-built dense plans
    # to the async applier (commit + ack off the dispatch thread) so
    # eval waves overlap instead of convoying
    pipeline_async: bool = True
    # async waves in flight before workers fall back to the classic
    # synchronous submit (bounds applier memory and completion-queue
    # depth)
    pipeline_inflight: int = 128
    # device re-entries per wave on partial OCC commit (redispatch from
    # the wave's remembered encode) before nacking back to the broker
    pipeline_redispatch_max: int = 2
    # watchdog bound: an accepted wave unacked this long after its last
    # (re)enqueue is force-nacked — no eval strands in the pipeline
    pipeline_ack_timeout_s: float = 30.0
    # backoff between a wave's partial-commit redispatches (exponential
    # from this base, capped at the max): a flapping apply path degrades
    # to spaced retries instead of hot-looping device dispatches
    pipeline_redispatch_backoff_s: float = 0.05
    pipeline_redispatch_backoff_max_s: float = 1.0
    # bounded wait for a pipeline slot when inflight_max is saturated
    # (an unblock storm's re-enqueue spike): a transient spike defers
    # briefly and stays async, sustained saturation falls back to the
    # classic synchronous path (counted as nomad.pipeline.backpressure)
    pipeline_backpressure_wait_s: float = 0.02
    # -- watch hub / blocking queries (nomad_tpu/watch) ----------------
    # wakeup coalescing window: raft applies landing within it merge
    # into ONE flush, so an apply storm wakes each parked blocking query
    # once per window instead of once per write. 0 = synchronous wakeups
    # (per-apply, the reference's channel-close-per-write behavior)
    watch_coalesce_ms: float = 5.0
    # bound on parked watchers per replica; subscribe past it refuses
    # (WatchLimitError) and the read degrades to plain polling
    watch_max_watchers: int = 100_000
    # federation (reference leader.go:997/:1138): non-authoritative
    # regions' leaders mirror ACL policies and GLOBAL tokens from the
    # authoritative region. Empty authoritative_region (or equal to our
    # own region) disables replication.
    region: str = "global"
    authoritative_region: str = ""
    replication_token: str = ""
    replication_interval: float = 30.0


class Server:
    def __init__(
        self,
        config: Optional[ServerConfig] = None,
        raft: Optional[InProcRaft] = None,
        name: str = "server-1",
    ) -> None:
        self.config = config or ServerConfig()
        # the port's device rule: raises when CUDA is asked for and
        # missing, before any thread starts
        from ..tpu.convert import resolve_device

        resolve_device(self.config.device)
        self.name = name
        self.logger = logging.getLogger(f"nomad_tpu_torch.server.{name}")

        self.fsm = NomadFSM()
        # watch hub on EVERY replica (not leader-gated): followers notify
        # their local hub as entries replicate, which is what lets stale
        # reads park on a follower with min_query_index honored
        from ..watch.hub import WatchHub

        self.watch_hub = WatchHub(
            coalesce_ms=self.config.watch_coalesce_ms,
            max_watchers=self.config.watch_max_watchers,
        )
        self.fsm.watch_hub = self.watch_hub
        self.raft = raft or InProcRaft()
        self.eval_broker = EvalBroker()
        self.blocked_evals = BlockedEvals(
            self.eval_broker,
            coalesce_window_s=self.config.unblock_coalesce_window_s,
            max_batch=self.config.unblock_max_batch,
        )
        # leader autoscaler: armed with leadership below; inert until a
        # harness attaches scale_up_fn / scale_down_fn node providers
        from .autoscaler import Autoscaler

        self.autoscaler = Autoscaler(
            self.blocked_evals.stats,
            blocked_threshold=self.config.autoscaler_blocked_threshold,
            evals_per_node=self.config.autoscaler_evals_per_node,
            max_step=self.config.autoscaler_max_step,
            cooldown_s=self.config.autoscaler_cooldown_s,
            drain_idle_ticks=self.config.autoscaler_drain_idle_ticks,
        )
        self.plan_queue = PlanQueue()
        self.heartbeaters = HeartbeatTimers(
            self, self.config.heartbeat_min_ttl, self.config.heartbeat_max_ttl,
            self.config.heartbeat_grace,
        )
        self.workers: List[Worker] = []
        self.planner: Optional[Planner] = None
        self._leadership = False
        self._leader_generation = 0
        self._leader_timers: List[threading.Timer] = []
        self._lock = witness_rlock("server.Server._lock")

        # follower->leader write forwarding (leader_forward decorator):
        # one cached RPC client that follows the moving leader address.
        # Built lazily (property) so it picks up rpc_tls, which the agent
        # assigns after construction.
        self._leader_conn = None

        from .timetable import TimeTable

        self.timetable = TimeTable()
        # The FSM witnesses every applied index (including plan results and
        # entries replicated to followers), so GC cutoffs survive leader
        # transitions.
        self.fsm.timetable = self.timetable

        from .deploymentwatcher import DeploymentsWatcher
        from .drainer import NodeDrainer
        from .periodic import PeriodicDispatch

        self.deployment_watcher = DeploymentsWatcher(self)
        self.node_drainer = NodeDrainer(self)
        self.periodic_dispatcher = PeriodicDispatch(self)

        # Vault (nomad/vault.go): leader derives/revokes task tokens
        self.vault = None
        if self.config.vault is not None and getattr(self.config.vault, "enabled", False):
            from ..integrations.vault import VaultClient

            self.vault = VaultClient(self.config.vault)

        # Eval-batched device scheduling: workers submit encoded evals here
        # so K concurrent evals ride one device dispatch (the TPU-native
        # analog of the reference's N workers per server, server.go:1307).
        # The batcher's thread starts lazily on first use.
        self.device_batcher = None
        if self.config.device_batch > 1:
            from ..tpu.batcher import DeviceBatcher

            mesh = None
            if self.config.device_mesh:
                import torch

                from ..parallel import sharding

                devices = sharding.visible_devices(torch.device(self.config.device).type)
                n_dev = len(devices)
                if n_dev > 1:
                    mesh = sharding.make_mesh(
                        n_dev,
                        eval_parallel=min(self.config.device_batch, n_dev),
                        devices=devices,
                    )
            self.device_batcher = DeviceBatcher(
                max_batch=self.config.device_batch,
                window_ms=self.config.device_batch_window_ms,
                idle_ms=getattr(self.config, "device_batch_idle_ms", 0.0),
                device=self.config.device,
                mesh=mesh,
            )

        # Asynchronous eval-lifecycle pipeline (nomad_tpu/pipeline):
        # leader-only applier that owns commit + ack of device-built
        # dense plans; enabled/disabled with leadership below.
        self.pipeline = None
        if self.config.pipeline_async:
            from ..pipeline import AsyncApplier

            self.pipeline = AsyncApplier(
                self,
                inflight_max=self.config.pipeline_inflight,
                redispatch_max=self.config.pipeline_redispatch_max,
                ack_timeout_s=self.config.pipeline_ack_timeout_s,
                redispatch_backoff_s=self.config.pipeline_redispatch_backoff_s,
                redispatch_backoff_max_s=self.config.pipeline_redispatch_backoff_max_s,
                backpressure_wait_s=self.config.pipeline_backpressure_wait_s,
            )

        # Cross-region RPC hook (set by the agent): callable
        # (method, region, *args) routed through the gossip region map.
        self.region_rpc = None

        # first-job latency instrumentation (set once each)
        self._first_job_t0: Optional[float] = None
        self._first_job_latency_recorded = False

        # liveness watchdog: ticked from the leader timer loop (below);
        # the instance survives leadership churn, its progress baseline
        # re-seeds on the first tick of each generation
        from ..trace import FlightRecorder, LivenessWatchdog, \
            install_server_probes

        self.watchdog = LivenessWatchdog(
            self, stall_after=self.config.watchdog_stall_s
        )

        # flight recorder: armed with leadership (below), so followers
        # pay nothing; probes are wired once here — they all read through
        # self.* and survive leadership churn
        spill = None
        if self.config.flight_spill_dir:
            import os as _os

            _os.makedirs(self.config.flight_spill_dir, exist_ok=True)
            spill = _os.path.join(
                self.config.flight_spill_dir, f"{name}.flight.jsonl"
            )
        self.flight = FlightRecorder(
            interval_s=self.config.flight_interval_s,
            retain=self.config.flight_retain,
            spill_path=spill,
        )
        install_server_probes(self.flight, self)
        # the recorder tick drives the gauge publish so /v1/metrics stays
        # fresh even when the 10s stats sweep hasn't run yet (bench and
        # chaos harnesses poll gauges without an agent)
        self.flight.add_publisher(self.publish_stats_gauges)

        # Join before observing: the join-time election fires observers, and
        # start() handles the initial-leadership case explicitly.
        self.peer = self.raft.join(self.fsm)
        self.raft.leadership_observers.append(self._on_leadership)
        self.planner = Planner(self.raft, self.peer, self.fsm, self.plan_queue)

    # ------------------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader(self.peer)

    @property
    def leader_conn(self):
        if self._leader_conn is None:
            from ..rpc.transport import LeaderConn

            self._leader_conn = LeaderConn(
                timeout=30.0, tls=getattr(self, "rpc_tls", None)
            )
        return self._leader_conn

    def raft_apply(self, entry_type: str, payload) -> Tuple[int, object]:
        # every log append funnels through here (plan commits take the
        # applier's own tracked region too — the phase union dedups): the
        # worker-thread applies (eval status updates, follow-up evals)
        # otherwise show up as unexplained worker_busy time
        from ..utils import phases

        chaos_fire("raft_apply", entry_type=entry_type)
        from ..trace import lifecycle as _lc

        t0 = _lc.pipeline_now()
        try:
            with phases.track("raft_fsm"):
                return self.raft.apply(self.peer, entry_type, payload)
        finally:
            # same span on the lifecycle (monotonic) clock, keyed by entry
            # type: attribution joins it against the wave windows (phases
            # uses perf_counter and bench-window unions — wrong clock and
            # wrong granularity for per-wave critical paths)
            _lc.pipeline_record("raft_fsm", entry_type, t0, _lc.pipeline_now())

    def start(self) -> None:
        for i in range(self.config.num_schedulers):
            w = Worker(self, i)
            self.workers.append(w)
            w.start()
        self.planner.start()
        if self.is_leader and not self._leadership:
            self._establish_leadership()

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        if self.planner is not None:
            self.planner.stop()
        if self.device_batcher is not None:
            self.device_batcher.stop()
        # wake every parked blocking query and stop the flusher thread
        self.watch_hub.close()
        self._revoke_leadership()

    # -- leadership ------------------------------------------------------

    def _on_leadership(self, peer: int, is_leader: bool) -> None:
        if peer != self.peer:
            return
        if is_leader:
            self._establish_leadership()
        else:
            self._revoke_leadership()

    def _establish_leadership(self) -> None:
        with self._lock:
            if self._leadership:
                return
            self._leadership = True
        self.logger.info("gained leadership")
        self.plan_queue.set_enabled(True)
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.heartbeaters.set_enabled(True)
        self.deployment_watcher.set_enabled(True)
        self.node_drainer.set_enabled(True)
        self.periodic_dispatcher.set_enabled(True)
        if self.pipeline is not None:
            self.pipeline.set_enabled(True)
        self.fsm.on_eval_upserted = self._handle_upserted_eval
        self.fsm.on_capacity_change = self.blocked_evals.unblock
        self._restore_evals()
        self._restore_heartbeats()
        if self.fsm.state.scheduler_config()[1] is None:
            self.raft_apply(
                SCHEDULER_CONFIG,
                SchedulerConfiguration(
                    scheduler_algorithm=self.config.scheduler_algorithm,
                    chunk_k=self.config.chunk_k,
                    parity_sample_rate=self.config.parity_sample_rate,
                ),
            )
        # leadership observers run on threads of their own (wire raft
        # starts one per change): the generation moves under the lock
        with self._lock:
            self._leader_generation += 1
            gen = self._leader_generation
        self._schedule_leader_task(gen, self.config.unblock_failed_interval,
                                   self.blocked_evals.unblock_failed)
        self._schedule_leader_task(gen, FAILED_EVAL_REAP_INTERVAL_S,
                                   self._reap_failed_evals)
        self._schedule_leader_task(gen, self.config.eval_gc_interval, self._create_gc_evals)
        self._schedule_leader_task(gen, 10.0, self.publish_stats_gauges)
        if self.config.watchdog_interval > 0:
            self._schedule_leader_task(
                gen, self.config.watchdog_interval, self.watchdog.tick
            )
        # autoscaler flies with leadership, like the watchdog/flight tasks
        if self.config.autoscaler_interval_s > 0:
            self.autoscaler.set_enabled(True)
            self._schedule_leader_task(
                gen, self.config.autoscaler_interval_s, self.autoscaler.tick
            )
        # flight recorder flies with leadership: followers run no sampler
        self.flight.arm()
        if self.vault is not None:
            self._schedule_leader_task(gen, 60.0, self._sweep_vault_accessors)
        if (self.config.authoritative_region
                and self.config.authoritative_region != self.config.region):
            # non-authoritative leader: mirror ACL state from the
            # authoritative region (leader.go:997 replicateACLPolicies,
            # :1138 replicateACLTokens)
            self._schedule_leader_task(
                gen, self.config.replication_interval, self._replicate_acl
            )

    def publish_stats_gauges(self) -> None:
        """Publish broker/blocked/plan-queue gauges (reference
        eval_broker.go:825 EmitStats, blocked_evals.go EmitStats,
        leader.go:603 job summary metrics). Driven from BOTH the 10s
        leader stats sweep and the flight recorder's tick, so gauges on
        /v1/metrics stay fresh on harnesses with no agent sweep."""
        from ..utils import metric_names, metrics

        bs = self.eval_broker.stats()
        metrics.set_gauge("nomad.broker.total_ready", bs.get("total_ready", 0))
        metrics.set_gauge("nomad.broker.total_unacked", bs.get("total_unacked", 0))
        metrics.set_gauge("nomad.broker.total_blocked", bs.get("total_blocked", 0))
        metrics.set_gauge(
            "nomad.broker.dequeue_waiters", bs.get("dequeue_waiters", 0)
        )
        blocked_stats = self.blocked_evals.stats()
        metric_names.publish_family("nomad.blocked_evals", blocked_stats)
        # storm ledger (unblock_to_place percentiles, batch sizes, peak
        # depth) rides the same sweep
        from ..trace import capacity as _capacity

        _capacity.note_blocked_depth(blocked_stats.get("total_blocked", 0))
        _capacity.publish_gauges()
        metric_names.publish_family("nomad.autoscaler", self.autoscaler.stats())
        if self.device_batcher is not None:
            # a copy taken under the batcher's lock: its dispatcher
            # thread updates the table while this sweep reads it
            metric_names.publish_family(
                "nomad.device_batcher", self.device_batcher.stats_snapshot()
            )
        metrics.set_gauge(
            "nomad.plan.queue_depth", self.plan_queue.stats().get("depth", 0)
        )
        if self.pipeline is not None:
            metric_names.publish_family("nomad.pipeline", self.pipeline.stats())
        metrics.set_gauge(
            "nomad.heartbeat.active", self.heartbeaters.num_active()
        )
        metrics.set_gauge("nomad.state.latest_index", self.fsm.state.latest_index)
        # eval-lifecycle tail latency (nomad.trace.eval_ms.p50/p95/p99,
        # slowest_inflight_ms, inflight) — same sweep, so /v1/metrics
        # carries the trace gauges without a /v1/trace round trip
        from ..trace import lifecycle as _trace_lc

        _trace_lc.publish_gauges()

    def _revoke_leadership(self) -> None:
        with self._lock:
            if not self._leadership:
                return
            self._leadership = False
        self.logger.info("lost leadership")
        self.fsm.on_eval_upserted = None
        self.fsm.on_capacity_change = None
        self.plan_queue.set_enabled(False)
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.heartbeaters.set_enabled(False)
        self.deployment_watcher.set_enabled(False)
        self.node_drainer.set_enabled(False)
        self.periodic_dispatcher.set_enabled(False)
        if self.pipeline is not None:
            self.pipeline.set_enabled(False)
        self.autoscaler.set_enabled(False)
        self.flight.disarm()
        with self._lock:
            self._leader_generation += 1  # invalidates in-flight leader timers
            for t in self._leader_timers:
                t.cancel()
            self._leader_timers.clear()

    def _restore_evals(self) -> None:
        """Re-enqueue non-terminal evals on leadership (leader.go:295)."""
        for ev in self.fsm.state.evals():
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _restore_heartbeats(self) -> None:
        for node in self.fsm.state.nodes():
            if node.status != NODE_STATUS_DOWN:
                self.heartbeaters.reset_heartbeat_timer(node.id)

    def _schedule_leader_task(self, gen: int, interval: float, fn) -> None:
        """Run fn every interval while this leadership generation holds."""

        def tick():
            if self._leader_generation != gen or not self._leadership:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001
                self.logger.exception("leader task %s failed", fn.__name__)
            self._schedule_leader_task(gen, interval, fn)

        t = threading.Timer(interval, tick)
        t.daemon = True
        with self._lock:
            if self._leader_generation != gen:
                return
            self._leader_timers.append(t)
            # prune fired timers
            self._leader_timers = [x for x in self._leader_timers if x.is_alive() or x is t]
        t.start()

    def _reap_failed_evals(self) -> None:
        """Drain the _failed queue: mark failed + create follow-ups
        (reference leader.go:505); then cancel the evals the broker
        superseded (Nomad's reapCancelableEvaluations, leader.go)."""
        self._reap_cancelable_evals()
        from .eval_broker import FAILED_QUEUE

        while True:
            evaluation, token = self.eval_broker.dequeue([FAILED_QUEUE], timeout=0.01)
            if evaluation is None:
                return
            updated = evaluation.copy()
            updated.status = EVAL_STATUS_FAILED
            updated.status_description = (
                f"evaluation reached delivery limit ({self.eval_broker.delivery_limit})"
            )
            follow_up = evaluation.create_failed_follow_up_eval(60 * 10**9)
            updated.next_eval = follow_up.id
            updated.update_modify_time()
            follow_up.update_modify_time()
            self.raft_apply(EVAL_UPDATE, [updated, follow_up])
            try:
                self.eval_broker.ack(evaluation.id, token)
            except Exception:  # noqa: BLE001
                pass

    def _reap_cancelable_evals(self) -> None:
        """Mark canceled, through raft, every blocked eval the broker
        dropped for a newer one of the same job."""
        while True:
            evals = self.eval_broker.take_cancelable()
            if not evals:
                return
            updated = []
            for ev in evals:
                u = ev.copy()
                u.status = EVAL_STATUS_CANCELLED
                u.status_description = "canceled after more recent eval was processed"
                u.update_modify_time()
                updated.append(u)
            self.raft_apply(EVAL_UPDATE, updated)

    def _create_gc_evals(self) -> None:
        """Enqueue internal _core GC evals (reference leader.go:441)."""
        from ..structs.structs import (
            CORE_JOB_DEPLOYMENT_GC,
            CORE_JOB_EVAL_GC,
            CORE_JOB_JOB_GC,
            CORE_JOB_NODE_GC,
            JOB_TYPE_CORE,
        )

        index = self.fsm.state.latest_index
        for core_job in (
            CORE_JOB_EVAL_GC,
            CORE_JOB_JOB_GC,
            CORE_JOB_NODE_GC,
            CORE_JOB_DEPLOYMENT_GC,
        ):
            ev = Evaluation(
                namespace="-",
                priority=200,
                type=JOB_TYPE_CORE,
                triggered_by="scheduled",
                job_id=core_job,
                status=EVAL_STATUS_PENDING,
                snapshot_index=index,
            )
            self.eval_broker.enqueue(ev)

    def _handle_upserted_eval(self, evaluation: Evaluation) -> None:
        """FSM hook: route fresh evals to broker/blocked (fsm.go:641)."""
        if evaluation.should_enqueue():
            self.eval_broker.enqueue(evaluation)
        elif evaluation.should_block():
            self.blocked_evals.block(evaluation)

    # ------------------------------------------------------------------
    # Endpoint surface (in-process RPC equivalents)
    # ------------------------------------------------------------------

    def register_node(self, node: Node) -> float:
        """Node.Register: upsert + heartbeat TTL."""
        self.raft_apply(NODE_REGISTER, node)
        return self.heartbeaters.reset_heartbeat_timer(node.id)

    @leader_forward("Node.Deregister")
    def deregister_node(self, node_id: str) -> None:
        self.heartbeaters.clear_heartbeat_timer(node_id)
        self.raft_apply(NODE_DEREGISTER, node_id)
        self.create_node_evals(node_id)

    def heartbeat(self, node_id: str) -> float:
        """Node.UpdateStatus(ready) via TTL reset. Only the leader keeps
        TTLs: a heartbeat that reaches a follower (one the transport could
        not forward, no leader being known) raises ``NotLeaderError``, as
        Nomad's forward() fails with "No cluster leader", so the client
        tries another server. The reference answered it with a TTL from
        the follower's disabled timers, and the heartbeat was lost."""
        if not self.is_leader:
            raise NotLeaderError(f"{self.name} is not the leader: heartbeat not recorded")
        node = self.fsm.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node {node_id} not registered")
        if node.status == NODE_STATUS_DOWN:
            self.raft_apply(NODE_STATUS_UPDATE, (node_id, NODE_STATUS_READY))
            self.create_node_evals(node_id)
        return self.heartbeaters.reset_heartbeat_timer(node_id)

    def update_node_status(self, node_id: str, status: str) -> None:
        self.raft_apply(NODE_STATUS_UPDATE, (node_id, status))
        self.create_node_evals(node_id)

    @leader_forward("Node.UpdateDrain")
    def update_node_drain(self, node_id: str, drain) -> None:
        """Node.UpdateDrain: ``drain`` is a DrainStrategy, True (default
        strategy), or falsy to cancel. The force deadline is stamped here —
        before the raft apply — so every replica agrees on it."""
        import copy as _copy

        from ..structs.structs import DrainStrategy

        if drain is True:
            drain = DrainStrategy()
        elif drain:
            drain = _copy.copy(drain)  # never mutate the caller's object
        if drain and drain.deadline_ns > 0 and drain.force_deadline_ns == 0:
            drain.force_deadline_ns = time.time_ns() + drain.deadline_ns
        self.raft_apply(NODE_DRAIN_UPDATE, (node_id, drain, not drain))
        if drain:
            self.create_node_evals(node_id)

    @leader_forward("Node.UpdateEligibility")
    def update_node_eligibility(self, node_id: str, eligibility: str) -> None:
        self.raft_apply(NODE_ELIGIBILITY_UPDATE, (node_id, eligibility))

    @leader_forward("Node.Evaluate")
    def create_node_evals(self, node_id: str) -> List[str]:
        """One eval per job with allocs on the node (node_endpoint.go)."""
        allocs = self.fsm.state.allocs_by_node(node_id)
        jobs = {}
        for alloc in allocs:
            jobs[(alloc.namespace, alloc.job_id)] = alloc
        evals = []
        for (namespace, job_id), alloc in jobs.items():
            job = self.fsm.state.job_by_id(namespace, job_id)
            ev = Evaluation(
                namespace=namespace,
                priority=job.priority if job else 50,
                type=job.type if job else JOB_TYPE_SERVICE,
                triggered_by=EVAL_TRIGGER_NODE_UPDATE,
                job_id=job_id,
                node_id=node_id,
                status=EVAL_STATUS_PENDING,
            )
            ev.update_modify_time()
            evals.append(ev)
        if evals:
            self.raft_apply(EVAL_UPDATE, evals)
        return [e.id for e in evals]

    # -- jobs ------------------------------------------------------------

    @leader_forward("Job.Register")
    def register_job(self, job: Job) -> str:
        """Job.Register: upsert + create an eval (job_endpoint.go:73)."""
        # first-job latency gauge: time from the first
        # registration this process serves to its first plan commit
        if self._first_job_t0 is None:
            with self._lock:
                if self._first_job_t0 is None:
                    self._first_job_t0 = time.monotonic()
        # Consul Connect admission mutator: group services with a connect
        # stanza get their sidecar task + proxy port injected BEFORE the
        # job hits raft (job_endpoint_hook_connect.go:99)
        from .job_hooks import job_connect_hook

        job_connect_hook(job)
        # Vault admission check (job_endpoint.go:175 validateJob): a job
        # asking for Vault tokens needs a Vault-enabled server
        if self.vault is None:
            for tg in job.task_groups:
                for task in tg.tasks:
                    if task.vault:
                        raise ValueError(
                            f"task {task.name!r} has a vault stanza but the "
                            "server has no Vault configured"
                        )
        self.raft_apply(JOB_REGISTER, job)
        stored = self.fsm.state.job_by_id(job.namespace, job.id)
        # track/update/untrack with the dispatcher on every registration so
        # disabling a job's periodic stanza stops its launches (periodic.go:Add)
        self.periodic_dispatcher.add(stored)
        if stored.is_periodic() or stored.is_parameterized():
            # periodic children spawn at launch times; parameterized templates
            # only run when dispatched (job_endpoint.go Register)
            return ""
        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=stored.job_modify_index,
            status=EVAL_STATUS_PENDING,
        )
        ev.update_modify_time()
        self.raft_apply(EVAL_UPDATE, [ev])
        return ev.id

    @leader_forward("Job.Deregister")
    def deregister_job(self, namespace: str, job_id: str, purge: bool = False) -> str:
        job = self.fsm.state.job_by_id(namespace, job_id)
        self.raft_apply(JOB_DEREGISTER, (namespace, job_id, purge))
        self.blocked_evals.untrack(namespace, job_id)
        self.periodic_dispatcher.remove(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by=EVAL_TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
        )
        ev.update_modify_time()
        self.raft_apply(EVAL_UPDATE, [ev])
        return ev.id

    @leader_forward("Job.Evaluate")
    def evaluate_job(self, namespace: str, job_id: str) -> str:
        """Job.Evaluate: force a new evaluation (job_endpoint.go Evaluate)."""
        job = self.fsm.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id!r} not found")
        if job.is_periodic():
            raise ValueError("can't evaluate periodic job")
        if job.is_parameterized():
            raise ValueError("can't evaluate parameterized job")
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=job.job_modify_index,
            status=EVAL_STATUS_PENDING,
        )
        ev.update_modify_time()
        self.raft_apply(EVAL_UPDATE, [ev])
        return ev.id

    @leader_forward("Job.Dispatch")
    def dispatch_job(
        self, namespace: str, job_id: str, payload: bytes = b"", meta=None
    ):
        """Job.Dispatch: instantiate a parameterized job (job_endpoint.go
        Dispatch). Returns (child_job_id, eval_id)."""
        parent = self.fsm.state.job_by_id(namespace, job_id)
        if parent is None:
            raise KeyError(f"job {job_id!r} not found")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id!r} is not parameterized")
        if parent.stopped():
            raise ValueError(f"job {job_id!r} is stopped")
        cfg = parent.parameterized
        meta = dict(meta or {})
        if cfg.payload == "required" and not payload:
            raise ValueError("payload is required")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload is forbidden")
        for key in cfg.meta_required:
            if key not in meta:
                raise ValueError(f"missing required dispatch meta {key!r}")
        allowed = set(cfg.meta_required) | set(cfg.meta_optional)
        for key in meta:
            if key not in allowed:
                raise ValueError(f"dispatch meta {key!r} not allowed")

        child = parent.derive_child(
            "{}/dispatch-{}-{}".format(parent.id, int(time.time()), generate_uuid()[:8])
        )
        child.parameterized = None
        child.payload = bytes(payload)
        child.meta = {**parent.meta, **meta}
        eval_id = self.register_job(child)
        return child.id, eval_id

    @leader_forward("Job.Stability")
    def set_job_stability(
        self, namespace: str, job_id: str, version: int, stable: bool
    ) -> None:
        """Job.Stable (job_endpoint.go Stable)."""
        job = self.fsm.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id!r} not found")
        versions = self.fsm.state.job_versions.get((namespace, job_id), [])
        if not any(j.version == version for j in versions):
            raise ValueError(f"job {job_id!r} has no version {version}")
        self.raft_apply("job-stability", (namespace, job_id, version, stable))

    @leader_forward("Job.Revert")
    def revert_job(
        self,
        namespace: str,
        job_id: str,
        version: int,
        enforce_prior_version: Optional[int] = None,
    ) -> str:
        """Job.Revert: re-register a prior version (job_endpoint.go Revert)."""
        cur = self.fsm.state.job_by_id(namespace, job_id)
        if cur is None:
            raise KeyError(f"job {job_id!r} not found")
        if enforce_prior_version is not None and cur.version != enforce_prior_version:
            raise ValueError(
                f"current version is {cur.version}, not {enforce_prior_version}"
            )
        if version == cur.version:
            raise ValueError(f"can't revert to current version {version}")
        prior = self.fsm.state.job_by_id_and_version(namespace, job_id, version)
        if prior is None:
            raise KeyError(f"job {job_id!r} has no version {version}")
        revert = prior.copy()
        revert.stable = False
        revert.version = 0  # upsert assigns the next version
        return self.register_job(revert)

    def plan_job(self, job: Job, diff: bool = False):
        """Job.Plan: dry-run the scheduler against a snapshot with the
        submitted job inserted (job_endpoint.go Plan → scheduler harness);
        nothing raft-applies. Returns (annotations, failed_tg_allocs,
        job_modify_index, job_diff). The dry run places on the server's
        device (``ServerConfig.device``), as its workers do."""
        from ..scheduler.scheduler import new_scheduler
        from ..scheduler.testing import Harness
        from ..structs.diff import job_diff

        snap = self.fsm.state.snapshot()
        index = snap.latest_index + 1
        old_job = snap.job_by_id(job.namespace, job.id)
        jdiff = job_diff(old_job, None if job.stop else job) if diff else None
        if job.stop:
            snap.delete_job(index, job.namespace, job.id)
        else:
            snap.upsert_job(index, job)
        harness = Harness(snap, device=self.config.device)
        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=index,
            status=EVAL_STATUS_PENDING,
            annotate_plan=True,
        )
        sched = new_scheduler(job.type, self.logger, snap, harness)
        if hasattr(sched, "device"):
            sched.device = self.config.device
        sched.process(ev)
        annotations = harness.plans[-1].annotations if harness.plans else None
        failed = {}
        for e in harness.evals + [ev]:
            if e.failed_tg_allocs:
                failed.update(e.failed_tg_allocs)
        return annotations, failed or None, index, jdiff

    @leader_forward("System.GC")
    def force_gc(self) -> None:
        """System.GarbageCollect: a forced core GC eval (system_endpoint.go)."""
        from .core_sched import CoreScheduler

        ev = Evaluation(
            namespace="-",
            priority=100,
            type="_core",
            triggered_by="force-gc",
            job_id="force-gc",
            status=EVAL_STATUS_PENDING,
        )
        CoreScheduler(self, self.fsm.state.snapshot()).process(ev)

    @leader_forward("Alloc.Stop")
    def stop_alloc(self, alloc_id: str) -> str:
        """Alloc.Stop: mark the alloc for migration and kick an eval
        (alloc_endpoint.go Stop)."""
        alloc = self.fsm.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id!r} not found")
        job = alloc.job or self.fsm.state.job_by_id(alloc.namespace, alloc.job_id)
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by="alloc-stop",
            job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING,
        )
        ev.update_modify_time()
        from ..structs.structs import DesiredTransition

        self.raft_apply(
            "alloc-update-desired-transition",
            ({alloc_id: DesiredTransition(migrate=True)}, [ev]),
        )
        return ev.id

    # -- ACL (reference nomad/acl_endpoint.go) ---------------------------

    def bootstrap_acl(self):
        """One-shot creation of the initial management token
        (acl_endpoint.go Bootstrap)."""
        from ..structs.acl import bootstrap_token

        if self.fsm.state.acl_bootstrap_index != 0:
            raise ValueError("ACL bootstrap already done")
        token = bootstrap_token()
        self.raft_apply("acl-token-bootstrap", token)
        return self.fsm.state.acl_token_by_accessor(token.accessor_id)

    def upsert_acl_policies(self, policies) -> None:
        from ..acl import parse_policy

        for pol in policies:
            errors = pol.validate()
            if errors:
                raise ValueError("; ".join(errors))
            parse_policy(pol.rules)  # reject unparsable rules up front
        self.raft_apply("acl-policy-upsert", policies)

    def delete_acl_policies(self, names) -> None:
        self.raft_apply("acl-policy-delete", list(names))

    def upsert_acl_tokens(self, tokens):
        for tok in tokens:
            errors = tok.validate()
            if errors:
                raise ValueError("; ".join(errors))
        self.raft_apply("acl-token-upsert", tokens)
        return [self.fsm.state.acl_token_by_accessor(t.accessor_id) for t in tokens]

    def delete_acl_tokens(self, accessors) -> None:
        self.raft_apply("acl-token-delete", list(accessors))

    # -- cross-region ACL replication (leader.go:997/:1138) ---------------

    def list_acl_for_replication(self, secret: str = ""):
        """RPC: the authoritative region's full policy set + GLOBAL tokens
        for a replica region's mirror sweep. Token secrets cross the wire
        here, so the caller must present the replication token or a
        management token once ACLs are bootstrapped."""
        self._check_replication_auth(secret)
        state = self.fsm.state
        policies = list(state.acl_policies_table.values())
        tokens = [t for t in state.acl_tokens_table.values() if t.global_]
        return [policies, tokens]

    def _check_replication_auth(self, secret: str) -> None:
        state = self.fsm.state
        if not state.acl_tokens_table:
            return  # ACLs not bootstrapped: nothing secret to protect
        if self.config.replication_token and secret == self.config.replication_token:
            return
        tok = state.acl_token_by_secret(secret) if secret else None
        if tok is not None and tok.is_management():
            return
        raise PermissionError(
            "ACL replication requires the replication token or a management token"
        )

    def _replicate_acl(self) -> None:
        if self.region_rpc is None:
            return
        try:
            policies, tokens = self.region_rpc(
                "ACL.ListReplication",
                self.config.authoritative_region,
                self.config.replication_token,
            )
        except Exception as e:  # noqa: BLE001 — authoritative region away
            # misconfigured credentials never self-heal: surface them;
            # transient unreachability stays at debug
            if "PermissionError" in str(e):
                self.logger.warning(
                    "ACL replication rejected by %s: %s (check "
                    "replication_token)", self.config.authoritative_region, e,
                )
            else:
                self.logger.debug("ACL replication fetch failed: %s", e)
            return
        from .fsm import (
            ACL_POLICY_DELETE,
            ACL_POLICY_UPSERT,
            ACL_TOKEN_DELETE,
            ACL_TOKEN_UPSERT,
        )

        state = self.fsm.state
        # policies: content-compare (raft restamps indexes locally, so
        # index equality would re-upsert forever)
        remote_p = {p.name: p for p in policies}
        local_p = dict(state.acl_policies_table)
        deletes = [n for n in local_p if n not in remote_p]
        upserts = [
            p for n, p in remote_p.items()
            if n not in local_p
            or (local_p[n].rules, local_p[n].description)
            != (p.rules, p.description)
        ]
        if deletes:
            self.raft_apply(ACL_POLICY_DELETE, deletes)
        if upserts:
            self.raft_apply(ACL_POLICY_UPSERT, upserts)
        # tokens: only GLOBAL tokens mirror; local tokens stay local
        remote_t = {t.accessor_id: t for t in tokens}
        local_t = {
            a: t for a, t in state.acl_tokens_table.items() if t.global_
        }
        t_deletes = [a for a in local_t if a not in remote_t]

        def token_key(t):
            return (t.name, t.type, tuple(t.policies), t.secret_id)

        t_upserts = [
            t for a, t in remote_t.items()
            if a not in local_t or token_key(local_t[a]) != token_key(t)
        ]
        if t_deletes:
            self.raft_apply(ACL_TOKEN_DELETE, t_deletes)
        if t_upserts:
            self.raft_apply(ACL_TOKEN_UPSERT, t_upserts)

    # -- vault (nomad/vault.go + node_endpoint.go DeriveVaultToken) ------

    def derive_vault_token(
        self,
        alloc_id: str,
        task_names: List[str],
        node_id: str = "",
        node_secret: str = "",
    ) -> Dict[str, str]:
        """Create per-task Vault tokens for an alloc's tasks; accessors
        are raft-tracked so the tokens are revoked when the alloc dies.

        The caller must prove it is the node the alloc is placed on:
        (node_id, node_secret) must match the registered node's secret and
        the alloc must actually live there (node_endpoint.go:1370) —
        otherwise any RPC caller could mint tokens for any policy set."""
        if self.vault is None:
            raise ValueError("Vault is not configured on this server")
        node = self.fsm.state.node_by_id(node_id) if node_id else None
        if node is None or not node_secret or node.secret_id != node_secret:
            raise PermissionError("node secret mismatch")
        alloc = self.fsm.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id!r} not found")
        if alloc.node_id != node_id:
            raise PermissionError(
                f"alloc {alloc_id!r} is not placed on node {node_id!r}"
            )
        if alloc.terminal_status():
            raise ValueError(f"alloc {alloc_id!r} is terminal")
        job = alloc.job or self.fsm.state.job_by_id(alloc.namespace, alloc.job_id)
        tg = job.lookup_task_group(alloc.task_group) if job else None
        tasks = {t.name: t for t in (tg.tasks if tg else [])}
        tokens: Dict[str, str] = {}
        records = []
        for name in task_names:
            task = tasks.get(name)
            if task is None or not task.vault:
                raise ValueError(f"task {name!r} has no vault stanza")
            derived = self.vault.derive_token(list(task.vault.get("policies", [])))
            tokens[name] = derived["token"]
            records.append({
                "alloc_id": alloc_id, "task": name,
                "accessor": derived["accessor"],
            })
        from .fsm import VAULT_ACCESSOR_UPSERT

        self.raft_apply(VAULT_ACCESSOR_UPSERT, records)
        return tokens

    def _sweep_vault_accessors(self) -> None:
        """Leader retry sweep: revoke accessors whose allocs are terminal
        or gone but whose revocation previously failed (vault.go
        revokeDaemon semantics)."""
        if self.vault is None:
            return
        stale = []
        for alloc_id in list(self.fsm.state.vault_accessors_table):
            alloc = self.fsm.state.alloc_by_id(alloc_id)
            if alloc is None or alloc.terminal_status():
                stale.append(alloc_id)
        if stale:
            self._revoke_vault_accessors(stale)

    def _revoke_vault_accessors(self, alloc_ids: List[str]) -> None:
        """Revoke + untrack token accessors of dead allocs (vault.go
        RevokeTokens); failures stay tracked for the leader sweep."""
        if self.vault is None:
            return
        to_delete = []
        for alloc_id in alloc_ids:
            accessors = self.fsm.state.vault_accessors_by_alloc(alloc_id)
            if not accessors:
                continue
            failed = self.vault.revoke_accessors([a["accessor"] for a in accessors])
            if not failed:
                to_delete.append(alloc_id)
        if to_delete:
            from .fsm import VAULT_ACCESSOR_DELETE

            self.raft_apply(VAULT_ACCESSOR_DELETE, to_delete)

    # -- client sync -----------------------------------------------------

    def update_allocs_from_client(self, allocs: List[Allocation]) -> None:
        """Node.UpdateAlloc: client status sync; failed allocs trigger
        reschedule evals via their job (node_endpoint.go)."""
        self.raft_apply(ALLOC_CLIENT_UPDATE, allocs)
        dead = [a.id for a in allocs if a.terminal_status()]
        if dead and self.vault is not None:
            # off the RPC hot path: an unreachable Vault must not delay
            # reschedule evals; the leader sweep retries failures
            threading.Thread(
                target=self._revoke_vault_accessors, args=(dead,), daemon=True
            ).start()
        evals = []
        seen = set()
        for alloc in allocs:
            if alloc.client_status != "failed":
                continue
            stored = self.fsm.state.alloc_by_id(alloc.id)
            if stored is None or (stored.namespace, stored.job_id) in seen:
                continue
            seen.add((stored.namespace, stored.job_id))
            job = self.fsm.state.job_by_id(stored.namespace, stored.job_id)
            if job is None:
                continue
            ev = Evaluation(
                namespace=stored.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by="alloc-failure",
                job_id=job.id,
                status=EVAL_STATUS_PENDING,
            )
            ev.update_modify_time()
            evals.append(ev)
        if evals:
            self.raft_apply(EVAL_UPDATE, evals)

    # -- introspection ---------------------------------------------------

    def drain_evals(self, timeout: float = 10.0) -> bool:
        """Wait until the broker has no ready/unacked work (test helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            s = self.eval_broker.stats()
            if s["total_ready"] == 0 and s["total_unacked"] == 0 and s["total_waiting"] == 0:
                return True
            time.sleep(0.01)
        return False
