"""Churn trace-replay driver: run a live cluster through a chaos trace.

``ChurnReplay`` boots an in-proc cluster (shared ``InProcRaft``, N
servers, mock nodes with real heartbeat TTL timers and a background
heartbeat pump), then plays a :mod:`nomad_tpu_torch.chaos.trace` schedule
against the current leader in real time: registrations, stops,
rollouts (destructive or canaried), high-priority arrivals,
preemption-pressure waves, drains, heartbeat mutes (TTL expiry), fault
windows armed on the :mod:`~nomad_tpu_torch.chaos.injector` registry, and a
mid-run leader kill (``raft.transfer_leadership`` — the in-proc
equivalent of SIGKILLing the leader: abrupt, mid-write, with the broker
flushed and the new leader restoring evals and heartbeats).

Every event application has bounded retries with backoff — injected
faults (``ChaosFault``), leadership races (``NotLeaderError``), and RPC
weather are expected, not errors. After the last event the driver
quiesces: disarms everything (in a ``finally``), restores muted/drained
nodes, and waits for the cluster to converge before running the
post-run state-store invariant sweep that the SLO gate consumes.

Cluster plumbing is factored into overridable hooks (``_start_cluster``,
``_leader``, ``_leader_state``, ``_broker_stats``, ``_kill_leader``,
``_post_trace``, ``_replica_run_counts``, ``_shutdown``) so
:class:`nomad_tpu_torch.chaos.crash.CrashReplay` can drive the same trace
against a REAL multi-process wire-raft cluster where the leader kill is
a SIGKILL -9.

Copied from ``nomad_tpu/chaos/replay.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. The servers run on
``ServerConfig.device`` as the port's ``Server`` does: CUDA unless the
caller asks for the CPU (``ServerConfig(device="cpu")``), with no move
to the CPU when CUDA is missing. Every server of the cluster has its own
``DeviceBatcher``; after the leader transfer the new leader's batcher
takes the launches. ``_shutdown`` stops every server even when one's
``stop`` raises (the failure goes to ``errors``). Boot-time writes (the
fleet's registration, the warmup jobs) retry past a leader change
(``_boot_write``), where the reference's boot failed; the heartbeat
pump starts before the warmup, so a slow first launch cannot expire the
fleet.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Set, Tuple

from .. import mock
from ..rpc import transport as rpc_transport
from ..rpc.transport import RPCError
from ..server.raft import InProcRaft, NotLeaderError
from ..server.server import Server, ServerConfig
from ..trace import attribution, lifecycle, stitch
from ..trace import capacity as capacity_trace
from ..trace import context as xtrace
from .injector import ChaosFault, ChaosInjector
from .trace import ChaosEvent, generate_trace, trace_kind_counts

# bounded per-event retry: flapping faults degrade an event to "late",
# never to a hot loop or a wedged replay. ConnectionError is an OSError
# subclass, so RPC weather against a real cluster is covered too.
_EVENT_RETRIES = 6
_EVENT_BACKOFF_S = 0.05
_RETRYABLE = (ChaosFault, NotLeaderError, RuntimeError, KeyError,
              RPCError, OSError)
# a boot-time write (fleet registration, warmup jobs) retries past a
# leader change for this long: the cluster may still be settling its
# first elections, most of all on a loaded host
_BOOT_WRITE_S = 60.0


def invariant_sweep_allocs(
    allocs: List,
    expected: Dict[Tuple[str, str], int],
    stopped: Set[Tuple[str, str]],
) -> Dict[str, object]:
    """Post-run sweep over an alloc list: zero lost / duplicated allocs.

    - *duplicated*: an alloc id present twice, or two desired-run allocs
      holding the same (job, name) slot — the OCC/redispatch machinery
      double-placed an index.
    - *lost*: a live job whose desired-run alloc count is below its
      task-group count — churn ate a placement and nothing rescheduled it.
    - *orphaned*: desired-run allocs belonging to a stopped job.

    Takes a plain alloc list (not a state store) so the same sweep runs
    against remote replicas fetched over RPC by the crash harness.
    """
    from ..structs.structs import ALLOC_DESIRED_RUN

    violations: List[str] = []

    id_counts = Counter(a.id for a in allocs)
    dup_ids = {aid: n for aid, n in id_counts.items() if n > 1}
    for aid, n in sorted(dup_ids.items()):
        violations.append(f"alloc id {aid} appears {n} times")

    run_by_job: Dict[Tuple[str, str], List] = {}
    for a in allocs:
        if a.desired_status == ALLOC_DESIRED_RUN:
            run_by_job.setdefault((a.namespace, a.job_id), []).append(a)

    lost = 0
    dup_slots = 0
    for key, want in sorted(expected.items()):
        have = run_by_job.get(key, [])
        if len(have) < want:
            lost += want - len(have)
            violations.append(
                f"job {key[1]}: {len(have)}/{want} desired-run allocs"
            )
        name_counts = Counter(a.name for a in have)
        for name, n in sorted(name_counts.items()):
            if n > 1:
                dup_slots += n - 1
                violations.append(f"slot {name} held by {n} run allocs")

    orphaned = 0
    for key in sorted(stopped):
        n = len(run_by_job.get(key, []))
        if n:
            orphaned += n
            violations.append(f"stopped job {key[1]} still has {n} run allocs")

    return {
        "lost": lost,
        "duplicated": len(dup_ids) + dup_slots,
        "orphaned": orphaned,
        "converged": not violations,
        "violations": violations[:20],
    }


def invariant_sweep(
    state,
    expected: Dict[Tuple[str, str], int],
    stopped: Set[Tuple[str, str]],
) -> Dict[str, object]:
    """State-store form of :func:`invariant_sweep_allocs`."""
    return invariant_sweep_allocs(state.allocs(), expected, stopped)


class ChurnReplay:
    """Replay a chaos trace against a fresh in-proc cluster.

    ``run()`` returns the result dict :class:`nomad_tpu_torch.chaos.slo.SLOGate`
    evaluates: lifecycle trace summary, measured placement throughput,
    the invariant sweep, per-point fault fire counts, and replay
    bookkeeping (events applied, degraded events, leader kills).
    """

    def __init__(
        self,
        seed: int = 0,
        trace: Optional[List[ChaosEvent]] = None,
        n_servers: int = 3,
        n_nodes: int = 100,
        config: Optional[ServerConfig] = None,
        time_scale: float = 1.0,
        settle_timeout_s: float = 30.0,
        trace_kwargs: Optional[dict] = None,
        warmup_counts: Tuple[int, ...] = (),
        autoscale: bool = False,
        lock_witness: bool = False,
        race_witness: bool = False,
    ) -> None:
        self.seed = int(seed)
        kw = dict(trace_kwargs or {})
        kw.setdefault("n_nodes", n_nodes)
        self.trace = trace if trace is not None else generate_trace(self.seed, **kw)
        self.n_servers = n_servers
        self.n_nodes = n_nodes
        self.config = config or ServerConfig(
            heartbeat_min_ttl=1.5,
            heartbeat_max_ttl=2.5,
            # the trace's TTL-expiry faults expire at the TTL itself
            heartbeat_grace=0.0,
            eval_gc_interval=3600.0,
        )
        self.time_scale = float(time_scale)
        self.settle_timeout_s = float(settle_timeout_s)
        self.warmup_counts = tuple(warmup_counts)

        self.servers: List[Server] = []
        self.node_ids: List[str] = []
        self.injector = ChaosInjector(seed=self.seed)
        # nomad-lockdep: arm the runtime lock witness for the whole run
        # and cross-check witnessed order edges against the static graph
        self.lock_witness = bool(lock_witness)
        # nomad-race: arm the Eraser lockset witness too — any tracked
        # shared field whose candidate lockset empties under churn fails
        # the run, and runtime-witnessed sharing is cross-checked against
        # the static inferred-shared set
        self.race_witness = bool(race_witness)

        self._muted: Set[str] = set()
        self._mute_lock = threading.Lock()
        self._pump_stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self._nurse_thread: Optional[threading.Thread] = None
        # the nurse needs in-proc state access; the crash subclass (which
        # forbids canaried rollouts anyway) turns it off
        self._nurse_enabled = True

        # capacity-pressure bookkeeping: a sampler thread tracks blocked
        # depth peaks and placement flatlines (in-proc state access; the
        # crash subclass turns it off), and `autoscale=True` wires every
        # server's leader autoscaler to register fresh mock nodes
        self.autoscale = bool(autoscale)
        self._capacity_monitor_enabled = True
        self._monitor_thread: Optional[threading.Thread] = None
        self._peak_blocked = 0
        self._max_flatline_s = 0.0
        self._autoscaled_nodes = 0

        # convergence bookkeeping fed to the invariant sweep
        self._expected: Dict[Tuple[str, str], int] = {}
        self._stopped: Set[Tuple[str, str]] = set()
        self._drained: Set[str] = set()
        self._preempt_fillers: Dict[int, Tuple[str, str]] = {}
        self._preemption_enabled = False

        self.events_applied = 0
        self.events_degraded = 0   # exhausted retries; logged, not fatal
        self.leader_kills = 0
        self._boot_allocs = 0
        self.errors: List[str] = []
        self.fault_fires: Dict[str, int] = {}

    # -- cluster plumbing (the hooks CrashReplay overrides) ---------------

    def _start_cluster(self) -> None:
        raft = InProcRaft()
        for i in range(self.n_servers):
            self.servers.append(  # race-ok: bootstrap runs before the pump/nurse threads start
                Server(self.config, raft=raft, name=f"chaos-s{i + 1}")
            )
        if self.autoscale:
            # every server gets the node provider — whichever holds
            # leadership runs the (leadership-armed) loop
            for s in self.servers:
                s.autoscaler.scale_up_fn = self._autoscale_up
        for s in self.servers:
            s.start()

    def _autoscale_up(self, n: int) -> int:
        """Autoscaler node provider: register ``n`` fresh mock nodes on
        the current leader (each registration fires the capacity-change
        trigger, storming parked evals back out) and enroll them in the
        heartbeat pump so they stay READY."""
        leader = self._leader(timeout=2.0)
        added = 0
        for _ in range(int(n)):
            node = mock.node()
            leader.register_node(node)
            self.node_ids.append(node.id)  # race-ok: GIL-atomic append; replay thread is the only mutator
            added += 1
        self._autoscaled_nodes += added
        return added

    def _leader(self, timeout: float = 5.0) -> Server:
        deadline = time.monotonic() + timeout
        while True:
            for s in self.servers:
                if s.is_leader:
                    return s
            if time.monotonic() > deadline:
                raise RuntimeError("no leader within timeout")
            time.sleep(0.01)

    def _pump_leader(self):
        """Server the heartbeat pump drives. The crash harness routes
        this through a rotating live FOLLOWER so heartbeats traverse
        layer-7 leader forwarding — the traffic that populates
        ``forward_hop`` in the stitched ledger."""
        return self._leader(timeout=1.0)

    def _leader_state(self):
        """Read surface for the leader's FSM (a StateStore, or the crash
        harness's RPC-backed facade)."""
        return self._leader().fsm.state

    def _broker_stats(self) -> Dict[str, int]:
        return self._leader().eval_broker.stats()

    def _kill_leader(self) -> None:
        leader = self._leader()
        raft = leader.raft
        peers = [s.peer for s in self.servers if s is not leader]
        if peers:
            raft.transfer_leadership(peers[0])
            self.leader_kills += 1

    def _post_trace(self) -> None:
        """Hook between the last trace event and settle (the crash
        harness restarts the killed server here)."""

    def _replica_run_counts(self) -> Dict[str, Optional[int]]:
        return {
            s.name: s.fsm.state.count_allocs_desired_run()
            for s in self.servers
        }

    def _flight_stats(self) -> Dict[str, object]:
        """Per-server flight-recorder health (armed only on the leader;
        the crash harness's out-of-proc replicas have no in-proc
        recorder and report nothing here)."""
        out: Dict[str, object] = {}
        for s in self.servers:
            fl = getattr(s, "flight", None)
            if fl is not None:
                out[getattr(s, "name", "?")] = dict(
                    armed=fl.armed, **fl.overhead())
        return out

    def _span_sets(self) -> List[List[Dict[str, object]]]:
        """Per-process span sets for stitching. The in-proc harness has
        exactly one process (its own ring); the crash harness returns
        every replica's Trace.Export drain plus the driver's ring."""
        return [list(xtrace.export()["spans"])]

    def _rpc_result(self) -> Dict[str, object]:
        """Per-method RPC table. The in-proc harness reports the driver
        process's table (empty when ServerProxy short-circuits the
        wire); the crash harness merges every replica's."""
        return {"cluster": rpc_transport.rpc_stats(), "replicas": {}}

    def _stitched_result(self) -> Dict[str, object]:
        """Stitched cross-process trace sample + bottleneck ledger: the
        nomad-xtrace view of the run. Full trees are too big for a
        result dict, so this carries the ranked component report, clock
        offsets, and ONE formatted sample tree (the span-richest
        trace)."""
        st = stitch.stitch(self._span_sets())
        spans = st.pop("spans")
        report = attribution.stitched_report(spans)
        sample = ""
        if st["traces"]:
            richest = max(st["traces"],
                          key=lambda t: (t["spans"], t["trace_id"]))
            sample = stitch.format_tree(richest)
        return {
            "processes": st["processes"],
            "clock_offsets_ms": st["clock_offsets_ms"],
            "span_count": st["span_count"],
            "trace_count": st["trace_count"],
            "orphan_spans": sum(t["orphans"] for t in st["traces"]),
            "report": report,
            "sample_trace": sample,
        }

    def _extra_result(self) -> Dict[str, object]:
        """Harness-specific additions merged into the run() result."""
        return {}

    def _shutdown(self) -> None:
        self._pump_stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2.0)
        if self._nurse_thread is not None:
            self._nurse_thread.join(timeout=2.0)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2.0)
        # every server is stopped even when one's stop raises: a server
        # left running would outlive the replay in this process
        for s in self.servers:
            try:
                s.stop()
            except Exception as e:  # noqa: BLE001 — stop the others first
                self.errors.append(f"stop {s.name}: {e!r}")  # race-ok: GIL-atomic append; the pump, nurse and monitor have been joined

    # -- background pumps --------------------------------------------------

    def _pump_heartbeats(self) -> None:
        """Background client stand-in: heartbeat every live node well
        inside its TTL. Muted nodes are skipped (that IS the TTL-expiry
        fault); injected heartbeat faults surface here as ChaosFault and
        are simply dropped heartbeats."""
        interval = max(0.05, self.config.heartbeat_min_ttl / 3.0)
        while not self._pump_stop.wait(interval):
            try:
                leader = self._pump_leader()
            except RuntimeError:
                continue
            with self._mute_lock:
                muted = set(self._muted)
            # snapshot: capacity_release / autoscaler threads append
            for node_id in list(self.node_ids):
                if node_id in muted:
                    continue
                try:
                    leader.heartbeat(node_id)
                except _RETRYABLE:
                    continue
                except Exception as e:  # noqa: BLE001 — pump must survive
                    self.errors.append(f"heartbeat pump: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle

    def _nurse_deployments(self) -> None:
        """Client-health stand-in: no real clients run here, so the
        allochealth hook (client/allochealth in the reference) is pumped
        by the driver — active deployments get their unreported allocs
        marked healthy, and canaried deployments are promoted once every
        placed canary reports healthy, letting canaried rollouts run to
        completion instead of stalling the sweep."""
        while not self._pump_stop.wait(0.2):
            try:
                self._pump_deployments_once()
            except _RETRYABLE:
                continue
            except Exception as e:  # noqa: BLE001 — nurse must survive
                self.errors.append(f"deployment nurse: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle

    def _pump_deployments_once(self) -> None:
        from ..structs.structs import (
            ALLOC_CLIENT_RUNNING,
            ALLOC_DESIRED_RUN,
            AllocDeploymentStatus,
        )

        leader = self._leader(timeout=1.0)
        state = leader.fsm.state
        for d in state.deployments():
            if not d.active():
                continue
            updates = []
            for a in state.allocs_by_job(d.namespace, d.job_id, True):
                if (
                    a.deployment_id != d.id
                    or a.desired_status != ALLOC_DESIRED_RUN
                    or (a.deployment_status is not None
                        and a.deployment_status.healthy is not None)
                ):
                    continue
                u = a.copy_skip_job()
                u.client_status = ALLOC_CLIENT_RUNNING
                u.deployment_status = AllocDeploymentStatus(
                    healthy=True, timestamp_ns=time.time_ns(),
                    canary=(a.deployment_status.canary
                            if a.deployment_status else False),
                )
                updates.append(u)
            if updates:
                leader.update_allocs_from_client(updates)
            d2 = state.deployment_by_id(d.id)
            if d2 is None or not d2.active() or not d2.requires_promotion():
                continue
            # a placed-canary id can name an alloc that never committed
            # (a partially applied plan still recorded it in the
            # deployment) or one preempted since: it reports no health.
            # Promote once every live canary is healthy and each group's
            # healthy canaries reach its desired count, the count
            # Nomad's promotion gate reads (the reference waited on
            # every recorded id, and wedged on such a one)
            ready = False
            for tg in d2.task_groups.values():
                live = [
                    a for a in (state.alloc_by_id(cid) for cid in (tg.placed_canaries or []))
                    if a is not None and a.desired_status == ALLOC_DESIRED_RUN
                ]
                healthy = [
                    a for a in live
                    if a.deployment_status is not None and a.deployment_status.healthy
                ]
                if len(healthy) != len(live) or len(healthy) < tg.desired_canaries:
                    ready = False
                    break
                ready = ready or bool(healthy)
            if ready:
                try:
                    leader.deployment_watcher.promote(d2.id)
                except (KeyError, ValueError):
                    pass  # promoted or failed concurrently

    def _boot_write(self, leader, fn):
        """``fn(leader)`` for a write before the trace starts; returns the
        leader it ran on. A retryable error (the leader stepped down while
        the cluster settles its first elections, RPC weather) re-resolves
        the leader and retries with backoff, for up to _BOOT_WRITE_S: a
        leader change at boot is legal raft, and a client retries past it
        (the reference registered the fleet on the first leader it saw,
        and its boot failed with NotLeaderError when that one stepped
        down). Each boot write is idempotent."""
        deadline = time.monotonic() + _BOOT_WRITE_S
        delay = _EVENT_BACKOFF_S
        while True:
            try:
                if leader is None:
                    leader = self._leader()
                fn(leader)
                return leader
            except _RETRYABLE:
                if time.monotonic() > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
                leader = None

    def _boot(self) -> None:
        self._start_cluster()
        leader = self._leader()
        for _ in range(self.n_nodes):
            n = mock.node()
            self.node_ids.append(n.id)  # race-ok: bootstrap runs before the pump/nurse threads start
            leader = self._boot_write(leader, lambda ldr, n=n: ldr.register_node(n))
        # the fleet heartbeats from here on: the warmup's first launches
        # (a cold card's context and kernel loads) can outlast the TTL,
        # and a fleet left to expire meanwhile leaves the warmup jobs
        # nothing to run on (the reference started the pump after the
        # warmup; each warmup job then waited out its 60 s)
        self._pump_thread = threading.Thread(
            target=self._pump_heartbeats, name="chaos-heartbeat-pump",
            daemon=True,
        )
        self._pump_thread.start()
        self._warmup(leader)
        # gauges measure the churn run, not boot/warmup
        lifecycle.reset()
        capacity_trace.reset()
        xtrace.reset()
        xtrace.set_process("chaos-driver")
        rpc_transport.reset_rpc_stats()
        if self._nurse_enabled:
            self._nurse_thread = threading.Thread(
                target=self._nurse_deployments, name="chaos-deploy-nurse",
                daemon=True,
            )
            self._nurse_thread.start()
        if self._capacity_monitor_enabled:
            self._monitor_thread = threading.Thread(
                target=self._watch_capacity, name="chaos-capacity-monitor",
                daemon=True,
            )
            self._monitor_thread.start()

    def _watch_capacity(self) -> None:
        """Capacity-pressure sampler: blocked-depth high-water mark, and
        the longest stretch where blocked evals remained but NOTHING
        placed — the convoy signature the storm SLO bounds (placement
        rate must never flatline while work is parked and capacity is
        arriving)."""
        last_allocs = -1
        last_progress_t = time.monotonic()
        while not self._pump_stop.wait(0.1):
            try:
                leader = self._leader(timeout=1.0)
                blocked = leader.blocked_evals.stats().get("total_blocked", 0)
                capacity_trace.note_blocked_depth(blocked)
                if blocked > self._peak_blocked:
                    self._peak_blocked = blocked
                n = leader.fsm.state.count_allocs_desired_run()
                now = time.monotonic()
                if n != last_allocs or blocked == 0:
                    last_allocs = n
                    last_progress_t = now
                elif now - last_progress_t > self._max_flatline_s:
                    self._max_flatline_s = now - last_progress_t
            except Exception:  # noqa: BLE001 — monitor must survive churn
                continue

    def _warmup(self, leader: Server) -> None:
        """Pre-trace warmup: place (then purge) one throwaway job per
        requested task-group count, so the first device launches at the
        trace's eval shapes happen OUTSIDE the measured window. The
        reference warms XLA's compile buckets here; on the card the same
        jobs take the kernels' first use (the build if nothing built
        them yet, the first launch on each batcher's stream and the
        pinned slab's first fill) out of the window."""
        from ..structs.structs import ALLOC_DESIRED_RUN

        for i, count in enumerate(self.warmup_counts):
            job = self._make_job(f"chaos-warmup-{i}", count, 100, 64, 50)
            leader = self._boot_write(leader, lambda ldr, job=job: ldr.register_job(job))
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                run = [
                    a for a in leader.fsm.state.allocs_by_job(
                        job.namespace, job.id, True)
                    if a.desired_status == ALLOC_DESIRED_RUN
                ]
                if len(run) >= count:
                    break
                time.sleep(0.05)
            leader = self._boot_write(
                leader, lambda ldr, job=job: ldr.deregister_job(job.namespace, job.id, purge=True))
        if self.warmup_counts:
            leader.drain_evals(timeout=30.0)
        # warmup rows stay in the store (GC is off): exclude them from
        # the run's placement-throughput numerator
        self._boot_allocs = len(self._leader_state().allocs())

    # -- event application -----------------------------------------------

    def _make_job(self, job_id: str, count: int, cpu: int, memory_mb: int,
                  priority: int):
        job = mock.job()
        job.id = job_id
        job.name = job_id
        job.priority = priority
        tg = job.task_groups[0]
        tg.count = count
        res = tg.tasks[0].resources
        res.cpu = cpu
        res.memory_mb = memory_mb
        res.networks = []   # churn jobs don't contend on ports
        return job

    def _set_service_preemption(self) -> None:
        from ..structs.structs import PreemptionConfig, SchedulerConfiguration

        leader = self._leader()
        _, cfg = leader.fsm.state.scheduler_config()
        cfg = copy.deepcopy(cfg) if cfg is not None else SchedulerConfiguration()
        if cfg.preemption_config is None:
            cfg.preemption_config = PreemptionConfig()
        cfg.preemption_config.service_scheduler_enabled = True
        leader.raft_apply("scheduler-config", cfg)

    def _enable_service_preemption(self) -> None:
        # service-scheduler preemption is off by default (matching the
        # reference); a pressure wave flips it once, through raft, so
        # every replica agrees
        if self._preemption_enabled:
            return
        self._set_service_preemption()
        self._preemption_enabled = True

    def _apply_event(self, ev: ChaosEvent) -> None:
        a = ev.args
        if ev.kind == "register_job" or ev.kind == "hipri_job":
            prio = a.get("priority", 80 if ev.kind == "hipri_job" else 50)
            job = self._make_job(a["job_id"], a["count"], a["cpu"],
                                 a["memory_mb"], prio)
            self._leader().register_job(job)
            self._expected[(job.namespace, job.id)] = a["count"]
            self._stopped.discard((job.namespace, job.id))
        elif ev.kind == "stop_job":
            leader = self._leader()
            key = None
            for k in self._expected:
                if k[1] == a["job_id"]:
                    key = k
                    break
            if key is None:
                return   # registration degraded earlier; nothing to stop
            leader.deregister_job(key[0], key[1], purge=False)
            self._expected.pop(key, None)
            self._stopped.add(key)
        elif ev.kind == "rollout":
            leader = self._leader()
            for (ns, jid), count in list(self._expected.items()):
                if jid != a["job_id"]:
                    continue
                stored = self._leader_state().job_by_id(ns, jid)
                if stored is None:
                    return
                job = copy.deepcopy(stored)
                job.task_groups[0].tasks[0].resources.cpu = a["cpu"]
                canary = int(a.get("canary", 0))
                if canary:
                    # canaried deployment update: stage `canary` new-
                    # version allocs; the deployment nurse reports their
                    # health and promotes, unleashing the rolling
                    # replacement (reference update block + deploymentwatcher)
                    from ..structs.structs import UpdateStrategy

                    update = UpdateStrategy(
                        max_parallel=max(1, count), canary=canary)
                    job.update = update
                    job.task_groups[0].update = update
                leader.register_job(job)
                return
        elif ev.kind == "preempt_pressure":
            self._enable_service_preemption()
            wave = int(a.get("wave", 0))
            fill = self._make_job(
                f"preempt-fill-{wave}", a["filler_count"], a["filler_cpu"],
                a.get("memory_mb", 64), priority=10)
            self._leader().register_job(fill)
            # fillers are pressure, not fleet: under saturation they are
            # LEGITIMATELY part-placed then evicted by the hipri burst,
            # so they never enter _expected; release moves them to the
            # stopped set, where leftovers DO count (as orphans)
            self._preempt_fillers[wave] = (fill.namespace, fill.id)
        elif ev.kind == "preempt_release":
            wave = int(a.get("wave", 0))
            key = self._preempt_fillers.pop(wave, None)
            if key is None:
                return   # pressure event degraded earlier
            self._leader().deregister_job(key[0], key[1], purge=False)
            self._stopped.add(key)
        elif ev.kind == "saturate":
            # a burst of real fleet jobs past free capacity: placements
            # fail, evals park in BlockedEvals. They enter _expected —
            # the sweep requires them placed once capacity arrives
            wave = int(a.get("wave", 0))
            leader = self._leader()
            for i in range(int(a["job_count"])):
                job = self._make_job(
                    f"sat-{wave}-{i}", a["count"], a["cpu"],
                    a["memory_mb"], priority=40)
                leader.register_job(job)
                self._expected[(job.namespace, job.id)] = a["count"]
                self._stopped.discard((job.namespace, job.id))
        elif ev.kind == "capacity_release":
            # node-registration burst: each lands in the FSM and fires
            # the capacity-change trigger — the unblock storm
            leader = self._leader()
            for _ in range(int(a.get("node_count", 0))):
                node = mock.node()
                leader.register_node(node)
                self.node_ids.append(node.id)  # race-ok: GIL-atomic append; replay thread is the only mutator
        elif ev.kind == "drain_node":
            node_id = self.node_ids[a["node_idx"] % len(self.node_ids)]
            self._leader().update_node_drain(node_id, True)
            self._drained.add(node_id)
        elif ev.kind == "undrain_node":
            node_id = self.node_ids[a["node_idx"] % len(self.node_ids)]
            self._leader().update_node_drain(node_id, None)
            self._drained.discard(node_id)
        elif ev.kind == "mute_node":
            node_id = self.node_ids[a["node_idx"] % len(self.node_ids)]
            with self._mute_lock:
                self._muted.add(node_id)
        elif ev.kind == "unmute_node":
            node_id = self.node_ids[a["node_idx"] % len(self.node_ids)]
            with self._mute_lock:
                self._muted.discard(node_id)
        elif ev.kind == "arm_fault":
            self.injector.arm(
                a["point"], mode=a.get("mode", "fail"),
                prob=a.get("prob", 1.0), delay_s=a.get("delay_s", 0.0),
                max_fires=a.get("max_fires"),
            )
        elif ev.kind == "disarm_fault":
            point = a["point"]
            self.fault_fires[point] = (
                self.fault_fires.get(point, 0) + self.injector.fires(point)
            )
            self.injector.disarm(point)
        elif ev.kind == "leader_kill":
            self._kill_leader()
        else:
            raise ValueError(f"unknown trace event kind {ev.kind!r}")

    def _apply_with_retries(self, ev: ChaosEvent) -> None:
        delay = _EVENT_BACKOFF_S
        for attempt in range(_EVENT_RETRIES):
            try:
                self._apply_event(ev)
                self.events_applied += 1
                return
            except _RETRYABLE as e:
                if attempt == _EVENT_RETRIES - 1:
                    self.events_degraded += 1
                    self.errors.append(f"{ev.kind}@{ev.t:.2f}: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
                    return
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    # -- quiesce + measurement --------------------------------------------

    def _live_jobs_converged(self, state) -> bool:
        from ..structs.structs import ALLOC_DESIRED_RUN

        for (ns, jid), want in self._expected.items():
            run = [
                x for x in state.allocs_by_job(ns, jid, True)
                if x.desired_status == ALLOC_DESIRED_RUN
            ]
            if len(run) != want or len({x.name for x in run}) != want:
                return False
        return True

    def _settle(self) -> bool:
        """Restore every disturbance, then wait for convergence."""
        with self._mute_lock:
            self._muted.clear()
        for node_id in list(self._drained):
            try:
                self._leader().update_node_drain(node_id, None)
            except Exception as e:  # noqa: BLE001
                self.errors.append(f"undrain {node_id}: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
        self._drained.clear()

        deadline = time.monotonic() + self.settle_timeout_s
        nudge_at = time.monotonic() + self.settle_timeout_s / 2.0
        nudged = False
        while time.monotonic() < deadline:
            try:
                stats = self._broker_stats()
                broker_idle = (
                    stats["total_ready"] == 0
                    and stats["total_unacked"] == 0
                    and stats["total_waiting"] == 0
                )
                if broker_idle and self._live_jobs_converged(
                        self._leader_state()):
                    return True
            except _RETRYABLE as e:
                self.errors.append(f"settle probe: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
                time.sleep(0.2)
                continue
            # drain/migrate health gating has no real clients here: one
            # re-evaluation nudge per straggler halfway through the window
            if not nudged and time.monotonic() >= nudge_at:
                nudged = True
                leader = self._leader()
                for (ns, jid) in list(self._expected):
                    try:
                        leader.evaluate_job(ns, jid)
                    except Exception:  # noqa: BLE001 — stopped mid-nudge
                        pass
            time.sleep(0.05)
        return False

    def _measure(self, settled: bool, t0: float, t_run: float) -> Dict[str, object]:
        """Read the cluster while it is still up (before _shutdown)."""
        from ..structs.structs import ALLOC_DESIRED_RUN

        duration = time.monotonic() - t0
        # throughput over the churn window itself (boot + device warmup
        # excluded — they are setup, not the workload under measurement)
        run_duration = time.monotonic() - t_run
        allocs = self._leader_state().allocs()
        inv = invariant_sweep_allocs(allocs, self._expected, self._stopped)
        if not settled:
            inv["converged"] = False
            inv["violations"] = (["settle timeout"] + inv["violations"])[:20]

        # replica consistency: every FSM saw the same applied log (a
        # permanently-dead replica reports None and is excluded)
        counts = self._replica_run_counts()
        live = [c for c in counts.values() if c is not None]
        if len(set(live)) > 1:
            inv["converged"] = False
            inv["violations"].append(f"replica divergence: {counts}")

        # allocs() retains stopped/superseded rows until GC (disabled for
        # the run), so its length approximates placements ever created;
        # boot-time warmup rows are excluded
        total_allocs = max(0, len(allocs) - self._boot_allocs)
        result = {
            "seed": self.seed,
            "duration_s": round(duration, 3),
            "trace_events": len(self.trace),
            "trace_kinds": trace_kind_counts(self.trace),
            "events_applied": self.events_applied,
            "events_degraded": self.events_degraded,
            "leader_kills": self.leader_kills,
            "fault_fires": dict(sorted(self.fault_fires.items())),
            "total_allocs": total_allocs,
            "desired_run_allocs": sum(
                1 for a in allocs if a.desired_status == ALLOC_DESIRED_RUN
            ),
            "replica_run_counts": counts,
            "throughput_allocs_per_s": round(total_allocs / run_duration, 2)
            if run_duration > 0 else None,
            "trace_summary": lifecycle.summary(),
            # wave-level critical-path ledger over the churn window: the
            # ranked decomposition names the stage the wall went to, and
            # its coverage self-check is SLO-gateable
            # (attribution_coverage_min)
            "bottleneck_report": attribution.bottleneck_report(),
            # nomad-xtrace: per-method RPC table + stitched trace sample
            "rpc": self._rpc_result(),
            "stitched": self._stitched_result(),
            "flight": self._flight_stats(),
            "capacity": self._capacity_result(),
            "invariants": inv,
            "errors": self.errors[:20],
        }
        result.update(self._extra_result())
        return result

    def _capacity_result(self) -> Dict[str, object]:
        """Storm ledger: unblock-to-place percentiles and batch stats
        from the capacity trace module, joined with the monitor's peak /
        flatline bookkeeping and the end-of-run drain check."""
        cap = capacity_trace.summary()
        peak = max(self._peak_blocked, int(cap.get("peak_blocked") or 0))
        final_blocked = None
        blocked_stats = None
        auto: Dict[str, object] = {}
        for s in self.servers:
            tracker = getattr(s, "blocked_evals", None)
            if tracker is None:
                continue
            if getattr(s, "is_leader", False):
                blocked_stats = tracker.stats()
            scaler = getattr(s, "autoscaler", None)
            if scaler is not None and (scaler.stats().get("ticks")
                                       or self.autoscale):
                auto[getattr(s, "name", "?")] = scaler.stats()
        if blocked_stats is not None:
            final_blocked = blocked_stats.get("total_blocked", 0)
            cap["blocked_stats"] = blocked_stats
        cap.update({
            "peak_blocked": peak,
            "final_blocked": final_blocked,
            "blocked_drain_frac": (
                round(final_blocked / peak, 4)
                if peak and final_blocked is not None else None
            ),
            "max_flatline_s_while_blocked": round(self._max_flatline_s, 2),
            "autoscaled_nodes": self._autoscaled_nodes,
            "autoscaler": auto,
        })
        return cap

    def run(self) -> Dict[str, object]:
        t0 = time.monotonic()
        witness = None
        if self.lock_witness:
            from ..utils import lock_witness as _lw
            # armed BEFORE _boot so every factory-created lock in the
            # servers under churn is instrumented
            witness = _lw.arm()
        race = None
        if self.race_witness:
            from ..rpc import transport as _transport
            from ..trace import lifecycle as _lc
            from ..utils import race_witness as _rw
            # after any explicit lock-witness arm, so auto-arm bookkeeping
            # stays correct; module stat tables are re-minted AFTER arming
            # so they come out of the tracked factories
            race = _rw.arm()
            _lc.reset()
            _transport.reset_rpc_stats()
        try:
            self._boot()
            t_run = time.monotonic()
            start = t_run
            for ev in self.trace:
                target = start + ev.t * self.time_scale
                sleep_for = target - time.monotonic()
                if sleep_for > 0:
                    time.sleep(sleep_for)
                self._apply_with_retries(ev)
            # roll any still-armed fire counts into the tally before the
            # finally-disarm wipes them
            for point, st in self.injector.stats().items():
                self.fault_fires[point] = (
                    self.fault_fires.get(point, 0) + st["fires"]
                )
            self._post_trace()
            settled = self._settle()
            # measurement happens while the cluster is live: the crash
            # harness's replicas are separate processes that stop
            # answering RPC once _shutdown reaps them
            result = self._measure(settled, t0, t_run)
            if witness is not None:
                from ..analysis.lock_order import build_static_graph
                result["lock_witness"] = {
                    **witness.stats(),
                    "missing_from_static": [
                        list(e) for e in witness.cross_check(
                            build_static_graph())
                    ],
                }
            if race is not None:
                from ..analysis.shared_state import build_static_shared
                result["race_witness"] = {
                    **race.stats(),
                    "missing_from_static": sorted(
                        race.cross_check(build_static_shared())),
                }
            return result
        finally:
            if race is not None:
                from ..utils import race_witness as _rw
                _rw.disarm()
            if witness is not None:
                from ..utils import lock_witness as _lw
                _lw.disarm()
            self.injector.disarm_all()
            self._shutdown()
