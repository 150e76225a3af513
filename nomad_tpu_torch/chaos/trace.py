"""Deterministic churn/chaos traces: timestamped events, reproducible by seed.

A trace is a sorted list of ``ChaosEvent`` records — the full schedule of
everything the replay driver will do to the cluster: job registrations
and stops, destructive rollouts, high-priority arrivals, node drains and
restores, heartbeat mutes (TTL expiries), fault-window arms/disarms, and
at most one mid-run leader kill. ``generate_trace(seed)`` is a pure
function of its arguments (``random.Random(seed)`` only, no wall clock),
so the same seed always yields the same event trace — the property
``tests/test_chaos.py::test_trace_deterministic_by_seed`` pins.

Shape invariants the generator maintains (so a replay can settle):

- every ``drain_node`` has a matching ``undrain_node`` before the
  recovery tail;
- every ``mute_node`` (heartbeat expiry) has a matching ``unmute_node``;
- every ``arm_fault`` has a matching ``disarm_fault``;
- all disruption ends by ``recovery_frac * duration_s`` — the tail is
  clean air for the cluster to converge in before the SLO gate reads it.

Event kinds and their args:

====================  =====================================================
``register_job``      job_id, count, cpu, memory_mb, priority
``stop_job``          job_id (deregister, purge=False)
``rollout``           job_id, cpu [, canary] (resource-bump update; with
                      ``canary`` set it is a CANARIED deployment update —
                      that many canary allocs stage first and the rollout
                      only proceeds on promotion; without it the update is
                      destructive and replaces every alloc at once)
``hipri_job``         job_id, count, cpu, memory_mb [, priority]
                      (priority-80 arrival by default)
``drain_node``        node_idx
``undrain_node``      node_idx
``mute_node``         node_idx (stop heartbeating it: TTL expires, node
                      marked down, allocs lost + rescheduled)
``unmute_node``       node_idx (resume heartbeats: node returns READY)
``arm_fault``         point, mode, prob, delay_s, max_fires
``disarm_fault``      point
``preempt_pressure``  wave, filler_count, filler_cpu, memory_mb —
                      low-priority saturation: enable service-scheduler
                      preemption and register a priority-10 filler job
                      sized to soak node capacity (the generator follows
                      it with a priority-90 ``hipri_job`` burst that must
                      place by evicting fillers)
``preempt_release``   wave — deregister that wave's filler job (paired
                      before the recovery tail so the sweep converges)
``saturate``          wave, job_count, count, cpu, memory_mb — submit
                      job_count real jobs in one burst, sized well past
                      free capacity: placements fail and their evals
                      park in BlockedEvals (the saturated regime). The
                      jobs are fleet, not pressure — the sweep requires
                      them placed once capacity arrives
``capacity_release``  wave, node_count — register node_count fresh READY
                      nodes in one burst; every registration fires the
                      capacity-change trigger, so the parked evals
                      re-enqueue as an unblock storm through the
                      coalesced batch path
``leader_kill``       (none) — abrupt leader loss mid-run. In-proc replay
                      realizes it as a leadership transfer; the crash
                      harness as a real SIGKILL -9 of the leader process
====================  =====================================================

Copied from ``nomad_tpu/chaos/trace.py`` into the PyTorch port, which imports nothing
of ``nomad_tpu``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ChaosEvent:
    t: float           # seconds from replay start
    kind: str
    args: dict = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"t": round(self.t, 4), "kind": self.kind, "args": dict(self.args)}


def trace_to_jsonable(trace: List[ChaosEvent]) -> List[Dict[str, object]]:
    return [ev.to_dict() for ev in trace]


def trace_kind_counts(trace: List[ChaosEvent]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ev in trace:
        out[ev.kind] = out.get(ev.kind, 0) + 1
    return dict(sorted(out.items()))


# fault windows the generator draws from: (point, mode, prob, delay_s)
_FAULT_MENU = (
    ("device_dispatch", "fail", 0.5, 0.0),
    ("device_dispatch", "delay", 0.5, 0.05),
    ("plan_apply", "fail", 0.3, 0.0),
    ("broker_ack", "fail", 0.25, 0.0),
    ("raft_apply", "fail", 0.05, 0.0),
    ("heartbeat", "fail", 0.5, 0.0),
)


def generate_trace(
    seed: int = 0,
    duration_s: float = 30.0,
    n_nodes: int = 100,
    n_jobs: int = 20,
    tg_count: int = 8,
    stop_frac: float = 0.25,
    rollout_frac: float = 0.2,
    n_drains: int = 2,
    n_expiries: int = 2,
    n_hipri: int = 1,
    n_fault_windows: int = 3,
    leader_kill: bool = True,
    recovery_frac: float = 0.8,
    cpu: int = 200,
    memory_mb: int = 128,
    canary_frac: float = 0.0,
    n_preempt_waves: int = 0,
    n_saturate_waves: int = 0,
    saturate_jobs: int = 8,
    release_nodes: int = 0,
) -> List[ChaosEvent]:
    """Build a seeded churn schedule over ``duration_s`` trace-seconds.

    Phases: an initial registration wave over the first 20% of the
    window, overlapping churn (stops+replacements, rollouts, drains,
    TTL expiries, high-priority arrivals, fault windows, preemption
    waves, the leader kill) through ``recovery_frac``, then a clean
    recovery tail.

    ``canary_frac`` of the rollouts become canaried deployment updates;
    ``n_preempt_waves`` adds paired preempt_pressure/preempt_release
    waves (each with a hipri burst between them); ``n_saturate_waves``
    adds paired saturate/capacity_release waves (``saturate_jobs`` jobs
    past capacity, then ``release_nodes`` fresh nodes — the unblock
    storm). All default off, and when off the generator's rng
    consumption is unchanged — existing seeds keep producing
    byte-identical traces.
    """
    rng = Random(seed)
    events: List[ChaosEvent] = []
    recover_by = duration_s * recovery_frac

    def jitter(lo: float, hi: float) -> float:
        return lo + rng.random() * (hi - lo)

    # -- initial wave: the steady-state fleet --------------------------
    job_ids: List[str] = []
    for i in range(n_jobs):
        jid = f"churn-{i}"
        job_ids.append(jid)
        events.append(ChaosEvent(
            jitter(0.0, duration_s * 0.2), "register_job",
            {"job_id": jid, "count": tg_count, "cpu": cpu,
             "memory_mb": memory_mb, "priority": 50},
        ))

    churn_lo, churn_hi = duration_s * 0.2, recover_by

    # -- stop + replacement churn --------------------------------------
    n_stops = int(n_jobs * stop_frac)
    stopped = rng.sample(job_ids, n_stops) if n_stops else []
    for si, jid in enumerate(stopped):
        t = jitter(churn_lo, churn_hi * 0.9)
        events.append(ChaosEvent(t, "stop_job", {"job_id": jid}))
        # replacement keeps fleet load roughly level
        events.append(ChaosEvent(
            min(t + jitter(0.3, 1.5), recover_by), "register_job",
            {"job_id": f"churn-r{si}", "count": tg_count, "cpu": cpu,
             "memory_mb": memory_mb, "priority": 50},
        ))

    # -- rollouts (destructive, plus an optional canaried head) --------
    rollable = [j for j in job_ids if j not in stopped]
    rolled = rng.sample(rollable, min(len(rollable), int(n_jobs * rollout_frac)))
    n_canary = int(round(len(rolled) * canary_frac)) if canary_frac > 0 else 0
    for ri, jid in enumerate(rolled):
        args = {"job_id": jid, "cpu": cpu + 50}
        if ri < n_canary:
            # canaried rollouts need time for stage -> health -> promote
            # -> roll before the recovery tail, so bound them earlier
            args["canary"] = max(1, tg_count // 4)
            t = jitter(churn_lo, churn_hi * 0.7)
        else:
            t = jitter(churn_lo, churn_hi)
        events.append(ChaosEvent(t, "rollout", args))

    # -- high-priority arrivals ----------------------------------------
    for i in range(n_hipri):
        events.append(ChaosEvent(
            jitter(churn_lo, churn_hi), "hipri_job",
            {"job_id": f"hipri-{i}", "count": max(2, tg_count // 2),
             "cpu": cpu * 2, "memory_mb": memory_mb * 2},
        ))

    # -- node drains (paired restore) ----------------------------------
    drain_pool = list(range(n_nodes))
    rng.shuffle(drain_pool)
    for i in range(min(n_drains, len(drain_pool))):
        idx = drain_pool[i]
        t = jitter(churn_lo, churn_hi * 0.85)
        events.append(ChaosEvent(t, "drain_node", {"node_idx": idx}))
        events.append(ChaosEvent(
            min(t + jitter(0.5, 2.0), recover_by),
            "undrain_node", {"node_idx": idx},
        ))

    # -- heartbeat TTL expiries (paired resume) ------------------------
    for i in range(min(n_expiries, max(0, len(drain_pool) - n_drains))):
        idx = drain_pool[n_drains + i]
        t = jitter(churn_lo, churn_hi * 0.8)
        events.append(ChaosEvent(t, "mute_node", {"node_idx": idx}))
        events.append(ChaosEvent(
            min(t + jitter(1.0, 3.0), recover_by),
            "unmute_node", {"node_idx": idx},
        ))

    # -- fault windows (paired disarm) ---------------------------------
    menu = list(_FAULT_MENU)
    for i in range(n_fault_windows):
        point, mode, prob, delay_s = menu[i % len(menu)] if i < len(menu) \
            else rng.choice(menu)
        t = jitter(churn_lo, churn_hi * 0.8)
        events.append(ChaosEvent(t, "arm_fault", {
            "point": point, "mode": mode, "prob": prob,
            "delay_s": delay_s, "max_fires": None,
        }))
        events.append(ChaosEvent(
            min(t + jitter(1.0, 3.0), recover_by),
            "disarm_fault", {"point": point},
        ))

    # -- preemption-pressure waves (paired release) --------------------
    # each wave: low-priority fillers soak capacity, a priority-90 burst
    # arrives into the saturated cluster (placing it requires the service
    # scheduler to evict fillers), then the fillers are released before
    # the recovery tail so the sweep converges
    for i in range(n_preempt_waves):
        t = jitter(churn_lo, churn_hi * 0.7)
        events.append(ChaosEvent(t, "preempt_pressure", {
            "wave": i,
            "filler_count": max(4, tg_count),
            "filler_cpu": cpu * 3,
            "memory_mb": memory_mb,
        }))
        events.append(ChaosEvent(
            min(t + jitter(0.8, 1.5), recover_by), "hipri_job",
            {"job_id": f"preempt-hi-{i}", "count": max(2, tg_count // 2),
             "cpu": cpu * 2, "memory_mb": memory_mb, "priority": 90},
        ))
        events.append(ChaosEvent(
            min(t + jitter(2.5, 4.0), recover_by),
            "preempt_release", {"wave": i},
        ))

    # -- saturation waves (paired capacity release) --------------------
    # each wave: a burst of real jobs well past free capacity parks its
    # evals in BlockedEvals; the paired node-registration burst lands
    # before the recovery tail and storms them back out through the
    # coalesced unblock path (an armed autoscaler covers any remainder)
    for i in range(n_saturate_waves):
        t = jitter(churn_lo, churn_hi * 0.55)
        events.append(ChaosEvent(t, "saturate", {
            "wave": i,
            "job_count": saturate_jobs,
            "count": tg_count,
            "cpu": cpu,
            "memory_mb": memory_mb,
        }))
        events.append(ChaosEvent(
            min(t + jitter(1.5, 3.0), recover_by * 0.9),
            "capacity_release", {"wave": i, "node_count": release_nodes},
        ))

    # -- the leader kill -----------------------------------------------
    if leader_kill:
        events.append(ChaosEvent(
            jitter(duration_s * 0.4, duration_s * 0.6), "leader_kill", {},
        ))

    # stable order: time, then kind/args for deterministic ties
    events.sort(key=lambda ev: (ev.t, ev.kind, sorted(ev.args.items())))
    return events
