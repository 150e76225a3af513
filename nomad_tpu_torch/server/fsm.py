"""Finite state machine: applies replicated log entries to the StateStore.

Fills the role of reference ``nomad/fsm.go`` — one dispatch point so every
server materializes identical state from the same log. Log entries are
(type, payload) tuples of plain Python objects (the in-proc log passes them
by reference; a wire codec slots in at the raft boundary).

Copied from ``nomad_tpu/server/fsm.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..state import StateStore
from ..structs.structs import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_PENDING,
    Allocation,
    Deployment,
    Evaluation,
    Job,
    Node,
    SchedulerConfiguration,
)

# Log entry types (reference fsm.go:190-252 dispatch)
NODE_REGISTER = "node-register"
NODE_DEREGISTER = "node-deregister"
NODE_STATUS_UPDATE = "node-status-update"
NODE_DRAIN_UPDATE = "node-drain-update"
NODE_ELIGIBILITY_UPDATE = "node-eligibility-update"
JOB_REGISTER = "job-register"
JOB_DEREGISTER = "job-deregister"
EVAL_UPDATE = "eval-update"
EVAL_DELETE = "eval-delete"
ALLOC_UPDATE = "alloc-update"
ALLOC_CLIENT_UPDATE = "alloc-client-update"
ALLOC_UPDATE_DESIRED_TRANSITION = "alloc-update-desired-transition"
APPLY_PLAN_RESULTS = "apply-plan-results"
APPLY_PLAN_RESULTS_BATCH = "apply-plan-results-batch"
DEPLOYMENT_STATUS_UPDATE = "deployment-status-update"
DEPLOYMENT_PROMOTE = "deployment-promote"
DEPLOYMENT_ALLOC_HEALTH = "deployment-alloc-health"
DEPLOYMENT_DELETE = "deployment-delete"
SCHEDULER_CONFIG = "scheduler-config"
BATCH_NODE_UPDATE_DRAIN = "batch-node-update-drain"
JOB_STABILITY = "job-stability"
PERIODIC_LAUNCH = "periodic-launch"
ACL_POLICY_UPSERT = "acl-policy-upsert"
ACL_POLICY_DELETE = "acl-policy-delete"
ACL_TOKEN_UPSERT = "acl-token-upsert"
VAULT_ACCESSOR_UPSERT = "vault-accessor-upsert"
VAULT_ACCESSOR_DELETE = "vault-accessor-delete"
AUTOPILOT_CONFIG = "autopilot-config"
ACL_TOKEN_DELETE = "acl-token-delete"
ACL_TOKEN_BOOTSTRAP = "acl-token-bootstrap"


class NomadFSM:
    def __init__(self, state: Optional[StateStore] = None, logger=None) -> None:
        self.state = state or StateStore()
        self.logger = logger or logging.getLogger("nomad_tpu_torch.fsm")
        # leader-only hooks, set by the server when it holds leadership
        self.on_eval_upserted: Optional[Callable[[Evaluation], None]] = None
        self.on_capacity_change: Optional[Callable[[str, int], None]] = None
        # index<->time witnesses accumulate on every server (leader and
        # followers) so GC cutoffs survive leader transitions
        # (reference fsm.go witnesses inside Apply).
        self.timetable = None
        # blocking-query wakeups (watch/hub.WatchHub), attached by the
        # server on EVERY replica — followers notify their local hub so
        # stale reads park/wake against follower state. Standalone FSMs
        # (unit tests, parity oracles) leave it None and skip notify.
        # (annotated so the static lock-order graph types the attribute
        # and sees the apply -> hub._lock edge the runtime witness sees)
        self.watch_hub: Optional["WatchHub"] = None

    def apply(self, index: int, entry_type: str, payload) -> object:
        handler = _DISPATCH.get(entry_type)
        if handler is None:
            raise ValueError(f"unknown log entry type {entry_type!r}")
        if self.timetable is not None:
            self.timetable.witness(index)
        result = handler(self, index, payload)
        # notify AFTER the write is materialized, outside the dispatch
        # table (the hub's coalescing timer/clock must stay unreachable
        # from the fsm-determinism roots — notify only signals, it never
        # feeds state back into handlers)
        if self.watch_hub is not None:
            self.watch_hub.notify(index, _watch_touched(entry_type, payload))
        return result

    # -- handlers ----------------------------------------------------------

    def _apply_node_register(self, index: int, node: Node):
        self.state.upsert_node(index, node)
        stored = self.state.node_by_id(node.id)
        if self.on_capacity_change is not None and stored is not None and stored.ready():
            self.on_capacity_change(stored.computed_class, index)

    def _apply_node_deregister(self, index: int, node_id: str):
        self.state.delete_node(index, node_id)

    def _apply_node_status_update(self, index: int, payload):
        node_id, status = payload
        self.state.update_node_status(index, node_id, status)
        node = self.state.node_by_id(node_id)
        if self.on_capacity_change is not None and node is not None and node.ready():
            self.on_capacity_change(node.computed_class, index)

    def _apply_node_drain_update(self, index: int, payload):
        node_id, drain, mark_eligible = payload
        self.state.update_node_drain(index, node_id, drain, mark_eligible)

    def _apply_node_eligibility_update(self, index: int, payload):
        node_id, eligibility = payload
        self.state.update_node_eligibility(index, node_id, eligibility)
        node = self.state.node_by_id(node_id)
        if self.on_capacity_change is not None and node is not None and node.ready():
            self.on_capacity_change(node.computed_class, index)

    def _apply_job_register(self, index: int, job: Job):
        self.state.upsert_job(index, job)

    def _apply_job_deregister(self, index: int, payload):
        namespace, job_id, purge = payload
        if purge:
            self.state.delete_job(index, namespace, job_id)
        else:
            job = self.state.job_by_id(namespace, job_id)
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.state.upsert_job(index, stopped)

    def _apply_eval_update(self, index: int, evals: List[Evaluation]):
        self.state.upsert_evals(index, evals)
        if self.on_eval_upserted is not None:
            for ev in evals:
                stored = self.state.eval_by_id(ev.id)
                if stored is not None:
                    self.on_eval_upserted(stored)

    def _apply_eval_delete(self, index: int, payload):
        eval_ids, alloc_ids = payload
        self.state.delete_eval(index, eval_ids, alloc_ids)

    def _apply_alloc_update(self, index: int, allocs: List[Allocation]):
        self.state.upsert_allocs(index, allocs)

    def _apply_alloc_client_update(self, index: int, allocs: List[Allocation]):
        self.state.update_allocs_from_client(index, allocs)
        # terminal client states free capacity -> unblock
        if self.on_capacity_change is not None:
            for alloc in allocs:
                if alloc.client_terminal_status():
                    stored = self.state.alloc_by_id(alloc.id)
                    node = self.state.node_by_id(stored.node_id) if stored else None
                    if node is not None:
                        self.on_capacity_change(node.computed_class, index)

    def _apply_alloc_update_desired_transition(self, index: int, payload):
        transitions, evals = payload
        for alloc_id, transition in transitions.items():
            alloc = self.state.alloc_by_id(alloc_id)
            if alloc is None:
                continue
            updated = alloc.copy_skip_job()
            updated.desired_transition = transition
            updated.modify_index = index
            self.state.upsert_allocs(index, [updated])
        if evals:
            self._apply_eval_update(index, evals)

    def _apply_plan_results(self, index: int, payload):
        self.state.upsert_plan_results(
            index,
            alloc_updates=payload["alloc_updates"],
            allocs_stopped=payload["allocs_stopped"],
            allocs_preempted=payload.get("allocs_preempted", []),
            dense_placements=payload.get("dense_placements", []),
            deployment=payload.get("deployment"),
            deployment_updates=payload.get("deployment_updates"),
            eval_id=payload.get("eval_id", ""),
            timestamp_ns=payload.get("timestamp_ns", 0),
        )
        if payload.get("preemption_evals"):
            self._apply_eval_update(index, payload["preemption_evals"])
        # stopped allocs free capacity
        if self.on_capacity_change is not None:
            seen = set()
            for alloc in payload["allocs_stopped"]:
                node = self.state.node_by_id(alloc.node_id)
                if node is not None and node.computed_class not in seen:
                    seen.add(node.computed_class)
                    self.on_capacity_change(node.computed_class, index)

    def _apply_plan_results_batch(self, index: int, payloads):
        """One raft entry carrying SEVERAL plans' results — the leader's
        applier groups queued plans so the commit path pays raft/FSM
        dispatch once per batch instead of once per plan (the reference
        serializes per plan at plan_apply.go:45–70; batching is the
        TPU-era answer to C1M commit rates, where per-plan round trips
        dominate). Sequential application preserves per-plan semantics:
        the applier evaluated plan k+1 against a snapshot that already
        contained plan k's results.

        Payloads are independent plans, so failures are isolated per
        payload: the rest of the batch still applies (a shared failure
        would tell workers whose placements DID commit that they
        failed), and the per-payload error list returns to the leader's
        apply waiter so it can respond to each plan accurately. The
        errors are data-deterministic, so every replica partitions the
        batch identically."""
        from ..utils import metrics

        errors = []
        committed_dense = 0
        for payload in payloads:
            try:
                self._apply_plan_results(index, payload)
                errors.append(None)
                for block in payload.get("dense_placements", []):
                    committed_dense += len(block.ids)
            except Exception as e:  # noqa: BLE001 — isolate to this plan
                logging.getLogger("nomad_tpu_torch.fsm").exception(
                    "plan payload in batch failed to apply"
                )
                errors.append(str(e) or e.__class__.__name__)
        if committed_dense:
            # commit-side ground truth for the async pipeline: placements
            # that actually landed in the FSM, as opposed to the
            # dispatch-side "submitted" counters upstream
            metrics.incr_counter(
                "nomad.fsm.dense_placements_committed", committed_dense
            )
        return errors

    def _apply_deployment_status_update(self, index: int, payload):
        update, job, evaluation = payload
        d = self.state.deployment_by_id(update.deployment_id)
        if d is not None:
            nd = d.copy()
            nd.status = update.status
            nd.status_description = update.status_description
            self.state.upsert_deployment(index, nd)
        if job is not None:
            self.state.upsert_job(index, job)
        if evaluation is not None:
            self._apply_eval_update(index, [evaluation])

    def _apply_deployment_promote(self, index: int, payload):
        deployment_id, groups, description, evaluation = payload
        d = self.state.deployment_by_id(deployment_id)
        if d is not None:
            nd = d.copy()
            for group, dstate in nd.task_groups.items():
                if groups is None or group in groups:
                    dstate.promoted = True
            nd.status_description = description
            self.state.upsert_deployment(index, nd)
            # canaries lose canary status on promote
            for alloc_id in [
                a for s in (d.task_groups or {}).values() for a in s.placed_canaries
            ]:
                alloc = self.state.alloc_by_id(alloc_id)
                if alloc is not None and alloc.deployment_status is not None:
                    updated = alloc.copy_skip_job()
                    updated.deployment_status.canary = False
                    self.state.upsert_allocs(index, [updated])
        if evaluation is not None:
            self._apply_eval_update(index, [evaluation])

    def _apply_deployment_alloc_health(self, index: int, payload):
        deployment_id, healthy_ids, unhealthy_ids, timestamp_ns, dstatus, evaluation = payload
        self.state.update_deployment_alloc_health(
            index, deployment_id, healthy_ids, unhealthy_ids, timestamp_ns
        )
        if dstatus is not None:
            self._apply_deployment_status_update(index, (dstatus, None, None))
        if evaluation is not None:
            self._apply_eval_update(index, [evaluation])

    def _apply_deployment_delete(self, index: int, deployment_ids: List[str]):
        self.state.delete_deployment(index, deployment_ids)

    def _apply_scheduler_config(self, index: int, config: SchedulerConfiguration):
        self.state.scheduler_set_config(index, config)

    def _apply_job_stability(self, index: int, payload):
        namespace, job_id, version, stable = payload
        self.state.update_job_stability(index, namespace, job_id, version, stable)

    def _apply_periodic_launch(self, index: int, payload):
        namespace, job_id, launch_ns = payload
        self.state.upsert_periodic_launch(index, namespace, job_id, launch_ns)

    def _apply_batch_node_drain(self, index: int, payload):
        for node_id, (drain, mark_eligible) in payload.items():
            try:
                self.state.update_node_drain(index, node_id, drain, mark_eligible)
            except KeyError:
                pass

    # -- snapshot/restore --------------------------------------------------

    def _apply_acl_policy_upsert(self, index: int, policies):
        self.state.upsert_acl_policies(index, policies)

    def _apply_acl_policy_delete(self, index: int, names):
        self.state.delete_acl_policies(index, names)

    def _apply_acl_token_upsert(self, index: int, tokens):
        self.state.upsert_acl_tokens(index, tokens)

    def _apply_acl_token_delete(self, index: int, accessors):
        self.state.delete_acl_tokens(index, accessors)

    def _apply_acl_token_bootstrap(self, index: int, token):
        self.state.bootstrap_acl_token(index, token)

    def _apply_vault_accessor_upsert(self, index: int, records):
        self.state.upsert_vault_accessors(index, records)

    def _apply_vault_accessor_delete(self, index: int, alloc_ids):
        self.state.delete_vault_accessors(index, alloc_ids)

    def _apply_autopilot_config(self, index: int, config):
        self.state.autopilot_set_config(index, config)

    def snapshot(self) -> StateStore:
        return self.state.snapshot()

    def restore(self, snapshot: StateStore) -> None:
        self.state = snapshot
        # the whole store changed identity: every parked watcher must
        # re-query against the NEW tables, whatever it was watching
        if self.watch_hub is not None:
            self.watch_hub.notify_all(snapshot.latest_index)


# Every handler reachable from this table replays on every replica from
# the raft log — it must be a pure function of (state, index, payload).
# The fsm-determinism lint rule (nomad_tpu/analysis/) enforces that no
# handler, directly or transitively, reads the wall clock or RNG;
# timestamps/UUIDs must be stamped by the proposer and carried in the
# log entry payload.
_DISPATCH: Dict[str, Callable] = {
    NODE_REGISTER: NomadFSM._apply_node_register,
    NODE_DEREGISTER: NomadFSM._apply_node_deregister,
    NODE_STATUS_UPDATE: NomadFSM._apply_node_status_update,
    NODE_DRAIN_UPDATE: NomadFSM._apply_node_drain_update,
    NODE_ELIGIBILITY_UPDATE: NomadFSM._apply_node_eligibility_update,
    JOB_REGISTER: NomadFSM._apply_job_register,
    JOB_DEREGISTER: NomadFSM._apply_job_deregister,
    EVAL_UPDATE: NomadFSM._apply_eval_update,
    EVAL_DELETE: NomadFSM._apply_eval_delete,
    ALLOC_UPDATE: NomadFSM._apply_alloc_update,
    ALLOC_CLIENT_UPDATE: NomadFSM._apply_alloc_client_update,
    ALLOC_UPDATE_DESIRED_TRANSITION: NomadFSM._apply_alloc_update_desired_transition,
    APPLY_PLAN_RESULTS: NomadFSM._apply_plan_results,
    APPLY_PLAN_RESULTS_BATCH: NomadFSM._apply_plan_results_batch,
    DEPLOYMENT_STATUS_UPDATE: NomadFSM._apply_deployment_status_update,
    DEPLOYMENT_PROMOTE: NomadFSM._apply_deployment_promote,
    DEPLOYMENT_ALLOC_HEALTH: NomadFSM._apply_deployment_alloc_health,
    DEPLOYMENT_DELETE: NomadFSM._apply_deployment_delete,
    SCHEDULER_CONFIG: NomadFSM._apply_scheduler_config,
    BATCH_NODE_UPDATE_DRAIN: NomadFSM._apply_batch_node_drain,
    JOB_STABILITY: NomadFSM._apply_job_stability,
    PERIODIC_LAUNCH: NomadFSM._apply_periodic_launch,
    ACL_POLICY_UPSERT: NomadFSM._apply_acl_policy_upsert,
    ACL_POLICY_DELETE: NomadFSM._apply_acl_policy_delete,
    ACL_TOKEN_UPSERT: NomadFSM._apply_acl_token_upsert,
    ACL_TOKEN_DELETE: NomadFSM._apply_acl_token_delete,
    ACL_TOKEN_BOOTSTRAP: NomadFSM._apply_acl_token_bootstrap,
    VAULT_ACCESSOR_UPSERT: NomadFSM._apply_vault_accessor_upsert,
    VAULT_ACCESSOR_DELETE: NomadFSM._apply_vault_accessor_delete,
    AUTOPILOT_CONFIG: NomadFSM._apply_autopilot_config,
}


# -- watch-hub touch maps ----------------------------------------------------
#
# Which (table, key) pairs each entry type dirties, for post-apply watch
# notification. ``key=None`` means a bulk write to the table (wakes every
# watcher of it, row-level ones included). Key conventions match the read
# endpoints' subscriptions: nodes/evals/allocs/deployments key on their id,
# jobs on (namespace, id). The map errs TOWARD waking: a spurious wake
# costs one re-query; a missed one strands a watcher until its deadline —
# hence the unknown-entry fallback notifies every table.

_WATCH_ALL = tuple((t, None) for t in (
    "nodes", "jobs", "evals", "allocs", "deployments",
))


def _touched_plan_results(payload):
    # allocs stay a bulk touch: dense placements can carry thousands of
    # ids per plan and enumerating them on the apply hot path costs more
    # than the spurious row-watcher re-queries it would save. Evals and
    # deployments are few per plan, so those enumerate precisely — a plan
    # storm must not wake every parked row-level eval watcher (the serve
    # bench measures exactly this).
    out = [("allocs", None)]
    eval_id = payload.get("eval_id", "")
    out.append(("evals", eval_id or None))
    for ev in payload.get("preemption_evals") or ():
        out.append(("evals", ev.id))
    dep = payload.get("deployment")
    if dep is not None:
        out.append(("deployments", dep.id))
    for upd in payload.get("deployment_updates") or ():
        out.append(("deployments", upd.deployment_id))
    return out


_WATCH_TOUCHED = {
    NODE_REGISTER: lambda p: [("nodes", p.id)],
    NODE_DEREGISTER: lambda p: [("nodes", p)],
    NODE_STATUS_UPDATE: lambda p: [("nodes", p[0])],
    NODE_DRAIN_UPDATE: lambda p: [("nodes", p[0])],
    NODE_ELIGIBILITY_UPDATE: lambda p: [("nodes", p[0])],
    BATCH_NODE_UPDATE_DRAIN: lambda p: [("nodes", nid) for nid in p],
    JOB_REGISTER: lambda p: [("jobs", (p.namespace, p.id))],
    JOB_DEREGISTER: lambda p: [("jobs", (p[0], p[1]))],
    EVAL_UPDATE: lambda p: [("evals", ev.id) for ev in p],
    EVAL_DELETE: lambda p: (
        [("evals", eid) for eid in p[0]] + [("allocs", aid) for aid in p[1]]
    ),
    ALLOC_UPDATE: lambda p: [("allocs", a.id) for a in p],
    ALLOC_CLIENT_UPDATE: lambda p: [("allocs", a.id) for a in p],
    ALLOC_UPDATE_DESIRED_TRANSITION: lambda p: (
        [("allocs", aid) for aid in p[0]] + [("evals", ev.id) for ev in p[1] or ()]
    ),
    APPLY_PLAN_RESULTS: _touched_plan_results,
    APPLY_PLAN_RESULTS_BATCH: lambda p: [
        t for payload in p for t in _touched_plan_results(payload)
    ],
    DEPLOYMENT_STATUS_UPDATE: lambda p: (
        [("deployments", p[0].deployment_id)]
        + ([("jobs", (p[1].namespace, p[1].id))] if p[1] is not None else [])
        + ([("evals", p[2].id)] if p[2] is not None else [])
    ),
    DEPLOYMENT_PROMOTE: lambda p: (
        [("deployments", p[0]), ("allocs", None)]
        + ([("evals", p[3].id)] if p[3] is not None else [])
    ),
    DEPLOYMENT_ALLOC_HEALTH: lambda p: (
        [("deployments", p[0]), ("allocs", None)]
        + ([("evals", p[5].id)] if p[5] is not None else [])
    ),
    DEPLOYMENT_DELETE: lambda p: [("deployments", did) for did in p],
    JOB_STABILITY: lambda p: [("jobs", (p[0], p[1]))],
    PERIODIC_LAUNCH: lambda p: [("jobs", (p[0], p[1]))],
    # config/ACL/vault entries touch no watched read table
    SCHEDULER_CONFIG: lambda p: (),
    AUTOPILOT_CONFIG: lambda p: (),
    ACL_POLICY_UPSERT: lambda p: (),
    ACL_POLICY_DELETE: lambda p: (),
    ACL_TOKEN_UPSERT: lambda p: (),
    ACL_TOKEN_DELETE: lambda p: (),
    ACL_TOKEN_BOOTSTRAP: lambda p: (),
    VAULT_ACCESSOR_UPSERT: lambda p: (),
    VAULT_ACCESSOR_DELETE: lambda p: (),
}


def _watch_touched(entry_type: str, payload):
    fn = _WATCH_TOUCHED.get(entry_type)
    if fn is None:
        return _WATCH_ALL
    try:
        return fn(payload)
    except Exception:  # noqa: BLE001 — never let a notify map break apply
        return _WATCH_ALL
