"""Critical-path attribution: turn spans into a ranked bottleneck ledger.

The lifecycle layer records WHAT happened (per-eval stamps, per-wave
pipeline stage spans, aux spans for ``wait_min_index`` and ``raft_fsm``)
but not WHY a run was slow. This module joins those spans into an
exclusive wall-clock decomposition of the makespan and emits
``bottleneck_report()``: "wait_min_index: 41% of makespan; broker
dequeue idle: 22%; ...".

The decomposition is a greedy exclusive claim in a fixed precedence
order (work stages before waits, waits before idle): each instant of
the makespan is attributed to the HIGHEST-precedence component active
at that instant. That answers "what was the system doing" the way a
profiler's self-time does — an eval sitting in the broker queue while
the device is mid-dispatch is pipelining, not a bottleneck; the same
queue time with nothing else running is. Components claim only once, so
the entries sum to at most the makespan and

    coverage = attributed_time / makespan

is a self-check on the span set itself: coverage < 0.9 means the
instrumentation lost track of what the system was doing and the report
says so instead of ranking garbage.

Idle comes in two explicitly distinguished flavors. ``idle`` is
INSTRUMENTED: scheduler workers record their coalesced empty-dequeue
periods (lifecycle.IDLE_STAGE), so dead time between waves is claimed
with direct evidence and counts toward coverage. ``broker_idle`` is the
SYNTHESIZED complement of the wave windows — no eval in flight at all —
and ranks below ``idle``. Time inside the makespan that neither work
spans, instrumented idle, nor the complement explains stays
unattributed and drags coverage below the floor: an instrumentation
hole must still fail the self-check, never get laundered as idle.

All interval math is on the lifecycle clock (``time.monotonic``).

Copied from ``nomad_tpu/trace/attribution.py`` into the PyTorch port, which imports nothing
of ``nomad_tpu``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import lifecycle

#: claim order: real work first, then ordered waits, then idle. Renaming
#: or reordering changes report semantics — tests pin this.
PRECEDENCE: Tuple[str, ...] = (
    "encode",          # pipeline stage: dense-plan encode
    "dispatch",        # pipeline stage: device dispatch
    "evaluate",        # pipeline stage: scheduler evaluate
    "commit",          # pipeline stage: applier commit
    "raft_fsm",        # aux span: raft apply + FSM
    "invoke",          # scheduler think-time not covered by stage spans
    "wait_min_index",  # aux span: worker blocked on SnapshotMinIndex
    "commit_wait",     # plan submitted, waiting for the applier
    "finalize",        # applied, waiting for ack bookkeeping
    "invoke_wait",     # dequeued, waiting for a scheduler slot
    "queue_wait",      # enqueued, waiting for a broker dequeue
    "idle",            # INSTRUMENTED worker idle: >=1 scheduler worker
                       # recorded a coalesced empty-dequeue period and no
                       # higher component was active (lifecycle.IDLE_STAGE)
    "broker_idle",     # synthesized complement: no eval in flight at all
)

COVERAGE_FLOOR = 0.9

Interval = Tuple[float, float]


# -- interval algebra -------------------------------------------------------


def _merged(spans: Iterable[Interval],
            lo: Optional[float] = None,
            hi: Optional[float] = None) -> List[Interval]:
    """Sorted, coalesced, optionally clipped intervals."""
    out: List[Interval] = []
    for a, b in sorted(spans):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(merged: Sequence[Interval]) -> float:
    return sum(b - a for a, b in merged)


def _subtract(merged: Sequence[Interval],
              claimed: Sequence[Interval]) -> List[Interval]:
    """``merged`` minus ``claimed`` (both sorted+coalesced)."""
    out: List[Interval] = []
    j = 0
    for a, b in merged:
        cur = a
        while j < len(claimed) and claimed[j][1] <= cur:
            j += 1
        k = j
        while k < len(claimed) and claimed[k][0] < b:
            ca, cb = claimed[k]
            if ca > cur:
                out.append((cur, ca))
            cur = max(cur, cb)
            if cur >= b:
                break
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def _complement(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return _subtract([(lo, hi)], _merged(merged))


# -- component extraction ---------------------------------------------------


def _record_component_spans(records: Sequence[Dict[str, object]],
                            now: float) -> Dict[str, List[Interval]]:
    """Per-component raw intervals from lifecycle records. Open-ended
    segments (eval still in flight) extend to ``now``."""
    comps: Dict[str, List[Interval]] = {
        "queue_wait": [], "invoke_wait": [], "invoke": [],
        "commit_wait": [], "finalize": [],
    }
    for r in records:
        enq = r.get("enqueue_t")
        if enq is None:
            continue
        end = r.get("end_t") or now
        deq = r.get("dequeue_t")
        inv0 = r.get("invoke_start_t")
        inv1 = r.get("invoke_end_t")
        sub = r.get("submit_t")
        app = r.get("apply_t")
        comps["queue_wait"].append((enq, deq if deq is not None else end))
        if deq is not None:
            comps["invoke_wait"].append(
                (deq, inv0 if inv0 is not None else end))
        if inv0 is not None:
            comps["invoke"].append((inv0, inv1 if inv1 is not None else end))
        if sub is not None:
            comps["commit_wait"].append((sub, app if app is not None else end))
        if app is not None:
            comps["finalize"].append((app, end))
    return comps


def _wave_windows(records: Sequence[Dict[str, object]],
                  now: float) -> List[Interval]:
    return _merged(
        (r["enqueue_t"], r.get("end_t") or now)
        for r in records if r.get("enqueue_t") is not None
    )


# -- the decomposition ------------------------------------------------------


def _greedy_claim(comp_spans: Dict[str, List[Interval]],
                  precedence: Sequence[str],
                  t0: float, t1: float) -> Tuple[Dict[str, float], float]:
    """The exclusive claim loop shared by the single-process and the
    stitched decomposition: walk components in precedence order, each
    claims only the instants no higher-precedence component already
    holds. Returns (component -> seconds, total attributed seconds)."""
    order = list(precedence) + sorted(set(comp_spans) - set(precedence))
    claimed: List[Interval] = []
    components: Dict[str, float] = {}
    for name in order:
        raw = comp_spans.get(name)
        if not raw:
            continue
        merged = _merged(raw, t0, t1)
        exclusive = _subtract(merged, claimed)
        seconds = _length(exclusive)
        if seconds > 0:
            components[name] = seconds
        claimed = _merged(claimed + exclusive)
    return components, _length(claimed)


def critical_path(records: Optional[Sequence[Dict[str, object]]] = None,
                  spans: Optional[Sequence[Tuple[str, str, float, float]]] = None,
                  now: Optional[float] = None) -> Dict[str, object]:
    """Exclusive per-component wall-clock decomposition of the makespan.

    ``records``/``spans`` default to the live lifecycle tables; tests
    pass synthetic sets. Returns makespan bounds, per-component claimed
    seconds (precedence order) and the coverage self-check.
    """
    if records is None:
        records = lifecycle.raw_records()
    if spans is None:
        spans = lifecycle.pipeline_spans()
    if now is None:
        now = lifecycle.pipeline_now()

    bounds: List[float] = []
    for r in records:
        if r.get("enqueue_t") is not None:
            bounds.append(r["enqueue_t"])
            bounds.append(r.get("end_t") or now)
    for (_s, _w, a, b) in spans:
        bounds.append(a)
        bounds.append(b)
    if not bounds:
        return {"makespan_s": 0.0, "t0": None, "t1": None, "waves": 0, "components": {},
                "occ_retries": 0, "coverage": 0.0, "unattributed_s": 0.0}
    t0, t1 = min(bounds), max(bounds)
    makespan = t1 - t0
    if makespan <= 0:
        return {"makespan_s": 0.0, "t0": t0, "t1": t1, "waves": 0, "components": {},
                "occ_retries": 0, "coverage": 0.0, "unattributed_s": 0.0}

    comp_spans = _record_component_spans(records, now)
    occ_retries = sum(1 for r in records if r.get("outcome") == "nack")
    for stage, _wave, a, b in spans:
        comp_spans.setdefault(stage, []).append((a, b))
    comp_spans["broker_idle"] = _complement(_wave_windows(records, now), t0, t1)

    components, attributed = _greedy_claim(comp_spans, PRECEDENCE, t0, t1)
    return {
        "makespan_s": round(makespan, 6),
        "t0": t0,
        "t1": t1,
        "waves": len(_wave_windows(records, now)),
        "components": {k: round(v, 6) for k, v in components.items()},
        "occ_retries": occ_retries,
        "coverage": round(attributed / makespan, 4),
        "unattributed_s": round(makespan - attributed, 6),
    }


def bottleneck_report(records: Optional[Sequence[Dict[str, object]]] = None,
                      spans: Optional[Sequence[Tuple[str, str, float, float]]] = None,
                      now: Optional[float] = None,
                      top_n: int = 0) -> Dict[str, object]:
    """The ranked wall-clock ledger. ``entries`` are sorted by claimed
    seconds (ties broken by name — deterministic for equal span sets);
    ``top`` is the one-line headline ("wait_min_index: 41% of makespan").
    ``coverage_ok`` is the >=0.9 self-check: when it fails the top line
    says the instrumentation lost coverage instead of naming a stage.
    """
    cp = critical_path(records, spans, now)
    makespan = cp["makespan_s"]
    entries = [
        {
            "component": name,
            "seconds": seconds,
            "share": round(seconds / makespan, 4) if makespan else 0.0,
        }
        for name, seconds in cp["components"].items()
    ]
    entries.sort(key=lambda e: (-e["seconds"], e["component"]))
    if top_n > 0:
        entries = entries[:top_n]
    coverage_ok = cp["coverage"] >= COVERAGE_FLOOR
    if not entries:
        top = "no spans recorded"
    elif not coverage_ok:
        top = (f"coverage {cp['coverage']:.0%} below "
               f"{COVERAGE_FLOOR:.0%} floor: span set incomplete")
    else:
        lead = entries[0]
        top = f"{lead['component']}: {lead['share']:.0%} of makespan"
    return {
        "makespan_s": makespan,
        "waves": cp["waves"],
        "occ_retries": cp["occ_retries"],
        "coverage": cp["coverage"],
        "coverage_ok": coverage_ok,
        "unattributed_s": cp["unattributed_s"],
        "entries": entries,
        "top": top,
    }


def format_report(report: Dict[str, object], top_n: int = 5) -> str:
    """Human one-liner for logs/records: ``wait_min_index: 41%; broker
    dequeue idle: 22%; ... (coverage 96%)``."""
    parts = [
        f"{e['component']}: {e['share']:.0%}"
        for e in report.get("entries", [])[:top_n]
    ]
    if not parts:
        return report.get("top", "no spans recorded")
    return "; ".join(parts) + f" (coverage {report.get('coverage', 0):.0%})"


# -- stitched (cross-process) decomposition ---------------------------------
#
# Same greedy exclusive claim, but over the wall-clock spans a stitched
# multi-process collection produced (trace/stitch.py output, already
# clock-aligned). This is where wire time finally gets a name: an RPC's
# client span minus its matched server child is time on the wire or in
# the accept queue (``rpc_wait``); a client span whose PARENT is a
# server span is a layer-7 forwarding hop (``forward_hop``); a
# wait_min_index span recorded by a follower-driven worker is
# replication lag (``follower_lag``).

#: stitched claim order: eval work, then the wire, then handler time and
#: queue waits, then idle between traces.
STITCHED_PRECEDENCE: Tuple[str, ...] = (
    "invoke",          # worker-side scheduler think-time
    "forward_hop",     # client span under a server span: follower -> leader hop
    "rpc_wait",        # client span minus its matched server child: wire + accept
    "follower_lag",    # wait_min_index on a follower-driven worker
    "wait_min_index",  # wait_min_index on the leader's own worker
    "commit_wait",     # plan submitted, waiting for the applier
    "finalize",        # applied, waiting for ack bookkeeping
    "rpc_handler",     # server-side handler time not otherwise claimed
    "queue_wait",      # enqueued, waiting for a broker dequeue
    "driver",          # driver-side root spans (event.*)
    "trace_idle",      # no trace in flight at all
)

#: lifecycle/worker span name -> stitched component. ``eval.wait_min_index``
#: is resolved by role attr (follower_lag vs wait_min_index) below.
_STITCHED_SPAN_COMPONENTS: Dict[str, str] = {
    "eval.queue_wait": "queue_wait",
    "eval.invoke": "invoke",
    "eval.commit_wait": "commit_wait",
    "eval.finalize": "finalize",
}


def _stitched_component_spans(
    spans: Sequence[Dict[str, object]],
) -> Dict[str, List[Interval]]:
    """Raw per-component intervals from a clock-aligned span set."""
    comps: Dict[str, List[Interval]] = defaultdict(list)
    by_id: Dict[object, Dict[str, object]] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid is not None:
            by_id[sid] = s
    # server spans matched to their client parent: subtracted from the
    # client interval so rpc_wait is the wire/accept remainder only
    server_child: Dict[object, List[Interval]] = defaultdict(list)
    for s in spans:
        if s.get("kind") == "server":
            parent = by_id.get(s.get("parent_id"))
            if parent is not None and parent.get("kind") == "client":
                server_child[s.get("parent_id")].append((s["start"], s["end"]))
    for s in spans:
        iv: Interval = (s["start"], s["end"])
        name = str(s.get("name", ""))
        kind = s.get("kind")
        if name == "eval.wait_min_index":
            role = (s.get("attrs") or {}).get("role")
            comps["follower_lag" if role == "follower" else
                  "wait_min_index"].append(iv)
        elif name in _STITCHED_SPAN_COMPONENTS:
            comps[_STITCHED_SPAN_COMPONENTS[name]].append(iv)
        elif kind == "client":
            parent = by_id.get(s.get("parent_id"))
            if parent is not None and parent.get("kind") == "server":
                # this process is relaying someone else's request:
                # the whole hop is forwarding overhead
                comps["forward_hop"].append(iv)
            else:
                kids = _merged(server_child.get(s.get("span_id"), ()))
                if kids:
                    comps["rpc_wait"].extend(_subtract([iv], kids))
                else:
                    # server never exported (killed replica / evicted
                    # ring): the whole call reads as wire time
                    comps["rpc_wait"].append(iv)
        elif kind == "server":
            comps["rpc_handler"].append(iv)
        else:
            comps["driver"].append(iv)
    return dict(comps)


def stitched_critical_path(
    spans: Sequence[Dict[str, object]],
) -> Dict[str, object]:
    """Exclusive decomposition of a stitched span set's makespan.
    ``spans`` is the flat clock-aligned list ``stitch.stitch()`` returns
    under ``"spans"``. Same shape as :func:`critical_path` plus the
    process roster."""
    valid = [
        s for s in spans
        if isinstance(s.get("start"), (int, float))
        and isinstance(s.get("end"), (int, float))
        and s["end"] >= s["start"]
    ]
    if not valid:
        return {"makespan_s": 0.0, "t0": None, "t1": None, "traces": 0,
                "processes": [], "components": {}, "coverage": 0.0,
                "unattributed_s": 0.0}
    t0 = min(s["start"] for s in valid)
    t1 = max(s["end"] for s in valid)
    makespan = t1 - t0
    traces = {str(s.get("trace_id")) for s in valid}
    processes = sorted({str(s.get("process")) for s in valid})
    if makespan <= 0:
        return {"makespan_s": 0.0, "t0": t0, "t1": t1, "traces": len(traces),
                "processes": processes, "components": {}, "coverage": 0.0,
                "unattributed_s": 0.0}
    comp_spans = _stitched_component_spans(valid)
    # idle = no trace window active at all (precedent: broker_idle)
    windows = _merged(
        (min(s["start"] for s in group), max(s["end"] for s in group))
        for group in _by_trace(valid).values()
    )
    comp_spans["trace_idle"] = _complement(windows, t0, t1)
    components, attributed = _greedy_claim(
        comp_spans, STITCHED_PRECEDENCE, t0, t1)
    return {
        "makespan_s": round(makespan, 6),
        "t0": t0,
        "t1": t1,
        "traces": len(traces),
        "processes": processes,
        "components": {k: round(v, 6) for k, v in components.items()},
        "coverage": round(attributed / makespan, 4),
        "unattributed_s": round(makespan - attributed, 6),
    }


def _by_trace(
    spans: Sequence[Dict[str, object]],
) -> Dict[str, List[Dict[str, object]]]:
    groups: Dict[str, List[Dict[str, object]]] = defaultdict(list)
    for s in spans:
        groups[str(s.get("trace_id"))].append(s)
    return groups


def stitched_report(spans: Sequence[Dict[str, object]],
                    top_n: int = 0) -> Dict[str, object]:
    """Ranked cross-process ledger; the multi-process sibling of
    :func:`bottleneck_report` with the same >=0.9 coverage self-check."""
    cp = stitched_critical_path(spans)
    makespan = cp["makespan_s"]
    entries = [
        {
            "component": name,
            "seconds": seconds,
            "share": round(seconds / makespan, 4) if makespan else 0.0,
        }
        for name, seconds in cp["components"].items()
    ]
    entries.sort(key=lambda e: (-e["seconds"], e["component"]))
    if top_n > 0:
        entries = entries[:top_n]
    coverage_ok = cp["coverage"] >= COVERAGE_FLOOR
    if not entries:
        top = "no spans recorded"
    elif not coverage_ok:
        top = (f"coverage {cp['coverage']:.0%} below "
               f"{COVERAGE_FLOOR:.0%} floor: span set incomplete")
    else:
        lead = entries[0]
        top = f"{lead['component']}: {lead['share']:.0%} of makespan"
    return {
        "makespan_s": makespan,
        "traces": cp["traces"],
        "processes": cp["processes"],
        "coverage": cp["coverage"],
        "coverage_ok": coverage_ok,
        "unattributed_s": cp["unattributed_s"],
        "entries": entries,
        "top": top,
    }
