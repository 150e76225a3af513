"""Stitch N processes' span rings into per-trace span trees.

The collector side of cross-process tracing (trace/context.py): each
replica's ``Trace.Export`` RPC drains a bounded span ring; this module
merges those sets, aligns their clocks and rebuilds the tree one
logical request traced through the cluster —

    event.job_register                      (driver)
    └─ rpc.client.Job.Register              (driver)
       └─ rpc.server.Job.Register           (follower, forwarded=True)
          └─ rpc.client.Job.Register        (follower → leader hop)
             └─ rpc.server.Job.Register     (leader)
    eval.queue_wait / eval.invoke / ...     (leader + worker processes)

Clock alignment: span times are wall clock, and three OS processes'
wall clocks disagree by an unknown (possibly drifting) offset. Every
client/server span pair crossing a process boundary is an NTP-style
measurement: the server span must nest inside the client span in true
time, so

    offset(server rel client) = ((s.start - c.start) + (s.end - c.end)) / 2

cancels the symmetric part of the network delay. Per process pair we
take the median estimate over all pairs, then chain offsets through a
BFS from a reference process, so a process that only ever talks to the
leader still lands on the driver's axis.

Degradation is mandatory, never an exception: a SIGKILLed replica
exports nothing, so spans whose parent never arrived become ORPHAN
roots of a partial tree, and an unreachable process keeps offset 0.

Copied from ``nomad_tpu/trace/stitch.py`` into the PyTorch port, which imports nothing
of ``nomad_tpu``.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def merge_spans(
    span_sets: Iterable[Sequence[Dict[str, object]]],
) -> List[Dict[str, object]]:
    """Concatenate per-process span sets, dropping duplicates (a
    collector may drain overlapping windows) and sorting by
    ``(start, span_id)`` so equal inputs merge identically regardless
    of arrival order."""
    seen: set = set()
    out: List[Dict[str, object]] = []
    for spans in span_sets:
        for s in spans or ():
            key = (s.get("process"), s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    out.sort(key=lambda s: (s.get("start", 0.0), str(s.get("span_id"))))
    return out


def _span_pairs(
    spans: Sequence[Dict[str, object]],
) -> List[Tuple[Dict[str, object], Dict[str, object]]]:
    """(client, server) pairs crossing a process boundary: the server
    span's parent is the client span, recorded by a different process."""
    by_id = {s.get("span_id"): s for s in spans}
    pairs = []
    for s in spans:
        if s.get("kind") != "server":
            continue
        c = by_id.get(s.get("parent_id"))
        if c is None or c.get("kind") != "client":
            continue
        if c.get("process") == s.get("process"):
            continue
        pairs.append((c, s))
    return pairs


def _median(vals: List[float]) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


def estimate_offsets(
    spans: Sequence[Dict[str, object]],
    reference: Optional[str] = None,
) -> Dict[str, float]:
    """Per-process clock offset RELATIVE to ``reference`` (default: the
    process recording the most spans; deterministic tie-break by name).
    ``normalized_time = span_time - offset[process]``."""
    processes = sorted({str(s.get("process")) for s in spans})
    if not processes:
        return {}
    if reference is None:
        counts: Dict[str, int] = defaultdict(int)
        for s in spans:
            counts[str(s.get("process"))] += 1
        reference = max(processes, key=lambda p: (counts[p], p))
    # edge (P, Q) -> offset estimates of Q's clock relative to P's
    edges: Dict[Tuple[str, str], List[float]] = defaultdict(list)
    for c, s in _span_pairs(spans):
        cp, sp = str(c.get("process")), str(s.get("process"))
        est = ((s["start"] - c["start"]) + (s["end"] - c["end"])) / 2.0
        edges[(cp, sp)].append(est)
        edges[(sp, cp)].append(-est)
    offsets: Dict[str, float] = {reference: 0.0}
    queue = deque([reference])
    while queue:
        p = queue.popleft()
        for (a, b), ests in edges.items():
            if a != p or b in offsets:
                continue
            offsets[b] = offsets[p] + _median(ests)
            queue.append(b)
    # unreachable processes (no RPC pair touches them): trust their
    # wall clock rather than dropping their spans
    for p in processes:
        offsets.setdefault(p, 0.0)
    return offsets


def normalize(
    spans: Sequence[Dict[str, object]],
    offsets: Dict[str, float],
) -> List[Dict[str, object]]:
    """Shifted copies of ``spans`` on the reference clock axis."""
    out = []
    for s in spans:
        off = offsets.get(str(s.get("process")), 0.0)
        if off:
            s = dict(s)
            s["start"] = s["start"] - off
            s["end"] = s["end"] - off
        out.append(s)
    return out


def build_trees(spans: Sequence[Dict[str, object]]) -> List[Dict[str, object]]:
    """Per-trace span trees, oldest trace first. Spans whose parent was
    never collected (its process died, or its ring evicted the span)
    surface as ``orphan`` roots — a PARTIAL tree, never an exception."""
    by_trace: Dict[str, List[Dict[str, object]]] = defaultdict(list)
    for s in spans:
        by_trace[str(s.get("trace_id"))].append(s)
    traces: List[Dict[str, object]] = []
    for trace_id, members in by_trace.items():
        nodes = {
            s["span_id"]: {"span": s, "children": []} for s in members
        }
        roots: List[Dict[str, object]] = []
        for s in members:
            node = nodes[s["span_id"]]
            parent = s.get("parent_id")
            if parent is None:
                roots.append(node)
            elif parent in nodes and parent != s["span_id"]:
                nodes[parent]["children"].append(node)
            else:
                node["orphan"] = True
                roots.append(node)
        # a parent-pointer cycle (corrupt input) leaves nodes unreachable
        # from any root; surface them as orphans instead of losing them
        reachable: set = set()
        stack = [n["span"]["span_id"] for n in roots]
        while stack:
            sid = stack.pop()
            if sid in reachable:
                continue
            reachable.add(sid)
            stack.extend(
                c["span"]["span_id"] for c in nodes[sid]["children"]
            )
        for sid, node in nodes.items():
            if sid not in reachable:
                node["orphan"] = True
                node["children"] = []
                roots.append(node)

        def sort_key(node):
            return (node["span"].get("start", 0.0),
                    str(node["span"].get("span_id")))

        def sort_rec(node) -> None:
            node["children"].sort(key=sort_key)
            for c in node["children"]:
                sort_rec(c)

        roots.sort(key=sort_key)
        for r in roots:
            sort_rec(r)
        start = min(s["start"] for s in members)
        end = max(s["end"] for s in members)
        traces.append({
            "trace_id": trace_id,
            "start": start,
            "end": end,
            "duration_ms": round((end - start) * 1000.0, 3),
            "processes": sorted({str(s.get("process")) for s in members}),
            "spans": len(members),
            "orphans": sum(1 for r in roots if r.get("orphan")),
            "roots": roots,
        })
    traces.sort(key=lambda t: (t["start"], t["trace_id"]))
    return traces


def stitch(
    span_sets: Iterable[Sequence[Dict[str, object]]],
    recent: Optional[int] = None,
    reference: Optional[str] = None,
) -> Dict[str, object]:
    """The full collector pass: merge → clock-align → trees. This is
    the ``/v1/trace/distributed`` payload and the chaos harnesses'
    stitched-trace sample."""
    spans = merge_spans(span_sets)
    offsets = estimate_offsets(spans, reference)
    norm = normalize(spans, offsets)
    traces = build_trees(norm)
    if recent is not None and recent >= 0:
        traces = traces[-recent:] if recent else []
    return {
        "processes": sorted(offsets),
        "clock_offsets_ms": {
            p: round(off * 1000.0, 3) for p, off in sorted(offsets.items())
        },
        "span_count": len(spans),
        "trace_count": len(set(str(s.get("trace_id")) for s in spans)),
        "traces": traces,
        "spans": norm,
    }


def format_tree(trace: Dict[str, object]) -> str:
    """ASCII rendering of one stitched trace (docs / debugging)."""
    lines = [
        f"trace {trace['trace_id']} "
        f"({trace['duration_ms']}ms, "
        f"processes: {', '.join(trace['processes'])})"
    ]
    t0 = trace["start"]

    def walk(node, depth: int) -> None:
        s = node["span"]
        tag = " ORPHAN" if node.get("orphan") else ""
        lines.append(
            "  " * depth
            + f"└─ {s['name']} [{s.get('process')}] "
            + f"+{(s['start'] - t0) * 1000.0:.1f}ms "
            + f"{(s['end'] - s['start']) * 1000.0:.2f}ms{tag}"
        )
        for c in node["children"]:
            walk(c, depth + 1)

    for r in trace["roots"]:
        walk(r, 1)
    return "\n".join(lines)
