"""pipeline-stage-discipline: the async pipeline's stage boundaries.

The eval-lifecycle pipeline (``nomad_tpu_torch/pipeline/``) only stays correct
— and only stays BOUNDED — if its stages respect two structural rules:

1. **Commits go through the plan queue, never around it.** Pipeline code
   must not apply raft entries (``server.raft_apply(...)``,
   ``raft.apply(...)``) or write the state store directly
   (``state.upsert_*`` / ``state.delete_*``): the Planner's batched
   waiter is the single serialization point, and a side-door write from
   the dispatch-stage thread would bypass both the per-payload failure
   isolation and the OCC evaluation that makes overlapping waves safe.

2. **Stage handoff only via bounded queues.** An unbounded
   ``queue.Queue()`` between stages turns a stalled consumer into
   unbounded memory growth (the exact convoy-to-OOM failure the
   pipeline exists to avoid). Construct ``BoundedStageQueue`` (or pass
   an explicit positive ``maxsize``) so backpressure propagates to the
   producer instead.

Scope is syntactic: modules whose path sits under ``nomad_tpu_torch/pipeline/``.
Violations are recognized by call shape — a call whose resolved dotted
name ends in ``raft_apply``, a ``<...>.raft.apply(...)`` chain, an
attribute call named ``upsert_<x>``/``delete_<x>``, or a
``queue.Queue``/``SimpleQueue`` construction without a positive
``maxsize``.

Copied from ``nomad_tpu/analysis/pipeline_stage_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, ParsedModule, import_aliases, resolve_call_name

RULE = "pipeline-stage-discipline"

# attribute-call prefixes that constitute a direct state-store write
_STORE_WRITE_PREFIXES = ("upsert_", "delete_")


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return "nomad_tpu_torch/pipeline/" in rel or rel.startswith("pipeline/")


def _unbounded_queue(call: ast.Call, name: Optional[str]) -> Optional[str]:
    """Reason string if this call constructs an unbounded stdlib queue."""
    if name in ("queue.SimpleQueue", "multiprocessing.SimpleQueue"):
        return f"'{name}' has no capacity bound"
    if name not in ("queue.Queue", "queue.LifoQueue", "queue.PriorityQueue"):
        return None
    maxsize: Optional[ast.expr] = None
    if call.args:
        maxsize = call.args[0]
    for kw in call.keywords:
        if kw.arg == "maxsize":
            maxsize = kw.value
    if maxsize is None:
        return f"'{name}' constructed without maxsize"
    if isinstance(maxsize, ast.Constant) and isinstance(maxsize.value, int) \
            and maxsize.value <= 0:
        return f"'{name}' constructed with maxsize<=0 (unbounded)"
    return None  # explicit non-constant/positive maxsize: caller's bound


class PipelineStageDisciplineChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        if not _in_scope(module.rel):
            return []
        aliases = import_aliases(module.tree)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(node.func, aliases)
            parts = name.split(".") if name else []

            # raft applies: server.raft_apply(...) / self.raft.apply(...)
            if parts and (parts[-1] == "raft_apply"
                          or (len(parts) >= 2 and parts[-1] == "apply"
                              and parts[-2] == "raft")):
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"raft apply '{name}' from pipeline code: commits must "
                    f"go through plan_queue.enqueue so the Planner's "
                    f"batched waiter stays the single serialization point",
                ))
                continue

            # direct state-store writes: <x>.upsert_*/<x>.delete_*
            if isinstance(node.func, ast.Attribute) and any(
                node.func.attr.startswith(p) for p in _STORE_WRITE_PREFIXES
            ):
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"state-store write '{node.func.attr}' from pipeline "
                    f"code: only the FSM mutates the store — hand results "
                    f"to the plan queue instead",
                ))
                continue

            # unbounded stage handoff queues
            reason = _unbounded_queue(node, name)
            if reason is not None:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"unbounded stage queue: {reason} — stage handoff must "
                    f"use BoundedStageQueue (or an explicit positive "
                    f"maxsize) so backpressure reaches the producer",
                ))
        return findings
