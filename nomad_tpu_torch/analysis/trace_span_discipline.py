"""trace-span-discipline: span regions must be exception-safe.

The trace layer's invariants (worker ``current`` always restored, phase
spans always closed, lifecycle stamps never leaked open) all hang on one
structural property: a span factory's return value is a context manager
whose ``__exit__`` runs on EVERY exit path. That holds exactly when the
call site is

  - the context expression of a ``with`` statement
    (``with phases.track("rank"): ...``,
    ``with self._span("invoke_scheduler", eid): ...``), or
  - the sole argument of an ``ExitStack.enter_context(...)`` call
    (the stack's own ``with`` provides the try/finally).

Anything else — a bare statement call that discards the manager, storing
the manager in a variable for a manual ``__enter__()``/``__exit__()``
dance, passing it somewhere that may never enter it — leaves a path
where an exception (or an early ``return``) skips ``__exit__``: the
phase stays "open" forever, the watchdog reports a worker parked in a
span it left minutes ago, and ``coverage()`` double-counts.

Span factories are recognized syntactically: a call whose resolved
dotted name ends in ``phases.track`` (any alias — ``_phases.track``,
``nomad_tpu_torch.utils.phases.track``), or an attribute call named ``_span``
(the Worker span helper's naming convention).

Copied from ``nomad_tpu/analysis/trace_span_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, ParsedModule, import_aliases, resolve_call_name

RULE = "trace-span-discipline"


def _is_span_factory(call: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """The display name of the span factory being called, or None."""
    if isinstance(call.func, ast.Attribute) and call.func.attr == "_span":
        return "._span"
    name = resolve_call_name(call.func, aliases)
    if name is None:
        return None
    parts = name.split(".")
    # relative imports (`from ..utils import phases as _phases`) are not
    # in the alias map, so match on the trailing segments: `<...>.track`
    # where the module segment is phases-like
    if len(parts) >= 2 and parts[-1] == "track" \
            and parts[-2].lstrip("_") == "phases":
        return name
    return None


class TraceSpanDisciplineChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        aliases = import_aliases(module.tree)

        # pass 1: collect the call nodes sitting in a legal position
        ok = set()
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ok.add(id(item.context_expr))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "enter_context" \
                    and len(node.args) == 1 and not node.keywords:
                ok.add(id(node.args[0]))

        # pass 2: every span-factory call outside those positions leaks
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or id(node) in ok:
                continue
            name = _is_span_factory(node, aliases)
            if name is None:
                continue
            findings.append(Finding(
                RULE, module.rel, node.lineno,
                f"span factory '{name}' called outside a 'with' item or "
                f"enter_context(...): an exit path can skip __exit__ — "
                f"wrap it as 'with {name}(...):'",
            ))
        return findings
