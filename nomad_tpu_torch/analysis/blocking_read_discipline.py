"""blocking-read-discipline: the read surface stays blocking-query clean.

Two invariants keep the nomad-watch serving layer trustworthy:

1. **Read endpoints route through the blocking wrapper.** Every
   ``rpc.register("Noun.Verb", fn)`` in the endpoint registry whose verb
   is read-shaped (``List*``/``Get*``/``Summary``/``Allocations``/
   ``Evaluations``) must reach ``serve_read``/``blocking_read`` somewhere
   in its handler — that is the one funnel that stamps QueryMeta under
   the store's lock and honors ``min_query_index``/``allow_stale``. A
   read endpoint outside the funnel silently returns index-less
   responses that break client ``min_query_index`` chaining. Deliberate
   exceptions carry a ``# blocking-read-waiver: <reason>`` comment on or
   just above the registration.

2. **Watch-hub callbacks are read-only observers.** Functions handed to
   ``hub.add_callback`` run on the flusher thread, downstream of the FSM
   apply path: a callback that writes state (``upsert_*``/``delete_*``/
   ``update_*``/``raft_apply``/``apply``) or takes a store lock
   (``with x._lock``/``.acquire()``) can deadlock apply against the
   flusher or re-enter raft from the notification path.

Scope: invariant 1 applies to endpoint registry modules (basename
``endpoints.py``); invariant 2 applies everywhere outside this analysis
package.

Copied from ``nomad_tpu/analysis/blocking_read_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, ParsedModule

RULE = "blocking-read-discipline"

_BLOCKING_FUNNELS = {"serve_read", "blocking_read"}
_READ_VERBS = {"Summary", "Allocations", "Evaluations"}
_WAIVER_MARK = "blocking-read-waiver"
# how far above a registration the waiver comment block may start
_WAIVER_LOOKBACK = 4

_MUTATOR_PREFIXES = ("upsert_", "delete_", "update_", "set_")
_MUTATOR_EXACT = {"raft_apply", "apply", "enqueue", "enqueue_all"}


def _is_endpoints_module(rel: str) -> bool:
    return rel.replace("\\", "/").rsplit("/", 1)[-1] == "endpoints.py"


def _read_verb(method: str) -> bool:
    verb = method.rsplit(".", 1)[-1]
    return (
        verb.startswith("List")
        or verb.startswith("Get")
        or verb in _READ_VERBS
    )


def _has_waiver(lines: List[str], lineno: int) -> bool:
    lo = max(1, lineno - _WAIVER_LOOKBACK)
    for i in range(lo, min(lineno + 1, len(lines) + 1)):
        if _WAIVER_MARK in lines[i - 1]:
            return True
    return False


def _local_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """Every def in the module, nested ones included (endpoint handlers
    are typically closures inside ``bind_server``)."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _calls_funnel(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in _BLOCKING_FUNNELS:
            return True
        if isinstance(f, ast.Attribute) and f.attr in _BLOCKING_FUNNELS:
            return True
    return False


def _receiver_tail(node: ast.AST) -> str:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts)).lower()


def _callback_violation(fn: ast.AST) -> Optional[str]:
    """First state-write / lock-acquire inside a callback body, or None."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr.startswith(_MUTATOR_PREFIXES) or attr in _MUTATOR_EXACT:
                return f"calls state mutator '.{attr}()'"
            if attr == "acquire":
                return "acquires a lock ('.acquire()')"
        elif isinstance(node, ast.With):
            for item in node.items:
                name = _receiver_tail(item.context_expr)
                tail = name.rsplit(".", 1)[-1]
                if tail.endswith(("_lock", "_cond")):
                    return f"takes lock 'with {name}'"
    return None


class BlockingReadDisciplineChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        rel = module.rel.replace("\\", "/")
        if "nomad_tpu_torch/analysis/" in rel or rel.startswith("analysis/"):
            return []
        findings: List[Finding] = []
        if _is_endpoints_module(rel):
            findings.extend(self._check_endpoints(module))
        findings.extend(self._check_callbacks(module))
        return findings

    # -- invariant 1: read endpoints route through the funnel ------------

    def _check_endpoints(self, module: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        defs = _local_defs(module.tree)
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            method = node.args[0].value
            if not _read_verb(method):
                continue
            if _has_waiver(module.lines, node.lineno):
                continue
            handler = node.args[1]
            routed = False
            if isinstance(handler, ast.Lambda):
                routed = _calls_funnel(handler)
            elif isinstance(handler, ast.Name) and handler.id in defs:
                routed = _calls_funnel(defs[handler.id])
            if not routed:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"read endpoint '{method}' does not route through the "
                    f"blocking_read/serve_read funnel: responses carry no "
                    f"QueryMeta index and min_query_index chaining breaks "
                    f"(add '# {_WAIVER_MARK}: <reason>' if deliberate)",
                ))
        return findings

    # -- invariant 2: hub callbacks stay read-only -----------------------

    def _check_callbacks(self, module: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        defs = _local_defs(module.tree)
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_callback"
                and node.args
            ):
                continue
            recv = _receiver_tail(node.func.value)
            if "hub" not in recv and "watch" not in recv:
                continue  # flight-recorder publishers etc. are not ours
            cb = node.args[0]
            target: Optional[ast.AST] = None
            if isinstance(cb, ast.Lambda):
                target = cb
            elif isinstance(cb, ast.Name) and cb.id in defs:
                target = defs[cb.id]
            if target is None:
                continue
            why = _callback_violation(target)
            if why is not None:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"watch-hub notify callback {why}: callbacks run on "
                    f"the flusher thread downstream of FSM apply and must "
                    f"be read-only observers",
                ))
        return findings
