"""metrics-discipline: metric names are literals from registered families.

The InmemSink aggregates by exact metric name, so the name SET must be
bounded at compile time: a name minted per eval id / node id / error
string grows every retained interval without bound and makes
``/v1/metrics`` rendering quadratic. Three obligations at every
``metrics.incr_counter/add_sample/set_gauge/measure_since`` call site:

  1. the name argument is a dotted ``nomad.*`` string literal, an
     UPPER_CASE module constant, or an f-string whose literal head is
     ``nomad.<family>...`` (a bounded enum suffix like the eval type is
     fine — the family stays greppable);
  2. f-string names must NOT appear lexically inside a for/while loop —
     that is the "minted in a hot loop" cardinality smell. Loops publish
     dynamic key sets through the blessed doors in
     ``utils.metric_names``: ``publish_family(prefix, mapping)`` for
     gauges, ``family_sample``/``family_counter`` for bounded dynamic
     keys under a registered family (the RPC layer's per-method names);
  3. the name's family (``nomad.<second segment>``) is documented in
     ``utils/metric_names.py`` FAMILIES (enforced when that registry is
     in the scanned module set, i.e. on full-tree runs; fixtures opt in
     via ``extra_modules``).

``publish_family`` itself must be called with a literal registered
prefix. The registry module is exempt (it IS the blessed door), as is
``utils/metrics.py`` (the sink's internal fan-out plumbing).

Copied from ``nomad_tpu/analysis/metrics_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from .core import Finding, ParsedModule, import_aliases, resolve_call_name

RULE = "metrics-discipline"

_CHECKED = {"incr_counter", "add_sample", "set_gauge", "measure_since"}
_NAME_RE = re.compile(r"^nomad\.[a-z0-9_]+(\.[a-zA-Z0-9_\-]+)+$")
_HEAD_RE = re.compile(r"^nomad\.[a-z0-9_]+\.")
_CONST_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")

#: modules exempt from call-site checks: the blessed dynamic-name door
#: and the sink's own plumbing
_EXEMPT = ("utils/metric_names.py", "utils/metrics.py")


def _is_metrics_call(call: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    """'set_gauge' etc. when the call targets the metrics module (any
    alias/relative-import spelling), else None."""
    name = resolve_call_name(call.func, aliases)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] in _CHECKED and len(parts) >= 2 \
            and parts[-2].lstrip("_") == "metrics":
        return parts[-1]
    return None


#: the blessed dynamic-name doors in utils/metric_names.py; each takes a
#: literal registered family prefix as its first argument
_BLESSED_DOORS = {"publish_family", "family_sample", "family_counter"}


def _blessed_door(call: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
    name = resolve_call_name(call.func, aliases)
    if name is None:
        return None
    tail = name.split(".")[-1]
    return tail if tail in _BLESSED_DOORS else None


def _fstring_head(node: ast.JoinedStr) -> Optional[str]:
    """The leading literal part of an f-string, or None."""
    if node.values and isinstance(node.values[0], ast.Constant) \
            and isinstance(node.values[0].value, str):
        return node.values[0].value
    return None


def _const_name(node: ast.AST) -> Optional[str]:
    """Terminal identifier of a Name/Attribute, if UPPER_CASE constant."""
    if isinstance(node, ast.Name):
        seg = node.id
    elif isinstance(node, ast.Attribute):
        seg = node.attr
    else:
        return None
    return seg if _CONST_RE.match(seg) else None


class MetricsDisciplineChecker:
    rule = RULE

    def __init__(self) -> None:
        self._families: Set[str] = set()

    # -- collect: read FAMILIES keys from the registry module -----------

    def collect(self, module: ParsedModule) -> None:
        if not module.rel.endswith("utils/metric_names.py"):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if not any(isinstance(t, ast.Name) and t.id == "FAMILIES"
                       for t in targets):
                continue
            value = node.value
            if isinstance(value, ast.Dict):
                for key in value.keys:
                    if isinstance(key, ast.Constant) \
                            and isinstance(key.value, str):
                        self._families.add(key.value)

    # -- check ----------------------------------------------------------

    def check(self, module: ParsedModule) -> List[Finding]:
        if module.rel.endswith(_EXEMPT):
            return []
        aliases = import_aliases(module.tree)
        findings: List[Finding] = []
        self._visit(module, module.tree, aliases, False, findings)
        return findings

    def _visit(self, module: ParsedModule, node: ast.AST,
               aliases: Dict[str, str], in_loop: bool,
               findings: List[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                # a nested def is its own execution context, not part of
                # the enclosing loop's per-iteration body
                self._visit(module, child, aliases, False, findings)
                continue
            child_in_loop = in_loop or isinstance(
                child, (ast.For, ast.AsyncFor, ast.While))
            if isinstance(child, ast.Call):
                self._check_call(module, child, aliases, child_in_loop,
                                 findings)
            self._visit(module, child, aliases, child_in_loop, findings)

    def _check_call(self, module: ParsedModule, call: ast.Call,
                    aliases: Dict[str, str], in_loop: bool,
                    findings: List[Finding]) -> None:
        door = _blessed_door(call, aliases)
        if door is not None:
            self._check_prefix(module, call, door, findings)
            return
        fn = _is_metrics_call(call, aliases)
        if fn is None or not call.args:
            return
        name_arg = call.args[0]

        if isinstance(name_arg, ast.Constant) \
                and isinstance(name_arg.value, str):
            if not _NAME_RE.match(name_arg.value):
                findings.append(Finding(
                    RULE, module.rel, call.lineno,
                    f"metric name {name_arg.value!r} is not a dotted "
                    f"'nomad.<family>.<name>' literal",
                ))
            else:
                self._check_family(module, call, name_arg.value, findings)
            return

        if isinstance(name_arg, ast.JoinedStr):
            head = _fstring_head(name_arg)
            if head is None or not _HEAD_RE.match(head):
                findings.append(Finding(
                    RULE, module.rel, call.lineno,
                    f"f-string metric name passed to {fn}() has no "
                    f"'nomad.<family>.' literal head — the family must "
                    f"be greppable",
                ))
                return
            if in_loop:
                findings.append(Finding(
                    RULE, module.rel, call.lineno,
                    f"f-string metric name minted inside a loop at {fn}() "
                    f"— unbounded cardinality kills the InmemSink; "
                    f"publish the dict through "
                    f"metric_names.publish_family(...)",
                ))
                return
            self._check_family(module, call, head, findings)
            return

        if _const_name(name_arg) is not None:
            return  # module constant: bounded by construction

        findings.append(Finding(
            RULE, module.rel, call.lineno,
            f"metric name passed to {fn}() is dynamic (not a 'nomad.*' "
            f"literal, UPPER_CASE constant, or literal-headed f-string)",
        ))

    def _check_prefix(self, module: ParsedModule, call: ast.Call,
                      door: str, findings: List[Finding]) -> None:
        if not call.args:
            return
        prefix = call.args[0]
        if not (isinstance(prefix, ast.Constant)
                and isinstance(prefix.value, str)
                and prefix.value.startswith("nomad.")):
            findings.append(Finding(
                RULE, module.rel, call.lineno,
                f"{door}() prefix must be a 'nomad.*' string "
                f"literal",
            ))
            return
        self._check_family(module, call, prefix.value, findings)

    def _check_family(self, module: ParsedModule, call: ast.Call,
                      name: str, findings: List[Finding]) -> None:
        if not self._families:
            return  # registry not in the scanned set (unit fixtures)
        family = ".".join(name.split(".")[:2])
        if family not in self._families:
            findings.append(Finding(
                RULE, module.rel, call.lineno,
                f"metric family {family!r} is not documented in "
                f"utils/metric_names.py FAMILIES",
            ))
