"""Shared machinery for nomad-lint: parsing, findings, suppressions,
baseline handling and the multi-checker runner.

The linter is stdlib-``ast`` only (no third-party deps) so it runs in
every environment the test suite runs in. Checkers are small classes
with an optional ``collect(module)`` pre-pass (for cross-module facts,
e.g. ``# guarded-by`` declarations) and a ``check(module)`` pass that
yields findings. Line-based facts (comments) come from ``module.lines``
since the AST drops them.

Copied from ``nomad_tpu/analysis/core.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Finding:
    rule: str
    file: str  # posix-style path, relative to the scan root's parent
    line: int
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers drift with unrelated edits, so
        baselined findings match on (rule, file, message) only."""
        return (self.rule, self.file, self.message)

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class ParsedModule:
    path: str  # absolute filesystem path
    rel: str   # posix display/baseline path
    tree: ast.Module
    lines: List[str]


# `# nomad-lint: disable=rule-a,rule-b` on the finding's line suppresses it.
_SUPPRESS_RE = re.compile(r"#\s*nomad-lint:\s*disable=([\w\-, ]+)")


def suppressed_rules(lines: Sequence[str], lineno: int) -> frozenset:
    """Rules disabled on a given 1-based source line."""
    if not (1 <= lineno <= len(lines)):
        return frozenset()
    m = _SUPPRESS_RE.search(lines[lineno - 1])
    if not m:
        return frozenset()
    return frozenset(part.strip() for part in m.group(1).split(",") if part.strip())


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local alias -> full dotted module/name for every import in the
    module (function-local imports included: the linter resolves names
    syntactically, not by scope)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def resolve_call_name(func: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name of a call target with its first segment de-aliased
    (``_time.monotonic`` -> ``time.monotonic``, ``np.random.x`` ->
    ``numpy.random.x``)."""
    name = dotted_name(func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    full = aliases.get(head)
    if full is not None:
        name = full + ("." + rest if rest else "")
    return name


def body_walk(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function/class
    definitions (those are separate units, reached only if called), but
    including lambdas and comprehensions, which execute inline."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def parse_file(path: str, rel: str) -> Tuple[Optional[ParsedModule], Optional[Finding]]:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return None, Finding("parse", rel, e.lineno or 1, f"syntax error: {e.msg}")
    return ParsedModule(path=path, rel=rel, tree=tree, lines=source.splitlines()), None


def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(dirpath, fn))
    return files


def default_checkers() -> list:
    """All thirteen rules, in the reference's order."""
    from .blocking_read_discipline import BlockingReadDisciplineChecker
    from .condition_discipline import ConditionDisciplineChecker
    from .dtype_discipline import DtypeDisciplineChecker
    from .fault_injection_discipline import FaultInjectionDisciplineChecker
    from .fsm_determinism import FsmDeterminismChecker
    from .jit_purity import JitPurityChecker
    from .lock_order import LockOrderChecker, WholeProgramLockAnalysis
    from .metrics_discipline import MetricsDisciplineChecker
    from .pipeline_stage_discipline import PipelineStageDisciplineChecker
    from .rpc_telemetry_discipline import RpcTelemetryDisciplineChecker
    from .shared_state import SharedStateDisciplineChecker
    from .subprocess_discipline import SubprocessDisciplineChecker
    from .trace_span_discipline import TraceSpanDisciplineChecker

    # ONE interprocedural call-graph build, shared by the three
    # concurrency rules (add_module is idempotent, analyze() memoizes)
    shared_analysis = WholeProgramLockAnalysis()
    return [
        JitPurityChecker(),
        DtypeDisciplineChecker(),
        FsmDeterminismChecker(),
        TraceSpanDisciplineChecker(),
        PipelineStageDisciplineChecker(),
        FaultInjectionDisciplineChecker(),
        SubprocessDisciplineChecker(),
        MetricsDisciplineChecker(),
        LockOrderChecker(analysis=shared_analysis),
        ConditionDisciplineChecker(analysis=shared_analysis),
        SharedStateDisciplineChecker(analysis=shared_analysis),
        RpcTelemetryDisciplineChecker(),
        BlockingReadDisciplineChecker(),
    ]


def run_paths(paths: Sequence[str], rel_to: Optional[str] = None,
              checkers: Optional[list] = None,
              only_rel: Optional[set] = None,
              timings: Optional[Dict[str, float]] = None) -> List[Finding]:
    """Run every checker over the python files under ``paths``; returns
    suppression-filtered findings (baseline NOT applied — see
    ``apply_baseline``). ``rel_to`` anchors display/baseline paths.

    ``only_rel`` restricts REPORTING to the given rel paths while the
    collect pass still sees the whole tree (``--changed-only``: the
    cross-module facts stay whole-program, the findings are scoped).
    ``timings``, if given, accumulates per-rule wall seconds; the shared
    call-graph build is reported separately under ``call-graph`` and
    also included in whichever rule forced it."""
    rel_to = rel_to or os.getcwd()
    if checkers is None:
        checkers = default_checkers()

    modules: List[ParsedModule] = []
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(path), rel_to).replace(os.sep, "/")
        module, err = parse_file(path, rel)
        if err is not None:
            findings.append(err)
        if module is not None:
            modules.append(module)

    import time as _time
    for checker in checkers:
        collect = getattr(checker, "collect", None)
        if collect is not None:
            t0 = _time.perf_counter()
            for module in modules:
                collect(module)
            if timings is not None:
                rule = getattr(checker, "rule", type(checker).__name__)
                timings[rule] = timings.get(rule, 0.0) \
                    + _time.perf_counter() - t0
    for checker in checkers:
        t0 = _time.perf_counter()
        for module in modules:
            if only_rel is not None and module.rel not in only_rel:
                continue
            for f in checker.check(module):
                if f.rule not in suppressed_rules(module.lines, f.line) \
                        and "all" not in suppressed_rules(module.lines, f.line):
                    findings.append(f)
        if timings is not None:
            rule = getattr(checker, "rule", type(checker).__name__)
            timings[rule] = timings.get(rule, 0.0) + _time.perf_counter() - t0
    if timings is not None:
        # surface the one-shot shared call-graph build on its own line
        for checker in checkers:
            wall = getattr(getattr(checker, "analysis", None),
                           "analyze_wall_s", 0.0)
            if wall:
                timings["call-graph"] = max(timings.get("call-graph", 0.0),
                                            wall)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings


def run_source(source: str, rel: str, checkers: Optional[list] = None,
               extra_modules: Sequence[Tuple[str, str]] = ()) -> List[Finding]:
    """Fixture entry point: lint in-memory source (used by the unit
    tests). ``extra_modules`` are additional (source, rel) pairs that
    participate in the collect pass (cross-module lock declarations)."""
    if checkers is None:
        checkers = default_checkers()
    modules: List[ParsedModule] = []
    findings: List[Finding] = []
    for src, rel_i in [*extra_modules, (source, rel)]:
        try:
            tree = ast.parse(src, filename=rel_i)
        except SyntaxError as e:
            findings.append(Finding("parse", rel_i, e.lineno or 1,
                                    f"syntax error: {e.msg}"))
            continue
        modules.append(ParsedModule(path=rel_i, rel=rel_i, tree=tree,
                                    lines=src.splitlines()))
    for checker in checkers:
        collect = getattr(checker, "collect", None)
        if collect is not None:
            for module in modules:
                collect(module)
    for checker in checkers:
        for module in modules:
            if module.rel != rel:
                continue  # fixtures lint only the module under test
            for f in checker.check(module):
                if f.rule not in suppressed_rules(module.lines, f.line) \
                        and "all" not in suppressed_rules(module.lines, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings


# ---------------------------------------------------------------------------
# Baseline: a JSON list of {rule, file, message} records for pre-existing
# violations. Matching is a multiset subtraction on Finding.key() so fixed
# findings become stale entries (reported by --prune hint) and NEW findings
# of an already-baselined kind still surface once the old count is used up.
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError("baseline must be a JSON list")
    return data


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[dict]) -> Tuple[List[Finding], List[dict]]:
    """Returns (new_findings, stale_baseline_entries)."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for ent in baseline:
        key = (ent.get("rule", ""), ent.get("file", ""), ent.get("message", ""))
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            new.append(f)
    stale = [
        {"rule": k[0], "file": k[1], "message": k[2]}
        for k, count in sorted(budget.items()) for _ in range(count) if count > 0
    ]
    return new, stale


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    data = [
        {"rule": f.rule, "file": f.file, "message": f.message}
        for f in findings
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
