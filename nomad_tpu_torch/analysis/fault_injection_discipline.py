"""fault-injection-discipline: chaos hooks only via the chaos registry.

The chaos harness (``nomad_tpu_torch/chaos/``) stays trustworthy only if the
production side of it stays inert and uniform:

1. **Production modules touch chaos ONLY through the registry's
   ``fire`` hook.** The blessed shape is ``from ..chaos.injector import
   fire as <alias>`` plus calls to that alias. Anything else — importing
   ``ChaosInjector``/``ChaosFault`` into production code, ``if CHAOS:``
   flags, ``os.environ`` lookups with CHAOS keys, any other chaos-named
   identifier — is an ad-hoc injection branch: a second code path that
   ships to production, drifts from the registry's arm/disarm
   accounting, and silently changes behavior outside chaos runs.

2. **Every ``arm`` has a ``disarm`` in a ``finally``.** An injector that
   outlives its test poisons every run after it (the registry is a
   process-global slot). A function that arms an injector must contain
   a ``try`` whose ``finally`` calls ``disarm``/``disarm_all``;
   module-scope arms are flagged outright.

3. ``fire`` calls with a constant point name must name a registered
   injection point — a typo'd point is a hook that never fires.

Scope: rule 1 applies to production modules (``nomad_tpu_torch/`` excluding
``nomad_tpu_torch/chaos/`` and test files); rules 2-3 apply everywhere outside
``nomad_tpu_torch/chaos/`` itself (the harness package owns its documented
driver-level ``finally``; consumers — tests, benches — are exactly where
a leaked arm does damage).

Copied from ``nomad_tpu/analysis/fault_injection_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, ParsedModule

RULE = "fault-injection-discipline"

# kept in sync with chaos.injector.POINTS (imported lazily to avoid
# coupling the linter's import graph to the package under lint)
_KNOWN_POINTS = (
    "device_dispatch",
    "plan_apply",
    "broker_ack",
    "raft_apply",
    "heartbeat",
    "unblock_enqueue",
    "watch_notify",
)

_ARM_RECEIVER_HINTS = ("chaos", "inj")


def _norm(rel: str) -> str:
    return rel.replace("\\", "/")


def _in_chaos_pkg(rel: str) -> bool:
    rel = _norm(rel)
    return "nomad_tpu_torch/chaos/" in rel or rel.startswith("chaos/")


def _is_test_file(rel: str) -> bool:
    rel = _norm(rel)
    base = rel.rsplit("/", 1)[-1]
    return "tests/" in rel or base.startswith("test_") or base == "conftest.py"


# Harness modules living OUTSIDE nomad_tpu_torch/chaos/: replay drivers that
# legitimately build on the chaos harness (subclass CrashReplay, spawn
# ServerProcess fleets) but ship next to the subsystem they exercise.
_HARNESS_MODULES = (
    "nomad_tpu_torch/watch/serve.py",  # ServeReplay — the serve-100Kwatch bench
)


def _production_scope(rel: str) -> bool:
    rel = _norm(rel)
    if "nomad_tpu_torch/analysis/" in rel or rel.startswith("analysis/"):
        return False  # the linter itself names chaos in its rules
    if any(rel.endswith(h) for h in _HARNESS_MODULES):
        return False
    return (
        ("nomad_tpu_torch/" in rel or not rel.startswith(("tests/", "bench")))
        and not _in_chaos_pkg(rel)
        and not _is_test_file(rel)
    )


def _chaos_import_module(node: ast.ImportFrom) -> bool:
    mod = node.module or ""
    return "chaos" in mod.lower()


def _fire_aliases(tree: ast.AST) -> Set[str]:
    """Names the blessed ``fire`` hook is bound to in this module.

    Resolved from the raw ImportFrom nodes (not ``import_aliases``,
    which skips the relative imports production modules use)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and _chaos_import_module(node):
            for alias in node.names:
                if alias.name == "fire":
                    out.add(alias.asname or alias.name)
    return out


def _receiver_text(func: ast.expr) -> str:
    """Dotted receiver of an attribute call, best effort."""
    parts: List[str] = []
    cur = func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _looks_like_injector_arm(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "arm"):
        return False
    recv = _receiver_text(call.func.value).lower()
    if any(h in recv for h in _ARM_RECEIVER_HINTS):
        return True
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value in _KNOWN_POINTS:
        return True
    return False


def _is_disarm_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in ("disarm", "disarm_all")
    )


def _env_chaos_key(call: ast.Call) -> Optional[str]:
    """Constant CHAOS-ish key in an os.getenv/environ.get call."""
    name = _receiver_text(call.func) if isinstance(call.func, ast.Attribute) \
        else (call.func.id if isinstance(call.func, ast.Name) else "")
    if not name.endswith(("getenv", "environ.get")):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str) \
            and "chaos" in call.args[0].value.lower():
        return call.args[0].value
    return None


class FaultInjectionDisciplineChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        if _in_chaos_pkg(module.rel):
            return []
        findings: List[Finding] = []
        aliases = _fire_aliases(module.tree)
        if _production_scope(module.rel):
            findings.extend(self._check_production(module, aliases))
        findings.extend(self._check_fire_points(module, aliases))
        findings.extend(self._check_arm_finally(module))
        return findings

    # -- rule 1: production modules --------------------------------------

    def _check_production(self, module: ParsedModule,
                          aliases: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and _chaos_import_module(node):
                for alias in node.names:
                    if alias.name != "fire":
                        findings.append(Finding(
                            RULE, module.rel, node.lineno,
                            f"production import of '{alias.name}' from the "
                            f"chaos package: production modules may import "
                            f"only the 'fire' hook — arming/handling chaos "
                            f"belongs to the harness",
                        ))
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if "chaos" in alias.name.lower():
                        findings.append(Finding(
                            RULE, module.rel, node.lineno,
                            f"production 'import {alias.name}': chaos enters "
                            f"production only as 'from ..chaos.injector "
                            f"import fire as <alias>'",
                        ))
            elif isinstance(node, ast.Name) and "chaos" in node.id.lower() \
                    and node.id not in aliases:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"ad-hoc chaos conditioning '{node.id}' in production "
                    f"code: injection points go through the chaos "
                    f"registry's fire() hook, not module flags",
                ))
            elif isinstance(node, ast.Attribute) \
                    and "chaos" in node.attr.lower():
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"ad-hoc chaos attribute '{node.attr}' in production "
                    f"code: injection points go through the chaos "
                    f"registry's fire() hook",
                ))
            elif isinstance(node, ast.Call):
                key = _env_chaos_key(node)
                if key is not None:
                    findings.append(Finding(
                        RULE, module.rel, node.lineno,
                        f"environment-gated chaos ('{key}') in production "
                        f"code: fault behavior must be armed through the "
                        f"chaos registry, not env vars",
                    ))
            elif isinstance(node, ast.Subscript):
                recv = _receiver_text(node.value) \
                    if isinstance(node.value, (ast.Attribute, ast.Name)) else ""
                if recv.endswith("environ") \
                        and isinstance(node.slice, ast.Constant) \
                        and isinstance(node.slice.value, str) \
                        and "chaos" in node.slice.value.lower():
                    findings.append(Finding(
                        RULE, module.rel, node.lineno,
                        f"environment-gated chaos ('{node.slice.value}') in "
                        f"production code: fault behavior must be armed "
                        f"through the chaos registry, not env vars",
                    ))
        return findings

    # -- rule 3: fire() point names --------------------------------------

    def _check_fire_points(self, module: ParsedModule,
                           aliases: Set[str]) -> List[Finding]:
        if not aliases:
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in aliases):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and node.args[0].value not in _KNOWN_POINTS:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"fire({node.args[0].value!r}): unknown injection point "
                    f"— known points: {', '.join(_KNOWN_POINTS)}",
                ))
        return findings

    # -- rule 2: arm/finally ---------------------------------------------

    def _check_arm_finally(self, module: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        func_nodes = [
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        in_func: Set[int] = set()
        for fn in func_nodes:
            has_finally_disarm = any(
                isinstance(t, ast.Try) and any(
                    _is_disarm_call(sub)
                    for stmt in t.finalbody for sub in ast.walk(stmt)
                )
                for t in ast.walk(fn)
            )
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _looks_like_injector_arm(node):
                    in_func.add(id(node))
                    if not has_finally_disarm:
                        findings.append(Finding(
                            RULE, module.rel, node.lineno,
                            "injector armed without a disarm in a 'finally' "
                            "in the same function: a leaked arm poisons "
                            "every later run in the process",
                        ))
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and _looks_like_injector_arm(node) \
                    and id(node) not in in_func:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    "injector armed at module scope: arm inside a function "
                    "with a matching disarm in a 'finally'",
                ))
        return findings
