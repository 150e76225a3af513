"""subprocess-discipline: spawned server processes are bounded and reaped.

The crash-recovery harness (``nomad_tpu_torch/chaos/crash.py``) and its tests
spawn real server OS processes. A child process is a resource Python
will not collect: an un-reaped ``Popen`` is a zombie holding its data
dir, an unbounded ``wait()`` on an unkillable child wedges the whole
test run, and a ``subprocess.run`` without a timeout turns one stuck
server into a hung CI job. Three rules, enforced over the code that
spawns processes (the chaos package, tests, and bench drivers):

1. **Blocking one-shot helpers carry an explicit ``timeout=``** —
   ``subprocess.run`` / ``call`` / ``check_call`` / ``check_output``
   with no timeout blocks forever on a wedged child.
2. **``<proc>.wait()`` carries an explicit ``timeout=``** — an
   unbounded reap after SIGKILL still hangs when the child is stuck in
   uninterruptible sleep; bound it and let ``TimeoutExpired`` surface.
3. **Every ``Popen`` is owned** — either assigned to an attribute of a
   class that also defines a reap method (``terminate`` / ``kill`` /
   ``close`` / ``stop``, the :class:`~nomad_tpu_torch.chaos.crash.ServerProcess`
   pattern), or created in a function whose ``finally`` reaps it
   (``terminate``/``kill``/``wait``). A bare local ``Popen`` leaks the
   child on the first exception between spawn and reap.

Scope: ``nomad_tpu_torch/chaos/``, test files, and bench drivers — harness
code, where a leaked child outlives the scenario and poisons the next
one. Client task drivers (``client/drivers/``, logmon, plugin
transports) spawn workloads as their actual job and manage lifecycles
through their own handle/recover machinery; they are out of scope here.

Copied from ``nomad_tpu/analysis/subprocess_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import Finding, ParsedModule, dotted_name, import_aliases, resolve_call_name

RULE = "subprocess-discipline"

_ONESHOT = {
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
}
_POPEN = "subprocess.Popen"
_REAP_METHODS = ("terminate", "kill", "kill_hard", "close", "stop", "wait")
# receiver-name hints for rule 2: `.wait()` on something process-shaped
# (never on locks/events — their wait() is the one with different rules)
_PROC_HINTS = ("proc", "popen", "child", "pgm", "server_process")


def _norm(rel: str) -> str:
    return rel.replace("\\", "/")


def _is_test_file(rel: str) -> bool:
    rel = _norm(rel)
    base = rel.rsplit("/", 1)[-1]
    return "tests/" in rel or base.startswith("test_") or base == "conftest.py"


def _spawn_scope(rel: str) -> bool:
    """Files allowed to spawn processes (and held to rules 1-3)."""
    rel = _norm(rel)
    base = rel.rsplit("/", 1)[-1]
    return (
        "nomad_tpu_torch/chaos/" in rel
        or rel.startswith("chaos/")
        or _is_test_file(rel)
        or base.startswith("bench")
    )


def _proc_receiver(func: ast.expr) -> bool:
    recv = dotted_name(func)
    if recv is None:
        return False
    recv = recv.lower()
    head = recv.rsplit(".", 2)
    owner = head[-2] if len(head) >= 2 else recv
    return any(h in owner for h in _PROC_HINTS) or owner == "p"


def _has_timeout_kw(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


class SubprocessDisciplineChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        if not _spawn_scope(module.rel):
            return []
        aliases = import_aliases(module.tree)
        findings: List[Finding] = []
        findings.extend(self._check_oneshot_timeouts(module, aliases))
        findings.extend(self._check_wait_timeouts(module))
        findings.extend(self._check_popen_owned(module, aliases))
        return findings

    # -- rule 1: one-shot helpers are bounded ----------------------------

    def _check_oneshot_timeouts(self, module: ParsedModule,
                                aliases: Dict[str, str]) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(node.func, aliases)
            if name in _ONESHOT and not _has_timeout_kw(node):
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"'{name}' without timeout=: a wedged child blocks "
                    f"this call forever — pass an explicit timeout and "
                    f"handle TimeoutExpired",
                ))
        return findings

    # -- rule 2: reaps are bounded ---------------------------------------

    def _check_wait_timeouts(self, module: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "wait"
                    and _proc_receiver(node.func)):
                continue
            if not _has_timeout_kw(node):
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    "process .wait() without timeout=: even after SIGKILL "
                    "a child stuck in uninterruptible sleep hangs an "
                    "unbounded reap — pass timeout= and surface "
                    "TimeoutExpired",
                ))
        return findings

    # -- rule 3: every Popen is owned ------------------------------------

    def _check_popen_owned(self, module: ParsedModule,
                           aliases: Dict[str, str]) -> List[Finding]:
        findings: List[Finding] = []

        # classes that define a reap method: their methods may assign
        # Popen to self.<attr> (instance-managed lifecycle)
        reaping_classes: Set[int] = set()
        class_of_node: Dict[int, int] = {}
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if any(isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and m.name in _REAP_METHODS for m in cls.body):
                reaping_classes.add(id(cls))
            for sub in ast.walk(cls):
                class_of_node.setdefault(id(sub), id(cls))

        func_of_node: Dict[int, ast.AST] = {}
        for fn in ast.walk(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    func_of_node.setdefault(id(sub), fn)

        def finally_reaps(fn: Optional[ast.AST]) -> bool:
            if fn is None:
                return False
            for t in ast.walk(fn):
                if not isinstance(t, ast.Try):
                    continue
                for stmt in t.finalbody:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) \
                                and isinstance(sub.func, ast.Attribute) \
                                and sub.func.attr in _REAP_METHODS:
                            return True
            return False

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not (isinstance(call, ast.Call)
                    and resolve_call_name(call.func, aliases) == _POPEN):
                continue
            self_attr = any(
                isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self" for t in node.targets
            )
            if self_attr and class_of_node.get(id(node)) in reaping_classes:
                continue
            if finally_reaps(func_of_node.get(id(node))):
                continue
            findings.append(Finding(
                RULE, module.rel, node.lineno,
                "Popen not owned: assign it to an attribute of a class "
                "with a reap method (terminate/kill/close/stop), or reap "
                "it in this function's 'finally' — a bare local Popen "
                "leaks the child on the first exception",
            ))

        # a Popen used as a bare expression (not even assigned) is always
        # unreaped
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                    and resolve_call_name(node.value.func, aliases) == _POPEN:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    "Popen result discarded: the process can never be "
                    "reaped — keep the handle and reap it",
                ))
        return findings
