"""fsm-determinism: FSM apply handlers must be wall-clock/RNG free.

Every server materializes state by replaying the same log through
``NomadFSM.apply`` (server/fsm.py): any handler that reads the wall
clock or an RNG produces replica-divergent state — the timestamps the
FSM stores all arrive IN the log payload for exactly this reason.

Detection: module-level dict assignments whose target name contains
``DISPATCH`` are treated as apply dispatch tables; their values
(``Class.method`` / bare functions) are the roots. Reachability follows
same-module calls — ``self.m(...)`` and ``Class.m(...)`` to methods of
the same class, bare names to module functions — and flags calls into
time/random/datetime/uuid/secrets namespaces plus ``os.urandom``.

Copied from ``nomad_tpu/analysis/fsm_determinism.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .core import Finding, ParsedModule, body_walk, import_aliases, resolve_call_name

RULE = "fsm-determinism"

BANNED_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.",
    "datetime.", "uuid.", "secrets.",
)
BANNED_EXACT = {"os.urandom", "time"}


class FsmDeterminismChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        # class name -> {method name -> FunctionDef}
        classes: Dict[str, Dict[str, ast.AST]] = {}
        functions: Dict[str, ast.AST] = {}
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    m.name: m for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions[node.name] = node

        # roots: values of module-level *DISPATCH* dicts
        roots: List[Tuple[str, ast.AST, str]] = []  # (owner class or "", fn, label)
        for node in module.tree.body:
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.value
            else:
                continue
            if not (isinstance(target, ast.Name) and "DISPATCH" in target.id.upper()):
                continue
            if not isinstance(value, ast.Dict):
                continue
            for v in value.values:
                if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name):
                    cls, meth = v.value.id, v.attr
                    fn = classes.get(cls, {}).get(meth)
                    if fn is not None:
                        roots.append((cls, fn, f"{cls}.{meth}"))
                elif isinstance(v, ast.Name) and v.id in functions:
                    roots.append(("", functions[v.id], v.id))
        if not roots:
            return []

        aliases = import_aliases(module.tree)
        findings: List[Finding] = []
        seen: Set[int] = {id(fn) for _, fn, _ in roots}
        queue = list(roots)
        while queue:
            cls, fn, label = queue.pop()
            for node in body_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee, owner = None, ""
                f = node.func
                if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                    if f.value.id == "self" and cls:
                        callee, owner = classes.get(cls, {}).get(f.attr), cls
                    elif f.value.id in classes:
                        callee, owner = classes[f.value.id].get(f.attr), f.value.id
                elif isinstance(f, ast.Name):
                    callee = functions.get(f.id)
                if callee is not None:
                    if id(callee) not in seen:
                        seen.add(id(callee))
                        queue.append((
                            owner, callee,
                            f"{getattr(callee, 'name', '?')} (from {label})",
                        ))
                    continue
                name = resolve_call_name(f, aliases)
                if name is None:
                    continue
                if name in BANNED_EXACT or any(
                    name.startswith(p) for p in BANNED_PREFIXES
                ):
                    findings.append(Finding(
                        RULE, module.rel, node.lineno,
                        f"nondeterministic call '{name}' reachable from "
                        f"FSM dispatch handler {label}",
                    ))
        return findings
