"""jit-purity: functions compiled by ``jax.jit`` must be pure.

A traced function runs ONCE per compile-cache shape; host-side effects
inside it (wall clock, RNG, threading, prints, global mutation) execute
at trace time only and silently vanish — or worse, bake a trace-time
value into the compiled executable. The scan bodies behind the placement
engine's parity guarantees (PARITY.md) must therefore never touch the
host environment.

Detection: a function is a jit ENTRY when it is decorated with
``jax.jit`` / ``partial(jax.jit, ...)`` or passed to a ``jax.jit(...)``
call. From every entry, same-module callees are resolved by bare name
(any FunctionDef with that name, nested ones included — the engine's
builder pattern returns closures) and the reachable set is scanned for:

  - calls into banned namespaces (time, random, numpy.random,
    threading, datetime, uuid, secrets, os.urandom) and bare ``print``
  - ``global`` / ``nonlocal`` declarations (rebinding escapes the trace)

The port compiles nothing with ``jax.jit``, so the reference's detection
alone would check nothing in it. It keeps that detection and also takes
as entries the plain versions that stand for each CUDA kernel's body
(what the CPU runs and what every kernel is held against): every
module-level function of ``tpu/step.py`` (K1-K3), ``tpu/forced.py``
(K4) and ``tpu/chunk.py`` (K5), and the ``*_t`` functions of
``tpu/preempt.py`` (K6-K8). They are held to the same banned namespaces.

Copied from ``nomad_tpu/analysis/jit_purity.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, ParsedModule, body_walk, import_aliases, resolve_call_name

RULE = "jit-purity"

BANNED_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "threading.",
    "datetime.", "uuid.", "secrets.",
)
BANNED_EXACT = {"print", "os.urandom", "time", "input"}

#: modules whose every module-level function is a kernel's plain body
PLAIN_BODY_MODULES = ("tpu/step.py", "tpu/forced.py", "tpu/chunk.py")
#: modules whose ``*_t`` functions are kernels' plain bodies
PLAIN_T_MODULES = ("tpu/preempt.py",)


def _is_jit_expr(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """True for ``jax.jit`` / ``jit`` (imported from jax) references and
    ``partial(jax.jit, ...)`` / ``functools.partial(jax.jit, ...)``."""
    if not isinstance(node, ast.Call):
        # resolve_call_name de-aliases `from jax import jit` to jax.jit
        if resolve_call_name(node, aliases) == "jax.jit":
            return True
    if isinstance(node, ast.Call):
        fn = resolve_call_name(node.func, aliases)
        if fn in ("functools.partial", "partial") and node.args:
            return _is_jit_expr(node.args[0], aliases)
    return False


class JitPurityChecker:
    rule = RULE

    def check(self, module: ParsedModule) -> List[Finding]:
        aliases = import_aliases(module.tree)

        # name -> FunctionDefs (nested defs included; bare-name resolution)
        by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)

        entries: List[Tuple[ast.AST, str]] = []
        seen_ids: Set[int] = set()

        def add_entry(fn: ast.AST, why: str) -> None:
            if id(fn) not in seen_ids:
                seen_ids.add(id(fn))
                entries.append((fn, why))

        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _is_jit_expr(dec, aliases):
                        add_entry(node, f"@jit function '{node.name}'")
            elif isinstance(node, ast.Call) and _is_jit_expr(node.func, aliases):
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name):
                        for fn in by_name.get(arg.id, []):
                            add_entry(fn, f"jit-compiled function '{arg.id}'")
                    elif isinstance(arg, ast.Lambda):
                        add_entry(arg, "jit-compiled lambda")

        rel = module.rel.replace("\\", "/")
        plain_all = rel.endswith(PLAIN_BODY_MODULES)
        if plain_all or rel.endswith(PLAIN_T_MODULES):
            for node in module.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (plain_all or node.name.endswith("_t")):
                    add_entry(node, f"plain kernel body '{node.name}'")

        # transitive same-module closure over bare-name calls
        queue = list(entries)
        reach: List[Tuple[ast.AST, str]] = []
        while queue:
            fn, why = queue.pop()
            reach.append((fn, why))
            for node in body_walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    for callee in by_name.get(node.func.id, []):
                        if id(callee) not in seen_ids:
                            seen_ids.add(id(callee))
                            name = getattr(callee, "name", "<lambda>")
                            queue.append(
                                (callee, f"'{name}' (reached from {why})")
                            )

        findings: List[Finding] = []
        for fn, why in reach:
            findings.extend(self._scan_function(module, fn, why, aliases))
        return findings

    def _scan_function(self, module: ParsedModule, fn: ast.AST, why: str,
                       aliases: Dict[str, str]) -> Iterable[Finding]:
        for node in body_walk(fn):
            if isinstance(node, ast.Call):
                name = resolve_call_name(node.func, aliases)
                if name is None:
                    continue
                if name in BANNED_EXACT or any(
                    name.startswith(p) for p in BANNED_PREFIXES
                ):
                    yield Finding(
                        RULE, module.rel, node.lineno,
                        f"impure call '{name}' inside {why}",
                    )
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                kw = "global" if isinstance(node, ast.Global) else "nonlocal"
                yield Finding(
                    RULE, module.rel, node.lineno,
                    f"{kw} mutation of {', '.join(node.names)} inside {why}",
                )
