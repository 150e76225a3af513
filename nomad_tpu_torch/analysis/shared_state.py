"""shared-state-discipline: whole-program shared-state race analysis.

nomad-race's static side, built on the same interprocedural engine as
``lock-order`` (one :class:`WholeProgramLockAnalysis` instance is shared
across the three concurrency rules). The pass:

1. **Inventories thread-entry roots** — the places a new flow of control
   starts: ``threading.Thread(target=f)`` / ``threading.Timer(.., f)``
   spawns (through lambdas and ``functools.partial`` too), executor
   ``.submit(f)``, the server's ``_schedule_leader_task(gen, iv, f)``
   leader tasks, RPC ``register("Svc.method", handler)`` dispatch
   handlers, and future ``add_done_callback(cb)`` hooks. A root spawned
   inside a loop (worker pools) or from two call sites is concurrent
   with itself.

2. **Propagates** root reachability over the call graph: every unit
   learns which roots can be on its stack.

3. **Infers shared state**: a class attribute (or module-level global)
   is *shared* when units reachable from >= 2 concurrent roots access it
   (one self-concurrent root counts). Synchronization objects (locks,
   conditions, events, queues, thread handles) are exempt, as are
   attributes of classes that declare no lock at all — those are data
   objects whose ownership is transferred through queues; the runtime
   race witness covers them dynamically.

4. **Proves every write** (plain/augmented assignment, ``del``, and
   mutating container method calls — the subscript chain root counts as
   the written attribute) to an inferred-shared attribute happens under
   a held lock of the owning class: a lexical ``with``, the
   ``*_locked`` naming convention, or the all-call-sites-held proof
   (``notify_held``) borrowed from condition-discipline. ``__init__``
   writes are exempt (thread start is a happens-before edge).

5. Keeps ``# guarded-by: <lockname>`` annotations as **authoritative
   guard declarations** (subsuming the old annotation-only
   ``lock-discipline`` rule): writes to an annotated attribute — by
   NAME, on any receiver — must hold the named lock, root-reachable or
   not, and are reported once (never double-reported by the inferred
   path).

Findings are suppressed line-by-line with ``# race-ok: <reason>`` — a
reasoned claim (single-writer, immutable-after-init, torn-read-benign)
that feeds the ratchet: a ``race-ok`` that no longer suppresses
anything is itself a finding, so stale claims can't linger. Messages
carry no line numbers, so baseline entries survive drift.

``build_static_shared()`` exposes the inferred-shared key set (same
``module.Class.attr`` namespace as the lock inventory and the
``tracked_*`` container factories in ``utils/race_witness.py``) to the
runtime witness's teardown cross-check: every field the Eraser witness
saw touched by >= 2 threads must be in this set, which makes a
witness-armed stress run a soundness test for the root inventory.

Copied from ``nomad_tpu/analysis/shared_state.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``; ``build_static_shared``
defaults to the port's tree.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ParsedModule, dotted_name
from .lock_order import (
    WholeProgramLockAnalysis,
    _Class,
    _FALLBACK_DENY,
    _Mod,
    _Unit,
)

RULE = "shared-state-discipline"

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_RACE_OK_RE = re.compile(r"#\s*race-ok:(.*)$")

# container methods that mutate the receiver in place
_MUTATING_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "update", "setdefault", "add", "sort", "reverse", "rotate",
})

# constructor tails that mint synchronization (or thread-handle) objects:
# writes to attributes holding these are lifecycle management, not data
_SYNC_TAILS = frozenset({
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "LifoQueue", "PriorityQueue",
    "SimpleQueue", "BoundedStageQueue", "Thread", "Timer",
    "ThreadPoolExecutor", "local",
    "witness_lock", "witness_rlock", "witness_condition",
    "module_witness_lock", "module_witness_rlock",
})

_TRACKED_FACTORIES = frozenset({"tracked_dict", "tracked_list",
                                "tracked_deque"})

_ALL_CAPS_RE = re.compile(r"^_?[A-Z0-9_]+$")


def _base_attribute(target: ast.AST) -> Optional[ast.Attribute]:
    """The Attribute at the root of a write target: ``x.a`` for ``x.a``,
    ``x.a[k]`` and ``x.a[k][j]``; None for plain names."""
    cur = target
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    return cur if isinstance(cur, ast.Attribute) else None


def _base_name(target: ast.AST) -> Optional[ast.Name]:
    """The Name at the root of a subscripted write target."""
    cur = target
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    return cur if isinstance(cur, ast.Name) else None


class _Access:
    __slots__ = ("key", "owner", "attr", "unit", "lineno", "held",
                 "kind", "is_self", "pseudo")

    def __init__(self, key: str, owner, attr: str, unit: _Unit,
                 lineno: int, held: Tuple[str, ...], kind: str,
                 is_self: bool) -> None:
        self.key = key
        self.owner = owner          # _Class, or _Mod for module globals
        self.attr = attr
        self.unit = unit
        self.lineno = lineno
        self.held = held            # resolved keys + "?<name>" pseudo entries
        self.kind = kind            # read|write|rmw|del|mutate
        self.is_self = is_self


class SharedStateDisciplineChecker:
    rule = RULE

    def __init__(self,
                 analysis: Optional[WholeProgramLockAnalysis] = None) -> None:
        self.analysis = analysis or WholeProgramLockAnalysis()
        # guarded-by annotations (ported from the old lock-discipline rule)
        self.guarded: Dict[str, str] = {}               # attr -> lockname
        self.declaring: Set[Tuple[str, str, str]] = set()
        self.decl_lines: Set[Tuple[str, int]] = set()
        # race-ok suppressions: (rel, lineno) -> reason
        self._race_ok: Dict[Tuple[str, int], str] = {}
        self._findings: Optional[List[Finding]] = None
        # outputs for build_static_shared / diagnostics
        self.shared_keys: Set[str] = set()
        self.root_inventory: Dict[str, bool] = {}       # qual -> self-concurrent

    # -- pass 1: cross-module facts --------------------------------------

    def collect(self, module: ParsedModule) -> None:
        self.analysis.add_module(module)
        # real COMMENT tokens only — docstrings that *mention* race-ok
        # (like this module's) must not register as suppressions
        try:
            reader = io.StringIO("\n".join(module.lines) + "\n").readline
            for tok in tokenize.generate_tokens(reader):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _RACE_OK_RE.search(tok.string)
                if m is not None:
                    self._race_ok[(module.rel, tok.start[0])] = \
                        m.group(1).strip()
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    line = module.lines[node.lineno - 1] \
                        if node.lineno <= len(module.lines) else ""
                    m = _GUARDED_RE.search(line)
                    if m:
                        self.guarded[tgt.attr] = m.group(1)
                        self.declaring.add((module.rel, cls.name, tgt.attr))
                        self.decl_lines.add((module.rel, node.lineno))

    # -- inventories -----------------------------------------------------

    def _prepass(self) -> None:
        """Per-class assigned/sync/tracked-attr sets and per-module
        mutable-global inventories."""
        self._assigned: Dict[int, Set[str]] = {}     # id(_Class) -> attrs
        self._sync: Dict[int, Set[str]] = {}
        self._tracked: Dict[Tuple[int, str], str] = {}  # (id, attr) -> key
        self._mod_globals: Dict[Tuple[str, ...], Set[str]] = {}
        self._mod_tracked: Dict[Tuple[str, ...], Dict[str, str]] = {}

        for mod in self.analysis.mods.values():
            for cls in mod.classes.values():
                assigned = self._assigned.setdefault(id(cls), set())
                sync = self._sync.setdefault(id(cls), set())
                for node in ast.walk(cls.node):
                    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                        continue
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for tgt in targets:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        assigned.add(tgt.attr)
                        if isinstance(node.value, ast.Call):
                            name = dotted_name(node.value.func) or ""
                            tail = name.rsplit(".", 1)[-1]
                            if tail in _SYNC_TAILS:
                                sync.add(tgt.attr)
                            elif tail in _TRACKED_FACTORIES:
                                lit = WholeProgramLockAnalysis._literal_arg(
                                    node.value)
                                if lit:
                                    self._tracked[(id(cls), tgt.attr)] = lit
                # sync objects published through a local
                # (``t = Thread(...); self._thread = t``)
                for meth in cls.methods.values():
                    local_sync: Set[str] = set()
                    for node in ast.walk(meth.node):
                        if not (isinstance(node, ast.Assign)
                                and isinstance(node.value, ast.Call)):
                            continue
                        name = dotted_name(node.value.func) or ""
                        if name.rsplit(".", 1)[-1] not in _SYNC_TAILS:
                            continue
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                local_sync.add(tgt.id)
                    if not local_sync:
                        continue
                    for node in ast.walk(meth.node):
                        if not (isinstance(node, ast.Assign)
                                and isinstance(node.value, ast.Name)
                                and node.value.id in local_sync):
                            continue
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Attribute) \
                                    and isinstance(tgt.value, ast.Name) \
                                    and tgt.value.id == "self":
                                sync.add(tgt.attr)
                sync.update(cls.attr_locks)
                sync.update(cls.attr_conds)

            # module-level mutable globals: container literals, tracked
            # factories, and scalars rebound via `global` in some unit
            names: Set[str] = set()
            tracked: Dict[str, str] = {}
            global_decls: Set[str] = set()
            for u in list(mod.funcs.values()) + [
                    m for c in mod.classes.values() for m in c.methods.values()]:
                for node in ast.walk(u.node):
                    if isinstance(node, ast.Global):
                        global_decls.update(node.names)
            for node in mod.pm.tree.body:
                tgt_name = None
                value = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    tgt_name, value = node.targets[0].id, node.value
                elif isinstance(node, ast.AnnAssign) \
                        and isinstance(node.target, ast.Name):
                    tgt_name, value = node.target.id, node.value
                if tgt_name is None:
                    continue
                if _ALL_CAPS_RE.match(tgt_name) \
                        or (tgt_name.startswith("__")
                            and tgt_name.endswith("__")) \
                        or tgt_name in mod.mod_locks \
                        or tgt_name in mod.mod_conds \
                        or tgt_name in mod.tables:
                    continue
                is_container = isinstance(value, (
                    ast.Dict, ast.DictComp, ast.List, ast.ListComp,
                    ast.Set, ast.SetComp))
                if isinstance(value, ast.Call):
                    tail = (dotted_name(value.func) or "").rsplit(".", 1)[-1]
                    if tail in {"deque", "defaultdict", "OrderedDict",
                                "Counter"}:
                        is_container = True
                    elif tail in _TRACKED_FACTORIES:
                        lit = WholeProgramLockAnalysis._literal_arg(value)
                        if lit:
                            is_container = True
                            tracked[tgt_name] = lit
                if is_container or tgt_name in global_decls:
                    names.add(tgt_name)
            self._mod_globals[mod.parts] = names
            self._mod_tracked[mod.parts] = tracked

    def _canon(self, owner, attr: str) -> str:
        """Canonical key for an attribute access — declared-tracked
        literal if present, else ``stem.Class.attr`` on the DECLARING
        class (first in the MRO chain that assigns it)."""
        if isinstance(owner, _Mod):
            lit = self._mod_tracked.get(owner.parts, {}).get(attr)
            return lit or f"{owner.stem}.{attr}"
        for c in self.analysis._cls_chain(owner):
            if attr in self._assigned.get(id(c), ()):
                lit = self._tracked.get((id(c), attr))
                return lit or f"{c.mod.stem}.{c.name}.{attr}"
        return f"{owner.mod.stem}.{owner.name}.{attr}"

    def _is_exempt_attr(self, owner, attr: str) -> bool:
        if attr.startswith("__") and attr.endswith("__"):
            return True
        if isinstance(owner, _Mod):
            return False
        for c in self.analysis._cls_chain(owner):
            if attr in self._sync.get(id(c), ()):
                return True
            if attr in c.methods:
                return True
        return False

    def _owner_locks(self, owner) -> Dict[str, str]:
        """lockname -> lock key candidates of the owning class/module."""
        out: Dict[str, str] = {}
        if isinstance(owner, _Mod):
            for name, key in owner.mod_locks.items():
                out.setdefault(name, key)
            for name, key in owner.mod_conds.items():
                out.setdefault(name, key)
            return out
        for c in self.analysis._cls_chain(owner):
            for name, key in c.attr_locks.items():
                out.setdefault(name, key)
            for name, key in c.attr_conds.items():
                out.setdefault(name, key)
        return out

    _CTOR_NAMES = frozenset({
        "__init__", "__new__", "__setstate__", "__post_init__"})

    def _ctor_only(self, unit: _Unit, _depth: int = 0) -> bool:
        """True when ``unit`` runs only on the construction path: it IS a
        constructor-family method, or every call site (per the shared
        call graph) is a ctor-only method of the same class. Writes there
        happen-before the object is published to other threads, exactly
        like writes lexically inside ``__init__``."""
        if unit.cls is None:
            return False
        if unit.qual.rsplit(".", 1)[-1] in self._CTOR_NAMES:
            return True
        if _depth >= 3:
            return False
        sites = self.analysis.callers.get(unit)
        if not sites:
            return False
        return all(caller.cls is unit.cls
                   and self._ctor_only(caller, _depth + 1)
                   for caller, _held in sites)

    # -- local typing (light version of lock_order's prescan) ------------

    def _local_types(self, unit: _Unit) -> Dict[str, _Class]:
        lt: Dict[str, _Class] = {}
        args = getattr(unit.node, "args", None)
        if args is not None:
            for a in (list(getattr(args, "posonlyargs", []))
                      + list(args.args) + list(args.kwonlyargs)):
                if a.annotation is None:
                    continue
                for name in WholeProgramLockAnalysis._ann_names(a.annotation):
                    c = self.analysis._class_by_name(name, unit.mod)
                    if c is not None:
                        lt.setdefault(a.arg, c)
                        break
        for node in ast.walk(unit.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                ctor = dotted_name(node.value.func)
                if ctor:
                    c = self.analysis._class_by_name(ctor, unit.mod)
                    if c is not None:
                        lt.setdefault(node.targets[0].id, c)
        return lt

    # -- thread-entry roots ----------------------------------------------

    def _is_threading(self, name: str, mod: _Mod) -> bool:
        head = name.split(".", 1)[0]
        if head in {"threading", "_threading"}:
            return True
        ali = mod.aliases.get(head)
        if ali is None:
            return False
        if ali[0] == "mod" and ali[1][:1] == ("threading",):
            return True
        if ali[0] == "from" and ali[1][:1] == ("threading",):
            return True
        return False

    def _callable_targets(self, expr: Optional[ast.AST], unit: _Unit,
                          lt: Dict[str, _Class]) -> List[_Unit]:
        if expr is None:
            return []
        if isinstance(expr, ast.Lambda):
            out: List[_Unit] = []
            for node in ast.walk(expr.body):
                if isinstance(node, ast.Call):
                    out.extend(self.analysis.resolve_call(node, unit, lt))
            return out
        if isinstance(expr, ast.Call):
            tail = (dotted_name(expr.func) or "").rsplit(".", 1)[-1]
            if tail == "partial" and expr.args:
                return self._callable_targets(expr.args[0], unit, lt)
            return []
        return self.analysis._resolve_callable_ref(expr, unit)

    def _spawn_targets(self, call: ast.Call, unit: _Unit,
                       lt: Dict[str, _Class]) -> List[_Unit]:
        f = call.func
        name = dotted_name(f) or ""
        tail = name.rsplit(".", 1)[-1]
        kws = {k.arg: k.value for k in call.keywords if k.arg}
        if tail == "Thread" and self._is_threading(name, unit.mod):
            return self._callable_targets(kws.get("target"), unit, lt)
        if tail == "Timer" and self._is_threading(name, unit.mod):
            fn = kws.get("function") or (
                call.args[1] if len(call.args) > 1 else None)
            return self._callable_targets(fn, unit, lt)
        if not isinstance(f, ast.Attribute):
            return []
        if f.attr == "submit" and call.args:
            return self._callable_targets(call.args[0], unit, lt)
        if f.attr == "_schedule_leader_task" and len(call.args) >= 3:
            return self._callable_targets(call.args[2], unit, lt)
        if f.attr == "add_done_callback" and call.args:
            return self._callable_targets(call.args[0], unit, lt)
        if f.attr == "register" and len(call.args) >= 2 \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return self._callable_targets(call.args[1], unit, lt)
        return []

    def _scan_roots(self) -> Dict[int, Tuple[_Unit, bool]]:
        """unit id -> (unit, self-concurrent?) for every thread-entry
        root. Self-concurrent: spawned inside a loop or from >= 2 sites."""
        roots: Dict[int, Tuple[_Unit, bool]] = {}

        def add(targets: List[_Unit], multi: bool) -> None:
            for t in targets:
                prev = roots.get(id(t))
                # a second spawn site makes the root self-concurrent
                roots[id(t)] = (t, multi if prev is None else True)

        for u in self.analysis._units:
            lt = self._local_types(u)

            def walk(node: ast.AST, in_loop: bool) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        continue
                    child_loop = in_loop or isinstance(
                        child, (ast.For, ast.AsyncFor, ast.While))
                    if isinstance(child, ast.Call):
                        targets = self._spawn_targets(child, u, lt)
                        if targets:
                            add(targets, child_loop)
                    walk(child, child_loop)

            walk(u.node, False)

        # socketserver request handlers: a ThreadingTCPServer runs
        # Handler.handle on a fresh thread per accepted connection.
        # Handler classes nested inside functions are not call-graph
        # units, so root what their method bodies call instead —
        # uniquely-named methods (deny-listed protocol names excluded)
        # and same-module functions.
        for mod in self.analysis.mods.values():
            for node in ast.walk(mod.pm.tree):
                if not isinstance(node, ast.ClassDef) or not any(
                        (dotted_name(b) or "").rsplit(".", 1)[-1]
                        .endswith("RequestHandler") for b in node.bases):
                    continue
                for sub in node.body:
                    if not isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                        continue
                    for call in ast.walk(sub):
                        if not isinstance(call, ast.Call):
                            continue
                        f = call.func
                        if isinstance(f, ast.Attribute):
                            if f.attr in _FALLBACK_DENY:
                                continue
                            cands = self.analysis._method_index.get(
                                f.attr, [])
                            if len(cands) == 1:
                                add(cands, True)
                        elif isinstance(f, ast.Name):
                            u2 = mod.funcs.get(f.id)
                            if u2 is not None:
                                add([u2], True)
        return roots

    # -- access walk -----------------------------------------------------

    def _attr_access_owner(self, attr_node: ast.Attribute, unit: _Unit,
                           lt: Dict[str, _Class]):
        """(owner, is_self) for ``<base>.<attr>`` — owner is a _Class, a
        _Mod (module-global via alias), or None when unresolvable."""
        base = attr_node.value
        cls, mod = unit.cls, unit.mod
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                return cls, True
            t = lt.get(base.id)
            if t is not None:
                return t, False
            m2 = self.analysis._module_of_alias(mod, base.id)
            if m2 is not None and attr_node.attr in self._mod_globals.get(
                    m2.parts, ()):
                return m2, False
        elif isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and cls is not None:
            t = self.analysis._attr_type(cls, base.attr)
            if t is not None:
                return t, False
        return None, False

    def _walk_unit(self, unit: _Unit, record) -> None:
        lt = self._local_types(unit)
        mod = unit.mod
        globals_declared = {
            n for node in ast.walk(unit.node)
            if isinstance(node, ast.Global) for n in node.names
        }
        mod_names = self._mod_globals.get(mod.parts, set())

        def rec_attr(attr_node: ast.Attribute, lineno: int,
                     held: Tuple[str, ...], kind: str) -> None:
            owner, is_self = self._attr_access_owner(attr_node, unit, lt)
            if owner is None:
                # guarded-by stays name-based: the annotation is
                # authoritative wherever the attr name appears, even on
                # receivers the light typing cannot resolve
                if attr_node.attr in self.guarded and kind != "read":
                    key = dotted_name(attr_node) or attr_node.attr
                    record(_Access(key, None, attr_node.attr, unit,
                                   lineno, held, kind, False))
                return
            if self._is_exempt_attr(owner, attr_node.attr):
                return
            key = self._canon(owner, attr_node.attr)
            record(_Access(key, owner, attr_node.attr, unit, lineno, held,
                           kind, is_self))

        def rec_global(name: str, lineno: int, held: Tuple[str, ...],
                       kind: str) -> None:
            key = self._mod_tracked.get(mod.parts, {}).get(name) \
                or f"{mod.stem}.{name}"
            record(_Access(key, mod, name, unit, lineno, held, kind, False))

        def handle_target(t: ast.AST, kind: str, lineno: int,
                          held: Tuple[str, ...]) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    handle_target(e, kind, lineno, held)
                return
            attr = _base_attribute(t)
            if attr is not None:
                rec_attr(attr, lineno, held, kind)
                return
            nm = _base_name(t)
            if nm is None:
                return
            if isinstance(t, ast.Subscript):
                # item assignment mutates the container, no `global` needed
                if nm.id in mod_names:
                    rec_global(nm.id, lineno, held, kind)
            elif nm.id in mod_names and nm.id in globals_declared:
                rec_global(nm.id, lineno, held, kind)

        def resolve_with(expr: ast.AST) -> Optional[str]:
            key = self.analysis.resolve_lock_expr(expr, unit, lt)
            if key is not None:
                return key
            if isinstance(expr, ast.Attribute):
                return "?" + expr.attr
            if isinstance(expr, ast.Name):
                return "?" + expr.id
            return None

        def block(nodes, held: Tuple[str, ...]) -> None:
            for node in nodes:
                if node is None or isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    continue
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    nh = held
                    for item in node.items:
                        block([item.context_expr], nh)
                        k = resolve_with(item.context_expr)
                        if k is not None and k not in nh:
                            nh = nh + (k,)
                    block(node.body, nh)
                    continue
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        handle_target(t, "write", node.lineno, held)
                elif isinstance(node, ast.AugAssign):
                    handle_target(node.target, "rmw", node.lineno, held)
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    handle_target(node.target, "write", node.lineno, held)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        handle_target(t, "del", node.lineno, held)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATING_METHODS \
                        and not self.analysis.resolve_call(node, unit, lt):
                    # a receiver whose class defines this method is a
                    # CALL (the graph walks into it), not a container
                    # mutation — `self.periodic_dispatcher.add(job)`
                    recv = node.func.value
                    if isinstance(recv, ast.Attribute):
                        rec_attr(recv, node.lineno, held, "mutate")
                    elif isinstance(recv, ast.Name) \
                            and recv.id in mod_names:
                        rec_global(recv.id, node.lineno, held, "mutate")
                elif isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load):
                    rec_attr(node, node.lineno, held, "read")
                elif isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in mod_names:
                    rec_global(node.id, node.lineno, held, "read")
                block(ast.iter_child_nodes(node), held)

        block(ast.iter_child_nodes(unit.node), ())

    # -- the analysis ----------------------------------------------------

    def _compute(self) -> List[Finding]:
        if self._findings is not None:
            return self._findings
        an = self.analysis
        an.analyze()
        self._prepass()

        # roots + reachability
        roots = self._scan_roots()
        ordered_roots = sorted(roots.values(), key=lambda rm: rm[0].qual)
        self.root_inventory = {u.qual: multi for u, multi in ordered_roots}
        unit_roots: Dict[int, Set[int]] = {}
        multi_idx: Set[int] = set()
        for idx, (r, multi) in enumerate(ordered_roots):
            if multi:
                multi_idx.add(idx)
            stack, seen = [r], {id(r)}
            while stack:
                u = stack.pop()
                unit_roots.setdefault(id(u), set()).add(idx)
                for targets, _ln, _held in u.calls:
                    for t in targets:
                        if id(t) not in seen:
                            seen.add(id(t))
                            stack.append(t)

        # all accesses
        accesses: List[_Access] = []
        for u in an._units:
            self._walk_unit(u, accesses.append)

        # sharing inference
        key_roots: Dict[str, Set[int]] = {}
        key_root_names: Dict[str, Set[str]] = {}
        for a in accesses:
            rs = unit_roots.get(id(a.unit))
            if not rs:
                continue
            key_roots.setdefault(a.key, set()).update(rs)
            names = key_root_names.setdefault(a.key, set())
            for i in rs:
                names.add(ordered_roots[i][0].qual)
        shared: Set[str] = set()
        for key, rs in key_roots.items():
            if len(rs) >= 2 or (rs and rs & multi_idx):
                shared.add(key)
        # guarded-by declarations are shared by fiat
        for a in accesses:
            if a.attr in self.guarded and a.key not in shared:
                shared.add(a.key)
        self.shared_keys = shared

        findings: List[Finding] = []
        used_race_ok: Set[Tuple[str, int]] = set()

        def suppressed(rel: str, lineno: int, pending: Finding) -> bool:
            reason = self._race_ok.get((rel, lineno))
            if reason is None:
                return False
            used_race_ok.add((rel, lineno))
            if not reason:
                findings.append(Finding(
                    RULE, rel, lineno,
                    "'# race-ok' suppression needs a reason "
                    "(e.g. '# race-ok: single writer, torn reads benign')"))
            return True

        def held_names(held: Tuple[str, ...]) -> Set[str]:
            out = set()
            for h in held:
                out.add(h[1:] if h.startswith("?") else h.rsplit(".", 1)[-1])
            return out

        for a in accesses:
            if a.kind == "read":
                continue
            rel = a.unit.mod.pm.rel
            lex_names = held_names(a.held)
            resolved_held = tuple(h for h in a.held if not h.startswith("?"))
            # 1) guarded-by annotations: authoritative, name-based, and
            #    enforced whether or not a root reaches the write
            if a.attr in self.guarded:
                is_decl_scope = a.is_self and a.unit.cls is not None and (
                    rel, a.unit.cls.name, a.attr) in self.declaring
                if a.is_self and not is_decl_scope:
                    continue  # an unrelated class's same-named attr
                if (rel, a.lineno) in self.decl_lines:
                    continue  # the annotated declaration itself
                lock = self.guarded[a.attr]
                ok = lock in lex_names
                if not ok and not isinstance(a.owner, _Mod):
                    lock_key = self.analysis._attr_lock_key(a.owner, lock) \
                        if isinstance(a.owner, _Class) else None
                    if lock_key is not None:
                        ok = self.analysis.notify_held(
                            a.unit, lock_key, resolved_held)
                if not ok:
                    f = Finding(
                        RULE, rel, a.lineno,
                        f"write to '{a.key}' (guarded-by {lock}) outside "
                        f"a 'with ....{lock}:' block")
                    if not suppressed(rel, a.lineno, f):
                        findings.append(f)
                continue
            # 2) inferred sharing: only for attrs of lock-owning classes
            if a.key not in shared:
                continue
            locks = self._owner_locks(a.owner)
            if not locks:
                continue  # lockless data object: runtime witness territory
            if a.is_self and self._ctor_only(a.unit):
                continue  # construction (incl. unpickle) happens-before
                # the object is published to other threads; covers
                # ctor-path helpers (__init__ -> _load_persistent)
            ok = any(k in resolved_held for k in locks.values()) \
                or any(n in lex_names for n in locks) \
                or any(self.analysis.notify_held(a.unit, k, resolved_held)
                       for k in locks.values())
            if ok:
                continue
            rnames = sorted(key_root_names.get(a.key, ()))
            rdesc = ", ".join(rnames[:3]) + (
                f" +{len(rnames) - 3} more" if len(rnames) > 3 else "")
            ldesc = " or ".join(sorted(set(locks.values())))
            f = Finding(
                RULE, rel, a.lineno,
                f"unguarded {a.kind} to shared state '{a.key}' in "
                f"{a.unit.qual} (reachable from concurrent roots: {rdesc}); "
                f"hold {ldesc}, use a *_locked helper, or annotate "
                f"'# race-ok: <reason>'")
            if not suppressed(rel, a.lineno, f):
                findings.append(f)

        # 3) the ratchet: a race-ok that suppresses nothing is stale
        for (rel, lineno), _reason in sorted(self._race_ok.items()):
            if (rel, lineno) not in used_race_ok:
                findings.append(Finding(
                    RULE, rel, lineno,
                    "stale '# race-ok' suppression: no shared-state "
                    "finding is suppressed on this line"))

        # one finding per (file, line, message): the walker can reach the
        # same write through e.g. tuple targets
        seen_f: Set[Tuple[str, int, str]] = set()
        deduped: List[Finding] = []
        for f in sorted(findings, key=lambda f: (f.file, f.line, f.message)):
            k = (f.file, f.line, f.message)
            if k not in seen_f:
                seen_f.add(k)
                deduped.append(f)
        self._findings = deduped
        return deduped

    def check(self, module: ParsedModule) -> List[Finding]:
        return [f for f in self._compute() if f.file == module.rel]


# -- the witness cross-check entry point ------------------------------------

_STATIC_CACHE: Dict[str, Set[str]] = {}


def build_static_shared(root: Optional[str] = None) -> Set[str]:
    """Whole-tree inferred-shared key set, for the race witness's
    teardown cross-check. ``root`` defaults to the port's own package
    (``nomad_tpu_torch``); results are cached per root."""
    from .core import iter_py_files, parse_file

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(root)
    cached = _STATIC_CACHE.get(root)
    if cached is not None:
        return cached
    checker = SharedStateDisciplineChecker()
    base = os.path.dirname(root)
    for path in iter_py_files([root]):
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        pm, _err = parse_file(path, rel)
        if pm is not None:
            checker.collect(pm)
    checker._compute()
    keys = set(checker.shared_keys)
    _STATIC_CACHE[root] = keys
    return keys
