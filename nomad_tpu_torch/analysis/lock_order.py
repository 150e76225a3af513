"""lock-order: whole-program lock acquisition-order analysis.

nomad-lockdep's static side. The pass:

1. **Inventories** every lock/condition creation site — plain
   ``threading.Lock()/RLock()/Condition()`` assignments and the witness
   factories (``witness_lock``/``witness_rlock``/``witness_condition``
   from ``nomad_tpu_torch/utils/lock_witness.py``). Locks are keyed
   ``module.Class._lockname`` (``module._lockname`` at module level);
   witness factory calls contribute their literal name argument, which
   is what keeps the static keys and the runtime witness keys identical
   by construction. Conditions are normalized to the lock they wrap
   (``threading.Condition(self._lock)`` — acquiring the condition IS
   acquiring the lock).

2. Builds a **conservative name-based interprocedural call graph**
   (shared with ``condition-discipline`` and
   ``shared-state-discipline`` — one instance per lint run): ``self.m()``
   resolves through the class (and by-name base classes), ``self.a.m()``
   and local ``x = ClassName(...); x.m()`` resolve through recorded
   constructor types, module aliases resolve through (relative) imports,
   and as a last resort a bare method name resolves to every definition
   of that name when there are at most ``_FALLBACK_CAP`` of them. Two
   first-class-function idioms the repo leans on are resolved
   explicitly, because the raft -> FSM -> store path flows through both:
   module-level **dispatch tables** (``_DISPATCH = {KEY: Cls.handler}``;
   a call through ``_DISPATCH[k]`` or a local bound from
   ``_DISPATCH.get(k)`` fans out to every table entry) and **callback
   attributes** (``self.fsm.on_x = self.blocked.m`` recorded globally by
   attribute name; ``self.on_x(...)`` where ``on_x`` is not a method
   resolves to every recorded assignment).

3. **Walks** ``with <lock>:`` nesting through calls: every unit gets a
   lexical summary (acquisitions, calls, each with the lexically-held
   key set at the site), then held sets propagate through the call graph
   from every unit (memoized on (unit, held-set)). Acquiring B while A
   is held emits the order edge ``A -> B`` with the first call chain
   that produced it.

4. Reports every **strongly connected component** of the edge graph as
   a potential deadlock, with both acquisition chains in the message.
   Messages carry files + call chains but no line numbers, so baseline
   entries survive unrelated drift.

``build_static_graph()`` exposes the edge set to the runtime witness's
teardown cross-check: every witnessed edge must be present here, which
makes a witness-armed stress run a soundness test for this pass.

Thread/timer targets (``threading.Thread(target=f)``) are deliberately
NOT walked inline — the callee runs on a fresh thread with an empty
held set, so no order edge crosses a spawn.

Copied from ``nomad_tpu/analysis/lock_order.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``: module names are keyed on the
port's package (``_PKG``), and ``build_static_graph`` defaults to the
port's tree.
"""
from __future__ import annotations

import ast
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import Finding, ParsedModule, dotted_name

RULE = "lock-order"

# the package whose name is dropped from module keys, so that a lock's
# static key matches the literal name its witness factory records
_PKG = "nomad_tpu_torch"

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_COND_CTORS = {"threading.Condition"}
_FACTORY_LOCKS = {"witness_lock", "witness_rlock",
                  "module_witness_lock", "module_witness_rlock"}
_FACTORY_CONDS = {"witness_condition"}
_FALLBACK_CAP = 3
_MAX_DEPTH = 14

# Bare-name fallback is OFF for names that collide with dict/list/set/IO/
# socket/threading protocol methods: `buf.write(...)` or `d.update(...)`
# on an unresolvable base is overwhelmingly a stdlib object, and resolving
# it to a same-named repo method manufactures wild cross-subsystem call
# chains (a dict.update inside the metrics sink must not "call" the HTTP
# client's update()).
_FALLBACK_DENY = frozenset({
    "update", "get", "put", "pop", "append", "extend", "insert", "add",
    "remove", "discard", "clear", "copy", "keys", "values", "items",
    "setdefault", "sort", "index", "count", "reverse",
    "write", "writelines", "read", "readline", "readlines", "flush",
    "close", "open", "seek", "tell",
    "recv", "send", "sendall", "connect", "accept", "bind", "listen",
    "join", "start", "run", "stop", "cancel", "set", "is_set",
    "acquire", "release", "locked", "wait", "notify", "notify_all",
    "result", "done", "submit", "shutdown",
    "encode", "decode", "strip", "split", "format", "replace",
})


def _modparts(rel: str) -> Tuple[str, ...]:
    parts = rel.replace("\\", "/").split("/")
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[0] == _PKG:
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return tuple(p for p in parts if p)


class _Class:
    def __init__(self, name: str, mod: "_Mod", node: ast.ClassDef) -> None:
        self.name = name
        self.mod = mod
        self.node = node
        self.bases: List[str] = [
            b for b in (dotted_name(x) for x in node.bases) if b
        ]
        self.methods: Dict[str, "_Unit"] = {}
        self.attr_locks: Dict[str, str] = {}   # attr -> lock key
        self.attr_conds: Dict[str, str] = {}   # attr -> lock key it wraps
        self.attr_types: Dict[str, str] = {}   # attr -> dotted ctor name


class _Unit:
    __slots__ = ("qual", "node", "mod", "cls", "acquires", "calls",
                 "notifies", "waits", "scanned")

    def __init__(self, qual: str, node: ast.AST, mod: "_Mod",
                 cls: Optional[_Class]) -> None:
        self.qual = qual
        self.node = node
        self.mod = mod
        self.cls = cls
        # lexical summaries, filled by _scan_unit:
        self.acquires: List[Tuple[str, int, Tuple[str, ...]]] = []
        self.calls: List[Tuple[List["_Unit"], int, Tuple[str, ...]]] = []
        self.notifies: List[Tuple[str, str, int, Tuple[str, ...]]] = []
        self.waits: List[Tuple[str, int, bool, bool]] = []
        self.scanned = False


class _Mod:
    def __init__(self, pm: ParsedModule) -> None:
        self.pm = pm
        self.parts = _modparts(pm.rel)
        self.stem = self.parts[-1] if self.parts else pm.rel
        self.funcs: Dict[str, _Unit] = {}
        self.classes: Dict[str, _Class] = {}
        self.mod_locks: Dict[str, str] = {}
        self.mod_conds: Dict[str, str] = {}
        # dispatch tables: name -> dotted callable refs from the dict literal
        self.tables: Dict[str, List[str]] = {}
        # alias -> ("mod", parts) | ("sym", parts, symbol) | ("ext", dotted)
        self.aliases: Dict[str, Tuple] = {}


class WholeProgramLockAnalysis:
    """Shared engine for the lock-order and condition-discipline rules."""

    def __init__(self) -> None:
        self.mods: Dict[Tuple[str, ...], _Mod] = {}
        self._units: List[_Unit] = []
        self._method_index: Dict[str, List[_Unit]] = {}
        self._class_index: Dict[str, List[_Class]] = {}
        self._cond_attr_names: Set[str] = set()
        self._analyzed = False
        # edge -> (file, line, chain string)
        self.edge_sites: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.graph: Dict[str, Set[str]] = {}
        # reverse call index: unit -> [(caller unit, lexical held at site)]
        self.callers: Dict[_Unit, List[Tuple[_Unit, Tuple[str, ...]]]] = {}
        # callback registry: attr name -> every unit ever assigned to it
        self.callback_attrs: Dict[str, List[_Unit]] = {}
        # wall time of the one-shot analyze() build, for --json timings
        self.analyze_wall_s = 0.0

    # -- collect ---------------------------------------------------------

    def add_module(self, pm: ParsedModule) -> None:
        mod = _Mod(pm)
        if mod.parts in self.mods:
            return
        self.mods[mod.parts] = mod
        self._collect_aliases(mod)
        self._collect_defs(mod)

    def _collect_aliases(self, mod: _Mod) -> None:
        pkg = mod.parts[:-1]
        for node in ast.walk(mod.pm.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    parts = tuple(a.name.split("."))
                    if parts and parts[0] == _PKG:
                        parts = parts[1:]
                    mod.aliases[a.asname or a.name.split(".")[0]] = (
                        ("mod", parts) if a.asname else ("mod", parts[:1])
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0:
                    base = tuple((node.module or "").split("."))
                    if base and base[0] == _PKG:
                        base = base[1:]
                elif node.level - 1 <= len(pkg):
                    up = len(pkg) - (node.level - 1)
                    base = pkg[:up] + tuple(
                        (node.module or "").split(".") if node.module else ()
                    )
                else:
                    continue
                base = tuple(p for p in base if p)
                for a in node.names:
                    if a.name == "*":
                        continue
                    # the name may be a submodule OR a symbol; record both
                    mod.aliases[a.asname or a.name] = ("from", base, a.name)

    def _collect_defs(self, mod: _Mod) -> None:
        for node in mod.pm.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                u = _Unit(f"{mod.stem}.{node.name}", node, mod, None)
                mod.funcs[node.name] = u
                self._units.append(u)
            elif isinstance(node, ast.ClassDef):
                cls = _Class(node.name, mod, node)
                mod.classes[node.name] = cls
                self._class_index.setdefault(node.name, []).append(cls)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        u = _Unit(f"{mod.stem}.{cls.name}.{sub.name}",
                                  sub, mod, cls)
                        cls.methods[sub.name] = u
                        self._units.append(u)
                        self._method_index.setdefault(sub.name, []).append(u)
                self._collect_class_attrs(mod, cls)
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)) or \
                    (isinstance(node, ast.AnnAssign)
                     and isinstance(node.target, ast.Name)
                     and node.value is not None):
                if isinstance(node, ast.Assign):
                    name = node.targets[0].id
                else:
                    name = node.target.id
                if isinstance(node.value, ast.Dict):
                    refs = [r for r in (dotted_name(v) for v in node.value.values
                                        if v is not None) if r]
                    if refs:
                        mod.tables[name] = refs
                    continue
                kind = self._ctor_kind(node.value, mod)
                if kind is None:
                    continue
                what, key = kind
                key = key or f"{mod.stem}.{name}"
                if what == "lock":
                    mod.mod_locks[name] = key
                elif what == "cond":
                    lk = self._cond_lock_arg(node.value, mod, None)
                    mod.mod_conds[name] = lk or key
                    mod.mod_locks.setdefault(name, lk or key)

    @staticmethod
    def _ann_names(annotation: ast.AST) -> List[str]:
        """Candidate class names inside a type annotation — ``NomadFSM``,
        ``Optional[NomadFSM]``, ``List[NomadFSM]``, ``"NomadFSM"``."""
        names: List[str] = []
        for n in ast.walk(annotation):
            if isinstance(n, ast.Name) and n.id[:1].isupper() \
                    and n.id not in {"Optional", "List", "Dict", "Tuple",
                                     "Set", "Sequence", "Iterable",
                                     "Callable", "Union", "Any", "Type"}:
                names.append(n.id)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and n.value[:1].isupper():
                names.append(n.value.rsplit(".", 1)[-1])
        return names

    def _collect_class_attrs(self, mod: _Mod, cls: _Class) -> None:
        # class-wide param -> annotated-class map, so `self.state = state`
        # (and `state or StateStore()`) types the attribute from the
        # parameter annotation
        param_anns: Dict[str, str] = {}
        for fn in ast.walk(cls.node):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for a in (list(getattr(fn.args, "posonlyargs", []))
                      + list(fn.args.args) + list(fn.args.kwonlyargs)):
                if a.annotation is None:
                    continue
                for name in self._ann_names(a.annotation):
                    param_anns.setdefault(a.arg, name)
                    break
        for node in ast.walk(cls.node):
            if isinstance(node, ast.AnnAssign):
                tgt = node.target
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    for name in self._ann_names(node.annotation):
                        cls.attr_types.setdefault(tgt.attr, name)
                        break
                continue
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            attr = tgt.attr
            kind = self._ctor_kind(node.value, mod)
            if kind is not None:
                what, key = kind
                key = key or f"{mod.stem}.{cls.name}.{attr}"
                if what == "lock":
                    cls.attr_locks.setdefault(attr, key)
                else:
                    lk = self._cond_lock_arg(node.value, mod, cls)
                    cls.attr_conds.setdefault(attr, lk or key)
                    if lk is None:
                        cls.attr_locks.setdefault(attr, key)
                    self._cond_attr_names.add(attr)
                continue
            # typed attribute: self.x = ClassName(...), self.x = param,
            # self.x = param or ClassName(...)
            vals = (node.value.values if isinstance(node.value, ast.BoolOp)
                    else [node.value])
            for v in vals:
                if isinstance(v, ast.Call):
                    ctor = dotted_name(v.func)
                    if ctor and (ctor[:1].isupper() or ("." in ctor and
                            ctor.rsplit(".", 1)[-1][:1].isupper())):
                        cls.attr_types.setdefault(attr, ctor)
                        break
                elif isinstance(v, ast.Name) and v.id in param_anns:
                    cls.attr_types.setdefault(attr, param_anns[v.id])
                    break

    def _ctor_kind(self, value: ast.AST, mod: _Mod
                   ) -> Optional[Tuple[str, Optional[str]]]:
        """('lock'|'cond', explicit key or None) for a lock-creating
        expression, else None."""
        if not isinstance(value, ast.Call):
            return None
        name = dotted_name(value.func) or ""
        tail = name.rsplit(".", 1)[-1]
        # de-alias the head for threading-as-_threading style imports
        head = name.split(".", 1)[0]
        ali = mod.aliases.get(head)
        if ali and ali[0] == "mod" and ali[1] == ("threading",):
            name = "threading." + name.split(".", 1)[1] if "." in name else name
        if name in _LOCK_CTORS or (
                tail in {"Lock", "RLock"} and head in {"threading", "_threading"}):
            return ("lock", None)
        if name in _COND_CTORS or (
                tail == "Condition" and head in {"threading", "_threading"}):
            return ("cond", None)
        if tail in _FACTORY_LOCKS:
            return ("lock", self._literal_arg(value))
        if tail in _FACTORY_CONDS:
            return ("cond", self._literal_arg(value))
        return None

    @staticmethod
    def _literal_arg(call: ast.Call) -> Optional[str]:
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return call.args[0].value
        return None

    def _cond_lock_arg(self, call: ast.Call, mod: _Mod,
                       cls: Optional[_Class]) -> Optional[str]:
        """The lock key a Condition(...) wraps, resolved lazily by attr
        name: ``Condition(self._lock)`` -> the class's ``_lock`` key."""
        args = list(call.args)
        name = dotted_name(call.func) or ""
        if name.rsplit(".", 1)[-1] in _FACTORY_CONDS and args:
            args = args[1:]  # first arg is the witness name literal
        if not args:
            return None
        a = args[0]
        if isinstance(a, ast.Attribute) and isinstance(a.value, ast.Name) \
                and a.value.id == "self" and cls is not None:
            # the lock attr may not be collected yet; derive its key the
            # same way the collector will
            return cls.attr_locks.get(
                a.attr, f"{mod.stem}.{cls.name}.{a.attr}")
        if isinstance(a, ast.Name):
            return mod.mod_locks.get(a.id, f"{mod.stem}.{a.id}")
        return None

    # -- resolution ------------------------------------------------------

    def _class_by_name(self, dotted: str, mod: _Mod) -> Optional[_Class]:
        """Resolve a constructor name to a collected class: module-local,
        imported (aliased), or globally unique by simple name."""
        head, _, rest = dotted.partition(".")
        if not rest and head in mod.classes:
            return mod.classes[head]
        ali = mod.aliases.get(head)
        if ali is not None:
            if ali[0] == "from" and not rest:
                # `from .x import ClassName`
                target = self.mods.get(ali[1] + (ali[2],))
                if target is None:
                    target = self.mods.get(ali[1])
                    if target is not None:
                        if ali[2] in target.classes:
                            return target.classes[ali[2]]
                        # package re-export (`from ..state import
                        # StateStore` through state/__init__): follow the
                        # __init__'s own alias one hop
                        ali2 = target.aliases.get(ali[2])
                        if ali2 is not None and ali2[0] == "from":
                            t2 = self.mods.get(ali2[1])
                            if t2 is not None and ali2[2] in t2.classes:
                                return t2.classes[ali2[2]]
                            t2 = self.mods.get(ali2[1] + (ali2[2],))
                            if t2 is not None and ali2[2] in t2.classes:
                                return t2.classes[ali2[2]]
            if ali[0] == "from" and rest:
                # `from . import x` then `x.ClassName(...)`
                target = self.mods.get(ali[1] + (ali[2],))
                if target is not None and rest in target.classes:
                    return target.classes[rest]
            if ali[0] == "mod" and rest:
                target = self.mods.get(ali[1])
                if target is not None and rest in target.classes:
                    return target.classes[rest]
        cands = self._class_index.get(dotted.rsplit(".", 1)[-1], [])
        if len(cands) == 1:
            return cands[0]
        return None

    def _cls_chain(self, cls: _Class) -> List[_Class]:
        chain, seen = [], set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            chain.append(c)
            for b in c.bases:
                bc = self._class_by_name(b, c.mod)
                if bc is not None:
                    stack.append(bc)
        return chain

    def _attr_lock_key(self, cls: _Class, attr: str,
                       conds_too: bool = True) -> Optional[str]:
        for c in self._cls_chain(cls):
            if attr in c.attr_locks:
                return c.attr_locks[attr]
            if conds_too and attr in c.attr_conds:
                return c.attr_conds[attr]
        return None

    def _attr_type(self, cls: _Class, attr: str) -> Optional[_Class]:
        for c in self._cls_chain(cls):
            t = c.attr_types.get(attr)
            if t is not None:
                return self._class_by_name(t, c.mod)
        return None

    def _module_of_alias(self, mod: _Mod, name: str) -> Optional[_Mod]:
        ali = mod.aliases.get(name)
        if ali is None:
            return None
        if ali[0] == "mod":
            return self.mods.get(ali[1])
        if ali[0] == "from":
            return self.mods.get(ali[1] + (ali[2],))
        return None

    def _table_units(self, mod: _Mod, table: str) -> List[_Unit]:
        """Units named by a dispatch-table literal: ``Cls.method`` refs
        resolve through the class index, bare names through the module."""
        out: List[_Unit] = []
        for ref in mod.tables.get(table, ()):
            head, _, rest = ref.partition(".")
            if rest:
                c = self._class_by_name(head, mod)
                if c is not None:
                    u = c.methods.get(rest.rsplit(".", 1)[-1])
                    if u is not None:
                        out.append(u)
            elif head in mod.funcs:
                out.append(mod.funcs[head])
        return out

    def _resolve_callable_ref(self, value: ast.AST,
                              unit: _Unit) -> List[_Unit]:
        """A non-call reference to a function/bound method — the right
        side of a callback assignment like ``x.on_f = self.broker.m``."""
        mod, cls = unit.mod, unit.cls
        if isinstance(value, ast.Attribute):
            base = value.value
            if isinstance(base, ast.Name) and base.id == "self" \
                    and cls is not None:
                for c in self._cls_chain(cls):
                    if value.attr in c.methods:
                        return [c.methods[value.attr]]
            elif isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and cls is not None:
                t = self._attr_type(cls, base.attr)
                if t is not None:
                    for c in self._cls_chain(t):
                        if value.attr in c.methods:
                            return [c.methods[value.attr]]
        elif isinstance(value, ast.Name) and value.id in mod.funcs:
            return [mod.funcs[value.id]]
        return []

    def _collect_callbacks(self) -> None:
        """Global pass (all modules added, before any unit is scanned):
        every ``<expr>.<attr> = <callable ref>`` assignment registers
        the callee under the ATTRIBUTE NAME, so ``self.<attr>(...)``
        where ``<attr>`` is not a method fans out to every assignment —
        name-based and conservative, like the rest of the resolver."""
        def register(attr: str, value: ast.AST, u: _Unit) -> None:
            targets = self._resolve_callable_ref(value, u)
            if targets:
                reg = self.callback_attrs.setdefault(attr, [])
                for t in targets:
                    if t not in reg:
                        reg.append(t)

        for u in self._units:
            for node in ast.walk(u.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Attribute):
                    register(node.targets[0].attr, node.value, u)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in {"append", "add", "register",
                                               "insert"} \
                        and isinstance(node.func.value, ast.Attribute) \
                        and node.args:
                    # observer lists: x.leadership_observers.append(cb)
                    register(node.func.value.attr, node.args[-1], u)

    def resolve_lock_expr(self, expr: ast.AST, unit: _Unit,
                          local_types: Dict[str, _Class]) -> Optional[str]:
        """Lock key for a ``with``-context / condition expression."""
        mod, cls = unit.mod, unit.cls
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    return self._attr_lock_key(cls, expr.attr)
                t = local_types.get(base.id)
                if t is not None:
                    return self._attr_lock_key(t, expr.attr)
                m2 = self._module_of_alias(mod, base.id)
                if m2 is not None:
                    return m2.mod_locks.get(expr.attr) \
                        or m2.mod_conds.get(expr.attr)
            elif isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and cls is not None:
                t = self._attr_type(cls, base.attr)
                if t is not None:
                    return self._attr_lock_key(t, expr.attr)
        elif isinstance(expr, ast.Name):
            return mod.mod_locks.get(expr.id) or mod.mod_conds.get(expr.id)
        return None

    def resolve_call(self, call: ast.Call, unit: _Unit,
                     local_types: Dict[str, _Class],
                     local_tables: Optional[Dict[str, List[_Unit]]] = None,
                     ) -> List[_Unit]:
        mod, cls = unit.mod, unit.cls
        f = call.func
        if isinstance(f, ast.Subscript) and isinstance(f.value, ast.Name) \
                and f.value.id in mod.tables:
            # direct table dispatch: _DISPATCH[kind](...)
            return self._table_units(mod, f.value.id)
        if isinstance(f, ast.Name):
            if local_tables and f.id in local_tables:
                # handler = _DISPATCH.get(kind); handler(...)
                return local_tables[f.id]
            if f.id in mod.funcs:
                return [mod.funcs[f.id]]
            ali = mod.aliases.get(f.id)
            if ali is not None and ali[0] == "from":
                target = self.mods.get(ali[1])
                if target is not None and ali[2] in target.funcs:
                    return [target.funcs[ali[2]]]
            c = self._class_by_name(f.id, mod)
            if c is not None:
                init = c.methods.get("__init__")
                return [init] if init is not None else []
            return []
        if not isinstance(f, ast.Attribute):
            return []
        meth = f.attr
        base = f.value
        if isinstance(base, ast.Subscript):
            # self.fsms[peer].apply(...) — container annotations already
            # unwrap to the element class
            base = base.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                for c in self._cls_chain(cls):
                    if meth in c.methods:
                        return [c.methods[meth]]
                # not a method: a callback attribute someone wired up
                return list(self.callback_attrs.get(meth, ()))
            t = local_types.get(base.id)
            if t is not None:
                for c in self._cls_chain(t):
                    if meth in c.methods:
                        return [c.methods[meth]]
                return []
            m2 = self._module_of_alias(mod, base.id)
            if m2 is not None:
                return [m2.funcs[meth]] if meth in m2.funcs else []
        elif isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and cls is not None:
            t = self._attr_type(cls, base.attr)
            if t is not None:
                for c in self._cls_chain(t):
                    if meth in c.methods:
                        return [c.methods[meth]]
                return []
        # conservative fallback: a method name with very few definitions,
        # unless the name shadows a stdlib container/IO/thread protocol
        if meth in _FALLBACK_DENY:
            return []
        cands = self._method_index.get(meth, [])
        if 1 <= len(cands) <= _FALLBACK_CAP:
            return list(cands)
        return []

    # -- lexical scan ----------------------------------------------------

    def _scan_unit(self, unit: _Unit) -> None:
        if unit.scanned:
            return
        unit.scanned = True
        local_types: Dict[str, _Class] = {}
        local_tables: Dict[str, List[_Unit]] = {}

        # parameter annotations seed the local type map (fsm: NomadFSM)
        args = getattr(unit.node, "args", None)
        if args is not None:
            for a in (list(getattr(args, "posonlyargs", []))
                      + list(args.args) + list(args.kwonlyargs)):
                if a.annotation is None:
                    continue
                for name in self._ann_names(a.annotation):
                    c = self._class_by_name(name, unit.mod)
                    if c is not None:
                        local_types.setdefault(a.arg, c)
                        break

        # one quick pass for local constructor types (x = ClassName(...))
        def prescan(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.Assign) and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name):
                    tgt = child.targets[0].id
                    if isinstance(child.value, ast.Call):
                        fn = child.value.func
                        # handler = _DISPATCH.get(kind)
                        if isinstance(fn, ast.Attribute) \
                                and fn.attr == "get" \
                                and isinstance(fn.value, ast.Name) \
                                and fn.value.id in unit.mod.tables:
                            local_tables.setdefault(tgt, self._table_units(
                                unit.mod, fn.value.id))
                        else:
                            ctor = dotted_name(fn)
                            if ctor:
                                c = self._class_by_name(ctor, unit.mod)
                                if c is not None:
                                    local_types.setdefault(tgt, c)
                    elif isinstance(child.value, ast.Subscript) \
                            and isinstance(child.value.value, ast.Name) \
                            and child.value.value.id in unit.mod.tables:
                        # handler = _DISPATCH[kind]
                        local_tables.setdefault(tgt, self._table_units(
                            unit.mod, child.value.value.id))
                elif isinstance(child, (ast.For, ast.AsyncFor)):
                    # `for fsm in self.fsms:` / `for i, fsm in
                    # enumerate(self.fsms):` — the container annotation
                    # already unwraps to the element class
                    it, tgt_node = child.iter, child.target
                    if isinstance(it, ast.Call) and it.args:
                        fn = it.func
                        if isinstance(fn, ast.Name) and fn.id in {
                                "enumerate", "sorted", "list", "reversed",
                                "tuple"}:
                            if fn.id == "enumerate" \
                                    and isinstance(tgt_node, ast.Tuple) \
                                    and len(tgt_node.elts) == 2:
                                tgt_node = tgt_node.elts[1]
                            it = it.args[0]
                    elif isinstance(it, ast.Call) \
                            and isinstance(it.func, ast.Attribute) \
                            and it.func.attr == "values":
                        it = it.func.value
                    name = tgt_node.id if isinstance(tgt_node, ast.Name) \
                        else None
                    t: Optional[_Class] = None
                    if isinstance(it, ast.Attribute) \
                            and isinstance(it.value, ast.Name) \
                            and it.value.id == "self" and unit.cls is not None:
                        t = self._attr_type(unit.cls, it.attr)
                        # `for cb in self.leadership_observers: cb(...)`
                        cbs = self.callback_attrs.get(it.attr)
                        if name is not None and cbs:
                            local_tables.setdefault(name, list(cbs))
                    if name is not None and t is not None:
                        local_types.setdefault(name, t)
                prescan(child)

        prescan(unit.node)

        # nested `def` bodies are skipped by the main walk — a closure
        # handed to Thread(target=...) runs with an EMPTY held set, not
        # this frame's. But a nested function CALLED here runs inline on
        # this thread: scan its body at the call site under the caller's
        # current held set (lifecycle._emit_trace_spans's `emit` closure
        # acquiring the span-ring lock is the canonical case).
        nested_defs: Dict[str, ast.AST] = {}
        for sub in ast.walk(unit.node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not unit.node:
                nested_defs.setdefault(sub.name, sub)
        inlining: Set[str] = set()

        def block(nodes: Iterable[ast.AST], held: Tuple[str, ...],
                  in_while: bool) -> None:
            for node in nodes:
                if node is None or isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    continue
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    new_held = held
                    for item in node.items:
                        # calls inside the context expression run BEFORE
                        # the acquisition
                        block(ast.iter_child_nodes(item.context_expr),
                              new_held, in_while)
                        if isinstance(item.context_expr, ast.Call):
                            self._scan_call(unit, item.context_expr,
                                            new_held, in_while, local_types,
                                            local_tables)
                        key = self.resolve_lock_expr(
                            item.context_expr, unit, local_types)
                        if key is not None and key not in new_held:
                            unit.acquires.append((key, node.lineno, new_held))
                            new_held = new_held + (key,)
                    block(node.body, new_held, in_while)
                    continue
                if isinstance(node, ast.While):
                    block([node.test], held, True)
                    block(node.body, held, True)
                    block(node.orelse, held, in_while)
                    continue
                if isinstance(node, ast.Call):
                    self._scan_call(unit, node, held, in_while, local_types,
                                    local_tables)
                    f = node.func
                    if isinstance(f, ast.Name) and f.id in nested_defs \
                            and f.id not in inlining:
                        inlining.add(f.id)
                        block(nested_defs[f.id].body, held, in_while)
                        inlining.discard(f.id)
                block(ast.iter_child_nodes(node), held, in_while)

        block(ast.iter_child_nodes(unit.node), (), False)

    def _scan_call(self, unit: _Unit, call: ast.Call, held: Tuple[str, ...],
                   in_while: bool, local_types: Dict[str, _Class],
                   local_tables: Dict[str, List[_Unit]]) -> None:
        f = call.func
        if isinstance(f, ast.Attribute):
            base_is_cond = (
                isinstance(f.value, ast.Attribute)
                and f.value.attr in self._cond_attr_names
            ) or (
                isinstance(f.value, ast.Name)
                and f.value.id in unit.mod.mod_conds
            )
            if f.attr in {"wait", "wait_for"} and base_is_cond:
                key = self.resolve_lock_expr(f.value, unit, local_types)
                unit.waits.append((
                    key or "?", call.lineno, in_while, f.attr == "wait_for"))
                return
            if f.attr in {"notify", "notify_all"} and base_is_cond:
                key = self.resolve_lock_expr(f.value, unit, local_types)
                if key is not None:
                    unit.notifies.append(
                        (key, f.attr, call.lineno, held))
                return
        targets = self.resolve_call(call, unit, local_types, local_tables)
        if targets:
            unit.calls.append((targets, call.lineno, held))
            for t in targets:
                self.callers.setdefault(t, []).append((unit, held))

    # -- interprocedural walk --------------------------------------------

    def analyze(self) -> None:
        if self._analyzed:
            return
        self._analyzed = True
        t0 = time.perf_counter()
        self._collect_callbacks()
        for u in self._units:
            self._scan_unit(u)
        memo: Set[Tuple[int, frozenset]] = set()

        def walk(unit: _Unit, entry_held: Tuple[str, ...],
                 chain: Tuple[str, ...], depth: int) -> None:
            key = (id(unit), frozenset(entry_held))
            if key in memo or depth > _MAX_DEPTH:
                return
            memo.add(key)
            chain = chain + (unit.qual,)
            for lock, lineno, lex in unit.acquires:
                for h in dict.fromkeys(entry_held + lex):
                    if h != lock:
                        self._add_edge(h, lock, unit.mod.pm.rel, lineno,
                                       chain)
            for targets, _lineno, lex in unit.calls:
                nh = tuple(dict.fromkeys(entry_held + lex))
                for t in targets:
                    walk(t, nh, chain, depth + 1)

        for u in self._units:
            walk(u, (), (), 0)
        self.analyze_wall_s = time.perf_counter() - t0

    def _add_edge(self, a: str, b: str, rel: str, lineno: int,
                  chain: Tuple[str, ...]) -> None:
        succ = self.graph.setdefault(a, set())
        if b in succ:
            return
        succ.add(b)
        self.edge_sites[(a, b)] = (rel, lineno, " -> ".join(chain[-4:]))

    # -- outputs ---------------------------------------------------------

    def edges(self) -> Set[Tuple[str, str]]:
        self.analyze()
        return {(a, b) for a, succ in self.graph.items() for b in succ}

    def cycles(self) -> List[List[str]]:
        """Strongly connected components with >= 2 nodes, sorted."""
        self.analyze()
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        nodes = sorted(set(self.graph)
                       | {b for s in self.graph.values() for b in s})

        def strong(v: str) -> None:
            work = [(v, iter(sorted(self.graph.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(self.graph.get(w, ())))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))

        for v in nodes:
            if v not in index:
                strong(v)
        return sorted(sccs)

    # -- condition-discipline support ------------------------------------

    def notify_held(self, unit: _Unit, lock_key: str,
                    lex_held: Tuple[str, ...]) -> bool:
        """Is a notify site provably issued with ``lock_key`` held?
        Lexical with-block, the ``*_locked`` caller-holds convention, or
        every (transitive, depth-bounded) call site under the lock."""
        if lock_key in lex_held:
            return True

        def fn_name(u: _Unit) -> str:
            return u.qual.rsplit(".", 1)[-1]

        def check(u: _Unit, depth: int, seen: Set[int]) -> bool:
            if fn_name(u).endswith("_locked"):
                return True
            if depth > 3 or id(u) in seen:
                return False
            seen.add(id(u))
            sites = self.callers.get(u, [])
            if not sites:
                return False
            return all(
                lock_key in held or check(caller, depth + 1, seen)
                for caller, held in sites
            )

        return check(unit, 0, set())


class LockOrderChecker:
    """Registered checker: reports each lock-order SCC once, attributed
    to the file of its lexically-first edge site."""

    rule = RULE

    def __init__(self, analysis: Optional[WholeProgramLockAnalysis] = None
                 ) -> None:
        self.analysis = analysis or WholeProgramLockAnalysis()
        self._findings: Optional[List[Finding]] = None

    def collect(self, module: ParsedModule) -> None:
        self.analysis.add_module(module)

    def _compute(self) -> List[Finding]:
        if self._findings is not None:
            return self._findings
        findings: List[Finding] = []
        for comp in self.analysis.cycles():
            in_comp = set(comp)
            edges = sorted(
                (a, b) for (a, b) in self.analysis.edge_sites
                if a in in_comp and b in in_comp
            )
            parts = []
            for a, b in edges:
                rel, _lineno, chain = self.analysis.edge_sites[(a, b)]
                parts.append(f"{a} -> {b} [{rel} via {chain}]")
            first = self.analysis.edge_sites[edges[0]]
            findings.append(Finding(
                RULE, first[0], first[1],
                "potential deadlock: lock-order cycle {%s}; edges: %s"
                % (", ".join(comp), "; ".join(parts)),
            ))
        self._findings = findings
        return findings

    def check(self, module: ParsedModule) -> List[Finding]:
        return [f for f in self._compute() if f.file == module.rel]


# -- the witness cross-check entry point ------------------------------------

_STATIC_CACHE: Dict[str, Set[Tuple[str, str]]] = {}


def build_static_graph(root: Optional[str] = None) -> Set[Tuple[str, str]]:
    """Whole-tree lock-order edges, for the runtime witness's teardown
    cross-check. ``root`` defaults to the port's own package
    (``nomad_tpu_torch``); results are cached per root."""
    from .core import iter_py_files, parse_file

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(root)
    cached = _STATIC_CACHE.get(root)
    if cached is not None:
        return cached
    analysis = WholeProgramLockAnalysis()
    base = os.path.dirname(root)
    for path in iter_py_files([root]):
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        pm, _err = parse_file(path, rel)
        if pm is not None:
            analysis.add_module(pm)
    edges = analysis.edges()
    _STATIC_CACHE[root] = edges
    return edges
