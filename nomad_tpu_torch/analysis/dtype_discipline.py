"""dtype-discipline: no float64 creep in the integer-parity encode path.

The parity engine's guarantee (PARITY.md) is that patched/cached encodes
are bit-identical to fresh ones. The inline encode path casts capacities
to the eval dtype (int32 in parity mode) BEFORE subtracting; a float64
subtraction cast to int64 afterwards rounds differently on fractional
capacities — exactly the ``epoch_usage_arrays`` divergence this checker
exists to catch mechanically.

Scoped to the integer-spec modules (``tpu/encode.py``, ``tpu/intscore.py``
— the rest of the host codebase legitimately computes in float64). Two
sub-patterns:

  A. ``(x - y).astype(np.int64)`` where the subtraction operands are not
     each themselves ``.astype(...)`` casts: the subtraction ran in
     whatever dtype the operands carried (float64 capacities) instead of
     the eval dtype.
  B. binary arithmetic where one operand is provably float64 — a literal
     ``np.float64(...)`` call or a variable assigned from an allocation
     with an explicit ``np.float64`` dtype — without an ``.astype`` cast.

Packed-mask layouts (sub-pattern C, its OWN wider target list — the
kernel modules that consume packed planes, ``tpu/engine.py`` and
``tpu/batcher.py`` included): the fused scan packs boolean planes into
uint8 feature lanes and 16-bit count lanes inside int32 (intscore
"Packed-mask lanes"). Crossing a packed boundary is only exact through
the blessed helpers, so the rule flags

  C1. raw ``>>`` / ``&`` bit surgery on a ``*packed*``-named array
      outside the ``pack_*``/``unpack_*`` helpers themselves — a
      hand-rolled unpack silently breaks when the lane layout moves;
  C2. float promotion of a ``*packed*``-named plane (``.astype`` to a
      float dtype, or arithmetic against a float literal) — packed
      lanes are integral bit patterns, not numbers.

Copied from ``nomad_tpu/analysis/dtype_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
The packed targets add the port's ``tpu/convert.py`` and
``tpu/kernels.py``, where the packed slab is built and read, and the
float dtypes add ``torch``'s.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from .core import Finding, ParsedModule, dotted_name, resolve_call_name

RULE = "dtype-discipline"

TARGET_SUFFIXES = ("tpu/encode.py", "tpu/intscore.py")

# sub-pattern C applies wherever packed planes travel: the encode that
# emits them, the scan/batcher modules that consume them
PACKED_TARGET_SUFFIXES = (
    "tpu/encode.py", "tpu/intscore.py", "tpu/engine.py", "tpu/batcher.py",
    "tpu/convert.py", "tpu/kernels.py",
)

_FLOAT_DTYPES = {
    "numpy.float16", "numpy.float32", "numpy.float64",
    "np.float16", "np.float32", "np.float64",
    "jnp.float16", "jnp.float32", "jnp.float64", "jnp.bfloat16",
    "jax.numpy.float32", "jax.numpy.float64",
    "torch.float16", "torch.float32", "torch.float64", "torch.bfloat16",
    "torch.half", "torch.float", "torch.double",
}

_ALLOC_FNS = {
    "numpy.zeros", "numpy.ones", "numpy.full", "numpy.empty",
    "numpy.array", "numpy.asarray", "numpy.zeros_like", "numpy.full_like",
    "np.zeros", "np.ones", "np.full", "np.empty",
    "np.array", "np.asarray", "np.zeros_like", "np.full_like",
}
_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod)


def _is_float64_ref(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """np.float64 / numpy.float64 / "float64"."""
    if isinstance(node, ast.Constant) and node.value == "float64":
        return True
    name = dotted_name(node)
    if name is None:
        return False
    head, _, rest = name.partition(".")
    return (aliases.get(head, head) + ("." + rest if rest else "")) in (
        "numpy.float64", "np.float64",
    )


def _is_int64_ref(node: ast.AST, aliases: Dict[str, str]) -> bool:
    if isinstance(node, ast.Constant) and node.value == "int64":
        return True
    name = dotted_name(node)
    if name is None:
        return False
    head, _, rest = name.partition(".")
    return (aliases.get(head, head) + ("." + rest if rest else "")) in (
        "numpy.int64", "np.int64",
    )


def _is_astype_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "astype"
    )


def _sub_leaves(node: ast.BinOp) -> List[ast.AST]:
    """Leaf operands of a +/- chain: ``a - b - c`` -> [a, b, c]."""
    out: List[ast.AST] = []
    for side in (node.left, node.right):
        if isinstance(side, ast.BinOp) and isinstance(side.op, (ast.Add, ast.Sub)):
            out.extend(_sub_leaves(side))
        else:
            out.append(side)
    return out


def _float64_alloc(call: ast.Call, aliases: Dict[str, str]) -> bool:
    """An array allocation whose explicit dtype is float64 (keyword or
    positional)."""
    fn = resolve_call_name(call.func, aliases)
    if fn is None:
        return False
    head = fn.split(".")[0]
    norm = fn if head == "numpy" else fn.replace(head, "np", 1)
    if norm not in _ALLOC_FNS and fn not in _ALLOC_FNS:
        return False
    for kw in call.keywords:
        if kw.arg == "dtype" and _is_float64_ref(kw.value, aliases):
            return True
    return any(_is_float64_ref(a, aliases) for a in call.args)


def _is_float_dtype_ref(node: ast.AST, aliases: Dict[str, str]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(("float", "bfloat")):
        return True
    name = dotted_name(node)
    if name is None:
        return False
    head, _, rest = name.partition(".")
    return (aliases.get(head, head) + ("." + rest if rest else "")) in \
        _FLOAT_DTYPES or name in _FLOAT_DTYPES


def _packed_operand(node: ast.AST):
    """The ``*packed*``-named Name/Attribute inside an expression (the
    packed plane crossing a boundary), or None. Does NOT descend into
    ``pack_*``/``unpack_*`` calls: a plane passed THROUGH a blessed
    helper has already crossed the boundary legally."""
    stack = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.Call):
            fn = sub.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if fname.startswith(("pack_", "unpack_")):
                continue
            stack.extend(ast.iter_child_nodes(sub))
            continue
        if isinstance(sub, ast.Name) and "packed" in sub.id.lower():
            return sub.id
        if isinstance(sub, ast.Attribute) and "packed" in sub.attr.lower():
            return sub.attr
        stack.extend(ast.iter_child_nodes(sub))
    return None


class DtypeDisciplineChecker:
    rule = RULE

    def __init__(self, restrict_to=TARGET_SUFFIXES,
                 packed_targets=PACKED_TARGET_SUFFIXES):
        self.restrict_to = tuple(restrict_to)
        self.packed_targets = tuple(packed_targets)

    def check(self, module: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        if self.restrict_to and module.rel.endswith(self.restrict_to):
            findings.extend(self._check_float64_creep(module))
        if self.packed_targets and module.rel.endswith(self.packed_targets):
            findings.extend(self._check_packed_lanes(module))
        return findings

    def _check_float64_creep(self, module: ParsedModule) -> List[Finding]:
        from .core import body_walk, import_aliases

        aliases = import_aliases(module.tree)
        findings: List[Finding] = []

        # sub-pattern B, per lexical scope (body_walk skips nested defs, so
        # every node belongs to exactly one scope): names assigned float64
        # allocations taint arithmetic they appear in un-cast
        scopes = [module.tree] + [
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            tainted: Set[str] = set()
            for node in body_walk(scope):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                        and _float64_alloc(node.value, aliases):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
            if not tainted:
                continue
            for node in body_walk(scope):
                if isinstance(node, ast.BinOp) and isinstance(node.op, _ARITH_OPS):
                    for operand in (node.left, node.right):
                        if self._operand_float64(operand, tainted, aliases):
                            findings.append(Finding(
                                RULE, module.rel, node.lineno,
                                "float64 operand "
                                f"'{ast.unparse(operand)}' in arithmetic "
                                "without an explicit dtype cast",
                            ))
                            break

        # sub-pattern A: (a - b).astype(np.int64) with un-cast operands
        for node in ast.walk(module.tree):
            if not _is_astype_call(node):
                continue
            if not any(_is_int64_ref(a, aliases) for a in node.args):
                continue
            target = node.func.value
            if not (isinstance(target, ast.BinOp)
                    and isinstance(target.op, (ast.Add, ast.Sub))):
                continue
            uncast = [
                leaf for leaf in _sub_leaves(target)
                if not (_is_astype_call(leaf) or isinstance(leaf, ast.Constant))
            ]
            if uncast:
                findings.append(Finding(
                    RULE, module.rel, target.lineno,
                    "int64 cast of a subtraction whose operands are not "
                    "each .astype()-cast first "
                    f"(un-cast: {', '.join(ast.unparse(u) for u in uncast)})",
                ))
        return findings

    def _operand_float64(self, node: ast.AST, tainted: Set[str],
                         aliases: Dict[str, str]) -> bool:
        # a tainted name, a subscript/slice of one, or a float64 literal call
        cur = node
        while isinstance(cur, ast.Subscript):
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id in tainted:
            return True
        if isinstance(node, ast.Call) and _is_float64_ref(node.func, aliases):
            return True
        return False

    # -- sub-pattern C: packed-lane discipline --------------------------

    def _check_packed_lanes(self, module: ParsedModule) -> List[Finding]:
        from .core import import_aliases

        aliases = import_aliases(module.tree)
        # the blessed helpers themselves ARE the raw bit surgery; skip
        # every node inside a pack_*/unpack_* def
        blessed = [
            (fn.lineno, fn.end_lineno or fn.lineno)
            for fn in ast.walk(module.tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and fn.name.startswith(("pack_", "unpack_"))
        ]

        def in_blessed(node: ast.AST) -> bool:
            ln = getattr(node, "lineno", None)
            return ln is not None and any(a <= ln <= b for a, b in blessed)

        findings: List[Finding] = []
        seen_raw: Set[tuple] = set()  # (line, name): nested >>/& report once
        for node in ast.walk(module.tree):
            if in_blessed(node):
                continue
            # C1: raw >> / & surgery on a packed plane
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.RShift, ast.BitAnd)):
                name = _packed_operand(node.left) or _packed_operand(node.right)
                if name:
                    if (node.lineno, name) not in seen_raw:
                        seen_raw.add((node.lineno, name))
                        findings.append(Finding(
                            RULE, module.rel, node.lineno,
                            f"raw bit unpack of packed plane '{name}' outside "
                            "the blessed intscore helpers (use unpack_feat_lane"
                            "/unpack_count_lo/unpack_count_hi)",
                        ))
                    continue
            # C2a: .astype(<float dtype>) on a packed plane
            if _is_astype_call(node) \
                    and any(_is_float_dtype_ref(a, aliases) for a in node.args):
                name = _packed_operand(node.func.value)
                if name:
                    findings.append(Finding(
                        RULE, module.rel, node.lineno,
                        f"float promotion of packed plane '{name}' "
                        "(packed lanes are integral bit patterns; unpack "
                        "through the blessed helpers before float math)",
                    ))
                    continue
            # C2b: arithmetic between a packed plane and a float literal
            if isinstance(node, ast.BinOp) and isinstance(node.op, _ARITH_OPS):
                for lhs, rhs in ((node.left, node.right),
                                 (node.right, node.left)):
                    if isinstance(rhs, ast.Constant) \
                            and isinstance(rhs.value, float):
                        name = _packed_operand(lhs)
                        if name:
                            findings.append(Finding(
                                RULE, module.rel, node.lineno,
                                "float promotion of packed plane "
                                f"'{name}' in arithmetic with a float "
                                "literal (unpack the lane first)",
                            ))
                            break
        return findings
