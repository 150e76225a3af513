"""hclspec — schema-as-data for plugin configuration (reference
plugins/shared/hclspec/hcl_spec.proto:1-50).

The reference ships plugin config schemas as protobuf Spec trees that
the agent uses to decode/validate a driver's HCL config. This module is
the same idea with plain dicts as the wire format (the plugin transport
is msgpack here, so schema-as-data needs no extra codegen):

  {"attr":    {"type": "string"|"number"|"bool"|"list(string)"|...,
               "required": bool}}
  {"block":   {"spec": {field: Spec, ...}}}
  {"block_list": {"spec": {...}}}          # repeated blocks
  {"default": {"primary": Spec, "default": value}}
  {"literal": {"value": value}}

``decode(spec, value)`` validates ``value`` against the spec, applies
defaults, and returns (decoded, errors). A plugin's ``config_schema()``
may return either this spec form or the legacy flat
``{key: {"type", "required"}}`` form, which is auto-upgraded.

Copied from ``nomad_tpu/plugins/hclspec.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

_PRIMS = {
    "string": str,
    "number": (int, float),
    "int": int,
    "float": (int, float),
    "bool": bool,
    "any": object,
}


class SpecError(Exception):
    pass


def upgrade_flat_schema(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Legacy flat {key: {"type", "required", "default"}} → block spec."""
    fields: Dict[str, Any] = {}
    for key, meta in flat.items():
        t = meta.get("type", "any")
        if t == "list":
            t = "list(any)"
        elif t == "map":
            t = "map(any)"
        attr = {"attr": {"type": t, "required": bool(meta.get("required"))}}
        if "default" in meta:
            attr = {"default": {"primary": attr, "default": meta["default"]}}
        fields[key] = attr
    return {"block": {"spec": fields}}


def normalize(schema: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Accept either a spec tree or the legacy flat schema."""
    if not schema:
        return {"block": {"spec": {}}}
    if any(k in schema for k in ("attr", "block", "block_list", "default", "literal")):
        return schema
    return upgrade_flat_schema(schema)


def _check_type(path: str, t: str, value: Any, errors: List[str]) -> Any:
    if t.startswith("list(") and t.endswith(")"):
        if not isinstance(value, list):
            errors.append(f"{path}: expected list, got {type(value).__name__}")
            return value
        inner = t[5:-1]
        return [_check_type(f"{path}[{i}]", inner, v, errors)
                for i, v in enumerate(value)]
    if t.startswith("map(") and t.endswith(")"):
        if not isinstance(value, dict):
            errors.append(f"{path}: expected map, got {type(value).__name__}")
            return value
        inner = t[4:-1]
        return {k: _check_type(f"{path}.{k}", inner, v, errors)
                for k, v in value.items()}
    want = _PRIMS.get(t)
    if want is None:
        errors.append(f"{path}: unknown spec type {t!r}")
        return value
    if want is object:
        return value
    # bool is an int subclass: don't admit True for a number attr
    if isinstance(value, bool) and want is not bool and t != "any":
        errors.append(f"{path}: expected {t}, got bool")
        return value
    if not isinstance(value, want):
        errors.append(f"{path}: expected {t}, got {type(value).__name__}")
    return value


def _decode(spec: Dict[str, Any], value: Any, path: str,
            errors: List[str]) -> Any:
    if "literal" in spec:
        return spec["literal"].get("value")
    if "default" in spec:
        node = spec["default"]
        if value is None:
            return node.get("default")
        return _decode(node["primary"], value, path, errors)
    if "attr" in spec:
        node = spec["attr"]
        if value is None:
            if node.get("required"):
                errors.append(f"{path}: required attribute missing")
            return None
        return _check_type(path, node.get("type", "any"), value, errors)
    if "block" in spec:
        fields = spec["block"].get("spec", {})
        if value is None:
            value = {}
        if not isinstance(value, dict):
            errors.append(f"{path}: expected block, got {type(value).__name__}")
            return value
        out = {}
        for key, sub in fields.items():
            out_val = _decode(sub, value.get(key), f"{path}.{key}" if path else key,
                              errors)
            if out_val is not None or key in value:
                out[key] = out_val
        for key in value:
            if key not in fields:
                errors.append(f"{path + '.' if path else ''}{key}: unknown field")
        return out
    if "block_list" in spec:
        inner = {"block": {"spec": spec["block_list"].get("spec", {})}}
        if value is None:
            return []
        if not isinstance(value, list):
            errors.append(f"{path}: expected list of blocks")
            return value
        return [_decode(inner, v, f"{path}[{i}]", errors)
                for i, v in enumerate(value)]
    errors.append(f"{path}: malformed spec node {sorted(spec)}")
    return value


def decode(schema: Optional[Dict[str, Any]], value: Any) -> Tuple[Any, List[str]]:
    """Validate + default-apply ``value`` against ``schema``.
    Returns (decoded, errors); errors empty on success."""
    errors: List[str] = []
    decoded = _decode(normalize(schema), value, "", errors)
    return decoded, errors
