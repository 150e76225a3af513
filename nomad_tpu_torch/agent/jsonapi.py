"""JSON ⇆ dataclass codec for the HTTP API.

The reference serves Go structs whose JSON keys are the exported Go field
names ("ID", "JobID", "MemoryMB", "TaskGroups"...). Our structs are
snake_case Python dataclasses; this module maps between the two so the
HTTP surface looks like the reference's /v1 API (command/agent/http.go
``wrap`` encodes responses with the stdlib JSON encoder over those
structs). Decoding is type-hint driven: given a target dataclass we
rebuild nested structs, lists, dicts, optionals — never arbitrary types.

Copied from ``nomad_tpu/agent/jsonapi.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Type

# Word fragments rendered as acronyms in Go field names.
_ACRONYMS = {
    "id": "ID",
    "cpu": "CPU",
    "mb": "MB",
    "mbits": "MBits",
    "ttl": "TTL",
    "acl": "ACL",
    "url": "URL",
    "ip": "IP",
    "iops": "IOPS",
    "gc": "GC",
    "dns": "DNS",
    "ns": "Ns",
    "hcl": "HCL",
    # Go API: FailedTGAllocs, DesiredTGUpdates (api/evaluations.go,
    # api/jobs.go plan annotations)
    "tg": "TG",
}

# Whole-field overrides where fragment-by-fragment casing is not enough.
_FIELD_OVERRIDES = {
    "ids": "IDs",
    "eval_ids": "EvalIDs",
    "alloc_ids": "AllocIDs",
    "node_ids": "NodeIDs",
    # Go API name differs from the struct field (api/jobs.go
    # ParameterizedJob *ParameterizedJobConfig)
    "parameterized": "ParameterizedJob",
}


def camel(name: str) -> str:
    """snake_case field name -> reference-style Go JSON key."""
    if name in _FIELD_OVERRIDES:
        return _FIELD_OVERRIDES[name]
    parts = name.split("_")
    out = []
    for p in parts:
        if not p:
            continue
        out.append(_ACRONYMS.get(p, p[0].upper() + p[1:]))
    return "".join(out)


def to_json_obj(obj: Any) -> Any:
    """Dataclass tree -> plain JSON-serializable tree with Go-style keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[camel(f.name)] = to_json_obj(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {str(k): to_json_obj(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [to_json_obj(v) for v in obj]
    if isinstance(obj, bytes):
        return base64.b64encode(obj).decode("ascii")
    if isinstance(obj, float) and obj != obj:  # NaN -> null
        return None
    return obj


def dumps(obj: Any, pretty: bool = False) -> str:
    data = to_json_obj(obj)
    if pretty:
        return json.dumps(data, indent=4, sort_keys=False)
    return json.dumps(data, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

_hints_cache: Dict[Type, Dict[str, Any]] = {}


def _type_hints(cls: Type) -> Dict[str, Any]:
    hints = _hints_cache.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        _hints_cache[cls] = hints
    return hints


_keymap_cache: Dict[Type, Dict[str, str]] = {}


def _key_map(cls: Type) -> Dict[str, str]:
    """Accepted JSON key (camel or snake, lowercased) -> field name."""
    m = _keymap_cache.get(cls)
    if m is None:
        m = {}
        for f in dataclasses.fields(cls):
            m[f.name.lower()] = f.name
            m[camel(f.name).lower()] = f.name
        _keymap_cache[cls] = m
    return m


def from_json_obj(cls: Type, data: Any) -> Any:
    """Build an instance of ``cls`` (honoring type hints) from JSON data."""
    return _convert(cls, data)


def _convert(hint: Any, data: Any) -> Any:
    if data is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X] and unions
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _convert(args[0], data)
        return data
    if origin in (list, typing.List):
        (item,) = typing.get_args(hint) or (Any,)
        return [_convert(item, v) for v in data]
    if origin in (set, typing.Set):
        (item,) = typing.get_args(hint) or (Any,)
        return set(_convert(item, v) for v in data)
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        vt = args[1] if len(args) == 2 else Any
        return {k: _convert(vt, v) for k, v in data.items()}
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(hint)
        if args and args[-1] is not Ellipsis:
            return tuple(_convert(a, v) for a, v in zip(args, data))
        return tuple(data)
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        if not isinstance(data, dict):
            raise ValueError(f"expected object for {hint.__name__}, got {type(data).__name__}")
        keymap = _key_map(hint)
        hints = _type_hints(hint)
        kwargs = {}
        for k, v in data.items():
            fname = keymap.get(str(k).lower())
            if fname is None:
                continue  # tolerate unknown keys like the reference's API does
            kwargs[fname] = _convert(hints.get(fname, Any), v)
        return hint(**kwargs)
    if hint is bytes:
        if isinstance(data, str):
            return base64.b64decode(data)
        return bytes(data)
    if hint is float and isinstance(data, int):
        return float(data)
    if hint is int and isinstance(data, float) and data.is_integer():
        return int(data)
    return data


def loads(cls: Optional[Type], body: str) -> Any:
    data = json.loads(body) if body else None
    if cls is None:
        return data
    return from_json_obj(cls, data)
