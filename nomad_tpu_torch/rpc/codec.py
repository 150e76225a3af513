"""Wire codec: msgpack with a typed-dataclass extension.

Fills the role of the reference's msgpack codec over net/rpc
(nomad/rpc.go, helper/codec): structs cross the wire as msgpack maps
tagged with their registered type name and are rebuilt through a class
registry — never arbitrary deserialization (no pickle on the wire), so a
malicious peer can only produce known struct types.

Request envelopes are ``{"seq", "method", "body"}`` plus optional
routing flags (``no_forward``, ``region``) and the distributed-tracing
context under :data:`TRACE_KEY` — a ``{"trace_id", "span_id"}`` dict
(trace/context.py) that the server side re-activates so its handler
span becomes a child of the caller's span. Unknown envelope fields are
ignored by older peers, so the trace field is wire-compatible both ways.

Copied from ``nomad_tpu/rpc/codec.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Two changes: the bytes are packed and
unpacked by the port's own copy of the msgpack format (``wirefmt``: the
same bytes as ``msgpack.packb(..., use_bin_type=True)``, the same values
as ``msgpack.unpackb(..., raw=False, strict_map_key=False)``), so the
port does not import ``msgpack``; and the registry holds the wire types
of the reference's registry that the port has: its own structs
(``structs.structs``), the client drivers' payload types
(``client.drivers.base``'s) and the task directory (``TaskDir``), the
device plugins' payload types (``plugins.base.PluginInfo`` and
``plugins.device``'s), the ACL structs (``structs.acl``) and the
operator's ``AutopilotConfig`` (``server.autopilot``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Type

from . import wirefmt

_TYPE_KEY = "__t"

#: request-envelope field carrying the TraceContext wire dict
TRACE_KEY = "trace"
_REGISTRY: Dict[str, Type] = {}
_REGISTRY_READY = False
_REGISTRY_LOCK = threading.Lock()


def _ensure_registry() -> None:
    """Thread-safe one-time full registration. Gating on registry
    non-emptiness is wrong twice over: a concurrent first call can observe
    a PARTIALLY-filled registry mid-registration, and an early
    register_struct() call would suppress full registration forever."""
    global _REGISTRY_READY
    if _REGISTRY_READY:
        return
    with _REGISTRY_LOCK:
        if _REGISTRY_READY:
            return
        _register_all_structs()
        _REGISTRY_READY = True


def register_struct(cls: Type) -> Type:
    """Allow a dataclass across the wire."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _register_all_structs() -> None:
    from ..structs import structs as s

    for name in dir(s):
        obj = getattr(s, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            _REGISTRY[obj.__name__] = obj
    # non-struct payloads that ride raft/rpc
    from ..client.drivers.base import (
        Capabilities,
        ExitResult,
        Fingerprint,
        TaskConfig,
        TaskHandle,
        TaskStats,
        TaskStatus,
    )

    for cls in (Capabilities, ExitResult, Fingerprint, TaskConfig, TaskHandle,
                TaskStats, TaskStatus):
        _REGISTRY[cls.__name__] = cls

    from ..plugins.base import PluginInfo
    from ..plugins.device import (
        ContainerReservation,
        DetectedDevice,
        DeviceGroup,
        DeviceSpec,
        DeviceStats,
        Mount,
    )

    for cls in (PluginInfo, ContainerReservation, DetectedDevice, DeviceGroup,
                DeviceSpec, DeviceStats, Mount):
        _REGISTRY[cls.__name__] = cls

    from ..client.allocdir import TaskDir

    _REGISTRY[TaskDir.__name__] = TaskDir

    # ACL + operator payloads (ride raft snapshots and RPC)
    from ..structs import acl as acl_structs

    for name in dir(acl_structs):
        obj = getattr(acl_structs, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            _REGISTRY[obj.__name__] = obj

    from ..server.autopilot import AutopilotConfig

    _REGISTRY[AutopilotConfig.__name__] = AutopilotConfig


def _to_wire(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TYPE_KEY: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _to_wire(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        # tuple keys (e.g. (namespace, job_id)) become tagged lists
        enc = {}
        tuple_keys = False
        for k, v in obj.items():
            if isinstance(k, tuple):
                tuple_keys = True
                break
        if tuple_keys:
            return {
                _TYPE_KEY: "__tdict",
                "items": [[_to_wire(list(k) if isinstance(k, tuple) else k), _to_wire(v)]
                          for k, v in obj.items()],
            }
        for k, v in obj.items():
            enc[k] = _to_wire(v)
        return enc
    if isinstance(obj, tuple):
        return {_TYPE_KEY: "__tuple", "items": [_to_wire(v) for v in obj]}
    if isinstance(obj, set):
        return {_TYPE_KEY: "__set", "items": [_to_wire(v) for v in obj]}
    if isinstance(obj, list):
        return [_to_wire(v) for v in obj]
    return obj


def _from_wire(obj: Any) -> Any:
    if isinstance(obj, dict):
        tname = obj.get(_TYPE_KEY)
        if tname == "__tuple":
            return tuple(_from_wire(v) for v in obj["items"])
        if tname == "__set":
            return set(_from_wire(v) for v in obj["items"])
        if tname == "__tdict":
            return {
                tuple(_from_wire(k)) if isinstance(k, list) else _from_wire(k): _from_wire(v)
                for k, v in obj["items"]
            }
        if tname is not None:
            cls = _REGISTRY.get(tname)
            if cls is None:
                raise ValueError(f"unknown wire type {tname!r}")
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {
                k: _from_wire(v)
                for k, v in obj.items()
                if k != _TYPE_KEY and k in field_names
            }
            return cls(**kwargs)
        return {k: _from_wire(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_wire(v) for v in obj]
    return obj


def encode(obj: Any) -> bytes:
    _ensure_registry()
    return wirefmt.packb(_to_wire(obj))


def decode(data: bytes) -> Any:
    _ensure_registry()
    return _from_wire(wirefmt.unpackb(data))
