"""Agent configuration files: HCL/JSON load + defaults merging.

Fills the role of reference ``command/agent/config.go`` +
``config_parse.go``: the agent is driven by config FILES with the CLI
flags as overrides. ``-config`` takes a file or a directory (repeatable);
directories load every ``*.hcl``/``*.json`` in lexical order; later
sources merge over earlier ones key-by-key (reference Config.Merge,
config.go:1); key names match the reference's HCL schema so existing
Nomad config files map over:

    region / datacenter / name / data_dir / bind_addr / enable_debug / device
    ports { http rpc serf }
    advertise { rpc }
    server { enabled bootstrap_expect num_schedulers encrypt
             authoritative_region heartbeat_grace raft_protocol(ignored)
             default_scheduler_config { scheduler_algorithm chunk_k
                                        parity_sample_rate } }
    client { enabled node_class servers meta {} host_volume "n" { path } }
    acl { enabled replication_token }
    telemetry { statsd_address statsite_address datadog_address
                datadog_tags prefix flight_interval_s flight_retain
                flight_spill_dir }
    tls { http ca_file cert_file key_file verify_server_hostname }

The file model intentionally covers the knobs this agent implements; an
unknown key is an ERROR (reference config parsing is strict via
hcl.DecodeObject) so typos fail loudly at boot instead of silently
running defaults.

Copied from ``nomad_tpu/agent/config_file.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Two changes: the top-level key
``device`` ("cuda" or "cpu") sets ``AgentConfig.device``, and the
server's ``heartbeat_grace`` (a Go duration, as in Nomad's server
stanza) sets ``AgentConfig.heartbeat_grace``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List

from ..jobspec import HCLError, parse_hcl
from ..jobspec.parse import parse_duration_ns
from .agent import AgentConfig


class ConfigError(ValueError):
    pass


def load_config_sources(paths: List[str]) -> Dict[str, Any]:
    """Load + merge every ``-config`` source in order."""
    merged: Dict[str, Any] = {}
    for path in paths:
        for f in _expand(path):
            merged = merge_config(merged, _load_one(f))
    return merged


def _expand(path: str) -> List[str]:
    if os.path.isdir(path):
        out = [
            os.path.join(path, name)
            for name in sorted(os.listdir(path))
            if name.endswith((".hcl", ".json")) and not name.startswith(".")
        ]
        return out
    if not os.path.exists(path):
        raise ConfigError(f"config path {path!r} does not exist")
    return [path]


def _load_one(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    try:
        if path.endswith(".json"):
            data = json.loads(src or "{}")
        else:
            data = parse_hcl(src).to_plain()
    except (HCLError, ValueError) as e:
        raise ConfigError(f"{path}: {e}") from e
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: top level must be an object")
    return data


def merge_config(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive key-wise merge; scalars and lists in the overlay replace,
    objects merge (reference Config.Merge semantics)."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# file model -> AgentConfig
# ---------------------------------------------------------------------------

_TOP_KEYS = {
    "region", "datacenter", "name", "data_dir", "bind_addr", "enable_debug",
    "ports", "advertise", "server", "client", "acl", "telemetry", "tls",
    "log_level", "disable_update_check", "leave_on_interrupt",
    "leave_on_terminate", "device",
}
_PORT_KEYS = {"http", "rpc", "serf"}
_SERVER_KEYS = {
    "enabled", "bootstrap_expect", "num_schedulers", "encrypt",
    "authoritative_region", "retry_join", "wire_raft", "raft_protocol",
    "default_scheduler_config", "heartbeat_grace",
}
_CLIENT_KEYS = {
    "enabled", "node_class", "servers", "meta", "host_volume",
}
_ACL_KEYS = {"enabled", "replication_token", "token_ttl", "policy_ttl"}
_TELEMETRY_KEYS = {
    "statsd_address", "statsite_address", "datadog_address", "datadog_tags",
    "prefix", "prometheus_metrics", "collection_interval",
    "flight_interval_s", "flight_retain", "flight_spill_dir",
}
_TLS_KEYS = {
    "http", "rpc", "ca_file", "cert_file", "key_file",
    "verify_server_hostname",
}


def _check_keys(obj: Dict[str, Any], allowed: set, where: str) -> None:
    unknown = set(obj) - allowed
    if unknown:
        raise ConfigError(
            f"unknown {where} config key(s): {', '.join(sorted(unknown))}"
        )


def _as_bool(v: Any, where: str) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    raise ConfigError(f"{where}: expected bool, got {v!r}")


def _as_list(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    return [str(x) for x in v]


def apply_file_config(cfg: AgentConfig, data: Dict[str, Any]) -> AgentConfig:
    """Overlay a merged config-file dict onto an AgentConfig (which
    carries the defaults). Returns a NEW AgentConfig; ``cfg`` is not
    mutated. CLI flags are applied by the caller AFTER this, giving the
    reference's defaults < files < flags precedence."""
    cfg = dataclasses.replace(cfg)
    _check_keys(data, _TOP_KEYS, "top-level")

    if "region" in data:
        cfg.region = str(data["region"])
    if "datacenter" in data:
        cfg.datacenter = str(data["datacenter"])
    if "name" in data:
        cfg.name = str(data["name"])
    if "data_dir" in data:
        cfg.data_dir = str(data["data_dir"])
    if "bind_addr" in data:
        cfg.http_bind = cfg.rpc_bind = cfg.serf_bind = str(data["bind_addr"])
    if "enable_debug" in data:
        cfg.enable_debug = _as_bool(data["enable_debug"], "enable_debug")
    if "device" in data:
        cfg.device = str(data["device"])

    ports = data.get("ports") or {}
    _check_keys(ports, _PORT_KEYS, "ports")
    if "http" in ports:
        cfg.http_port = int(ports["http"])
    if "rpc" in ports:
        cfg.rpc_port = int(ports["rpc"])
    if "serf" in ports:
        cfg.serf_port = int(ports["serf"])

    adv = data.get("advertise") or {}
    _check_keys(adv, {"http", "rpc", "serf"}, "advertise")
    if "rpc" in adv:
        cfg.advertise_addr = str(adv["rpc"])

    srv = data.get("server") or {}
    _check_keys(srv, _SERVER_KEYS, "server")
    if "enabled" in srv:
        cfg.server_enabled = _as_bool(srv["enabled"], "server.enabled")
    if "bootstrap_expect" in srv:
        cfg.bootstrap_expect = int(srv["bootstrap_expect"])
    if "num_schedulers" in srv:
        cfg.num_schedulers = int(srv["num_schedulers"])
    if "encrypt" in srv:
        cfg.encrypt = str(srv["encrypt"])
    if "authoritative_region" in srv:
        cfg.authoritative_region = str(srv["authoritative_region"])
    if "retry_join" in srv:
        cfg.retry_join = _as_list(srv["retry_join"])
    if "wire_raft" in srv:
        cfg.wire_raft = _as_bool(srv["wire_raft"], "server.wire_raft")
    if "heartbeat_grace" in srv:
        try:
            cfg.heartbeat_grace = parse_duration_ns(srv["heartbeat_grace"]) / 1e9
        except HCLError as e:
            raise ConfigError(f"server.heartbeat_grace: {e}") from None
    dsc = srv.get("default_scheduler_config") or {}
    if "scheduler_algorithm" in dsc:
        cfg.scheduler_algorithm = str(dsc["scheduler_algorithm"])
    if "chunk_k" in dsc:
        cfg.chunk_k = int(dsc["chunk_k"])
    if "parity_sample_rate" in dsc:
        cfg.parity_sample_rate = float(dsc["parity_sample_rate"])

    cli = data.get("client") or {}
    _check_keys(cli, _CLIENT_KEYS, "client")
    if "enabled" in cli:
        cfg.client_enabled = _as_bool(cli["enabled"], "client.enabled")
    if "node_class" in cli:
        cfg.node_class = str(cli["node_class"])
    if "servers" in cli:
        cfg.servers = _as_list(cli["servers"])
    if "meta" in cli:
        cfg.meta = {str(k): str(v) for k, v in (cli["meta"] or {}).items()}
    if "host_volume" in cli:
        vols: Dict[str, str] = {}
        for vname, spec in (cli["host_volume"] or {}).items():
            if not isinstance(spec, dict) or "path" not in spec:
                raise ConfigError(
                    f"client.host_volume.{vname}: needs a path attribute"
                )
            vols[str(vname)] = str(spec["path"])
        cfg.host_volumes = vols

    acl = data.get("acl") or {}
    _check_keys(acl, _ACL_KEYS, "acl")
    if "enabled" in acl:
        cfg.acl_enabled = _as_bool(acl["enabled"], "acl.enabled")
    if "replication_token" in acl:
        cfg.replication_token = str(acl["replication_token"])

    tel = data.get("telemetry") or {}
    _check_keys(tel, _TELEMETRY_KEYS, "telemetry")
    # statsite speaks the statsd line protocol; both map onto the
    # statsd push sink (command/agent/command.go:976-1018)
    if "statsd_address" in tel:
        cfg.telemetry_statsd_address = str(tel["statsd_address"])
    elif "statsite_address" in tel:
        cfg.telemetry_statsd_address = str(tel["statsite_address"])
    if "datadog_address" in tel:
        cfg.telemetry_datadog_address = str(tel["datadog_address"])
    if "datadog_tags" in tel:
        cfg.telemetry_datadog_tags = {
            str(k): str(v) for k, v in (tel["datadog_tags"] or {}).items()
        }
    if "prefix" in tel:
        cfg.telemetry_prefix = str(tel["prefix"])
    if "flight_interval_s" in tel:
        cfg.flight_interval_s = float(tel["flight_interval_s"])
    if "flight_retain" in tel:
        cfg.flight_retain = int(tel["flight_retain"])
    if "flight_spill_dir" in tel:
        cfg.flight_spill_dir = str(tel["flight_spill_dir"])

    tls = data.get("tls") or {}
    _check_keys(tls, _TLS_KEYS, "tls")
    if "ca_file" in tls:
        cfg.tls_ca_file = str(tls["ca_file"])
    if "cert_file" in tls:
        cfg.tls_cert_file = str(tls["cert_file"])
    if "key_file" in tls:
        cfg.tls_key_file = str(tls["key_file"])
    if "http" in tls:
        cfg.tls_http = _as_bool(tls["http"], "tls.http")
    if "verify_server_hostname" in tls:
        cfg.tls_verify_server_hostname = _as_bool(
            tls["verify_server_hostname"], "tls.verify_server_hostname"
        )

    return cfg


def load_agent_config(paths: List[str],
                      base: AgentConfig | None = None) -> AgentConfig:
    """defaults -> files (in order) -> returned AgentConfig."""
    return apply_file_config(base or AgentConfig(), load_config_sources(paths))
