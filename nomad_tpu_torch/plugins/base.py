"""Base plugin protocol (reference ``plugins/base/proto/base.proto``).

Every plugin — driver or device — answers ``PluginInfo``, exposes a config
schema, and accepts ``SetConfig`` before use. The schema is a plain
declarative dict (the hclspec slot, plugins/shared/hclspec): attribute name
→ {"type": ..., "required": ..., "default": ...}; agents validate plugin
stanzas against it without importing the plugin.

Copied from ``nomad_tpu/plugins/base.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

API_VERSION = "v0.1.0"
PLUGIN_TYPE_DRIVER = "driver"
PLUGIN_TYPE_DEVICE = "device"

# stdout handshake line the subprocess prints once its socket is live
# (go-plugin's "CORE-PROTOCOL-VERSION|APP-PROTOCOL-VERSION|NETWORK|ADDR|PROTOCOL")
HANDSHAKE_PREFIX = "NOMAD-TPU-PLUGIN|1|"


@dataclass
class PluginInfo:
    type: str = PLUGIN_TYPE_DRIVER
    name: str = ""
    plugin_version: str = "0.1.0"
    plugin_api_versions: tuple = (API_VERSION,)


class BasePlugin:
    """Implemented by every plugin object served over the socket."""

    def plugin_info(self) -> PluginInfo:
        raise NotImplementedError

    def config_schema(self) -> Dict[str, Any]:
        return {}

    def set_config(self, config: Dict[str, Any]) -> None:
        self.config = dict(config)


def validate_config(schema: Dict[str, Any], config: Dict[str, Any]) -> list:
    """Schema-check a plugin config stanza; returns error strings.

    Schemas are hclspec-style schema-as-data trees (plugins/hclspec.py —
    the reference's plugins/shared/hclspec protocol); the legacy flat
    ``{key: {"type", "required"}}`` form upgrades transparently."""
    from .hclspec import decode

    _, errors = decode(schema, config or {})
    return errors


def decode_config(schema: Dict[str, Any], config: Dict[str, Any]):
    """Validate AND default-apply: (decoded_config, errors)."""
    from .hclspec import decode

    return decode(schema, config or {})
