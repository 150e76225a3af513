"""Plugin catalog: built-in registry + external discovery/launch.

Fills the role of reference ``helper/pluginutils/catalog`` (register.go
built-ins) + ``helper/pluginutils/loader`` (external plugin discovery from
plugin_dir, config validation, instance caching): built-in drivers stay
in-process by default; anything in ``plugin_dir`` (executables named
``nomad-driver-*`` / ``nomad-device-*``) or registered via
``register_external_driver`` runs as a subprocess, one shared instance per
plugin name.

Copied from ``nomad_tpu/plugins/catalog.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: the logger is
``nomad_tpu_torch.plugins.catalog``; built-in drivers run under ``python
-m nomad_tpu_torch.plugins.launch``; the subprocess environment is
``launch.plugin_env``, where the device plugins' callers import it too.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Dict, List, Optional

from .base import PLUGIN_TYPE_DEVICE, PLUGIN_TYPE_DRIVER, validate_config
from .device import ExternalDevicePlugin
from .driver_plugin import ExternalDriver
from .launch import plugin_env
from .transport import PluginError, spawn_plugin

logger = logging.getLogger("nomad_tpu_torch.plugins.catalog")

_lock = threading.Lock()
_external_instances: Dict[str, object] = {}


def launch_builtin_driver(name: str) -> ExternalDriver:
    """Run a BUILT-IN driver out-of-process (the reference's default mode:
    every driver is a go-plugin subprocess)."""
    argv = [sys.executable, "-m", "nomad_tpu_torch.plugins.launch", "driver", name]
    client = spawn_plugin(argv, env=plugin_env())
    return ExternalDriver(name, client)


def launch_external(path: str) -> object:
    """Launch a discovered plugin executable; returns ExternalDriver or
    ExternalDevicePlugin based on its self-reported plugin_info."""
    client = spawn_plugin([path], env=plugin_env())
    info = client.call("plugin_info", timeout=10.0)
    if info.type == PLUGIN_TYPE_DRIVER:
        return ExternalDriver(info.name, client)
    if info.type == PLUGIN_TYPE_DEVICE:
        return ExternalDevicePlugin(info.name, client)
    client.close()
    raise PluginError(f"plugin {path} has unknown type {info.type!r}")


_replaced_factories: Dict[str, object] = {}


def register_external_driver(name: str, config: Optional[dict] = None) -> None:
    """Re-register a built-in driver name to run out-of-process: callers
    of ``new_driver(name)`` transparently get the shared subprocess-backed
    instance. ``close_external_driver`` undoes this."""
    from ..client.drivers.base import register

    def factory():
        with _lock:
            inst = _external_instances.get(name)
            if inst is not None and inst.client.alive():
                return inst
            inst = launch_builtin_driver(name)
            if config:
                schema = inst.config_schema()
                errors = validate_config(schema, config) if schema else []
                if errors:
                    inst.close()
                    raise PluginError("; ".join(errors))
                inst.set_config(config)
            _external_instances[name] = inst
            return inst

    prior = register(name, factory)
    with _lock:
        _replaced_factories.setdefault(name, prior)


def close_external_driver(name: str) -> None:
    """Stop the shared subprocess for ``name`` and reinstate whatever
    factory it displaced (typically the in-process built-in)."""
    from ..client.drivers.base import restore

    with _lock:
        inst = _external_instances.pop(name, None)
        prior = _replaced_factories.pop(name, None)
    if inst is not None:
        try:
            inst.close()
        except Exception:  # noqa: BLE001
            pass
    restore(name, prior)


class Catalog:
    """Discovers and owns external plugin instances for one agent."""

    def __init__(self, plugin_dir: str = "") -> None:
        self.plugin_dir = plugin_dir
        self.drivers: Dict[str, ExternalDriver] = {}
        self.devices: Dict[str, ExternalDevicePlugin] = {}
        self._displaced: Dict[str, object] = {}  # name → prior factory

    def discover(self) -> "Catalog":
        """Scan plugin_dir for plugin executables (loader discovery)."""
        if not self.plugin_dir or not os.path.isdir(self.plugin_dir):
            return self
        for entry in sorted(os.listdir(self.plugin_dir)):
            path = os.path.join(self.plugin_dir, entry)
            if not (os.path.isfile(path) and os.access(path, os.X_OK)):
                continue
            if not entry.startswith(("nomad-driver-", "nomad-device-")):
                continue
            try:
                plugin = launch_external(path)
            except (PluginError, OSError) as e:
                # one malformed executable (bad shebang, wrong arch) must
                # not take the node agent down
                logger.warning("failed to launch plugin %s: %s", path, e)
                continue
            if isinstance(plugin, ExternalDriver):
                self.drivers[plugin.name] = plugin
                from ..client.drivers.base import register

                prior = register(plugin.name, lambda p=plugin: p)
                self._displaced.setdefault(plugin.name, prior)
            else:
                self.devices[plugin.name] = plugin
        return self

    def close(self) -> None:
        from ..client.drivers.base import restore

        for name, d in list(self.drivers.items()):
            d.close()
            restore(name, self._displaced.pop(name, None))
        for d in list(self.devices.values()):
            d.close()
        self.drivers.clear()
        self.devices.clear()


def shutdown_external_instances() -> None:
    """Stop every shared subprocess driver and restore displaced
    factories."""
    with _lock:
        names = set(_external_instances) | set(_replaced_factories)
    for name in names:
        close_external_driver(name)
