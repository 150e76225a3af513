"""Device plugin protocol (reference ``plugins/device/device.go:20``).

A device plugin fingerprints groups of schedulable devices
(vendor/type/name + attributes), reserves instances for a task (returning
env vars + mounts, device.go Reserve → ContainerReservation), and reports
per-instance stats. ``DevicePluginShim``/``ExternalDevicePlugin`` mirror
the driver plugin split over the same transport.

Copied from ``nomad_tpu/plugins/device.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .base import PLUGIN_TYPE_DEVICE, BasePlugin, PluginInfo
from .transport import PluginClient, PluginError


@dataclass
class DetectedDevice:
    """One device instance (device.go Device)."""

    id: str = ""
    healthy: bool = True
    health_description: str = ""


@dataclass
class DeviceGroup:
    """Homogeneous device group (device.go DeviceGroup): the unit the
    scheduler matches constraints/affinities against."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    devices: List[DetectedDevice] = field(default_factory=list)
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class Mount:
    task_path: str = ""
    host_path: str = ""
    read_only: bool = True


@dataclass
class DeviceSpec:
    task_path: str = ""
    host_path: str = ""
    permissions: str = "rwm"


@dataclass
class ContainerReservation:
    """What a task gets for its reserved devices (device.go
    ContainerReservation)."""

    envs: Dict[str, str] = field(default_factory=dict)
    mounts: List[Mount] = field(default_factory=list)
    devices: List[DeviceSpec] = field(default_factory=list)


@dataclass
class DeviceStats:
    instance_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    timestamp_ns: int = 0


class DevicePlugin(BasePlugin):
    """Concrete device plugins implement fingerprint/reserve/stats."""

    name = "device"

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(type=PLUGIN_TYPE_DEVICE, name=self.name)

    def fingerprint(self) -> List[DeviceGroup]:
        raise NotImplementedError

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        raise NotImplementedError

    def stats(self) -> DeviceStats:
        return DeviceStats(timestamp_ns=time.time_ns())


class DevicePluginShim(BasePlugin):
    """Subprocess side."""

    def __init__(self, plugin: DevicePlugin) -> None:
        self.plugin = plugin

    def plugin_info(self) -> PluginInfo:
        return self.plugin.plugin_info()

    def config_schema(self):
        return self.plugin.config_schema()

    def set_config(self, config) -> None:
        self.plugin.set_config(config)

    def fingerprint(self) -> List[DeviceGroup]:
        return self.plugin.fingerprint()

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        return self.plugin.reserve(device_ids)

    def stats(self) -> DeviceStats:
        return self.plugin.stats()


class ExternalDevicePlugin(DevicePlugin):
    """Agent side: device plugin behind a subprocess boundary."""

    def __init__(self, name: str, client: PluginClient) -> None:
        self.name = name
        self.client = client

    def fingerprint(self) -> List[DeviceGroup]:
        return self.client.call("fingerprint", timeout=30.0)

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        return self.client.call("reserve", device_ids, timeout=30.0)

    def stats(self) -> DeviceStats:
        return self.client.call("stats", timeout=30.0)

    def close(self) -> None:
        self.client.close()
