"""Scriptable mock device plugin (reference ``plugins/device/mock.go``):
fingerprints a configurable group of fake devices and reserves them with
deterministic env vars — the test double for the device manager.

Copied from ``nomad_tpu/plugins/mock_device.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. One addition: the group's device
type (``device_type``, config key ``type``; default ``"gpu"`` as in the
reference), so a mock group can stand for another kind of device, such as
an FPGA.
"""
from __future__ import annotations

import time
from typing import List

from .device import (
    ContainerReservation,
    DetectedDevice,
    DeviceGroup,
    DevicePlugin,
    DeviceStats,
)


class MockDevicePlugin(DevicePlugin):
    name = "mock-device"
    config_schema_spec = {
        "vendor": {"type": "string"},
        "model": {"type": "string"},
        "count": {"type": "int"},
        "type": {"type": "string"},
    }

    def __init__(self, vendor: str = "nomad", model: str = "mock", count: int = 2,
                 device_type: str = "gpu"):
        self.vendor = vendor
        self.model = model
        self.count = count
        self.device_type = device_type
        self.config = {}

    def config_schema(self):
        return self.config_schema_spec

    def set_config(self, config) -> None:
        self.config = dict(config)
        self.vendor = config.get("vendor", self.vendor)
        self.model = config.get("model", self.model)
        self.count = int(config.get("count", self.count))
        self.device_type = config.get("type", self.device_type)

    def fingerprint(self) -> List[DeviceGroup]:
        return [
            DeviceGroup(
                vendor=self.vendor,
                type=self.device_type,
                name=self.model,
                devices=[
                    DetectedDevice(id=f"{self.model}-{i}") for i in range(self.count)
                ],
                attributes={"memory_mib": "4096"},
            )
        ]

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        known = {f"{self.model}-{i}" for i in range(self.count)}
        for did in device_ids:
            if did not in known:
                raise ValueError(f"unknown device {did!r}")
        return ContainerReservation(
            envs={"MOCK_VISIBLE_DEVICES": ",".join(sorted(device_ids))}
        )

    def stats(self) -> DeviceStats:
        return DeviceStats(
            instance_stats={
                f"{self.model}-{i}": {"utilization": 0.0} for i in range(self.count)
            },
            timestamp_ns=time.time_ns(),
        )


def plugin() -> MockDevicePlugin:
    return MockDevicePlugin()
