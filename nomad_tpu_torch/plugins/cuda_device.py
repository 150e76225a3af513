"""CUDA device plugin.

Fills the nvidia-device-plugin slot (reference ``devices/gpu/nvidia/``:
NVML fingerprint → device groups, Reserve → ``NVIDIA_VISIBLE_DEVICES``)
for the cards the PyTorch port runs on: fingerprints the host's CUDA
devices through ``torch.cuda``, exposes them as schedulable device groups
(vendor ``nvidia``, type ``gpu``, one group per device name, one instance
per ordinal), and reserves instances by exporting ``CUDA_VISIBLE_DEVICES``
so the task's CUDA runtime binds only its assigned cards.

An instance's id is its ordinal within this process's own visible set.
When the plugin's process was started under ``CUDA_VISIBLE_DEVICES``
(an index or a ``GPU-``/``MIG-`` UUID per card), the reservation exports
that entry of the set, not the ordinal: a task inherits the client's
environment with the reservation laid over it, so exporting ordinal 0
of a host started with ``CUDA_VISIBLE_DEVICES=3`` would hand the task
physical card 0, a card the server never assigned.

The port of ``nomad_tpu/plugins/tpu_device.py``, which fingerprints with
``jax.devices()``, falls back to JAX's CPU devices and reserves with
``TPU_VISIBLE_CHIPS``. This plugin reports no device group when
``torch.cuda.is_available()`` is false: a host without CUDA has no GPU to
schedule, and nothing falls back to the CPU (nvidia fingerprint.go does
the same when NVML is absent).

Fingerprinting reads the device count and names only. It allocates
nothing on a card and makes no stream, so a process that only
fingerprints holds no CUDA context where ``torch.cuda`` allows that.
"""
from __future__ import annotations

import os
import time
from typing import List

from .device import (
    ContainerReservation,
    DetectedDevice,
    DeviceGroup,
    DevicePlugin,
    DeviceStats,
)


class CUDADevicePlugin(DevicePlugin):
    name = "cuda"
    config_schema_spec = {}

    def __init__(self) -> None:
        self.config = {}

    def config_schema(self):
        return self.config_schema_spec

    def _detect(self) -> List[DeviceGroup]:
        import torch

        if not torch.cuda.is_available():
            return []
        groups = {}
        for i in range(torch.cuda.device_count()):
            name = torch.cuda.get_device_name(i)
            g = groups.get(name)
            if g is None:
                g = groups[name] = DeviceGroup(vendor="nvidia", type="gpu", name=name,
                                               attributes={})
            g.devices.append(DetectedDevice(id=str(i)))
        for g in groups.values():
            g.attributes["count"] = str(len(g.devices))
        return list(groups.values())

    def fingerprint(self) -> List[DeviceGroup]:
        # no memoization: the device manager's periodic pass must see
        # cards appear or go unhealthy
        return self._detect()

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        known = {d.id for g in self.fingerprint() for d in g.devices}
        for did in device_ids:
            if did not in known:
                raise ValueError(f"unknown CUDA device {did!r}")
        ordinals = sorted(device_ids, key=lambda x: int(x) if x.isdigit() else 0)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            entries = [e.strip() for e in visible.split(",")]
            ordinals = [entries[int(o)] for o in ordinals]
        return ContainerReservation(envs={"CUDA_VISIBLE_DEVICES": ",".join(ordinals)})

    def stats(self) -> DeviceStats:
        return DeviceStats(
            instance_stats={d.id: {"healthy": 1.0} for g in self.fingerprint()
                            for d in g.devices},
            timestamp_ns=time.time_ns(),
        )


def plugin() -> CUDADevicePlugin:
    return CUDADevicePlugin()
