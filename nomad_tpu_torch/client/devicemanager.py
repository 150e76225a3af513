"""Client device manager.

Fills the role of reference ``client/devicemanager`` (989 LoC): owns the
node's device plugin instances (in-process built-ins and subprocess
plugins alike — both satisfy ``DevicePlugin``), merges their fingerprints
into ``Node.NodeResources.Devices`` for the scheduler's DeviceChecker /
deviceAllocator, and at task start turns the alloc's
``AllocatedDeviceResource`` assignments into env vars + mounts via the
owning plugin's ``Reserve`` (devicemanager manager.go → instance.go).

Copied from ``nomad_tpu/client/devicemanager.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. The built-in ``"cuda"`` plugin
(``plugins.cuda_device``) takes the place of the reference's ``"tpu"``;
the logger is ``nomad_tpu_torch.devicemanager``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..plugins.device import ContainerReservation, DevicePlugin
from ..structs.structs import (
    AllocatedDeviceResource,
    Node,
    NodeDeviceInstance,
    NodeDeviceResource,
)

logger = logging.getLogger("nomad_tpu_torch.devicemanager")

GroupId = Tuple[str, str, str]  # (vendor, type, name)


class DeviceManager:
    def __init__(self, plugins: Optional[List[DevicePlugin]] = None,
                 fingerprint_interval: float = 30.0) -> None:
        self.plugins: List[DevicePlugin] = list(plugins or [])
        self.fingerprint_interval = fingerprint_interval
        self._owners: Dict[GroupId, DevicePlugin] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set by the client: called with the fresh device list when a
        # periodic fingerprint changes it (triggers node re-registration)
        self.on_devices_changed = None
        self._last: List[NodeDeviceResource] = []

    # -- fingerprint -----------------------------------------------------

    def fingerprint(self) -> List[NodeDeviceResource]:
        """One fingerprint pass over every plugin; remembers which plugin
        owns each device group for later reservation."""
        out: List[NodeDeviceResource] = []
        owners: Dict[GroupId, DevicePlugin] = {}
        for plugin in self.plugins:
            try:
                groups = plugin.fingerprint()
            except Exception as e:  # noqa: BLE001 — a sick plugin mustn't kill the node
                logger.warning("device plugin %s fingerprint failed: %s",
                               getattr(plugin, "name", "?"), e)
                continue
            for g in groups:
                res = NodeDeviceResource(
                    vendor=g.vendor,
                    type=g.type,
                    name=g.name,
                    instances=[
                        NodeDeviceInstance(id=d.id, healthy=d.healthy)
                        for d in g.devices
                    ],
                    attributes=dict(g.attributes),
                )
                out.append(res)
                owners[(g.vendor, g.type, g.name)] = plugin
        with self._lock:
            self._owners = owners
            self._last = out
        return out

    def fingerprint_node(self, node: Node) -> None:
        """Merge device groups into the node (client.go:1324
        updateNodeFromFingerprint, batchFirstFingerprints)."""
        self.apply_to_node(node, self.fingerprint())

    @staticmethod
    def apply_to_node(node: Node, devices: List[NodeDeviceResource]) -> None:
        """Write devices into BOTH node_resources and the device.*
        attributes constraints match against — they must never diverge."""
        if node.node_resources is not None:
            node.node_resources.devices = devices
        stale = [k for k in node.attributes if k.startswith("device.")]
        for k in stale:
            del node.attributes[k]
        for res in devices:
            key = f"device.{res.vendor}.{res.type}.{res.name}"
            node.attributes[f"{key}.count"] = str(len(res.instances))
            for attr, val in res.attributes.items():
                node.attributes[f"{key}.{attr}"] = str(val)

    # -- reservation -----------------------------------------------------

    def reserve(self, assignments: List[AllocatedDeviceResource]) -> ContainerReservation:
        """Reserve every assigned device group; merged env/mounts/devices
        (taskrunner device_hook semantics)."""
        merged = ContainerReservation()
        for asg in assignments:
            with self._lock:
                plugin = self._owners.get((asg.vendor, asg.type, asg.name))
            if plugin is None:
                raise DeviceReservationError(
                    f"no device plugin owns {asg.vendor}/{asg.type}/{asg.name}"
                )
            res = plugin.reserve(list(asg.device_ids))
            merged.envs.update(res.envs)
            merged.mounts.extend(res.mounts)
            merged.devices.extend(res.devices)
        return merged

    # -- periodic refresh ------------------------------------------------

    def start(self) -> None:
        if self.fingerprint_interval <= 0 or not self.plugins:
            return
        self._thread = threading.Thread(
            target=self._loop, name="devicemanager", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.fingerprint_interval):
            before = self._snapshot_ids()
            self.fingerprint()
            if self._snapshot_ids() != before and self.on_devices_changed is not None:
                try:
                    self.on_devices_changed(list(self._last))
                except Exception:  # noqa: BLE001
                    logger.exception("devices-changed callback failed")

    def _snapshot_ids(self):
        with self._lock:
            return [
                (r.vendor, r.type, r.name,
                 tuple((i.id, i.healthy) for i in r.instances))
                for r in self._last
            ]

    def stop(self) -> None:
        self._stop.set()
        for plugin in self.plugins:
            close = getattr(plugin, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001
                    pass


class DeviceReservationError(Exception):
    pass


def builtin_device_plugin(name: str, config: Optional[dict] = None) -> DevicePlugin:
    """Instantiate a built-in device plugin by name (the device half of
    the plugin catalog's built-in registry)."""
    if name in ("mock", "mock-device"):
        from ..plugins.mock_device import MockDevicePlugin

        plugin = MockDevicePlugin()
    elif name == "cuda":
        from ..plugins.cuda_device import CUDADevicePlugin

        plugin = CUDADevicePlugin()
    else:
        raise ValueError(f"unknown built-in device plugin {name!r}")
    if config:
        plugin.set_config(config)
    return plugin
