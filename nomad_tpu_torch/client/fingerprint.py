"""Node fingerprinting.

Fills the role of reference ``client/fingerprint/`` + fingerprint_manager.go:
detectors populate ``Node.attributes`` and ``Node.node_resources``. The
registry mirrors fingerprint.go (arch, cpu, memory, storage, host, nomad,
signal); cloud-env detectors (env_aws/env_gce) and consul/vault are absent
with their backends. Driver fingerprints ride the same mechanism
(drivermanager in the reference).

Copied from ``nomad_tpu/client/fingerprint.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change: the node's attributes,
``nomad.revision`` included, are the reference's, so both packages
fingerprint a host alike.
"""
from __future__ import annotations

import multiprocessing
import os
import platform
import shutil
import socket
from typing import Callable, Dict, List

from ..structs.structs import Node, NodeResources

from .drivers.base import HEALTH_HEALTHY, available_drivers, new_driver


def _arch(node: Node) -> None:
    node.attributes["cpu.arch"] = platform.machine()


def _cpu(node: Node) -> None:
    cores = multiprocessing.cpu_count()
    node.attributes["cpu.numcores"] = str(cores)
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except (OSError, ValueError):
        pass
    node.attributes["cpu.frequency"] = str(int(mhz))
    total = int(cores * mhz)
    node.attributes["cpu.totalcompute"] = str(total)
    if node.node_resources.cpu_shares == 0:
        node.node_resources.cpu_shares = total


def _memory(node: Node) -> None:
    mb = 1024
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    mb = int(line.split()[1]) // 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    node.attributes["memory.totalbytes"] = str(mb * 1024 * 1024)
    if node.node_resources.memory_mb == 0:
        node.node_resources.memory_mb = mb


def _storage(node: Node) -> None:
    usage = shutil.disk_usage("/")
    node.attributes["unique.storage.bytestotal"] = str(usage.total)
    node.attributes["unique.storage.bytesfree"] = str(usage.free)
    if node.node_resources.disk_mb == 0:
        node.node_resources.disk_mb = usage.free // (1024 * 1024)


def _host(node: Node) -> None:
    node.attributes["kernel.name"] = platform.system().lower()
    node.attributes["kernel.version"] = platform.release()
    node.attributes["os.name"] = platform.system().lower()
    node.attributes["os.version"] = platform.version()
    node.attributes["unique.hostname"] = socket.gethostname()
    if not node.name:
        node.name = socket.gethostname()


def _network(node: Node) -> None:
    """Interface + speed detection (reference client/fingerprint/network.go);
    mirrors mock.node()'s shape so scheduling fit math sees a real offer."""
    from ..structs.structs import NetworkResource

    ip = "127.0.0.1"
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
    except OSError:
        pass
    node.attributes["unique.network.ip-address"] = ip
    if not node.node_resources.networks:
        node.node_resources.networks = [
            NetworkResource(device="eth0", cidr=f"{ip}/32", ip=ip, mbits=1000)
        ]


def _nomad(node: Node) -> None:
    from .. import __version__

    node.attributes["nomad.version"] = __version__
    node.attributes["nomad.revision"] = "tpu"


def _signal(node: Node) -> None:
    import signal as _s

    node.attributes["os.signals"] = ",".join(sorted(s.name for s in _s.Signals))


def _drivers(node: Node) -> None:
    """Driver detection (the reference's drivermanager fingerprint loop)."""
    from ..structs.structs import DriverInfo

    for name in available_drivers():
        fp = new_driver(name).fingerprint()
        healthy = fp.health == HEALTH_HEALTHY
        node.attributes[f"driver.{name}"] = "1" if healthy else "0"
        node.attributes.update(fp.attributes)
        node.drivers[name] = DriverInfo(
            name=name, detected=True, healthy=healthy,
            health_description=fp.health_description,
        )


FINGERPRINTERS: List[Callable[[Node], None]] = [
    _arch, _cpu, _memory, _storage, _host, _network, _nomad, _signal, _drivers,
]


def fingerprint_node(node: Node) -> Node:
    """Run every detector (fingerprint_manager.go:32 batch first run)."""
    if node.node_resources is None:
        node.node_resources = NodeResources()
    for fp in FINGERPRINTERS:
        fp(node)
    node.compute_class()
    return node
