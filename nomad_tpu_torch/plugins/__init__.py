"""Plugin system: out-of-process driver/device plugins.

Fills the role of the reference's go-plugin stack (``plugins/base``,
``plugins/drivers``, ``plugins/device``, ``helper/pluginutils``): plugins
run as subprocesses serving the driver/device protocol over a unix-domain
socket with the same msgpack framing the server RPC uses (the gRPC slot),
discovered and launched by a catalog.

Copied from ``nomad_tpu/plugins/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. The TPU device plugin's place is taken
by ``cuda_device``.
"""
from .base import API_VERSION, PluginInfo
from .catalog import Catalog, register_external_driver
from .device import ContainerReservation, DeviceGroup, DevicePlugin

__all__ = [
    "API_VERSION",
    "PluginInfo",
    "Catalog",
    "register_external_driver",
    "DevicePlugin",
    "DeviceGroup",
    "ContainerReservation",
]
