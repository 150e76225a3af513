"""Plugin system: out-of-process device plugins.

Fills the role of the reference's go-plugin stack (``plugins/base``,
``plugins/device``, ``helper/pluginutils``): plugins run as subprocesses
serving the device protocol over a unix-domain socket with the same
msgpack framing the server RPC uses (the gRPC slot).

Copied in part from ``nomad_tpu/plugins/__init__.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``: it exports only what the
port has. The catalog and the driver plugins come with the client; the
TPU device plugin's place is taken by ``cuda_device``.
"""
from .base import API_VERSION, PluginInfo
from .device import ContainerReservation, DeviceGroup, DevicePlugin

__all__ = [
    "API_VERSION",
    "PluginInfo",
    "DevicePlugin",
    "DeviceGroup",
    "ContainerReservation",
]
