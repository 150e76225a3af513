"""Task drivers (reference ``drivers/``): mock, raw_exec/exec, docker,
java, qemu.

Copied from ``nomad_tpu/client/drivers/__init__.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``. No change.
"""
from . import (  # noqa: F401  (registration side effects)
    base,
    docker,
    exec_driver,
    java_driver,
    mock_driver,
    qemu,
    raw_exec,
)
from .base import Driver, DriverError, TaskConfig, TaskHandle, available_drivers, new_driver

__all__ = [
    "Driver",
    "DriverError",
    "TaskConfig",
    "TaskHandle",
    "available_drivers",
    "new_driver",
]
