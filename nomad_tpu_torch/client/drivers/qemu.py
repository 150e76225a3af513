"""QEMU driver (reference ``drivers/qemu``, 816 LoC): boots a VM image
under qemu-system-x86_64. Argument construction mirrors driver.go
StartTask (accelerator, memory from the task's resources, image drive,
port forwards via user-mode netdev, -nographic); supervision reuses the
raw-exec machinery. Fingerprint degrades to undetected without the
binary.

Copied from ``nomad_tpu/client/drivers/qemu.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import shutil
import subprocess

from .base import (
    Capabilities,
    DriverError,
    Fingerprint,
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    TaskConfig,
    TaskHandle,
    register,
)
from .raw_exec import RawExecDriver

QEMU_BIN = "qemu-system-x86_64"


def qemu_args(cfg: TaskConfig) -> list:
    config = cfg.config
    image = config.get("image_path")
    if not image:
        raise DriverError("qemu requires config.image_path")
    mem = cfg.memory_limit_mb or 512
    args = [
        "-machine", f"type=pc,accel={config.get('accelerator', 'tcg')}",
        "-name", cfg.name,
        "-m", f"{mem}M",
        "-drive", f"file={image}",
        "-nographic",
    ]
    port_map = config.get("port_map") or {}
    if port_map:
        fwds = ",".join(
            f"hostfwd=tcp::{host}-:{guest}" for guest, host in port_map.items()
        )
        args += ["-netdev", f"user,id=user.0,{fwds}",
                 "-device", "virtio-net,netdev=user.0"]
    args += [str(a) for a in config.get("args", [])]
    return args


class QemuDriver(RawExecDriver):
    name = "qemu"
    capabilities = Capabilities(send_signals=True, exec=False, fs_isolation="image")
    produces_logs = True

    def fingerprint(self) -> Fingerprint:
        binary = shutil.which(QEMU_BIN)
        if binary is None:
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description=f"{QEMU_BIN} not found")
        try:
            out = subprocess.run([binary, "--version"], capture_output=True,
                                 text=True, timeout=10)
            version = out.stdout.splitlines()[0] if out.stdout else "unknown"
        except (OSError, subprocess.TimeoutExpired):
            version = "unknown"
        return Fingerprint(health=HEALTH_HEALTHY, attributes={
            "driver.qemu": "1",
            "driver.qemu.version": version,
        })

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        rewritten = TaskConfig(**{**cfg.__dict__})
        rewritten.config = {
            "command": shutil.which(QEMU_BIN) or QEMU_BIN,
            "args": qemu_args(cfg),
        }
        handle = super().start_task(rewritten)
        handle.driver = self.name
        return handle


register("qemu", QemuDriver)
