"""Java driver (reference ``drivers/java``, 800 LoC): runs a jar or a
class through the host JVM. Command construction mirrors driver.go
javaCmdArgs (jvm_options → -jar jar_path | -cp class_path class → args);
process supervision reuses the raw-exec machinery. Fingerprint degrades
to undetected without a ``java`` binary (driver.go Fingerprint exec of
``java -version``).

Copied from ``nomad_tpu/client/drivers/java_driver.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``. No change.
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


def java_cmd_args(config: dict) -> list:
    """driver.go javaCmdArgs."""
    args = [str(a) for a in config.get("jvm_options", [])]
    if config.get("jar_path"):
        args += ["-jar", str(config["jar_path"])]
    elif config.get("class"):
        if config.get("class_path"):
            args += ["-cp", str(config["class_path"])]
        args.append(str(config["class"]))
    else:
        raise DriverError("java requires config.jar_path or config.class")
    args += [str(a) for a in config.get("args", [])]
    return args


class JavaDriver(RawExecDriver):
    name = "java"
    capabilities = Capabilities(send_signals=True, exec=False, fs_isolation="none")
    produces_logs = True

    def fingerprint(self) -> Fingerprint:
        java = shutil.which("java")
        if java is None:
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description="java binary not found")
        try:
            out = subprocess.run(
                [java, "-version"], capture_output=True, text=True, timeout=10
            )
            version_line = (out.stderr or out.stdout).splitlines()[0]
        except (OSError, subprocess.TimeoutExpired, IndexError):
            version_line = "unknown"
        return Fingerprint(health=HEALTH_HEALTHY, attributes={
            "driver.java": "1",
            "driver.java.version": version_line,
        })

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        rewritten = TaskConfig(**{**cfg.__dict__})
        rewritten.config = {
            "command": shutil.which("java") or "java",
            "args": java_cmd_args(cfg.config),
        }
        handle = super().start_task(rewritten)
        handle.driver = self.name
        return handle


register("java", JavaDriver)
