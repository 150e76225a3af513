"""Driver plugin protocol: serve / consume a task driver over the plugin
transport.

Fills the role of reference ``plugins/drivers`` (driver.go:40 DriverPlugin,
client.go gRPC client, server.go gRPC server): ``DriverPluginShim`` is the
subprocess side wrapping a concrete ``Driver``; ``ExternalDriver`` is the
agent side — a ``Driver`` whose every method crosses the process boundary,
so the task runner and fingerprinter run unchanged against in-process and
out-of-process drivers alike.

Copied from ``nomad_tpu/plugins/driver_plugin.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..client.drivers.base import (
    Capabilities,
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStats,
    TaskStatus,
)
from .base import PLUGIN_TYPE_DRIVER, BasePlugin, PluginInfo
from .transport import PluginClient, PluginError


class DriverPluginShim(BasePlugin):
    """Subprocess side: exposes a concrete Driver over the socket."""

    def __init__(self, driver: Driver) -> None:
        self.driver = driver

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(type=PLUGIN_TYPE_DRIVER, name=self.driver.name)

    def config_schema(self) -> Dict[str, Any]:
        return getattr(self.driver, "config_schema", {})

    def set_config(self, config: Dict[str, Any]) -> None:
        setter = getattr(self.driver, "set_config", None)
        if setter is not None:
            setter(config)

    def capabilities(self) -> Capabilities:
        return self.driver.capabilities

    def produces_logs(self) -> bool:
        return bool(getattr(self.driver, "produces_logs", False))

    def fingerprint(self) -> Fingerprint:
        return self.driver.fingerprint()

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        return self.driver.start_task(cfg)

    def wait_task(self, task_id: str, timeout: Optional[float] = None):
        return self.driver.wait_task(task_id, timeout)

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "SIGTERM") -> None:
        self.driver.stop_task(task_id, timeout_s, signal)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        self.driver.destroy_task(task_id, force)

    def inspect_task(self, task_id: str) -> TaskStatus:
        return self.driver.inspect_task(task_id)

    def task_stats(self, task_id: str) -> TaskStats:
        return self.driver.task_stats(task_id)

    def recover_task(self, handle: TaskHandle) -> None:
        self.driver.recover_task(handle)

    def signal_task(self, task_id: str, signal: str) -> None:
        self.driver.signal_task(task_id, signal)

    def exec_task(self, task_id: str, cmd: List[str], timeout_s: float):
        return self.driver.exec_task(task_id, cmd, timeout_s)


class ExternalDriver(Driver):
    """Agent side: a Driver backed by a plugin subprocess. One instance
    (and one subprocess) is shared by every task using the driver —
    the reference's drivermanager holds one plugin instance per driver."""

    def __init__(self, name: str, client: PluginClient) -> None:
        self.name = name
        self.client = client
        try:
            self.capabilities = client.call("capabilities", timeout=10.0)
        except PluginError:
            self.capabilities = Capabilities()
        try:
            self.produces_logs = client.call("produces_logs", timeout=10.0)
        except PluginError:
            # older plugin without the method: don't clobber capabilities
            self.produces_logs = False

    def _call(self, method: str, *args, timeout: Optional[float] = None):
        try:
            return self.client.call(method, *args, timeout=timeout)
        except PluginError as e:
            raise DriverError(str(e)) from e

    def plugin_info(self) -> PluginInfo:
        return self._call("plugin_info", timeout=10.0)

    def config_schema(self) -> Dict[str, Any]:
        return self._call("config_schema", timeout=10.0)

    def set_config(self, config: Dict[str, Any]) -> None:
        self._call("set_config", config, timeout=10.0)

    def fingerprint(self) -> Fingerprint:
        try:
            return self._call("fingerprint", timeout=10.0)
        except DriverError as e:
            from ..client.drivers.base import HEALTH_UNDETECTED

            return Fingerprint(health=HEALTH_UNDETECTED, health_description=str(e))

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        return self._call("start_task", cfg, timeout=60.0)

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        # socket timeout must outlast the server-side wait
        sock_timeout = None if timeout is None else timeout + 10.0
        return self._call("wait_task", task_id, timeout, timeout=sock_timeout)

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "SIGTERM") -> None:
        self._call("stop_task", task_id, timeout_s, signal, timeout=timeout_s + 30.0)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        self._call("destroy_task", task_id, force, timeout=30.0)

    def inspect_task(self, task_id: str) -> TaskStatus:
        return self._call("inspect_task", task_id, timeout=10.0)

    def task_stats(self, task_id: str) -> TaskStats:
        return self._call("task_stats", task_id, timeout=10.0)

    def recover_task(self, handle: TaskHandle) -> None:
        self._call("recover_task", handle, timeout=30.0)

    def signal_task(self, task_id: str, signal: str) -> None:
        self._call("signal_task", task_id, signal, timeout=10.0)

    def exec_task(self, task_id: str, cmd: List[str], timeout_s: float) -> Tuple[bytes, int]:
        out = self._call("exec_task", task_id, cmd, timeout_s, timeout=timeout_s + 30.0)
        data, code = out
        return bytes(data), code

    def close(self) -> None:
        self.client.close()
