"""Task driver interface.

Fills the role of reference ``plugins/drivers/driver.go:40 DriverPlugin``:
TaskConfigSchema / Capabilities / Fingerprint / StartTask / WaitTask /
StopTask / DestroyTask / RecoverTask / InspectTask / TaskStats / SignalTask /
ExecTask. The reference runs drivers as go-plugin gRPC subprocesses; here
drivers are in-process classes behind the same interface, so an
out-of-process transport can wrap them without changing callers (the same
boundary discipline as the scheduler's State/Planner interfaces).

Copied from ``nomad_tpu/client/drivers/base.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# driver health (driver.go HealthState*)
HEALTH_UNDETECTED = "undetected"
HEALTH_UNHEALTHY = "unhealthy"
HEALTH_HEALTHY = "healthy"


@dataclass
class Fingerprint:
    health: str = HEALTH_HEALTHY
    health_description: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class TaskConfig:
    """What a driver needs to start a task (driver.go TaskConfig)."""

    id: str = ""  # <alloc_id>/<task_name>
    name: str = ""
    alloc_id: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)  # driver-specific
    task_dir: Optional[object] = None  # allocdir.TaskDir
    stdout_path: str = ""
    stderr_path: str = ""
    cpu_limit: int = 0
    memory_limit_mb: int = 0
    user: str = ""
    # device reservations (plugins/device ContainerReservation): isolating
    # drivers (docker/exec) honor these; unisolated drivers see the env only
    mounts: List[Any] = field(default_factory=list)
    devices: List[Any] = field(default_factory=list)


@dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: str = ""

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


@dataclass
class TaskStatus:
    id: str = ""
    name: str = ""
    state: str = "unknown"  # running | exited | unknown
    started_at_ns: int = 0
    completed_at_ns: int = 0
    exit_result: Optional[ExitResult] = None


@dataclass
class TaskStats:
    cpu_percent: float = 0.0
    memory_rss_bytes: int = 0
    timestamp_ns: int = 0


@dataclass
class Capabilities:
    """driver.go Capabilities."""

    send_signals: bool = False
    exec: bool = False
    fs_isolation: str = "none"  # none | chroot | image


@dataclass
class TaskHandle:
    """Serializable handle for recovery after a client restart
    (driver.go TaskHandle)."""

    driver: str = ""
    config: Optional[TaskConfig] = None
    state: str = "running"
    driver_state: Dict[str, Any] = field(default_factory=dict)  # e.g. pid


class DriverError(Exception):
    pass


def open_task_output(path: str, timeout: float = 30.0):
    """Open a task output path for append. Logmon paths are FIFOs: wait
    for the reader with a deadline instead of blocking forever (a dead
    logmon must fail the start, not hang the task runner), then clear
    O_NONBLOCK so the task's own writes block normally."""
    import errno
    import fcntl
    import os
    import stat as stat_mod

    try:
        is_fifo = stat_mod.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        is_fifo = False
    if not is_fifo:
        return open(path, "ab")
    deadline = time.monotonic() + timeout
    while True:
        try:
            fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError as e:
            if e.errno != errno.ENXIO:
                raise DriverError(f"cannot open task output {path}: {e}") from e
            if time.monotonic() > deadline:
                raise DriverError(
                    f"no log collector reading {path} after {timeout}s"
                ) from e
            time.sleep(0.02)
    flags = fcntl.fcntl(fd, fcntl.F_GETFL)
    fcntl.fcntl(fd, fcntl.F_SETFL, flags & ~os.O_NONBLOCK)
    return os.fdopen(fd, "ab")


class Driver:
    """Base driver (DriverPlugin). Subclasses register via ``register``."""

    name = "base"
    capabilities = Capabilities()
    # drivers that redirect task stdout/stderr into the provided paths get
    # logmon FIFOs + rotation; purely synthetic drivers (mock) skip it
    produces_logs = False

    def fingerprint(self) -> Fingerprint:
        """One-shot detection (the reference streams; the client polls)."""
        return Fingerprint(
            health=HEALTH_HEALTHY,
            attributes={f"driver.{self.name}": "1"},
        )

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        raise NotImplementedError

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        """Block until the task exits; None on timeout."""
        raise NotImplementedError

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "SIGTERM") -> None:
        raise NotImplementedError

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        raise NotImplementedError

    def inspect_task(self, task_id: str) -> TaskStatus:
        raise NotImplementedError

    def task_stats(self, task_id: str) -> TaskStats:
        return TaskStats(timestamp_ns=time.time_ns())

    def recover_task(self, handle: TaskHandle) -> None:
        raise DriverError(f"driver {self.name} cannot recover tasks")

    def signal_task(self, task_id: str, signal: str) -> None:
        raise DriverError(f"driver {self.name} does not support signals")

    def exec_task(self, task_id: str, cmd: List[str], timeout_s: float) -> Tuple[bytes, int]:
        raise DriverError(f"driver {self.name} does not support exec")

    def exec_task_streaming(self, task_id: str, cmd: List[str]) -> "ExecSession":
        """Interactive exec in the task's context (the reference's
        websocket-backed `nomad alloc exec`, driver ExecTaskStreaming)."""
        raise DriverError(f"driver {self.name} does not support streaming exec")


class ExecSession:
    """A live interactive command: stdin sink + stdout source + exit code.
    The transport layer (websocket bridge) pumps both directions."""

    def stdin_write(self, data: bytes) -> None:
        raise NotImplementedError

    def stdin_close(self) -> None:
        raise NotImplementedError

    def read_output(self, timeout: float = 0.25) -> Optional[bytes]:
        """Next output chunk; b"" when none ready yet; None at EOF."""
        raise NotImplementedError

    def exit_code(self) -> Optional[int]:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError


class SubprocessExecSession(ExecSession):
    """ExecSession over a local subprocess (raw_exec / exec drivers)."""

    def __init__(self, cmd: List[str], env=None, cwd=None) -> None:
        import queue as queue_mod
        import subprocess
        import threading

        self.proc = subprocess.Popen(
            cmd, env=env, cwd=cwd,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, bufsize=0,
        )
        self._q: "queue_mod.Queue[Optional[bytes]]" = queue_mod.Queue()

        def pump() -> None:
            try:
                while True:
                    # bufsize=0 gives a raw FileIO: read() returns as soon
                    # as ANY bytes are available (one syscall)
                    chunk = self.proc.stdout.read(65536)
                    if not chunk:
                        break
                    self._q.put(chunk)
            finally:
                self._q.put(None)

        self._pump = threading.Thread(target=pump, daemon=True)
        self._pump.start()
        self._eof = False

    def stdin_write(self, data: bytes) -> None:
        try:
            self.proc.stdin.write(data)
            self.proc.stdin.flush()
        except (BrokenPipeError, ValueError, OSError):
            pass

    def stdin_close(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass

    def read_output(self, timeout: float = 0.25) -> Optional[bytes]:
        import queue as queue_mod

        if self._eof:
            return None
        try:
            chunk = self._q.get(timeout=timeout)
        except queue_mod.Empty:
            return b""
        if chunk is None:
            self._eof = True
            try:
                # stdout EOF usually means exit, but a task that closed
                # its stdout while still running must not raise out of
                # the websocket pump
                self.proc.wait(timeout=5)
            except Exception:  # noqa: BLE001 — TimeoutExpired
                pass
            return None
        return chunk

    def exit_code(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass


_REGISTRY: Dict[str, Callable[[], Driver]] = {}


def register(name: str, factory: Callable[[], Driver]) -> Optional[Callable[[], Driver]]:
    """Register a driver factory; returns the factory it replaced (if any)
    so plugin catalogs can restore it on shutdown."""
    prior = _REGISTRY.get(name)
    _REGISTRY[name] = factory
    return prior


def restore(name: str, factory: Optional[Callable[[], Driver]]) -> None:
    """Undo a register(): reinstate the prior factory or drop the name."""
    if factory is None:
        _REGISTRY.pop(name, None)
    else:
        _REGISTRY[name] = factory


def new_driver(name: str) -> Driver:
    factory = _REGISTRY.get(name)
    if factory is None:
        raise DriverError(f"unknown driver {name!r} (have: {sorted(_REGISTRY)})")
    return factory()


def available_drivers() -> List[str]:
    return sorted(_REGISTRY)
