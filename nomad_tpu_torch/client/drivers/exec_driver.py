"""exec driver: tasks supervised by the native out-of-process executor.

Fills the role of reference ``drivers/exec/driver.go`` + the executor
subprocess boundary (``drivers/shared/executor/``): the driver fork-execs
``nomad-executor`` (C++, native/executor/), which setsids, applies rlimits,
redirects stdio, runs the task, and records "<exit_code> <signal>" in a
status file. Because supervision lives outside the client process, tasks
survive a client restart and recovery re-attaches by executor pid — the
reference's reattach config (plugins/drivers/driver.go:47 RecoverTask).

Copied from ``nomad_tpu/client/drivers/exec_driver.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``. Change: ``nomad-executor``
comes from the port's ``native.ensure_built``, which compiles the unedited
``native/executor/nomad_executor.cpp`` into
``nomad_tpu_torch/native/_build/``.
"""
from __future__ import annotations

import os
import signal as _signal
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...native import ensure_built
from .base import (
    Capabilities,
    Driver,
    DriverError,
    ExitResult,
    TaskConfig,
    TaskHandle,
    TaskStats,
    TaskStatus,
    register,
)


def _proc_start_ticks(pid: int) -> Optional[int]:
    """Kernel start time of a pid (field 22 of /proc/<pid>/stat) — the
    identity that distinguishes a live executor from a recycled pid."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        # comm may contain spaces/parens; field 22 counts from after ')'
        return int(stat.rsplit(")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


class _ExecutorTask:
    def __init__(self, cfg: TaskConfig, executor_bin: str) -> None:
        command = cfg.config.get("command")
        if not command:
            raise DriverError("exec requires config.command")
        args = [str(a) for a in cfg.config.get("args", [])]
        workdir = cfg.task_dir.dir if cfg.task_dir is not None else "/tmp"
        self.status_file = os.path.join(workdir, f".{cfg.name}.status")
        self.pid_file = os.path.join(workdir, f".{cfg.name}.pid")
        for stale in (self.status_file, self.pid_file):
            try:
                os.remove(stale)
            except OSError:
                pass
        argv = [
            executor_bin,
            "--status-file", self.status_file,
            "--pid-file", self.pid_file,
        ]
        if cfg.stdout_path:
            argv += ["--stdout", cfg.stdout_path]
        if cfg.stderr_path:
            argv += ["--stderr", cfg.stderr_path]
        argv += ["--cwd", workdir]
        kill_timeout = float(cfg.config.get("kill_timeout", 5.0))
        argv += ["--kill-timeout", str(kill_timeout)]
        for limit_flag in ("rlimit_cpu", "rlimit_as", "rlimit_nofile"):
            if cfg.config.get(limit_flag):
                argv += [f"--{limit_flag.replace('_', '-')}", str(cfg.config[limit_flag])]
        for k, v in cfg.env.items():
            argv += ["--env", f"{k}={v}"]
        argv += ["--", command] + args
        try:
            self.proc: Optional[subprocess.Popen] = subprocess.Popen(
                argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
            )
        except OSError as e:
            raise DriverError(f"failed to launch executor: {e}") from e
        self.pid = self.proc.pid
        self.cfg = cfg
        self.started_at = time.time_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        threading.Thread(target=self._reap, daemon=True).start()

    def task_pgid(self) -> Optional[int]:
        """The task's process-group id (== the executor's child pid)."""
        try:
            with open(self.pid_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _read_status(self) -> Optional[ExitResult]:
        try:
            with open(self.status_file) as f:
                parts = f.read().split()
            return ExitResult(exit_code=int(parts[0]), signal=int(parts[1]))
        except (OSError, IndexError, ValueError):
            return None

    def _executor_alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        try:
            os.kill(self.pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def _reap(self) -> None:
        while True:
            if self.proc is not None:
                self.proc.wait()
            else:
                while self._executor_alive():
                    time.sleep(0.1)
            result = self._read_status()
            if result is None:
                result = ExitResult(exit_code=127, err="executor died without status")
            self.exit_result = result
            self.completed_at = time.time_ns()
            self.done.set()
            return


class ExecDriver(Driver):
    name = "exec"
    capabilities = Capabilities(send_signals=True, exec=False, fs_isolation="chroot")
    produces_logs = True

    def __init__(self) -> None:
        self.tasks: Dict[str, _ExecutorTask] = {}
        self._executor_bin: Optional[str] = None

    def _bin(self) -> str:
        if self._executor_bin is None:
            self._executor_bin = ensure_built("nomad-executor")
        return self._executor_bin

    def fingerprint(self):
        from .base import HEALTH_HEALTHY, HEALTH_UNDETECTED, Fingerprint

        try:
            self._bin()
        except Exception as e:  # noqa: BLE001
            return Fingerprint(health=HEALTH_UNDETECTED, health_description=str(e))
        return Fingerprint(
            health=HEALTH_HEALTHY, attributes={f"driver.{self.name}": "1"}
        )

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        if cfg.id in self.tasks:
            raise DriverError(f"task {cfg.id} already started")
        t = _ExecutorTask(cfg, self._bin())
        self.tasks[cfg.id] = t
        return TaskHandle(
            driver=self.name, config=cfg, state="running",
            driver_state={
                "pid": t.pid,
                "pid_start_ticks": _proc_start_ticks(t.pid),
                "status_file": t.status_file,
                "pid_file": t.pid_file,
            },
        )

    def _get(self, task_id: str) -> _ExecutorTask:
        t = self.tasks.get(task_id)
        if t is None:
            raise DriverError(f"unknown task {task_id}")
        return t

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        t = self._get(task_id)
        if not t.done.wait(timeout=timeout):
            return None
        return t.exit_result

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "SIGTERM") -> None:
        t = self._get(task_id)
        sig = getattr(_signal, signal, _signal.SIGTERM)
        pgid = t.task_pgid()
        if sig not in (_signal.SIGTERM, _signal.SIGINT) and pgid is not None:
            try:
                os.killpg(pgid, sig)
            except ProcessLookupError:
                pass
        # always poke the executor: it forwards SIGTERM to the task group
        # and escalates itself, and it covers the window before the pid
        # file lands on disk
        try:
            os.kill(t.pid, _signal.SIGTERM)
        except ProcessLookupError:
            pass
        kill_timeout = float(t.cfg.config.get("kill_timeout", 5.0))
        if not t.done.wait(timeout=max(timeout_s, kill_timeout) + 1.5):
            # last resort: SIGKILL the TASK GROUP (not just the executor —
            # the task runs setsid'd and would otherwise be orphaned alive).
            # Re-read the pid file: it may have landed since the first look.
            pgid = t.task_pgid()
            if pgid is not None:
                try:
                    os.killpg(pgid, _signal.SIGKILL)
                except ProcessLookupError:
                    pass
            try:
                os.kill(t.pid, _signal.SIGKILL)
            except ProcessLookupError:
                pass
            t.done.wait(timeout=5.0)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        t = self.tasks.get(task_id)
        if t is None:
            return
        if not t.done.is_set():
            if not force:
                raise DriverError(f"task {task_id} still running")
            self.stop_task(task_id, 0.0, "SIGKILL")
        del self.tasks[task_id]

    def inspect_task(self, task_id: str) -> TaskStatus:
        t = self._get(task_id)
        return TaskStatus(
            id=task_id,
            name=t.cfg.name,
            state="exited" if t.done.is_set() else "running",
            started_at_ns=t.started_at,
            completed_at_ns=t.completed_at,
            exit_result=t.exit_result,
        )

    def task_stats(self, task_id: str) -> TaskStats:
        t = self._get(task_id)
        rss = 0
        try:
            with open(f"/proc/{t.pid}/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            pass
        return TaskStats(memory_rss_bytes=rss, timestamp_ns=time.time_ns())

    def signal_task(self, task_id: str, signal: str) -> None:
        sig = getattr(_signal, signal, None)
        if sig is None:
            raise DriverError(f"unknown signal {signal}")
        t = self._get(task_id)
        pgid = t.task_pgid()
        try:
            if pgid is not None:
                os.killpg(pgid, sig)  # deliver to the task, not the supervisor
            else:
                os.kill(t.pid, sig)
        except ProcessLookupError:
            pass

    def recover_task(self, handle: TaskHandle) -> None:
        """Re-attach to a live executor by pid (RecoverTask)."""
        pid = (handle.driver_state or {}).get("pid")
        cfg = handle.config
        if pid is None or cfg is None:
            raise DriverError("handle missing pid")
        expected_ticks = handle.driver_state.get("pid_start_ticks")
        actual_ticks = _proc_start_ticks(pid)
        if (
            actual_ticks is not None
            and expected_ticks is not None
            and actual_ticks != expected_ticks
        ):
            raise DriverError(f"pid {pid} was recycled (start time mismatch)")
        t = _ExecutorTask.__new__(_ExecutorTask)
        t.cfg = cfg
        t.pid = pid
        t.proc = None  # not our child anymore
        t.status_file = handle.driver_state.get("status_file", "")
        t.pid_file = handle.driver_state.get("pid_file", "")
        t.started_at = time.time_ns()
        t.completed_at = 0
        t.exit_result = None
        t.done = threading.Event()
        # the executor may have finished while we were down
        if not t._executor_alive() and t._read_status() is None:
            raise DriverError(f"executor pid {pid} gone without status")
        threading.Thread(target=t._reap, daemon=True).start()
        self.tasks[cfg.id] = t


register("exec", ExecDriver)
