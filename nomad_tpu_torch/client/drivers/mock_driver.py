"""Scriptable mock driver for tests.

Fills the role of reference ``drivers/mock/driver.go`` (928 LoC): a task
"runs" for ``run_for`` seconds, exits with ``exit_code``, optionally errors
on start (``start_error``), blocks for ``start_block_for``, and ignores the
stop signal for ``kill_after`` (exercising kill-timeout escalation).
Config keys mirror the reference's mock config stanza.

Copied from ``nomad_tpu/client/drivers/mock_driver.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .base import (
    Capabilities,
    Driver,
    DriverError,
    ExitResult,
    TaskConfig,
    TaskHandle,
    TaskStatus,
    register,
)


def _seconds(v) -> float:
    """Accept a number of seconds (possibly as a bare string) or a Go-style
    duration ("5s"). Malformed values surface as DriverError so the task
    runner records a driver failure instead of losing its run thread."""
    try:
        return float(v)
    except (TypeError, ValueError):
        pass
    from ...jobspec.parse import HCLError, parse_duration_ns

    try:
        return parse_duration_ns(v) / 1e9
    except HCLError as e:
        raise DriverError(f"bad duration {v!r}: {e}") from e


class _MockTask:
    def __init__(self, cfg: TaskConfig) -> None:
        self.cfg = cfg
        c = cfg.config
        self.run_for = _seconds(c.get("run_for", 0.0))
        self.exit_code = int(c.get("exit_code", 0))
        self.exit_signal = int(c.get("exit_signal", 0))
        self.kill_after = _seconds(c.get("kill_after", 0.0))
        self.started_at = time.time_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self.kill_requested = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        deadline = time.monotonic() + self.run_for
        while time.monotonic() < deadline:
            if self.kill_requested.wait(timeout=0.01):
                # honor the kill only after kill_after
                time.sleep(self.kill_after)
                self._finish(ExitResult(exit_code=0, signal=15))
                return
        self._finish(ExitResult(exit_code=self.exit_code, signal=self.exit_signal))

    def _finish(self, result: ExitResult) -> None:
        # the force-kill path may have finished the task first; the first
        # result wins and must not be overwritten
        if self.done.is_set():
            return
        self.exit_result = result
        self.completed_at = time.time_ns()
        self.done.set()


class MockDriver(Driver):
    name = "mock"
    capabilities = Capabilities(send_signals=True, exec=False, fs_isolation="none")

    def __init__(self) -> None:
        self.tasks: Dict[str, _MockTask] = {}

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        if cfg.config.get("start_error"):
            raise DriverError(str(cfg.config["start_error"]))
        block = _seconds(cfg.config.get("start_block_for", 0.0))
        if block:
            time.sleep(block)
        if cfg.id in self.tasks:
            raise DriverError(f"task {cfg.id} already started")
        self.tasks[cfg.id] = _MockTask(cfg)
        return TaskHandle(driver=self.name, config=cfg, state="running")

    def _get(self, task_id: str) -> _MockTask:
        t = self.tasks.get(task_id)
        if t is None:
            raise DriverError(f"unknown task {task_id}")
        return t

    def exec_task_streaming(self, task_id: str, cmd):
        """Echo session: every stdin write comes back as output; EOF
        exits 0 (interactive-exec plumbing tests without real processes)."""
        import queue as queue_mod

        self._get(task_id)

        class _EchoSession:
            def __init__(self) -> None:
                self._q: "queue_mod.Queue" = queue_mod.Queue()
                self._code = None
                self._eof = False

            def stdin_write(self, data: bytes) -> None:
                self._q.put(data)

            def stdin_close(self) -> None:
                self._code = 0
                self._q.put(None)

            def read_output(self, timeout: float = 0.25):
                if self._eof:
                    return None
                try:
                    chunk = self._q.get(timeout=timeout)
                except queue_mod.Empty:
                    return b""
                if chunk is None:
                    self._eof = True
                    return None
                return chunk

            def exit_code(self):
                return self._code

            def kill(self) -> None:
                self._code = 137
                self._q.put(None)

        return _EchoSession()

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        t = self._get(task_id)
        if not t.done.wait(timeout=timeout):
            return None
        return t.exit_result

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "SIGTERM") -> None:
        t = self._get(task_id)
        t.kill_requested.set()
        if not t.done.wait(timeout=timeout_s):
            t._finish(ExitResult(exit_code=0, signal=9))  # force kill

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        t = self.tasks.get(task_id)
        if t is None:
            return
        if not t.done.is_set():
            if not force:
                raise DriverError(f"task {task_id} still running")
            self.stop_task(task_id, 0.0)
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

    def signal_task(self, task_id: str, signal: str) -> None:
        self._get(task_id)  # accept silently, like the reference mock

    def recover_task(self, handle: TaskHandle) -> None:
        # mock tasks die with the process; a recovered task is re-started
        if handle.config is not None and handle.config.id not in self.tasks:
            self.tasks[handle.config.id] = _MockTask(handle.config)


register("mock", MockDriver)
