"""raw_exec driver: unisolated fork/exec.

Fills the role of reference ``drivers/rawexec/driver.go`` (712 LoC): runs
``command`` + ``args`` as a child process with the task env, stdout/stderr
captured to the task log dir, no resource isolation. Process-group kill
(setsid) mirrors the reference's executor shutdown. Recovery re-attaches by
pid (reference RecoverTask via the executor reattach config).

Copied from ``nomad_tpu/client/drivers/raw_exec.py`` into the PyTorch
port, which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import os
import signal as _signal
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from .base import (
    Capabilities,
    Driver,
    DriverError,
    ExitResult,
    TaskConfig,
    TaskHandle,
    TaskStats,
    TaskStatus,
    open_task_output,
    register,
)

_SIGNALS = {s.name: s.value for s in _signal.Signals}


class _ExecTask:
    def __init__(self, cfg: TaskConfig) -> None:
        command = cfg.config.get("command")
        if not command:
            raise DriverError("raw_exec requires config.command")
        args = [str(a) for a in cfg.config.get("args", [])]
        cwd = cfg.task_dir.dir if cfg.task_dir is not None else None
        self.stdout = open_task_output(cfg.stdout_path) if cfg.stdout_path else subprocess.DEVNULL
        self.stderr = open_task_output(cfg.stderr_path) if cfg.stderr_path else subprocess.DEVNULL
        env = dict(os.environ)
        env.update(cfg.env)
        try:
            self.proc = subprocess.Popen(
                [command] + args,
                env=env,
                cwd=cwd,
                stdout=self.stdout,
                stderr=self.stderr,
                start_new_session=True,  # own process group for group-kill
            )
        except OSError as e:
            for f in (self.stdout, self.stderr):
                if hasattr(f, "close"):
                    f.close()
            raise DriverError(f"failed to start {command}: {e}") from e
        self.cfg = cfg
        self.started_at = time.time_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        threading.Thread(target=self._reap, daemon=True).start()

    def _reap(self) -> None:
        code = self.proc.wait()
        if code < 0:
            self.exit_result = ExitResult(exit_code=0, signal=-code)
        else:
            self.exit_result = ExitResult(exit_code=code)
        self.completed_at = time.time_ns()
        for f in (self.stdout, self.stderr):
            if hasattr(f, "close"):
                f.close()
        self.done.set()

    def signal_group(self, sig: int) -> None:
        try:
            os.killpg(self.proc.pid, sig)
        except ProcessLookupError:
            pass


class RawExecDriver(Driver):
    name = "raw_exec"
    capabilities = Capabilities(send_signals=True, exec=True, fs_isolation="none")
    produces_logs = True

    def __init__(self) -> None:
        self.tasks: Dict[str, _ExecTask] = {}

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        if cfg.id in self.tasks:
            raise DriverError(f"task {cfg.id} already started")
        t = _ExecTask(cfg)
        self.tasks[cfg.id] = t
        return TaskHandle(
            driver=self.name, config=cfg, state="running",
            driver_state={"pid": t.proc.pid},
        )

    def _get(self, task_id: str) -> _ExecTask:
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
        t.signal_group(_SIGNALS.get(signal, _signal.SIGTERM))
        if not t.done.wait(timeout=max(timeout_s, 0.001)):
            t.signal_group(_signal.SIGKILL)
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
            with open(f"/proc/{t.proc.pid}/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            pass
        return TaskStats(memory_rss_bytes=rss, timestamp_ns=time.time_ns())

    def signal_task(self, task_id: str, signal: str) -> None:
        sig = _SIGNALS.get(signal)
        if sig is None:
            raise DriverError(f"unknown signal {signal}")
        self._get(task_id).signal_group(sig)

    def exec_task(self, task_id: str, cmd: List[str], timeout_s: float) -> Tuple[bytes, int]:
        t = self._get(task_id)
        try:
            out = subprocess.run(
                cmd, env=t.cfg.env, capture_output=True, timeout=timeout_s
            )
        except subprocess.TimeoutExpired as e:
            return (e.stdout or b""), 124
        return out.stdout + out.stderr, out.returncode

    def exec_task_streaming(self, task_id: str, cmd: List[str]):
        from .base import SubprocessExecSession

        t = self._get(task_id)
        cwd = None
        td = t.cfg.task_dir
        if td is not None:
            cwd = getattr(td, "local_dir", None) or getattr(td, "dir", None)
        return SubprocessExecSession(cmd, env=t.cfg.env, cwd=cwd)

    def recover_task(self, handle: TaskHandle) -> None:
        """Re-attach to a live pid after client restart (RecoverTask)."""
        pid = handle.driver_state.get("pid")
        cfg = handle.config
        if pid is None or cfg is None:
            raise DriverError("handle missing pid")
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError) as e:
            raise DriverError(f"pid {pid} gone: {e}") from e
        t = _ExecTask.__new__(_ExecTask)
        t.cfg = cfg
        t.stdout = t.stderr = subprocess.DEVNULL
        t.started_at = time.time_ns()
        t.completed_at = 0
        t.exit_result = None
        t.done = threading.Event()

        class _Reattached:
            def __init__(self, pid: int) -> None:
                self.pid = pid

            def wait(self) -> int:
                # not our child: poll liveness (legacy-reattach semantics)
                while True:
                    try:
                        os.kill(self.pid, 0)
                    except ProcessLookupError:
                        return 0
                    time.sleep(0.1)

        t.proc = _Reattached(pid)
        threading.Thread(target=t._reap, daemon=True).start()
        self.tasks[cfg.id] = t


register("raw_exec", RawExecDriver)
