"""E2E framework: fork-exec black-box agents driven over HTTP.

Fills the role of reference ``e2e/framework/framework.go`` +
``testutil/server.go`` (TestServer launches the real compiled nomad
binary and drives it over the API): each agent is a real
``python -m nomad_tpu_torch.cli agent`` OS process; tests interact only
through the SDK, exactly like a user.

The PyTorch port's copy of ``tests/e2e_framework.py``: each agent runs the
port's CLI with ``-device cpu``, and the environment sets nothing for JAX.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


class AgentProc:
    """One real agent process (testutil.TestServer)."""

    def __init__(self, *flags: str, name: str = "e2e") -> None:
        import queue
        import threading

        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch.cli", "agent",
             "-http-port", "0", "-device", "cpu", *flags],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=_env(),
            text=True,
        )
        # a pump thread owns stdout for the process lifetime: the banner
        # wait must be able to time out (readline blocks), and a chatty
        # agent must never stall on a full pipe after the banner
        self.lines: List[str] = []
        self._line_q: "queue.Queue[str]" = queue.Queue()

        def _pump() -> None:
            try:
                for line in self.proc.stdout:
                    self.lines.append(line)
                    self._line_q.put(line)
            except (ValueError, OSError):
                pass

        threading.Thread(target=_pump, daemon=True,
                         name=f"agent-pump-{name}").start()
        self.http_addr = self._await_banner()

    def _await_banner(self, timeout: float = 120.0) -> str:
        import queue

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self._line_q.get(timeout=0.2)
            except queue.Empty:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"agent {self.name} exited {self.proc.returncode}: "
                        + "".join(self.lines[-10:])
                    )
                continue
            if "HTTP at" in line:
                return line.rsplit(" ", 1)[1].strip()
        raise RuntimeError(f"agent {self.name} never printed its address")

    @property
    def api(self):
        from nomad_tpu_torch.api import Client, Config

        return Client(Config(address=self.http_addr))

    def kill_hard(self) -> None:
        """SIGKILL — the clientstate crash-recovery scenario."""
        self.proc.kill()
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)


def wait_until(fn, timeout=120.0, msg="condition", interval=0.3):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            if fn():
                return
        except Exception as e:  # noqa: BLE001 — agents may still be booting
            last = e
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg} (last error: {last})")


def service_job(job_id: str, count: int = 1, command: str = "sleep",
                args: Optional[list] = None, **tg_extra) -> dict:
    tg = {
        "Name": "g",
        "Count": count,
        "Tasks": [{
            "Name": "t", "Driver": "raw_exec",
            "Config": {"command": "/bin/sh",
                       "args": ["-c", command] if args is None else args},
            "Resources": {"CPU": 50, "MemoryMB": 32},
        }],
    }
    tg.update(tg_extra)
    return {"ID": job_id, "Name": job_id, "Type": "service",
            "Datacenters": ["dc1"], "TaskGroups": [tg]}


def allocs_of(api, job_id: str) -> list:
    allocs, _ = api.jobs.allocations(job_id)
    return allocs or []


def running_allocs(api, job_id: str) -> list:
    return [a for a in allocs_of(api, job_id) if a["ClientStatus"] == "running"]
