"""Script checks — commands run INSIDE the task via the driver exec API,
heartbeating a Consul TTL check (reference command/agent/consul/
script.go:1-40: Nomad registers script checks as TTL checks and updates
them itself after each run).

Copied from ``nomad_tpu/client/script_checks.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.client.script_checks``.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

logger = logging.getLogger("nomad_tpu_torch.client.script_checks")


def parse_duration_s(v, default: float) -> float:
    """"10s"/"1m"/"500ms" (or a bare number of seconds) → seconds."""
    if v is None or v == "":
        return default
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1000.0
        if s.endswith("h"):
            return float(s[:-1]) * 3600.0
        if s.endswith("m"):
            return float(s[:-1]) * 60.0
        if s.endswith("s"):
            return float(s[:-1])
        return float(s)
    except ValueError:
        return default


class ScriptCheckRunner:
    """One script check: exec the command every ``interval`` with
    ``timeout``, report passing (exit 0) / critical to the TTL check."""

    def __init__(self, consul, check_id: str, command: str, args: List[str],
                 interval_s: float, timeout_s: float,
                 exec_fn: Callable[[List[str], float], tuple],
                 stop_event: Optional[threading.Event] = None) -> None:
        self.consul = consul
        self.check_id = check_id
        self.cmd = [command] + list(args or [])
        self.interval_s = max(interval_s, 0.1)
        self.timeout_s = timeout_s
        self.exec_fn = exec_fn
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"script-check-{self.check_id[-12:]}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                out, code = self.exec_fn(self.cmd, self.timeout_s)
                # Consul's script convention (script.go): 0 passing,
                # 1 warning (degraded but discoverable), else critical
                status = {0: "passing", 1: "warning"}.get(code, "critical")
                output = out.decode(errors="replace") if isinstance(out, bytes) else str(out)
            except Exception as e:  # noqa: BLE001 — exec failure = critical
                status, output = "critical", str(e)
            # a stop that landed mid-exec means the check may already be
            # deregistered — don't heartbeat into the void
            if self._stop.is_set():
                return
            try:
                self.consul.update_ttl(self.check_id, status, output[-500:])
            except Exception as e:  # noqa: BLE001 — consul blip, retry next tick
                logger.warning("ttl update for %s failed: %s", self.check_id, e)
            if self._stop.wait(self.interval_s):
                return
