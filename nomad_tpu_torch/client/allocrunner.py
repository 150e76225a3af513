"""Allocation runner: supervises one allocation's task runners.

Fills the role of reference ``client/allocrunner/`` — alloc_runner.go:237
Run, the prerun/postrun hook chain (alloc_runner_hooks.go:123: allocDir,
await-previous-alloc, health watcher), and ``client/allochealth/`` (the
deployment health tracker: all tasks running for ``min_healthy_time`` ⇒
healthy; any task failing ⇒ unhealthy). Consul/CSI-backed hooks have no
backend here and are omitted.

Copied from ``nomad_tpu/client/allocrunner.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Changes: the logger is
``nomad_tpu_torch.allocrunner.<id>``; ``restart_task`` indexes
``self.task_runners`` by name, so the lock and shared-state lint resolves
the call to ``TaskRunner.restart`` (through a list it fell back to every
``restart`` of the port, the chaos harness's ``ServerProcess.restart``
among them); the task-runner table is written under ``_lock``, since
the agent's alloc stats route reads it from HTTP threads.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..structs.structs import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING,
    ALLOC_DESIRED_RUN,
    Allocation,
    AllocDeploymentStatus,
    TaskState,
)
from .allocdir import AllocDir
from .taskrunner import STATE_DEAD, STATE_RUNNING, TaskRunner


class AllocRunner:
    def __init__(
        self,
        alloc: Allocation,
        base_dir: str,
        node=None,
        on_update: Optional[Callable[["AllocRunner"], None]] = None,
        prev_alloc_watcher: Optional[Callable[[], None]] = None,
        device_manager=None,
        driver_factory=None,
        consul=None,
        vault_fn=None,
        vault_addr: str = "",
    ) -> None:
        self.alloc = alloc
        self.node = node
        self.on_update = on_update
        self.prev_alloc_watcher = prev_alloc_watcher
        self.device_manager = device_manager
        self.driver_factory = driver_factory
        self.consul = consul
        self.vault_fn = vault_fn
        self.vault_addr = vault_addr
        self.logger = logging.getLogger(f"nomad_tpu_torch.allocrunner.{alloc.id[:8]}")

        self.alloc_dir = AllocDir(base_dir, alloc.id)
        self.task_runners: Dict[str, TaskRunner] = {}
        self.deployment_status: Optional[AllocDeploymentStatus] = None
        self._destroyed = threading.Event()
        self._aborted = False  # stopped/GC'd before tasks ever started
        self._lock = threading.Lock()
        self._waiters = 0

        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        self.task_group = tg
        self._health_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def run(self, recover_handles: Optional[Dict] = None) -> None:
        # prerun hooks: await previous alloc (upstream allocs hook), allocDir
        if self.prev_alloc_watcher is not None:
            self.prev_alloc_watcher()
            # the wait can outlive the alloc: a GC/stop that landed while
            # blocked must win, or we'd start tasks nothing tracks anymore.
            # Mark the abort so client_status() reports terminal — a
            # forever-"pending" stopped alloc would block ITS replacement's
            # watcher for the full timeout.
            if self._destroyed.is_set() or self.alloc.terminal_status() or (
                self.alloc.desired_status != ALLOC_DESIRED_RUN
            ):
                self._aborted = True
                self._notify()
                return
        self.alloc_dir.build()
        if self.task_group is None:
            self.logger.error("alloc %s has no task group in job", self.alloc.id)
            return
        for task in self.task_group.tasks:
            td = self.alloc_dir.new_task_dir(task.name)
            tr = TaskRunner(
                self.alloc, task, td, node=self.node, on_state_change=self._notify,
                device_manager=self.device_manager,
                driver_factory=self.driver_factory,
                consul=self.consul,
                vault_fn=self.vault_fn,
                vault_addr=self.vault_addr,
            )
            with self._lock:
                self.task_runners[task.name] = tr
            handle = (recover_handles or {}).get(task.name)
            if handle is not None and not tr.recover(handle):
                self.logger.info("task %s not recoverable; starting fresh", task.name)
        for tr in self.task_runners.values():
            tr.run()
        # GROUP services (incl. Connect sidecar proxy services) register
        # once per alloc (reference allocrunner groupServiceHook)
        self._group_consul_ids = []
        if self.consul is not None and getattr(self.task_group, "services", None):
            address = (
                self.node.attributes.get("unique.network.ip-address", "")
                if self.node is not None else ""
            )
            try:
                self._group_consul_ids = self.consul.register_group_services(
                    self.alloc, self.task_group, address=address
                )
            except Exception as e:  # noqa: BLE001 — consul outage isn't fatal
                self.logger.warning("group consul registration failed: %s", e)
        if self.alloc.deployment_id:
            self._health_thread = threading.Thread(
                target=self._watch_health, daemon=True,
                name=f"allochealth-{self.alloc.id[:8]}",
            )
            self._health_thread.start()

    def _notify(self) -> None:
        # group Consul services deregister as soon as EVERY task is done —
        # a batch alloc that finishes on its own must not leave its group
        # service/sidecar-proxy routing to a dead endpoint until GC
        if (
            getattr(self, "_group_consul_ids", None)
            and self.task_runners
            and all(tr.done.is_set() for tr in self.task_runners.values())
        ):
            ids, self._group_consul_ids = self._group_consul_ids, []
            try:
                self.consul.deregister_ids(ids)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("group consul deregistration failed: %s", e)
        if self.on_update is not None:
            self.on_update(self)

    # -- status roll-up (alloc_runner.go clientAlloc) --------------------

    def task_states(self) -> Dict[str, TaskState]:
        return {name: tr.state for name, tr in self.task_runners.items()}

    def client_status(self) -> str:
        states = list(self.task_states().values())
        if not states:
            return ALLOC_CLIENT_COMPLETE if self._aborted else ALLOC_CLIENT_PENDING
        if any(s.state == STATE_DEAD and s.failed for s in states):
            return ALLOC_CLIENT_FAILED
        if all(s.state == STATE_DEAD for s in states):
            return ALLOC_CLIENT_COMPLETE
        if any(s.state == STATE_RUNNING for s in states):
            return ALLOC_CLIENT_RUNNING
        return ALLOC_CLIENT_PENDING

    def client_alloc(self) -> Allocation:
        """The status-sync payload (client.go allocSync entries)."""
        a = Allocation(
            id=self.alloc.id,
            namespace=self.alloc.namespace,
            job_id=self.alloc.job_id,
            task_group=self.alloc.task_group,
            node_id=self.alloc.node_id,
            deployment_id=self.alloc.deployment_id,
        )
        a.client_status = self.client_status()
        a.task_states = {k: v for k, v in self.task_states().items()}
        a.deployment_status = self.deployment_status
        a.modify_time_ns = time.time_ns()
        return a

    # -- deployment health (client/allochealth/tracker.go) ---------------

    def _watch_health(self) -> None:
        tg = self.task_group
        update = tg.update if tg is not None else None
        min_healthy_ns = update.min_healthy_time_ns if update is not None else 10 * 10**9
        deadline_ns = update.healthy_deadline_ns if update is not None else 5 * 60 * 10**9
        start = time.time_ns()
        healthy_since: Optional[int] = None
        while not self._destroyed.is_set():
            status = self.client_status()
            if status == ALLOC_CLIENT_FAILED or any(
                s.failed for s in self.task_states().values()
            ):
                self._set_health(False)
                return
            if status == ALLOC_CLIENT_RUNNING:
                now = time.time_ns()
                healthy_since = healthy_since or now
                if now - healthy_since >= min_healthy_ns:
                    self._set_health(True)
                    return
            else:
                healthy_since = None
            if time.time_ns() - start > deadline_ns:
                self._set_health(False)
                return
            time.sleep(0.05)

    def _set_health(self, healthy: bool) -> None:
        self.deployment_status = AllocDeploymentStatus(
            healthy=healthy, timestamp_ns=time.time_ns()
        )
        self._notify()

    # -- teardown --------------------------------------------------------

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new version of this alloc (alloc_runner.go Update)."""
        self.alloc.desired_status = alloc.desired_status
        self.alloc.desired_transition = alloc.desired_transition
        self.alloc.modify_index = alloc.modify_index
        if alloc.desired_status != ALLOC_DESIRED_RUN:
            self.stop()

    def restart_task(self, task_name: str = "") -> None:
        """Alloc.Restart: restart one task, or all (alloc_endpoint.go)."""
        for name in [task_name] if task_name else list(self.task_runners):
            self.task_runners[name].restart()

    def signal_task(self, task_name: str, sig: str) -> None:
        """Alloc.Signal (alloc_endpoint.go Signal)."""
        targets = (
            [self.task_runners[task_name]] if task_name
            else list(self.task_runners.values())
        )
        for tr in targets:
            tr.driver.signal_task(tr.task_id, sig)

    def exec_task(self, task_name: str, cmd, timeout_s: float = 30.0):
        """One-shot exec in a task's context."""
        tr = self.task_runners[task_name]
        return tr.driver.exec_task(tr.task_id, list(cmd), timeout_s)

    def exec_task_streaming(self, task_name: str, cmd):
        """Interactive exec session (the reference's websocket-backed
        `nomad alloc exec`, alloc_endpoint.go execStream)."""
        tr = self.task_runners[task_name]
        return tr.driver.exec_task_streaming(tr.task_id, list(cmd))

    def stop(self) -> None:
        if self.consul is not None and getattr(self, "_group_consul_ids", None):
            try:
                self.consul.deregister_ids(self._group_consul_ids)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("group consul deregistration failed: %s", e)
            self._group_consul_ids = []
        for tr in self.task_runners.values():
            tr.kill_requested.set()
        for tr in self.task_runners.values():
            tr.done.wait(timeout=15.0)
        self._notify()

    def destroy(self) -> None:
        self._destroyed.set()
        self.stop()
        self.alloc_dir.destroy()

    def wait(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        for tr in self.task_runners.values():
            if not tr.done.wait(timeout=max(0.0, deadline - time.monotonic())):
                return False
        return True
