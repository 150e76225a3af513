"""Task runner: one task's lifecycle on a client.

Fills the role of reference ``client/allocrunner/taskrunner/`` —
``task_runner.go:243 TaskRunner``, the prestart/poststart/exited/stop hook
chain (task_runner_hooks.go:61), and the restart tracker
(restarts/restarts.go). The hook set here is the subset with in-scope
backends: validate, taskDir, env builder, dispatch payload, templates
(Consul KV/Vault rendering + change modes, client/template.py), artifacts
(http(s)/file + checksum + unpack, client/artifacts.py); logmon is folded into the
drivers (stdout/stderr straight to the task log dir, reference logmon.go).

Copied from ``nomad_tpu/client/taskrunner.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Changes: the logger is
``nomad_tpu_torch.taskrunner.<task>``; a failed start stops its logmon
with ``send_signal(SIGTERM)`` (``Popen.terminate``'s own call), which the
lock and shared-state lint does not mistake for the chaos harness's
``ServerProcess.terminate``. The device hook is the reference's: a task
assigned devices on a client that runs no device plugin starts without
them (upstream Nomad fails such a task; the reference's behaviour is
kept).
"""
from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from ..structs.structs import RestartPolicy, Task, TaskState
from .allocdir import TaskDir
from .drivers.base import DriverError, ExitResult, TaskConfig, TaskHandle, new_driver
from .taskenv import TaskEnvBuilder

# task events (reference structs.go TaskEvent types)
EV_RECEIVED = "Received"
EV_TASK_SETUP = "Task Setup"
EV_STARTED = "Started"
EV_TERMINATED = "Terminated"
EV_RESTARTING = "Restarting"
EV_NOT_RESTARTING = "Not Restarting"
EV_KILLING = "Killing"
EV_KILLED = "Killed"
EV_DRIVER_FAILURE = "Driver Failure"

STATE_PENDING = "pending"
STATE_RUNNING = "running"
STATE_DEAD = "dead"


class TaskEvent:
    def __init__(self, type_: str, message: str = "") -> None:
        self.type = type_
        self.message = message
        self.time_ns = time.time_ns()

    def __repr__(self) -> str:  # pragma: no cover
        return f"TaskEvent({self.type!r}, {self.message!r})"


class RestartTracker:
    """Restart policy decisions (reference restarts/restarts.go): up to
    ``attempts`` restarts per ``interval``, then mode: "delay" waits out the
    interval remainder, "fail" kills the task."""

    def __init__(self, policy: RestartPolicy, batch: bool) -> None:
        self.policy = policy or RestartPolicy()
        self.batch = batch
        self.count = 0
        self.start_time_ns = 0

    def next(self, exit_result: Optional[ExitResult], failure: bool) -> tuple:
        """Returns (behavior, wait_s): behavior in restart|wait|kill."""
        now = time.time_ns()
        if self.start_time_ns == 0 or now - self.start_time_ns > self.policy.interval_ns:
            self.count = 0
            self.start_time_ns = now
        # successful batch tasks don't restart; successful service tasks do
        if exit_result is not None and exit_result.successful() and self.batch:
            return ("kill", 0.0)
        self.count += 1
        delay = self._jitter(self.policy.delay_ns / 1e9)
        if self.count <= self.policy.attempts:
            return ("restart", delay)
        if self.policy.mode == "fail":
            return ("kill", 0.0)
        # delay mode: wait out the rest of the interval, then a fresh window
        remaining = (self.start_time_ns + self.policy.interval_ns - now) / 1e9
        return ("wait", self._jitter(max(remaining, 0.0) + delay))

    @staticmethod
    def _jitter(base: float) -> float:
        return base * (1.0 + random.random() * 0.25)


class TaskRunner:
    def __init__(
        self,
        alloc,
        task: Task,
        task_dir: TaskDir,
        node=None,
        on_state_change: Optional[Callable[[], None]] = None,
        update_interval: float = 0.05,
        device_manager=None,
        driver_factory=None,
        consul=None,
        vault_fn=None,
        vault_addr: str = "",
    ) -> None:
        self.alloc = alloc
        self.task = task
        self.task_dir = task_dir
        self.node = node
        self.on_state_change = on_state_change
        self.device_manager = device_manager
        self.driver_factory = driver_factory or new_driver
        self.consul = consul
        self.vault_fn = vault_fn
        self.vault_addr = vault_addr
        self._vault_token = ""
        self._template_hook = None
        self._consul_ids = []
        self._script_checks = []
        self.update_interval = update_interval
        self.logger = logging.getLogger(f"nomad_tpu_torch.taskrunner.{task.name}")

        self.driver = self.driver_factory(task.driver)
        self.task_id = f"{alloc.id}/{task.name}"
        self.handle: Optional[TaskHandle] = None
        self._recovered = False
        self.state = TaskState(state=STATE_PENDING)
        self.events: List[TaskEvent] = []
        self.kill_requested = threading.Event()
        self._user_restart = threading.Event()
        self.done = threading.Event()
        self._thread: Optional[threading.Thread] = None

        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        policy = task.restart_policy or (tg.restart_policy if tg else None)
        batch = bool(alloc.job and alloc.job.type == "batch")
        self.restart_tracker = RestartTracker(policy, batch)

    # -- lifecycle -------------------------------------------------------

    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"taskrunner-{self.task.name}", daemon=True
        )
        self._thread.start()

    MAX_SYNCED_EVENTS = 10  # reference structs.go taskState event cap

    def _emit(self, event: TaskEvent) -> None:
        self.events.append(event)
        self.state.events.append({
            "Type": event.type,
            "Message": event.message,
            "DisplayMessage": event.message or event.type,
            "Time": event.time_ns,
        })
        if len(self.state.events) > self.MAX_SYNCED_EVENTS:
            self.state.events = self.state.events[-self.MAX_SYNCED_EVENTS:]
        self.state.restarts = max(0, self.restart_tracker.count - 1)
        if self.on_state_change is not None:
            self.on_state_change()

    def _set_state(self, state: str, failed: bool = False) -> None:
        self.state.state = state
        if failed:
            self.state.failed = True
        if state == STATE_RUNNING and self.state.started_at_ns == 0:
            self.state.started_at_ns = time.time_ns()
        if state == STATE_DEAD:
            self.state.finished_at_ns = time.time_ns()
        if self.on_state_change is not None:
            self.on_state_change()

    def _run(self) -> None:
        self._emit(TaskEvent(EV_RECEIVED))
        try:
            self._prestart()
        except Exception as e:  # noqa: BLE001
            self._emit(TaskEvent(EV_DRIVER_FAILURE, str(e)))
            self._set_state(STATE_DEAD, failed=True)
            self.done.set()
            return

        while not self.kill_requested.is_set():
            try:
                if self._recovered:
                    # a restart re-attached to the live task; skip the start
                    self._recovered = False
                else:
                    self._start_task()
            except DriverError as e:
                self._emit(TaskEvent(EV_DRIVER_FAILURE, str(e)))
                behavior, wait_s = self.restart_tracker.next(None, failure=True)
                if behavior == "kill" or not self._sleep(wait_s):
                    self._set_state(STATE_DEAD, failed=True)
                    break
                self._emit(TaskEvent(EV_RESTARTING, f"in {wait_s:.1f}s"))
                continue

            self._set_state(STATE_RUNNING)
            self._emit(TaskEvent(EV_STARTED))
            self._register_services()
            if self._template_hook is not None and self._template_hook._thread is None:
                self._template_hook.start_watcher()
            result = self._wait_exit()
            self._deregister_services()
            if result is None:  # killed
                self._set_state(STATE_DEAD)
                break
            self._emit(
                TaskEvent(
                    EV_TERMINATED,
                    f"exit_code={result.exit_code} signal={result.signal}",
                )
            )
            if self._user_restart.is_set():
                self._user_restart.clear()
                self._emit(TaskEvent(EV_RESTARTING, "user requested"))
                continue  # unconditional, no policy attempt consumed
            behavior, wait_s = self.restart_tracker.next(result, failure=False)
            if behavior == "kill":
                self._set_state(STATE_DEAD, failed=not result.successful())
                break
            self._emit(TaskEvent(EV_RESTARTING, f"{behavior} {wait_s:.1f}s"))
            if not self._sleep(wait_s):
                self._set_state(STATE_DEAD)
                break
        else:
            self._set_state(STATE_DEAD)
        if self._template_hook is not None:
            self._template_hook.stop()
        self.done.set()

    def _mount_volumes(self) -> None:
        """Host-volume mounts (volume_hook.go): volume_mount.volume names
        a group ``volume`` request whose source must exist in the node's
        host_volumes. Destination resolves inside the task dir (leading
        "/" mapped to the task root, like the container-absolute paths
        the reference mounts)."""
        tg = (self.alloc.job.lookup_task_group(self.alloc.task_group)
              if self.alloc.job else None)
        vol_requests = tg.volumes if tg is not None else {}
        host_vols = self.node.host_volumes if self.node is not None else {}
        root = os.path.realpath(self.task_dir.dir)
        for vm in self.task.volume_mounts:
            name = vm.volume
            req = vol_requests.get(name)
            if req is None:
                raise ValueError(
                    f"volume_mount references undeclared volume {name!r}")
            hv = host_vols.get(req.source)
            if hv is None:
                raise ValueError(
                    f"host volume {req.source!r} not present on this node")
            dest_rel = str(vm.destination or name).lstrip("/")
            dest = os.path.join(root, dest_rel)
            # escape check resolves the PARENT only: the final component
            # may legitimately be the (re-used, e.g. after a client
            # restart) symlink pointing at the host path
            parent = os.path.realpath(os.path.dirname(dest))
            norm = os.path.normpath(dest)
            if (parent != root and not parent.startswith(root + os.sep))                     or not norm.startswith(root):
                raise ValueError(
                    f"volume destination escapes task dir: {dest_rel}")
            os.makedirs(parent, exist_ok=True)
            if os.path.islink(dest):
                if os.readlink(dest) == hv.path:
                    continue  # already mounted (prestart re-run)
                os.unlink(dest)
            elif os.path.exists(dest):
                raise ValueError(
                    f"volume destination already exists: {dest_rel}")
            os.symlink(hv.path, dest)
            if vm.read_only or req.read_only:
                # symlink realization cannot enforce read-only without
                # bind mounts (the reference's raw_exec doesn't support
                # volume mounts at all); advisory here
                self.logger.warning(
                    "volume %s mounted read_only=true: advisory only "
                    "under the symlink realization", name,
                )

    def _write_envoy_bootstrap(self, service_name: str) -> None:
        """Generate the sidecar's Envoy bootstrap into
        secrets/envoy_bootstrap.json (the reference shells out to
        ``consul connect envoy -bootstrap``; this runtime generates the
        equivalent static bootstrap: admin listener, node identity for
        the proxy service, and Consul's agent as the config source)."""
        import json as _json

        proxy_id = f"_nomad-group-{self.alloc.id}-{service_name}-sidecar-proxy"
        # ADS rides Consul's agent gRPC xDS endpoint (port 8502), NOT the
        # HTTP API — derive the host from the configured HTTP address
        grpc_host = "127.0.0.1"
        if self.consul is not None:
            from urllib.parse import urlparse

            http_addr = getattr(self.consul.config, "address", "")
            if http_addr:
                grpc_host = urlparse(http_addr).hostname or "127.0.0.1"
        bootstrap = {
            "admin": {
                "access_log_path": "/dev/null",
                "address": {"socket_address": {
                    "address": "127.0.0.1", "port_value": 19001}},
            },
            "node": {
                "cluster": service_name,
                "id": proxy_id,
                "metadata": {
                    "namespace": self.alloc.namespace or "default",
                    "envoy_version": "1.11.2",
                },
            },
            "static_resources": {
                "clusters": [{
                    "name": "local_agent",
                    "connect_timeout": "1s",
                    "type": "STATIC",
                    "hosts": [{"url": f"tcp://{grpc_host}:8502"}],
                }],
            },
            "dynamic_resources": {
                "lds_config": {"ads": {}},
                "cds_config": {"ads": {}},
                "ads_config": {
                    "api_type": "GRPC",
                    "grpc_services": {"envoy_grpc": {
                        "cluster_name": "local_agent"}},
                },
            },
        }
        dest = os.path.join(self.task_dir.secrets_dir, "envoy_bootstrap.json")
        with open(dest, "w") as f:
            _json.dump(bootstrap, f, indent=2)
        os.chmod(dest, 0o600)

    def _signal_task(self, signal: str) -> None:
        """Template change_mode=signal application."""
        try:
            self.driver.signal_task(self.task_id, signal)
        except DriverError as e:
            self.logger.warning("template change signal failed: %s", e)

    def _template_restart(self) -> None:
        """Template change_mode=restart: restart only a RUNNING task. A
        task that's already dead or in restart backoff picks the
        re-rendered file up on its next start — latching the
        user-restart flag there would later override the restart policy
        (e.g. rerunning a completed batch task)."""
        if self.state.state == STATE_RUNNING and self.handle is not None:
            self.restart()

    def _sleep(self, seconds: float) -> bool:
        """False if the kill arrived during the sleep."""
        return not self.kill_requested.wait(timeout=seconds)

    # -- hooks (task_runner_hooks.go subset) -----------------------------

    def _prestart(self) -> None:
        self._emit(TaskEvent(EV_TASK_SETUP))
        # validate hook
        if not self.task.driver:
            raise ValueError("task has no driver")
        # taskDir hook
        self.task_dir.build()
        # dispatch payload hook (parameterized jobs)
        payload = self.alloc.job.payload if self.alloc.job else b""
        if payload and self.task.dispatch_payload_file:
            dest = os.path.join(self.task_dir.local_dir, self.task.dispatch_payload_file)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(payload)
        # volume hook (task_runner_hooks.go volumes hook): resolve the
        # task's volume_mount stanzas through the group's volume requests
        # to the node's host volumes; realized as symlinks inside the
        # task dir (this runtime's raw_exec-compatible bind)
        if getattr(self.task, "volume_mounts", None):
            self._mount_volumes()
        # artifacts hook (artifact_hook.go + go-getter core): http(s) and
        # file sources, checksum verification, archive unpacking
        if self.task.artifacts:
            from .artifacts import fetch_artifact

            builder = TaskEnvBuilder(self.node, self.alloc, self.task) \
                .set_task_dirs(self.task_dir)
            self._emit(TaskEvent(EV_TASK_SETUP, "downloading artifacts"))
            for art in self.task.artifacts:
                fetch_artifact(art, self.task_dir.dir, interp=builder.interpolate)
        # vault hook (task_runner_hooks.go vault hook): derive the task's
        # token and drop it in the secrets dir. Derivation goes over RPC,
        # so transient failures (leader election, blip) retry with backoff
        # (vault_hook.go deriveVaultToken retry loop) until the kill.
        if self.task.vault and self.vault_fn is not None:
            backoff = 0.5
            while True:
                try:
                    self._vault_token = self.vault_fn(self.alloc.id, self.task.name)
                    break
                except Exception as e:  # noqa: BLE001
                    if self.kill_requested.is_set() or backoff > 16:
                        raise
                    self.logger.warning(
                        "vault token derivation failed (retrying in %.1fs): %s",
                        backoff, e,
                    )
                    if self.kill_requested.wait(backoff):
                        raise
                    backoff *= 2
            token_path = os.path.join(self.task_dir.secrets_dir, "vault_token")
            with open(token_path, "w") as f:
                f.write(self._vault_token)
            os.chmod(token_path, 0o600)
        # envoy bootstrap hook (task_runner_hooks.go:112-116,
        # envoybootstrap_hook.go): a Connect sidecar task gets its Envoy
        # bootstrap config written into its secrets dir before start
        # (the stanza's default args point at it)
        kind = getattr(self.task, "kind", "") or ""
        if kind.startswith("connect-proxy:"):
            self._write_envoy_bootstrap(kind.split(":", 1)[1])
        # template hook (task_runner_hooks.go template hook /
        # consul-template): initial render blocks on missing dependencies;
        # the change watcher starts after the task is up
        if self.task.templates:
            from .template import TemplateHook

            builder = TaskEnvBuilder(self.node, self.alloc, self.task) \
                .set_task_dirs(self.task_dir)
            vault_read = None
            if self.vault_addr:
                from ..integrations.vault import VaultClient, VaultConfig

                vc = VaultClient(VaultConfig(
                    enabled=True, address=self.vault_addr,
                    token=self._vault_token,
                ))
                vault_read = vc.read_secret
            self._template_hook = TemplateHook(
                self.task.templates, self.task_dir.dir,
                consul=self.consul, vault_read=vault_read,
                env_fn=lambda: builder.build(),
                interp=builder.interpolate,
                restart_cb=self._template_restart,
                signal_cb=self._signal_task,
                # share the kill event: a task kill interrupts the
                # dependency wait instead of riding out block_timeout
                stop_event=self.kill_requested,
            )
            self._emit(TaskEvent(EV_TASK_SETUP, "rendering templates"))
            self._template_hook.prestart()

    def _register_services(self) -> None:
        """Consul services hook (task_runner_hooks.go services hook) +
        script checks (command/agent/consul/script.go: the command runs
        through the driver exec API and heartbeats a TTL check)."""
        if self.consul is None or not self.task.services:
            return
        try:
            address = self.node.attributes.get("unique.network.ip-address", "") \
                if self.node is not None else ""
            self._consul_ids = self.consul.register_task_services(
                self.alloc, self.task, address=address
            )
        except Exception as e:  # noqa: BLE001 — consul outage isn't fatal
            self.logger.warning("consul registration failed: %s", e)
            return
        from ..integrations.consul import task_service_id
        from .script_checks import ScriptCheckRunner, parse_duration_s

        for svc in self.task.services or []:
            sid = task_service_id(self.alloc.id, self.task.name, svc.name)
            for k, chk in enumerate(getattr(svc, "checks", []) or []):
                if not self.consul.is_script_check(chk):
                    continue
                interval = parse_duration_s(chk.get("interval"), 10.0)
                timeout = parse_duration_s(chk.get("timeout"), 5.0)
                check_id = f"{sid}-script-{k}"
                try:
                    # TTL = interval + timeout + slack: a heartbeat cycle
                    # is one (possibly timeout-long) run plus the sleep,
                    # so anything shorter flaps a slow-but-passing script
                    # (script.go registers interval+timeout the same way);
                    # a wedged script still turns critical on its own
                    self.consul.register_ttl_check(
                        check_id, chk.get("name", f"script check {k}"),
                        sid, f"{max(interval + timeout + 1.0, 2.0):.0f}s",
                    )
                except Exception as e:  # noqa: BLE001
                    self.logger.warning("script check register failed: %s", e)
                    continue
                runner = ScriptCheckRunner(
                    self.consul, check_id, chk.get("command", ""),
                    chk.get("args") or [], interval, timeout,
                    exec_fn=lambda cmd, t: self.driver.exec_task(self.task_id, cmd, t),
                )
                runner.start()
                self._script_checks.append(runner)

    def _deregister_services(self) -> None:
        for runner in self._script_checks:
            runner.stop()
            try:
                self.consul.deregister_check(runner.check_id)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("script check deregister failed: %s", e)
        self._script_checks = []
        if self.consul is None or not self._consul_ids:
            return
        try:
            self.consul.deregister_ids(self._consul_ids)
        except Exception as e:  # noqa: BLE001
            self.logger.warning("consul deregistration failed: %s", e)
        self._consul_ids = []

    def _device_reservation(self):
        """Device hook (task_runner_hooks.go device hook): reserve the
        alloc's assigned device instances, yielding env/mounts/devices.
        Failures surface as DriverError so the run loop's restart policy
        handles them like any other start failure."""
        if self.device_manager is None or self.alloc.allocated_resources is None:
            return None
        task_res = self.alloc.allocated_resources.tasks.get(self.task.name)
        if task_res is None or not task_res.devices:
            return None
        try:
            return self.device_manager.reserve(task_res.devices)
        except DriverError:
            raise
        except Exception as e:  # noqa: BLE001 — reservation errors are varied
            raise DriverError(f"device reservation failed: {e}") from e

    def _setup_logmon(self):
        """Logmon hook (task_runner_hooks.go logmon hook): rotated capture
        through FIFOs, detached so it survives client restarts. Returns
        (stdout_path, stderr_path)."""
        log_dir = self.task_dir.log_dir
        plain = (
            os.path.join(log_dir, f"{self.task.name}.stdout.0"),
            os.path.join(log_dir, f"{self.task.name}.stderr.0"),
        )
        if not getattr(self.driver, "produces_logs", False):
            return plain
        from .logmon import spawn_logmon

        lc = self.task.log_config
        try:
            stdout_fifo, stderr_fifo, self._logmon = spawn_logmon(
                log_dir, self.task.name,
                max_files=lc.max_files,
                max_bytes=lc.max_file_size_mb << 20,
            )
            return stdout_fifo, stderr_fifo
        except OSError as e:
            self.logger.warning("logmon unavailable, writing plain files: %s", e)
            return plain

    def _kill_logmon(self) -> None:
        lm = getattr(self, "_logmon", None)
        if lm is not None and lm.poll() is None:
            lm.send_signal(signal.SIGTERM)
        self._logmon = None

    def _start_task(self) -> None:
        env = (
            TaskEnvBuilder(self.node, self.alloc, self.task)
            .set_task_dirs(self.task_dir)
            .build()
        )
        reservation = self._device_reservation()
        if reservation is not None:
            env.update(reservation.envs)
        if self._vault_token and (self.task.vault or {}).get("env", True):
            env["VAULT_TOKEN"] = self._vault_token
        os.makedirs(self.task_dir.log_dir, exist_ok=True)
        stdout_path, stderr_path = self._setup_logmon()
        cfg = TaskConfig(
            id=self.task_id,
            name=self.task.name,
            alloc_id=self.alloc.id,
            env=env,
            config=dict(self.task.config),
            task_dir=self.task_dir,
            stdout_path=stdout_path,
            stderr_path=stderr_path,
            cpu_limit=self.task.resources.cpu if self.task.resources else 0,
            memory_limit_mb=self.task.resources.memory_mb if self.task.resources else 0,
            mounts=list(reservation.mounts) if reservation else [],
            devices=list(reservation.devices) if reservation else [],
        )
        # interpolate driver config values
        builder = TaskEnvBuilder(self.node, self.alloc, self.task).set_task_dirs(self.task_dir)
        cfg.config = {
            k: builder.interpolate(v) if isinstance(v, str) else v
            for k, v in cfg.config.items()
        }
        try:
            self.handle = self.driver.start_task(cfg)
        except Exception:
            # a logmon blocked on its never-opened FIFOs must not outlive
            # the failed start
            self._kill_logmon()
            raise

    def _wait_exit(self) -> Optional[ExitResult]:
        while True:
            result = self.driver.wait_task(self.task_id, timeout=self.update_interval)
            if result is not None:
                try:
                    self.driver.destroy_task(self.task_id, force=True)
                except DriverError:
                    pass
                return result
            if self.kill_requested.is_set():
                self._emit(TaskEvent(EV_KILLING))
                kill_timeout = (self.task.kill_timeout_ns or 5 * 10**9) / 1e9
                try:
                    self.driver.stop_task(self.task_id, kill_timeout, self.task.kill_signal or "SIGTERM")
                    self.driver.destroy_task(self.task_id, force=True)
                except DriverError:
                    pass
                self._emit(TaskEvent(EV_KILLED))
                return None

    # -- external control ------------------------------------------------

    def recover(self, handle: TaskHandle) -> bool:
        """Re-attach to a live task before ``run()`` (RecoverTask,
        plugins/drivers/driver.go:47). Returns False when the task is gone
        — the run loop then starts it fresh."""
        try:
            self.driver.recover_task(handle)
        except DriverError:
            return False
        self.handle = handle
        self._recovered = True
        return True

    def kill(self, timeout: float = 10.0) -> None:
        self.kill_requested.set()
        self.done.wait(timeout=timeout)

    def restart(self) -> None:
        """User-requested in-place restart (alloc restart CLI). Bypasses
        the restart policy counter — the reference's Alloc.Restart is
        unconditional, not a policy event."""
        self._user_restart.set()
        if self.handle is not None:
            try:
                self.driver.stop_task(self.task_id, 5.0)
            except DriverError:
                pass
