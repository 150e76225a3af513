"""Docker driver: containers over the Docker Engine HTTP API.

Fills the role of reference ``drivers/docker/`` (5,414 LoC): container
lifecycle against the daemon's unix socket (the go-dockerclient slot —
no SDK, plain REST), image pulls with a refcounting coordinator
(docker/coordinator.go) so concurrent tasks share pulls and images are
deleted when the last user stops, a log pump demuxing the container's
multiplexed log stream into the task's stdout/stderr files (the docklog
subprocess slot), and a reconciler that removes dangling nomad-labelled
containers (docker/reconciler.go). Fingerprint degrades to undetected
when no daemon socket answers (fingerprint.go).

Copied from ``nomad_tpu/client/drivers/docker.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.docker``.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import struct
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from .base import (
    Capabilities,
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    TaskConfig,
    TaskHandle,
    TaskStats,
    TaskStatus,
    register,
)

logger = logging.getLogger("nomad_tpu_torch.docker")

DEFAULT_SOCKET = "/var/run/docker.sock"
NOMAD_LABEL = "com.hashicorp.nomad.alloc_id"


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: Optional[float] = None) -> None:
        super().__init__("localhost", timeout=timeout)
        self.socket_path = socket_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            s.settimeout(self.timeout)
        s.connect(self.socket_path)
        self.sock = s


class DockerAPI:
    """Minimal Docker Engine REST client (go-dockerclient's role)."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET) -> None:
        self.socket_path = socket_path

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        params: Optional[dict] = None,
        timeout: Optional[float] = 60.0,
        raw: bool = False,
    ):
        if params:
            path += "?" + urllib.parse.urlencode(params)
        conn = _UnixHTTPConnection(self.socket_path, timeout=timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if payload else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                msg = data.decode(errors="replace")
                try:
                    msg = json.loads(msg).get("message", msg)
                except (ValueError, AttributeError):
                    pass
                raise DriverError(f"docker {method} {path}: {resp.status} {msg}")
            if raw:
                return data
            return json.loads(data) if data else None
        except (OSError, http.client.HTTPException) as e:
            raise DriverError(f"docker daemon unreachable: {e}") from e
        finally:
            conn.close()

    # -- api surface -----------------------------------------------------

    def ping(self) -> bool:
        try:
            self._request("GET", "/_ping", raw=True, timeout=3.0)
            return True
        except DriverError:
            return False

    def version(self) -> dict:
        return self._request("GET", "/version", timeout=5.0) or {}

    @staticmethod
    def parse_image(image: str) -> Tuple[str, str]:
        """Split repo and tag like docker does: the tag is after the LAST
        ':' and only when that ':' follows the last '/', so registry ports
        ('localhost:5000/app') and digests ('app@sha256:...') stay intact."""
        if "@" in image:
            return image, ""  # digest reference: no tag parameter
        idx = image.rfind(":")
        if idx > image.rfind("/"):
            return image[:idx], image[idx + 1:]
        return image, "latest"

    def pull(self, image: str) -> None:
        """POST /images/create streams progress; drain until EOF."""
        name, tag = self.parse_image(image)
        params = {"fromImage": name}
        if tag:
            params["tag"] = tag
        self._request("POST", "/images/create", params=params,
                      raw=True, timeout=600.0)

    def image_exists(self, image: str) -> bool:
        try:
            self._request("GET", f"/images/{urllib.parse.quote(image, safe='')}/json",
                          timeout=10.0)
            return True
        except DriverError:
            return False

    def remove_image(self, image: str) -> None:
        self._request("DELETE", f"/images/{urllib.parse.quote(image, safe='')}",
                      timeout=60.0)

    def create_container(self, name: str, config: dict) -> str:
        out = self._request("POST", "/containers/create",
                            body=config, params={"name": name})
        return out["Id"]

    def start_container(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/start")

    def stop_container(self, cid: str, timeout_s: int) -> None:
        self._request("POST", f"/containers/{cid}/stop",
                      params={"t": timeout_s}, timeout=timeout_s + 30.0)

    def kill_container(self, cid: str, signal: str = "SIGKILL") -> None:
        self._request("POST", f"/containers/{cid}/kill", params={"signal": signal})

    def remove_container(self, cid: str, force: bool = True) -> None:
        self._request("DELETE", f"/containers/{cid}",
                      params={"force": "true" if force else "false"})

    def wait_container(self, cid: str, timeout: Optional[float] = None) -> int:
        out = self._request("POST", f"/containers/{cid}/wait", timeout=timeout)
        return int(out.get("StatusCode", -1))

    def inspect_container(self, cid: str) -> dict:
        return self._request("GET", f"/containers/{cid}/json") or {}

    def list_containers(self, all_: bool = True,
                        label: Optional[str] = None) -> List[dict]:
        params: Dict[str, Any] = {"all": "true" if all_ else "false"}
        if label:
            params["filters"] = json.dumps({"label": [label]})
        return self._request("GET", "/containers/json", params=params) or []

    def container_stats(self, cid: str) -> dict:
        return self._request(
            "GET", f"/containers/{cid}/stats", params={"stream": "false"}
        ) or {}

    def container_logs_stream(self, cid: str):
        """Raw follow-mode log socket; caller demuxes and closes."""
        conn = _UnixHTTPConnection(self.socket_path, timeout=None)
        conn.request(
            "GET",
            f"/containers/{cid}/logs?follow=true&stdout=true&stderr=true",
        )
        return conn, conn.getresponse()

    def exec_in_container(self, cid: str, cmd: List[str],
                          timeout_s: float) -> Tuple[bytes, int]:
        """Attached exec: the start response carries the multiplexed
        output stream; exit code comes from exec inspect (what the
        reference uses for script checks and alloc exec)."""
        out = self._request("POST", f"/containers/{cid}/exec", body={
            "Cmd": cmd, "AttachStdout": True, "AttachStderr": True,
        })
        exec_id = out["Id"]
        conn = _UnixHTTPConnection(self.socket_path, timeout=timeout_s)
        try:
            conn.request(
                "POST", f"/exec/{exec_id}/start",
                body=json.dumps({"Detach": False, "Tty": False}).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise DriverError(f"exec stream failed: {e}") from e
        finally:
            conn.close()
        output = _demux_docker_stream(raw)
        info = self._request("GET", f"/exec/{exec_id}/json") or {}
        return output, int(info.get("ExitCode") or 0)


def _demux_docker_stream(raw: bytes) -> bytes:
    """Strip the 8-byte frame headers from docker's multiplexed stream;
    pass non-framed (tty) payloads through untouched."""
    out = bytearray()
    pos = 0
    while pos + 8 <= len(raw):
        stream = raw[pos]
        if stream not in (0, 1, 2) or raw[pos + 1:pos + 4] != b"\x00\x00\x00":
            return raw  # not framed (tty mode)
        size = struct.unpack(">I", raw[pos + 4:pos + 8])[0]
        out.extend(raw[pos + 8:pos + 8 + size])
        pos += 8 + size
    if pos != len(raw) and not out:
        return raw
    return bytes(out)


class ImageCoordinator:
    """Refcounted image pulls (reference docker/coordinator.go): many
    tasks share one pull; the image is removed when the last task using
    it stops (when image_gc is on)."""

    class _Pull:
        def __init__(self) -> None:
            self.done = threading.Event()
            self.error: Optional[Exception] = None

    def __init__(self, api: DockerAPI, image_gc: bool = True) -> None:
        self.api = api
        self.image_gc = image_gc
        self._lock = threading.Lock()
        self._refs: Dict[str, int] = {}
        self._pulls: Dict[str, "ImageCoordinator._Pull"] = {}
        # images with an acquire in flight: release() must not gc these —
        # the acquirer may have already probed image_exists()=True
        self._acquiring: Dict[str, int] = {}
        # images being deleted right now: acquire waits these out instead
        # of trusting a stale image_exists probe
        self._removing: set = set()

    def acquire(self, image: str) -> None:
        with self._lock:
            self._acquiring[image] = self._acquiring.get(image, 0) + 1
        try:
            self._acquire_inner(image)
        finally:
            with self._lock:
                n = self._acquiring.get(image, 1) - 1
                if n:
                    self._acquiring[image] = n
                else:
                    self._acquiring.pop(image, None)

    def _acquire_inner(self, image: str) -> None:
        # wait out an in-flight removal of THIS image so the exists-probe
        # below can't observe a half-deleted state
        deadline = time.monotonic() + 120
        while True:
            with self._lock:
                removing = image in self._removing
            if not removing:
                break
            if time.monotonic() > deadline:
                raise DriverError(f"image {image} stuck in removal")
            time.sleep(0.05)
        # probe outside the lock: a slow daemon must not serialize every
        # unrelated acquire/release behind one HTTP round trip
        with self._lock:
            pull = self._pulls.get(image)
        if pull is None:
            exists = self.api.image_exists(image)
            with self._lock:
                pull = self._pulls.get(image)  # someone may have raced us
                if pull is None and not exists:
                    pull = self._pulls[image] = self._Pull()
                    do_pull = True
                else:
                    do_pull = False
        else:
            do_pull = False
        if do_pull:
            try:
                self.api.pull(image)
            except Exception as e:  # noqa: BLE001 — waiters need the error
                pull.error = e
                raise
            finally:
                pull.done.set()
                with self._lock:
                    self._pulls.pop(image, None)
        elif pull is not None:
            pull.done.wait(timeout=600)
            if pull.error is not None:
                raise DriverError(f"shared pull of {image} failed: {pull.error}")
        with self._lock:
            self._refs[image] = self._refs.get(image, 0) + 1

    def release(self, image: str) -> None:
        with self._lock:
            n = self._refs.get(image, 0) - 1
            if n > 0:
                self._refs[image] = n
                return
            self._refs.pop(image, None)
            if self._acquiring.get(image):
                return  # a racing acquire will re-reference it
            if not self.image_gc:
                return
            # mark-then-remove outside the lock: acquires of THIS image
            # wait out the marker; unrelated images stay unblocked
            self._removing.add(image)
        try:
            self.api.remove_image(image)
        except DriverError as e:
            logger.debug("image gc of %s skipped: %s", image, e)
        finally:
            with self._lock:
                self._removing.discard(image)


class _DockerTask:
    def __init__(self, driver: "DockerDriver", cfg: TaskConfig, cid: str) -> None:
        self.driver = driver
        self.cfg = cfg
        self.cid = cid
        self.image = str(cfg.config.get("image", ""))
        self.started_at = time.time_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self._log_conn = None
        threading.Thread(target=self._wait, daemon=True).start()
        if cfg.stdout_path:
            threading.Thread(target=self._pump_logs, daemon=True).start()

    def _wait(self) -> None:
        try:
            code = self.driver.api.wait_container(self.cid, timeout=None)
        except DriverError:
            code = -1
        self.exit_result = ExitResult(exit_code=max(code, 0),
                                      err="" if code >= 0 else "wait failed")
        self.completed_at = time.time_ns()
        self.done.set()
        if self._log_conn is not None:
            try:
                self._log_conn.close()
            except OSError:
                pass

    def _pump_logs(self) -> None:
        """Demux docker's multiplexed log stream into the task's
        stdout/stderr files (reference docklog subprocess)."""
        try:
            conn, resp = self.driver.api.container_logs_stream(self.cid)
        except DriverError:
            return
        self._log_conn = conn
        try:
            with open(self.cfg.stdout_path, "ab") as out, \
                    open(self.cfg.stderr_path or os.devnull, "ab") as err:
                while True:
                    header = resp.read(8)
                    if len(header) < 8:
                        return
                    stream, size = header[0], struct.unpack(">I", header[4:8])[0]
                    data = resp.read(size)
                    target = err if stream == 2 else out
                    target.write(data)
                    target.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class DockerDriver(Driver):
    name = "docker"
    capabilities = Capabilities(send_signals=True, exec=True, fs_isolation="image")
    # the driver pumps container logs into the task files itself
    produces_logs = False
    config_schema = {
        "endpoint": {"type": "string"},
        "image_gc": {"type": "bool"},
    }

    RECONCILE_INTERVAL = 300.0  # docker/reconciler.go default period

    def __init__(self, socket_path: str = DEFAULT_SOCKET) -> None:
        self.api = DockerAPI(socket_path)
        self.coordinator = ImageCoordinator(self.api)
        self.tasks: Dict[str, _DockerTask] = {}
        self._lock = threading.Lock()
        self._reconciler_started = False

    def set_config(self, config: dict) -> None:
        if config.get("endpoint"):
            self.api = DockerAPI(str(config["endpoint"]).replace("unix://", ""))  # race-ok: plugin config lands before any task runs; reference swap is atomic
            self.coordinator.api = self.api
        if "image_gc" in config:
            self.coordinator.image_gc = bool(config["image_gc"])

    # -- fingerprint -----------------------------------------------------

    def fingerprint(self) -> Fingerprint:
        if not self.api.ping():
            return Fingerprint(
                health=HEALTH_UNDETECTED,
                health_description="docker daemon not reachable",
            )
        version = self.api.version().get("Version", "unknown")
        return Fingerprint(health=HEALTH_HEALTHY, attributes={
            "driver.docker": "1",
            "driver.docker.version": version,
        })

    # -- lifecycle -------------------------------------------------------

    @staticmethod
    def container_name(cfg: TaskConfig) -> str:
        return f"{cfg.name}-{cfg.alloc_id}"

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        image = cfg.config.get("image")
        if not image:
            raise DriverError("docker requires config.image")
        with self._lock:
            if cfg.id in self.tasks:
                raise DriverError(f"task {cfg.id} already started")
        self.coordinator.acquire(image)
        binds = []
        if cfg.task_dir is not None:
            binds = [
                f"{cfg.task_dir.shared_alloc_dir}:/alloc",
                f"{cfg.task_dir.local_dir}:/local",
                f"{cfg.task_dir.secrets_dir}:/secrets",
            ]
        binds += [
            f"{m.host_path}:{m.task_path}" + (":ro" if m.read_only else "")
            for m in cfg.mounts
        ]
        container = {
            "Image": image,
            "Cmd": ([cfg.config["command"]] if cfg.config.get("command") else [])
            + [str(a) for a in cfg.config.get("args", [])],
            "Env": [f"{k}={v}" for k, v in cfg.env.items()],
            "WorkingDir": str(cfg.config.get("work_dir", "")) or None,
            "Labels": {NOMAD_LABEL: cfg.alloc_id},
            "HostConfig": {
                "Binds": binds,
                "Memory": cfg.memory_limit_mb << 20,
                "CPUShares": cfg.cpu_limit,
                "NetworkMode": str(cfg.config.get("network_mode", "")) or "default",
            },
        }
        try:
            cid = self.api.create_container(self.container_name(cfg), container)
            self.api.start_container(cid)
        except DriverError:
            self.coordinator.release(image)
            raise
        task = _DockerTask(self, cfg, cid)
        with self._lock:
            self.tasks[cfg.id] = task
        self._ensure_reconciler()
        return TaskHandle(
            driver=self.name, config=cfg, state="running",
            driver_state={"container_id": cid, "image": image},
        )

    def _ensure_reconciler(self) -> None:
        """Lazy periodic dangling-container sweep: starts with the first
        task so idle drivers (and fingerprint-only instances) spawn no
        threads."""
        with self._lock:
            if self._reconciler_started:
                return
            self._reconciler_started = True

        def loop() -> None:
            while True:
                time.sleep(self.RECONCILE_INTERVAL)
                removed = self.reconcile_dangling()
                if removed:
                    logger.info("reconciler removed %d dangling containers",
                                len(removed))

        threading.Thread(target=loop, name="docker-reconciler", daemon=True).start()

    def _get(self, task_id: str) -> _DockerTask:
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
        try:
            if signal != "SIGTERM":
                self.api.kill_container(t.cid, signal)
                if t.done.wait(timeout=max(timeout_s, 0.001)):
                    return
            self.api.stop_container(t.cid, int(max(timeout_s, 1)))
        except DriverError as e:
            logger.warning("stopping container %s: %s", t.cid[:12], e)
        t.done.wait(timeout=timeout_s + 10)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None:
                return
            if not t.done.is_set() and not force:
                raise DriverError(f"task {task_id} still running")
            # claim it under the lock so a concurrent destroy is a no-op
            del self.tasks[task_id]
        try:
            self.api.remove_container(t.cid, force=True)
        except DriverError as e:
            logger.warning("removing container %s: %s", t.cid[:12], e)
        self.coordinator.release(t.image)

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
        try:
            raw = self.api.container_stats(t.cid)
        except DriverError:
            return TaskStats(timestamp_ns=time.time_ns())
        mem = (raw.get("memory_stats") or {}).get("usage", 0)
        cpu = raw.get("cpu_stats") or {}
        pre = raw.get("precpu_stats") or {}
        delta = (cpu.get("cpu_usage", {}).get("total_usage", 0)
                 - pre.get("cpu_usage", {}).get("total_usage", 0))
        sys_delta = cpu.get("system_cpu_usage", 0) - pre.get("system_cpu_usage", 0)
        pct = (delta / sys_delta * 100.0) if sys_delta > 0 else 0.0
        return TaskStats(cpu_percent=pct, memory_rss_bytes=mem,
                         timestamp_ns=time.time_ns())

    def signal_task(self, task_id: str, signal: str) -> None:
        t = self._get(task_id)
        self.api.kill_container(t.cid, signal)

    def exec_task(self, task_id: str, cmd: List[str], timeout_s: float) -> Tuple[bytes, int]:
        t = self._get(task_id)
        return self.api.exec_in_container(t.cid, cmd, timeout_s)

    def recover_task(self, handle: TaskHandle) -> None:
        """Re-attach to a live container after a client restart
        (driver.go RecoverTask)."""
        cid = handle.driver_state.get("container_id")
        if not cid or handle.config is None:
            raise DriverError("docker handle missing container id")
        info = self.api.inspect_container(cid)
        if not (info.get("State") or {}).get("Running", False):
            raise DriverError(f"container {cid[:12]} not running")
        self.coordinator.acquire(handle.driver_state.get("image", ""))
        task = _DockerTask(self, handle.config, cid)
        with self._lock:
            self.tasks[handle.config.id] = task

    # -- reconciler (docker/reconciler.go) -------------------------------

    def reconcile_dangling(self) -> List[str]:
        """Remove nomad-labelled containers no task tracks (leaked by a
        crash between create and handle persistence)."""
        with self._lock:
            known = {t.cid for t in self.tasks.values()}
        removed = []
        try:
            for c in self.api.list_containers(all_=True, label=NOMAD_LABEL):
                cid = c.get("Id", "")
                if cid and cid not in known:
                    try:
                        self.api.remove_container(cid, force=True)
                        removed.append(cid)
                    except DriverError:
                        pass
        except DriverError:
            pass
        return removed


# One driver instance per process: the image coordinator's refcounts and
# the reconciler's known-container set must span every task on the node
# (the reference's drivermanager holds a single plugin instance).
_shared_driver: Optional[DockerDriver] = None
_shared_lock = threading.Lock()


def shared_docker_driver() -> DockerDriver:
    global _shared_driver
    with _shared_lock:
        if _shared_driver is None:
            _shared_driver = DockerDriver()
        return _shared_driver


register("docker", shared_docker_driver)
