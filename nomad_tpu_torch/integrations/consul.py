"""Consul integration: task service/check registration + agent
self-registration.

Fills the role of reference ``command/agent/consul/`` (ServiceClient):
tasks' ``service`` stanzas register into Consul's agent API when the task
starts and deregister when it stops, with Nomad-style service IDs
(``_nomad-task-<alloc>-<task>-<service>``); server/client agents
self-register as the ``nomad``/``nomad-client`` services. Transport is
Consul's HTTP agent API; ``MockConsulServer`` stands in for tests.

Copied from ``nomad_tpu/integrations/consul.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.consul``.
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger("nomad_tpu_torch.consul")


@dataclass
class ConsulConfig:
    address: str = ""  # e.g. http://127.0.0.1:8500
    token: str = ""
    auto_advertise: bool = True  # self-register the agent


class ConsulError(Exception):
    pass


def task_service_id(alloc_id: str, task: str, service: str) -> str:
    """command/agent/consul/client.go makeTaskServiceID shape."""
    return f"_nomad-task-{alloc_id}-{task}-{service}"


class ConsulClient:
    def __init__(self, config: ConsulConfig) -> None:
        self.config = config

    @property
    def enabled(self) -> bool:
        return bool(self.config.address)

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              raw_body: Optional[str] = None):
        data = None
        if raw_body is not None:
            data = raw_body.encode()
        elif body is not None:
            data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.config.address + path,
            method=method,
            data=data,
            headers={"X-Consul-Token": self.config.token} if self.config.token else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else None
        except urllib.error.HTTPError as e:
            raise ConsulError(f"consul {path}: {e.code} {e.read().decode(errors='replace')}")
        except OSError as e:
            raise ConsulError(f"consul unreachable at {self.config.address}: {e}")

    # -- agent service API ----------------------------------------------

    def register_service(
        self,
        service_id: str,
        name: str,
        address: str = "",
        port: int = 0,
        tags: Optional[List[str]] = None,
        checks: Optional[List[dict]] = None,
        kind: str = "",
        proxy: Optional[dict] = None,
    ) -> None:
        body = {
            "ID": service_id,
            "Name": name,
            "Tags": list(tags or []),
            "Address": address,
            "Port": port,
        }
        if checks:
            body["Checks"] = checks
        if kind:
            body["Kind"] = kind  # "connect-proxy" for Connect sidecars
        if proxy:
            body["Proxy"] = proxy
        self._call("PUT", "/v1/agent/service/register", body)

    def deregister_service(self, service_id: str) -> None:
        self._call("PUT", f"/v1/agent/service/deregister/{service_id}")

    # -- KV store (the template hook's {{ key }} source) ----------------

    def kv_get(self, key: str) -> Optional[str]:
        """Value at ``key`` or None (Consul /v1/kv API, base64 values)."""
        import base64

        try:
            entries = self._call("GET", f"/v1/kv/{key.lstrip('/')}")
        except ConsulError:
            return None
        if not entries:
            return None
        raw = entries[0].get("Value") or ""
        return base64.b64decode(raw).decode() if raw else ""

    def kv_put(self, key: str, value: str) -> None:
        self._call("PUT", f"/v1/kv/{key.lstrip('/')}", raw_body=value)

    def services(self) -> Dict[str, dict]:
        return self._call("GET", "/v1/agent/services") or {}

    # -- TTL checks (the script-check slot, command/agent/consul/script.go:
    # Nomad registers script checks as TTL checks and heartbeats them
    # itself after running the command through the driver exec API) -----

    def register_ttl_check(self, check_id: str, name: str, service_id: str,
                           ttl: str) -> None:
        self._call("PUT", "/v1/agent/check/register", {
            "ID": check_id, "Name": name, "ServiceID": service_id, "TTL": ttl,
        })

    def update_ttl(self, check_id: str, status: str, output: str = "") -> None:
        self._call("PUT", f"/v1/agent/check/update/{check_id}", {
            "Status": status, "Output": output,
        })

    def deregister_check(self, check_id: str) -> None:
        self._call("PUT", f"/v1/agent/check/deregister/{check_id}")

    # -- task lifecycle hooks (consul/client.go RegisterWorkload) --------

    @staticmethod
    def is_script_check(c: dict) -> bool:
        return c.get("type") == "script" or bool(c.get("command"))

    @staticmethod
    def _check_body(svc_name: str, c: dict) -> Optional[dict]:
        """Consul rejects TTL+Interval together; shape per check kind.
        Script checks return None — they register separately as TTL
        checks the client heartbeats (script.go semantics)."""
        if ConsulClient.is_script_check(c):
            return None
        body = {"Name": c.get("name", f"service: {svc_name} check")}
        if c.get("ttl"):
            body["TTL"] = c["ttl"]
        elif c.get("http"):
            body["HTTP"] = c["http"]
            body["Interval"] = c.get("interval", "10s")
        elif c.get("tcp"):
            body["TCP"] = c["tcp"]
            body["Interval"] = c.get("interval", "10s")
        return body

    @staticmethod
    def _resolve_port(alloc, task, port_label: str) -> int:
        """Map a service's port label to the alloc's assigned port value
        (consul/client.go serviceRegs → GetTaskEnv port lookup)."""
        if not port_label:
            return 0
        res = alloc.allocated_resources
        task_res = res.tasks.get(task.name) if res is not None else None
        networks = list(task_res.networks) if task_res is not None else []
        for net in networks:
            for port in list(net.dynamic_ports) + list(net.reserved_ports):
                if port.label == port_label:
                    return port.value
        return 0

    def register_task_services(self, alloc, task, address: str = "") -> List[str]:
        """Register every service stanza on the task; returns the ids for
        deregistration at task stop."""
        ids = []
        for svc in task.services or []:
            sid = task_service_id(alloc.id, task.name, svc.name)
            checks = [
                b for b in (
                    self._check_body(svc.name, c)
                    for c in getattr(svc, "checks", []) or []
                ) if b is not None
            ]
            try:
                self.register_service(
                    sid, svc.name, address=address,
                    port=self._resolve_port(alloc, task, svc.port_label),
                    tags=svc.tags, checks=checks or None,
                )
                ids.append(sid)
            except ConsulError as e:
                logger.warning("registering %s failed: %s", sid, e)
        return ids

    def register_group_services(self, alloc, tg, address: str = "") -> List[str]:
        """Register GROUP-level services; a service with a Connect sidecar
        also registers its proxy service (Kind=connect-proxy, the
        reference's groupServiceHook + sidecar registration)."""
        from ..structs.structs import CONNECT_PROXY_PREFIX

        def group_port(label: str) -> int:
            ar = alloc.allocated_resources
            if ar is None or not label:
                return 0
            for net in ar.shared.networks:
                for p in list(net.dynamic_ports) + list(net.reserved_ports):
                    if p.label == label:
                        return p.value
            # group asks may have landed on a task's offer
            for tr in ar.tasks.values():
                for net in tr.networks:
                    for p in list(net.dynamic_ports) + list(net.reserved_ports):
                        if p.label == label:
                            return p.value
            return 0

        ids: List[str] = []
        for svc in getattr(tg, "services", []) or []:
            sid = f"_nomad-group-{alloc.id}-{svc.name}"
            for c in getattr(svc, "checks", []) or []:
                if self.is_script_check(c):
                    # group-level script checks need a task to exec in
                    # (reference check.task field) — not wired here yet
                    logger.warning(
                        "group service %s: script checks on group services "
                        "are not supported; check %r skipped",
                        svc.name, c.get("name", ""),
                    )
            checks = [
                b for b in (
                    self._check_body(svc.name, c)
                    for c in getattr(svc, "checks", []) or []
                ) if b is not None
            ]
            try:
                self.register_service(
                    sid, svc.name, address=address,
                    port=group_port(svc.port_label),
                    tags=svc.tags, checks=checks or None,
                )
                ids.append(sid)
            except ConsulError as e:
                logger.warning("registering %s failed: %s", sid, e)
                continue
            if getattr(svc, "has_sidecar", lambda: False)():
                proxy_label = f"{CONNECT_PROXY_PREFIX}-{svc.name}"
                proxy_id = f"{sid}-sidecar-proxy"
                sidecar = (svc.connect or {}).get("sidecar_service") or {}
                proxy_cfg = dict(sidecar.get("proxy") or {})
                proxy_cfg.setdefault("DestinationServiceName", svc.name)
                proxy_cfg.setdefault("DestinationServiceID", sid)
                try:
                    self.register_service(
                        proxy_id, f"{svc.name}-sidecar-proxy",
                        address=address,
                        port=group_port(proxy_label),
                        tags=svc.tags,
                        kind="connect-proxy",
                        proxy=proxy_cfg,
                    )
                    ids.append(proxy_id)
                except ConsulError as e:
                    logger.warning("registering %s failed: %s", proxy_id, e)
        return ids

    def deregister_ids(self, ids: List[str]) -> None:
        for sid in ids:
            try:
                self.deregister_service(sid)
            except ConsulError as e:
                logger.warning("deregistering %s failed: %s", sid, e)


# ---------------------------------------------------------------------------
# In-tree mock Consul
# ---------------------------------------------------------------------------


class MockConsulServer:
    """The slice of Consul's agent API the integration uses."""

    def __init__(self) -> None:
        import http.server
        import socketserver

        self.services: Dict[str, dict] = {}
        self.checks: Dict[str, dict] = {}
        self.kv: Dict[str, str] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, obj=None) -> None:
                payload = json.dumps(obj).encode() if obj is not None else b""
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_PUT(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if self.path.startswith("/v1/kv/"):
                    key = self.path[len("/v1/kv/"):]
                    with outer._lock:
                        outer.kv[key] = raw.decode()
                    return self._reply(200, True)
                body = json.loads(raw or b"{}")
                if self.path == "/v1/agent/check/register":
                    with outer._lock:
                        outer.checks[body["ID"]] = {
                            "Name": body.get("Name", ""),
                            "ServiceID": body.get("ServiceID", ""),
                            "TTL": body.get("TTL", ""),
                            "Status": "critical",
                            "Output": "",
                        }
                    return self._reply(200)
                if self.path.startswith("/v1/agent/check/update/"):
                    cid = self.path.rsplit("/", 1)[1]
                    with outer._lock:
                        chk = outer.checks.get(cid)
                        if chk is None:
                            return self._reply(404, {"error": "unknown check"})
                        chk["Status"] = body.get("Status", "")
                        chk["Output"] = body.get("Output", "")
                    return self._reply(200)
                if self.path.startswith("/v1/agent/check/deregister/"):
                    cid = self.path.rsplit("/", 1)[1]
                    with outer._lock:
                        outer.checks.pop(cid, None)
                    return self._reply(200)
                if self.path == "/v1/agent/service/register":
                    with outer._lock:
                        outer.services[body["ID"]] = body
                    return self._reply(200)
                if self.path.startswith("/v1/agent/service/deregister/"):
                    sid = self.path.rsplit("/", 1)[1]
                    with outer._lock:
                        outer.services.pop(sid, None)
                    return self._reply(200)
                return self._reply(404, {"error": "no handler"})

            def do_GET(self):
                if self.path == "/v1/agent/services":
                    with outer._lock:
                        return self._reply(200, dict(outer.services))
                if self.path.startswith("/v1/kv/"):
                    import base64

                    key = self.path[len("/v1/kv/"):]
                    with outer._lock:
                        val = outer.kv.get(key)
                    if val is None:
                        return self._reply(404, [])
                    return self._reply(200, [{
                        "Key": key,
                        "Value": base64.b64encode(val.encode()).decode(),
                    }])
                return self._reply(404, {"error": "no handler"})

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.address = "http://{}:{}".format(*self._srv.server_address)
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)

    def start(self) -> "MockConsulServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
