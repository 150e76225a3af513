"""Typed HTTP client SDK (reference api/api.go:371 Client and the per-noun
files api/jobs.go, api/nodes.go, api/allocations.go, api/evaluations.go,
api/deployments.go, api/acl.go, api/operator.go, api/agent.go, api/search.go).

The Go SDK is a standalone module importable without the rest of Nomad; this
package mirrors that: it depends only on the standard library (urllib) and
speaks the agent's Go-style wire JSON. Blocking queries work exactly like the
reference: pass ``QueryOptions(wait_index=...)`` and the request long-polls
until the server's index passes it, returning ``QueryMeta.last_index`` for the
next call.

Copied from ``nomad_tpu/api/api.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class APIError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"Unexpected response code: {code} ({message})")
        self.code = code
        self.message = message


@dataclass
class QueryOptions:
    namespace: str = ""
    region: str = ""
    prefix: str = ""
    auth_token: str = ""
    wait_index: int = 0
    wait_time: str = ""  # Go duration string, e.g. "5s"
    params: Dict[str, str] = field(default_factory=dict)


@dataclass
class WriteOptions:
    namespace: str = ""
    region: str = ""
    auth_token: str = ""


@dataclass
class QueryMeta:
    last_index: int = 0
    known_leader: bool = False
    request_time_ns: int = 0


@dataclass
class WriteMeta:
    last_index: int = 0


@dataclass
class Config:
    """Client configuration (reference api/api.go DefaultConfig)."""

    address: str = "http://127.0.0.1:4646"
    region: str = ""
    namespace: str = ""
    token: str = ""
    timeout: float = 65.0
    # mutual-TLS material for https:// addresses (reference api.go
    # TLSConfig; env NOMAD_CACERT / NOMAD_CLIENT_CERT / NOMAD_CLIENT_KEY)
    ca_cert: str = ""
    client_cert: str = ""
    client_key: str = ""
    # hostname verification is ON by default; cluster certs pinned to
    # "<role>.<region>.nomad" names need the explicit opt-out (the
    # reference CLI's -tls-skip-verify / api.TLSConfig.Insecure)
    tls_skip_verify: bool = False

    def ssl_context(self):
        if not self.address.startswith("https://"):
            return None
        cached = getattr(self, "_ssl_ctx", None)
        if cached is not None:
            return cached
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.ca_cert:
            ctx.load_verify_locations(self.ca_cert)
        if self.client_cert and self.client_key:
            ctx.load_cert_chain(self.client_cert, self.client_key)
        if self.tls_skip_verify:
            ctx.check_hostname = False
        object.__setattr__(self, "_ssl_ctx", ctx)
        return ctx


class Client:
    """Entry point; exposes one sub-client per API noun (api.go:371)."""

    def __init__(self, config: Optional[Config] = None, **kw) -> None:
        self.config = config or Config(**kw)
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.alloc_fs = AllocFS(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.acl_policies = ACLPolicies(self)
        self.acl_tokens = ACLTokens(self)
        self.operator = Operator(self)
        self.agent = AgentAPI(self)
        self.system = System(self)
        self.status = Status(self)
        self.regions = Regions(self)
        self.search = Search(self)

    # -- plumbing ---------------------------------------------------------

    def _url(self, path: str, q: Optional[QueryOptions]) -> str:
        params: Dict[str, str] = {}
        ns = (q.namespace if q else "") or self.config.namespace
        if ns:
            params["namespace"] = ns
        region = (q.region if q else "") or self.config.region
        if region:
            params["region"] = region
        if q is not None:
            if q.prefix:
                params["prefix"] = q.prefix
            if q.wait_index:
                params["index"] = str(q.wait_index)
            if q.wait_time:
                params["wait"] = q.wait_time
            params.update(q.params)
        qs = urllib.parse.urlencode(params)
        return self.config.address + path + (f"?{qs}" if qs else "")

    def _do(
        self,
        method: str,
        path: str,
        body: Any = None,
        q: Optional[QueryOptions] = None,
        raw: bool = False,
    ) -> Tuple[Any, QueryMeta]:
        url = self._url(path, q)
        data = None
        if body is not None:
            data = body if isinstance(body, bytes) else json.dumps(body).encode()
        headers = {}
        token = (q.auth_token if q else "") or self.config.token
        if token:
            headers["X-Nomad-Token"] = token
        if data is not None:
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(
                req, timeout=self.config.timeout, context=self.config.ssl_context()
            ) as resp:
                payload = resp.read()
                meta = QueryMeta(
                    last_index=int(resp.headers.get("X-Nomad-Index") or 0),
                    known_leader=resp.headers.get("X-Nomad-KnownLeader") == "true",
                )
                if raw:
                    return payload, meta
                text = payload.decode()
                return (json.loads(text) if text else None), meta
        except urllib.error.HTTPError as e:
            raise APIError(e.code, e.read().decode(errors="replace"))
        except urllib.error.URLError as e:
            raise APIError(0, str(e.reason))

    def get(self, path: str, q: Optional[QueryOptions] = None):
        return self._do("GET", path, None, q)

    def get_raw(self, path: str, q: Optional[QueryOptions] = None) -> bytes:
        """GET returning raw bytes (fs cat/readat/logs endpoints)."""
        payload, _ = self._do("GET", path, None, q, raw=True)
        return payload

    def put(self, path: str, body: Any = None, q: Optional[QueryOptions] = None):
        return self._do("PUT", path, body, q)

    def post(self, path: str, body: Any = None, q: Optional[QueryOptions] = None):
        return self._do("POST", path, body, q)

    def delete(self, path: str, q: Optional[QueryOptions] = None):
        return self._do("DELETE", path, None, q)


class _Sub:
    def __init__(self, client: Client) -> None:
        self.client = client


# ---------------------------------------------------------------------------
# Jobs (api/jobs.go)
# ---------------------------------------------------------------------------


class Jobs(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/jobs", q)

    def info(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}", q)

    def register(self, job: Dict[str, Any], q: Optional[QueryOptions] = None):
        return self.client.put("/v1/jobs", {"Job": job}, q)

    def deregister(self, job_id: str, purge: bool = False, q: Optional[QueryOptions] = None):
        q = q or QueryOptions()
        if purge:
            q.params["purge"] = "true"
        return self.client.delete(f"/v1/job/{job_id}", q)

    def parse_hcl(self, hcl: str, canonicalize: bool = True):
        out, _ = self.client.post(
            "/v1/jobs/parse", {"JobHCL": hcl, "Canonicalize": canonicalize}
        )
        return out

    def validate(self, job: Dict[str, Any], q: Optional[QueryOptions] = None):
        return self.client.put("/v1/validate/job", {"Job": job}, q)

    def plan(self, job: Dict[str, Any], diff: bool = True, q: Optional[QueryOptions] = None):
        return self.client.put(
            f"/v1/job/{job.get('ID', '')}/plan", {"Job": job, "Diff": diff}, q
        )

    def evaluate(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/job/{job_id}/evaluate", {}, q)

    def allocations(self, job_id: str, all_allocs: bool = False, q: Optional[QueryOptions] = None):
        q = q or QueryOptions()
        if all_allocs:
            q.params["all"] = "true"
        return self.client.get(f"/v1/job/{job_id}/allocations", q)

    def evaluations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}/evaluations", q)

    def deployments(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}/deployments", q)

    def latest_deployment(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}/deployment", q)

    def summary(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}/summary", q)

    def versions(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/job/{job_id}/versions", q)

    def dispatch(
        self,
        job_id: str,
        meta: Optional[Dict[str, str]] = None,
        payload: bytes = b"",
        q: Optional[QueryOptions] = None,
    ):
        import base64

        body: Dict[str, Any] = {"Meta": meta or {}}
        if payload:
            body["Payload"] = base64.b64encode(payload).decode()
        return self.client.put(f"/v1/job/{job_id}/dispatch", body, q)

    def revert(self, job_id: str, version: int, q: Optional[QueryOptions] = None):
        return self.client.put(
            f"/v1/job/{job_id}/revert",
            {"JobID": job_id, "JobVersion": version},
            q,
        )

    def stable(self, job_id: str, version: int, stable: bool, q: Optional[QueryOptions] = None):
        return self.client.put(
            f"/v1/job/{job_id}/stable",
            {"JobID": job_id, "JobVersion": version, "Stable": stable},
            q,
        )

    def periodic_force(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/job/{job_id}/periodic/force", {}, q)


# ---------------------------------------------------------------------------
# Nodes (api/nodes.go)
# ---------------------------------------------------------------------------


class Nodes(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/nodes", q)

    def info(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/node/{node_id}", q)

    def stats(self, node_id: str = "", q: Optional[QueryOptions] = None):
        """Host stats (api/nodes.go Stats → /v1/client/stats); node_id
        makes a server agent proxy to that node."""
        q = q or QueryOptions()
        if node_id:
            q.params["node_id"] = node_id
        return self.client.get("/v1/client/stats", q)

    def allocations(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/node/{node_id}/allocations", q)

    def evaluate(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/node/{node_id}/evaluate", {}, q)

    def update_drain(
        self,
        node_id: str,
        spec: Optional[Dict[str, Any]],
        mark_eligible: bool = False,
        q: Optional[QueryOptions] = None,
    ):
        return self.client.put(
            f"/v1/node/{node_id}/drain",
            {"DrainSpec": spec, "MarkEligible": mark_eligible},
            q,
        )

    def toggle_eligibility(self, node_id: str, eligible: bool, q: Optional[QueryOptions] = None):
        return self.client.put(
            f"/v1/node/{node_id}/eligibility",
            {"Eligibility": "eligible" if eligible else "ineligible"},
            q,
        )

    def purge(self, node_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/node/{node_id}/purge", {}, q)


# ---------------------------------------------------------------------------
# Allocations / Evaluations / Deployments
# ---------------------------------------------------------------------------


class Allocations(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/allocations", q)

    def info(self, alloc_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/allocation/{alloc_id}", q)

    def stop(self, alloc_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/allocation/{alloc_id}/stop", {}, q)

    def stats(self, alloc_id: str, q: Optional[QueryOptions] = None):
        """Per-task resource usage (api/allocations.go Stats)."""
        return self.client.get(f"/v1/client/allocation/{alloc_id}/stats", q)

    def restart(self, alloc_id: str, task: str = "", q=None):
        """api/allocations.go Restart."""
        return self.client.put(
            f"/v1/client/allocation/{alloc_id}/restart", {"Task": task}, q
        )

    def signal(self, alloc_id: str, signal: str, task: str = "", q=None):
        """api/allocations.go Signal."""
        return self.client.put(
            f"/v1/client/allocation/{alloc_id}/signal",
            {"Signal": signal, "Task": task}, q,
        )

    def exec_task(self, alloc_id: str, task: str, cmd, timeout: float = 30.0, q=None):
        """One-shot exec (the reference's alloc-exec, non-interactive)."""
        q = q or QueryOptions()
        q.params["timeout"] = str(timeout)
        return self.client.post(
            f"/v1/client/allocation/{alloc_id}/exec",
            {"Task": task, "Cmd": list(cmd)}, q,
        )

    def exec_stream(self, alloc_id: str, task: str, command) -> "ExecStream":
        """INTERACTIVE exec over a websocket (api/allocations.go Exec /
        the reference's execStream): returns a session with stdin/stdout
        pumps and the remote exit code."""
        import json as json_mod

        cfg = self.client.config
        parsed = urllib.parse.urlsplit(cfg.address)
        default_port = 443 if parsed.scheme == "https" else 80
        host, port = parsed.hostname, parsed.port or default_port
        params = {"task": task, "command": json_mod.dumps(list(command))}
        path = (
            f"/v1/client/allocation/{alloc_id}/exec?"
            + urllib.parse.urlencode(params)
        )
        headers = {}
        if cfg.token:
            headers["X-Nomad-Token"] = cfg.token
        from ..agent.websocket import WebSocketClient

        ws = WebSocketClient(
            host, port, path, headers=headers, tls_context=cfg.ssl_context(),
        )
        return ExecStream(ws)


class ExecStream:
    """Client side of the interactive exec protocol: json frames with
    base64 stdio, terminated by an {"exit_code": N} frame."""

    def __init__(self, ws) -> None:
        self._ws = ws
        self.exit_code: Optional[int] = None

    def send_stdin(self, data: bytes) -> None:
        import base64
        import json as json_mod

        frame = {"stdin": {"data": base64.b64encode(data).decode()}}
        self._ws.send(json_mod.dumps(frame).encode(), opcode=0x1)

    def close_stdin(self) -> None:
        import json as json_mod

        self._ws.send(json_mod.dumps({"stdin": {"close": True}}).encode(), opcode=0x1)

    def read_output(self) -> Optional[bytes]:
        """Next stdout chunk, or None when the session ended (exit_code
        is set afterwards)."""
        import base64
        import json as json_mod

        while True:
            try:
                opcode, payload = self._ws.recv()
            except (ConnectionError, OSError):
                return None
            if opcode == 0x8:  # close
                return None
            try:
                frame = json_mod.loads(payload or b"{}")
            except ValueError:
                continue
            if "exit_code" in frame:
                self.exit_code = frame["exit_code"]
                return None
            data = (frame.get("stdout") or {}).get("data")
            if data:
                return base64.b64decode(data)

    def close(self) -> None:
        self._ws.close()


class AllocFS(_Sub):
    """Alloc filesystem/log access (api/fs.go AllocFS)."""

    def ls(self, alloc_id: str, path: str = "/", q: Optional[QueryOptions] = None):
        q = q or QueryOptions()
        q.params["path"] = path
        return self.client.get(f"/v1/client/fs/ls/{alloc_id}", q)

    def stat(self, alloc_id: str, path: str, q: Optional[QueryOptions] = None):
        q = q or QueryOptions()
        q.params["path"] = path
        return self.client.get(f"/v1/client/fs/stat/{alloc_id}", q)

    def cat(self, alloc_id: str, path: str, q: Optional[QueryOptions] = None) -> bytes:
        q = q or QueryOptions()
        q.params["path"] = path
        return self.client.get_raw(f"/v1/client/fs/cat/{alloc_id}", q)

    def read_at(self, alloc_id: str, path: str, offset: int, limit: int,
                q: Optional[QueryOptions] = None) -> bytes:
        q = q or QueryOptions()
        q.params.update({"path": path, "offset": str(offset), "limit": str(limit)})
        return self.client.get_raw(f"/v1/client/fs/readat/{alloc_id}", q)

    def logs(self, alloc_id: str, task: str, log_type: str = "stdout",
             offset: int = 0, origin: str = "start",
             q: Optional[QueryOptions] = None) -> bytes:
        data, _ = self.logs_at(alloc_id, task, log_type, offset, origin, q)
        return data

    def logs_at(self, alloc_id: str, task: str, log_type: str = "stdout",
                offset: int = 0, origin: str = "start",
                q: Optional[QueryOptions] = None):
        """(data, next_offset): the server returns the next stream offset
        in X-Nomad-Index so followers survive log rotation."""
        q = q or QueryOptions()
        q.params.update({
            "task": task, "type": log_type,
            "offset": str(offset), "origin": origin,
        })
        data, meta = self.client._do(
            "GET", f"/v1/client/fs/logs/{alloc_id}", None, q, raw=True
        )
        return data, meta.last_index

    def logs_follow(self, alloc_id: str, task: str, log_type: str = "stdout",
                    offset: int = 0, origin: str = "start",
                    q: Optional[QueryOptions] = None):
        """SERVER-PUSH log stream (follow=true): yields byte chunks as the
        task writes them; the generator ends when the caller closes it or
        the agent goes away."""
        q = q or QueryOptions()
        q.params.update({
            "task": task, "type": log_type, "offset": str(offset),
            "origin": origin, "follow": "true",
        })
        url = self.client._url(f"/v1/client/fs/logs/{alloc_id}", q)
        req = urllib.request.Request(url)
        if self.client.config.token:
            req.add_header("X-Nomad-Token", self.client.config.token)
        resp = urllib.request.urlopen(
            req, timeout=3600, context=self.client.config.ssl_context()
        )

        def gen():
            try:
                while True:
                    chunk = resp.read1(8192) if hasattr(resp, "read1") else resp.read(8192)
                    if not chunk:
                        return
                    yield chunk
            finally:
                resp.close()

        return gen()


class Evaluations(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/evaluations", q)

    def info(self, eval_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/evaluation/{eval_id}", q)

    def allocations(self, eval_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/evaluation/{eval_id}/allocations", q)


class Deployments(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/deployments", q)

    def info(self, deployment_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/deployment/{deployment_id}", q)

    def allocations(self, deployment_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/deployment/allocations/{deployment_id}", q)

    def promote(self, deployment_id: str, groups: Optional[List[str]] = None, q=None):
        body: Dict[str, Any] = {"DeploymentID": deployment_id}
        if groups:
            body["Groups"] = groups
        else:
            body["All"] = True
        return self.client.put(f"/v1/deployment/promote/{deployment_id}", body, q)

    def fail(self, deployment_id: str, q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/deployment/fail/{deployment_id}", {}, q)

    def pause(self, deployment_id: str, pause: bool, q: Optional[QueryOptions] = None):
        return self.client.put(
            f"/v1/deployment/pause/{deployment_id}",
            {"DeploymentID": deployment_id, "Pause": pause},
            q,
        )


# ---------------------------------------------------------------------------
# ACL (api/acl.go)
# ---------------------------------------------------------------------------


class ACLPolicies(_Sub):
    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/acl/policies", q)

    def info(self, name: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/acl/policy/{name}", q)

    def upsert(self, policy: Dict[str, Any], q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/acl/policy/{policy['Name']}", policy, q)

    def delete(self, name: str, q: Optional[QueryOptions] = None):
        return self.client.delete(f"/v1/acl/policy/{name}", q)


class ACLTokens(_Sub):
    def bootstrap(self, q: Optional[QueryOptions] = None):
        return self.client.put("/v1/acl/bootstrap", {}, q)

    def list(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/acl/tokens", q)

    def info(self, accessor_id: str, q: Optional[QueryOptions] = None):
        return self.client.get(f"/v1/acl/token/{accessor_id}", q)

    def self(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/acl/token/self", q)

    def create(self, token: Dict[str, Any], q: Optional[QueryOptions] = None):
        return self.client.put("/v1/acl/token", token, q)

    def update(self, token: Dict[str, Any], q: Optional[QueryOptions] = None):
        return self.client.put(f"/v1/acl/token/{token['AccessorID']}", token, q)

    def delete(self, accessor_id: str, q: Optional[QueryOptions] = None):
        return self.client.delete(f"/v1/acl/token/{accessor_id}", q)


# ---------------------------------------------------------------------------
# Operator / Agent / System / Status / Regions / Search
# ---------------------------------------------------------------------------


class Operator(_Sub):
    def scheduler_get_configuration(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/operator/scheduler/configuration", q)

    def scheduler_set_configuration(self, config: Dict[str, Any], q=None):
        return self.client.put("/v1/operator/scheduler/configuration", config, q)

    def raft_get_configuration(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/operator/raft/configuration", q)

    def autopilot_get_configuration(self, q: Optional[QueryOptions] = None):
        return self.client.get("/v1/operator/autopilot/configuration", q)

    def autopilot_set_configuration(self, config: Dict[str, Any], q=None):
        return self.client.put("/v1/operator/autopilot/configuration", config, q)

    def raft_remove_peer(self, peer_id: str, q: Optional[QueryOptions] = None):
        """Reference api/operator.go RaftRemovePeerByID."""
        from urllib.parse import quote

        return self.client.delete(
            f"/v1/operator/raft/peer?id={quote(peer_id, safe='')}", q
        )


class AgentAPI(_Sub):
    def self(self):
        out, _ = self.client.get("/v1/agent/self")
        return out

    def health(self):
        out, _ = self.client.get("/v1/agent/health")
        return out

    def members(self):
        out, _ = self.client.get("/v1/agent/members")
        return out

    def servers(self):
        out, _ = self.client.get("/v1/agent/servers")
        return out

    def metrics(self):
        out, _ = self.client.get("/v1/metrics")
        return out

    def monitor(self, log_level: str = "info", seq: int = 0):
        """One log-tail poll (api/agent.go Monitor's non-follow shape)."""
        out, _ = self.client.get(
            f"/v1/agent/monitor?log_level={log_level}&seq={seq}"
        )
        return out

    def monitor_follow(self, log_level: str = "info"):
        """SERVER-PUSH agent log stream (/v1/agent/monitor?follow=true):
        yields byte chunks until closed (api/agent.go Monitor)."""
        url = self.client._url(
            "/v1/agent/monitor",
            QueryOptions(params={"log_level": log_level, "follow": "true"}),
        )
        req = urllib.request.Request(url)
        if self.client.config.token:
            req.add_header("X-Nomad-Token", self.client.config.token)
        resp = urllib.request.urlopen(
            req, timeout=3600, context=self.client.config.ssl_context()
        )

        def gen():
            try:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        return
                    yield chunk
            finally:
                resp.close()

        return gen()

    def join(self, addresses):
        """api/agent.go Join: runtime gossip join."""
        from urllib.parse import quote

        qs = "&".join(f"address={quote(a, safe='')}" for a in addresses)
        out, _ = self.client.put(f"/v1/agent/join?{qs}", {})
        return out

    def force_leave(self, node: str):
        from urllib.parse import quote

        out, _ = self.client.put(
            f"/v1/agent/force-leave?node={quote(node, safe='')}", {}
        )
        return out

    def keyring_list(self):
        out, _ = self.client.get("/v1/agent/keyring/list")
        return out

    def keyring_op(self, op: str, key: str):
        """op: install | use | remove."""
        out, _ = self.client.put(f"/v1/agent/keyring/{op}", {"Key": key})
        return out

    def client_gc(self):
        out, _ = self.client.put("/v1/client/gc", {})
        return out


class System(_Sub):
    def garbage_collect(self):
        return self.client.put("/v1/system/gc", {})

    def reconcile_summaries(self):
        return self.client.put("/v1/system/reconcile/summaries", {})


class Status(_Sub):
    def leader(self):
        out, _ = self.client.get("/v1/status/leader")
        return out

    def peers(self):
        out, _ = self.client.get("/v1/status/peers")
        return out


class Regions(_Sub):
    def list(self):
        out, _ = self.client.get("/v1/regions")
        return sorted(out or [])


class Search(_Sub):
    def prefix_search(self, prefix: str, context: str = "all", q=None):
        out, _ = self.client.post(
            "/v1/search", {"Prefix": prefix, "Context": context}, q
        )
        return out
