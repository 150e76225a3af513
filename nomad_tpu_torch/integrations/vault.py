"""Vault integration: per-task token derivation / renewal / revocation.

Fills the role of reference ``nomad/vault.go`` (1,349 LoC vaultClient):
the leader derives child tokens for tasks that carry a ``vault`` stanza
(CreateToken with the task's policies, vault.go DeriveToken), tracks the
token accessors so allocations that die get their tokens revoked
(RevokeTokens / MarkForRevocation), and renews its own server token.
Transport is Vault's plain HTTP API; ``MockVaultServer`` is the in-tree
stand-in (the reference tests use a real dev-mode Vault binary —
nomad/vault_testing.go; zero-egress environments get the mock).

Copied from ``nomad_tpu/integrations/vault.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``. Its logger is ``nomad_tpu_torch.vault``.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger("nomad_tpu_torch.vault")


@dataclass
class VaultConfig:
    enabled: bool = False
    address: str = ""  # e.g. http://127.0.0.1:8200
    token: str = ""  # server's own (root/periodic) token
    task_token_ttl: str = "72h"
    allow_unauthenticated: bool = True  # jobs may use vault without a token


class VaultError(Exception):
    pass


class VaultClient:
    """Server-side Vault API client (vault.go vaultClient)."""

    def __init__(self, config: VaultConfig) -> None:
        self.config = config

    @property
    def enabled(self) -> bool:
        return self.config.enabled and bool(self.config.address)

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              token: Optional[str] = None) -> dict:
        req = urllib.request.Request(
            self.config.address + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"X-Vault-Token": token or self.config.token},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            raise VaultError(f"vault {path}: {e.code} {e.read().decode(errors='replace')}")
        except OSError as e:
            raise VaultError(f"vault unreachable at {self.config.address}: {e}")

    # -- token lifecycle -------------------------------------------------

    def derive_token(self, policies: List[str]) -> Dict[str, str]:
        """Child token restricted to the task's policies (vault.go
        DeriveToken → auth/token/create). Returns {token, accessor}."""
        out = self._call("POST", "/v1/auth/token/create", {
            "policies": policies,
            "ttl": self.config.task_token_ttl,
            "display_name": "nomad-task",
            "renewable": True,
        })
        auth = out.get("auth") or {}
        if not auth.get("client_token"):
            raise VaultError("vault returned no client token")
        return {"token": auth["client_token"], "accessor": auth.get("accessor", "")}

    def renew(self, token: str) -> None:
        self._call("POST", "/v1/auth/token/renew", {"token": token})

    def revoke_accessor(self, accessor: str) -> None:
        self._call("POST", "/v1/auth/token/revoke-accessor", {"accessor": accessor})

    def revoke_accessors(self, accessors: List[str]) -> List[str]:
        """Best-effort batch revoke; returns the accessors that failed
        (leader retries those later, vault.go RevokeTokens)."""
        failed = []
        for acc in accessors:
            try:
                self.revoke_accessor(acc)
            except VaultError as e:
                logger.warning("revoking accessor %s failed: %s", acc[:12], e)
                failed.append(acc)
        return failed

    def read_secret(self, path: str, token: Optional[str] = None) -> dict:
        """KV-v1 style secret read (the template hook's {{ secret }}
        source): GET /v1/<path> → the response's ``data`` map."""
        out = self._call("GET", "/v1/" + path.lstrip("/"), token=token)
        return out.get("data") or {}

    def lookup_self(self) -> dict:
        return self._call("GET", "/v1/auth/token/lookup-self")


# ---------------------------------------------------------------------------
# In-tree mock Vault (vault_testing.go slot)
# ---------------------------------------------------------------------------


@dataclass
class MockToken:
    token: str
    accessor: str
    policies: List[str] = field(default_factory=list)
    ttl: str = ""
    revoked: bool = False
    renewals: int = 0


class MockVaultServer:
    """Just enough of Vault's token API for the integration tests."""

    def __init__(self, root_token: str = "root") -> None:
        import http.server
        import socketserver

        self.root_token = root_token
        self.tokens: Dict[str, MockToken] = {}
        # path -> data map served at GET /v1/<path> (KV-v1 style; the
        # template hook's {{ secret }} source)
        self.secrets: Dict[str, dict] = {}
        self.by_accessor: Dict[str, MockToken] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, obj) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                auth = self.headers.get("X-Vault-Token", "")
                if not outer._valid(auth):
                    return self._reply(403, {"errors": ["permission denied"]})
                if self.path == "/v1/auth/token/create":
                    tok = outer._create(body)
                    return self._reply(200, {"auth": {
                        "client_token": tok.token,
                        "accessor": tok.accessor,
                        "policies": tok.policies,
                    }})
                if self.path == "/v1/auth/token/renew":
                    with outer._lock:
                        t = outer.tokens.get(body.get("token", ""))
                        if t is None or t.revoked:
                            return self._reply(400, {"errors": ["bad token"]})
                        t.renewals += 1
                    return self._reply(200, {"auth": {"client_token": t.token}})
                if self.path == "/v1/auth/token/revoke-accessor":
                    with outer._lock:
                        t = outer.by_accessor.get(body.get("accessor", ""))
                        if t is None:
                            return self._reply(400, {"errors": ["unknown accessor"]})
                        t.revoked = True
                    return self._reply(204, {})
                return self._reply(404, {"errors": ["no handler"]})

            def do_GET(self):
                auth = self.headers.get("X-Vault-Token", "")
                if self.path == "/v1/auth/token/lookup-self":
                    with outer._lock:
                        t = outer.tokens.get(auth)
                    if auth == outer.root_token:
                        return self._reply(200, {"data": {"policies": ["root"]}})
                    if t is None or t.revoked:
                        return self._reply(403, {"errors": ["permission denied"]})
                    return self._reply(200, {"data": {"policies": t.policies}})
                if self.path.startswith("/v1/secret/"):
                    if not outer._valid(auth):
                        return self._reply(403, {"errors": ["permission denied"]})
                    key = self.path[len("/v1/"):]
                    with outer._lock:
                        data = outer.secrets.get(key)
                    if data is None:
                        return self._reply(404, {"errors": ["not found"]})
                    return self._reply(200, {"data": data})
                return self._reply(404, {"errors": ["no handler"]})

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.address = "http://{}:{}".format(*self._srv.server_address)
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)

    def _valid(self, token: str) -> bool:
        if token == self.root_token:
            return True
        with self._lock:
            t = self.tokens.get(token)
        return t is not None and not t.revoked

    def _create(self, body: dict) -> MockToken:
        tok = MockToken(
            token=f"s.{uuid.uuid4().hex[:24]}",
            accessor=uuid.uuid4().hex[:24],
            policies=list(body.get("policies") or []),
            ttl=str(body.get("ttl", "")),
        )
        with self._lock:
            self.tokens[tok.token] = tok
            self.by_accessor[tok.accessor] = tok
        return tok

    def start(self) -> "MockVaultServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
