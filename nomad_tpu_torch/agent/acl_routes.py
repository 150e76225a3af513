"""/v1/acl/* HTTP surface (reference command/agent/acl_endpoint.go →
nomad/acl_endpoint.go).

Copied from ``nomad_tpu/agent/acl_routes.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""

from __future__ import annotations

from typing import List

from ..structs.acl import ACLPolicy, ACLToken
from . import jsonapi
from .http import HTTPError, Request


class ACLRoutes:
    def __init__(self, agent) -> None:
        self.agent = agent

    @property
    def server(self):
        if self.agent.server is None:
            raise HTTPError(501, "server is not enabled on this agent")
        return self.agent.server

    @property
    def state(self):
        return self.server.fsm.state

    def register_all(self, mux) -> None:
        r = mux.register
        r("/v1/acl/bootstrap", self.bootstrap)
        r("/v1/acl/policies", self.policies_index)
        r("/v1/acl/policy/", self.policy_specific)
        r("/v1/acl/tokens", self.tokens_index)
        r("/v1/acl/token", self.token_create)
        r("/v1/acl/token/", self.token_specific)

    # -- helpers ----------------------------------------------------------

    def _require_management(self, req: Request) -> None:
        resolver = self.agent.acl_resolver
        if resolver is None:
            raise HTTPError(400, "ACL support disabled")
        acl = resolver.resolve_secret(req.options.auth_token)
        if acl is None or not acl.is_management():
            raise PermissionError("Permission denied")

    def _enabled(self) -> None:
        if self.agent.acl_resolver is None:
            raise HTTPError(400, "ACL support disabled")

    # -- handlers ---------------------------------------------------------

    def bootstrap(self, req: Request):
        self._enabled()
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        try:
            token = self.server.bootstrap_acl()
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return token

    def policies_index(self, req: Request):
        self._enabled()
        self._require_management(req)
        req.response_index = self.state.latest_index
        return [
            {
                "Name": p.name,
                "Description": p.description,
                "CreateIndex": p.create_index,
                "ModifyIndex": p.modify_index,
            }
            for p in self.state.acl_policies()
        ]

    def policy_specific(self, req: Request):
        self._enabled()
        name = req.path[len("/v1/acl/policy/") :]
        if not name:
            raise HTTPError(400, "missing policy name")
        self._require_management(req)
        if req.method == "GET":
            pol = self.state.acl_policy_by_name(name)
            if pol is None:
                raise HTTPError(404, f"policy {name!r} not found")
            req.response_index = pol.modify_index
            return pol
        if req.method in ("PUT", "POST"):
            pol = req.json(ACLPolicy)
            if pol.name and pol.name != name:
                raise HTTPError(400, "policy name does not match request path")
            pol.name = name
            try:
                self.server.upsert_acl_policies([pol])
            except ValueError as e:
                raise HTTPError(400, str(e))
            req.response_index = self.state.latest_index
            return None
        if req.method == "DELETE":
            self.server.delete_acl_policies([name])
            req.response_index = self.state.latest_index
            return None
        raise HTTPError(405, "method not allowed")

    def tokens_index(self, req: Request):
        self._enabled()
        self._require_management(req)
        req.response_index = self.state.latest_index
        return [t.public_stub() for t in self.state.acl_tokens()]

    def token_create(self, req: Request):
        self._enabled()
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._require_management(req)
        tok = req.json(ACLToken)
        try:
            created: List[ACLToken] = self.server.upsert_acl_tokens([tok])
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return created[0]

    def token_specific(self, req: Request):
        self._enabled()
        accessor = req.path[len("/v1/acl/token/") :]
        if accessor == "self":
            return self._token_self(req)
        if not accessor:
            # the longest-prefix mux routes bare /v1/acl/token here too
            return self.token_create(req)
        self._require_management(req)
        if req.method == "GET":
            tok = self.state.acl_token_by_accessor(accessor)
            if tok is None:
                raise HTTPError(404, f"token {accessor!r} not found")
            req.response_index = tok.modify_index
            return tok
        if req.method in ("PUT", "POST"):
            tok = req.json(ACLToken)
            if tok.accessor_id and tok.accessor_id != accessor:
                raise HTTPError(400, "token accessor does not match request path")
            existing = self.state.acl_token_by_accessor(accessor)
            if existing is None:
                raise HTTPError(404, f"token {accessor!r} not found")
            tok.accessor_id = accessor
            tok.secret_id = existing.secret_id  # secrets are immutable
            try:
                created = self.server.upsert_acl_tokens([tok])
            except ValueError as e:
                raise HTTPError(400, str(e))
            req.response_index = self.state.latest_index
            return created[0]
        if req.method == "DELETE":
            self.server.delete_acl_tokens([accessor])
            req.response_index = self.state.latest_index
            return None
        raise HTTPError(405, "method not allowed")

    def _token_self(self, req: Request):
        secret = req.options.auth_token
        if not secret:
            raise HTTPError(400, "no token supplied")
        tok = self.state.acl_token_by_secret(secret)
        if tok is None:
            raise PermissionError("ACL token not found")
        req.response_index = tok.modify_index
        return tok
