"""Token → ACL resolution with policy caching (reference nomad/acl.go
ResolveToken and the server's parsed-ACL LRU at server.go:212).

Copied from ``nomad_tpu/acl/resolver.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from ..structs.acl import ACLToken
from .acl import ACL, Policy, management_acl, new_acl, parse_policy


class TokenError(PermissionError):
    """Presented secret does not resolve to a token (HTTP 403)."""


class PermissionDenied(PermissionError):
    """Token resolved but lacks the capability (HTTP 403)."""


class ACLResolver:
    """Resolves secret IDs against the replicated ACL tables.

    Parsed policies are cached keyed by (name, modify_index) and compiled
    ACLs by the sorted policy-name/index tuple, mirroring the reference's
    two-level cache (nomad/acl.go:37 resolveTokenFromSnapshotCache).
    """

    def __init__(self, state_fn: Callable[[], object], enabled: bool = True) -> None:
        self._state_fn = state_fn
        self.enabled = enabled
        self._lock = threading.Lock()
        self._policy_cache: Dict[Tuple[str, int], Policy] = {}
        self._acl_cache: Dict[Tuple, ACL] = {}

    def resolve_secret(self, secret: str) -> Optional[ACL]:
        """Secret → compiled ACL. ``None`` means "ACLs disabled, allow all"."""
        if not self.enabled:
            return None
        state = self._state_fn()
        if not secret:
            token = ACLToken(accessor_id="anonymous", policies=["anonymous"])
        else:
            token = state.acl_token_by_secret(secret)
            if token is None:
                raise TokenError("ACL token not found")
        if token.is_management():
            return management_acl()
        policies = []
        key = []
        for name in sorted(token.policies):
            pol = state.acl_policy_by_name(name)
            if pol is None:
                continue  # dangling policy reference: grants nothing
            key.append((name, pol.modify_index))
            policies.append(self._parse_cached(pol))
        cache_key = tuple(key)
        with self._lock:
            acl = self._acl_cache.get(cache_key)
        if acl is None:
            acl = new_acl(policies)
            with self._lock:
                self._acl_cache[cache_key] = acl
        return acl

    def _parse_cached(self, pol) -> Policy:
        key = (pol.name, pol.modify_index)
        with self._lock:
            parsed = self._policy_cache.get(key)
        if parsed is None:
            parsed = parse_policy(pol.rules) if pol.rules else Policy()
            with self._lock:
                self._policy_cache[key] = parsed
        return parsed

    # -- HTTP enforcement ---------------------------------------------------

    def check_http(self, req, capabilities, namespace: str) -> None:
        """Enforce capability strings from the route table.

        Namespace capabilities are plain names ("submit-job"); coarse-grained
        checks use "<scope>:<read|write>" ("node:write", "operator:read").
        """
        acl = self.resolve_secret(req.options.auth_token)
        if acl is None:
            return
        for cap in capabilities:
            if ":" in cap:
                scope, op = cap.split(":", 1)
                ok = getattr(acl, f"allow_{scope}_{op}")()
            else:
                ok = acl.allow_namespace_operation(namespace or "default", cap)
            if not ok:
                raise PermissionDenied("Permission denied")
