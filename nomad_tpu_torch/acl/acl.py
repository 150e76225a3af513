"""ACL policy language and capability engine (reference acl/policy.go,
acl/acl.go:43 ACL / :83 NewACL).

Policies are HCL documents:

    namespace "default" {
      policy       = "read"
      capabilities = ["submit-job"]
    }
    node     { policy = "write" }
    agent    { policy = "read" }
    operator { policy = "write" }
    quota    { policy = "read" }
    host_volume "prod-*" {
      policy = "read"
    }

``policy`` shorthands expand to capability sets
(acl/policy.go expandNamespacePolicy); explicit ``capabilities`` merge in.
An :class:`ACL` merges many parsed policies; "deny" always wins
(acl/acl.go:118).  Namespace and host-volume rules support a trailing-``*``
glob, longest-prefix match winning (the reference uses exact radix lookups in
0.10 plus the implicit ``default`` namespace; globs are a superset kept for
convenience).

Copied from ``nomad_tpu/acl/acl.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..jobspec.hcl import HCLError, HCLObject, parse as parse_hcl

# Namespace capabilities (reference acl/policy.go:26-40)
NS_CAP_DENY = "deny"
NS_CAP_LIST_JOBS = "list-jobs"
NS_CAP_READ_JOB = "read-job"
NS_CAP_SUBMIT_JOB = "submit-job"
NS_CAP_DISPATCH_JOB = "dispatch-job"
NS_CAP_READ_LOGS = "read-logs"
NS_CAP_READ_FS = "read-fs"
NS_CAP_ALLOC_EXEC = "alloc-exec"
NS_CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
NS_CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
NS_CAP_SENTINEL_OVERRIDE = "sentinel-override"

_VALID_NS_CAPS = {
    NS_CAP_DENY,
    NS_CAP_LIST_JOBS,
    NS_CAP_READ_JOB,
    NS_CAP_SUBMIT_JOB,
    NS_CAP_DISPATCH_JOB,
    NS_CAP_READ_LOGS,
    NS_CAP_READ_FS,
    NS_CAP_ALLOC_EXEC,
    NS_CAP_ALLOC_NODE_EXEC,
    NS_CAP_ALLOC_LIFECYCLE,
    NS_CAP_SENTINEL_OVERRIDE,
}

HOST_VOLUME_CAP_DENY = "deny"
HOST_VOLUME_CAP_MOUNT_READONLY = "mount-readonly"
HOST_VOLUME_CAP_MOUNT_READWRITE = "mount-readwrite"

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_SCALE = "scale"

_VALID_POLICIES = {POLICY_DENY, POLICY_READ, POLICY_WRITE}


def _expand_namespace_policy(policy: str) -> List[str]:
    if policy == POLICY_DENY:
        return [NS_CAP_DENY]
    if policy == POLICY_READ:
        return [NS_CAP_LIST_JOBS, NS_CAP_READ_JOB]
    if policy == POLICY_WRITE:
        return [
            NS_CAP_LIST_JOBS,
            NS_CAP_READ_JOB,
            NS_CAP_SUBMIT_JOB,
            NS_CAP_DISPATCH_JOB,
            NS_CAP_READ_LOGS,
            NS_CAP_READ_FS,
            NS_CAP_ALLOC_EXEC,
            NS_CAP_ALLOC_LIFECYCLE,
        ]
    raise HCLError(f"invalid namespace policy {policy!r}", 0)


def _expand_host_volume_policy(policy: str) -> List[str]:
    if policy == POLICY_DENY:
        return [HOST_VOLUME_CAP_DENY]
    if policy == POLICY_READ:
        return [HOST_VOLUME_CAP_MOUNT_READONLY]
    if policy == POLICY_WRITE:
        return [HOST_VOLUME_CAP_MOUNT_READONLY, HOST_VOLUME_CAP_MOUNT_READWRITE]
    raise HCLError(f"invalid host_volume policy {policy!r}", 0)


@dataclass
class NamespacePolicy:
    name: str = ""
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class HostVolumePolicy:
    name: str = ""
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class Policy:
    """A parsed policy document (reference acl/policy.go:111 Policy)."""

    namespaces: List[NamespacePolicy] = field(default_factory=list)
    host_volumes: List[HostVolumePolicy] = field(default_factory=list)
    agent: str = ""
    node: str = ""
    operator: str = ""
    quota: str = ""

    def is_empty(self) -> bool:
        return (
            not self.namespaces
            and not self.host_volumes
            and not self.agent
            and not self.node
            and not self.operator
            and not self.quota
        )


def _coarse(o: HCLObject, what: str) -> str:
    p = o.get("policy", "")
    if p not in _VALID_POLICIES:
        raise HCLError(f"invalid {what} policy {p!r}", 0)
    return p


def parse_policy(rules: str) -> Policy:
    """Parse a policy HCL document (reference acl/policy.go:253 Parse)."""
    root = parse_hcl(rules)
    pol = Policy()
    for key, body in root:
        if key == "namespace":
            if not isinstance(body, HCLObject) or len(body) != 1:
                raise HCLError("namespace block requires a name label", 0)
            name, inner = body.items[0]
            if not isinstance(inner, HCLObject):
                raise HCLError("namespace block requires a body", 0)
            np = NamespacePolicy(name=name)
            if "policy" in inner:
                np.policy = inner.get("policy")
                np.capabilities.extend(_expand_namespace_policy(np.policy))
            for cap in inner.get("capabilities") or []:
                if cap not in _VALID_NS_CAPS:
                    raise HCLError(f"invalid namespace capability {cap!r}", 0)
                if cap not in np.capabilities:
                    np.capabilities.append(cap)
            if not np.capabilities:
                raise HCLError(f"namespace {name!r} grants nothing", 0)
            pol.namespaces.append(np)
        elif key == "host_volume":
            if not isinstance(body, HCLObject) or len(body) != 1:
                raise HCLError("host_volume block requires a name label", 0)
            name, inner = body.items[0]
            hv = HostVolumePolicy(name=name)
            if "policy" in inner:
                hv.policy = inner.get("policy")
                hv.capabilities.extend(_expand_host_volume_policy(hv.policy))
            for cap in inner.get("capabilities") or []:
                if cap not in hv.capabilities:
                    hv.capabilities.append(cap)
            pol.host_volumes.append(hv)
        elif key in ("agent", "node", "operator", "quota"):
            if not isinstance(body, HCLObject):
                raise HCLError(f"{key} must be a block", 0)
            setattr(pol, key, _coarse(body, key))
        else:
            raise HCLError(f"unknown policy block {key!r}", 0)
    return pol


# ---------------------------------------------------------------------------
# Merged ACL object
# ---------------------------------------------------------------------------


def _match_rule(rules: Dict[str, frozenset], name: str) -> Optional[frozenset]:
    """Exact match, else longest trailing-* glob match."""
    if name in rules:
        return rules[name]
    best: Tuple[int, Optional[frozenset]] = (-1, None)
    for pattern, caps in rules.items():
        if pattern.endswith("*") and name.startswith(pattern[:-1]):
            if len(pattern) > best[0]:
                best = (len(pattern), caps)
    return best[1]


_COARSE_RANK = {POLICY_DENY: 3, POLICY_WRITE: 2, POLICY_READ: 1, "": 0}


class ACL:
    """Capability check object compiled from policies (acl/acl.go:43)."""

    def __init__(self, management: bool = False) -> None:
        self.management = management
        self._namespaces: Dict[str, frozenset] = {}
        self._host_volumes: Dict[str, frozenset] = {}
        self.agent = ""
        self.node = ""
        self.operator = ""
        self.quota = ""

    # -- namespace ---------------------------------------------------------

    def allow_namespace_operation(self, ns: str, op: str) -> bool:
        if self.management:
            return True
        caps = _match_rule(self._namespaces, ns or "default")
        if caps is None or NS_CAP_DENY in caps:
            return False
        return op in caps

    def allow_namespace(self, ns: str) -> bool:
        if self.management:
            return True
        caps = _match_rule(self._namespaces, ns or "default")
        return bool(caps) and NS_CAP_DENY not in caps

    def allow_host_volume_operation(self, name: str, op: str) -> bool:
        if self.management:
            return True
        caps = _match_rule(self._host_volumes, name)
        if caps is None or HOST_VOLUME_CAP_DENY in caps:
            return False
        return op in caps

    # -- coarse-grained ------------------------------------------------------

    def _coarse_allows(self, level: str, write: bool) -> bool:
        if self.management:
            return True
        if level == POLICY_DENY:
            return False
        if write:
            return level == POLICY_WRITE
        return level in (POLICY_READ, POLICY_WRITE)

    def allow_agent_read(self) -> bool:
        return self._coarse_allows(self.agent, write=False)

    def allow_agent_write(self) -> bool:
        return self._coarse_allows(self.agent, write=True)

    def allow_node_read(self) -> bool:
        return self._coarse_allows(self.node, write=False)

    def allow_node_write(self) -> bool:
        return self._coarse_allows(self.node, write=True)

    def allow_operator_read(self) -> bool:
        return self._coarse_allows(self.operator, write=False)

    def allow_operator_write(self) -> bool:
        return self._coarse_allows(self.operator, write=True)

    def allow_quota_read(self) -> bool:
        return self._coarse_allows(self.quota, write=False)

    def allow_quota_write(self) -> bool:
        return self._coarse_allows(self.quota, write=True)

    def is_management(self) -> bool:
        return self.management


#: ACL that allows everything (management token / ACLs disabled)
def management_acl() -> ACL:
    return ACL(management=True)


def new_acl(policies: Iterable[Policy]) -> ACL:
    """Merge policies into an ACL; deny wins (acl/acl.go:83 NewACL)."""
    acl = ACL()
    ns_caps: Dict[str, set] = {}
    ns_denied: Dict[str, set] = {}
    hv_caps: Dict[str, set] = {}
    hv_denied: Dict[str, set] = {}
    for pol in policies:
        for np in pol.namespaces:
            bucket = ns_caps.setdefault(np.name, set())
            denied = ns_denied.setdefault(np.name, set())
            if NS_CAP_DENY in np.capabilities:
                # a blanket deny wipes previously granted caps for the name
                denied.update(_VALID_NS_CAPS)
            for cap in np.capabilities:
                bucket.add(cap)
        for hv in pol.host_volumes:
            bucket = hv_caps.setdefault(hv.name, set())
            denied = hv_denied.setdefault(hv.name, set())
            if HOST_VOLUME_CAP_DENY in hv.capabilities:
                denied.update(
                    {
                        HOST_VOLUME_CAP_DENY,
                        HOST_VOLUME_CAP_MOUNT_READONLY,
                        HOST_VOLUME_CAP_MOUNT_READWRITE,
                    }
                )
            bucket.update(hv.capabilities)
        for attr in ("agent", "node", "operator", "quota"):
            level = getattr(pol, attr)
            if _COARSE_RANK[level] > _COARSE_RANK[getattr(acl, attr)]:
                setattr(acl, attr, level)
    for name, caps in ns_caps.items():
        if ns_denied.get(name):
            caps = {NS_CAP_DENY}
        acl._namespaces[name] = frozenset(caps)
    for name, caps in hv_caps.items():
        if hv_denied.get(name):
            caps = {HOST_VOLUME_CAP_DENY}
        acl._host_volumes[name] = frozenset(caps)
    return acl
