"""ACL policy engine (reference acl/ package + nomad/acl.go).

Copied from ``nomad_tpu/acl/__init__.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from .acl import (
    ACL,
    HostVolumePolicy,
    NamespacePolicy,
    Policy,
    management_acl,
    new_acl,
    parse_policy,
)
from .resolver import ACLResolver, PermissionDenied, TokenError

__all__ = [
    "ACL",
    "ACLResolver",
    "HostVolumePolicy",
    "NamespacePolicy",
    "PermissionDenied",
    "Policy",
    "TokenError",
    "management_acl",
    "new_acl",
    "parse_policy",
]
