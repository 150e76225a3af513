"""ACL data model (reference nomad/structs/structs.go ACLPolicy:~9100,
ACLToken, and nomad/structs/structs.go anonymous/bootstrap token handling).

Copied from ``nomad_tpu/structs/acl.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import List

from .structs import generate_uuid

ACL_TOKEN_TYPE_CLIENT = "client"
ACL_TOKEN_TYPE_MANAGEMENT = "management"

#: The implicit token used when no secret is presented (structs.go
#: AnonymousACLToken).
ANONYMOUS_ACCESSOR = "anonymous"


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""
    create_index: int = 0
    modify_index: int = 0

    def validate(self) -> List[str]:
        errors = []
        if not self.name or len(self.name) > 128:
            errors.append("invalid policy name")
        return errors


@dataclass
class ACLToken:
    accessor_id: str = field(default_factory=generate_uuid)
    secret_id: str = field(default_factory=generate_uuid)
    name: str = ""
    type: str = ACL_TOKEN_TYPE_CLIENT
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_time_ns: int = field(default_factory=lambda: time.time_ns())
    create_index: int = 0
    modify_index: int = 0

    def is_management(self) -> bool:
        return self.type == ACL_TOKEN_TYPE_MANAGEMENT

    def validate(self) -> List[str]:
        errors = []
        if self.type not in (ACL_TOKEN_TYPE_CLIENT, ACL_TOKEN_TYPE_MANAGEMENT):
            errors.append(f"invalid token type {self.type!r}")
        if self.type == ACL_TOKEN_TYPE_CLIENT and not self.policies:
            errors.append("client token missing policies")
        if self.type == ACL_TOKEN_TYPE_MANAGEMENT and self.policies:
            errors.append("management token cannot be assigned policies")
        return errors

    def public_stub(self) -> "ACLToken":
        """Copy without the secret (listing endpoints never leak secrets)."""
        return ACLToken(
            accessor_id=self.accessor_id,
            secret_id="",
            name=self.name,
            type=self.type,
            policies=list(self.policies),
            global_=self.global_,
            create_time_ns=self.create_time_ns,
            create_index=self.create_index,
            modify_index=self.modify_index,
        )


def anonymous_token() -> ACLToken:
    return ACLToken(
        accessor_id=ANONYMOUS_ACCESSOR,
        secret_id="",
        name="Anonymous Token",
        type=ACL_TOKEN_TYPE_CLIENT,
        policies=["anonymous"],
    )


def bootstrap_token() -> ACLToken:
    return ACLToken(
        name="Bootstrap Token",
        type=ACL_TOKEN_TYPE_MANAGEMENT,
        global_=True,
        secret_id=secrets.token_hex(16),
    )
