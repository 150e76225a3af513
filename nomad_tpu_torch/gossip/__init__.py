"""Gossip membership (the serf/memberlist slot).

Fills the role of the reference's vendored hashicorp/serf + memberlist
(nomad/serf.go, nomad/server.go:1250 setupSerf): SWIM-style failure
detection and metadata dissemination over UDP, feeding server peer
reconciliation and cross-region federation.

Copied from ``nomad_tpu/gossip/__init__.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from .memberlist import Member, Memberlist, MemberlistConfig

__all__ = ["Member", "Memberlist", "MemberlistConfig"]
