"""RPC layer (reference nomad/rpc.go + helper/pool), trimmed to the codec
and the transport: msgpack over TCP with a typed-struct codec, leader
forwarding, and the per-method RPC stats table the churn replay reads.
The endpoint registry (``endpoints.py``: ``RemoteServerProxy``,
``bind_server``) is not ported yet.

Trimmed copy of ``nomad_tpu/rpc/__init__.py``.
"""
from .codec import decode, encode, register_struct
from .transport import RPCClient, RPCError, RPCServer

__all__ = [
    "RPCClient",
    "RPCError",
    "RPCServer",
    "decode",
    "encode",
    "register_struct",
]
