"""RPC layer (reference nomad/rpc.go + helper/pool): msgpack over TCP with
typed-struct codec, leader forwarding, and the endpoint registry.

Copied from ``nomad_tpu/rpc/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``; the msgpack bytes come from the port's
own ``wirefmt``.
"""
from .codec import decode, encode, register_struct
from .endpoints import RemoteServerProxy, bind_server
from .transport import RPCClient, RPCError, RPCServer

__all__ = [
    "RPCClient",
    "RPCError",
    "RPCServer",
    "RemoteServerProxy",
    "bind_server",
    "decode",
    "encode",
    "register_struct",
]
