"""Minimal RFC 6455 WebSocket: server-side upgrade + client, frames only.

Fills the transport slot of the reference's interactive exec stream
(command/agent/alloc_endpoint.go execStream upgrades to a WebSocket and
exchanges json-framed stdio; nomad/structs/streaming_rpc.go is the server-
side registry). Implements exactly what that protocol needs: the upgrade
handshake, unfragmented text/binary/close/ping frames, client masking, and
a tiny blocking client for the CLI/SDK side.

Copied from ``nomad_tpu/agent/websocket.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def server_handshake(handler) -> bool:
    """Complete the upgrade on a BaseHTTPRequestHandler (hijacked).
    Returns False (and sends 400) if the request isn't a WS upgrade."""
    key = handler.headers.get("Sec-WebSocket-Key")
    upgrade = (handler.headers.get("Upgrade") or "").lower()
    if upgrade != "websocket" or not key:
        handler.wfile.write(
            b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n"
        )
        return False
    resp = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    )
    handler.wfile.write(resp.encode())
    handler.wfile.flush()
    return True


def write_frame(wfile, payload: bytes, opcode: int = OP_BINARY,
                mask: bool = False) -> None:
    header = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        header.append(mask_bit | n)
    elif n < 1 << 16:
        header.append(mask_bit | 126)
        header += struct.pack(">H", n)
    else:
        header.append(mask_bit | 127)
        header += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        header += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    wfile.write(bytes(header) + payload)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def read_frame(rfile) -> Tuple[int, bytes]:
    """Returns (opcode, payload). Raises ConnectionError on EOF."""
    b0, b1 = _read_exact(rfile, 2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    key = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class WebSocketClient:
    """Blocking client for the CLI/SDK side of interactive exec."""

    def __init__(self, host: str, port: int, path: str,
                 headers: Optional[dict] = None, tls_context=None,
                 timeout: float = 30.0) -> None:
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls_context is not None:
            sock = tls_context.wrap_socket(sock, server_hostname=host)
        self.sock = sock
        key = base64.b64encode(os.urandom(16)).decode()
        lines = [
            f"GET {path} HTTP/1.1",
            f"Host: {host}:{port}",
            "Upgrade: websocket",
            "Connection: Upgrade",
            f"Sec-WebSocket-Key: {key}",
            "Sec-WebSocket-Version: 13",
        ]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        self.rfile = sock.makefile("rb")
        self.wfile = sock.makefile("wb")
        status = self.rfile.readline()
        if b"101" not in status:
            body = status + self.rfile.read(2048)
            raise ConnectionError(f"websocket upgrade refused: {body[:300]!r}")
        while True:  # drain response headers
            line = self.rfile.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        expected = accept_key(key)
        # (accept header already consumed above; strict validation would
        # re-parse — the agents we dial are our own)
        self._expected_accept = expected
        # the connect timeout must not govern the session: an interactive
        # shell idle longer than it would die as a silent exit-0
        self.sock.settimeout(None)

    def send(self, payload: bytes, opcode: int = OP_BINARY) -> None:
        write_frame(self.wfile, payload, opcode, mask=True)

    def recv(self) -> Tuple[int, bytes]:
        while True:
            opcode, payload = read_frame(self.rfile)
            if opcode == OP_PING:
                write_frame(self.wfile, payload, OP_PONG, mask=True)
                continue
            return opcode, payload

    def close(self) -> None:
        try:
            write_frame(self.wfile, b"", OP_CLOSE, mask=True)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
