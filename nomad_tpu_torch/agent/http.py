"""HTTP transport for the /v1 API.

Fills the role of the reference's ``command/agent/http.go``: a mux of
prefix-registered handlers (registerHandlers :150–224) behind a ``wrap``
that does JSON encoding, blocking-query parameters (index/wait), the
pretty flag, the ACL token header, and the X-Nomad-Index response
headers. Built on the stdlib threading HTTP server — one thread per
in-flight request, which is what blocking queries need.

Copied from ``nomad_tpu/agent/http.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Change: the handler's logger is
``nomad_tpu_torch.http``.
"""
from __future__ import annotations

import json
import re
import threading
import traceback
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import jsonapi


class HTTPError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code
        self.message = message


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DUR_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(s: str) -> float:
    """Go-style duration string ("5s", "1m30s", "150ms") -> seconds."""
    if not s:
        return 0.0
    try:
        return float(s)  # bare number = seconds
    except ValueError:
        pass
    total, pos = 0.0, 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise HTTPError(400, f"invalid duration {s!r}")
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise HTTPError(400, f"invalid duration {s!r}")
    return total


@dataclass
class QueryOptions:
    """Parsed blocking-query / common request params (api QueryOptions)."""

    min_index: int = 0
    wait: float = 0.0
    namespace: str = "default"
    region: str = ""
    prefix: str = ""
    auth_token: str = ""
    stale: bool = False


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, List[str]]
    body: bytes
    headers: Dict[str, str]
    options: QueryOptions = field(default_factory=QueryOptions)
    # handlers set this to stamp X-Nomad-Index
    response_index: Optional[int] = None
    # handlers returning bytes may override the content type (UI assets)
    response_content_type: Optional[str] = None

    def param(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self, cls=None):
        try:
            return jsonapi.loads(cls, self.body.decode("utf-8") if self.body else "")
        except (ValueError, TypeError) as e:
            raise HTTPError(400, f"bad request body: {e}")


Handler = Callable[[Request], Any]


class StreamingResponse:
    """Handler return value that streams chunks to the client
    (Transfer-Encoding: chunked) — the HTTP realization of the
    reference's streaming RPC frames (structs/streaming_rpc.go,
    command/agent/http.go:187). ``gen`` yields bytes; the stream ends
    when it returns or the client disconnects."""

    def __init__(self, gen, content_type: str = "application/octet-stream") -> None:
        self.gen = gen
        self.content_type = content_type


class Hijacker:
    """Handler return value that takes over the raw connection (the
    reference's WebSocket upgrade path for interactive exec,
    alloc_endpoint.go execStream). ``fn`` receives the
    BaseHTTPRequestHandler; it owns the socket afterwards."""

    def __init__(self, fn) -> None:
        self.fn = fn


class HTTPServer:
    """Prefix-matching mux + JSON wrap, mirroring http.go's mux semantics."""

    def __init__(self, bind: str = "127.0.0.1", port: int = 0,
                 tls=None) -> None:
        self._routes: List[Tuple[str, Handler]] = []
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bind = bind
        self._port = port
        self.tls = tls  # rpc.transport.TLSConfig: serve HTTPS with mTLS

    def register(self, prefix: str, handler: Handler) -> None:
        self._routes.append((prefix, handler))
        # longest prefix wins, like Go's ServeMux
        self._routes.sort(key=lambda r: len(r[0]), reverse=True)

    def lookup(self, path: str) -> Optional[Handler]:
        for prefix, handler in self._routes:
            if prefix.endswith("/"):
                if path.startswith(prefix) or path == prefix[:-1]:
                    return handler
            elif path == prefix:
                return handler
        return None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        mux = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _handle(self):
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path
                query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req = Request(
                    method=self.command,
                    path=path,
                    query=query,
                    body=body,
                    headers={k: v for k, v in self.headers.items()},
                )
                opts = req.options
                if "index" in query:
                    try:
                        opts.min_index = int(query["index"][0])
                    except ValueError:
                        return self._send_err(400, "invalid index")
                if "wait" in query:
                    try:
                        opts.wait = parse_duration(query["wait"][0])
                    except HTTPError as e:
                        return self._send_err(e.code, e.message)
                opts.namespace = req.param("namespace", "default")
                opts.region = req.param("region", "")
                opts.prefix = req.param("prefix", "")
                opts.stale = "stale" in query
                opts.auth_token = (
                    self.headers.get("X-Nomad-Token") or req.param("token", "")
                )

                handler = mux.lookup(path)
                if handler is None:
                    return self._send_err(404, f"no handler for {path}")
                try:
                    result = handler(req)
                except HTTPError as e:
                    return self._send_err(e.code, e.message)
                except PermissionError as e:
                    return self._send_err(403, str(e) or "Permission denied")
                except KeyError as e:
                    return self._send_err(404, str(e))
                except Exception as e:  # 500 with message, like wrap()
                    traceback.print_exc()
                    return self._send_err(500, f"{type(e).__name__}: {e}")
                if isinstance(result, Hijacker):
                    self.close_connection = True
                    result.fn(self)
                    return
                if isinstance(result, StreamingResponse):
                    return self._send_stream(result, req)
                self._send_json(result, req)

            def _send_stream(self, stream: "StreamingResponse", req: Request):
                self.send_response(200)
                self.send_header("Content-Type", stream.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                if req.response_index is not None:
                    self.send_header("X-Nomad-Index", str(req.response_index))
                self.end_headers()
                self.close_connection = True
                try:
                    for chunk in stream.gen:
                        if not chunk:
                            continue
                        self.wfile.write(b"%x\r\n" % len(chunk))
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away — generator GC closes sources
                finally:
                    close = getattr(stream.gen, "close", None)
                    if close is not None:
                        close()

            def _send_json(self, obj, req: Request):
                if isinstance(obj, bytes):
                    payload = obj
                    ctype = req.response_content_type or "application/octet-stream"
                else:
                    pretty = "pretty" in req.query
                    payload = jsonapi.dumps(obj, pretty=pretty).encode("utf-8")
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                if req.response_index is not None:
                    self.send_header("X-Nomad-Index", str(req.response_index))
                    self.send_header("X-Nomad-KnownLeader", "true")
                    self.send_header("X-Nomad-LastContact", "0")
                self.end_headers()
                self.wfile.write(payload)

            def _send_err(self, code: int, message: str):
                payload = message.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = _handle
            do_POST = _handle
            do_PUT = _handle
            do_DELETE = _handle

        tls_cfg = self.tls

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                # disconnects mid-stream (follow-mode consumers hitting
                # Ctrl-C) are peer-side events; anything else escaped the
                # route wrapper and keeps its traceback via logging
                import logging as logging_mod
                import sys as sys_mod

                exc = sys_mod.exc_info()[1]
                log = logging_mod.getLogger("nomad_tpu_torch.http")
                if isinstance(exc, (ConnectionError, TimeoutError,
                                    BrokenPipeError)):
                    log.debug("connection from %s dropped: %s",
                              client_address, exc)
                else:
                    log.warning("request from %s crashed", client_address,
                                exc_info=True)

            def finish_request(self, request, client_address):
                # handshake in the per-connection thread: wrapping the
                # LISTENER would run handshakes in the accept loop, where
                # one stalled client freezes the whole API
                if tls_cfg is not None:
                    import ssl as ssl_mod

                    try:
                        request.settimeout(30)
                        request = tls_cfg.server_context().wrap_socket(
                            request, server_side=True
                        )
                        request.settimeout(None)
                    except (OSError, ssl_mod.SSLError):
                        try:
                            request.close()
                        except OSError:
                            pass
                        return
                super().finish_request(request, client_address)

        self._server = _Server((self._bind, self._port), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="http", daemon=True
        )
        self._thread.start()

    @property
    def addr(self) -> Tuple[str, int]:
        assert self._server is not None
        return self._server.server_address[:2]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
