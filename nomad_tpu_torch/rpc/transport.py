"""TCP RPC transport: length-framed msgpack request/response.

Fills the role of reference ``nomad/rpc.go`` + ``helper/pool/``: msgpack
net/rpc over TCP with connection reuse and leader forwarding
(rpc.go:409 ``forward`` / :493 forwardLeader). Framing is
[u32 length][msgpack envelope]; the envelope is
{"seq", "method", "body"[, "trace"]} out and {"seq", "error", "body"}
back — ``trace`` is the distributed-tracing context (codec.TRACE_KEY,
trace/context.py). One server thread per connection (yamux multiplexing
is unnecessary when each connection already pipelines request/response
pairs).

Telemetry (the reference exports yamux/raft RPC metrics via go-metrics;
here the transport itself is the choke point): every dispatched method
records latency into a log-bucketed histogram plus error /
``NotLeaderError`` counters and request/response frame bytes, under the
``nomad.rpc.<method>.*`` family and in a module-level per-method table
(:func:`rpc_stats`) that the ``Trace.Export`` RPC and the flight
recorder's ``rpc`` probe read. Client calls open a ``client`` span and
inject the ambient TraceContext; the server opens a child ``server``
span around dispatch, so a forwarded write shows up as
client → server(follower) → client(forward) → server(leader) in the
stitched trace.

Copied from ``nomad_tpu/rpc/transport.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``; its logger is
``nomad_tpu_torch.rpc.server``, and ``RPCServer`` forwards to the leader
over a pool of connections (``_forward_idle``, under ``_forward_lock``),
one per concurrent forward: an ``RPCClient`` answers one call at a time,
and the reference's single forwarding connection queued every write a
follower relays behind the one in flight (Nomad multiplexes them on one
session).
"""
from __future__ import annotations

import logging
import random
import socket
import socketserver
import ssl
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..trace import context as xtrace
from ..utils import metric_names, metrics
from ..utils.lock_witness import module_witness_lock
from ..utils.race_witness import tracked_dict
from ..utils.metrics import LogHistogram
from .codec import TRACE_KEY, decode, encode

_LEN = struct.Struct(">I")
MAX_FRAME = 256 << 20


class RPCError(Exception):
    pass


class FrameError(ConnectionError):
    """A frame-level failure (short read, dropped send) tagged with the
    method, peer address and bytes transferred — a ``ConnectionError``
    subclass so every retry/failover path that handles peer death keeps
    working, but a chaos-run log line now says WHICH call to WHOM died
    mid-frame instead of a bare "peer closed"."""


# -- per-method server telemetry -------------------------------------------


class _MethodStats:
    __slots__ = ("calls", "errors", "not_leader", "req_bytes",
                 "resp_bytes", "hist")

    def __init__(self) -> None:
        self.calls = 0
        self.errors = 0
        self.not_leader = 0
        self.req_bytes = 0
        self.resp_bytes = 0
        self.hist = LogHistogram()

    def row(self, wire: bool = False) -> Dict[str, object]:
        out: Dict[str, object] = {
            "calls": self.calls,
            "errors": self.errors,
            "not_leader": self.not_leader,
            "req_bytes": self.req_bytes,
            "resp_bytes": self.resp_bytes,
            "latency_ms_p50": self.hist.percentile(0.50),
            "latency_ms_p95": self.hist.percentile(0.95),
            "latency_ms_p99": self.hist.percentile(0.99),
        }
        if wire:
            # mergeable across replicas: elementwise bucket addition
            out["latency_hist"] = self.hist.to_wire()
        return out


_rpc_lock = module_witness_lock("rpc.transport._rpc_lock")
_rpc_stats: Dict[str, _MethodStats] = tracked_dict("transport._rpc_stats", {})
_rpc_inflight = 0


def _record_dispatch(method: str, elapsed_s: float,
                     error: Optional[str]) -> None:
    ms = elapsed_s * 1000.0
    not_leader = bool(error) and error.startswith("NotLeaderError")
    with _rpc_lock:
        st = _rpc_stats.setdefault(method, _MethodStats())
        st.calls += 1
        st.hist.add(ms)
        if error:
            st.errors += 1
        if not_leader:
            st.not_leader += 1
    # the method set is bounded by the bind_server registry (unknown
    # methods never reach here), so these dynamic names stay bounded
    metric_names.family_sample("nomad.rpc", f"{method}.latency_ms", ms)
    if error:
        metric_names.family_counter("nomad.rpc", f"{method}.errors")
    if not_leader:
        metric_names.family_counter("nomad.rpc", f"{method}.not_leader")


def _record_frame_bytes(method: str, req_bytes: int, resp_bytes: int) -> None:
    with _rpc_lock:
        st = _rpc_stats.setdefault(method, _MethodStats())
        st.req_bytes += req_bytes
        st.resp_bytes += resp_bytes
    metric_names.family_sample("nomad.rpc", f"{method}.req_bytes", req_bytes)
    metric_names.family_sample("nomad.rpc", f"{method}.resp_bytes", resp_bytes)


def rpc_stats(wire: bool = False) -> Dict[str, Dict[str, object]]:
    """Per-method table for this process: counts, byte totals, latency
    percentiles (``wire=True`` adds the raw histogram buckets so a
    collector can merge tables across replicas)."""
    with _rpc_lock:
        items = list(_rpc_stats.items())
    return {m: st.row(wire) for m, st in sorted(items)}


def rpc_stats_brief() -> Dict[str, object]:
    """Cheap flight-recorder probe: totals only, no percentile walks."""
    with _rpc_lock:
        return {
            "methods": len(_rpc_stats),
            "inflight": _rpc_inflight,
            "calls": sum(st.calls for st in _rpc_stats.values()),
            "errors": sum(st.errors for st in _rpc_stats.values()),
            "not_leader": sum(st.not_leader for st in _rpc_stats.values()),
        }


def reset_rpc_stats() -> None:
    # re-mint through the factory so a race witness armed after import
    # still gets a tracked table (the import-time one predates arming)
    global _rpc_stats, _rpc_inflight
    with _rpc_lock:
        _rpc_stats = tracked_dict("transport._rpc_stats", {})
        _rpc_inflight = 0


def merge_rpc_tables(
    tables: Iterable[Dict[str, Dict[str, object]]],
) -> Dict[str, Dict[str, object]]:
    """Merge wire-form per-method tables (``rpc_stats(wire=True)``) from
    N replicas into one cluster table: counters add, histogram buckets
    add elementwise, and the percentiles are recomputed from the MERGED
    histogram — not averaged, so a single slow replica still moves the
    cluster p99."""
    merged: Dict[str, _MethodStats] = {}
    for table in tables:
        for method, row in (table or {}).items():
            st = merged.setdefault(method, _MethodStats())
            st.calls += int(row.get("calls", 0))
            st.errors += int(row.get("errors", 0))
            st.not_leader += int(row.get("not_leader", 0))
            st.req_bytes += int(row.get("req_bytes", 0))
            st.resp_bytes += int(row.get("resp_bytes", 0))
            counts = row.get("latency_hist")
            if counts:
                st.hist.merge(LogHistogram(counts))
    return {m: st.row() for m, st in sorted(merged.items())}


class TLSConfig:
    """Mutual-TLS material (reference helper/tlsutil + agent tls stanza):
    one CA, one cert+key per agent, client certs required on both sides.

    When ``server_name`` is set (e.g. ``server.<region>.nomad``) and
    ``verify_server_hostname`` is true, RPC clients verify the server's
    certificate SAN against that pinned name — so a mere cluster-CA cert
    holder (a client agent's cert) cannot impersonate a server
    (the reference's ``verify_server_hostname`` role pinning). Pass
    ``verify_server_hostname=False`` to opt out (the
    ``api.Config.tls_skip_verify`` posture)."""

    def __init__(self, ca_file: str, cert_file: str, key_file: str,
                 verify: bool = True, server_name: str = "",
                 verify_server_hostname: bool = True) -> None:
        self.ca_file = ca_file
        self.cert_file = cert_file
        self.key_file = key_file
        self.verify = verify
        self.server_name = server_name
        self.verify_server_hostname = verify_server_hostname
        self._server_ctx: Optional[ssl.SSLContext] = None
        self._client_ctx: Optional[ssl.SSLContext] = None
        self._http_client_ctx: Optional[ssl.SSLContext] = None
        self._ctx_lock = threading.Lock()

    @property
    def pin_server_name(self) -> bool:
        return bool(self.server_name) and self.verify_server_hostname and self.verify

    def server_context(self) -> ssl.SSLContext:
        # built once and shared: SSLContext is designed for reuse, and the
        # per-connection path must not re-read key material from disk
        with self._ctx_lock:
            if self._server_ctx is None:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(self.cert_file, self.key_file)
                ctx.load_verify_locations(self.ca_file)
                if self.verify:
                    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
                self._server_ctx = ctx
            return self._server_ctx

    def _build_client_ctx(self, check_hostname: bool) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.check_hostname = check_hostname
        ctx.verify_mode = ssl.CERT_REQUIRED if self.verify else ssl.CERT_NONE
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Context for the RPC plane: pins the server SAN when
        ``server_name`` is configured (dial with
        ``server_hostname=self.server_name``, not the peer address)."""
        with self._ctx_lock:
            if self._client_ctx is None:
                self._client_ctx = self._build_client_ctx(self.pin_server_name)
            return self._client_ctx

    def http_client_context(self) -> ssl.SSLContext:
        """Context for intra-cluster HTTPS (log fetch, ephemeral-disk
        migration): peers are client agents at dynamic addresses whose
        certs carry role names, not IPs — certificate chain is still
        verified against the cluster CA, hostname is not."""
        with self._ctx_lock:
            if self._http_client_ctx is None:
                self._http_client_ctx = self._build_client_ctx(False)
            return self._http_client_ctx


def _read_exact(sock: socket.socket, n: int, peer: str = "",
                what: str = "") -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise FrameError(
                f"peer {peer or '?'} closed after {len(buf)}/{n} bytes"
                f"{f' reading {what}' if what else ''}"
            )
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, payload: bytes, peer: str = "",
                method: str = "") -> None:
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except ConnectionError as e:
        raise FrameError(
            f"send of {len(payload)}B frame"
            f"{f' for {method}' if method else ''} to peer {peer or '?'} "
            f"failed: {e}"
        ) from e


def _recv_frame(sock: socket.socket, peer: str = "", method: str = "") -> bytes:
    what = f"{method} response" if method else "frame"
    (length,) = _LEN.unpack(_read_exact(sock, 4, peer, f"{what} header"))
    if length > MAX_FRAME:
        raise RPCError(
            f"frame too large: {length} "
            f"({what} from peer {peer or '?'})"
        )
    return _read_exact(sock, length, peer, f"{length}B {what}")


def request_envelope(seq: int, method: str, args: tuple, *,
                     no_forward: bool = False, region: Optional[str] = None,
                     stale: bool = False) -> Dict[str, Any]:
    """The request envelope ``RPCClient.call`` sends: ``seq``, ``method``,
    ``body`` and the optional flags, with the caller's active trace
    context (``xtrace.inject()``) under ``TRACE_KEY`` so the server's
    handler span joins the caller's trace."""
    req: Dict[str, Any] = {"seq": seq, "method": method, "body": tuple(args)}
    if no_forward:
        req["no_forward"] = True
    if region:
        req["region"] = region
    if stale:
        req["stale"] = True
    tctx = xtrace.inject()
    if tctx is not None:
        req[TRACE_KEY] = tctx
    return req


def request_frame(seq: int, method: str, *args: Any,
                  stale: bool = False) -> bytes:
    """One whole length-prefixed request frame (``request_envelope``,
    encoded), for a caller that writes its own non-blocking socket."""
    payload = encode(request_envelope(seq, method, args, stale=stale))
    return _LEN.pack(len(payload)) + payload


class RPCServer:
    """Dispatches "Noun.Verb" methods to registered handlers."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        region: str = "global",
        tls: Optional["TLSConfig"] = None,
    ) -> None:
        self.logger = logging.getLogger("nomad_tpu_torch.rpc.server")
        self.tls = tls
        self.handlers: Dict[str, Callable[..., Any]] = {}
        # set to (host, port) of the leader for transparent forwarding
        self.leader_addr: Optional[Tuple[str, int]] = None
        self.is_leader: Callable[[], bool] = lambda: True
        # idle connections to the leader, one taken per forward in flight
        self._forward_idle: List["RPCClient"] = []
        self._forward_lock = threading.Lock()
        # cross-region federation (rpc.go:502 forwardRegion): resolves a
        # region name to that region's server RPC addrs, fed by gossip
        self.region = region
        self.region_servers: Optional[Callable[[str], list]] = None
        self._region_pools: Dict[Tuple[str, int], "RPCClient"] = {}
        self._region_pools_lock = threading.Lock()

        outer = self
        self._active_conns: set = set()
        self._active_lock = threading.Lock()
        self._stopping = False

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if outer.tls is not None:
                    try:
                        sock = outer.tls.server_context().wrap_socket(
                            sock, server_side=True
                        )
                    except (OSError, ssl.SSLError) as e:
                        outer.logger.debug("TLS handshake failed: %s", e)
                        return
                with outer._active_lock:
                    if outer._stopping:
                        # raced a stop(): close instead of serving — a
                        # dead server must not keep answering
                        try:
                            sock.close()
                        except OSError:
                            pass
                        return
                    outer._active_conns.add(sock)
                peer = "%s:%s" % self.client_address[:2]
                try:
                    while True:
                        frame = _recv_frame(sock, peer)
                        req = decode(frame)
                        resp = outer._dispatch(req)
                        out = encode(resp)
                        method = req.get("method", "")
                        if method in outer.handlers:
                            _record_frame_bytes(method, len(frame), len(out))
                        _send_frame(sock, out, peer, method)
                except (ConnectionError, OSError, ssl.SSLError):
                    pass
                finally:
                    with outer._active_lock:
                        outer._active_conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            # the watch serving bench parks thousands of persistent
            # watcher connections that dial in bursts; socketserver's
            # default backlog of 5 turns that storm into SYN drops and
            # client-side connect timeouts (kernel caps by somaxconn)
            request_queue_size = 1024

            def handle_error(self, request, client_address):
                # peer-side tear-downs stay quiet; anything else reaching
                # here escaped the handler's own guards and is a genuine
                # server bug — keep its full traceback, just via logging
                import ssl as ssl_mod
                import sys

                exc = sys.exc_info()[1]
                if isinstance(exc, (ConnectionError, ssl_mod.SSLError,
                                    TimeoutError, BrokenPipeError)):
                    outer.logger.debug(
                        "connection from %s dropped: %s", client_address, exc
                    )
                else:
                    outer.logger.warning(
                        "request from %s crashed", client_address,
                        exc_info=True,
                    )

        self._tcp = Server((host, port), Handler)
        self.addr: Tuple[str, int] = self._tcp.server_address
        self._thread: Optional[threading.Thread] = None

    def register(self, method: str, fn: Callable[..., Any]) -> None:
        self.handlers[method] = fn  # race-ok: endpoints register before serve() accepts connections

    def register_endpoint(self, noun: str, obj: object) -> None:
        """Every public method of ``obj`` becomes "<noun>.<method>"
        (the reference's endpoint struct registry, server.go:236)."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            fn = getattr(obj, name)
            if callable(fn):
                self.register(f"{noun}.{name}", fn)

    FORWARDED = "forwarded"
    LOCAL_ONLY = {"Status.ping", "Status.leader"}

    def _dispatch(self, req: dict) -> dict:
        seq = req.get("seq", 0)
        method = req.get("method", "")
        body = req.get("body", ())
        fn = self.handlers.get(method)
        if fn is None:
            # unregistered methods are NOT recorded: the per-method stats
            # table must stay bounded by the bind_server registry, not by
            # whatever strings a hostile peer mints
            return {"seq": seq, "error": f"unknown method {method!r}", "body": None}
        global _rpc_inflight
        with _rpc_lock:
            _rpc_inflight += 1
            inflight = _rpc_inflight
        metrics.set_gauge("nomad.rpc.inflight", inflight)
        t0 = time.monotonic()
        # re-enter the caller's trace: the server span is a child of the
        # client span that crossed the wire, so a forwarded write nests
        # client -> server(follower) -> client(forward) -> server(leader)
        token = xtrace.activate(req.get(TRACE_KEY))
        resp: dict
        try:
            with xtrace.span(f"rpc.server.{method}", kind="server",
                             attrs={"method": method}) as sattrs:
                try:
                    # region forwarding (rpc.go:502 forwardRegion): a
                    # request naming another region hops to any server
                    # there, which then applies its own leader forwarding
                    req_region = req.get("region")
                    if req_region and req_region != self.region:
                        result = self._forward_region(req_region, method, body)
                    # leader forwarding (rpc.go:409): followers proxy writes.
                    # "stale" is the allowStale read flag: the follower
                    # answers from its own FSM instead of forwarding, and
                    # the endpoint stamps measured follower_lag into
                    # QueryMeta (watch/stale.py)
                    elif (
                        not self.is_leader()
                        and self.leader_addr is not None
                        and self.leader_addr != self.addr
                        and method not in self.LOCAL_ONLY
                        and not req.get("no_forward")
                        and not req.get("stale")
                    ):
                        sattrs["forwarded"] = True
                        result = self._forward(method, body)
                    else:
                        if req.get("stale") and not self.is_leader():
                            sattrs["stale"] = True
                        result = fn(*body)
                    resp = {"seq": seq, "error": None, "body": result}
                except Exception as e:  # noqa: BLE001
                    sattrs["error"] = type(e).__name__
                    resp = {"seq": seq, "error": f"{type(e).__name__}: {e}",
                            "body": None}
        finally:
            xtrace.deactivate(token)
            with _rpc_lock:
                _rpc_inflight -= 1
                inflight = _rpc_inflight
            metrics.set_gauge("nomad.rpc.inflight", inflight)
        _record_dispatch(method, time.monotonic() - t0, resp["error"])
        return resp

    def _forward(self, method: str, body) -> Any:
        # connection threads forward concurrently, each on a connection
        # of its own: idle ones to the current leader are reused, ones to
        # a former leader closed
        addr = self.leader_addr
        stale = []
        with self._forward_lock:
            client = None
            while self._forward_idle:
                c = self._forward_idle.pop()
                if c.addr == addr:
                    client = c
                    break
                stale.append(c)
        for c in stale:
            c.close()
        if client is None:
            client = RPCClient(*addr, tls=self.tls)
        try:
            return client.call(method, *body, no_forward=True)
        finally:
            with self._forward_lock:
                self._forward_idle.append(client)

    def _forward_region(self, region: str, method: str, body) -> Any:
        servers = self.region_servers(region) if self.region_servers else []
        if not servers:
            raise RPCError(f"no path to region {region!r}")
        addr = tuple(random.choice(servers))
        with self._region_pools_lock:
            pool = self._region_pools.get(addr)
            if pool is None:
                pool = self._region_pools[addr] = RPCClient(*addr, tls=self.tls)
        # keep the region tag: the remote sees its own region and serves it
        return pool.call(method, *body, region=region)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="rpc-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        # a stopped server must stop ANSWERING, not just accepting: close
        # established connections too, or clients pinned to a dead server
        # never observe the death (and never fail over)
        with self._active_lock:
            self._stopping = True
            conns = list(self._active_conns)
            self._active_conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        with self._forward_lock:
            idle, self._forward_idle = self._forward_idle, []
        for c in idle:
            c.close()
        with self._region_pools_lock:
            pools = list(self._region_pools.values())
            self._region_pools.clear()
        for pool in pools:
            pool.close()


class RPCClient:
    """Pooled client: one persistent connection, serialized calls
    (helper/pool ConnPool's role for a single peer)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 tls: Optional[TLSConfig] = None) -> None:
        self.addr = (host, port)
        self.timeout = timeout
        self.tls = tls
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._seq = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.tls is not None:
                sni = (
                    self.tls.server_name
                    if self.tls.pin_server_name
                    else self.addr[0]
                )
                s = self.tls.client_context().wrap_socket(
                    s, server_hostname=sni
                )
            self._sock = s
        return self._sock

    def call(
        self,
        method: str,
        *args: Any,
        no_forward: bool = False,
        region: Optional[str] = None,
        timeout: Optional[float] = None,
        no_retry: bool = False,
        stale: bool = False,
    ) -> Any:
        """``timeout`` overrides the connection timeout for this call;
        ``no_retry`` disables the reconnect-resend (required for
        non-idempotent calls like Plan.Submit, where a resend would
        enqueue the work twice); ``stale`` marks an allowStale read the
        receiving replica serves locally instead of leader-forwarding
        (older peers ignore the unknown envelope field and forward as
        before — wire-compatible)."""
        peer = f"{self.addr[0]}:{self.addr[1]}"
        # the outbound span is opened BEFORE the envelope is built so
        # inject() carries this span's id: the server's handler span
        # becomes its child and the stitcher can pair the two to
        # estimate the clock offset between the processes
        with xtrace.span(f"rpc.client.{method}", kind="client",
                         attrs={"method": method, "peer": peer}) as attrs:
            with self._lock:
                self._seq += 1
                req = request_envelope(self._seq, method, args,
                                       no_forward=no_forward, region=region,
                                       stale=stale)
                payload = encode(req)
                attrs["req_bytes"] = len(payload)
                try:
                    sock = self._connect()
                    if timeout is not None:
                        sock.settimeout(timeout)
                    try:
                        _send_frame(sock, payload, peer, method)
                        frame = _recv_frame(sock, peer, method)
                    finally:
                        if timeout is not None:
                            sock.settimeout(self.timeout)
                except (ConnectionError, OSError):
                    self._close_locked()
                    if no_retry:
                        raise
                    # one reconnect attempt (pool behavior on dead conns)
                    attrs["reconnected"] = True
                    sock = self._connect()
                    if timeout is not None:
                        sock.settimeout(timeout)
                    try:
                        _send_frame(sock, payload, peer, method)
                        frame = _recv_frame(sock, peer, method)
                    except (ConnectionError, OSError):
                        # a retry that dies mid-exchange leaves a request
                        # outstanding on this socket; keeping it would let
                        # the late response answer the NEXT call
                        self._close_locked()
                        raise
                    finally:
                        if timeout is not None:
                            try:
                                sock.settimeout(self.timeout)
                            except OSError:
                                pass
                attrs["resp_bytes"] = len(frame)
                resp = decode(frame)
                if resp.get("seq") != req["seq"]:
                    # late response from an abandoned exchange (e.g. a
                    # timeout that didn't tear the connection down) — it
                    # belongs to a PREVIOUS request, and every frame after
                    # it is off by one: poison, drop the connection
                    self._close_locked()
                    raise RPCError(
                        f"response seq mismatch for {method}: got "
                        f"{resp.get('seq')!r}, expected {req['seq']}"
                    )
            if resp.get("error"):
                raise RPCError(resp["error"])
            return resp.get("body")

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()


class LeaderConn:
    """Thread-safe cache of one RPCClient keyed on the (changing) leader
    address: get() reconnects when the address moves, close() tears down.
    Shared by everything that follows the leader (follower workers, the
    colocated-client failover proxy, RPC write forwarding)."""

    def __init__(self, timeout: float = 30.0,
                 tls: Optional[TLSConfig] = None) -> None:
        self.timeout = timeout
        self.tls = tls
        self._lock = threading.Lock()
        self._client: Optional[RPCClient] = None

    def get(self, addr) -> RPCClient:
        addr = tuple(addr)
        with self._lock:
            if self._client is not None and self._client.addr != addr:
                self._client.close()
                self._client = None
            if self._client is None:
                self._client = RPCClient(*addr, timeout=self.timeout, tls=self.tls)
            return self._client

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                self._client.close()
                self._client = None
