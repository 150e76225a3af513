"""Alloc filesystem + logs HTTP endpoints.

Fills the role of reference ``client/fs_endpoint.go`` (FileSystem.List/
Stat/Stream/Logs) + ``command/agent/fs_endpoint.go`` (/v1/client/fs/*)
+ the server→client proxy (``nomad/client_fs_endpoint.go``): an agent
serves requests for allocs on its own client directly from the alloc dir;
for remote allocs a server-mode agent forwards the HTTP request to the
owning node's advertised HTTP address (the reference proxies over
streaming RPC — same hop, this transport is HTTP).

Copied from ``nomad_tpu/agent/fs_routes.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change: logs are read through
the port's ``client/logmon.read_logs``.
"""
from __future__ import annotations

import os
import urllib.parse
import urllib.request
from typing import Optional

from .http import Hijacker, HTTPError, HTTPServer, Request, StreamingResponse
from .routes import _tail


# Follow-mode streams end after this long with no data AND no way to
# observe the peer (disconnects only surface on write); bounds the threads
# abandoned followers can pin.
MAX_STREAM_IDLE_S = 600.0


class FSRoutes:
    def __init__(self, agent) -> None:
        self.agent = agent

    def register_all(self, mux: HTTPServer) -> None:
        mux.register("/v1/client/fs/ls/", self.ls)
        mux.register("/v1/client/fs/stat/", self.stat)
        mux.register("/v1/client/fs/cat/", self.cat)
        mux.register("/v1/client/fs/readat/", self.readat)
        mux.register("/v1/client/fs/logs/", self.logs)
        mux.register("/v1/client/stats", self.host_stats)
        mux.register("/v1/client/allocation/", self.alloc_stats)

    # -- helpers ---------------------------------------------------------

    def _authorize(self, req: Request, alloc_id: str, capability: str) -> None:
        """Enforce namespace fs/logs capabilities (reference
        fs_endpoint.go:~40 aclObj.AllowNsOp(ns, readFS/readLogs))."""
        namespace = "default"
        server = self.agent.server
        if server is not None:
            alloc = server.fsm.state.alloc_by_id(alloc_id)
            if alloc is not None:
                namespace = alloc.namespace
        elif self.agent.client is not None:
            ar = self.agent.client.allocrunners.get(alloc_id)
            if ar is not None:
                namespace = ar.alloc.namespace
        self.agent.authorize(req, (capability,), namespace)

    def _alloc_root(self, alloc_id: str) -> Optional[str]:
        """The alloc's directory if it lives on this agent's client."""
        client = self.agent.client
        if client is None:
            return None
        root = os.path.join(client.alloc_dir_base, alloc_id)
        return root if os.path.isdir(root) else None

    def _safe_path(self, root: str, rel: str) -> str:
        """Resolve ``rel`` inside ``root``; reject escapes
        (fs_endpoint.go uses filepath.Clean + prefix check)."""
        candidate = os.path.realpath(os.path.join(root, rel.lstrip("/")))
        real_root = os.path.realpath(root)
        if candidate != real_root and not candidate.startswith(real_root + os.sep):
            raise HTTPError(403, "path escapes allocation directory")
        return candidate

    def _forward(self, req: Request, http_addr: str, path: str,
                 method: str = "GET", body: bytes = b"") -> bytes:
        """One node-addressed HTTP hop with token + query passthrough."""
        query = urllib.parse.urlencode(
            {k: v[0] for k, v in req.query.items()}, safe="/"
        )
        base = http_addr if "://" in http_addr else f"http://{http_addr}"
        url = f"{base}{path}"
        if query:
            url += f"?{query}"
        preq = urllib.request.Request(url, method=method, data=body or None)
        token = req.options.auth_token
        if token:
            preq.add_header("X-Nomad-Token", token)
        ctx = None
        if url.startswith("https://") and self.agent.tls is not None:
            ctx = self.agent.tls.http_client_context()
        try:
            with urllib.request.urlopen(preq, timeout=30, context=ctx) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            raise HTTPError(e.code, e.read().decode(errors="replace"))
        except OSError as e:
            raise HTTPError(502, f"proxy to {http_addr} failed: {e}")

    def _resolve_remote_node(self, alloc_id: str):
        """The node owning the alloc, for server→client forwarding.
        Raises 404 when the node is unknown, unreachable, or IS this very
        agent (a self-proxy would recurse until fd exhaustion)."""
        server = self.agent.server
        if server is None:
            raise HTTPError(404, f"alloc {alloc_id} not on this node")
        alloc = server.fsm.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise HTTPError(404, f"unknown allocation {alloc_id}")
        node = server.fsm.state.node_by_id(alloc.node_id)
        if node is None or not node.http_addr:
            raise HTTPError(
                404, f"node for alloc {alloc_id} has no reachable HTTP address"
            )
        if node.http_addr.split("://")[-1] == "{}:{}".format(*self.agent.http.addr):
            raise HTTPError(404, f"alloc {alloc_id} directory not found")
        return node

    def _proxy(self, req: Request, alloc_id: str, method: str = "GET",
               body: bytes = b"") -> bytes:
        """Forward to the node that owns the alloc (client_fs_endpoint.go
        server→client hop)."""
        node = self._resolve_remote_node(alloc_id)
        return self._forward(req, node.http_addr, req.path, method, body)

    # -- handlers --------------------------------------------------------

    def ls(self, req: Request):
        alloc_id = _tail(req, "/v1/client/fs/ls/")
        self._authorize(req, alloc_id, "read-fs")
        root = self._alloc_root(alloc_id)
        if root is None:
            import json

            return json.loads(self._proxy(req, alloc_id) or b"[]")
        path = self._safe_path(root, req.param("path", "/"))
        if not os.path.exists(path):
            raise HTTPError(404, f"path {req.param('path', '/')} not found")
        entries = []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            entries.append({
                "Name": name,
                "IsDir": os.path.isdir(full),
                "Size": st.st_size,
                "FileMode": oct(st.st_mode & 0o777),
                "ModTime": int(st.st_mtime),
            })
        return entries

    def stat(self, req: Request):
        alloc_id = _tail(req, "/v1/client/fs/stat/")
        self._authorize(req, alloc_id, "read-fs")
        root = self._alloc_root(alloc_id)
        if root is None:
            import json

            return json.loads(self._proxy(req, alloc_id) or b"{}")
        path = self._safe_path(root, req.param("path", "/"))
        if not os.path.exists(path):
            raise HTTPError(404, f"path {req.param('path', '/')} not found")
        st = os.stat(path)
        return {
            "Name": os.path.basename(path) or "/",
            "IsDir": os.path.isdir(path),
            "Size": st.st_size,
            "FileMode": oct(st.st_mode & 0o777),
            "ModTime": int(st.st_mtime),
        }

    def cat(self, req: Request) -> bytes:
        alloc_id = _tail(req, "/v1/client/fs/cat/")
        self._authorize(req, alloc_id, "read-fs")
        root = self._alloc_root(alloc_id)
        if root is None:
            return self._proxy(req, alloc_id)
        path = self._safe_path(root, req.param("path", "/"))
        if not os.path.isfile(path):
            raise HTTPError(404, f"file {req.param('path', '/')} not found")
        with open(path, "rb") as f:
            return f.read()

    def readat(self, req: Request) -> bytes:
        alloc_id = _tail(req, "/v1/client/fs/readat/")
        self._authorize(req, alloc_id, "read-fs")
        root = self._alloc_root(alloc_id)
        if root is None:
            return self._proxy(req, alloc_id)
        path = self._safe_path(root, req.param("path", "/"))
        if not os.path.isfile(path):
            raise HTTPError(404, f"file {req.param('path', '/')} not found")
        try:
            offset = int(req.param("offset", "0"))
            limit = int(req.param("limit", str(1 << 20)))
        except ValueError:
            raise HTTPError(400, "offset/limit must be integers")
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(max(0, limit))

    def host_stats(self, req: Request):
        """/v1/client/stats (reference command/agent/stats_endpoint.go →
        ClientStats.Stats, ACL NodeRead): host CPU/memory/disk/uptime. On a
        server agent, ?node_id= proxies to that node
        (client_stats_endpoint.go rpcHandlerForNode)."""
        self.agent.authorize(req, ("node:read",), "default")
        node_id = req.param("node_id")
        local = self.agent.client
        if node_id and (local is None or local.node.id != node_id):
            # not (or not only) this node: hop to the target's agent
            server = self.agent.server
            if server is None:
                raise HTTPError(404, f"node {node_id} is not this client")
            node = server.fsm.state.node_by_id(node_id)
            if node is None or not node.http_addr:
                raise HTTPError(404, f"node {node_id} has no reachable HTTP address")
            import json as json_mod

            return json_mod.loads(self._forward(
                req, node.http_addr, "/v1/client/stats") or b"{}")
        if local is None:
            raise HTTPError(404, "not a client node (pass ?node_id= on servers)")
        import os as os_mod
        import shutil as shutil_mod
        import time as time_mod

        mem = {}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    mem[k.strip()] = int(v.split()[0]) * 1024
        except (OSError, ValueError, IndexError):
            pass
        try:
            load1, load5, load15 = os_mod.getloadavg()
        except OSError:
            load1 = load5 = load15 = 0.0
        try:
            du = shutil_mod.disk_usage(self.agent.client.config.state_dir)
            disk = {"Size": du.total, "Used": du.used, "Available": du.free,
                    "UsedPercent": du.used / du.total * 100.0 if du.total else 0.0,
                    "Device": self.agent.client.config.state_dir}
        except OSError:
            disk = {}
        uptime = 0
        try:
            with open("/proc/uptime") as f:
                uptime = int(float(f.read().split()[0]))
        except (OSError, ValueError, IndexError):
            pass
        return {
            "Timestamp": time_mod.time_ns(),
            "Uptime": uptime,
            "CPUTicksConsumed": 0.0,
            "CPU": [{"CPU": f"cpu{i}"} for i in range(os_mod.cpu_count() or 1)],
            "LoadAvg": {"Load1": load1, "Load5": load5, "Load15": load15},
            "Memory": {
                "Total": mem.get("MemTotal", 0),
                "Available": mem.get("MemAvailable", 0),
                "Used": max(0, mem.get("MemTotal", 0) - mem.get("MemAvailable", 0)),
                "Free": mem.get("MemFree", 0),
            },
            "DiskStats": [disk] if disk else [],
        }

    def alloc_stats(self, req: Request):
        """/v1/client/allocation/<id>/{stats,restart,signal,exec}
        (reference client_allocations_endpoint.go + alloc_endpoint.go):
        stats aggregation plus task lifecycle verbs."""
        rest = _tail(req, "/v1/client/allocation/")
        alloc_id, _, verb = rest.partition("/")
        if verb in ("restart", "signal", "exec"):
            return self._alloc_lifecycle(req, alloc_id, verb)
        if verb != "stats":
            raise HTTPError(404, f"no handler for {req.path}")
        self._authorize(req, alloc_id, "read-job")
        client = self.agent.client
        runner = client.allocrunners.get(alloc_id) if client is not None else None
        if runner is None:
            import json

            return json.loads(self._proxy(req, alloc_id) or b"{}")
        import time as time_mod

        tasks = {}
        total_cpu = 0.0
        total_rss = 0
        for name, tr in runner.task_runners.items():
            try:
                st = tr.driver.task_stats(tr.task_id)
            except Exception:  # noqa: BLE001 — dead tasks have no stats
                continue
            tasks[name] = {
                "ResourceUsage": {
                    "CpuStats": {"Percent": st.cpu_percent},
                    "MemoryStats": {"RSS": st.memory_rss_bytes},
                },
                "Timestamp": st.timestamp_ns,
            }
            total_cpu += st.cpu_percent
            total_rss += st.memory_rss_bytes
        return {
            "ResourceUsage": {
                "CpuStats": {"Percent": total_cpu},
                "MemoryStats": {"RSS": total_rss},
            },
            "Tasks": tasks,
            "Timestamp": time_mod.time_ns(),
        }

    def _alloc_lifecycle(self, req: Request, alloc_id: str, verb: str):
        """restart/signal: alloc-lifecycle capability; exec: alloc-exec
        (reference acl.NamespaceCapabilityAllocLifecycle / AllocExec)."""
        cap = "alloc-exec" if verb == "exec" else "alloc-lifecycle"
        self._authorize(req, alloc_id, cap)
        client = self.agent.client
        runner = client.allocrunners.get(alloc_id) if client is not None else None
        if verb == "exec" and (req.headers.get("Upgrade") or "").lower() == "websocket":
            # INTERACTIVE exec (alloc_endpoint.go execStream): upgrade to a
            # websocket and bridge json-framed stdio to the task
            if runner is None:
                return self._exec_ws_bridge(req, alloc_id)
            return self._exec_ws_local(req, runner)
        if runner is None:
            import json

            return json.loads(self._proxy(req, alloc_id, method=req.method,
                                          body=req.body) or b"{}")
        body = {}
        if req.body:
            import json

            try:
                body = json.loads(req.body)
            except ValueError:
                raise HTTPError(400, "bad request body")
        task = body.get("Task", "") or req.param("task", "")
        if verb == "restart":
            runner.restart_task(task)
            return {"Index": 0}
        if verb == "signal":
            sig = body.get("Signal", "") or req.param("signal", "SIGTERM")
            try:
                runner.signal_task(task, sig)
            except KeyError:
                raise HTTPError(404, f"unknown task {task!r}")
            except Exception as e:  # noqa: BLE001 — bad signal names are 400s
                raise HTTPError(400, str(e))
            return {"Index": 0}
        # exec (one-shot, non-interactive)
        cmd = body.get("Cmd") or []
        if not task or not cmd:
            raise HTTPError(400, "exec requires Task and Cmd")
        try:
            timeout_s = float(req.param("timeout", "30"))
        except ValueError:
            raise HTTPError(400, "timeout must be a number")
        try:
            output, code = runner.exec_task(task, cmd, timeout_s)
        except KeyError:
            raise HTTPError(404, f"unknown task {task!r}")
        except Exception as e:  # noqa: BLE001 — driver may not support exec
            raise HTTPError(400, str(e))
        return {"Output": output.decode(errors="replace"), "ExitCode": code}

    def _exec_ws_local(self, req: Request, runner):
        """Serve an interactive exec session over a websocket upgrade.
        Frames are json, reference exec protocol shape:
          client -> {"stdin": {"data": b64}} | {"stdin": {"close": true}}
          server -> {"stdout": {"data": b64}} ... {"exit_code": N}
        """
        import base64
        import json
        import threading

        from . import websocket as ws

        task = req.param("task", "")
        try:
            cmd = json.loads(req.param("command", "[]"))
        except ValueError:
            raise HTTPError(400, "command must be a json array")
        if not task or not cmd:
            raise HTTPError(400, "exec requires task and command parameters")
        try:
            session = runner.exec_task_streaming(task, cmd)
        except KeyError:
            raise HTTPError(404, f"unknown task {task!r}")
        except Exception as e:  # noqa: BLE001 — driver may not support it
            raise HTTPError(400, str(e))

        def serve(handler) -> None:
            if not ws.server_handshake(handler):
                session.kill()
                return
            stop = threading.Event()

            def pump_stdin() -> None:
                try:
                    while not stop.is_set():
                        opcode, payload = ws.read_frame(handler.rfile)
                        if opcode == ws.OP_CLOSE:
                            session.stdin_close()
                            return
                        if opcode == ws.OP_PING:
                            ws.write_frame(handler.wfile, payload, ws.OP_PONG)
                            continue
                        try:
                            frame = json.loads(payload or b"{}")
                        except ValueError:
                            continue
                        stdin = frame.get("stdin") or {}
                        if stdin.get("close"):
                            session.stdin_close()
                        elif stdin.get("data"):
                            session.stdin_write(base64.b64decode(stdin["data"]))
                except (ConnectionError, OSError):
                    session.kill()

            t = threading.Thread(target=pump_stdin, daemon=True)
            t.start()
            try:
                while True:
                    chunk = session.read_output(timeout=0.25)
                    if chunk is None:
                        break
                    if chunk:
                        frame = json.dumps({
                            "stdout": {"data": base64.b64encode(chunk).decode()}
                        }).encode()
                        ws.write_frame(handler.wfile, frame, ws.OP_TEXT)
                code = session.exit_code()
                ws.write_frame(
                    handler.wfile,
                    json.dumps({"exit_code": 0 if code is None else code}).encode(),
                    ws.OP_TEXT,
                )
                ws.write_frame(handler.wfile, b"", ws.OP_CLOSE)
            except (BrokenPipeError, ConnectionResetError, OSError):
                session.kill()
            finally:
                stop.set()

        return Hijacker(serve)

    def _exec_ws_bridge(self, req: Request, alloc_id: str):
        """Server-mode agent: bridge the websocket to the owning node
        (the reference's server->client streaming-RPC hop)."""
        node = self._resolve_remote_node(alloc_id)
        addr = node.http_addr.split("://")[-1]
        host, _, port = addr.rpartition(":")
        query = urllib.parse.urlencode(
            {k: v[0] for k, v in req.query.items()}, safe="/"
        )
        path = req.path + (f"?{query}" if query else "")
        headers = {}
        if req.options.auth_token:
            headers["X-Nomad-Token"] = req.options.auth_token
        tls_ctx = None
        if node.http_addr.startswith("https://") and self.agent.tls is not None:
            tls_ctx = self.agent.tls.http_client_context()

        from . import websocket as ws

        def serve(handler) -> None:
            import threading

            try:
                upstream = ws.WebSocketClient(
                    host, int(port), path, headers=headers, tls_context=tls_ctx
                )
            except (OSError, ConnectionError) as e:
                handler.wfile.write(
                    f"HTTP/1.1 502 Bad Gateway\r\nContent-Length: 0\r\n\r\n".encode()
                )
                return
            if not ws.server_handshake(handler):
                upstream.close()
                return

            def downstream_to_upstream() -> None:
                try:
                    while True:
                        opcode, payload = ws.read_frame(handler.rfile)
                        if opcode == ws.OP_CLOSE:
                            upstream.close()
                            return
                        upstream.send(payload, opcode)
                except (ConnectionError, OSError):
                    upstream.close()

            t = threading.Thread(target=downstream_to_upstream, daemon=True)
            t.start()
            try:
                while True:
                    opcode, payload = upstream.recv()
                    if opcode == ws.OP_CLOSE:
                        ws.write_frame(handler.wfile, b"", ws.OP_CLOSE)
                        return
                    ws.write_frame(handler.wfile, payload, opcode)
            except (ConnectionError, OSError):
                pass

        return Hijacker(serve)

    def logs(self, req: Request):
        """Log read across the rotated sequence (fs_endpoint.go logs).
        ``follow=true`` switches to SERVER-PUSH streaming: the agent keeps
        the response open and pushes new bytes as the task writes them
        (the reference's streaming-RPC log frames; chunked here)."""
        alloc_id = _tail(req, "/v1/client/fs/logs/")
        self._authorize(req, alloc_id, "read-logs")
        follow = req.param("follow", "") in ("true", "1")
        root = self._alloc_root(alloc_id)
        if root is None:
            if follow:
                return self._proxy_stream(req, alloc_id)
            return self._proxy(req, alloc_id)
        task = req.param("task", "")
        if not task:
            raise HTTPError(400, "task parameter required")
        kind = req.param("type", "stdout")
        if kind not in ("stdout", "stderr"):
            raise HTTPError(400, "type must be stdout or stderr")
        try:
            offset = int(req.param("offset", "0"))
        except ValueError:
            raise HTTPError(400, "offset must be an integer")
        origin = req.param("origin", "start")
        from ..client.logmon import read_logs

        log_dir = os.path.join(root, "alloc", "logs")
        if not follow:
            data, next_offset = read_logs(
                log_dir, task, kind, offset=offset, origin=origin
            )
            req.response_index = next_offset
            return data

        runner = (self.agent.client.allocrunners.get(alloc_id)
                  if self.agent.client is not None else None)

        def task_dead() -> bool:
            if runner is None:
                return True
            tr = runner.task_runners.get(task)
            return tr is None or tr.done.is_set()

        def stream():
            import time as time_mod

            pos = offset
            first_origin = origin
            idle_deadline = time_mod.monotonic() + MAX_STREAM_IDLE_S
            while True:
                data, pos = read_logs(
                    log_dir, task, kind, offset=pos, origin=first_origin
                )
                first_origin = "start"  # offsets are absolute afterwards
                if data:
                    idle_deadline = time_mod.monotonic() + MAX_STREAM_IDLE_S
                    yield data
                    continue
                # the reference's frame stream ends at task completion;
                # the idle cap bounds abandoned followers (a disconnect
                # is only detectable on write)
                if task_dead() or time_mod.monotonic() > idle_deadline:
                    return
                time_mod.sleep(0.2)

        return StreamingResponse(stream())

    def _proxy_stream(self, req: Request, alloc_id: str):
        """Streaming pass-through to the owning node (server→client hop
        for follow-mode logs)."""
        node = self._resolve_remote_node(alloc_id)
        query = urllib.parse.urlencode(
            {k: v[0] for k, v in req.query.items()}, safe="/"
        )
        base = node.http_addr if "://" in node.http_addr else f"http://{node.http_addr}"
        url = f"{base}{req.path}"
        if query:
            url += f"?{query}"
        preq = urllib.request.Request(url)
        if req.options.auth_token:
            preq.add_header("X-Nomad-Token", req.options.auth_token)
        ctx = None
        if url.startswith("https://") and self.agent.tls is not None:
            ctx = self.agent.tls.http_client_context()
        try:
            resp = urllib.request.urlopen(preq, timeout=3600, context=ctx)
        except urllib.error.HTTPError as e:
            raise HTTPError(e.code, e.read().decode(errors="replace"))
        except OSError as e:
            raise HTTPError(502, f"proxy to {node.http_addr} failed: {e}")

        def stream():
            try:
                while True:
                    chunk = resp.read1(8192) if hasattr(resp, "read1") else resp.read(8192)
                    if not chunk:
                        return
                    yield chunk
            finally:
                resp.close()

        return StreamingResponse(stream())
