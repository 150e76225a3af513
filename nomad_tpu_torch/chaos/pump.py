"""The crash harness's heartbeat pump, in a process of its own.

:class:`~nomad_tpu_torch.chaos.replay.ChurnReplay` keeps every live
node alive from a thread of the harness's process, the stand-in for the
fleet's clients. Across real server processes that thread competes for
the harness's GIL with the harness's own work (decoding whole alloc
lists at the measurement, stitching the spans of every replica), and on
a slow host a pass outlasted the nodes' TTLs: the fleet expired at once
and the node-update evals that followed outran the schedulers. A Nomad
client runs in a process of its own; so does this pump.

Each pass heartbeats every node that is not muted (a muted node is the
trace's TTL-expiry fault) through the followers first, from a rotating
start, then the leader, as the reference's pump does (the heartbeat
forwards follower → leader, the ``forward_hop`` path), split over
``workers`` threads, each with connections of its own, as a fleet's
clients beat concurrently: one at a time, a pass of 120 nodes on a slow
host took as long as the shortest TTL. A server that cannot relay a
heartbeat (no leader known, as on a replica just restarted; a dead
process; a call slower than ``call_timeout``; a forward that failed)
hands the rest of the worker's pass to the next one, the leader last,
as a Nomad client fails over to another server (client/servers.go).
Every 5 s the process prints a JSON line of what it did (heartbeats
sent, failures by kind, passes, the slowest pass); the harness returns
it with the run's result.

Not in the reference: its pump is a thread of the harness
(``nomad_tpu/chaos/replay.py`` ``_pump_heartbeats``).

The harness drives it through :class:`HeartbeatPump`; the process reads
JSON lines on its standard input: ``{"nodes": [...], "muted": [...],
"followers": [[host, port], ...], "leader": [host, port] | null}``
replaces its view, and end of input stops it.
"""
from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

Addr = Tuple[str, int]

_REAP_TIMEOUT_S = 10.0


def heartbeat_pass(nodes: Sequence[str], muted, route: List[Addr], clients: Dict,
                   call_timeout: float, tally: Dict[str, int]) -> None:
    """One pass over ``nodes`` along ``route``, the leader last (consumed
    as servers fail); ``tally`` counts what happened."""
    from ..rpc.transport import RPCClient, RPCError

    for node_id in nodes:
        if node_id in muted:
            continue
        while route:
            addr = route[0]
            client = clients.get(addr)
            if client is None:
                client = clients[addr] = RPCClient(*addr, timeout=10.0)
            try:
                client.call("Node.Heartbeat", node_id, timeout=call_timeout)
                tally["sent"] = tally.get("sent", 0) + 1
                break
            except (OSError, RPCError) as e:
                kind = str(e).split(":", 1)[0][:40] or type(e).__name__
                tally[kind] = tally.get(kind, 0) + 1
                if len(route) == 1 and isinstance(e, RPCError) and not kind.startswith(
                        "NotLeaderError"):
                    break  # the leader refused this node's heartbeat itself
                # a relay that failed (dead, too slow, no leader, a failed
                # forward): the rest of the pass goes to the next server
                route.pop(0)
        if not route:
            tally["unrouted"] = tally.get("unrouted", 0) + 1
            break


def _read_update(fd: int, buf: bytearray, timeout: float) -> Tuple[Optional[dict], bool]:
    """The last complete JSON line that arrives within ``timeout`` (None
    if none), and whether the input ended."""
    latest = None
    ready, _, _ = select.select([fd], [], [], max(timeout, 0.0))
    while ready:
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            return latest, True
        buf += chunk
        while b"\n" in buf:
            line, _, rest = bytes(buf).partition(b"\n")
            buf[:] = rest
            if line.strip():
                latest = json.loads(line)
        ready, _, _ = select.select([fd], [], [], 0.0)
    return latest, False


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="nomad_tpu_torch.chaos.pump")
    p.add_argument("--interval", type=float, required=True)
    p.add_argument("--call-timeout", type=float, required=True)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)
    fd = sys.stdin.fileno()
    buf = bytearray()
    workers = max(1, args.workers)
    # one connection per server for each worker
    clients: List[Dict[Addr, object]] = [{} for _ in range(workers)]
    view = {"nodes": [], "muted": [], "followers": [], "leader": None}
    rr = 0
    next_pass = time.monotonic()
    tally: Dict[str, int] = {}
    next_report = time.monotonic() + 5.0
    try:
        while True:
            update, ended = _read_update(fd, buf, next_pass - time.monotonic())
            if update is not None:
                view = update
            if ended:
                return 0
            if time.monotonic() < next_pass:
                continue
            rr += 1
            nodes, muted = view["nodes"], set(view["muted"])
            followers = [tuple(a) for a in view["followers"]]
            leader = [tuple(view["leader"])] if view["leader"] else []
            threads = []
            t_pass = time.monotonic()
            tallies: List[Dict[str, int]] = [{} for _ in range(workers)]
            for w in range(workers):
                k = (rr + w) % len(followers) if followers else 0
                route = followers[k:] + followers[:k] + leader
                t = threading.Thread(target=heartbeat_pass,
                                     args=(nodes[w::workers], muted, route, clients[w],
                                           args.call_timeout, tallies[w]),
                                     name=f"heartbeat-pump-{w}", daemon=True)
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
            for per_worker in tallies:
                for k, v in per_worker.items():
                    tally[k] = tally.get(k, 0) + v
            tally["passes"] = tally.get("passes", 0) + 1
            tally["slowest_pass_ms"] = max(tally.get("slowest_pass_ms", 0),
                                           int((time.monotonic() - t_pass) * 1e3))
            if time.monotonic() >= next_report:
                # one line every 5 s: what the harness reads back
                print(json.dumps(tally, sort_keys=True), flush=True)
                tally, next_report = {}, time.monotonic() + 5.0
            next_pass = time.monotonic() + args.interval
    finally:
        for per_worker in clients:
            for c in per_worker.values():
                c.close()


class HeartbeatPump:
    """The pump process, started by ``start`` and fed by ``update``;
    ``stop`` ends its input and reaps it (bounded)."""

    def __init__(self, interval: float, call_timeout: float, log_path: str) -> None:
        self.interval = float(interval)
        self.call_timeout = float(call_timeout)
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._logf = None
        self._last: Optional[str] = None

    def start(self) -> None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self._logf = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch.chaos.pump",
             "--interval", str(self.interval), "--call-timeout", str(self.call_timeout)],
            stdin=subprocess.PIPE, stdout=self._logf, stderr=subprocess.STDOUT, env=env,
        )

    def update(self, nodes: Sequence[str], muted, followers: Sequence[Addr],
               leader: Optional[Addr]) -> None:
        """Hand the pump the current view (sent only when it changed)."""
        line = json.dumps({"nodes": list(nodes), "muted": sorted(muted),
                           "followers": [list(a) for a in followers],
                           "leader": list(leader) if leader else None})
        if line == self._last or self.proc is None or self.proc.poll() is not None:
            return
        self.proc.stdin.write(line.encode() + b"\n")
        self.proc.stdin.flush()
        self._last = line

    def report(self, lines: int = 60) -> List[dict]:
        """The pump's last 5-second tallies (heartbeats sent, failures by
        kind, passes, the slowest pass), oldest first."""
        try:
            with open(self.log_path, "rb") as f:
                rows = f.read().decode("utf-8", "replace").splitlines()[-lines:]
        except OSError:
            return []
        out = []
        for row in rows:
            try:
                out.append(json.loads(row))
            except ValueError:
                out.append({"log": row[:200]})
        return out

    def stop(self) -> None:
        try:
            if self.proc is not None:
                try:
                    self.proc.stdin.close()
                except OSError:
                    pass
                try:
                    self.proc.wait(timeout=_REAP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait(timeout=_REAP_TIMEOUT_S)
        finally:
            if self._logf is not None:
                self._logf.close()
                self._logf = None


if __name__ == "__main__":
    sys.exit(main())
