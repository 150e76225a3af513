"""serve-100Kwatch harness: a blocking-watcher army over real RPC.

:class:`ServeReplay` extends the crash harness's 3-process wire-raft
cluster with a **serving workload** that runs concurrently with the
churn trace:

- a **watcher army** (default 5120 watchers) each parked
  in a real ``Eval.GetEval`` blocking query against one replica — 2/3
  pinned to followers as ``allow_stale`` reads served by the follower's
  own FSM + hub, 1/3 to the leader. Every watcher is a
  :class:`~nomad_tpu_torch.watch.stale.StaleReader` chaining ``meta.index``
  back as the next ``min_query_index``, exactly like a reference agent;
- a **beacon writer** committing a rotating group of beacon evals
  through ``Eval.Update`` (which returns the raft index) once per tick,
  recording ``(index, commit_time)`` into a ledger;
- **throughput readers** issuing plain (non-blocking) list reads so the
  leader-vs-follower read split is measured on both query shapes.

The ledger is the ground truth that turns watch returns into verdicts:
a return whose index covers a ledger commit is a **wakeup** (latency =
return − max(park, commit)); a deadline-shaped return that sat on an
old covered commit is a **lost wakeup** (the acceptance gate requires
zero); an index move with no ledger entry for the key is a **spurious**
wakeup (bulk table writes from churn — correct, just not ours). The
deadline re-query inside ``blocking_read`` is what keeps "lost" honest:
even a dropped notify returns the CURRENT index, so losing a wakeup is
only ever visible as lateness, which is exactly what we measure.

Concurrency proof is sampled, not assumed: each writer tick polls every
replica's ``Watch.Stats`` (no_forward) and records the summed parked
depth; the bench gates on the peak. Per-replica hub stats at stop time
supply the cluster coalescing ratio (notifies / flushes).

Copied from ``nomad_tpu/watch/serve.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``; the cluster is the port's
:class:`~nomad_tpu_torch.chaos.crash.CrashReplay`, so ``device`` (default
``cuda``) reaches every server process. One change: the army runs on
``_ARMY_LOOPS`` selector loops, each watcher a connection of its own
with one blocking read in flight, instead of a thread per watcher. The
watchers, their reads, their chaining and the classification of every
return are the reference's; a thread each, 5,120 watchers beside the
servers' thread per parked read passed the card host's task limit
(the run was killed at ~8,100 threads), and on this host's CPU 5,120
harness threads left 3,371 watchers parked past the drain window.
"""
from __future__ import annotations

import os
import selectors
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos.crash import CrashReplay, ServerProcess
from ..rpc.codec import decode
from ..rpc.transport import RPCClient, RPCError, request_frame
from ..structs.structs import EVAL_STATUS_COMPLETE, Evaluation, QueryOptions
from .stale import StaleReader

# the transport's frame header: a big-endian u32 length
_FRAME_LEN = struct.Struct(">I")
# a return this close to max_query_time is deadline-shaped, not a wakeup
_DEADLINE_SLACK_S = 0.5
# a covered commit this much older than a deadline-shaped return means
# the notify was lost (vs merely coalesced/late)
_LOST_GRACE_S = 5.0
# the army's selector loops, each owning an equal share of the watchers
_ARMY_LOOPS = 4
# connect storms are gated so the accept queue never sees 5K SYNs at once
_CONNECT_GATE = 64
# a watch call's transport bound past its max_query_time (the reference
# watcher's RPCClient timeout: max_query_time + 15 s)
_CALL_SLACK_S = 15.0
# a failed watch call is retried after this pause
_RETRY_PAUSE_S = 0.2


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _beacon_eval(key: str, tick: int) -> Evaluation:
    ev = Evaluation(id=key, job_id="serve-beacon", type="service")
    ev.status = EVAL_STATUS_COMPLETE   # terminal: the broker ignores it
    ev.status_description = f"tick-{tick}"
    return ev


class _WatcherStats:
    """One watcher thread's counters — thread-local while running,
    aggregated by the parent after join, so the hot loop takes no shared
    lock except the ledger read on an index move."""

    __slots__ = ("role", "seeds", "wakeups", "lost", "spurious",
                 "deadline_idle", "drain", "errors", "latencies_ms")

    def __init__(self, role: str) -> None:
        self.role = role
        self.seeds = 0
        self.wakeups = 0
        self.lost = 0
        self.spurious = 0
        self.deadline_idle = 0
        self.drain = 0
        self.errors = 0
        self.latencies_ms: List[float] = []


class _Watcher:
    """One member of the army: its key, its replica, its connection and
    the read in flight; the counters are its ``_WatcherStats``."""

    __slots__ = ("key", "port", "stale", "stats", "sock", "connecting", "out", "inbuf",
                 "seq", "last_index", "min_index", "t_park", "deadline", "in_flight",
                 "retry_at", "closed")

    def __init__(self, key: str, port: int, role: str, stale: bool) -> None:
        self.key, self.port, self.stale = key, port, stale
        self.stats = _WatcherStats(role)
        self.sock = None
        self.connecting = False
        self.out = bytearray()
        self.inbuf = bytearray()
        self.seq = 0
        self.last_index = 0
        self.min_index = 0
        self.t_park = 0.0
        self.deadline = 0.0
        self.in_flight = False
        self.retry_at = 0.0
        self.closed = False


class ServeReplay(CrashReplay):
    """Churn replay + concurrent blocking-watch serving workload.

    Construction kwargs beyond :class:`CrashReplay`:

    - ``n_watchers``: army size (default 5120; ``>= 5000`` parked
      concurrently is the bench gate);
    - ``n_beacons`` / ``beacon_group`` / ``beacon_tick_s``: ledger key
      space, keys committed per tick, tick period. The schedule's
      arithmetic is load-bearing on one core: the per-key commit period
      ``(n_beacons / beacon_group) * beacon_tick_s`` must sit UNDER
      ``watch_query_time`` (else parks deadline out instead of waking),
      which fixes the total wakeup rate at ``n_watchers / period``. The
      free knob is burst shape, and both extremes lose: one big burst
      per second convoys the woken clients behind each other's GIL
      slices (seconds of tail), while tiny continuous bursts leave the
      replica schedulers no quiet gap and starve placement (the
      I/O-bound handler flood preempts CPU-bound scheduler slices).
      Defaults: ~107 watchers every 500ms;
    - ``watch_query_time``: each park's ``max_query_time`` — also the
      bound on army drain at stop;
    - ``n_readers``: plain-read throughput threads.

    The trace must not carry ``leader_kill``: watchers pin replicas by
    role for the follower-share measurement, and a mid-run re-election
    would silently turn a follower pin into a leader pin.
    """

    def __init__(self, *, n_watchers: int = 5120, n_beacons: int = 96,
                 beacon_group: int = 2, beacon_tick_s: float = 0.5,
                 watch_query_time: float = 30.0, n_readers: int = 6,
                 ramp_timeout_s: float = 150.0, **kwargs) -> None:
        super().__init__(**kwargs)
        if any(ev.kind == "leader_kill" for ev in self.trace):
            raise ValueError(
                "serve traces cannot carry leader_kill: watchers pin "
                "replicas by role; use CrashReplay for failover scenarios"
            )
        self.n_watchers = int(n_watchers)
        self.n_beacons = int(n_beacons)
        self.beacon_group = max(1, int(beacon_group))
        self.beacon_tick_s = float(beacon_tick_s)
        self.watch_query_time = float(watch_query_time)
        self.n_readers = int(n_readers)
        self.ramp_timeout_s = float(ramp_timeout_s)
        self.ramp_s: Optional[float] = None
        self.ramp_parked = 0
        self._serve_stop = threading.Event()
        self._serve_threads: List[threading.Thread] = []
        self._army_threads: List[threading.Thread] = []
        self._watchers: List[_Watcher] = []
        self._serve_clients: List[RPCClient] = []
        self._connect_gate = threading.Semaphore(_CONNECT_GATE)
        self._army_deadline: Optional[float] = None   # set at halt
        # beacon key -> [(raft index, commit monotonic)]  # guarded-by: _ledger_lock
        self._ledger: Dict[str, List[Tuple[int, float]]] = {}
        self._ledger_lock = threading.Lock()
        self._watcher_stats: List[_WatcherStats] = []
        self._stats_lock = threading.Lock()   # guards _watcher_stats/_reads/_army_deadline
        # plain-read throughput counters: role -> count  # guarded-by: _stats_lock
        self._reads: Dict[str, int] = {"leader": 0, "follower": 0}
        self.beacon_commits = 0          # writer thread only
        self.writer_errors = 0           # writer thread only
        self.peak_watchers = 0           # writer thread only
        self.stragglers = 0              # parent, after join
        self._final_watch_stats: Dict[str, Dict[str, object]] = {}

    # -- lifecycle ---------------------------------------------------------

    def _boot(self) -> None:
        super()._boot()
        self._serve_start()

    def _post_trace(self) -> None:
        self._serve_halt()
        super()._post_trace()

    def _extra_result(self) -> Dict[str, object]:
        out = super()._extra_result()
        out["serve"] = self._serve_result()
        return out

    def _shutdown(self) -> None:
        self._serve_halt()   # idempotent; normal path already ran it
        for c in self._serve_clients:
            try:
                c.close()
            except OSError:
                pass
        self._serve_clients.clear()
        super()._shutdown()

    # -- army --------------------------------------------------------------

    def _beacon_key(self, i: int) -> str:
        return f"serve-beacon-{i:04d}"

    def _serve_start(self) -> None:
        leader = self._find_leader_proc()
        followers = [sp for sp in self.procs.values() if sp is not leader]
        # seed the ledger: one registration commit covering every key
        writer_client = RPCClient("127.0.0.1", leader.port, timeout=15.0)
        self._serve_clients.append(writer_client)
        evals = [_beacon_eval(self._beacon_key(i), 0)
                 for i in range(self.n_beacons)]
        idx = writer_client.call("Eval.Update", evals, timeout=15.0)
        now = time.monotonic()
        with self._ledger_lock:
            for i in range(self.n_beacons):
                self._ledger[self._beacon_key(i)] = [(int(idx), now)]
        self.beacon_commits = 1

        for i in range(self.n_watchers):
            if i % 3 == 0 or not followers:
                proc, role, stale = leader, "leader", False
            else:
                proc = followers[i % len(followers)]
                role, stale = "follower", True
            self._watchers.append(
                _Watcher(self._beacon_key(i % self.n_beacons), proc.port, role, stale))
        for j in range(_ARMY_LOOPS):
            t = threading.Thread(target=self._army_main,
                                 args=(self._watchers[j::_ARMY_LOOPS],),
                                 name=f"serve-army-{j}", daemon=True)
            t.start()
            self._army_threads.append(t)
        # ramp barrier: the trace must drive a FULLY parked army, not a
        # spawning one — every watcher seed-reads then parks (no beacon
        # commits happen yet, so parked threads stay parked), and the
        # measurement window starts only once the hubs report the whole
        # army registered
        t0 = time.monotonic()
        deadline = t0 + self.ramp_timeout_s
        while time.monotonic() < deadline:
            depth = self._sample_depth()
            self.ramp_parked = max(self.ramp_parked, depth)
            if depth >= self.n_watchers:
                break
            time.sleep(0.5)
        self.ramp_s = round(time.monotonic() - t0, 1)
        self.peak_watchers = self.ramp_parked
        if self.ramp_parked < self.n_watchers:
            self.errors.append(  # race-ok: GIL-atomic append; harness list, read after threads settle
                f"serve ramp: {self.ramp_parked}/{self.n_watchers} watchers "
                f"parked after {self.ramp_timeout_s:.0f}s"
            )
        replicas = [leader] + followers
        for j in range(self.n_readers):
            proc = replicas[j % len(replicas)]
            role = "leader" if proc is leader else "follower"
            t = threading.Thread(
                target=self._reader_main,
                args=(proc, role, proc is not leader),
                name=f"serve-read-{j}", daemon=True,
            )
            t.start()
            self._serve_threads.append(t)
        sampler = threading.Thread(
            target=self._sampler_main, name="serve-sampler", daemon=True)
        sampler.start()
        self._serve_threads.append(sampler)
        writer = threading.Thread(
            target=self._writer_main, args=(writer_client,),
            name="serve-writer", daemon=True)
        writer.start()
        self._serve_threads.append(writer)

    def _serve_halt(self) -> None:
        if self._serve_stop.is_set():
            return
        self._serve_stop.set()
        # one final commit touching EVERY beacon key wakes the whole army
        # promptly instead of waiting out max_query_time deadlines
        try:
            lp = self._leader_proc or self._find_leader_proc()
            flush = RPCClient("127.0.0.1", lp.port, timeout=15.0)
            self._serve_clients.append(flush)
            idx = flush.call(
                "Eval.Update",
                [_beacon_eval(self._beacon_key(i), -1)
                 for i in range(self.n_beacons)],
                timeout=15.0,
            )
            now = time.monotonic()
            with self._ledger_lock:
                for i in range(self.n_beacons):
                    self._ledger.setdefault(
                        self._beacon_key(i), []).append((int(idx), now))
            self.beacon_commits += 1
        except (RPCError, OSError, RuntimeError) as e:
            self.errors.append(f"serve halt flush: {e!r}")  # race-ok: GIL-atomic append; harness list, read after threads settle
        deadline = time.monotonic() + self.watch_query_time + 30.0
        with self._stats_lock:
            self._army_deadline = deadline
        for t in self._army_threads + self._serve_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self.stragglers = (sum(1 for w in self._watchers if not w.closed)
                           + sum(1 for t in self._army_threads + self._serve_threads
                                 if t.is_alive()))
        if self.stragglers:
            self.errors.append(  # race-ok: GIL-atomic append; harness list, read after threads settle
                f"serve: {self.stragglers} army watchers or threads still parked after "
                f"{self.watch_query_time + 30.0:.0f}s drain window"
            )
        for nid, sp in sorted(self.procs.items()):
            if not sp.alive():
                continue
            try:
                self._final_watch_stats[nid] = sp.call(
                    "Watch.Stats", no_forward=True, timeout=2.0)
            except (RPCError, OSError):
                pass

    # -- threads -----------------------------------------------------------

    def _army_main(self, watchers: List["_Watcher"]) -> None:
        """One selector loop over its share of the army: each watcher a
        connection of its own with one blocking ``Eval.GetEval`` in
        flight, chaining ``meta.index`` back as its next
        ``min_query_index`` (the reference's ``StaleReader.watch``), its
        returns classified as the reference's watcher thread does."""
        sel = selectors.DefaultSelector()
        by_fd: Dict[int, _Watcher] = {}
        waiting = list(watchers)            # to (re)connect, in order
        try:
            while True:
                now = time.monotonic()
                stopping = self._serve_stop.is_set()
                if stopping:
                    with self._stats_lock:
                        deadline = self._army_deadline
                    if all(w.closed for w in watchers) or (
                            deadline is not None and now > deadline):
                        return
                # dial the next watchers the connect gate lets through
                if not stopping:
                    keep = []
                    for w in waiting:
                        if w.retry_at > now or not self._connect_gate.acquire(blocking=False):
                            keep.append(w)
                            continue
                        self._army_dial(w, sel, by_fd)
                    waiting = keep
                for key, events in sel.select(timeout=0.05):
                    w = by_fd.get(key.fd)
                    if w is not None:
                        self._army_event(w, events, sel, by_fd, waiting)
                now = time.monotonic()
                for w in list(by_fd.values()):
                    if w.deadline and now > w.deadline:
                        w.stats.errors += 1   # the call outlived its bound
                        self._army_drop(w, sel, by_fd, waiting)
                if stopping:
                    for w in list(by_fd.values()):
                        if not w.in_flight:
                            self._army_close(w, sel, by_fd)
                    for w in waiting:
                        w.closed = True
                    waiting = []
        finally:
            for w in list(by_fd.values()):
                self._army_close(w, sel, by_fd)
            sel.close()
            with self._stats_lock:
                self._watcher_stats.extend(w.stats for w in watchers)

    def _army_dial(self, w: "_Watcher", sel, by_fd) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        w.sock, w.connecting = sock, True
        w.deadline = time.monotonic() + self.watch_query_time + _CALL_SLACK_S
        sock.connect_ex(("127.0.0.1", w.port))
        by_fd[sock.fileno()] = w
        sel.register(sock, selectors.EVENT_WRITE)

    def _army_send(self, w: "_Watcher", sel) -> None:
        """Queue the watcher's next blocking read and wait for writability."""
        w.seq += 1
        w.min_index = w.last_index
        w.out = bytearray(request_frame(
            w.seq, "Eval.GetEval", w.key,
            QueryOptions(min_query_index=w.last_index,
                         max_query_time=self.watch_query_time,
                         allow_stale=w.stale),
            stale=w.stale))
        w.inbuf = bytearray()
        w.in_flight = True
        w.t_park = time.monotonic()
        w.deadline = w.t_park + self.watch_query_time + _CALL_SLACK_S
        sel.modify(w.sock, selectors.EVENT_WRITE)

    def _army_event(self, w: "_Watcher", events, sel, by_fd, waiting) -> None:
        try:
            if w.connecting:
                err = w.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err:
                    raise OSError(err, os.strerror(err))
                w.connecting = False
                self._connect_gate.release()
                self._army_send(w, sel)
                return
            if events & selectors.EVENT_WRITE and w.out:
                sent = w.sock.send(w.out)
                del w.out[:sent]
                if not w.out:
                    sel.modify(w.sock, selectors.EVENT_READ)
                return
            if events & selectors.EVENT_READ:
                chunk = w.sock.recv(1 << 16)
                if not chunk:
                    raise ConnectionError("server closed the connection")
                w.inbuf += chunk
                if len(w.inbuf) < 4:
                    return
                (n,) = _FRAME_LEN.unpack_from(w.inbuf, 0)
                if len(w.inbuf) < 4 + n:
                    return
                resp = decode(bytes(w.inbuf[4:4 + n]))
                w.in_flight = False
                if resp.get("seq") != w.seq:
                    raise ConnectionError("response seq mismatch")
                self._army_reply(w, resp, sel, by_fd, waiting)
        except (OSError, ValueError) as e:  # noqa: F841 — counted, then redialled
            if w.connecting:
                w.connecting = False
                self._connect_gate.release()
            w.stats.errors += 1
            self._army_drop(w, sel, by_fd, waiting)

    def _army_reply(self, w: "_Watcher", resp, sel, by_fd, waiting) -> None:
        """One watch return: classified as the reference's watcher
        classifies it, then the next read, or the close when stopping."""
        now = time.monotonic()
        if resp.get("error"):
            w.stats.errors += 1
            self._army_drop(w, sel, by_fd, waiting)   # redialled after a pause
            return
        _, meta = resp["body"]
        w.last_index = max(w.last_index, meta.index)
        if self._serve_stop.is_set():
            # the halt path wakes the WHOLE army at once to drain it fast;
            # that storm is a teardown mechanism, not the serving
            # workload — keep it out of the latency distribution
            w.stats.drain += 1
            self._army_close(w, sel, by_fd)
            return
        if w.min_index == 0:
            w.stats.seeds += 1   # first call is non-blocking by design
        else:
            self._classify(w.stats, w.key, w.min_index, meta.index, w.t_park, now,
                           now - w.t_park)
        self._army_send(w, sel)

    def _army_drop(self, w: "_Watcher", sel, by_fd, waiting) -> None:
        """Close a failed connection; redial after a pause unless stopping."""
        self._army_close(w, sel, by_fd)
        if not self._serve_stop.is_set():
            w.closed = False
            w.retry_at = time.monotonic() + _RETRY_PAUSE_S
            waiting.append(w)

    def _army_close(self, w: "_Watcher", sel, by_fd) -> None:
        if w.sock is not None:
            by_fd.pop(w.sock.fileno(), None)
            try:
                sel.unregister(w.sock)
            except (KeyError, ValueError):
                pass
            try:
                w.sock.close()
            except OSError:
                pass
            w.sock = None
        w.in_flight = False
        w.deadline = 0.0
        w.closed = True

    def _classify(self, stats: _WatcherStats, key: str, min_index: int,
                  index: int, t_park: float, now: float,
                  elapsed: float) -> None:
        deadline_shaped = elapsed >= self.watch_query_time - _DEADLINE_SLACK_S
        first_commit: Optional[float] = None
        with self._ledger_lock:
            for c_idx, c_time in self._ledger.get(key, ()):
                if min_index < c_idx <= max(index, min_index):
                    first_commit = c_time if first_commit is None else min(
                        first_commit, c_time)
        if index > min_index:
            if first_commit is None:
                stats.spurious += 1   # bulk table write from churn, not ours
            elif deadline_shaped and now - first_commit >= _LOST_GRACE_S:
                stats.lost += 1       # covered commit sat un-notified
            else:
                stats.wakeups += 1
                stats.latencies_ms.append(
                    max(0.0, now - max(first_commit, t_park)) * 1000.0)
        else:
            # index did not move past min: a pure deadline. If the ledger
            # says this key DID move long ago, replication/notify stalled.
            stalled = False
            with self._ledger_lock:
                for c_idx, c_time in self._ledger.get(key, ()):
                    if c_idx > min_index and now - c_time >= _LOST_GRACE_S:
                        stalled = True
                        break
            if stalled:
                stats.lost += 1
            else:
                stats.deadline_idle += 1

    def _sample_depth(self) -> int:
        """Summed parked-watcher depth across replica hubs (Watch.Stats,
        no_forward — each replica answers for its own registry)."""
        depth = 0
        for sp in self.procs.values():
            if not sp.alive():
                continue
            try:
                st = sp.call("Watch.Stats", no_forward=True, timeout=2.0)
                depth += int(st.get("watchers", 0))
            except (RPCError, OSError):
                pass
        return depth

    def _sampler_main(self) -> None:
        while not self._serve_stop.is_set():
            self.peak_watchers = max(self.peak_watchers, self._sample_depth())
            self._serve_stop.wait(1.0)

    def _writer_main(self, client: RPCClient) -> None:
        tick = 0
        cursor = 0
        while not self._serve_stop.is_set():
            t0 = time.monotonic()
            tick += 1
            keys = [self._beacon_key((cursor + j) % self.n_beacons)
                    for j in range(self.beacon_group)]
            cursor = (cursor + self.beacon_group) % self.n_beacons
            try:
                idx = client.call(
                    "Eval.Update", [_beacon_eval(k, tick) for k in keys],
                    timeout=10.0,
                )
            except (RPCError, OSError):
                self.writer_errors += 1
                self._serve_stop.wait(0.5)
                continue
            now = time.monotonic()
            with self._ledger_lock:
                for k in keys:
                    self._ledger.setdefault(k, []).append((int(idx), now))
            self.beacon_commits += 1
            self._serve_stop.wait(
                max(0.05, self.beacon_tick_s - (time.monotonic() - t0)))

    def _reader_main(self, proc: ServerProcess, role: str,
                     stale: bool) -> None:
        client = RPCClient("127.0.0.1", proc.port, timeout=10.0)
        reader = StaleReader(client, stale=stale)
        n = 0
        try:
            while not self._serve_stop.is_set():
                try:
                    # row reads, not Eval.List: a full-table serialize per
                    # poll would measure pickling, not the serving path
                    reader.read("Eval.GetEval",
                                self._beacon_key(n % self.n_beacons),
                                timeout=10.0)
                    n += 1
                except (RPCError, OSError):
                    if self._serve_stop.is_set():
                        break
                self._serve_stop.wait(0.1)
        finally:
            with self._stats_lock:
                self._reads[role] = self._reads.get(role, 0) + n
            try:
                client.close()
            except OSError:
                pass

    # -- result ------------------------------------------------------------

    def _serve_result(self) -> Dict[str, object]:
        lat: List[float] = []
        by_role = {"leader": 0, "follower": 0}
        wakeups = lost = spurious = idle = errors = seeds = drain = 0
        with self._stats_lock:
            stats = list(self._watcher_stats)
            plain_reads = dict(self._reads)
        for s in stats:
            lat.extend(s.latencies_ms)
            # every completed watch return is one served read
            by_role[s.role] = by_role.get(s.role, 0) + (
                s.seeds + s.wakeups + s.lost + s.spurious
                + s.deadline_idle + s.drain)
            wakeups += s.wakeups
            lost += s.lost
            spurious += s.spurious
            idle += s.deadline_idle
            drain += s.drain
            errors += s.errors
            seeds += s.seeds
        for role, n in plain_reads.items():
            by_role[role] = by_role.get(role, 0) + n
        total_reads = sum(by_role.values())
        lat.sort()
        notifies = sum(int(st.get("notifies", 0))
                       for st in self._final_watch_stats.values())
        flushes = sum(int(st.get("flushes", 0))
                      for st in self._final_watch_stats.values())
        return {
            "n_watchers": self.n_watchers,
            "peak_concurrent_watchers": self.peak_watchers,
            "ramp_s": self.ramp_s,
            "ramp_parked": self.ramp_parked,
            "stragglers": self.stragglers,
            "wakeups": wakeups,
            "lost_wakeups": lost,
            "spurious_wakeups": spurious,
            "deadline_idle": idle,
            "drain_wakeups": drain,
            "seed_reads": seeds,
            "watcher_errors": errors,
            "wakeup_ms": {
                "p50": round(_percentile(lat, 0.50), 1),
                "p95": round(_percentile(lat, 0.95), 1),
                "p99": round(_percentile(lat, 0.99), 1),
                "max": round(lat[-1], 1) if lat else 0.0,
                "samples": len(lat),
            },
            "beacon_commits": self.beacon_commits,
            "writer_errors": self.writer_errors,
            "reads_total": total_reads,
            "reads_by_role": by_role,
            "follower_read_share": (
                round(by_role.get("follower", 0) / total_reads, 4)
                if total_reads else 0.0
            ),
            "plain_reads_by_role": plain_reads,
            "coalesce_ratio": (
                round(notifies / flushes, 2) if flushes else 0.0
            ),
            "watch_stats": dict(self._final_watch_stats),
        }
