"""Raft consensus over the RPC transport — one node per server process.

Fills the role of the reference's vendored hashicorp/raft
(nomad/server.go:1079 setupRaft, nomad/raft_rpc.go RaftLayer): leader
election with randomized timeouts, term/vote persistence, log replication
with quorum commit, conflict rollback via next_index backtracking, and
snapshot install for followers whose needed entries were compacted. The
durable log rides the C++ segmented store (native/nomadlog — the
raft-boltdb slot); term/vote metadata sits beside it.

Interface-compatible with ``InProcRaft`` as the ``Server`` consumes it
(join / apply / is_leader / snapshot / leadership_observers / close), so a
server runs unchanged on either: in-proc for dev mode and tests, wire raft
for real multi-process clusters. ``apply`` blocks until the entry commits
on a quorum and is applied to the local FSM — the same linearizable
contract ``raftApply`` gives the reference (nomad/rpc.go raftApply).

Copied from ``nomad_tpu/server/wire_raft.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Changes: the durable log is the
port's ``native.log.NativeLog`` (the same C++ source and file format, so
either package reads a data dir the other wrote), the codec is the port's
(the same msgpack bytes), and the logger sits under ``nomad_tpu_torch``;
and a new leader tells its observers (the server's leadership setup,
which restores pending evals) only once its barrier entry is applied, as
Nomad waits on a raft barrier first: the reference tells them at once,
and a server that restored its evals before a committed plan of the old
term reached its FSM placed the same names twice (the crash harness's
doubled slots). Two more of hashicorp/raft's behaviours the reference
lacks keep a slow or stale follower from deposing a working leader,
which under load turned one rejoin into a hundred elections (the
rejoining server kept raising its term ahead of the cluster's, and each
raise deposed the leader): a server campaigns only after a pre-vote
round (``Raft.PreVote``, Raft thesis §9.6) in which a majority says it
would vote for it; a server that knows a live leader rejects a vote
without taking the candidate's term (Raft §6); and a follower's
election timer starts when it has finished handling the leader's call,
not when the call arrived. Every fsync and ``sync()``
of the reference stays: durability is part of the result.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..rpc.codec import decode as codec_decode
from ..rpc.codec import encode as codec_encode
from ..rpc.transport import RPCClient, RPCError, RPCServer
from .fsm import NomadFSM
from .raft import NotLeaderError
from ..utils.lock_witness import witness_lock, witness_rlock

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


def _encode_fsm_state(state_store) -> bytes:
    """FSM snapshot → msgpack bytes through the typed struct codec.

    Snapshots cross the wire in InstallSnapshot, so they must never be
    pickled: arbitrary deserialization there would hand code execution to
    any peer that can reach the RPC port (the reference ships snapshot
    data as msgpack, nomad/fsm.go persist/restore)."""
    return codec_encode(state_store.__getstate__())


def _decode_fsm_state(blob: bytes):
    from ..state import StateStore

    store = StateStore.__new__(StateStore)
    store.__setstate__(codec_decode(blob))
    return store


def _decode_disk_blob(blob: bytes):
    """Decode a locally-persisted record (log entry / snapshot wrapper).

    New writes are always codec-encoded; data dirs written by builds that
    pickled local state still load (pickle is acceptable for LOCAL files
    we wrote ourselves — the wire never carries it)."""
    try:
        return codec_decode(blob)
    except Exception:  # noqa: BLE001 — legacy format
        import pickle  # local-disk fallback only

        return pickle.loads(blob)


@dataclass
class WireRaftConfig:
    node_id: str = "node-1"
    election_timeout_min: float = 0.5
    election_timeout_max: float = 1.0
    heartbeat_interval: float = 0.1
    rpc_timeout: float = 1.0
    apply_timeout: float = 10.0
    sync_writes: bool = False


class WireRaft:
    """A raft participant. ``peers`` maps node_id → RPC address of the
    other servers; the full cluster is peers + self (static bootstrap,
    the reference's ``bootstrap_expect`` pattern)."""

    def __init__(
        self,
        rpc: RPCServer,
        peers: Optional[Dict[str, Tuple[str, int]]] = None,
        config: Optional[WireRaftConfig] = None,
        data_dir: Optional[str] = None,
    ) -> None:
        self.config = config or WireRaftConfig()
        self.node_id = self.config.node_id
        self.logger = logging.getLogger(f"nomad_tpu_torch.raft.{self.node_id}")
        self.rpc = rpc
        self.peers: Dict[str, Tuple[str, int]] = dict(peers or {})
        # staged (log-replicated) membership: peers added through the log
        # start as NONVOTERS — replicated to but outside quorum/election
        # math — and promote to voters once caught up (the reference gets
        # this from hashicorp/raft's staged configuration changes,
        # leader.go:859)
        self.nonvoters: set = set()
        self._self_nonvoter = False
        self._staged: Dict[str, int] = {}  # peer -> catch-up target index
        self._clients: Dict[str, RPCClient] = {}

        self._lock = witness_rlock("wire_raft.WireRaft._lock")
        self._snap_lock = witness_lock("wire_raft.WireRaft._snap_lock")
        self._commit_cv = threading.Condition(self._lock)
        self._repl_cv = threading.Condition(self._lock)
        self._snapshots_installed = 0

        # persistent state
        self.current_term = 0
        self.voted_for: Optional[str] = None
        # log entries as (index, term, entry_type, payload); index-contiguous,
        # starting after the snapshot boundary
        self.log: List[Tuple[int, int, str, object]] = []
        self._snapshot_index = 0
        self._snapshot_term = 0
        self._snapshot_state: Optional[bytes] = None
        self._snapshot_config: Optional[dict] = None

        # volatile state
        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self._apply_results: Dict[int, object] = {}

        self.fsm: Optional[NomadFSM] = None
        self.leadership_observers: List[Callable[[int, bool], None]] = []
        self._was_leader = False

        self.store = None
        self._meta_path = None
        self._snapshot_path = None
        if data_dir is not None:
            from ..native.log import NativeLog

            os.makedirs(data_dir, exist_ok=True)
            self.store = NativeLog(os.path.join(data_dir, "log"))
            self._meta_path = os.path.join(data_dir, "raft_meta.json")
            self._snapshot_path = os.path.join(data_dir, "snapshot.bin")
            self._load_persistent()

        self._shutdown = threading.Event()
        self._started = False
        self._config_replay_boundary = 0
        self._last_contact = time.monotonic()
        self._election_deadline = self._random_deadline()
        self._threads: List[threading.Thread] = []

        rpc.register("Raft.RequestVote", self._handle_request_vote)
        rpc.register("Raft.PreVote", self._handle_pre_vote)
        rpc.register("Raft.AppendEntries", self._handle_append_entries)
        rpc.register("Raft.InstallSnapshot", self._handle_install_snapshot)

    # -- InProcRaft-compatible surface -----------------------------------

    def join(self, fsm: NomadFSM) -> int:
        """Attach the local FSM (exactly one per process); restores the
        snapshot + replays committed log. Returns peer handle 0."""
        with self._lock:
            if self.fsm is not None:
                raise ValueError("wire raft hosts exactly one FSM")
            self.fsm = fsm
            if self._snapshot_state is not None:
                fsm.restore(_decode_fsm_state(self._snapshot_state))
                self.last_applied = self._snapshot_index
            # committed entries re-apply on restart via commit advancement;
            # a lone node (no peers) self-commits everything it has
            if not self.peers:
                self.commit_index = self._last_index()
                self._apply_committed_locked()
        return 0

    def is_leader(self, peer: int = 0) -> bool:
        return self.state == LEADER

    def apply(self, peer: int, entry_type: str, payload) -> Tuple[int, object]:
        """Leader-only: append, replicate to quorum, apply, return
        (index, local FSM response)."""
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(
                    f"{self.node_id} is not the leader (leader={self.leader_id})"
                )
            index = self._last_index() + 1
            term = self.current_term
            self._append_locked(index, term, entry_type, payload)
            self.match_index[self.node_id] = index
            self._repl_cv.notify_all()
            if not self.peers:
                self._advance_commit_locked()
            deadline = time.monotonic() + self.config.apply_timeout
            while self.commit_index < index or self.last_applied < index:
                if self.state != LEADER or self.current_term != term:
                    raise NotLeaderError("lost leadership during apply")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"apply of index {index} timed out")
                self._commit_cv.wait(remaining)
            return index, self._apply_results.pop(index, None)

    def snapshot(self, peer: int = 0) -> int:
        """Snapshot the FSM and compact the log (fsm.go:1059).

        Capture (state, applied index, term, membership) is atomic under
        ``_lock``; the codec encode and the fsync'd file write run OUTSIDE
        it, so a large FSM dump never stalls appends, commit advancement
        or the replicator heartbeats (a leader serializing a big snapshot
        under the lock reads as a dead leader to its peers). Installation
        re-checks under ``_lock`` that no newer snapshot — e.g. a
        concurrent InstallSnapshot — landed meanwhile."""
        with self._snap_lock:
            with self._lock:
                if self.fsm is None:
                    return 0
                index = self.last_applied
                if index == 0:
                    return 0
                if index <= self._snapshot_index:
                    return self._snapshot_index
                term = self._term_at(index)
                state = self.fsm.snapshot()
                # membership rides the snapshot (hashicorp/raft stores the
                # configuration in snapshot meta): a follower caught up via
                # InstallSnapshot must learn peers whose PEER_ADD entries
                # were compacted away
                config = self._config_snapshot_locked()
            # safe off-lock: fsm.snapshot() is a point-in-time store copy
            # whose rows later applies never mutate in place
            state_blob = _encode_fsm_state(state)
            tmp = None
            if self._snapshot_path is not None:
                tmp = self._snapshot_path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(codec_encode((index, term, state_blob, config)))
                    f.flush()
                    os.fsync(f.fileno())
            with self._lock:
                if index <= self._snapshot_index:
                    if tmp is not None:
                        try:
                            os.remove(tmp)
                        except OSError:
                            pass
                    return self._snapshot_index
                self._snapshot_state = state_blob
                self._snapshot_term = term
                self._snapshot_config = config
                self.log = [e for e in self.log if e[0] > index]
                self._snapshot_index = index
                if tmp is not None:
                    os.replace(tmp, self._snapshot_path)
                if self.store is not None:
                    self.store.truncate_before(index + 1)
                    self.store.sync()
                return index

    def close(self) -> None:
        self._shutdown.set()
        with self._lock:
            self._repl_cv.notify_all()
            self._commit_cv.notify_all()
        for c in self._clients.values():
            c.close()
        # atomic handoff: appenders hold _lock around their
        # `store is not None` check, so they see the store or None,
        # never a closed handle
        with self._lock:
            store, self.store = self.store, None
        if store is not None:
            store.sync()
            store.close()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "WireRaft":
        self._started = True  # race-ok: start() is called once, before any raft thread exists
        # membership-change entries at or below this index are HISTORY:
        # replaying them during catch-up would remove peers that have since
        # rejoined (the live peer set comes from gossip bootstrap). Only
        # entries committed after we started participating apply.
        with self._lock:
            self._config_replay_boundary = self._last_index()
        t = threading.Thread(
            target=self._election_loop, name=f"raft-election-{self.node_id}", daemon=True
        )
        t.start()
        self._threads.append(t)  # race-ok: GIL-atomic append; only read at shutdown
        for peer_id in list(self.peers):
            self._start_replicator(peer_id)
        if not self.peers:
            # single-node cluster: immediate self-election
            with self._lock:
                self._become_leader_locked(self.current_term + 1)
        return self

    def _start_replicator(self, peer_id: str) -> None:
        t = threading.Thread(
            target=self._replicator, args=(peer_id,),
            name=f"raft-repl-{self.node_id}-{peer_id}", daemon=True,
        )
        t.start()
        self._threads.append(t)  # race-ok: GIL-atomic append; only read at shutdown

    def add_peer(self, peer_id: str, addr: Tuple[str, int]) -> None:
        """Gossip-driven peer reconciliation (reference leader.go:859
        addRaftPeer — serf member join → raft configuration). A known peer
        gossiping a NEW address (restart with an ephemeral port) gets its
        connection retargeted."""
        addr = tuple(addr)
        stale_client = None
        with self._lock:
            if peer_id == self.node_id:
                return
            existing = self.peers.get(peer_id)
            if existing == addr:
                return
            self.peers[peer_id] = addr
            if existing is not None:
                # address change: drop the stale connection; the live
                # replicator thread picks up the new address next round
                stale_client = self._clients.pop(peer_id, None)
                new_peer = False
            else:
                new_peer = True
            if self.state == LEADER:
                self.next_index[peer_id] = self._last_index() + 1
                self.match_index.setdefault(peer_id, 0)
            started = self._started
        if stale_client is not None:
            stale_client.close()
        if started and new_peer:
            self._start_replicator(peer_id)

    def remove_peer(self, peer_id: str) -> None:
        """leader.go:952 removeRaftPeer — LOCAL view only. For a
        cluster-wide removal (autopilot dead-server cleanup) use
        remove_peer_replicated, or every node's quorum math diverges."""
        with self._lock:
            self.peers.pop(peer_id, None)
            self.next_index.pop(peer_id, None)
            self.match_index.pop(peer_id, None)
            if peer_id in self.nonvoters:
                self.nonvoters.discard(peer_id)
                self._persist_meta_locked()
            self._staged.pop(peer_id, None)
            client = self._clients.pop(peer_id, None)
        if client is not None:
            client.close()

    PEER_REMOVE = "_raft-peer-remove"
    PEER_ADD = "_raft-peer-add"

    def remove_peer_replicated(self, peer_id: str) -> None:
        """Leader-only: commit the removal through the log so every
        replica shrinks its configuration at the same log position (the
        single-server membership-change protocol)."""
        self.apply(0, self.PEER_REMOVE, peer_id)

    def note_peer_address(self, peer_id: str, addr: Tuple[str, int]) -> None:
        """Gossip address retarget for an ALREADY-CONFIGURED peer (restart
        with an ephemeral port). Never grows the configuration — adds go
        through the log (add_peer_staged)."""
        with self._lock:
            if peer_id not in self.peers:
                return
        self.add_peer(peer_id, addr)

    def add_peer_staged(self, peer_id: str, addr: Tuple[str, int]) -> bool:
        """Leader-only log-replicated peer addition: the peer enters the
        configuration as a NONVOTER (replicated to, excluded from quorum
        and elections) and is promoted to voter once its match index
        reaches the staging point — so a minority partition can never
        grow its own voter set, and an add during a partition commits on
        exactly one side. Returns False when not leader (the caller
        retries after the next leadership change)."""
        addr = tuple(addr)
        with self._lock:
            if peer_id == self.node_id:
                return True
            if self.state != LEADER:
                return False
            if peer_id in self.peers:
                # known peer (voter OR in-flight nonvoter): retarget its
                # address if gossip reports a new one — a staged peer that
                # restarted on a fresh port must still be reachable or it
                # can never catch up and promote
                retarget = self.peers.get(peer_id) != addr
                stage = False
            else:
                retarget = False
                stage = peer_id not in self._staged
        if retarget:
            self.add_peer(peer_id, addr)
        if stage:
            self._apply_async(
                self.PEER_ADD, {"id": peer_id, "addr": list(addr), "voter": False}
            )
        return True

    def _apply_async(self, entry_type: str, payload) -> None:
        """Leader-side append WITHOUT waiting for commit (safe from
        replicator threads, which must not block on their own quorum)."""
        with self._lock:
            if self.state != LEADER:
                return
            index = self._last_index() + 1
            self._append_locked(index, self.current_term, entry_type, payload)
            self.match_index[self.node_id] = index
            self._repl_cv.notify_all()
            if not self._voter_peers():
                self._advance_commit_locked()

    def _voter_peers(self):
        return [p for p in self.peers if p not in self.nonvoters]

    def _config_snapshot_locked(self) -> dict:
        return {
            "peers": {pid: list(addr) for pid, addr in self.peers.items()},
            "nonvoters": sorted(self.nonvoters),
        }

    def _apply_snapshot_config_locked(self, config, voter_overlay: bool = True) -> None:
        """Adopt the membership carried by an installed snapshot.

        ``voter_overlay=False`` adopts only the PEER SET (addresses):
        used on local restart, where the persisted meta's voter/nonvoter
        overlay is at least as new as the snapshot's (it is rewritten on
        every membership change) and must not be reverted to the
        snapshot-time view."""
        if not config:
            return
        for pid, addr in (config.get("peers") or {}).items():
            if pid != self.node_id:
                self.add_peer(pid, tuple(addr))
        if voter_overlay:
            nv = set(config.get("nonvoters") or [])
            self._self_nonvoter = self.node_id in nv
            self.nonvoters = {p for p in nv if p != self.node_id}
            self._persist_meta_locked()

    # -- persistence -----------------------------------------------------

    def _load_persistent(self) -> None:
        if self._meta_path and os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.current_term = meta.get("term", 0)
            self.voted_for = meta.get("voted_for")
            # voter/nonvoter overlay survives restarts (the replicated
            # config entries are replay-skipped behind the boundary, so
            # without this a restarted node would forget who is staged
            # — and a restarted nonvoter would campaign)
            self.nonvoters = set(meta.get("nonvoters", []))
            self._self_nonvoter = bool(meta.get("self_nonvoter", False))
        if self._snapshot_path and os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                record = _decode_disk_blob(f.read())
            if len(record) == 4:
                index, term, state_blob, snap_config = record
            else:  # pre-membership-snapshot format
                index, term, state_blob = record
                snap_config = None
            try:
                codec_decode(state_blob)
            except Exception:  # noqa: BLE001 — legacy pickled StateStore:
                # normalize now so restore and InstallSnapshot only ever
                # see codec bytes
                import pickle

                state_blob = _encode_fsm_state(pickle.loads(state_blob))
            self._snapshot_index = index
            self._snapshot_term = term
            self._snapshot_state = state_blob
            self._snapshot_config = snap_config
            if snap_config:
                # peers only: the meta overlay loaded above is newer than
                # the snapshot-time voter/nonvoter view
                self._apply_snapshot_config_locked(snap_config,
                                                   voter_overlay=False)
        if self.store is not None:
            first, last = self.store.first_index, self.store.last_index
            for index in range(max(first, self._snapshot_index + 1), last + 1):
                blob = self.store.get(index)
                if blob is None:
                    continue
                term, entry_type, payload = _decode_disk_blob(blob)
                self.log.append((index, term, entry_type, payload))

    def _persist_meta_locked(self) -> None:
        if self._meta_path is None:
            return
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "term": self.current_term, "voted_for": self.voted_for,
                "nonvoters": sorted(self.nonvoters),
                "self_nonvoter": self._self_nonvoter,
            }, f)
        os.replace(tmp, self._meta_path)

    def _append_locked(self, index: int, term: int, entry_type: str, payload) -> None:
        self.log.append((index, term, entry_type, payload))
        if self.store is not None:
            self.store.append(
                index,
                codec_encode((term, entry_type, payload)),
                sync=self.config.sync_writes,
            )

    # -- log helpers (hold lock) -----------------------------------------

    def _last_index(self) -> int:
        return self.log[-1][0] if self.log else self._snapshot_index

    def _last_term(self) -> int:
        return self.log[-1][1] if self.log else self._snapshot_term

    def _term_at(self, index: int) -> int:
        if index == self._snapshot_index:
            return self._snapshot_term
        if index == 0:
            return 0
        pos = index - self._snapshot_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos][1]
        return -1  # unknown (compacted or beyond tail)

    def _entries_from(self, index: int, limit: int = 512):
        pos = index - self._snapshot_index - 1
        if pos < 0:
            return None  # compacted — needs snapshot
        return self.log[pos:pos + limit]

    # -- roles -----------------------------------------------------------

    def _random_deadline(self) -> float:
        return time.monotonic() + random.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _notify_leadership(self, gained: bool) -> None:
        for observer in list(self.leadership_observers):
            try:
                observer(0, gained)
            except Exception:  # noqa: BLE001
                self.logger.exception("leadership observer failed")

    def _step_down_locked(self, term: int) -> None:
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_meta_locked()
        self._election_deadline = self._random_deadline()
        if was_leader:
            self._was_leader = False
            self._commit_cv.notify_all()
            threading.Thread(
                target=self._notify_leadership, args=(False,), daemon=True
            ).start()

    def _become_leader_locked(self, term: int) -> None:
        self.state = LEADER
        self.current_term = term
        self.leader_id = self.node_id
        last = self._last_index()
        for peer_id in self.peers:
            self.next_index[peer_id] = last + 1
            self.match_index[peer_id] = 0
        self.match_index[self.node_id] = last
        # staging bookkeeping is leader-local: a new leader re-stages any
        # nonvoters it inherited from the replicated config so their
        # promotion still happens
        for peer_id in self.nonvoters:
            self._staged[peer_id] = last
        self._persist_meta_locked()
        self._was_leader = True
        # a no-op barrier entry lets the new leader commit entries from
        # prior terms (raft §5.4.2 — only current-term entries count
        # toward commit)
        self._append_locked(last + 1, term, "_raft-barrier", None)
        self.match_index[self.node_id] = last + 1
        self._repl_cv.notify_all()
        if not self.peers:
            self._advance_commit_locked()
        threading.Thread(target=self._notify_leadership_after_barrier, args=(term, last + 1),
                         daemon=True).start()

    def _notify_leadership_after_barrier(self, term: int, barrier: int) -> None:
        """Tell the observers of a gained leadership once the barrier
        entry, and with it every entry of earlier terms, is applied to the
        local FSM (Nomad's leaderLoop runs ``raft.Barrier`` before
        ``establishLeadership``, nomad/leader.go). Told at once, the
        server restores its pending evals from a state that may still
        lack a plan the old leader committed, and the same eval places the
        same names a second time. Nothing is told when the leadership of
        ``term`` ends first."""
        with self._lock:
            while self.last_applied < barrier:
                if (self._shutdown.is_set() or self.state != LEADER
                        or self.current_term != term):
                    return
                self._commit_cv.wait(0.1)
            if self.state != LEADER or self.current_term != term:
                return
        self._notify_leadership(True)

    # -- election --------------------------------------------------------

    def _election_loop(self) -> None:
        while not self._shutdown.wait(0.02):
            with self._lock:
                if self.state == LEADER:
                    continue
                if time.monotonic() < self._election_deadline:
                    continue
                if self._self_nonvoter:
                    # staged nonvoters never campaign; the leader promotes
                    # them once caught up
                    self._election_deadline = self._random_deadline()
                    continue
                self._election_deadline = self._random_deadline()
                proposed = self.current_term + 1
                contact = self._last_contact
                pre = (self._last_index(), self._last_term(), self._voter_peers())
            # pre-vote (Raft thesis §9.6): campaign only when a majority
            # would vote, so a server that cannot win (a stale log, or a
            # leader the others still hear) never raises its term and never
            # deposes a working leader
            if not self._pre_vote(proposed, *pre):
                continue
            with self._lock:
                if (self.state == LEADER or self.current_term >= proposed
                        or self._last_contact != contact):
                    continue  # a leader's call or a higher term came meanwhile
                # start an election
                self.state = CANDIDATE
                self.current_term += 1
                term = self.current_term
                self.voted_for = self.node_id
                self._persist_meta_locked()
                self._election_deadline = self._random_deadline()
                last_index = self._last_index()
                last_term = self._last_term()
                voters = self._voter_peers()
            votes = 1
            needed = (len(voters) + 1) // 2 + 1
            for peer_id in list(voters):
                if self._shutdown.is_set():
                    return
                try:
                    r_term, granted = self._client(peer_id).call(
                        "Raft.RequestVote", term, self.node_id, last_index, last_term,
                        no_forward=True,
                    )
                except (RPCError, OSError, ConnectionError):
                    continue
                with self._lock:
                    if r_term > self.current_term:
                        self._step_down_locked(r_term)
                        break
                if granted:
                    votes += 1
            with self._lock:
                if self.state == CANDIDATE and self.current_term == term and votes >= needed:
                    self._become_leader_locked(term)

    def _pre_vote(self, term: int, last_index: int, last_term: int, voters) -> bool:
        """Would a majority vote for this server at ``term``? Asks each
        voter ``Raft.PreVote``; changes no state but to adopt a higher term
        a peer reports."""
        votes, needed = 1, (len(voters) + 1) // 2 + 1
        for peer_id in list(voters):
            if votes >= needed or self._shutdown.is_set():
                break
            try:
                r_term, granted = self._client(peer_id).call(
                    "Raft.PreVote", term, self.node_id, last_index, last_term,
                    no_forward=True,
                )
            except (RPCError, OSError, ConnectionError):
                continue
            with self._lock:
                if r_term > self.current_term:
                    self._step_down_locked(r_term)
                    return False
            if granted:
                votes += 1
        return votes >= needed

    def _handle_pre_vote(self, term, candidate_id, last_log_index, last_log_term):
        """``Raft.PreVote``: whether this server would grant
        ``candidate_id`` a vote at ``term`` (a term above its own, no live
        leader it knows of, a log at least as new as its own). Changes
        nothing."""
        with self._lock:
            if term <= self.current_term or self._leader_alive_locked(candidate_id):
                return [self.current_term, False]
            up_to_date = (last_log_term, last_log_index) >= (
                self._last_term(), self._last_index()
            )
            return [self.current_term, bool(up_to_date)]

    def _handle_request_vote(self, term, candidate_id, last_log_index, last_log_term):
        with self._lock:
            if term < self.current_term:
                return [self.current_term, False]
            if self._leader_alive_locked(candidate_id):
                # a server that knows a live leader neither grants nor
                # takes the candidate's term (Raft §6, "disruptive
                # servers"; hashicorp/raft rejects a vote while it has a
                # leader): a rejoining node that timed out would
                # otherwise depose a working leader, and again each time
                # it is slow to take the next heartbeat
                return [self.current_term, False]
            if term > self.current_term:
                self._step_down_locked(term)
            up_to_date = (last_log_term, last_log_index) >= (
                self._last_term(), self._last_index()
            )
            if up_to_date and self.voted_for in (None, candidate_id):
                self.voted_for = candidate_id
                self._persist_meta_locked()
                self._election_deadline = self._random_deadline()
                return [self.current_term, True]
            return [self.current_term, False]

    def _leader_alive_locked(self, candidate_id: str) -> bool:
        """This server leads, or heard from a leader other than the
        candidate within the minimum election timeout."""
        if self.state == LEADER:
            return candidate_id != self.node_id
        return (
            self.leader_id is not None
            and self.leader_id != candidate_id
            and time.monotonic() - self._last_contact < self.config.election_timeout_min
        )

    def _heard_from_leader_locked(self, term: int) -> None:
        """A call of the current term's leader has been handled: the
        election timer starts from its end, as hashicorp/raft sets its
        last contact once the call is done. A follower that spent longer
        than the election timeout installing a snapshot or applying
        entries must not campaign against the leader that sent them."""
        if term == self.current_term and self.state == FOLLOWER:
            self._election_deadline = self._random_deadline()
            self._last_contact = time.monotonic()

    # -- replication (leader side) ---------------------------------------

    def _client(self, peer_id: str) -> RPCClient:
        c = self._clients.get(peer_id)
        if c is None:
            host, port = self.peers[peer_id]
            c = self._clients[peer_id] = RPCClient(  # race-ok: idempotent cache fill; worst case a duplicate client is dropped
                host, port, timeout=self.config.rpc_timeout,
                tls=getattr(self.rpc, "tls", None),
            )
        return c

    def _replicator(self, peer_id: str) -> None:
        """Per-peer loop: push entries whenever we lead and the peer lags;
        otherwise heartbeat on the interval."""
        while not self._shutdown.is_set():
            with self._lock:
                self._repl_cv.wait(self.config.heartbeat_interval)
                if peer_id not in self.peers:
                    return  # removed via remove_peer
                if self.state != LEADER:
                    continue
                term = self.current_term
            try:
                self._replicate_once(peer_id, term)
            except (RPCError, OSError, ConnectionError):
                continue
            except Exception:  # noqa: BLE001
                self.logger.exception("replication to %s failed", peer_id)

    def _replicate_once(self, peer_id: str, term: int) -> None:
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                return
            next_idx = self.next_index.get(peer_id, self._last_index() + 1)
            prev_index = next_idx - 1
            prev_term = self._term_at(prev_index)
            entries = self._entries_from(next_idx)
            commit = self.commit_index
            if entries is None or prev_term < 0:
                # peer needs entries we compacted — install snapshot
                snap_index = self._snapshot_index
                snap_term = self._snapshot_term
                snap_state = self._snapshot_state
                snap_config = self._snapshot_config
                send_snapshot = True
            else:
                send_snapshot = False
                wire_entries = [list(e) for e in entries]
        if send_snapshot:
            if snap_state is None:
                return
            r_term = self._client(peer_id).call(
                "Raft.InstallSnapshot", term, self.node_id,
                snap_index, snap_term, snap_state, snap_config,
                no_forward=True,
            )
            with self._lock:
                if r_term > self.current_term:
                    self._step_down_locked(r_term)
                    return
                self.next_index[peer_id] = snap_index + 1
                self.match_index[peer_id] = max(
                    self.match_index.get(peer_id, 0), snap_index
                )
                self._advance_commit_locked()
            return
        r_term, success, match = self._client(peer_id).call(
            "Raft.AppendEntries", term, self.node_id,
            prev_index, prev_term, wire_entries, commit, no_forward=True,
        )
        with self._lock:
            if r_term > self.current_term:
                self._step_down_locked(r_term)
                return
            if self.state != LEADER or self.current_term != term:
                return
            if success:
                self.match_index[peer_id] = max(
                    self.match_index.get(peer_id, 0), match
                )
                self.next_index[peer_id] = self.match_index[peer_id] + 1
                self._advance_commit_locked()
                # staged nonvoter caught up -> promote to voter through
                # the log (async append; RLock makes this re-entrant)
                target = self._staged.get(peer_id)
                if target is not None and self.match_index[peer_id] >= target:
                    self._staged.pop(peer_id, None)
                    addr = self.peers.get(peer_id)
                    if addr is not None:
                        self._apply_async(self.PEER_ADD, {
                            "id": peer_id, "addr": list(addr), "voter": True,
                        })
                if self.next_index[peer_id] <= self._last_index():
                    self._repl_cv.notify_all()  # more to send
            else:
                # consistency check failed: the hint is the peer's last
                # index (back up past gaps) or its snapshot boundary (jump
                # FORWARD — everything at or below it is committed there)
                if match + 1 > next_idx:
                    self.next_index[peer_id] = match + 1
                else:
                    self.next_index[peer_id] = max(1, min(next_idx - 1, match + 1))
                self._repl_cv.notify_all()

    def _advance_commit_locked(self) -> None:
        """Commit = highest index replicated on a VOTER quorum, current
        term only (nonvoters receive entries but never count)."""
        voters = self._voter_peers()
        cluster = len(voters) + 1
        needed = cluster // 2 + 1
        voter_set = set(voters) | {self.node_id}
        for index in range(self._last_index(), self.commit_index, -1):
            if self._term_at(index) != self.current_term:
                break
            count = sum(
                1 for p, m in self.match_index.items()
                if m >= index and p in voter_set
            )
            if count >= needed:
                self.commit_index = index
                break
        self._apply_committed_locked()

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entries_from(self.last_applied, 1)
            if not entry:
                # entry not present (should be unreachable): roll back the
                # counter so the index is retried rather than silently
                # skipped — skipping would diverge the FSM from the log
                self.last_applied -= 1
                break
            index, term, entry_type, payload = entry[0]
            if entry_type == self.PEER_REMOVE:
                boundary = getattr(self, "_config_replay_boundary", 0)
                if payload != self.node_id and index > boundary:
                    # RLock: safe to re-enter remove_peer while applying
                    self.remove_peer(payload)
                if self.state == LEADER:
                    self._apply_results[index] = None
                continue
            if entry_type == self.PEER_ADD:
                boundary = getattr(self, "_config_replay_boundary", 0)
                # entries about SELF always apply (in order, latest wins):
                # a fresh joiner's own PEER_ADD sits at/below its replay
                # boundary, and skipping it would leave the staged
                # nonvoter thinking it may campaign
                if index > boundary or payload.get("id") == self.node_id:
                    pid = payload["id"]
                    voter = bool(payload.get("voter"))
                    if pid == self.node_id:
                        # we're the subject: learn our own voter status
                        self._self_nonvoter = not voter
                    else:
                        self.add_peer(pid, tuple(payload.get("addr") or ()))
                        if voter:
                            self.nonvoters.discard(pid)
                            self._staged.pop(pid, None)
                        else:
                            self.nonvoters.add(pid)
                            if self.state == LEADER:
                                # promote once the peer catches up to HERE
                                self._staged[pid] = index
                    self._persist_meta_locked()
                if self.state == LEADER:
                    self._apply_results[index] = None
                continue
            if entry_type != "_raft-barrier" and self.fsm is not None:
                try:
                    result = self.fsm.apply(index, entry_type, payload)
                except Exception as e:  # noqa: BLE001
                    self.logger.exception("FSM apply failed at %d", index)
                    result = e
                if self.state == LEADER:
                    self._apply_results[index] = result
        self._commit_cv.notify_all()

    # -- follower side ---------------------------------------------------

    def _handle_append_entries(
        self, term, leader_id, prev_index, prev_term, entries, leader_commit
    ):
        with self._lock:
            try:
                return self._append_entries_locked(
                    term, leader_id, prev_index, prev_term, entries, leader_commit)
            finally:
                self._heard_from_leader_locked(term)

    def _append_entries_locked(
        self, term, leader_id, prev_index, prev_term, entries, leader_commit
    ):
        if term < self.current_term:
            return [self.current_term, False, self._last_index()]
        if term > self.current_term or self.state != FOLLOWER:
            self._step_down_locked(term)
        self.leader_id = leader_id
        self._election_deadline = self._random_deadline()
        self._last_contact = time.monotonic()
        # a FRESH node (empty log, no snapshot) joining an established
        # cluster: everything already committed is pre-join history —
        # its peer set came from gossip bootstrap, so historical
        # PEER_REMOVE entries must not apply (the removed peer may
        # have long since rejoined)
        if (
            self._config_replay_boundary == 0
            and self._snapshot_index == 0
            and not self.log
        ):
            self._config_replay_boundary = leader_commit
        # prev below the snapshot boundary: the overlap is committed by
        # definition, but our term knowledge was compacted — hint the
        # snapshot index so the leader advances next_index past it (or
        # falls back to InstallSnapshot) instead of backing up forever
        if 0 < prev_index < self._snapshot_index:
            return [self.current_term, False, self._snapshot_index]
        # consistency check
        if prev_index > 0 and self._term_at(prev_index) != prev_term:
            return [self.current_term, False, min(self._last_index(), prev_index - 1)]
        for e in entries:
            index, e_term, entry_type, payload = e
            if index <= self._snapshot_index:
                # covered by the snapshot — committed by definition;
                # entering the truncation path here would compute a
                # negative slice position and wipe the whole tail
                continue
            existing = self._term_at(index)
            if existing == e_term:
                continue  # already have it
            if existing != -1 or index <= self._last_index():
                # conflict: truncate from here
                pos = index - self._snapshot_index - 1
                self.log = self.log[:max(pos, 0)]
                if self.store is not None:
                    self.store.truncate_after(index)
            if index == self._last_index() + 1:
                self._append_locked(index, e_term, entry_type, payload)
            else:
                # gap (shouldn't happen): reject so the leader backs up
                return [self.current_term, False, self._last_index()]
        if leader_commit > self.commit_index:
            self.commit_index = min(leader_commit, self._last_index())
            self._apply_committed_locked()
        return [self.current_term, True, self._last_index()]

    def _handle_install_snapshot(self, term, leader_id, last_index, last_term,
                                 state_blob, config=None):
        with self._lock:
            try:
                return self._install_snapshot_locked(term, leader_id, last_index, last_term,
                                                     state_blob, config)
            finally:
                self._heard_from_leader_locked(term)

    def _install_snapshot_locked(self, term, leader_id, last_index, last_term,
                                 state_blob, config):
        if term < self.current_term:
            return self.current_term
        self._step_down_locked(term)
        self.leader_id = leader_id
        self._election_deadline = self._random_deadline()
        self._last_contact = time.monotonic()
        if last_index <= self._snapshot_index:
            return self.current_term
        if self._config_replay_boundary == 0:
            # snapshot install = joining established history (see
            # append-entries fresh-node boundary)
            self._config_replay_boundary = last_index
        self._snapshot_index = last_index
        self._snapshot_term = last_term
        self._snapshot_state = state_blob
        self._snapshot_config = config
        # membership as of the snapshot: peers whose PEER_ADD entries
        # were compacted arrive here
        self._apply_snapshot_config_locked(config)
        self.log = [e for e in self.log if e[0] > last_index]
        if self._snapshot_path is not None:
            # fsync before replace: the log truncation below discards
            # the entries this snapshot supersedes, so the snapshot
            # must be durable first or a crash loses committed state
            tmp = self._snapshot_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(codec_encode(
                    (last_index, last_term, state_blob, config)
                ))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snapshot_path)
        if self.store is not None:
            self.store.truncate_before(last_index + 1)
            self.store.sync()
        if self.fsm is not None:
            self.fsm.restore(_decode_fsm_state(state_blob))
        self.last_applied = last_index
        self.commit_index = max(self.commit_index, last_index)
        self._snapshots_installed += 1
        return self.current_term

    # -- introspection ---------------------------------------------------

    def last_contact_age_s(self) -> float:
        """Seconds since the last leader contact (AppendEntries /
        InstallSnapshot) — the follower_lag measure stale reads stamp
        into QueryMeta. 0 while leading (we ARE the contact)."""
        with self._lock:
            if self.state == LEADER:
                return 0.0
            return max(time.monotonic() - self._last_contact, 0.0)

    def stats(self, peer: int = 0) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "term": self.current_term,
                "leader_id": self.leader_id,
                "last_index": self._last_index(),
                "commit_index": self.commit_index,
                "applied_index": self.last_applied,
                "num_peers": len(self.peers),
                "snapshot_index": self._snapshot_index,
                "snapshots_installed": self._snapshots_installed,
                "last_contact_age_s": (
                    0.0 if self.state == LEADER
                    else max(time.monotonic() - self._last_contact, 0.0)
                ),
            }
