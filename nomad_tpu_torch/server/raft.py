"""Replicated log abstraction.

Fills the role of the reference's vendored hashicorp/raft + BoltDB store
(nomad/server.go:1079 setupRaft). Two implementations:

- ``InProcRaft``: an in-process log for single-server (dev) mode and for
  multi-server tests — the leader appends entries and applies them to every
  peer FSM synchronously, giving the same linearizable apply order real raft
  provides (without network fault tolerance).
- A C++ consensus core is the planned native substrate for multi-host
  deployments (same ``apply`` contract); the control plane rides DCN, never
  ICI.

Copied from ``nomad_tpu/server/raft.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Callable, List, Optional, Tuple

from .fsm import NomadFSM
from ..utils.lock_witness import witness_lock, witness_rlock


class NotLeaderError(Exception):
    pass


class InProcRaft:
    """Shared log; one elected leader; synchronous replication to peer FSMs.

    With ``data_dir`` set, every entry also lands in the C++ segmented log
    (nomad_tpu/native/log.py over native/nomadlog — the raft-boltdb slot),
    and a restarted process replays it back into the FSM on join. Snapshots
    (``snapshot()``) persist the FSM state and compact the log behind it,
    mirroring fsm.go:1059 Snapshot + log truncation.
    """

    def __init__(self, data_dir: Optional[str] = None, sync_writes: bool = False) -> None:
        self._lock = witness_rlock("raft.InProcRaft._lock")
        # serializes whole snapshot() operations with each other, never
        # with apply(): the durable write happens outside _lock
        self._snap_lock = witness_lock("raft.InProcRaft._snap_lock")
        self.log: List[Tuple[int, str, object]] = []
        self.last_index = 0
        self.fsms: List[NomadFSM] = []
        self.leader_idx: Optional[int] = None
        self.leadership_observers: List[Callable[[int, bool], None]] = []
        self.sync_writes = sync_writes
        self.store = None
        self._snapshot_path = None
        self._snapshot_state: Optional[bytes] = None
        self._snapshot_index = 0
        if data_dir is not None:
            from ..native.log import NativeLog

            os.makedirs(data_dir, exist_ok=True)
            self.store = NativeLog(os.path.join(data_dir, "log"))
            self._snapshot_path = os.path.join(data_dir, "snapshot.bin")
            self._restore_from_store()

    def _restore_from_store(self) -> None:
        """Load the newest snapshot, then replay the durable log tail."""
        snap_index = 0
        if self._snapshot_path and os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                snap_index, self._snapshot_state = pickle.load(f)
        else:
            self._snapshot_state = None
        first, last = self.store.first_index, self.store.last_index
        for index in range(max(first, snap_index + 1), last + 1):
            blob = self.store.get(index)
            if blob is None:
                continue
            entry_type, payload = pickle.loads(blob)
            self.log.append((index, entry_type, payload))
        self.last_index = max(last, snap_index)
        self._snapshot_index = snap_index

    def join(self, fsm: NomadFSM) -> int:
        """Add a server's FSM; returns its peer index. Restores the newest
        snapshot (if any) then replays the log."""
        with self._lock:
            if getattr(self, "_snapshot_state", None) is not None:
                fsm.restore(pickle.loads(self._snapshot_state))
            for index, entry_type, payload in self.log:
                fsm.apply(index, entry_type, payload)
            self.fsms.append(fsm)
            peer = len(self.fsms) - 1
            if self.leader_idx is None:
                self._elect(peer)
            return peer

    def snapshot(self, peer: int) -> int:
        """Persist the peer's FSM state; compact the durable log behind it
        (fsm.go:1059 Snapshot / SnapshotAfter).

        The (state, index) pair is captured atomically under ``_lock`` —
        a snapshot must never claim an index whose mutations it does not
        contain — but serialization and the fsync'd write happen OUTSIDE
        the lock, so concurrent ``apply`` traffic never stalls behind a
        large FSM dump. Installation re-checks under ``_lock`` that no
        newer snapshot landed meanwhile."""
        with self._snap_lock:
            with self._lock:
                if self.store is None or self._snapshot_path is None:
                    return 0
                state = self.fsms[peer].snapshot()
                index = self.last_index
                if index <= self._snapshot_index:
                    return self._snapshot_index
            # safe off-lock: StateStore.snapshot() is a point-in-time copy
            # whose rows are never mutated in place by later applies
            state_blob = pickle.dumps(state)
            blob = pickle.dumps((index, state_blob))
            tmp = self._snapshot_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            with self._lock:
                if self.store is None or index <= self._snapshot_index:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    return self._snapshot_index
                os.replace(tmp, self._snapshot_path)
                self.store.truncate_before(index + 1)
                self.store.sync()
                # compact the in-memory log too, and refresh the cached
                # snapshot state future join() calls restore from
                self._snapshot_state = state_blob
                self.log = [e for e in self.log if e[0] > index]
                self._snapshot_index = index
                return index

    def stats(self, peer: int = 0) -> dict:
        """WireRaft-shaped introspection (Operator.RaftStats)."""
        with self._lock:
            return {
                "state": "leader" if self.leader_idx == peer else "follower",
                "term": 0,
                "leader_id": self.leader_idx,
                "last_index": self.last_index,
                "commit_index": self.last_index,
                "applied_index": self.last_index,
                "num_peers": max(0, len(self.fsms) - 1),
                "snapshot_index": self._snapshot_index,
                "snapshots_installed": 0,
            }

    def close(self) -> None:
        with self._lock:
            store, self.store = self.store, None
        if store is not None:
            store.sync()
            store.close()

    def _elect(self, peer: int) -> None:
        old = self.leader_idx
        self.leader_idx = peer
        for observer in self.leadership_observers:
            observer(peer, True)
            if old is not None:
                observer(old, False)

    def transfer_leadership(self, peer: int) -> None:
        with self._lock:
            if peer >= len(self.fsms):
                raise ValueError(f"unknown peer {peer}")
            old = self.leader_idx
            self.leader_idx = peer
            for observer in self.leadership_observers:
                if old is not None:
                    observer(old, False)
                observer(peer, True)

    def is_leader(self, peer: int) -> bool:
        return self.leader_idx == peer

    def apply(self, peer: int, entry_type: str, payload) -> Tuple[int, object]:
        """Append + replicate + apply; returns (index, leader-FSM response)."""
        with self._lock:
            if self.leader_idx != peer:
                raise NotLeaderError(f"peer {peer} is not the leader")
            self.last_index += 1
            index = self.last_index
            self.log.append((index, entry_type, payload))
            if self.store is not None:
                self.store.append(
                    index, pickle.dumps((entry_type, payload)), sync=self.sync_writes
                )
            response = None
            for i, fsm in enumerate(self.fsms):
                r = fsm.apply(index, entry_type, payload)
                if i == peer:
                    response = r
            return index, response
