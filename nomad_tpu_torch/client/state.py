"""Client-local persistent state for restart recovery.

Fills the role of reference ``client/state/`` (state_database.go over
BoltDB via helper/boltdd): alloc specs and task driver handles survive a
client restart so runners re-attach instead of re-running. SQLite stands in
for BoltDB (both are single-file embedded stores; sqlite3 ships with the
interpreter). The in-memory variant mirrors client/state/memdb.go for tests.

Copied from ``nomad_tpu/client/state.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import json
import os
import pickle
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

from ..structs.structs import Allocation
from .drivers.base import TaskHandle


class StateDB:
    """Interface (client/state/interface.go)."""

    def put_allocation(self, alloc: Allocation) -> None:
        raise NotImplementedError

    def get_all_allocations(self) -> List[Allocation]:
        raise NotImplementedError

    def delete_allocation(self, alloc_id: str) -> None:
        raise NotImplementedError

    def put_task_handle(self, alloc_id: str, task_name: str, handle: TaskHandle) -> None:
        raise NotImplementedError

    def get_task_handles(self, alloc_id: str) -> Dict[str, TaskHandle]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(StateDB):
    """client/state/memdb.go equivalent."""

    def __init__(self) -> None:
        self.allocs: Dict[str, Allocation] = {}
        self.handles: Dict[Tuple[str, str], TaskHandle] = {}

    def put_allocation(self, alloc: Allocation) -> None:
        self.allocs[alloc.id] = alloc

    def get_all_allocations(self) -> List[Allocation]:
        return list(self.allocs.values())

    def delete_allocation(self, alloc_id: str) -> None:
        self.allocs.pop(alloc_id, None)
        for key in [k for k in self.handles if k[0] == alloc_id]:
            del self.handles[key]

    def put_task_handle(self, alloc_id: str, task_name: str, handle: TaskHandle) -> None:
        self.handles[(alloc_id, task_name)] = handle

    def get_task_handles(self, alloc_id: str) -> Dict[str, TaskHandle]:
        return {t: h for (a, t), h in self.handles.items() if a == alloc_id}


class SqliteDB(StateDB):
    """client/state/state_database.go equivalent."""

    def __init__(self, state_dir: str) -> None:
        os.makedirs(state_dir, exist_ok=True)
        self.path = os.path.join(state_dir, "client_state.db")
        self._lock = threading.Lock()
        self._closed = False
        self.db = sqlite3.connect(self.path, check_same_thread=False)
        with self._lock:
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS allocations (id TEXT PRIMARY KEY, data BLOB)"
            )
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS task_handles ("
                "alloc_id TEXT, task_name TEXT, data BLOB,"
                "PRIMARY KEY (alloc_id, task_name))"
            )
            self.db.commit()

    def put_allocation(self, alloc: Allocation) -> None:
        blob = pickle.dumps(alloc)
        with self._lock:
            if self._closed:
                return
            self.db.execute(
                "INSERT OR REPLACE INTO allocations VALUES (?, ?)", (alloc.id, blob)
            )
            self.db.commit()

    def get_all_allocations(self) -> List[Allocation]:
        with self._lock:
            if self._closed:
                return []
            rows = self.db.execute("SELECT data FROM allocations").fetchall()
        return [pickle.loads(r[0]) for r in rows]

    def delete_allocation(self, alloc_id: str) -> None:
        with self._lock:
            if self._closed:
                return
            self.db.execute("DELETE FROM allocations WHERE id = ?", (alloc_id,))
            self.db.execute("DELETE FROM task_handles WHERE alloc_id = ?", (alloc_id,))
            self.db.commit()

    def put_task_handle(self, alloc_id: str, task_name: str, handle: TaskHandle) -> None:
        blob = pickle.dumps(handle)
        with self._lock:
            if self._closed:
                return
            self.db.execute(
                "INSERT OR REPLACE INTO task_handles VALUES (?, ?, ?)",
                (alloc_id, task_name, blob),
            )
            self.db.commit()

    def get_task_handles(self, alloc_id: str) -> Dict[str, TaskHandle]:
        with self._lock:
            if self._closed:
                return {}
            rows = self.db.execute(
                "SELECT task_name, data FROM task_handles WHERE alloc_id = ?",
                (alloc_id,),
            ).fetchall()
        return {name: pickle.loads(blob) for name, blob in rows}

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self.db.close()
