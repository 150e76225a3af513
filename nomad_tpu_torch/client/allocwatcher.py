"""Previous-allocation watcher + ephemeral disk migrator.

Fills the role of reference ``client/allocwatcher`` (prevAllocWatcher,
prevAllocMigrator, remotePrevAlloc): before a replacement allocation
starts, block until its ``previous_allocation`` reaches a terminal client
state, then — when the task group's ephemeral disk asks for it — carry the
old alloc's shared ``alloc/data`` over:

- previous alloc on THIS node → move (sticky) or copy the directory tree
  locally (allocwatcher localPrevAlloc);
- previous alloc on ANOTHER node → fetch the tree through the remote
  node's alloc FS API (the reference streams a tar over the FS RPC;
  this walks ls/cat over the same endpoints).

Copied from ``nomad_tpu/client/allocwatcher.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.allocwatcher``.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
import urllib.parse
import urllib.request
from typing import Callable, Optional

logger = logging.getLogger("nomad_tpu_torch.allocwatcher")

TERMINAL_CLIENT_STATUSES = ("complete", "failed", "lost")


class PrevAllocWatcher:
    """One watcher per replacement alloc (config.go NewAllocWatcher)."""

    def __init__(
        self,
        alloc,
        prev_alloc_id: str,
        local_runner_lookup: Callable[[str], Optional[object]],
        alloc_dir_base: str,
        remote_alloc_info: Optional[Callable[[str], Optional[dict]]] = None,
        poll_interval: float = 0.2,
        timeout: float = 300.0,
        auth_token: str = "",
        tls=None,  # rpc.transport.TLSConfig for https node addresses
    ) -> None:
        self.alloc = alloc
        self.prev_alloc_id = prev_alloc_id
        self.local_runner_lookup = local_runner_lookup
        self.alloc_dir_base = alloc_dir_base
        self.remote_alloc_info = remote_alloc_info
        self.poll_interval = poll_interval
        self.timeout = timeout
        self.auth_token = auth_token
        self.tls = tls

    # -- the prerun hook --------------------------------------------------

    def wait_and_migrate(self) -> None:
        tg = (
            self.alloc.job.lookup_task_group(self.alloc.task_group)
            if self.alloc.job
            else None
        )
        disk = tg.ephemeral_disk if tg is not None else None
        terminal = self._wait_terminal()
        if not terminal:
            # the previous alloc may still be writing; moving its data out
            # from under it would corrupt both sides — skip migration
            logger.warning(
                "previous alloc %s never went terminal; skipping disk migration",
                self.prev_alloc_id,
            )
            return
        if disk is not None and (disk.migrate or disk.sticky):
            try:
                self._migrate(move=disk.sticky and not disk.migrate)
            except Exception as e:  # noqa: BLE001 — data move is best-effort
                logger.warning(
                    "ephemeral disk migration from %s failed: %s",
                    self.prev_alloc_id, e,
                )

    # -- waiting ----------------------------------------------------------

    def _wait_terminal(self) -> bool:
        """True once the previous alloc is safely terminal (or gone)."""
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            runner = self.local_runner_lookup(self.prev_alloc_id)
            if runner is not None:
                status = runner.client_status()
                if status in TERMINAL_CLIENT_STATUSES:
                    return True
            else:
                info = (
                    self.remote_alloc_info(self.prev_alloc_id)
                    if self.remote_alloc_info is not None
                    else None
                )
                if info is None:
                    return True  # previous alloc GC'd / unknown: don't block
                if info.get("client_status") in TERMINAL_CLIENT_STATUSES:
                    return True
            time.sleep(self.poll_interval)
        logger.warning(
            "gave up waiting on previous alloc %s after %.0fs",
            self.prev_alloc_id, self.timeout,
        )
        return False

    # -- migration --------------------------------------------------------

    def _migrate(self, move: bool) -> None:
        dest = os.path.join(self.alloc_dir_base, self.alloc.id, "alloc", "data")
        prev_local = os.path.join(
            self.alloc_dir_base, self.prev_alloc_id, "alloc", "data"
        )
        if os.path.isdir(prev_local):
            self._migrate_local(prev_local, dest, move)
            return
        info = (
            self.remote_alloc_info(self.prev_alloc_id)
            if self.remote_alloc_info is not None
            else None
        )
        http_addr = (info or {}).get("node_http_addr")
        if http_addr:
            self._migrate_remote(http_addr, dest)

    @staticmethod
    def _migrate_local(src: str, dest: str, move: bool) -> None:
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if os.path.isdir(dest):
            shutil.rmtree(dest)
        if move:
            shutil.move(src, dest)
            os.makedirs(src, exist_ok=True)  # old dir keeps a valid layout
        else:
            shutil.copytree(src, dest)

    def _migrate_remote(self, http_addr: str, dest: str) -> None:
        """Pull alloc/data through the remote node's FS API
        (remotePrevAlloc migrate; reference streams a snapshot tar)."""
        os.makedirs(dest, exist_ok=True)

        def fetch(rel: str, into: str) -> None:
            entries = self._remote_json(
                http_addr, f"/v1/client/fs/ls/{self.prev_alloc_id}",
                {"path": rel},
            )
            for e in entries or []:
                sub_rel = f"{rel.rstrip('/')}/{e['Name']}"
                target = os.path.join(into, e["Name"])
                if e.get("IsDir"):
                    os.makedirs(target, exist_ok=True)
                    fetch(sub_rel, target)
                else:
                    data = self._remote_raw(
                        http_addr, f"/v1/client/fs/cat/{self.prev_alloc_id}",
                        {"path": sub_rel},
                    )
                    with open(target, "wb") as f:
                        f.write(data)
                    mode = e.get("FileMode")
                    if mode:
                        try:
                            os.chmod(target, int(str(mode), 0) & 0o777)
                        except (ValueError, OSError):
                            pass

        fetch("/alloc/data", dest)

    def _remote_raw(self, http_addr: str, path: str, params: dict) -> bytes:
        base = http_addr if "://" in http_addr else f"http://{http_addr}"
        url = f"{base}{path}?{urllib.parse.urlencode(params)}"
        req = urllib.request.Request(url)
        if self.auth_token:
            req.add_header("X-Nomad-Token", self.auth_token)
        ctx = None
        if url.startswith("https://") and self.tls is not None:
            ctx = self.tls.http_client_context()
        with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
            return resp.read()

    def _remote_json(self, http_addr: str, path: str, params: dict):
        return json.loads(self._remote_raw(http_addr, path, params) or b"null")
