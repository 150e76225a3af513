"""Allocation directory tree.

Fills the role of reference ``client/allocdir/`` (alloc_dir.go, task_dir.go):
every allocation gets ``<state_dir>/<alloc_id>/`` containing a shared
``alloc/`` dir (``data/ logs/ tmp/``) and one dir per task with
``local/ secrets/ tmp/``. The chroot-embedding half of the reference
(fs_linux.go) belongs to the isolating executor, not here.

Copied from ``nomad_tpu/client/allocdir.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List

SHARED_ALLOC_DIR = "alloc"
SHARED_SUBDIRS = ("data", "logs", "tmp")
TASK_LOCAL = "local"
TASK_SECRETS = "secrets"
TASK_TMP = "tmp"


@dataclass
class TaskDir:
    """Plain path bundle so it serializes across the driver-plugin
    boundary (the reference's driver.proto carries dir paths as strings)."""

    dir: str = ""
    shared_alloc_dir: str = ""
    local_dir: str = ""
    secrets_dir: str = ""
    tmp_dir: str = ""
    log_dir: str = ""

    @classmethod
    def create(cls, alloc_dir: str, task_name: str) -> "TaskDir":
        d = os.path.join(alloc_dir, task_name)
        shared = os.path.join(alloc_dir, SHARED_ALLOC_DIR)
        return cls(
            dir=d,
            shared_alloc_dir=shared,
            local_dir=os.path.join(d, TASK_LOCAL),
            secrets_dir=os.path.join(d, TASK_SECRETS),
            tmp_dir=os.path.join(d, TASK_TMP),
            log_dir=os.path.join(shared, "logs"),
        )

    def build(self) -> None:
        for d in (self.dir, self.local_dir, self.tmp_dir):
            os.makedirs(d, exist_ok=True)
        # secrets: mode 0700, wiped on destroy
        os.makedirs(self.secrets_dir, exist_ok=True)
        os.chmod(self.secrets_dir, 0o700)


class AllocDir:
    """Directory layout for one allocation (alloc_dir.go:AllocDir)."""

    def __init__(self, base_dir: str, alloc_id: str) -> None:
        self.alloc_id = alloc_id
        self.alloc_dir = os.path.join(base_dir, alloc_id)
        self.shared_dir = os.path.join(self.alloc_dir, SHARED_ALLOC_DIR)
        self.task_dirs: Dict[str, TaskDir] = {}

    def new_task_dir(self, task_name: str) -> TaskDir:
        td = TaskDir.create(self.alloc_dir, task_name)
        self.task_dirs[task_name] = td
        return td

    def build(self) -> None:
        os.makedirs(self.alloc_dir, exist_ok=True)
        for sub in SHARED_SUBDIRS:
            os.makedirs(os.path.join(self.shared_dir, sub), exist_ok=True)

    def destroy(self) -> None:
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    def list_files(self, rel: str = "") -> List[str]:
        root = os.path.join(self.alloc_dir, rel)
        out = []
        for dirpath, _, files in os.walk(root):
            for f in files:
                out.append(os.path.relpath(os.path.join(dirpath, f), self.alloc_dir))
        return sorted(out)
