"""Task environment builder.

Fills the role of reference ``client/taskenv/env.go``: assembles the
``NOMAD_*`` environment for a task plus attribute/meta interpolation of
``${...}`` references in task config values (taskenv is also what the
scheduler-side constraint resolver mirrors, feasible.go:497 resolveTarget).

Copied from ``nomad_tpu/client/taskenv.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from ..structs.structs import Allocation, Node, Task

_INTERP = re.compile(r"\$\{([^}]+)\}")


class TaskEnvBuilder:
    """Builds env maps (env.go:Builder)."""

    def __init__(
        self,
        node: Optional[Node],
        alloc: Optional[Allocation],
        task: Optional[Task],
        region: str = "global",
    ) -> None:
        self.node = node
        self.alloc = alloc
        self.task = task
        self.region = region
        self.task_dir: str = ""
        self.local_dir: str = ""
        self.secrets_dir: str = ""
        self.alloc_dir: str = ""

    def set_task_dirs(self, task_dir) -> "TaskEnvBuilder":
        self.task_dir = task_dir.dir
        self.local_dir = task_dir.local_dir
        self.secrets_dir = task_dir.secrets_dir
        self.alloc_dir = task_dir.shared_alloc_dir
        return self

    def _base_env(self) -> Dict[str, str]:
        """The NOMAD_* map only — computed without touching user env, so
        ``${env.*}`` resolution can't recurse into interpolation."""
        env: Dict[str, str] = {}
        if self.alloc_dir:
            env["NOMAD_ALLOC_DIR"] = self.alloc_dir
            env["NOMAD_TASK_DIR"] = self.local_dir
            env["NOMAD_SECRETS_DIR"] = self.secrets_dir
        if self.alloc is not None:
            env["NOMAD_ALLOC_ID"] = self.alloc.id
            env["NOMAD_ALLOC_NAME"] = self.alloc.name
            env["NOMAD_ALLOC_INDEX"] = str(self.alloc.index())
            env["NOMAD_GROUP_NAME"] = self.alloc.task_group
            env["NOMAD_JOB_ID"] = self.alloc.job_id
            env["NOMAD_NAMESPACE"] = self.alloc.namespace
            if self.alloc.job is not None:
                env["NOMAD_JOB_NAME"] = self.alloc.job.name
                env["NOMAD_JOB_PARENT_ID"] = self.alloc.job.parent_id
        if self.task is not None:
            env["NOMAD_TASK_NAME"] = self.task.name
            if self.task.resources is not None:
                env["NOMAD_CPU_LIMIT"] = str(self.task.resources.cpu)
                env["NOMAD_MEMORY_LIMIT"] = str(self.task.resources.memory_mb)
        if self.node is not None:
            env["NOMAD_DC"] = self.node.datacenter
            env["NOMAD_REGION"] = self.region
        # job -> group -> task meta, exposed as NOMAD_META_<key>
        if self.alloc is not None and self.alloc.job is not None and self.task is not None:
            meta = self.alloc.job.combined_task_meta(self.alloc.task_group, self.task.name)
            for k, v in meta.items():
                env[f"NOMAD_META_{k}"] = v
                env[f"NOMAD_META_{k.upper()}"] = v
        return env

    def build(self) -> Dict[str, str]:
        env = self._base_env()
        # user-specified env wins, with interpolation against the base map
        if self.task is not None:
            for k, v in self.task.env.items():
                env[k] = self.interpolate(v)
        return env

    # -- ${...} interpolation (env.go ReplaceEnv / feasible.go semantics) --

    def _resolve(self, ref: str) -> Optional[str]:
        if self.node is not None:
            if ref == "node.unique.id":
                return self.node.id
            if ref == "node.unique.name":
                return self.node.name
            if ref == "node.datacenter":
                return self.node.datacenter
            if ref == "node.class":
                return self.node.node_class
            if ref == "node.region":
                return self.region
            if ref.startswith("attr."):
                return self.node.attributes.get(ref[len("attr."):])
            if ref.startswith("meta."):
                return self.node.meta.get(ref[len("meta."):])
        if ref.startswith("env."):
            return self._base_env().get(ref[len("env."):])
        return None

    def interpolate(self, value: str) -> str:
        def sub(m: re.Match) -> str:
            resolved = self._resolve(m.group(1).strip())
            return resolved if resolved is not None else m.group(0)

        return _INTERP.sub(sub, value)
