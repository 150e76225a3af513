"""Job admission mutators (reference nomad/job_endpoint_hook_connect.go).

``job_connect_hook`` realizes groupConnectHook (:99): every group service
with a Consul Connect sidecar stanza gets a sidecar proxy task injected
into its task group (unless one already exists) plus a dynamic proxy port
on the group network. Runs at Job.Register admission, before the job hits
raft, so schedulers and clients only ever see the expanded job.

Copied from ``nomad_tpu/server/job_hooks.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

from typing import List, Optional

from ..structs.structs import (
    CONNECT_PROXY_PREFIX,
    NetworkResource,
    Port,
    Resources,
    Service,
    Task,
    TaskGroup,
)


def sidecar_task_name(service_name: str) -> str:
    return f"{CONNECT_PROXY_PREFIX}-{service_name}"


def sidecar_kind(service_name: str) -> str:
    return f"{CONNECT_PROXY_PREFIX}:{service_name}"


def _get_sidecar_task(tg: TaskGroup, service_name: str) -> Optional[Task]:
    kind = sidecar_kind(service_name)
    for t in tg.tasks:
        if getattr(t, "kind", "") == kind:
            return t
    return None


def _new_connect_task(service: Service) -> Task:
    """newConnectTask (:150): the default Envoy sidecar. The
    ``sidecar_task`` stanza overrides driver/config/resources — which is
    also how non-docker environments run a stand-in proxy."""
    task = Task(
        name=sidecar_task_name(service.name),
        driver="docker",
        config={
            "image": "envoyproxy/envoy:v1.11.2@sha256:a7769160c9c1a55bb8d07a3b71ce5d64f72b1f665f10d81aa1581bc3cf850d09",
            "args": [
                "-c", "${NOMAD_SECRETS_DIR}/envoy_bootstrap.json",
                "-l", "${meta.connect.log_level}",
            ],
        },
        resources=Resources(cpu=250, memory_mb=128),
    )
    task.kind = sidecar_kind(service.name)
    return task


def group_connect_validate(tg: TaskGroup) -> None:
    """groupConnectValidate (:171): sidecars need exactly one group
    network to attach the proxy port to."""
    for s in tg.services:
        if s.has_sidecar():
            if len(tg.networks) != 1:
                raise ValueError(
                    "Consul Connect sidecars require exactly 1 network, "
                    f"found {len(tg.networks)} in group {tg.name!r}"
                )
            break


def group_connect_hook(tg: TaskGroup) -> None:
    """groupConnectHook (:99): inject the sidecar task + proxy port."""
    for service in tg.services:
        if not service.has_sidecar():
            continue
        task = _get_sidecar_task(tg, service.name)
        if task is None:
            task = _new_connect_task(service)
            # merge the user's sidecar_task overrides (SidecarTask
            # MergeIntoTask)
            override = (service.connect or {}).get("sidecar_task") or {}
            if override.get("name"):
                task.name = override["name"]
            if override.get("driver"):
                task.driver = override["driver"]
            if override.get("config") is not None:
                task.config = dict(override["config"])
            if override.get("resources") is not None:
                res = override["resources"]
                task.resources = Resources(
                    cpu=res.get("cpu", 250),
                    memory_mb=res.get("memory_mb", 128),
                )
            if any(t.name == task.name for t in tg.tasks):
                from ..structs.structs import generate_uuid

                task.name = f"{task.name}-{generate_uuid()[:6]}"
            tg.tasks.append(task)

        # the sidecar proxy listens on a dynamic group port
        port_label = f"{CONNECT_PROXY_PREFIX}-{service.name}"
        net = tg.networks[0]
        if not any(p.label == port_label for p in net.dynamic_ports):
            net.dynamic_ports.append(Port(label=port_label))


def job_connect_hook(job) -> None:
    """jobConnectHook.Mutate (:55) + Validate: expand every task group."""
    for tg in job.task_groups:
        if not any(s.has_sidecar() for s in tg.services):
            continue
        group_connect_validate(tg)
        group_connect_hook(tg)
