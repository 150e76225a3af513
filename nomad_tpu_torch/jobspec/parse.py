"""Jobspec → structs mapping (reference jobspec/parse.go:27 Parse,
parse_job.go, parse_group.go, parse_task.go, parse_service.go,
parse_network.go).

The reference decodes HCL1 into ``api.Job``; here we map straight onto the
framework's canonical structs (``nomad_tpu_torch.structs``), which the HTTP agent
already converts to/from wire JSON.

Copied from ``nomad_tpu/jobspec/parse.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``. It builds the port's own ``structs.structs``
types, which are the reference's field for field.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..structs.structs import (
    Affinity,
    Constraint,
    EphemeralDisk,
    Job,
    MigrateStrategy,
    NetworkResource,
    ParameterizedJobConfig,
    PeriodicConfig,
    Port,
    RequestedDevice,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    Service,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
    UpdateStrategy,
    VolumeMount,
    VolumeRequest,
)
from .hcl import HCLError, HCLObject, parse as parse_hcl

__all__ = ["parse_job", "parse_file", "parse_duration_ns", "HCLError"]


# ---------------------------------------------------------------------------
# Small decoding helpers
# ---------------------------------------------------------------------------

_DUR_UNITS = {
    "ns": 1,
    "us": 10**3,
    "µs": 10**3,
    "ms": 10**6,
    "s": 10**9,
    "m": 60 * 10**9,
    "h": 3600 * 10**9,
    "d": 24 * 3600 * 10**9,
}


def parse_duration_ns(v: Any) -> int:
    """Go ``time.ParseDuration`` semantics ("1h30m", "10s", "250ms") → ns.

    Bare numbers are treated as nanoseconds, matching mapstructure decoding of
    integers into time.Duration in the reference.
    """
    if isinstance(v, bool):
        raise HCLError(f"invalid duration {v!r}", 0)
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip()
    if not s:
        return 0
    neg = s.startswith("-")
    if neg or s.startswith("+"):
        s = s[1:]
    total = 0.0
    i, n = 0, len(s)
    matched = False
    while i < n:
        j = i
        while j < n and (s[j].isdigit() or s[j] == "."):
            j += 1
        if j == i:
            raise HCLError(f"invalid duration {v!r}", 0)
        num = float(s[i:j])
        k = j
        while k < n and not (s[k].isdigit() or s[k] == "."):
            k += 1
        unit = s[j:k]
        if unit not in _DUR_UNITS:
            raise HCLError(f"unknown duration unit {unit!r} in {v!r}", 0)
        total += num * _DUR_UNITS[unit]
        matched = True
        i = k
    if not matched:
        raise HCLError(f"invalid duration {v!r}", 0)
    return -int(total) if neg else int(total)


def _str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _int(v: Any, what: str) -> int:
    if isinstance(v, bool):
        raise HCLError(f"{what}: expected number, got bool", 0)
    if isinstance(v, (int, float)):
        return int(v)
    try:
        return int(str(v), 0)
    except ValueError:
        raise HCLError(f"{what}: expected number, got {v!r}", 0)


def _bool(v: Any, what: str) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v in ("true", "1"):
            return True
        if v in ("false", "0"):
            return False
    raise HCLError(f"{what}: expected bool, got {v!r}", 0)


def _strmap(obj: Any, what: str) -> Dict[str, str]:
    if obj is None:
        return {}
    if not isinstance(obj, HCLObject):
        raise HCLError(f"{what}: expected a block/map", 0)
    return {k: _str(v) for k, v in obj}


def _plain(v: Any) -> Any:
    if isinstance(v, HCLObject):
        out: Dict[str, Any] = {}
        for k in v.keys():
            vals = [_plain(x) for x in v.get_all(k)]
            out[k] = vals[0] if len(vals) == 1 else vals
        return out
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _labelled_blocks(obj: HCLObject, key: str, what: str) -> List[tuple]:
    """Yield (label, body) for blocks like ``group "name" { ... }``."""
    out = []
    for body in obj.get_all(key):
        if not isinstance(body, HCLObject):
            raise HCLError(f"{what} must be a block", 0)
        if len(body) != 1 or not isinstance(body.items[0][1], HCLObject):
            raise HCLError(f"{what} requires exactly one label", 0)
        out.append(body.items[0])
    return out


# ---------------------------------------------------------------------------
# Constraint / affinity / spread (reference parse.go parseConstraints,
# parseAffinities, parseSpread — including the operator sugar keys)
# ---------------------------------------------------------------------------

_CONSTRAINT_SUGAR = (
    "version",
    "semver",
    "regexp",
    "set_contains",
    "set_contains_any",
    "set_contains_all",
)


def _parse_constraint_like(o: HCLObject, cls, what: str):
    ltarget = _str(o.get("attribute", ""))
    rtarget = _str(o.get("value", ""))
    operand = _str(o.get("operator", "="))
    for sugar in _CONSTRAINT_SUGAR:
        if sugar in o:
            operand = "set_contains" if sugar == "set_contains_all" else sugar
            rtarget = _str(o.get(sugar))
    if "distinct_hosts" in o:
        if not _bool(o.get("distinct_hosts"), what):
            raise HCLError("distinct_hosts should be set to true or not set at all", 0)
        operand = "distinct_hosts"
        ltarget = rtarget = ""
    if "distinct_property" in o:
        operand = "distinct_property"
        ltarget = _str(o.get("distinct_property"))
        rtarget = _str(o.get("value", ""))
    if "is_set" in o or "is_not_set" in o:
        operand = "is_set" if "is_set" in o else "is_not_set"
        rtarget = ""
    if cls is Constraint:
        return Constraint(ltarget=ltarget, rtarget=rtarget, operand=operand)
    return Affinity(
        ltarget=ltarget,
        rtarget=rtarget,
        operand=operand,
        weight=_int(o.get("weight", 50), f"{what}.weight"),
    )


def _parse_constraints(obj: HCLObject) -> List[Constraint]:
    return [
        _parse_constraint_like(o, Constraint, "constraint")
        for o in obj.get_all("constraint")
    ]


def _parse_affinities(obj: HCLObject) -> List[Affinity]:
    return [
        _parse_constraint_like(o, Affinity, "affinity") for o in obj.get_all("affinity")
    ]


def _parse_spreads(obj: HCLObject) -> List[Spread]:
    out: List[Spread] = []
    for o in obj.get_all("spread"):
        targets = [
            SpreadTarget(value=label, percent=_int(body.get("percent", 0), "percent"))
            for label, body in _labelled_blocks(o, "target", "spread target")
        ]
        out.append(
            Spread(
                attribute=_str(o.get("attribute", "")),
                weight=_int(o.get("weight", 50), "spread.weight"),
                spread_target=targets,
            )
        )
    return out


# ---------------------------------------------------------------------------
# Policies / strategies
# ---------------------------------------------------------------------------


def _parse_update(o: HCLObject) -> UpdateStrategy:
    u = UpdateStrategy()
    if "stagger" in o:
        u.stagger_ns = parse_duration_ns(o.get("stagger"))
    if "max_parallel" in o:
        u.max_parallel = _int(o.get("max_parallel"), "update.max_parallel")
    if "health_check" in o:
        u.health_check = _str(o.get("health_check"))
    if "min_healthy_time" in o:
        u.min_healthy_time_ns = parse_duration_ns(o.get("min_healthy_time"))
    if "healthy_deadline" in o:
        u.healthy_deadline_ns = parse_duration_ns(o.get("healthy_deadline"))
    if "progress_deadline" in o:
        u.progress_deadline_ns = parse_duration_ns(o.get("progress_deadline"))
    if "auto_revert" in o:
        u.auto_revert = _bool(o.get("auto_revert"), "update.auto_revert")
    if "auto_promote" in o:
        u.auto_promote = _bool(o.get("auto_promote"), "update.auto_promote")
    if "canary" in o:
        u.canary = _int(o.get("canary"), "update.canary")
    return u


def _parse_restart(o: HCLObject) -> RestartPolicy:
    r = RestartPolicy()
    if "attempts" in o:
        r.attempts = _int(o.get("attempts"), "restart.attempts")
    if "interval" in o:
        r.interval_ns = parse_duration_ns(o.get("interval"))
    if "delay" in o:
        r.delay_ns = parse_duration_ns(o.get("delay"))
    if "mode" in o:
        r.mode = _str(o.get("mode"))
    return r


def _parse_reschedule(o: HCLObject) -> ReschedulePolicy:
    p = ReschedulePolicy()
    if "attempts" in o:
        p.attempts = _int(o.get("attempts"), "reschedule.attempts")
    if "interval" in o:
        p.interval_ns = parse_duration_ns(o.get("interval"))
    if "delay" in o:
        p.delay_ns = parse_duration_ns(o.get("delay"))
    if "delay_function" in o:
        p.delay_function = _str(o.get("delay_function"))
    if "max_delay" in o:
        p.max_delay_ns = parse_duration_ns(o.get("max_delay"))
    if "unlimited" in o:
        p.unlimited = _bool(o.get("unlimited"), "reschedule.unlimited")
    return p


def _parse_migrate(o: HCLObject) -> MigrateStrategy:
    m = MigrateStrategy()
    if "max_parallel" in o:
        m.max_parallel = _int(o.get("max_parallel"), "migrate.max_parallel")
    if "health_check" in o:
        m.health_check = _str(o.get("health_check"))
    if "min_healthy_time" in o:
        m.min_healthy_time_ns = parse_duration_ns(o.get("min_healthy_time"))
    if "healthy_deadline" in o:
        m.healthy_deadline_ns = parse_duration_ns(o.get("healthy_deadline"))
    return m


def _parse_ephemeral_disk(o: HCLObject) -> EphemeralDisk:
    d = EphemeralDisk()
    if "sticky" in o:
        d.sticky = _bool(o.get("sticky"), "ephemeral_disk.sticky")
    if "size" in o:
        d.size_mb = _int(o.get("size"), "ephemeral_disk.size")
    if "migrate" in o:
        d.migrate = _bool(o.get("migrate"), "ephemeral_disk.migrate")
    return d


# ---------------------------------------------------------------------------
# Network / resources / services
# ---------------------------------------------------------------------------


def _parse_ports(o: HCLObject, net: NetworkResource) -> None:
    for label, body in _labelled_blocks(o, "port", "port"):
        static = body.get("static")
        to = _int(body.get("to", 0), "port.to") if "to" in body else 0
        if static is not None:
            net.reserved_ports.append(
                Port(label=label, value=_int(static, "port.static"), to=to)
            )
        else:
            net.dynamic_ports.append(Port(label=label, value=0, to=to))


def _parse_network(o: HCLObject) -> NetworkResource:
    net = NetworkResource()
    if "mode" in o:
        net.mode = _str(o.get("mode"))
    if "mbits" in o:
        net.mbits = _int(o.get("mbits"), "network.mbits")
    _parse_ports(o, net)
    return net


def _parse_device(name: str, o: HCLObject) -> RequestedDevice:
    return RequestedDevice(
        name=name,
        count=_int(o.get("count", 1), "device.count"),
        constraints=_parse_constraints(o),
        affinities=_parse_affinities(o),
    )


def _parse_resources(o: HCLObject) -> Resources:
    res = Resources()
    if "cpu" in o:
        res.cpu = _int(o.get("cpu"), "resources.cpu")
    if "memory" in o:
        res.memory_mb = _int(o.get("memory"), "resources.memory")
    if "disk" in o:
        res.disk_mb = _int(o.get("disk"), "resources.disk")
    for body in o.get_all("network"):
        res.networks.append(_parse_network(body))
    for label, body in _labelled_blocks(o, "device", "device"):
        res.devices.append(_parse_device(label, body))
    return res


def _parse_service(o: HCLObject, task_name: str) -> Service:
    name = _str(o.get("name", ""))
    if not name:
        name = f"${{JOB}}-{task_name}" if task_name else ""
    tags = [_str(t) for t in (o.get("tags") or [])]
    checks = [_plain(body) for body in o.get_all("check")]
    connect = None
    for body in o.get_all("connect"):
        # Consul Connect stanza (reference parse_service.go parseConnect):
        # kept as plain dicts — sidecar_service {port, proxy{...}} and
        # sidecar_task {driver, config{...}, resources{...}}
        connect = {}
        for sidecar in body.get_all("sidecar_service"):
            connect["sidecar_service"] = _plain(sidecar)
        for st in body.get_all("sidecar_task"):
            connect["sidecar_task"] = _plain(st)
        if _bool(body.get("native", False), "connect.native"):
            connect["native"] = True
    return Service(
        name=name, port_label=_str(o.get("port", "")), tags=tags, checks=checks,
        connect=connect,
    )


# ---------------------------------------------------------------------------
# Task / group / job
# ---------------------------------------------------------------------------


def _parse_task(name: str, o: HCLObject) -> Task:
    t = Task(name=name)
    t.driver = _str(o.get("driver", ""))
    t.user = _str(o.get("user", ""))
    if "leader" in o:
        t.leader = _bool(o.get("leader"), "task.leader")
    if "kill_timeout" in o:
        t.kill_timeout_ns = parse_duration_ns(o.get("kill_timeout"))
    if "kill_signal" in o:
        t.kill_signal = _str(o.get("kill_signal"))
    for body in o.get_all("config"):
        cfg = _plain(body)
        if not isinstance(cfg, dict):
            raise HCLError("task config must be a block", 0)
        t.config.update(cfg)
    for body in o.get_all("env"):
        t.env.update(_strmap(body, "env"))
    for body in o.get_all("meta"):
        t.meta.update(_strmap(body, "meta"))
    for body in o.get_all("resources"):
        t.resources = _parse_resources(body)
    t.constraints = _parse_constraints(o)
    t.affinities = _parse_affinities(o)
    for body in o.get_all("service"):
        t.services.append(_parse_service(body, name))
    for body in o.get_all("volume_mount"):
        vm = _plain(body)
        t.volume_mounts.append(VolumeMount(
            volume=vm.get("volume", ""),
            destination=vm.get("destination", ""),
            read_only=bool(vm.get("read_only", False)),
        ))
    for body in o.get_all("artifact"):
        t.artifacts.append(_plain(body))
    for body in o.get_all("template"):
        tpl = _plain(body)
        tpl.setdefault("change_mode", "restart")
        tpl.setdefault("splay", "5s")
        tpl.setdefault("perms", "0644")
        t.templates.append(tpl)
    vault = o.get("vault")
    if vault is not None:
        v = _plain(vault)
        v.setdefault("env", True)
        v.setdefault("change_mode", "restart")
        t.vault = v
    for body in o.get_all("restart"):
        t.restart_policy = _parse_restart(body)
    dp = o.get("dispatch_payload")
    if dp is not None:
        t.dispatch_payload_file = _str(dp.get("file", ""))
    if "logs" in o:
        from ..structs.structs import LogConfig

        logs = _plain(o.get("logs"))
        t.log_config = LogConfig(
            max_files=int(logs.get("max_files", 10)),
            max_file_size_mb=int(logs.get("max_file_size", 10)),
        )
    return t


def _parse_group(name: str, o: HCLObject, job_type: str) -> TaskGroup:
    g = TaskGroup(name=name)
    if "count" in o:
        g.count = _int(o.get("count"), "group.count")
    g.constraints = _parse_constraints(o)
    g.affinities = _parse_affinities(o)
    g.spreads = _parse_spreads(o)
    for body in o.get_all("restart"):
        g.restart_policy = _parse_restart(body)
    for body in o.get_all("reschedule"):
        g.reschedule_policy = _parse_reschedule(body)
    for body in o.get_all("ephemeral_disk"):
        g.ephemeral_disk = _parse_ephemeral_disk(body)
    for body in o.get_all("update"):
        g.update = _parse_update(body)
    for body in o.get_all("migrate"):
        g.migrate = _parse_migrate(body)
    for body in o.get_all("network"):
        g.networks.append(_parse_network(body))
    for label, body in _labelled_blocks(o, "volume", "volume"):
        g.volumes[label] = VolumeRequest(
            name=label,
            type=_str(body.get("type", "host")),
            source=_str(body.get("source", "")),
            read_only=_bool(body.get("read_only", False), "volume.read_only"),
        )
    for body in o.get_all("meta"):
        g.meta.update(_strmap(body, "meta"))
    # GROUP-level services — where Consul Connect stanzas live
    # (reference parse_group.go service blocks; unnamed group services
    # default to "<job>-<group>")
    for body in o.get_all("service"):
        svc = _parse_service(body, "")
        if not svc.name:
            svc.name = f"${{JOB}}-{name}"
        g.services.append(svc)
    for label, body in _labelled_blocks(o, "task", "task"):
        g.tasks.append(_parse_task(label, body))
    if not g.tasks:
        raise HCLError(f"group {name!r} has no tasks", 0)
    return g


def parse_job(src: str) -> Job:
    """Parse an HCL jobspec into a :class:`Job` (reference parse.go:27).

    Exactly one top-level ``job`` block is required.
    """
    root = parse_hcl(src)
    jobs = _labelled_blocks(root, "job", "job")
    if len(jobs) != 1:
        raise HCLError(f"expected exactly one 'job' block, got {len(jobs)}", 0)
    job_id, o = jobs[0]

    job = Job(id=job_id, name=job_id)
    if "name" in o:
        job.name = _str(o.get("name"))
    if "id" in o:
        job.id = _str(o.get("id"))
    if "region" in o:
        job.region = _str(o.get("region"))
    if "namespace" in o:
        job.namespace = _str(o.get("namespace"))
    if "type" in o:
        job.type = _str(o.get("type"))
    if "priority" in o:
        job.priority = _int(o.get("priority"), "job.priority")
    if "all_at_once" in o:
        job.all_at_once = _bool(o.get("all_at_once"), "job.all_at_once")
    if "datacenters" in o:
        job.datacenters = [_str(d) for d in (o.get("datacenters") or [])]
    job.constraints = _parse_constraints(o)
    job.affinities = _parse_affinities(o)
    job.spreads = _parse_spreads(o)
    for body in o.get_all("update"):
        job.update = _parse_update(body)
    for body in o.get_all("meta"):
        job.meta.update(_strmap(body, "meta"))
    for body in o.get_all("periodic"):
        p = PeriodicConfig(enabled=True)
        if "cron" in body:
            p.spec = _str(body.get("cron"))
            p.spec_type = "cron"
        if "prohibit_overlap" in body:
            p.prohibit_overlap = _bool(
                body.get("prohibit_overlap"), "periodic.prohibit_overlap"
            )
        if "time_zone" in body:
            p.timezone = _str(body.get("time_zone"))
        if "enabled" in body:
            p.enabled = _bool(body.get("enabled"), "periodic.enabled")
        job.periodic = p
    for body in o.get_all("parameterized"):
        job.parameterized = ParameterizedJobConfig(
            payload=_str(body.get("payload", "optional")),
            meta_required=[_str(x) for x in (body.get("meta_required") or [])],
            meta_optional=[_str(x) for x in (body.get("meta_optional") or [])],
        )
    for label, body in _labelled_blocks(o, "group", "group"):
        job.task_groups.append(_parse_group(label, body, job.type))
    # A bare task at job level becomes a single-task group of the same name
    # (reference parse_job.go: "If we have tasks outside, create TaskGroups")
    for label, body in _labelled_blocks(o, "task", "task"):
        task = _parse_task(label, body)
        job.task_groups.append(TaskGroup(name=label, count=1, tasks=[task]))
    if not job.task_groups:
        raise HCLError(f"job {job_id!r} has no task groups", 0)
    names = [g.name for g in job.task_groups]
    if len(names) != len(set(names)):
        raise HCLError("duplicate task group names", 0)
    # Service-name ${JOB} interpolation happens at parse time (the
    # reference interpolates in taskenv; nothing downstream here resolves
    # it, so defaulted "<job>-<group>" names must be concrete)
    for tg in job.task_groups:
        for svc in tg.services:
            svc.name = svc.name.replace("${JOB}", job.name)
        for task in tg.tasks:
            for svc in task.services:
                svc.name = svc.name.replace("${JOB}", job.name)
    return job


def parse_file(path: str) -> Job:
    with open(path, "r", encoding="utf-8") as f:
        return parse_job(f.read())
