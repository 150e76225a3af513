"""The `nomad` CLI (reference command/commands.go:57 registry + command/*.go).

Usage: python -m nomad_tpu_torch.cli <command> [sub] [flags] [args]

Global flags (reference command/meta.go FlagSet): -address, -region,
-namespace, -token — with NOMAD_ADDR / NOMAD_REGION / NOMAD_NAMESPACE /
NOMAD_TOKEN environment fallbacks.

Copied from ``nomad_tpu/cli/main.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. One change: ``agent`` takes ``-device``
("cuda", the default, or "cpu"), the torch device of the agent's server.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api import APIError, Client, Config, QueryOptions
from .fmt import ago, columns, kv, short_id
from .monitor import monitor_eval


class CLIError(Exception):
    pass


class Ctx:
    """Parsed global flags + lazy API client."""

    def __init__(self) -> None:
        self.address = os.environ.get("NOMAD_ADDR", "http://127.0.0.1:4646")
        self.region = os.environ.get("NOMAD_REGION", "")
        self.namespace = os.environ.get("NOMAD_NAMESPACE", "")
        self.token = os.environ.get("NOMAD_TOKEN", "")
        self.ca_cert = os.environ.get("NOMAD_CACERT", "")
        self.client_cert = os.environ.get("NOMAD_CLIENT_CERT", "")
        self.client_key = os.environ.get("NOMAD_CLIENT_KEY", "")
        self.tls_skip_verify = os.environ.get(
            "NOMAD_TLS_SKIP_VERIFY", ""
        ).lower() in ("1", "true", "yes")
        self.out: Callable[[str], None] = print
        self._client: Optional[Client] = None

    @property
    def client(self) -> Client:
        if self._client is None:
            self._client = Client(
                Config(
                    address=self.address,
                    region=self.region,
                    namespace=self.namespace,
                    token=self.token,
                    ca_cert=self.ca_cert,
                    client_cert=self.client_cert,
                    client_key=self.client_key,
                    tls_skip_verify=self.tls_skip_verify,
                )
            )
        return self._client


def _split_flags(args: List[str]) -> Tuple[Dict[str, str], List[str]]:
    """Nomad-style single-dash flags: -flag, -flag=value, -flag value."""
    flags: Dict[str, str] = {}
    rest: List[str] = []

    def put(name: str, val: str) -> None:
        # repeatable flags accumulate comma-separated instead of the
        # last occurrence silently clobbering earlier ones
        if name in _REPEATABLE_FLAGS and name in flags:
            flags[name] = flags[name] + "," + val
        else:
            flags[name] = val

    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            name = a.lstrip("-")
            if "=" in name:
                name, _, val = name.partition("=")
                put(name, val)
            elif i + 1 < len(args) and not args[i + 1].startswith("-") and _wants_value(name):
                put(name, args[i + 1])
                i += 1
            else:
                flags[name] = "true"
        else:
            rest.append(a)
        i += 1
    return flags, rest


_REPEATABLE_FLAGS = {"host-volume", "meta", "retry-join", "servers", "config"}


_VALUE_FLAGS = {
    "address", "region", "namespace", "token", "job", "output", "type",
    "deadline", "meta", "payload", "name", "policy", "rules",
    "description", "bind", "http-port", "config", "version", "limit",
    "per-page", "node-class", "datacenter", "task", "dc", "s",
    "ca-file", "cert-file", "key-file", "n",
    "rpc-port", "serf-port", "retry-join", "bootstrap-expect", "data-dir",
    "servers", "encrypt", "authoritative-region", "replication-token",
    "host-volume", "peer-id", "group", "log-level", "install", "use",
    "remove", "min-quorum", "t", "device",
}


def _wants_value(name: str) -> bool:
    return name in _VALUE_FLAGS


def _apply_global_flags(ctx: Ctx, flags: Dict[str, str]) -> None:
    if "address" in flags:
        ctx.address = flags["address"]
    if "region" in flags:
        ctx.region = flags["region"]
    if "namespace" in flags:
        ctx.namespace = flags["namespace"]
    if "token" in flags:
        ctx.token = flags["token"]


def _truthy(flags: Dict[str, str], name: str) -> bool:
    return flags.get(name, "").lower() in ("true", "1", "yes")


def _formatted(ctx: Ctx, flags: Dict[str, str], data) -> bool:
    """Shared -json / -t short-circuit for status commands (reference
    command/data_format.go:76 Format, used by ~all status commands):
    True when machine-readable output was emitted and the command should
    skip its human rendering."""
    use_json = _truthy(flags, "json")
    tmpl = flags.get("t", "")
    if not use_json and not tmpl:
        return False
    from .data_format import FormatError, format_data

    try:
        ctx.out(format_data(use_json, tmpl, data))
    except FormatError as e:
        raise CLIError(str(e))
    return True


# ---------------------------------------------------------------------------
# agent
# ---------------------------------------------------------------------------


def _parse_host_volumes(spec: str) -> Dict[str, str]:
    """-host-volume name=path[,name=path...]; malformed pairs are errors,
    not silent drops (a vanished volume fails placements obscurely)."""
    out: Dict[str, str] = {}
    for pair in spec.split(","):
        if not pair:
            continue
        if "=" not in pair:
            raise SystemExit(
                f"-host-volume expects name=path, got {pair!r}")
        name, _, path = pair.partition("=")
        out[name] = path
    return out


def cmd_agent(ctx: Ctx, args: List[str]) -> int:
    flags, _ = _split_flags(args)
    from ..agent import Agent, AgentConfig

    # precedence (reference command/agent/command.go readConfig):
    # built-in defaults < -config files/dirs (in order) < CLI flags
    cfg = AgentConfig()
    config_sources = [p for p in flags.get("config", "").split(",") if p]
    file_data = {}
    if config_sources:
        from ..agent.config_file import (
            ConfigError,
            apply_file_config,
            load_config_sources,
        )

        try:
            file_data = load_config_sources(config_sources)
            cfg = apply_file_config(cfg, file_data)
        except ConfigError as e:
            raise CLIError(str(e))

    dev = _truthy(flags, "dev")
    if dev:
        cfg.dev_mode = True
        cfg.server_enabled = True
        cfg.client_enabled = True
    if not config_sources:
        # legacy flags-only semantics: -client alone = client-only agent
        cfg.server_enabled = _truthy(flags, "server") or dev or not _truthy(flags, "client")
        cfg.client_enabled = _truthy(flags, "client") or dev
    else:
        if _truthy(flags, "server"):
            cfg.server_enabled = True
        if _truthy(flags, "client"):
            cfg.client_enabled = True
    if "name" in flags:
        cfg.name = flags["name"]
    if "region" in flags:
        cfg.region = flags["region"]
    if "dc" in flags:
        cfg.datacenter = flags["dc"]
    if "bind" in flags:
        cfg.http_bind = cfg.rpc_bind = cfg.serf_bind = flags["bind"]
    if "http-port" in flags:
        cfg.http_port = int(flags["http-port"])
    elif "http" not in (file_data.get("ports") or {}):
        # neither flag nor file chose a port: the reference default.
        # An explicit ports { http = 0 } means ephemeral and is honored.
        cfg.http_port = 4646
    if "rpc-port" in flags:
        cfg.rpc_port = int(flags["rpc-port"])
    if "serf-port" in flags:
        cfg.serf_port = int(flags["serf-port"])
    if "retry-join" in flags:
        cfg.retry_join = [a for a in flags["retry-join"].split(",") if a]
    if "bootstrap-expect" in flags:
        cfg.bootstrap_expect = int(flags["bootstrap-expect"])
    if _truthy(flags, "wire-raft"):
        cfg.wire_raft = True
    if "data-dir" in flags:
        cfg.data_dir = flags["data-dir"]
    if "device" in flags:
        cfg.device = flags["device"]
    if "node-class" in flags:
        cfg.node_class = flags["node-class"]
    if "host-volume" in flags:
        cfg.host_volumes = _parse_host_volumes(flags["host-volume"])
    if "servers" in flags:
        cfg.servers = [a for a in flags["servers"].split(",") if a]
    if _truthy(flags, "acl-enabled"):
        cfg.acl_enabled = True
    if _truthy(flags, "enable-debug"):
        cfg.enable_debug = True
    if _truthy(flags, "no-gossip"):
        cfg.gossip_enabled = False
    if "ca-file" in flags:
        cfg.tls_ca_file = flags["ca-file"]
    if "cert-file" in flags:
        cfg.tls_cert_file = flags["cert-file"]
    if "key-file" in flags:
        cfg.tls_key_file = flags["key-file"]
    if _truthy(flags, "tls-http"):
        cfg.tls_http = True
    if "encrypt" in flags:
        cfg.encrypt = flags["encrypt"]
    if "authoritative-region" in flags:
        cfg.authoritative_region = flags["authoritative-region"]
    if "replication-token" in flags:
        cfg.replication_token = flags["replication-token"]

    agent = Agent(cfg)
    agent.start()
    for src in config_sources:
        ctx.out(f"==> Loaded configuration from {src}")
    ctx.out(f"==> Nomad agent started! HTTP at {agent.http_addr}")
    ctx.out("==> Nomad agent configuration:")
    ctx.out(kv([
        ("Client", agent.client is not None),
        ("Server", agent.server is not None),
        ("ACL", cfg.acl_enabled),
        ("Region", "global"),
    ]))
    stop = {"flag": False}

    def _sig(*_):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        ctx.out("==> Caught signal, gracefully shutting down")
        agent.shutdown()
    return 0


def cmd_agent_info(ctx: Ctx, args: List[str]) -> int:
    info = ctx.client.agent.self()
    ctx.out(json.dumps(info, indent=2, sort_keys=True))
    return 0


def cmd_monitor(ctx: Ctx, args: List[str]) -> int:
    """nomad monitor [-log-level <level>] [-no-follow] — stream the
    agent's logs (reference command/monitor.go over /v1/agent/monitor)."""
    flags, _ = _split_flags(args)
    level = flags.get("log-level", "info")
    if _truthy(flags, "no-follow"):
        out = ctx.client.agent.monitor(log_level=level)
        for line in out.get("Lines") or []:
            ctx.out(line.rstrip("\n"))
        return 0
    pending = b""
    try:
        sys.stdout.flush()
        for chunk in ctx.client.agent.monitor_follow(log_level=level):
            pending += chunk
            complete, sep, pending = pending.rpartition(b"\n")
            if sep:
                ctx.out(complete.decode(errors="replace"))
                sys.stdout.flush()
    except KeyboardInterrupt:
        pass
    return 0


# ---------------------------------------------------------------------------
# job family
# ---------------------------------------------------------------------------


def _read_jobfile(ctx: Ctx, path: str) -> dict:
    if path == "-":
        src = sys.stdin.read()
    else:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
    if path.endswith(".json"):
        doc = json.loads(src)
        return doc.get("Job", doc)
    return ctx.client.jobs.parse_hcl(src, canonicalize=True)


def cmd_job_run(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job run [-detach] <jobfile>")
    job = _read_jobfile(ctx, rest[0])
    out, _ = ctx.client.jobs.register(job)
    eval_id = out.get("EvalID", "")
    if not eval_id:
        ctx.out(f'Job registration successful (no evaluation: periodic or parameterized)')
        return 0
    if _truthy(flags, "detach"):
        ctx.out(f"Job registration successful")
        ctx.out(f"Evaluation ID: {eval_id}")
        return 0
    return monitor_eval(ctx.client, eval_id, ctx.out, verbose=_truthy(flags, "verbose"))


def cmd_job_plan(ctx: Ctx, args: List[str]) -> int:
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job plan <jobfile>")
    job = _read_jobfile(ctx, rest[0])
    plan, _ = ctx.client.jobs.plan(job, diff=True)
    diff = plan.get("Diff") or {}
    ctx.out(f"+/- Job: \"{job.get('ID','')}\" ({diff.get('Type','None')})")
    for tg in plan.get("Annotations", {}).get("DesiredTGUpdates", {}).items():
        name, upd = tg
        parts = [
            f"{k.lower()}: {v}"
            for k, v in sorted(upd.items())
            if isinstance(v, int) and v
        ]
        ctx.out(f"    group \"{name}\": " + (", ".join(parts) or "no changes"))
    failures = plan.get("FailedTGAllocs") or {}
    if failures:
        ctx.out("==> WARNING: failed to place all allocations:")
        for tg in failures:
            ctx.out(f"    group {tg!r}")
    ctx.out(f"Job Modify Index: {plan.get('JobModifyIndex', 0)}")
    return 1 if failures else 0


def cmd_job_status(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    c = ctx.client
    if not rest:
        jobs, _ = c.jobs.list()
        if _formatted(ctx, flags, jobs or []):
            return 0
        if not jobs:
            ctx.out("No running jobs")
            return 0
        rows = [["ID", "Type", "Priority", "Status", "Submit Date"]]
        for j in jobs:
            rows.append([j["ID"], j["Type"], j["Priority"], j["Status"], ""])
        ctx.out(columns(rows))
        return 0
    job_id = rest[0]
    job, _ = c.jobs.info(job_id)
    if _formatted(ctx, flags, job):
        return 0
    summary, _ = c.jobs.summary(job_id)
    ctx.out(kv([
        ("ID", job["ID"]),
        ("Name", job["Name"]),
        ("Submit Date", ""),
        ("Type", job["Type"]),
        ("Priority", job["Priority"]),
        ("Datacenters", ",".join(job.get("Datacenters") or [])),
        ("Namespace", job.get("Namespace", "default")),
        ("Status", job["Status"]),
        ("Periodic", bool(job.get("Periodic"))),
        ("Parameterized", bool(job.get("ParameterizedJob"))),
    ]))
    ctx.out("\nSummary")
    rows = [["Task Group", "Queued", "Starting", "Running", "Failed", "Complete", "Lost"]]
    for tg, s in sorted((summary.get("Summary") or {}).items()):
        rows.append([
            tg, s.get("Queued", 0), s.get("Starting", 0), s.get("Running", 0),
            s.get("Failed", 0), s.get("Complete", 0), s.get("Lost", 0),
        ])
    ctx.out(columns(rows))
    allocs, _ = c.jobs.allocations(job_id)
    if allocs:
        ctx.out("\nAllocations")
        rows = [["ID", "Node ID", "Task Group", "Version", "Desired", "Status", "Created"]]
        for a in allocs:
            rows.append([
                short_id(a["ID"]), short_id(a.get("NodeID", "")), a.get("TaskGroup", ""),
                a.get("JobVersion", 0), a.get("DesiredStatus", ""),
                a.get("ClientStatus", ""), ago(a.get("CreateTime", 0)),
            ])
        ctx.out(columns(rows))
    return 0


def cmd_job_stop(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job stop [-purge] [-detach] <job>")
    out, _ = ctx.client.jobs.deregister(rest[0], purge=_truthy(flags, "purge"))
    eval_id = out.get("EvalID", "")
    if _truthy(flags, "detach") or not eval_id:
        ctx.out(f"Evaluation ID: {eval_id}")
        return 0
    return monitor_eval(ctx.client, eval_id, ctx.out)


def cmd_job_history(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job history <job>")
    versions, _ = ctx.client.jobs.versions(rest[0])
    if _formatted(ctx, flags, versions or []):
        return 0
    for v in versions or []:
        ctx.out(kv([
            ("Version", v.get("Version", 0)),
            ("Stable", v.get("Stable", False)),
            ("Status", v.get("Status", "")),
        ]))
        ctx.out("")
    return 0


def cmd_job_revert(ctx: Ctx, args: List[str]) -> int:
    _, rest = _split_flags(args)
    if len(rest) < 2:
        raise CLIError("usage: nomad job revert <job> <version>")
    out, _ = ctx.client.jobs.revert(rest[0], int(rest[1]))
    return monitor_eval(ctx.client, out.get("EvalID", ""), ctx.out)


def cmd_job_dispatch(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job dispatch [-meta k=v] [-payload file] <job>")
    meta = {}
    if "meta" in flags:
        k, _, v = flags["meta"].partition("=")
        meta[k] = v
    payload = b""
    if "payload" in flags:
        with open(flags["payload"], "rb") as f:
            payload = f.read()
    out, _ = ctx.client.jobs.dispatch(rest[0], meta=meta, payload=payload)
    ctx.out(f"Dispatched Job ID: {out.get('DispatchedJobID','')}")
    ctx.out(f"Evaluation ID: {short_id(out.get('EvalID',''))}")
    return 0


def cmd_job_inspect(ctx: Ctx, args: List[str]) -> int:
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job inspect <job>")
    job, _ = ctx.client.jobs.info(rest[0])
    ctx.out(json.dumps({"Job": job}, indent=2, sort_keys=True))
    return 0


def cmd_job_validate(ctx: Ctx, args: List[str]) -> int:
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job validate <jobfile>")
    job = _read_jobfile(ctx, rest[0])
    res, _ = ctx.client.jobs.validate(job)
    errs = res.get("ValidationErrors") or []
    if errs:
        for e in errs:
            ctx.out(f"  * {e}")
        return 1
    ctx.out("Job validation successful")
    return 0


_EXAMPLE_JOBSPEC = '''\
# Minimal example job (reference command/job_init.go example.nomad).
# Run it with: nomad job run example.nomad
job "example" {
  datacenters = ["dc1"]
  type        = "service"

  group "cache" {
    count = 1

    restart {
      attempts = 2
      interval = "30m"
      delay    = "15s"
      mode     = "fail"
    }

    ephemeral_disk {
      size = 300
    }

    task "redis" {
      driver = "raw_exec"

      config {
        command = "/bin/sh"
        args    = ["-c", "sleep 600"]
      }

      resources {
        cpu    = 500
        memory = 256
      }
    }
  }
}
'''


def cmd_job_init(ctx: Ctx, args: List[str]) -> int:
    """Reference command/job_init.go: write an example jobspec."""
    flags, rest = _split_flags(args)
    filename = rest[0] if rest else "example.nomad"
    if os.path.exists(filename):
        ctx.out(f"Job file '{filename}' already exists")
        return 1
    with open(filename, "w") as f:
        f.write(_EXAMPLE_JOBSPEC)
    ctx.out(f"Example job file written to {filename}")
    return 0


def cmd_job_eval(ctx: Ctx, args: List[str]) -> int:
    """Reference command/job_eval.go: force a new evaluation."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job eval [-detach] <job>")
    out, _ = ctx.client.jobs.evaluate(rest[0])
    eval_id = out.get("EvalID", "")
    if _truthy(flags, "detach") or not eval_id:
        ctx.out(f"Evaluation ID: {eval_id}")
        return 0
    return monitor_eval(ctx.client, eval_id, ctx.out)


def cmd_job_deployments(ctx: Ctx, args: List[str]) -> int:
    """Reference command/job_deployments.go."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job deployments <job>")
    deps, _ = ctx.client.jobs.deployments(rest[0])
    if _formatted(ctx, flags, deps or []):
        return 0
    if not deps:
        ctx.out("No deployments found")
        return 0
    rows = [["ID", "Job Version", "Status", "Description"]]
    for d in deps:
        rows.append([
            short_id(d["ID"]), d.get("JobVersion", 0), d.get("Status", ""),
            d.get("StatusDescription", ""),
        ])
    ctx.out(columns(rows))
    return 0


def cmd_job_promote(ctx: Ctx, args: List[str]) -> int:
    """Reference command/job_promote.go: promote the job's latest
    deployment's canaries."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job promote [-group g] <job>")
    deps, _ = ctx.client.jobs.deployments(rest[0])
    active = [
        d for d in deps or []
        if d.get("Status") in ("running", "pending", "paused")
    ]
    if not active:
        ctx.out(f"No active deployment for job {rest[0]!r}")
        return 1
    latest = max(active, key=lambda d: d.get("CreateIndex", 0))
    groups = flags["group"].split(",") if "group" in flags else None
    out, _ = ctx.client.deployments.promote(latest["ID"], groups=groups)
    eval_id = out.get("EvalID", "")
    if eval_id and not _truthy(flags, "detach"):
        return monitor_eval(ctx.client, eval_id, ctx.out)
    ctx.out(f"Deployment {short_id(latest['ID'])} promoted")
    return 0


def cmd_job_periodic_force(ctx: Ctx, args: List[str]) -> int:
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad job periodic force <job>")
    out, _ = ctx.client.jobs.periodic_force(rest[0])
    ctx.out(f"Evaluation ID: {out.get('EvalID','')}")
    return 0


def cmd_job(ctx: Ctx, args: List[str]) -> int:
    subs = {
        "run": cmd_job_run,
        "plan": cmd_job_plan,
        "status": cmd_job_status,
        "stop": cmd_job_stop,
        "history": cmd_job_history,
        "revert": cmd_job_revert,
        "dispatch": cmd_job_dispatch,
        "inspect": cmd_job_inspect,
        "validate": cmd_job_validate,
        "init": cmd_job_init,
        "eval": cmd_job_eval,
        "deployments": cmd_job_deployments,
        "promote": cmd_job_promote,
        "periodic": lambda c, a: cmd_job_periodic_force(c, a[1:]) if a and a[0] == "force" else _usage(c, "job periodic force <job>"),
    }
    return _dispatch(ctx, args, subs, "job")


# ---------------------------------------------------------------------------
# node family
# ---------------------------------------------------------------------------


def cmd_node_status(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    c = ctx.client
    if not rest:
        nodes, _ = c.nodes.list()
        if _formatted(ctx, flags, nodes or []):
            return 0
        rows = [["ID", "DC", "Name", "Class", "Drain", "Eligibility", "Status"]]
        for n in nodes or []:
            rows.append([
                short_id(n["ID"]), n.get("Datacenter", ""), n.get("Name", ""),
                n.get("NodeClass", ""), n.get("Drain", False),
                n.get("SchedulingEligibility", ""), n.get("Status", ""),
            ])
        ctx.out(columns(rows))
        return 0
    node, _ = c.nodes.info(_resolve_node(ctx, rest[0]))
    if _formatted(ctx, flags, node):
        return 0
    ctx.out(kv([
        ("ID", node["ID"]),
        ("Name", node.get("Name", "")),
        ("Class", node.get("NodeClass", "")),
        ("DC", node.get("Datacenter", "")),
        ("Drain", node.get("Drain", False)),
        ("Eligibility", node.get("SchedulingEligibility", "")),
        ("Status", node.get("Status", "")),
    ]))
    allocs, _ = c.nodes.allocations(node["ID"])
    if allocs:
        ctx.out("\nAllocations")
        rows = [["ID", "Job ID", "Task Group", "Desired", "Status"]]
        for a in allocs:
            rows.append([
                short_id(a["ID"]), a.get("JobID", ""), a.get("TaskGroup", ""),
                a.get("DesiredStatus", ""), a.get("ClientStatus", ""),
            ])
        ctx.out(columns(rows))
    return 0


def _resolve_node(ctx: Ctx, prefix: str) -> str:
    nodes, _ = ctx.client.nodes.list()
    matches = [n["ID"] for n in nodes or [] if n["ID"].startswith(prefix)]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise CLIError(f"No node(s) with prefix {prefix!r} found")
    raise CLIError(f"Prefix {prefix!r} matched multiple nodes")


def cmd_node_drain(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest or not (_truthy(flags, "enable") or _truthy(flags, "disable")):
        raise CLIError("usage: nomad node drain [-enable|-disable] [-deadline dur] <node>")
    node_id = _resolve_node(ctx, rest[0])
    spec = None
    if _truthy(flags, "enable"):
        deadline_ns = 3600 * 10**9  # DefaultDrainDeadline (1h)
        if "deadline" in flags:
            from ..jobspec import parse_duration_ns

            deadline_ns = parse_duration_ns(flags["deadline"])
        spec = {
            "Deadline": deadline_ns,
            "IgnoreSystemJobs": _truthy(flags, "ignore-system"),
        }
    ctx.client.nodes.update_drain(node_id, spec, mark_eligible=_truthy(flags, "disable"))
    state = "enabled" if spec else "disabled"
    ctx.out(f"Node \"{short_id(node_id)}\" drain strategy {state}")
    return 0


def cmd_node_eligibility(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest or not (_truthy(flags, "enable") or _truthy(flags, "disable")):
        raise CLIError("usage: nomad node eligibility [-enable|-disable] <node>")
    node_id = _resolve_node(ctx, rest[0])
    eligible = _truthy(flags, "enable")
    ctx.client.nodes.toggle_eligibility(node_id, eligible)
    ctx.out(
        f"Node \"{short_id(node_id)}\" scheduling eligibility set: "
        + ("eligible for scheduling" if eligible else "ineligible for scheduling")
    )
    return 0


def cmd_node(ctx: Ctx, args: List[str]) -> int:
    return _dispatch(ctx, args, {
        "status": cmd_node_status,
        "drain": cmd_node_drain,
        "eligibility": cmd_node_eligibility,
    }, "node")


# ---------------------------------------------------------------------------
# alloc / eval / deployment
# ---------------------------------------------------------------------------


def _find_alloc(ctx: Ctx, prefix: str) -> dict:
    allocs, _ = ctx.client.allocations.list(QueryOptions(prefix=prefix))
    matches = [a for a in allocs or [] if a["ID"].startswith(prefix)]
    if len(matches) != 1:
        raise CLIError(f"prefix {prefix!r} matched {len(matches)} allocations")
    return matches[0]


def cmd_alloc_logs(ctx: Ctx, args: List[str]) -> int:
    """nomad alloc logs [-stderr] [-f] [-n <lines>] [-task <name>] <alloc-id>
    (reference command/alloc_logs.go; -f polls the offset API)."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError(
            "usage: nomad alloc logs [-stderr] [-f] [-n <lines>] [-task <name>] <alloc-id>"
        )
    match = _find_alloc(ctx, rest[0])
    task = flags.get("task") or (rest[1] if len(rest) > 1 else "")
    if not task:
        alloc, _ = ctx.client.allocations.info(match["ID"])
        tasks = sorted((alloc.get("TaskStates") or {}).keys())
        if len(tasks) != 1:
            raise CLIError(
                "allocation has multiple tasks, pass -task (have: %s)" % ", ".join(tasks)
            )
        task = tasks[0]
    log_type = "stderr" if "stderr" in flags else "stdout"
    if "n" in flags:
        try:
            n = int(flags["n"])
        except ValueError:
            raise CLIError("-n takes a line count")
        # fetch a window back from the END so -n tails the real tail, not
        # the first MB of a big log
        data, offset = ctx.client.alloc_fs.logs_at(
            match["ID"], task, log_type, offset=1 << 20, origin="end"
        )
        if n <= 0:
            lines = []
        else:
            lines = data.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            lines = lines[-n:]
        if lines:
            ctx.out(b"\n".join(lines).decode(errors="replace"))
    else:
        data, offset = ctx.client.alloc_fs.logs_at(match["ID"], task, log_type)
        if data.rstrip(b"\n"):
            ctx.out(data.rstrip(b"\n").decode(errors="replace"))
    if not _truthy(flags, "f"):
        return 0
    # follow: SERVER-PUSH stream (follow=true keeps the response open and
    # the agent pushes bytes as the task writes — no client polling);
    # buffer partial lines so mid-line and mid-UTF-8 chunk boundaries
    # don't mangle output
    pending = b""
    try:
        sys.stdout.flush()
        for chunk in ctx.client.alloc_fs.logs_follow(
            match["ID"], task, log_type, offset=offset
        ):
            pending += chunk
            complete, sep, pending = pending.rpartition(b"\n")
            if sep:
                ctx.out(complete.decode(errors="replace"))
                sys.stdout.flush()  # follow mode must stream when piped
    except KeyboardInterrupt:
        pass
    except OSError:
        pass  # stream ended (agent idle-capped or went away)
    if pending:
        ctx.out(pending.decode(errors="replace"))
    return 0


def cmd_alloc_fs(ctx: Ctx, args: List[str]) -> int:
    """nomad alloc fs <alloc-id> [path] (reference command/alloc_fs.go):
    directory → listing, file → contents."""
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad alloc fs <alloc-id> [path]")
    match = _find_alloc(ctx, rest[0])
    path = rest[1] if len(rest) > 1 else "/"
    stat, _ = ctx.client.alloc_fs.stat(match["ID"], path)
    if stat.get("IsDir"):
        entries, _ = ctx.client.alloc_fs.ls(match["ID"], path)
        rows = [["Mode", "Size", "Name"]]
        for e in entries or []:
            name = e["Name"] + ("/" if e["IsDir"] else "")
            rows.append([e.get("FileMode", ""), str(e.get("Size", 0)), name])
        ctx.out(columns(rows))
    else:
        ctx.out(ctx.client.alloc_fs.cat(match["ID"], path).decode(errors="replace").rstrip("\n"))
    return 0


def cmd_alloc_restart(ctx: Ctx, args: List[str]) -> int:
    """nomad alloc restart <alloc-id> [task] (command/alloc_restart.go)."""
    _, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad alloc restart <alloc-id> [task]")
    match = _find_alloc(ctx, rest[0])
    ctx.client.allocations.restart(match["ID"], rest[1] if len(rest) > 1 else "")
    ctx.out(f'Allocation "{short_id(match["ID"])}" restarted')
    return 0


def cmd_alloc_signal(ctx: Ctx, args: List[str]) -> int:
    """nomad alloc signal [-s SIGNAL] <alloc-id> [task]."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad alloc signal [-s <signal>] <alloc-id> [task]")
    match = _find_alloc(ctx, rest[0])
    sig = flags.get("s", "SIGKILL")
    ctx.client.allocations.signal(match["ID"], sig,
                                  rest[1] if len(rest) > 1 else "")
    ctx.out(f'Signalled allocation "{short_id(match["ID"])}" with {sig}')
    return 0


def cmd_alloc_exec(ctx: Ctx, args: List[str]) -> int:
    """nomad alloc exec -task <name> <alloc-id> <cmd>... (one-shot).

    Flag parsing stops at the alloc id: everything after is the command
    verbatim (the command's own flags like ``sh -c`` must survive)."""
    flags: Dict[str, str] = {}
    i = 0
    while i < len(args) and args[i].startswith("-"):
        name = args[i].lstrip("-")
        if "=" in name:
            k, _, v = name.partition("=")
            flags[k] = v
            i += 1
        elif name in ("i", "interactive"):  # boolean flags
            flags[name] = "true"
            i += 1
        elif i + 1 < len(args):
            flags[name] = args[i + 1]
            i += 2
        else:
            raise CLIError(f"flag -{name} needs a value")
    rest = args[i:]
    if len(rest) < 2:
        raise CLIError(
            "usage: nomad alloc exec [-i] [-task <name>] <alloc-id> <cmd>..."
        )
    match = _find_alloc(ctx, rest[0])
    task = flags.get("task", "")
    if not task:
        alloc, _ = ctx.client.allocations.info(match["ID"])
        tasks = sorted((alloc.get("TaskStates") or {}).keys())
        if len(tasks) != 1:
            raise CLIError("pass -task (have: %s)" % ", ".join(tasks))
        task = tasks[0]
    if "i" in flags or "interactive" in flags:
        # INTERACTIVE: websocket session bridging this terminal's stdio to
        # the task (reference command/alloc_exec.go over execStream)
        import threading

        stream = ctx.client.allocations.exec_stream(match["ID"], task, rest[1:])

        def pump_stdin() -> None:
            try:
                while True:
                    line = sys.stdin.buffer.readline()
                    if not line:
                        stream.close_stdin()
                        return
                    stream.send_stdin(line)
            except (OSError, ValueError):
                pass

        t = threading.Thread(target=pump_stdin, daemon=True)
        t.start()
        try:
            while True:
                chunk = stream.read_output()
                if chunk is None:
                    break
                sys.stdout.buffer.write(chunk)
                sys.stdout.buffer.flush()
        except KeyboardInterrupt:
            pass
        finally:
            stream.close()
        return int(stream.exit_code or 0)
    out, _ = ctx.client.allocations.exec_task(match["ID"], task, rest[1:])
    if out.get("Output"):
        ctx.out(out["Output"].rstrip("\n"))
    return int(out.get("ExitCode", 0))


def cmd_alloc_stop(ctx: Ctx, args: List[str]) -> int:
    """Reference command/alloc_stop.go: stop + reschedule one alloc."""
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad alloc stop [-detach] <alloc-id>")
    alloc = _find_alloc(ctx, rest[0])
    out, _ = ctx.client.allocations.stop(alloc["ID"])
    eval_id = out.get("EvalID", "")
    if _truthy(flags, "detach") or not eval_id:
        ctx.out(f"Evaluation ID: {eval_id}")
        return 0
    return monitor_eval(ctx.client, eval_id, ctx.out)


def cmd_alloc_status(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad alloc status [-json] [-t <tmpl>] <alloc-id>")
    allocs, _ = ctx.client.allocations.list(QueryOptions(prefix=rest[0]))
    matches = [a for a in allocs or [] if a["ID"].startswith(rest[0])]
    if len(matches) != 1:
        raise CLIError(f"prefix {rest[0]!r} matched {len(matches)} allocations")
    alloc, _ = ctx.client.allocations.info(matches[0]["ID"])
    if _formatted(ctx, flags, alloc):
        return 0
    ctx.out(kv([
        ("ID", alloc["ID"]),
        ("Eval ID", short_id(alloc.get("EvalID", ""))),
        ("Name", alloc.get("Name", "")),
        ("Node ID", short_id(alloc.get("NodeID", ""))),
        ("Job ID", alloc.get("JobID", "")),
        ("Job Version", alloc.get("JobVersion", 0)),
        ("Client Status", alloc.get("ClientStatus", "")),
        ("Desired Status", alloc.get("DesiredStatus", "")),
        ("Created", ago(alloc.get("CreateTime", 0))),
    ]))
    states = alloc.get("TaskStates") or {}
    for task, st in sorted(states.items()):
        ctx.out(f"\nTask \"{task}\" is \"{st.get('State','')}\"")
        events = st.get("Events") or []
        if events:
            rows = [["Time", "Type", "Description"]]
            for e in events:
                rows.append([ago(e.get("Time", 0)), e.get("Type", ""), e.get("DisplayMessage", e.get("Message", ""))])
            ctx.out(columns(rows))
    metrics = alloc.get("Metrics") or {}
    if metrics.get("NodesEvaluated") is not None:
        ctx.out("\nPlacement Metrics")
        ctx.out(kv([
            ("Nodes Evaluated", metrics.get("NodesEvaluated", 0)),
            ("Nodes Filtered", metrics.get("NodesFiltered", 0)),
            ("Nodes Exhausted", metrics.get("NodesExhausted", 0)),
        ]))
    return 0


def cmd_eval_status(ctx: Ctx, args: List[str]) -> int:
    flags, rest = _split_flags(args)
    if not rest:
        raise CLIError("usage: nomad eval status [-json] [-t <tmpl>] <eval-id>")
    evals, _ = ctx.client.evaluations.list(QueryOptions(prefix=rest[0]))
    matches = [e for e in evals or [] if e["ID"].startswith(rest[0])]
    if len(matches) != 1:
        raise CLIError(f"prefix {rest[0]!r} matched {len(matches)} evaluations")
    ev, _ = ctx.client.evaluations.info(matches[0]["ID"])
    if _formatted(ctx, flags, ev):
        return 0
    ctx.out(kv([
        ("ID", ev["ID"]),
        ("Status", ev.get("Status", "")),
        ("Type", ev.get("Type", "")),
        ("TriggeredBy", ev.get("TriggeredBy", "")),
        ("Job ID", ev.get("JobID", "")),
        ("Priority", ev.get("Priority", 0)),
        ("Placement Failures", bool(ev.get("FailedTGAllocs"))),
    ]))
    return 0


def cmd_deployment(ctx: Ctx, args: List[str]) -> int:
    def dlist(ctx, a):
        flags, _rest = _split_flags(a)
        deps, _ = ctx.client.deployments.list()
        if _formatted(ctx, flags, deps or []):
            return 0
        rows = [["ID", "Job ID", "Job Version", "Status", "Description"]]
        for d in deps or []:
            rows.append([
                short_id(d["ID"]), d.get("JobID", ""), d.get("JobVersion", 0),
                d.get("Status", ""), d.get("StatusDescription", ""),
            ])
        ctx.out(columns(rows))
        return 0

    def _resolve(ctx, prefix: str) -> str:
        deps, _ = ctx.client.deployments.list()
        matches = [d for d in deps or [] if d["ID"].startswith(prefix)]
        if len(matches) != 1:
            raise CLIError(f"prefix matched {len(matches)} deployments")
        return matches[0]["ID"]

    def dstatus(ctx, a):
        flags, rest = _split_flags(a)
        if not rest:
            raise CLIError("usage: nomad deployment status [-json] [-t <tmpl>] <id>")
        d, _ = ctx.client.deployments.info(_resolve(ctx, rest[0]))
        if _formatted(ctx, flags, d):
            return 0
        ctx.out(kv([
            ("ID", d["ID"]),
            ("Job ID", d.get("JobID", "")),
            ("Job Version", d.get("JobVersion", 0)),
            ("Status", d.get("Status", "")),
            ("Description", d.get("StatusDescription", "")),
        ]))
        rows = [["Task Group", "Desired", "Placed", "Healthy", "Unhealthy", "Promoted"]]
        for tg, s in sorted((d.get("TaskGroups") or {}).items()):
            rows.append([
                tg, s.get("DesiredTotal", 0), s.get("PlacedAllocs", 0),
                s.get("HealthyAllocs", 0), s.get("UnhealthyAllocs", 0),
                s.get("Promoted", False),
            ])
        ctx.out("\nDeployed")
        ctx.out(columns(rows))
        return 0

    def dpromote(ctx, a):
        _, rest = _split_flags(a)
        if not rest:
            raise CLIError("usage: nomad deployment promote <id>")
        out, _ = ctx.client.deployments.promote(_resolve(ctx, rest[0]))
        return monitor_eval(ctx.client, out.get("EvalID", ""), ctx.out) if out.get("EvalID") else 0

    def dfail(ctx, a):
        _, rest = _split_flags(a)
        if not rest:
            raise CLIError("usage: nomad deployment fail <id>")
        ctx.client.deployments.fail(_resolve(ctx, rest[0]))
        ctx.out("Deployment marked as failed")
        return 0

    def _dpause(ctx, a, pause: bool):
        _, rest = _split_flags(a)
        if not rest:
            verb = "pause" if pause else "resume"
            raise CLIError(f"usage: nomad deployment {verb} <id>")
        ctx.client.deployments.pause(_resolve(ctx, rest[0]), pause)
        ctx.out("Deployment paused" if pause else "Deployment resumed")
        return 0

    return _dispatch(ctx, args, {
        "list": dlist, "status": dstatus, "promote": dpromote, "fail": dfail,
        # reference command/deployment_pause.go / deployment_resume.go
        "pause": lambda c, a: _dpause(c, a, True),
        "resume": lambda c, a: _dpause(c, a, False),
    }, "deployment")


# ---------------------------------------------------------------------------
# acl family
# ---------------------------------------------------------------------------


def cmd_acl(ctx: Ctx, args: List[str]) -> int:
    c = ctx.client

    def bootstrap(ctx, a):
        tok, _ = c.acl_tokens.bootstrap()
        ctx.out(kv([
            ("Accessor ID", tok["AccessorID"]),
            ("Secret ID", tok["SecretID"]),
            ("Name", tok["Name"]),
            ("Type", tok["Type"]),
            ("Global", tok.get("Global", False)),
            ("Policies", "n/a"),
        ]))
        return 0

    def policy(ctx, a):
        if not a:
            raise CLIError("usage: nomad acl policy <apply|list|info|delete>")
        sub, rest_args = a[0], a[1:]
        if sub == "apply":
            flags, rest = _split_flags(rest_args)
            if len(rest) < 2:
                raise CLIError("usage: nomad acl policy apply <name> <rules-file>")
            with open(rest[1], "r", encoding="utf-8") as f:
                rules = f.read()
            c.acl_policies.upsert({
                "Name": rest[0],
                "Description": flags.get("description", ""),
                "Rules": rules,
            })
            ctx.out(f"Successfully wrote {rest[0]!r} ACL policy!")
            return 0
        if sub == "list":
            pols, _ = c.acl_policies.list()
            rows = [["Name", "Description"]]
            for p in pols or []:
                rows.append([p["Name"], p.get("Description", "")])
            ctx.out(columns(rows))
            return 0
        if sub == "info":
            if not rest_args:
                raise CLIError("usage: nomad acl policy info <name>")
            p, _ = c.acl_policies.info(rest_args[0])
            ctx.out(kv([("Name", p["Name"]), ("Description", p.get("Description", ""))]))
            ctx.out("Rules\n" + p.get("Rules", ""))
            return 0
        if sub == "delete":
            if not rest_args:
                raise CLIError("usage: nomad acl policy delete <name>")
            c.acl_policies.delete(rest_args[0])
            ctx.out(f"Successfully deleted {rest_args[0]!r} ACL policy!")
            return 0
        raise CLIError(f"unknown acl policy subcommand {sub!r}")

    def token(ctx, a):
        if not a:
            raise CLIError("usage: nomad acl token <create|list|info|self|delete>")
        sub, rest_args = a[0], a[1:]
        if sub == "create":
            flags, _ = _split_flags(rest_args)
            policies = [p for p in flags.get("policy", "").split(",") if p]
            tok, _ = c.acl_tokens.create({
                "Name": flags.get("name", ""),
                "Type": flags.get("type", "client"),
                "Policies": policies,
                "Global": _truthy(flags, "global"),
            })
            ctx.out(kv([
                ("Accessor ID", tok["AccessorID"]),
                ("Secret ID", tok["SecretID"]),
                ("Name", tok.get("Name", "")),
                ("Type", tok["Type"]),
                ("Policies", ",".join(tok.get("Policies") or [])),
            ]))
            return 0
        if sub == "list":
            toks, _ = c.acl_tokens.list()
            rows = [["Name", "Type", "Global", "Accessor ID"]]
            for t in toks or []:
                rows.append([t.get("Name", ""), t["Type"], t.get("Global", False), t["AccessorID"]])
            ctx.out(columns(rows))
            return 0
        if sub == "self":
            tok, _ = c.acl_tokens.self()
            ctx.out(kv([("Accessor ID", tok["AccessorID"]), ("Name", tok.get("Name", "")), ("Type", tok["Type"])]))
            return 0
        if sub == "info":
            if not rest_args:
                raise CLIError("usage: nomad acl token info <accessor>")
            tok, _ = c.acl_tokens.info(rest_args[0])
            ctx.out(kv([("Accessor ID", tok["AccessorID"]), ("Name", tok.get("Name", "")), ("Type", tok["Type"])]))
            return 0
        if sub == "delete":
            if not rest_args:
                raise CLIError("usage: nomad acl token delete <accessor>")
            c.acl_tokens.delete(rest_args[0])
            ctx.out("Token deleted successfully")
            return 0
        raise CLIError(f"unknown acl token subcommand {sub!r}")

    return _dispatch(ctx, args, {"bootstrap": bootstrap, "policy": policy, "token": token}, "acl")


# ---------------------------------------------------------------------------
# operator / system / server / misc
# ---------------------------------------------------------------------------


def cmd_operator(ctx: Ctx, args: List[str]) -> int:
    def sched(ctx, a):
        flags, rest = _split_flags(a)
        if rest and rest[0] == "set-config":
            body = {}
            if "scheduler-algorithm" in flags:
                body["SchedulerAlgorithm"] = flags["scheduler-algorithm"]
            if "preemption-system" in flags:
                body["PreemptionConfig"] = {"SystemSchedulerEnabled": _truthy(flags, "preemption-system")}
            ctx.client.operator.scheduler_set_configuration(body)
            ctx.out("Scheduler configuration updated!")
            return 0
        cfg, _ = ctx.client.operator.scheduler_get_configuration()
        ctx.out(json.dumps(cfg, indent=2, sort_keys=True))
        return 0

    def raft(ctx, a):
        flags, rest = _split_flags(a)
        if rest and rest[0] == "remove-peer":
            # reference command/operator_raft_remove.go
            peer = flags.get("peer-id", "") or (rest[1] if len(rest) > 1 else "")
            if not peer:
                raise CLIError(
                    "usage: nomad operator raft remove-peer -peer-id=<id>"
                )
            ctx.client.operator.raft_remove_peer(peer)
            ctx.out(f"Removed peer {peer}")
            return 0
        if rest and rest[0] not in ("list-peers",):
            raise CLIError(
                "usage: nomad operator raft [list-peers | remove-peer -peer-id=<id>]"
            )
        raftcfg, _ = ctx.client.operator.raft_get_configuration()
        rows = [["Node", "ID", "Address", "State", "Voter"]]
        for s in raftcfg.get("Servers") or []:
            rows.append([
                s.get("Node", ""), s.get("ID", ""), s.get("Address", ""),
                "leader" if s.get("Leader") else "follower", s.get("Voter", True),
            ])
        ctx.out(columns(rows))
        return 0

    def autopilot(ctx, a):
        # reference command/operator_autopilot_get.go / _set.go
        flags, rest = _split_flags(a)
        if rest and rest[0] == "set-config":
            # read-modify-write like operator_autopilot_set.go: flags not
            # passed must keep their current values, not reset to zeros
            body, _ = ctx.client.operator.autopilot_get_configuration()
            body = dict(body or {})
            if "cleanup-dead-servers" in flags:
                body["CleanupDeadServers"] = _truthy(flags, "cleanup-dead-servers")
            if "min-quorum" in flags:
                body["MinQuorum"] = int(flags["min-quorum"])
            ctx.client.operator.autopilot_set_configuration(body)
            ctx.out("Configuration updated!")
            return 0
        cfg, _ = ctx.client.operator.autopilot_get_configuration()
        ctx.out(json.dumps(cfg, indent=2, sort_keys=True))
        return 0

    def keygen(ctx, a):
        # reference command/operator_keygen.go: 32 bytes of entropy, b64
        import os as _os

        ctx.out(base64.b64encode(_os.urandom(32)).decode())
        return 0

    def keyring(ctx, a):
        # reference command/operator_keyring.go: -list/-install/-use/-remove
        flags, _ = _split_flags(a)
        try:
            if "install" in flags:
                ctx.client.agent.keyring_op("install", flags["install"])
                ctx.out("Successfully installed key!")
            elif "use" in flags:
                ctx.client.agent.keyring_op("use", flags["use"])
                ctx.out("Successfully changed primary key!")
            elif "remove" in flags:
                ctx.client.agent.keyring_op("remove", flags["remove"])
                ctx.out("Successfully removed key!")
            else:
                out = ctx.client.agent.keyring_list()
                rows = [["Key", "Primary"]]
                primaries = out.get("PrimaryKeys") or {}
                for k in out.get("Keys") or {}:
                    rows.append([k, "yes" if k in primaries else ""])
                ctx.out(columns(rows))
        except APIError as e:
            ctx.out(f"error: {e}")
            return 1
        return 0

    return _dispatch(ctx, args, {
        "scheduler": sched,
        "scheduler-config": sched,
        "raft": raft,
        "autopilot": autopilot,
        "keygen": keygen,
        "keyring": keyring,
    }, "operator")


def cmd_system(ctx: Ctx, args: List[str]) -> int:
    def gc(ctx, a):
        ctx.client.system.garbage_collect()
        ctx.out("System GC triggered")
        return 0

    def reconcile(ctx, a):
        ctx.client.system.reconcile_summaries()
        ctx.out("Summaries reconciled")
        return 0

    return _dispatch(ctx, args, {"gc": gc, "reconcile": reconcile}, "system")


def cmd_server(ctx: Ctx, args: List[str]) -> int:
    def members(ctx, a):
        flags, _rest = _split_flags(a)
        out = ctx.client.agent.members()
        if _formatted(ctx, flags, out.get("Members") or []):
            return 0
        rows = [["Name", "Address", "Port", "Status", "Leader", "Region"]]
        for m in out.get("Members") or []:
            rows.append([
                m.get("Name", ""), m.get("Addr", ""), m.get("Port", 0),
                m.get("Status", ""), m.get("Leader", False), m.get("Region", "global"),
            ])
        ctx.out(columns(rows))
        return 0

    def join(ctx, a):
        # reference command/server_join.go
        _, rest = _split_flags(a)
        if not rest:
            raise CLIError("usage: nomad server join <addr:port> [...]")
        out = ctx.client.agent.join(rest)
        n = out.get("num_joined", 0)
        ctx.out(f"Joined {n} servers successfully")
        return 0 if n else 1

    def force_leave(ctx, a):
        # reference command/server_force_leave.go
        _, rest = _split_flags(a)
        if not rest:
            raise CLIError("usage: nomad server force-leave <node>")
        ctx.client.agent.force_leave(rest[0])
        ctx.out(f"Force-leave issued for {rest[0]}")
        return 0

    return _dispatch(ctx, args, {
        "members": members, "join": join, "force-leave": force_leave,
    }, "server")


def cmd_ui(ctx: Ctx, args: List[str]) -> int:
    ctx.out(ctx.address + "/ui/")
    return 0


def cmd_version(ctx: Ctx, args: List[str]) -> int:
    from .. import __version__

    ctx.out(f"Nomad-TPU v{__version__}")
    return 0


# ---------------------------------------------------------------------------
# registry + entry point
# ---------------------------------------------------------------------------


def _usage(ctx: Ctx, text: str) -> int:
    ctx.out(f"usage: nomad {text}")
    return 1


def _dispatch(ctx: Ctx, args: List[str], subs: Dict[str, Callable], family: str) -> int:
    if not args or args[0] not in subs:
        ctx.out(f"usage: nomad {family} <{('|'.join(subs))}>")
        return 1
    return subs[args[0]](ctx, args[1:])


COMMANDS: Dict[str, Callable[[Ctx, List[str]], int]] = {
    "agent": cmd_agent,
    "agent-info": cmd_agent_info,
    "monitor": cmd_monitor,
    "job": cmd_job,
    "node": cmd_node,
    "alloc": lambda c, a: _dispatch(
        c, a,
        {"status": cmd_alloc_status, "logs": cmd_alloc_logs, "fs": cmd_alloc_fs,
         "restart": cmd_alloc_restart, "signal": cmd_alloc_signal,
         "exec": cmd_alloc_exec, "stop": cmd_alloc_stop},
        "alloc",
    ),
    "eval": lambda c, a: _dispatch(c, a, {"status": cmd_eval_status}, "eval"),
    "deployment": cmd_deployment,
    "acl": cmd_acl,
    "operator": cmd_operator,
    "system": cmd_system,
    "server": cmd_server,
    "ui": cmd_ui,
    "version": cmd_version,
    # top-level aliases (reference keeps `nomad run` etc. working)
    "run": cmd_job_run,
    "plan": cmd_job_plan,
    "status": cmd_job_status,
    "stop": cmd_job_stop,
    "validate": cmd_job_validate,
    "inspect": cmd_job_inspect,
    "init": cmd_job_init,
    "logs": cmd_alloc_logs,
    "fs": cmd_alloc_fs,
    "exec": cmd_alloc_exec,
}


def main(argv: Optional[List[str]] = None, out: Callable[[str], None] = print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ctx = Ctx()
    ctx.out = out
    # a "--" terminator protects pass-through arguments (alloc exec
    # commands) from global-flag peeling: nothing after it is ours
    if "--" in argv:
        cut = argv.index("--")
        passthrough = argv[cut + 1:]
        argv = argv[:cut]
    else:
        passthrough = []
    # peel global flags wherever they appear (before any --)
    flags, rest = _split_flags(argv)
    _apply_global_flags(ctx, flags)
    # put non-global flags back for the subcommand (they were consumed;
    # simplest correct approach: re-split per command from the raw argv
    # minus global flag tokens)
    cleaned: List[str] = []
    skip = False
    for i, a in enumerate(argv):
        if skip:
            skip = False
            continue
        name = a.lstrip("-").partition("=")[0]
        if a.startswith("-") and name in ("address", "region", "namespace", "token"):
            if "=" not in a and i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                skip = True
            continue
        cleaned.append(a)
    cleaned.extend(passthrough)
    if not cleaned:
        out("usage: nomad <command> [args]")
        out("Commands: " + ", ".join(sorted(COMMANDS)))
        return 1
    cmd, args = cleaned[0], cleaned[1:]
    fn = COMMANDS.get(cmd)
    if fn is None:
        out(f"unknown command {cmd!r}")
        out("Commands: " + ", ".join(sorted(COMMANDS)))
        return 1
    try:
        return fn(ctx, args)
    except CLIError as e:
        out(f"Error: {e}")
        return 1
    except APIError as e:
        out(f"Error querying server: {e}")
        return 1
    except FileNotFoundError as e:
        out(f"Error: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
