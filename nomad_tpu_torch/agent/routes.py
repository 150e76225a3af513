"""/v1 HTTP endpoint handlers.

One section per noun, mirroring the reference's handler registry
(command/agent/http.go:151–224 → command/agent/*_endpoint.go). Handlers
take the parsed :class:`~nomad_tpu.agent.http.Request` and return plain
structs; the transport JSON-encodes them with reference-style keys.
Blocking queries ride the state store's ``blocking_query`` and stamp
``X-Nomad-Index`` via ``req.response_index``.

Copied from ``nomad_tpu/agent/routes.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change: jobs are parsed with the
port's ``jobspec``; metrics, trace, ``trace/distributed`` and flight
read the port's ``utils/metrics`` and ``trace``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from ..structs.structs import (
    Allocation,
    Evaluation,
    Job,
    Node,
    SchedulerConfiguration,
)
from . import jsonapi
from .http import HTTPError, HTTPServer, Request

MAX_BLOCKING_WAIT = 300.0  # cap like the reference's 5m default wait ceiling


def _blocking(req: Request, state, run: Callable[[Any], Any]):
    """Run a (possibly blocking) query and stamp the response index."""
    opts = req.options
    if opts.min_index > 0:
        result, index = state.blocking_query(
            run, opts.min_index, timeout=min(opts.wait or 5.0, MAX_BLOCKING_WAIT)
        )
    else:
        snap = state.snapshot()
        result, index = run(snap), snap.latest_index
    req.response_index = index
    return result


def _prefix_filter(items: List[Any], prefix: str, key=lambda o: o.id):
    if not prefix:
        return items
    return [o for o in items if key(o).startswith(prefix)]


def _require(obj, what: str):
    if obj is None:
        raise HTTPError(404, f"{what} not found")
    return obj


def _tail(req: Request, prefix: str) -> str:
    if not req.path.startswith(prefix):
        raise HTTPError(404, f"no handler for {req.path}")
    return req.path[len(prefix):]


class Routes:
    """Binds an Agent's server/client to an HTTPServer mux."""

    def __init__(self, agent) -> None:
        self.agent = agent

    # -- helpers ---------------------------------------------------------

    @property
    def server(self):
        if self.agent.server is None:
            raise HTTPError(501, "server is not enabled on this agent")
        return self.agent.server

    @property
    def state(self):
        return self.server.fsm.state

    @property
    def client(self):
        if self.agent.client is None:
            raise HTTPError(501, "client is not enabled on this agent")
        return self.agent.client

    def _authorize(self, req: Request, *capabilities: str, ns: str = "") -> None:
        """ACL enforcement choke point; no-op until ACLs are enabled."""
        self.agent.authorize(req, capabilities, ns or req.options.namespace)

    def register_all(self, mux: HTTPServer) -> None:
        r = mux.register
        r("/v1/jobs", self.jobs_index)
        r("/v1/jobs/parse", self.jobs_parse)
        r("/v1/job/", self.job_specific)
        r("/v1/nodes", self.nodes_index)
        r("/v1/node/", self.node_specific)
        r("/v1/allocations", self.allocs_index)
        r("/v1/allocation/", self.alloc_specific)
        r("/v1/evaluations", self.evals_index)
        r("/v1/evaluation/", self.eval_specific)
        r("/v1/deployments", self.deployments_index)
        r("/v1/deployment/", self.deployment_specific)
        r("/v1/status/leader", self.status_leader)
        r("/v1/status/peers", self.status_peers)
        r("/v1/operator/scheduler/configuration", self.operator_scheduler_config)
        r("/v1/operator/raft/configuration", self.operator_raft_config)
        r("/v1/operator/raft/peer", self.operator_raft_peer)
        r("/v1/operator/autopilot/configuration", self.operator_autopilot_config)
        r("/v1/operator/autopilot/health", self.operator_autopilot_health)
        r("/v1/agent/monitor", self.agent_monitor)
        r("/v1/agent/pprof", self.agent_pprof)
        r("/v1/system/gc", self.system_gc)
        r("/v1/system/reconcile/summaries", self.system_reconcile)
        r("/v1/agent/self", self.agent_self)
        r("/v1/agent/join", self.agent_join)
        r("/v1/agent/force-leave", self.agent_force_leave)
        r("/v1/agent/keyring/", self.agent_keyring)
        r("/v1/client/gc", self.client_gc)
        r("/v1/agent/health", self.agent_health)
        r("/v1/agent/servers", self.agent_servers)
        r("/v1/agent/members", self.agent_members)
        r("/v1/regions", self.regions)
        r("/v1/validate/job", self.validate_job)
        r("/v1/search", self.search)
        r("/v1/metrics", self.metrics)
        r("/v1/trace", self.trace)
        r("/v1/trace/distributed", self.trace_distributed)
        r("/v1/flight", self.flight)

    # -- jobs ------------------------------------------------------------

    def jobs_index(self, req: Request):
        if req.method == "GET":
            self._authorize(req, "read-job")
            ns = req.options.namespace

            def run(s):
                jobs = [j for j in s.jobs() if j.namespace == ns]
                return [_job_stub(j, s) for j in _prefix_filter(jobs, req.options.prefix)]

            return _blocking(req, self.state, run)
        if req.method in ("PUT", "POST"):
            self._authorize(req, "submit-job")
            payload = req.json()
            if not isinstance(payload, dict) or payload.get("Job") is None:
                raise HTTPError(400, "Job must be specified")
            job = jsonapi.from_json_obj(Job, payload["Job"])
            _canonicalize_job(job)
            eval_id = self.server.register_job(job)
            job = self.state.job_by_id(job.namespace, job.id)
            req.response_index = self.state.latest_index
            return {
                "EvalID": eval_id,
                "EvalCreateIndex": self.state.latest_index,
                "JobModifyIndex": job.job_modify_index if job else 0,
                "Index": self.state.latest_index,
            }
        raise HTTPError(405, "method not allowed")

    def jobs_parse(self, req: Request):
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        body = req.json()
        hcl = (body or {}).get("JobHCL", "")
        if not hcl:
            raise HTTPError(400, "JobHCL is empty")
        from ..jobspec import parse_job

        try:
            job = parse_job(hcl)
        except ValueError as e:
            raise HTTPError(400, f"error parsing jobspec: {e}")
        if (body or {}).get("Canonicalize"):
            _canonicalize_job(job)
        return job

    def job_specific(self, req: Request):
        rest = _tail(req, "/v1/job/")
        for suffix, fn in (
            ("/evaluate", self._job_evaluate),
            ("/allocations", self._job_allocations),
            ("/evaluations", self._job_evaluations),
            ("/versions", self._job_versions),
            ("/deployments", self._job_deployments),
            ("/deployment", self._job_latest_deployment),
            ("/summary", self._job_summary),
            ("/periodic/force", self._job_periodic_force),
            ("/dispatch", self._job_dispatch),
            ("/stable", self._job_stable),
            ("/revert", self._job_revert),
            ("/plan", self._job_plan),
        ):
            if rest.endswith(suffix):
                return fn(req, rest[: -len(suffix)])
        return self._job_crud(req, rest)

    def _job_crud(self, req: Request, job_id: str):
        ns = req.options.namespace
        if req.method == "GET":
            self._authorize(req, "read-job")
            return _blocking(
                req, self.state,
                lambda s: _require(s.job_by_id(ns, job_id), f"job {job_id!r}"),
            )
        if req.method in ("PUT", "POST"):  # update (same as register)
            self._authorize(req, "submit-job")
            payload = req.json()
            job = jsonapi.from_json_obj(Job, (payload or {}).get("Job") or {})
            _canonicalize_job(job)
            if job.id != job_id:
                raise HTTPError(400, f"job ID does not match request path ({job.id!r})")
            eval_id = self.server.register_job(job)
            req.response_index = self.state.latest_index
            return {"EvalID": eval_id, "Index": self.state.latest_index}
        if req.method == "DELETE":
            self._authorize(req, "submit-job")
            purge = req.param("purge") in ("true", "1")
            eval_id = self.server.deregister_job(ns, job_id, purge=purge)
            req.response_index = self.state.latest_index
            return {"EvalID": eval_id, "Index": self.state.latest_index}
        raise HTTPError(405, "method not allowed")

    def _job_evaluate(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        try:
            eval_id = self.server.evaluate_job(req.options.namespace, job_id)
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {"EvalID": eval_id, "Index": self.state.latest_index}

    def _job_allocations(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace
        all_allocs = req.param("all") in ("true", "1")
        return _blocking(
            req, self.state,
            lambda s: [_alloc_stub(a) for a in s.allocs_by_job(ns, job_id, all_allocs)],
        )

    def _job_evaluations(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace
        return _blocking(req, self.state, lambda s: s.evals_by_job(ns, job_id))

    def _job_versions(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace

        def run(s):
            versions = s.job_versions.get((ns, job_id), [])
            if not versions:
                raise HTTPError(404, f"job {job_id!r} not found")
            return {"Versions": versions, "Diffs": None}

        return _blocking(req, self.state, run)

    def _job_deployments(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace
        return _blocking(
            req, self.state,
            lambda s: [d for d in s.deployments()
                       if d.namespace == ns and d.job_id == job_id],
        )

    def _job_latest_deployment(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace
        return _blocking(
            req, self.state, lambda s: s.latest_deployment_by_job_id(ns, job_id)
        )

    def _job_summary(self, req: Request, job_id: str):
        self._authorize(req, "read-job")
        ns = req.options.namespace

        def run(s):
            _require(s.job_by_id(ns, job_id), f"job {job_id!r}")
            return {
                "JobID": job_id,
                "Namespace": ns,
                "Summary": s.job_summary(ns, job_id),
            }

        return _blocking(req, self.state, run)

    def _job_periodic_force(self, req: Request, job_id: str):
        self._authorize(req, "submit-job")
        try:
            child_id = self.server.periodic_dispatcher.force_launch(
                req.options.namespace, job_id
            )
        except KeyError as e:
            raise HTTPError(404, str(e))
        req.response_index = self.state.latest_index
        return {"EvalCreateIndex": self.state.latest_index, "Index": self.state.latest_index,
                "ChildJobID": child_id or ""}

    def _job_dispatch(self, req: Request, job_id: str):
        self._authorize(req, "dispatch-job")
        body = req.json() or {}
        import base64

        try:
            payload = base64.b64decode(body.get("Payload") or "")
        except Exception as e:
            raise HTTPError(400, f"invalid payload encoding: {e}")
        meta = body.get("Meta") or {}
        try:
            child_id, eval_id = self.server.dispatch_job(
                req.options.namespace, job_id, payload, meta
            )
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {
            "DispatchedJobID": child_id,
            "EvalID": eval_id,
            "EvalCreateIndex": self.state.latest_index,
            "JobCreateIndex": self.state.latest_index,
            "Index": self.state.latest_index,
        }

    def _job_stable(self, req: Request, job_id: str):
        self._authorize(req, "submit-job")
        body = req.json() or {}
        try:
            self.server.set_job_stability(
                req.options.namespace, job_id,
                int(body.get("JobVersion") or 0), bool(body.get("Stable")),
            )
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {"Index": self.state.latest_index}

    def _job_revert(self, req: Request, job_id: str):
        self._authorize(req, "submit-job")
        body = req.json() or {}
        try:
            eval_id = self.server.revert_job(
                req.options.namespace, job_id,
                int(body.get("JobVersion") or 0),
                body.get("EnforcePriorVersion"),
            )
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {"EvalID": eval_id, "Index": self.state.latest_index}

    def _job_plan(self, req: Request, job_id: str):
        self._authorize(req, "submit-job")
        payload = req.json()
        if not isinstance(payload, dict) or payload.get("Job") is None:
            raise HTTPError(400, "Job must be specified")
        job = jsonapi.from_json_obj(Job, payload["Job"])
        _canonicalize_job(job)
        if job.id != job_id:
            raise HTTPError(400, "job ID does not match request path")
        try:
            annotations, failed_tg_allocs, next_index, jdiff = self.server.plan_job(
                job, diff=bool(payload.get("Diff"))
            )
        except ValueError as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {
            "Annotations": annotations,
            "FailedTGAllocs": failed_tg_allocs,
            "JobModifyIndex": next_index,
            "Diff": jdiff,
            "Index": self.state.latest_index,
        }

    # -- nodes -----------------------------------------------------------

    def nodes_index(self, req: Request):
        self._authorize(req, "node:read")
        return _blocking(
            req, self.state,
            lambda s: [_node_stub(n) for n in _prefix_filter(s.nodes(), req.options.prefix)],
        )

    def node_specific(self, req: Request):
        rest = _tail(req, "/v1/node/")
        for suffix, fn in (
            ("/evaluate", self._node_evaluate),
            ("/allocations", self._node_allocations),
            ("/drain", self._node_drain),
            ("/eligibility", self._node_eligibility),
            ("/purge", self._node_purge),
        ):
            if rest.endswith(suffix):
                return fn(req, rest[: -len(suffix)])
        self._authorize(req, "node:read")
        return _blocking(
            req, self.state,
            lambda s: _require(s.node_by_id(rest), f"node {rest!r}").without_secret(),
        )

    def _node_evaluate(self, req: Request, node_id: str):
        self._authorize(req, "node:write")
        _require(self.state.node_by_id(node_id), f"node {node_id!r}")
        eval_ids = self.server.create_node_evals(node_id)
        req.response_index = self.state.latest_index
        return {"EvalIDs": eval_ids, "EvalCreateIndex": self.state.latest_index,
                "NodeModifyIndex": self.state.latest_index, "Index": self.state.latest_index}

    def _node_allocations(self, req: Request, node_id: str):
        self._authorize(req, "node:read")
        return _blocking(req, self.state, lambda s: s.allocs_by_node(node_id))

    def _node_drain(self, req: Request, node_id: str):
        self._authorize(req, "node:write")
        body = req.json() or {}
        spec = body.get("DrainSpec")
        drain = None
        if spec is not None:
            from ..structs.structs import DrainStrategy

            drain = DrainStrategy(
                deadline_ns=int(spec.get("Deadline") or 0),
                ignore_system_jobs=bool(spec.get("IgnoreSystemJobs")),
            )
        self.server.update_node_drain(node_id, drain)
        req.response_index = self.state.latest_index
        return {"NodeModifyIndex": self.state.latest_index, "Index": self.state.latest_index}

    def _node_eligibility(self, req: Request, node_id: str):
        self._authorize(req, "node:write")
        body = req.json() or {}
        eligibility = body.get("Eligibility") or ""
        if eligibility not in ("eligible", "ineligible"):
            raise HTTPError(400, f"invalid scheduling eligibility {eligibility!r}")
        self.server.update_node_eligibility(node_id, eligibility)
        req.response_index = self.state.latest_index
        return {"NodeModifyIndex": self.state.latest_index, "Index": self.state.latest_index}

    def _node_purge(self, req: Request, node_id: str):
        self._authorize(req, "node:write")
        self.server.deregister_node(node_id)
        req.response_index = self.state.latest_index
        return {"EvalIDs": [], "NodeModifyIndex": self.state.latest_index,
                "Index": self.state.latest_index}

    # -- allocations -----------------------------------------------------

    def allocs_index(self, req: Request):
        self._authorize(req, "read-job")
        ns = req.options.namespace

        def run(s):
            allocs = [a for a in s.allocs() if a.namespace == ns]
            return [_alloc_stub(a) for a in _prefix_filter(allocs, req.options.prefix)]

        return _blocking(req, self.state, run)

    def alloc_specific(self, req: Request):
        rest = _tail(req, "/v1/allocation/")
        if rest.endswith("/stop"):
            self._authorize(req, "alloc-lifecycle")
            alloc_id = rest[: -len("/stop")]
            eval_id = self.server.stop_alloc(alloc_id)
            req.response_index = self.state.latest_index
            return {"EvalID": eval_id, "Index": self.state.latest_index}
        self._authorize(req, "read-job")

        def run(s):
            alloc = _require(s.alloc_by_id(rest), f"alloc {rest!r}")
            if alloc.job is None:
                alloc = alloc.copy_skip_job()
                alloc.job = s.job_by_id(alloc.namespace, alloc.job_id)
            return alloc

        return _blocking(req, self.state, run)

    # -- evaluations -----------------------------------------------------

    def evals_index(self, req: Request):
        self._authorize(req, "read-job")
        return _blocking(
            req, self.state,
            lambda s: _prefix_filter(s.evals(), req.options.prefix),
        )

    def eval_specific(self, req: Request):
        rest = _tail(req, "/v1/evaluation/")
        if rest.endswith("/allocations"):
            eval_id = rest[: -len("/allocations")]
            self._authorize(req, "read-job")
            return _blocking(
                req, self.state,
                lambda s: [_alloc_stub(a) for a in s.allocs_by_eval(eval_id)],
            )
        self._authorize(req, "read-job")
        return _blocking(
            req, self.state,
            lambda s: _require(s.eval_by_id(rest), f"eval {rest!r}"),
        )

    # -- deployments -----------------------------------------------------

    def deployments_index(self, req: Request):
        self._authorize(req, "read-job")
        return _blocking(
            req, self.state,
            lambda s: _prefix_filter(s.deployments(), req.options.prefix),
        )

    def deployment_specific(self, req: Request):
        rest = _tail(req, "/v1/deployment/")
        dw = self.server.deployment_watcher
        try:
            if rest.startswith("promote/"):
                self._authorize(req, "submit-job")
                body = req.json() or {}
                groups = None if body.get("All") else body.get("Groups")
                dw.promote(rest[len("promote/"):], groups)
            elif rest.startswith("fail/"):
                self._authorize(req, "submit-job")
                dw.fail(rest[len("fail/"):])
            elif rest.startswith("pause/"):
                self._authorize(req, "submit-job")
                body = req.json() or {}
                dw.pause(rest[len("pause/"):], bool(body.get("Pause")))
            elif rest.startswith("allocation-health/"):
                self._authorize(req, "submit-job")
                body = req.json() or {}
                dw.set_alloc_health(
                    rest[len("allocation-health/"):],
                    body.get("HealthyAllocationIDs") or [],
                    body.get("UnhealthyAllocationIDs") or [],
                )
            elif rest.startswith("allocations/"):
                self._authorize(req, "read-job")
                d_id = rest[len("allocations/"):]
                return _blocking(
                    req, self.state,
                    lambda s: [_alloc_stub(a) for a in s.allocs()
                               if a.deployment_id == d_id],
                )
            else:
                self._authorize(req, "read-job")
                return _blocking(
                    req, self.state,
                    lambda s: _require(s.deployment_by_id(rest), f"deployment {rest!r}"),
                )
        except (ValueError,) as e:
            raise HTTPError(400, str(e))
        req.response_index = self.state.latest_index
        return {"EvalID": "", "Index": self.state.latest_index}

    # -- status / operator / system -------------------------------------

    def status_leader(self, req: Request):
        server = self.server
        if not server.is_leader:
            return "unknown"
        host, port = self.agent.http.addr
        return f"{host}:{port}"

    def status_peers(self, req: Request):
        return [p for p in self.agent.peer_names()]

    def operator_scheduler_config(self, req: Request):
        if req.method == "GET":
            self._authorize(req, "operator:read")
            index, config = self.state.scheduler_config()
            req.response_index = index
            return {"SchedulerConfig": config, "Index": index}
        if req.method in ("PUT", "POST"):
            self._authorize(req, "operator:write")
            body = req.json() or {}
            config = jsonapi.from_json_obj(SchedulerConfiguration, body)
            self.server.raft_apply("scheduler-config", config)
            return {"Updated": True, "Index": self.state.latest_index}
        raise HTTPError(405, "method not allowed")

    def operator_raft_config(self, req: Request):
        self._authorize(req, "operator:read")
        return {
            "Servers": [
                {"ID": name, "Node": name, "Address": addr, "Leader": leader,
                 "Voter": True}
                for name, addr, leader in self.agent.raft_servers()
            ],
            "Index": self.state.latest_index,
        }

    def operator_raft_peer(self, req: Request):
        """DELETE /v1/operator/raft/peer?id=<peer-id> — replicated removal
        of a raft peer (reference operator_endpoint.go RaftRemovePeerByID,
        command/agent/operator_endpoint.go:37)."""
        if req.method != "DELETE":
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "operator:write")
        peer_id = req.param("id")
        if not peer_id:
            raise HTTPError(400, "missing ?id=<peer-id>")
        self.agent.remove_raft_peer(peer_id)
        return {"Removed": peer_id, "Index": self.state.latest_index}

    def operator_autopilot_config(self, req: Request):
        from ..server.autopilot import AutopilotConfig

        if req.method == "GET":
            self._authorize(req, "operator:read")
            index, config = self.state.autopilot_config()
            req.response_index = index
            return config or AutopilotConfig()
        if req.method in ("PUT", "POST"):
            self._authorize(req, "operator:write")
            body = req.json() or {}
            config = jsonapi.from_json_obj(AutopilotConfig, body)
            self.server.raft_apply("autopilot-config", config)
            return {"Updated": True, "Index": self.state.latest_index}
        raise HTTPError(405, "method not allowed")

    def operator_autopilot_health(self, req: Request):
        self._authorize(req, "operator:read")
        if self.agent.autopilot is None:
            raise HTTPError(404, "autopilot requires a server-mode agent")
        servers = self.agent.autopilot.server_health()
        healthy = all(s.healthy for s in servers) if servers else False
        voters = sum(1 for s in servers if s.voter and s.healthy)
        return {
            "Healthy": healthy,
            "FailureTolerance": max(0, voters - (len(servers) // 2 + 1)),
            "Servers": [jsonapi.to_json_obj(s) for s in servers],
        }

    def agent_monitor(self, req: Request):
        """Agent log tail (reference /v1/agent/monitor). Default is one
        poll; ``follow=true`` keeps the response open and SERVER-PUSHES
        new log lines as they are emitted (chunked, one line per chunk
        batch — the reference's streaming monitor frames)."""
        self._authorize(req, "agent:read")
        try:
            seq = int(req.param("seq", "0"))
        except ValueError:
            raise HTTPError(400, "seq must be an integer")
        level = req.param("log_level", "info")
        if req.param("follow", "") not in ("true", "1"):
            return self.agent.monitor.tail(seq=seq, level=level)

        monitor = self.agent.monitor

        def stream():
            import time as time_mod

            cursor = seq
            # idle cap bounds abandoned followers (disconnects are only
            # observable on write)
            idle_deadline = time_mod.monotonic() + 600.0
            while True:
                out = monitor.tail(seq=cursor, level=level)
                lines, cursor = out["Lines"], out["Seq"]
                if lines:
                    idle_deadline = time_mod.monotonic() + 600.0
                    yield ("\n".join(lines) + "\n").encode()
                    continue
                if time_mod.monotonic() > idle_deadline:
                    return
                time_mod.sleep(0.25)

        from .http import StreamingResponse

        return StreamingResponse(stream(), content_type="text/plain")

    def agent_pprof(self, req: Request):
        """Debug dumps gated on enable_debug (http.go:220 pprof)."""
        if not self.agent.config.enable_debug:
            raise HTTPError(404, "debug endpoints disabled (enable_debug)")
        self._authorize(req, "agent:read")
        kind = req.param("type", "threads")
        from . import monitor as monitor_mod

        if kind in ("threads", "goroutine"):
            return monitor_mod.thread_dump().encode()
        if kind == "heap":
            return monitor_mod.heap_dump()
        raise HTTPError(400, f"unknown profile type {kind!r}")

    def system_gc(self, req: Request):
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "operator:write")
        self.server.force_gc()
        return {}

    def system_reconcile(self, req: Request):
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "operator:write")
        return {}

    # -- agent -----------------------------------------------------------

    def agent_self(self, req: Request):
        self._authorize(req, "agent:read")
        return self.agent.self_info()

    def agent_health(self, req: Request):
        out = {}
        if self.agent.server is not None:
            out["server"] = {"ok": True, "message": "ok"}
        if self.agent.client is not None:
            out["client"] = {"ok": True, "message": "ok"}
        return out

    def agent_servers(self, req: Request):
        self._authorize(req, "agent:read")
        return self.agent.known_servers()

    def agent_members(self, req: Request):
        self._authorize(req, "agent:read")
        return {"ServerName": self.agent.config.name,
                "ServerRegion": self.agent.config.region,
                "ServerDC": self.agent.config.datacenter,
                "Members": self.agent.members()}

    def agent_join(self, req: Request):
        """PUT /v1/agent/join?address=host:port[&address=...] — runtime
        gossip join (reference command/agent/http.go:181 + agent
        endpoint Join)."""
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "agent:write")
        addrs = req.query.get("address") or []
        if not addrs:
            raise HTTPError(400, "missing ?address=host:port")
        try:
            n = self.agent.join(addrs)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return {"num_joined": n, "error": "" if n else "no peers responded"}

    def agent_force_leave(self, req: Request):
        """PUT /v1/agent/force-leave?node=<name> — evict a (failed)
        member from gossip (reference http.go:183, serf RemoveFailedNode)."""
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "agent:write")
        node = req.param("node")
        if not node:
            raise HTTPError(400, "missing ?node=<name>")
        try:
            ok = self.agent.force_leave(node)
        except ValueError as e:
            raise HTTPError(400, str(e))
        if not ok:
            raise HTTPError(404, f"unknown member {node!r}")
        return {}

    def agent_keyring(self, req: Request):
        """/v1/agent/keyring/<list|install|use|remove> — gossip keyring
        rotation (reference http.go:185 + serf keyring protocol)."""
        op = req.path[len("/v1/agent/keyring/"):].strip("/")
        if op == "list":
            self._authorize(req, "agent:write")
            try:
                keys = self.agent.keyring("list", "")
            except ValueError as e:
                raise HTTPError(400, str(e))
            num_nodes = len(self.agent.members()) or 1
            return {
                "Keys": {k: num_nodes for k in keys},
                # serf's keyring -list contract: the sealing key is named
                # explicitly, not implied by map order
                "PrimaryKeys": {keys[0]: num_nodes} if keys else {},
                "NumNodes": num_nodes,
            }
        if op not in ("install", "use", "remove"):
            raise HTTPError(404, f"unknown keyring op {op!r}")
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "agent:write")
        body = req.json() or {}
        key = body.get("Key", "")
        if not key:
            raise HTTPError(400, "missing Key")
        try:
            self.agent.keyring(op, key)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return {}

    def client_gc(self, req: Request):
        """PUT /v1/client/gc — force terminal-alloc GC on this node
        (reference http.go:176 -> client/gc.go CollectAll). Destructive:
        GET is rejected like the sibling cluster-ops endpoints."""
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        self._authorize(req, "node:write")
        if self.agent.client is None:
            raise HTTPError(400, "agent is not running a client")
        collected = self.agent.client.garbage_collect(force=True)
        return {"Collected": collected}

    def regions(self, req: Request):
        return self.agent.regions()

    def metrics(self, req: Request):
        """Telemetry snapshot (reference http.go:189 /v1/metrics; supports
        ?format=prometheus like the reference)."""
        from ..utils.metrics import global_sink

        if req.param("format") == "prometheus":
            return global_sink().prometheus().encode()
        return global_sink().summary()

    def trace(self, req: Request):
        """Eval-lifecycle trace snapshot (nomad-trace): tail-latency
        summary, in-flight eval records (enqueue -> dequeue -> invoke ->
        submit -> apply stamps, host/device path, OCC attempt), recent
        completions, and — when this agent runs a server — per-worker
        current spans and the device batcher's dispatch profile.
        ?recent=N bounds the completed-record tail (default 64)."""
        from ..trace import lifecycle

        try:
            recent = int(req.param("recent") or 64)
        except ValueError:
            raise HTTPError(400, "recent must be an integer")
        out = lifecycle.snapshot(recent=max(0, recent))
        srv = self.agent.server
        if srv is not None:
            out["workers"] = srv.watchdog.worker_spans()
            if srv.device_batcher is not None:
                out["dispatch_profile"] = srv.device_batcher.dispatch_profile()
        return out

    def trace_distributed(self, req: Request):
        """Stitched cross-process trace view (nomad-xtrace): this
        process's span ring merged into per-trace span trees, with the
        stitched bottleneck ledger and the per-method RPC table. A
        single-agent view covers one process; chaos harnesses stitch all
        replicas via Trace.Export. ?recent=N bounds the trace tail
        (default 16)."""
        from ..rpc import transport
        from ..trace import attribution, context, stitch

        try:
            recent = int(req.param("recent") or 16)
        except ValueError:
            raise HTTPError(400, "recent must be an integer")
        exported = context.export()
        out = stitch.stitch([exported["spans"]], recent=max(0, recent))
        out["stitched_report"] = attribution.stitched_report(out.pop("spans"))
        out["rpc"] = transport.rpc_stats()
        out["dropped"] = exported["dropped"]
        return out

    def flight(self, req: Request):
        """Flight-recorder snapshot (nomad-flightrec): the last N frames
        of the leader's continuous sampler plus the live critical-path
        bottleneck report. ?recent=N bounds the frame tail (default 64);
        a non-server (client-only) agent serves the attribution report
        with no frames."""
        from ..trace import attribution

        try:
            recent = int(req.param("recent") or 64)
        except ValueError:
            raise HTTPError(400, "recent must be an integer")
        srv = self.agent.server
        if srv is not None:
            out = srv.flight.snapshot(recent=max(0, recent))
        else:
            out = {"armed": False, "frames": []}
        out["bottleneck_report"] = attribution.bottleneck_report()
        return out

    def search(self, req: Request):
        """Prefix search across objects (reference nomad/search_endpoint.go;
        truncates at 20 matches per context like truncateLimitQuery)."""
        if req.method not in ("PUT", "POST"):
            raise HTTPError(405, "method not allowed")
        body = req.json() or {}
        prefix = body.get("Prefix", "")
        context = body.get("Context", "all") or "all"
        ns = req.options.namespace
        limit = 20
        state = self.state
        sources = {
            "jobs": lambda: sorted(
                j.id for j in state.jobs() if j.namespace == ns and j.id.startswith(prefix)
            ),
            "evals": lambda: sorted(
                e.id for e in state.evals() if e.id.startswith(prefix)
            ),
            "allocs": lambda: sorted(
                a.id for a in state.allocs() if a.id.startswith(prefix)
            ),
            "nodes": lambda: sorted(
                n.id for n in state.nodes() if n.id.startswith(prefix)
            ),
            "deployment": lambda: sorted(
                d.id for d in state.deployments() if d.id.startswith(prefix)
            ),
        }
        if context != "all":
            if context not in sources:
                raise HTTPError(400, f"invalid search context {context!r}")
            wanted = [context]
        else:
            wanted = list(sources)
        cap_for = {
            "jobs": "read-job",
            "evals": "read-job",
            "allocs": "read-job",
            "deployment": "read-job",
            "nodes": "node:read",
        }
        matches: Dict[str, List[str]] = {}
        truncations: Dict[str, bool] = {}
        for ctx in wanted:
            self._authorize(req, cap_for[ctx])
            ids = sources[ctx]()
            truncations[ctx] = len(ids) > limit
            matches[ctx] = ids[:limit]
        req.response_index = self.state.latest_index
        return {"Matches": matches, "Truncations": truncations, "Index": self.state.latest_index}

    def validate_job(self, req: Request):
        self._authorize(req, "read-job")
        payload = req.json()
        if not isinstance(payload, dict) or payload.get("Job") is None:
            raise HTTPError(400, "Job must be specified")
        job = jsonapi.from_json_obj(Job, payload["Job"])
        _canonicalize_job(job)
        errors = _validate_job(job)
        return {
            "DriverConfigValidated": True,
            "ValidationErrors": errors,
            "Error": "; ".join(errors) if errors else "",
        }


# ---------------------------------------------------------------------------
# Stubs — trimmed list views, like the reference's structs.JobListStub etc.
# ---------------------------------------------------------------------------


def _job_stub(job: Job, state) -> dict:
    return {
        "ID": job.id,
        "ParentID": job.parent_id,
        "Name": job.name,
        "Namespace": job.namespace,
        "Datacenters": job.datacenters,
        "Type": job.type,
        "Priority": job.priority,
        "Periodic": job.is_periodic(),
        "ParameterizedJob": job.is_parameterized(),
        "Stop": job.stop,
        "Status": job.status,
        "StatusDescription": job.status_description,
        "JobSummary": {"JobID": job.id, "Namespace": job.namespace,
                       "Summary": state.job_summary(job.namespace, job.id)},
        "CreateIndex": job.create_index,
        "ModifyIndex": job.modify_index,
        "JobModifyIndex": job.job_modify_index,
        "SubmitTime": 0,
        "Version": job.version,
    }


def _alloc_stub(alloc: Allocation) -> dict:
    return {
        "ID": alloc.id,
        "EvalID": alloc.eval_id,
        "Name": alloc.name,
        "Namespace": alloc.namespace,
        "NodeID": alloc.node_id,
        "NodeName": alloc.node_name,
        "JobID": alloc.job_id,
        "JobType": alloc.job.type if alloc.job else "",
        "JobVersion": alloc.job.version if alloc.job else 0,
        "TaskGroup": alloc.task_group,
        "DesiredStatus": alloc.desired_status,
        "DesiredDescription": alloc.desired_description,
        "ClientStatus": alloc.client_status,
        "ClientDescription": alloc.client_description,
        "DeploymentStatus": jsonapi.to_json_obj(alloc.deployment_status),
        "FollowupEvalID": alloc.followup_eval_id,
        "TaskStates": jsonapi.to_json_obj(alloc.task_states),
        "CreateIndex": alloc.create_index,
        "ModifyIndex": alloc.modify_index,
        "CreateTime": alloc.create_time_ns,
        "ModifyTime": alloc.modify_time_ns,
    }


def _node_stub(node: Node) -> dict:
    return {
        "ID": node.id,
        "Datacenter": node.datacenter,
        "Name": node.name,
        "NodeClass": node.node_class,
        "Version": node.attributes.get("nomad.version", ""),
        "Drain": node.drain,
        "SchedulingEligibility": node.scheduling_eligibility,
        "Status": node.status,
        "StatusDescription": node.status_description,
        "CreateIndex": node.create_index,
        "ModifyIndex": node.modify_index,
    }


def _canonicalize_job(job: Job) -> None:
    """Fill defaults the way api.Job.Canonicalize does."""
    if not job.id:
        raise HTTPError(400, "Job ID is missing")
    if not job.name:
        job.name = job.id
    if not job.namespace:
        job.namespace = "default"
    if not job.datacenters:
        job.datacenters = ["dc1"]
    for tg in job.task_groups:
        if tg.count == 0:
            tg.count = 1


def _validate_job(job: Job) -> List[str]:
    errors = []
    if not job.id:
        errors.append("job ID is required")
    if not job.task_groups:
        errors.append("job must have at least one task group")
    seen = set()
    for tg in job.task_groups:
        if tg.name in seen:
            errors.append(f"duplicate task group {tg.name!r}")
        seen.add(tg.name)
        if tg.count < 0:
            errors.append(f"task group {tg.name!r} has negative count")
        if not tg.tasks:
            errors.append(f"task group {tg.name!r} has no tasks")
    return errors
