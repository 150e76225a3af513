"""E2E suites over real agent processes (reference e2e/: rescheduling/,
spread/, deployment/, clientstate/) — black-box through the SDK only.

The single-agent half of ``tests/test_e2e.py`` on the port, every agent
the port's CLI on the CPU; the cluster half (``TestClusterOpsE2E``,
``TestServerFailoverE2E``) is in ``tests/test_torch_e2e_cluster.py``.
"""
import os
import time

import pytest

from torch_e2e_framework import (
    AgentProc,
    allocs_of,
    running_allocs,
    service_job,
    wait_until,
)


@pytest.fixture(scope="module")
def dev():
    agent = AgentProc("-dev", "-no-gossip", name="dev")
    yield agent
    agent.stop()


class TestJobLifecycle:
    def test_run_update_stop(self, dev):
        api = dev.api
        job = service_job("e2e-life", count=2, command="sleep 300")
        api.jobs.register(job)
        wait_until(lambda: len(running_allocs(api, "e2e-life")) == 2,
                   msg="2 allocs running")
        # scale down via re-register
        job["TaskGroups"][0]["Count"] = 1
        api.jobs.register(job)
        wait_until(lambda: len(running_allocs(api, "e2e-life")) == 1,
                   msg="scaled to 1")
        api.jobs.deregister("e2e-life")
        wait_until(lambda: not running_allocs(api, "e2e-life"),
                   msg="all stopped")


class TestRescheduling:
    def test_failed_alloc_rescheduled(self, dev):
        """reference e2e/rescheduling: a dying task is replaced on a new
        alloc rather than restarted forever in place."""
        api = dev.api
        job = service_job("e2e-resched", count=1, command="exit 1")
        job["TaskGroups"][0]["Tasks"][0]["RestartPolicy"] = {
            "Attempts": 0, "Mode": "fail", "IntervalNs": 5_000_000_000,
            "DelayNs": 100_000_000,
        }
        job["TaskGroups"][0]["ReschedulePolicy"] = {
            "Attempts": 2, "IntervalNs": 60_000_000_000,
            "DelayNs": 500_000_000, "DelayFunction": "constant",
            "Unlimited": False,
        }
        api.jobs.register(job)
        wait_until(
            lambda: len([a for a in allocs_of(api, "e2e-resched")
                         if a["ClientStatus"] == "failed"]) >= 1
            and len(allocs_of(api, "e2e-resched")) >= 2,
            msg="failed alloc replaced by reschedule",
        )
        # replacements chain via PreviousAllocation/NextAllocation
        allocs = allocs_of(api, "e2e-resched")
        infos = [api.allocations.info(a["ID"])[0] for a in allocs]
        assert any(i.get("PreviousAllocation") for i in infos), \
            "reschedule links predecessor"


class TestSpreadAcrossNodes:
    def test_allocs_spread_on_two_clients(self):
        """reference e2e/spread: a spread stanza distributes allocs
        across client nodes (real server + 2 real client processes)."""
        server = AgentProc("-server", "-no-gossip", name="spread-srv")
        # discover the server's RPC address through its API
        raft, _ = server.api.get("/v1/operator/raft/configuration")
        rpc_addr = raft["Servers"][0]["Address"]
        clients = [
            AgentProc("-client", "-servers", rpc_addr, "-no-gossip",
                      "-node-class", f"rack{i}", name=f"spread-c{i}")
            for i in range(2)
        ]
        try:
            api = server.api
            wait_until(lambda: len((api.nodes.list()[0]) or []) == 2,
                       timeout=180, msg="2 nodes registered")
            job = service_job("e2e-spread", count=4, command="sleep 300")
            job["TaskGroups"][0]["Spreads"] = [
                {"Attribute": "${node.class}", "Weight": 100}
            ]
            api.jobs.register(job)
            wait_until(lambda: len(running_allocs(api, "e2e-spread")) == 4,
                       timeout=180, msg="4 allocs running")
            nodes_used = {a["NodeID"] for a in running_allocs(api, "e2e-spread")}
            assert len(nodes_used) == 2, "spread across both nodes"
            per_node = [sum(1 for a in running_allocs(api, "e2e-spread")
                            if a["NodeID"] == n) for n in nodes_used]
            assert sorted(per_node) == [2, 2], f"even spread, got {per_node}"
        finally:
            for c in clients:
                c.stop()
            server.stop()


class TestDeployment:
    def test_rolling_update_completes(self, dev):
        """reference e2e/deployment: an update stanza drives a rolling
        deployment to 'successful'."""
        api = dev.api
        job = service_job("e2e-deploy", count=2, command="sleep 300")
        job["TaskGroups"][0]["Update"] = {
            "MaxParallel": 1, "MinHealthyTimeNs": 100_000_000,
            "HealthyDeadlineNs": 30_000_000_000,
        }
        api.jobs.register(job)
        wait_until(lambda: len(running_allocs(api, "e2e-deploy")) == 2,
                   msg="initial rollout")
        # destructive update → new deployment
        job["TaskGroups"][0]["Tasks"][0]["Config"]["args"] = ["-c", "sleep 301"]
        api.jobs.register(job)

        def deployment_successful():
            deps, _ = api.jobs.deployments("e2e-deploy")
            return any(d["Status"] == "successful" and d["JobVersion"] >= 1
                       for d in deps or [])

        wait_until(deployment_successful, timeout=90,
                   msg="rolling deployment successful")


class TestClientState:
    def test_hard_kill_recovery(self, tmp_path_factory):
        """reference e2e/clientstate: kill -9 the agent; a restarted agent
        with the same data dir re-attaches to the live task instead of
        starting a second copy."""
        data_dir = str(tmp_path_factory.mktemp("e2e-state"))
        marker = os.path.join(data_dir, "counter")
        agent = AgentProc("-dev", "-no-gossip", "-data-dir", data_dir,
                          name="state-1")
        try:
            api = agent.api
            # the task appends its pid once at start: a restarted task
            # would append again
            job = service_job(
                "e2e-state", count=1,
                command=f"echo $$ >> {marker}; sleep 600",
            )
            api.jobs.register(job)
            wait_until(lambda: len(running_allocs(api, "e2e-state")) == 1,
                       timeout=150, msg="alloc running")
            wait_until(lambda: os.path.exists(marker), msg="task marker")
            pid_before = open(marker).read().strip()

            agent.kill_hard()
            # the task itself survives the agent's death (detached)
            assert open(marker).read().strip() == pid_before

            agent2 = AgentProc("-dev", "-no-gossip", "-data-dir", data_dir,
                               name="state-2")
            try:
                api2 = agent2.api
                wait_until(lambda: len(running_allocs(api2, "e2e-state")) == 1,
                           timeout=150, msg="alloc recovered after restart")
                time.sleep(1.0)
                assert open(marker).read().strip() == pid_before, \
                    "task re-attached, not restarted"
            finally:
                agent2.stop()
        finally:
            agent.stop()


class TestAffinities:
    """reference e2e/affinities: placements follow affinity weights."""

    def test_affinity_steers_placements(self):
        server = AgentProc("-server", "-no-gossip", name="aff-srv")
        raft, _ = server.api.get("/v1/operator/raft/configuration")
        rpc_addr = raft["Servers"][0]["Address"]
        clients = [
            AgentProc("-client", "-servers", rpc_addr, "-no-gossip",
                      "-node-class", f"aff-r{i}", name=f"aff-c{i}")
            for i in range(2)
        ]
        try:
            api = server.api
            wait_until(lambda: len(api.nodes.list()[0] or []) == 2,
                       timeout=180, msg="both nodes registered")
            # placements 1..count-1 strictly favor the affinity node
            # (anti = -(c+1)/count > -1 while c+1 < count); the FINAL
            # placement's +1 affinity and -1 anti-affinity cancel exactly
            # and the winner is capacity-dependent — assert count-1
            job = service_job("e2e-aff", count=4, command="sleep 300")
            job["Affinities"] = [{
                "LTarget": "${node.class}", "RTarget": "aff-r1",
                "Operand": "=", "Weight": 100,
            }]
            api.jobs.register(job)
            wait_until(lambda: len(running_allocs(api, "e2e-aff")) == 4,
                       timeout=120, msg="4 allocs running")
            nodes, _ = api.nodes.list()
            class_of = {n["ID"]: n.get("NodeClass", "") for n in nodes}
            placements = [class_of[a["NodeID"]]
                          for a in running_allocs(api, "e2e-aff")]
            # strong positive affinity: all but (possibly) the tying
            # final placement land on the affinity node
            assert placements.count("aff-r1") >= 3, placements
        finally:
            for c in clients:
                c.stop()
            server.stop()


class TestNomadExec:
    """reference e2e/nomadexec: command execution inside a live task."""

    def test_exec_and_fs_roundtrip(self, dev):
        api = dev.api
        job = service_job("e2e-exec",
                          command="echo bootmark > $NOMAD_TASK_DIR/mark; sleep 300")
        api.jobs.register(job)
        wait_until(lambda: running_allocs(api, "e2e-exec"), msg="alloc running")
        alloc = running_allocs(api, "e2e-exec")[0]

        # one-shot exec runs INSIDE the task env
        res, _ = api.allocations.exec_task(
            alloc["ID"], "t", ["/bin/sh", "-c", "echo from-exec; exit 7"])
        assert "from-exec" in res["Output"] and res["ExitCode"] == 7

        # fs API sees the file the task wrote
        data = api.alloc_fs.cat(alloc["ID"], "t/local/mark")
        assert data.strip() == b"bootmark"
        entries, _ = api.alloc_fs.ls(alloc["ID"], "t/local")
        assert any(e["Name"] == "mark" for e in entries)

        # task logs captured
        logs = api.alloc_fs.logs(alloc["ID"], "t", "stdout")
        assert isinstance(logs, (bytes, str))
        api.jobs.deregister("e2e-exec")


class TestMetricsE2E:
    """reference e2e/metrics: telemetry visible after scheduling load."""

    def test_scheduler_counters_present(self, dev):
        api = dev.api
        job = service_job("e2e-metrics", count=2, command="sleep 300")
        # the inmem sink aggregates in 10s intervals and /v1/metrics shows
        # the current one: poll from the registration on, so that the
        # interval in which this job's eval lands its scheduling counters
        # is read while it is current (a slow "allocs running" wait
        # under load can outlast it), and keep every name seen
        seen = set()

        def scheduler_and_plan_counters():
            m = api.agent.metrics()
            seen.update(c["Name"] for c in m.get("Counters", []))
            seen.update(s["Name"] for s in m.get("Samples", []))
            return (any("invoke_scheduler" in n for n in seen)
                    and any("plan" in n for n in seen))

        api.jobs.register(job)
        wait_until(scheduler_and_plan_counters, timeout=30, interval=0.1,
                   msg="scheduler+plan counters in the interval they landed in")
        wait_until(lambda: len(running_allocs(api, "e2e-metrics")) == 2,
                   msg="allocs running")
        # prometheus format serves too
        import urllib.request

        with urllib.request.urlopen(
            dev.http_addr + "/v1/metrics?format=prometheus", timeout=10
        ) as resp:
            text = resp.read().decode()
        assert "nomad_" in text and "# TYPE" in text
        api.jobs.deregister("e2e-metrics")


class TestParameterizedDispatch:
    """reference e2e (dispatch/periodic slot): parameterized job dispatch
    creates child jobs with payloads."""

    def test_dispatch_with_payload(self, dev):
        api = dev.api
        job = service_job("e2e-batch-param", count=1,
                          command='cat $NOMAD_TASK_DIR/input.txt > $NOMAD_TASK_DIR/out; sleep 300')
        job["Type"] = "batch"
        job["ParameterizedJob"] = {"Payload": "required"}
        job["TaskGroups"][0]["Tasks"][0]["DispatchPayloadFile"] = "input.txt"
        api.jobs.register(job)

        out, _ = api.jobs.dispatch("e2e-batch-param", payload=b"dispatched-data")
        child_id = out["DispatchedJobID"]
        wait_until(lambda: running_allocs(api, child_id), msg="child running")
        alloc = running_allocs(api, child_id)[0]
        wait_until(lambda: api.alloc_fs.cat(alloc["ID"], "t/local/out").strip()
                   == b"dispatched-data", msg="payload delivered")


class TestHostVolumes:
    """reference e2e/hostvolumes: a client-declared host volume is
    scheduled against (HostVolumeChecker) and mounted into the task."""

    def test_volume_scheduling_and_mount(self, tmp_path_factory):
        host_dir = tmp_path_factory.mktemp("hostvol")
        (host_dir / "seed.txt").write_text("from-the-host")
        agent = AgentProc("-dev", "-no-gossip",
                          "-host-volume", f"shared={host_dir}",
                          name="hv-agent")
        try:
            api = agent.api
            # the node advertises the volume
            nodes, _ = api.nodes.list()
            info, _ = api.nodes.info(nodes[0]["ID"])
            assert "shared" in (info.get("HostVolumes") or {})

            job = service_job(
                "e2e-hv", count=1,
                command="cat data/seed.txt > $NOMAD_TASK_DIR/copied; "
                        "echo task-was-here > data/written.txt; sleep 300",
            )
            job["TaskGroups"][0]["Volumes"] = {
                "data": {"Name": "data", "Type": "host", "Source": "shared"},
            }
            job["TaskGroups"][0]["Tasks"][0]["VolumeMounts"] = [
                {"Volume": "data", "Destination": "data"},
            ]
            api.jobs.register(job)
            # generous: suite-context CPU contention (jax compiles on all
            # cores) can starve the agent for a while
            wait_until(lambda: running_allocs(api, "e2e-hv"), timeout=180,
                       msg="alloc running")
            alloc = running_allocs(api, "e2e-hv")[0]
            # the task read host data through the mount...
            wait_until(lambda: api.alloc_fs.cat(
                alloc["ID"], "t/local/copied").strip() == b"from-the-host",
                msg="host file visible through mount")
            # ...and wrote back to the HOST through it
            wait_until(lambda: (host_dir / "written.txt").exists(),
                       msg="task write landed on the host volume")
            assert (host_dir / "written.txt").read_text().strip() == "task-was-here"

            # a job demanding a MISSING volume doesn't place
            bad = service_job("e2e-hv-missing", count=1, command="sleep 30")
            bad["TaskGroups"][0]["Volumes"] = {
                "data": {"Name": "data", "Type": "host", "Source": "no-such"},
            }
            api.jobs.register(bad)
            evals_seen = []
            def blocked():
                evs, _ = api.jobs.evaluations("e2e-hv-missing")
                evals_seen[:] = evs or []
                return any(e.get("Status") == "complete"
                           and e.get("FailedTGAllocs") for e in evals_seen)
            wait_until(blocked, timeout=120, msg="missing volume fails placement")
            assert not running_allocs(api, "e2e-hv-missing")
        finally:
            agent.stop()
