"""API SDK tests against a live dev agent (reference api/*_test.go driven by
testutil.TestServer — here in-process instead of fork-exec).

The port's copy of ``tests/test_api_sdk.py``: every agent and server on
the CPU (``device="cpu"``).
"""

import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.jsonapi import dumps, loads
from nomad_tpu_torch.api import APIError, Client, Config, QueryOptions
from nomad_tpu_torch.structs.structs import RestartPolicy

import json


@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu", dev_mode=True, num_schedulers=2, name="sdk-dev"))
    a.start()
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def client(agent):
    return Client(Config(address=agent.http_addr))


def service_job_json(job_id: str, count: int = 1):
    job = mock.job()
    job.id = job_id
    job.name = job_id
    job.task_groups[0].count = count
    task = job.task_groups[0].tasks[0]
    task.driver = "mock"
    task.config = {"run_for": "10s"}
    task.restart_policy = RestartPolicy(attempts=0, mode="fail")
    return json.loads(dumps(job))


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_agent_and_status(client):
    info = client.agent.self()
    assert info["config"]["Server"]["Enabled"] is True
    assert client.agent.health()["server"]["ok"]
    assert ":" in client.status.leader()
    assert client.regions.list() == ["global"]


def test_job_lifecycle(client):
    jobs, meta = client.jobs.list()
    assert jobs == []

    out, wm = client.jobs.register(service_job_json("sdk-job", count=2))
    assert out["EvalID"]
    assert wm.last_index > 0

    info, qm = client.jobs.info("sdk-job")
    assert info["ID"] == "sdk-job"
    assert qm.last_index > 0

    # allocations eventually placed by the scheduler
    wait_for(
        lambda: len(client.jobs.allocations("sdk-job")[0]) == 2,
        msg="allocs placed",
    )
    allocs, _ = client.jobs.allocations("sdk-job")
    assert {a["JobID"] for a in allocs} == {"sdk-job"}

    evals, _ = client.jobs.evaluations("sdk-job")
    assert evals and evals[0]["JobID"] == "sdk-job"

    ev, _ = client.evaluations.info(evals[0]["ID"])
    assert ev["ID"] == evals[0]["ID"]

    alloc, _ = client.allocations.info(allocs[0]["ID"])
    assert alloc["ID"] == allocs[0]["ID"]

    summary, _ = client.jobs.summary("sdk-job")
    assert summary["JobID"] == "sdk-job"

    out, _ = client.jobs.deregister("sdk-job", purge=True)
    assert out["EvalID"]


def test_blocking_query_wakes_on_write(client):
    _, meta = client.jobs.list()
    idx = meta.last_index
    results = {}

    def blocker():
        # standard long-poll loop: any write wakes the query; re-issue with
        # the returned index until the object of interest shows up
        wait_index = idx
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            jobs, m2 = client.jobs.list(
                QueryOptions(wait_index=wait_index, wait_time="10s")
            )
            results["jobs"] = jobs
            results["index"] = m2.last_index
            if any(j["ID"] == "sdk-block" for j in jobs):
                return
            wait_index = max(wait_index + 1, m2.last_index)

    t = threading.Thread(target=blocker)
    t.start()
    time.sleep(0.2)
    client.jobs.register(service_job_json("sdk-block"))
    t.join(timeout=10)
    assert not t.is_alive()
    assert results["index"] > idx
    assert any(j["ID"] == "sdk-block" for j in results["jobs"])
    client.jobs.deregister("sdk-block", purge=True)


def test_nodes_api(client):
    wait_for(lambda: len(client.nodes.list()[0]) == 1, msg="node registered")
    nodes, _ = client.nodes.list()
    node_id = nodes[0]["ID"]
    info, _ = client.nodes.info(node_id)
    assert info["ID"] == node_id
    allocs, _ = client.nodes.allocations(node_id)
    assert isinstance(allocs, list)

    out, _ = client.nodes.toggle_eligibility(node_id, eligible=False)
    info, _ = client.nodes.info(node_id)
    assert info["SchedulingEligibility"] == "ineligible"
    client.nodes.toggle_eligibility(node_id, eligible=True)


def test_parse_and_plan_and_validate(client):
    hcl = 'job "planme" { datacenters=["dc1"] group "g" { task "t" { driver="mock" config { run_for = "5s" } } } }'
    parsed = client.jobs.parse_hcl(hcl)
    assert parsed["ID"] == "planme"

    res = client.jobs.validate(parsed)[0]
    assert res["ValidationErrors"] == []

    plan, _ = client.jobs.plan(parsed, diff=True)
    assert plan["Diff"]["Type"] in ("Added", "added", "Edited", "None")


def test_operator_api(client):
    cfg, _ = client.operator.scheduler_get_configuration()
    assert "SchedulerConfig" in cfg
    raft, _ = client.operator.raft_get_configuration()
    assert raft["Servers"]


def test_search(client):
    client.jobs.register(service_job_json("searchable-job"))
    out = client.search.prefix_search("searchable", context="jobs")
    assert out["Matches"]["jobs"] == ["searchable-job"]
    assert out["Truncations"]["jobs"] is False
    out = client.search.prefix_search("searchable", context="all")
    assert "nodes" in out["Matches"]
    with pytest.raises(APIError):
        client.search.prefix_search("x", context="bogus")
    client.jobs.deregister("searchable-job", purge=True)


def test_api_error_shape(client):
    with pytest.raises(APIError) as ei:
        client.jobs.info("does-not-exist")
    assert ei.value.code == 404
