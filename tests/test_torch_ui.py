"""Web UI tests — the reference ships 108 UI test files against Mirage
(a fake /v1 API); our no-build SPA is exercised the inverse way: a REAL
agent serves both the bundle and /v1, and these tests assert (a) the
bundle ships every view and its wiring, and (b) every endpoint the SPA
consumes answers with the shapes the JS destructures — the API-contract
half of UI testing, without a JS runtime.

The port's copy of ``tests/test_ui.py``: every agent and server on the
CPU (``device="cpu"``).
"""
import json
import time
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.agent import Agent, AgentConfig


def http(agent, method, path, body=None, raw=False):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        agent.http_addr + path, method=method, data=data,
        headers={"Content-Type": "application/json"} if body else {},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        payload = resp.read()
    if raw:
        return payload
    return json.loads(payload) if payload else None


@pytest.fixture
def agent():
    a = Agent(AgentConfig(device="cpu",
        name="ui-agent", gossip_enabled=False, client_enabled=True,
        dev_mode=True, num_schedulers=1,
    ))
    a.start()
    yield a
    a.shutdown()


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


HCL = """
job "ui-smoke" {
  datacenters = ["dc1"]
  group "g" {
    count = 1
    task "t" {
      driver = "raw_exec"
      config { command = "/bin/sh" args = ["-c", "sleep 60"] }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""


class TestUIBundle:
    def test_spa_served_with_all_views(self, agent):
        html = http(agent, "GET", "/ui/", raw=True).decode()
        # nav entries
        for view in ("jobs", "run", "nodes", "topo", "allocs", "evals",
                     "deploys", "servers"):
            assert f'"{view}"' in html, f"view {view} missing from bundle"
        # page implementations + core wiring
        for marker in ("async jobs()", "async run(", "async function api(",
                       "data-stop-job", "plan-btn", "run-btn",
                       "jobspec", "WebSocket", "log-view", "X-Nomad-Token",
                       # r4: live cpu/mem sparklines + deployment actions
                       "function spark(", "SPARK_WINDOW", "polyline",
                       "data-dep-promote", "data-dep-fail",
                       "deploymentAction",
                       # r4: cluster topology view
                       "async topo()", "topo-node", "CPUShares"):
            assert marker in html, f"bundle missing {marker!r}"

    def test_ui_route_without_trailing_slash(self, agent):
        html = http(agent, "GET", "/ui", raw=True).decode()
        assert "<title" in html or "nomad-tpu" in html


class TestUIEndpointContract:
    """Every /v1 call the SPA's pages make, against a live agent."""

    def test_job_run_flow_parse_plan_register(self, agent):
        # the Run Job view: parse HCL -> plan preview -> register
        job = http(agent, "POST", "/v1/jobs/parse", {"JobHCL": HCL})
        assert job["ID"] == "ui-smoke"
        plan = http(agent, "PUT", f"/v1/job/{job['ID']}/plan",
                    {"Job": job, "Diff": True})
        assert "Annotations" in plan or "Diff" in plan or plan
        out = http(agent, "POST", "/v1/jobs", {"Job": job})
        assert out.get("EvalID")

        # jobs list page shape
        wait_until(lambda: any(j["ID"] == "ui-smoke"
                               for j in http(agent, "GET", "/v1/jobs")),
                   msg="job listed")
        jobs = http(agent, "GET", "/v1/jobs")
        entry = next(j for j in jobs if j["ID"] == "ui-smoke")
        for key in ("ID", "Type", "Priority", "Status"):
            assert key in entry

        # job detail page shape
        detail = http(agent, "GET", "/v1/job/ui-smoke")
        for key in ("ID", "Name", "Type", "Priority", "Datacenters"):
            assert key in detail
        allocs = http(agent, "GET", "/v1/job/ui-smoke/allocations?all=true")
        evals = http(agent, "GET", "/v1/job/ui-smoke/evaluations")
        assert isinstance(allocs, list) and isinstance(evals, list)
        assert evals and {"ID", "TriggeredBy", "Status"} <= set(evals[0])

        # alloc list/detail shapes once placed
        wait_until(lambda: http(agent, "GET", "/v1/allocations"),
                   msg="allocations listed")
        allocs = http(agent, "GET", "/v1/allocations")
        a = allocs[0]
        for key in ("ID", "JobID", "TaskGroup", "DesiredStatus",
                    "ClientStatus", "NodeID"):
            assert key in a
        detail = http(agent, "GET", f"/v1/allocation/{a['ID']}")
        assert detail["ID"] == a["ID"]

    def test_nodes_and_servers_pages(self, agent):
        nodes = http(agent, "GET", "/v1/nodes")
        assert nodes and {"ID", "Name", "Status"} <= set(nodes[0])
        node = http(agent, "GET", f"/v1/node/{nodes[0]['ID']}")
        assert "Attributes" in node
        members = http(agent, "GET", "/v1/agent/members")
        assert "Members" in members or isinstance(members, list)

    def test_evals_and_deployments_pages(self, agent):
        evals = http(agent, "GET", "/v1/evaluations")
        assert isinstance(evals, list)
        deploys = http(agent, "GET", "/v1/deployments")
        assert isinstance(deploys, list)

    def test_stop_job_button_endpoint(self, agent):
        job = http(agent, "POST", "/v1/jobs/parse", {"JobHCL": HCL})
        http(agent, "POST", "/v1/jobs", {"Job": job})
        wait_until(lambda: any(j["ID"] == "ui-smoke"
                               for j in http(agent, "GET", "/v1/jobs")),
                   msg="job listed")
        out = http(agent, "DELETE", "/v1/job/ui-smoke")
        assert out.get("EvalID")
        wait_until(
            lambda: http(agent, "GET", "/v1/job/ui-smoke")["Stop"] is True,
            msg="job stopped",
        )
