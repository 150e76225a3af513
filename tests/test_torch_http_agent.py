"""HTTP agent tests: /v1 surface over a dev-mode agent — reference
command/agent/http_test.go, job_endpoint_test.go, node_endpoint_test.go.

The port's copy of ``tests/test_http_agent.py``: every agent and server
on the CPU (``device="cpu"``).
"""
import json
import time
import urllib.error
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.jsonapi import camel, dumps, from_json_obj, to_json_obj
from nomad_tpu_torch.structs.structs import Job, RestartPolicy


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def call(base, path, method="GET", body=None, headers=None):
    data = None
    if body is not None:
        data = json.dumps(body).encode() if not isinstance(body, bytes) else body
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = resp.read().decode()
        return json.loads(payload) if payload else None, dict(resp.headers)


@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu", dev_mode=True, num_schedulers=2,
                          scheduler_algorithm="binpack", name="dev1"))
    a.start()
    yield a
    a.shutdown()


def batch_echo_job_json():
    job = mock.job()
    job.type = "batch"
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy.attempts = 0
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", "echo done"]}
    task.restart_policy = RestartPolicy(attempts=0, mode="fail")
    return job, json.loads(dumps(job))


# ---------------------------------------------------------------------------
# jsonapi codec
# ---------------------------------------------------------------------------


def test_camel_casing():
    assert camel("id") == "ID"
    assert camel("job_id") == "JobID"
    assert camel("memory_mb") == "MemoryMB"
    assert camel("task_groups") == "TaskGroups"
    assert camel("create_index") == "CreateIndex"
    assert camel("eval_ids") == "EvalIDs"
    assert camel("modify_time_ns") == "ModifyTimeNs"


def test_json_roundtrip_job():
    job = mock.job()
    data = to_json_obj(job)
    assert data["ID"] == job.id
    assert data["TaskGroups"][0]["Tasks"][0]["Driver"]
    back = from_json_obj(Job, data)
    assert back.id == job.id
    assert back.task_groups[0].tasks[0].driver == job.task_groups[0].tasks[0].driver
    assert back.task_groups[0].count == job.task_groups[0].count


def test_json_decode_tolerates_snake_and_unknown_keys():
    back = from_json_obj(Job, {"id": "j1", "TotallyUnknown": 5, "Priority": 70})
    assert back.id == "j1" and back.priority == 70


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


def test_register_job_and_run_to_completion(agent):
    base = agent.http_addr
    job, job_json = batch_echo_job_json()
    out, headers = call(base, "/v1/jobs", "PUT", {"Job": job_json})
    assert out["EvalID"]
    assert "X-Nomad-Index" in headers

    def done():
        allocs, _ = call(base, f"/v1/job/{job.id}/allocations?all=true")
        return any(a["ClientStatus"] == "complete" for a in allocs)

    wait_for(done, msg="alloc complete over HTTP")
    got, _ = call(base, f"/v1/job/{job.id}")
    assert got["ID"] == job.id
    summary, _ = call(base, f"/v1/job/{job.id}/summary")
    assert summary["JobID"] == job.id

    evals, _ = call(base, f"/v1/job/{job.id}/evaluations")
    assert evals and evals[0]["JobID"] == job.id
    alloc_id = call(base, f"/v1/job/{job.id}/allocations")[0][0]["ID"]
    alloc, _ = call(base, f"/v1/allocation/{alloc_id}")
    assert alloc["ID"] == alloc_id and alloc["Job"]["ID"] == job.id


def test_jobs_list_and_prefix(agent):
    base = agent.http_addr
    jobs, headers = call(base, "/v1/jobs")
    assert isinstance(jobs, list) and jobs
    assert jobs[0]["JobSummary"]["JobID"]
    none, _ = call(base, "/v1/jobs?prefix=definitely-not-a-job")
    assert none == []


def test_nodes_endpoints(agent):
    base = agent.http_addr
    nodes, _ = call(base, "/v1/nodes")
    assert len(nodes) == 1
    node_id = nodes[0]["ID"]
    node, _ = call(base, f"/v1/node/{node_id}")
    assert node["ID"] == node_id
    allocs, _ = call(base, f"/v1/node/{node_id}/allocations")
    assert isinstance(allocs, list)
    out, _ = call(base, f"/v1/node/{node_id}/eligibility", "PUT",
                  {"Eligibility": "ineligible"})
    assert out["Index"] > 0
    node, _ = call(base, f"/v1/node/{node_id}")
    assert node["SchedulingEligibility"] == "ineligible"
    call(base, f"/v1/node/{node_id}/eligibility", "PUT", {"Eligibility": "eligible"})


def test_blocking_query_unblocks_on_write(agent):
    base = agent.http_addr
    _, headers = call(base, "/v1/jobs")
    index = int(headers["X-Nomad-Index"])

    import threading

    results = {}

    def blocked():
        t0 = time.monotonic()
        results["out"], results["headers"] = call(
            base, f"/v1/jobs?index={index}&wait=30s")
        results["elapsed"] = time.monotonic() - t0

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.3)
    job, job_json = batch_echo_job_json()
    call(base, "/v1/jobs", "PUT", {"Job": job_json})
    t.join(timeout=20)
    assert not t.is_alive()
    assert int(results["headers"]["X-Nomad-Index"]) > index


def test_evaluations_and_deployments_listing(agent):
    base = agent.http_addr
    evals, _ = call(base, "/v1/evaluations")
    assert evals
    ev_id = evals[0]["ID"]
    ev, _ = call(base, f"/v1/evaluation/{ev_id}")
    assert ev["ID"] == ev_id
    deps, _ = call(base, "/v1/deployments")
    assert isinstance(deps, list)


def test_status_and_agent_endpoints(agent):
    base = agent.http_addr
    leader, _ = call(base, "/v1/status/leader")
    host, port = agent.http.addr
    assert leader == f"{host}:{port}"
    self_info, _ = call(base, "/v1/agent/self")
    assert self_info["config"]["Server"]["Enabled"] is True
    health, _ = call(base, "/v1/agent/health")
    assert health["server"]["ok"] and health["client"]["ok"]
    members, _ = call(base, "/v1/agent/members")
    assert members["Members"][0]["Status"] == "alive"
    regions, _ = call(base, "/v1/regions")
    assert regions == ["global"]


def test_operator_scheduler_configuration(agent):
    base = agent.http_addr
    out, _ = call(base, "/v1/operator/scheduler/configuration")
    assert "SchedulerConfig" in out
    call(base, "/v1/operator/scheduler/configuration", "PUT",
         {"SchedulerAlgorithm": "binpack",
          "PreemptionConfig": {"SystemSchedulerEnabled": True}})
    out, _ = call(base, "/v1/operator/scheduler/configuration")
    assert out["SchedulerConfig"]["SchedulerAlgorithm"] == "binpack"


def test_job_stop_and_purge(agent):
    base = agent.http_addr
    job, job_json = batch_echo_job_json()
    call(base, "/v1/jobs", "PUT", {"Job": job_json})
    out, _ = call(base, f"/v1/job/{job.id}?purge=true", "DELETE")
    assert out["EvalID"]
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, f"/v1/job/{job.id}")
    assert e.value.code == 404


def test_404_and_405(agent):
    base = agent.http_addr
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, "/v1/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, "/v1/jobs", "DELETE")
    assert e.value.code == 405


def test_validate_job(agent):
    base = agent.http_addr
    _, job_json = batch_echo_job_json()
    out, _ = call(base, "/v1/validate/job", "PUT", {"Job": job_json})
    assert out["ValidationErrors"] == []
    bad = dict(job_json)
    bad["TaskGroups"] = []
    out, _ = call(base, "/v1/validate/job", "PUT", {"Job": bad})
    assert out["ValidationErrors"]


def test_system_gc(agent):
    base = agent.http_addr
    out, _ = call(base, "/v1/system/gc", "PUT")
    assert out == {}


def test_job_plan_with_diff(agent):
    base = agent.http_addr
    job, job_json = batch_echo_job_json()
    out, _ = call(base, f"/v1/job/{job.id}/plan", "PUT",
                  {"Job": job_json, "Diff": True})
    assert out["Diff"]["Type"] == "Added"
    assert out["Diff"]["ID"] == job.id
    assert out["JobModifyIndex"] > 0
    # nothing was actually registered by a plan
    with pytest.raises(urllib.error.HTTPError):
        call(base, f"/v1/job/{job.id}")
    # now register, modify, and plan the modification -> Edited
    call(base, "/v1/jobs", "PUT", {"Job": job_json})
    job_json["Priority"] = 90
    out, _ = call(base, f"/v1/job/{job.id}/plan", "PUT",
                  {"Job": job_json, "Diff": True})
    assert out["Diff"]["Type"] == "Edited"
    fields = {f["Name"]: f for f in out["Diff"]["Fields"]}
    assert fields["Priority"]["New"] == "90"


def test_dispatch_parameterized_job(agent):
    base = agent.http_addr
    job, job_json = batch_echo_job_json()
    job_json["Parameterized"] = {"Payload": "optional", "MetaRequired": ["who"]}
    call(base, "/v1/jobs", "PUT", {"Job": job_json})
    # missing required meta -> 400
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, f"/v1/job/{job.id}/dispatch", "PUT", {"Meta": {}})
    assert e.value.code == 400
    out, _ = call(base, f"/v1/job/{job.id}/dispatch", "PUT",
                  {"Meta": {"who": "world"}})
    assert out["DispatchedJobID"].startswith(job.id + "/dispatch-")
    child, _ = call(base, f"/v1/job/{out['DispatchedJobID']}")
    assert child["ParentID"] == job.id
    assert child["Meta"]["who"] == "world"
    assert child["Stable"] is False and child["Stop"] is False
    # stopped parent refuses dispatch
    call(base, f"/v1/job/{job.id}", "DELETE")
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, f"/v1/job/{job.id}/dispatch", "PUT", {"Meta": {"who": "x"}})
    assert e.value.code == 400


def test_job_stability_validates_version(agent):
    base = agent.http_addr
    job, job_json = batch_echo_job_json()
    call(base, "/v1/jobs", "PUT", {"Job": job_json})
    with pytest.raises(urllib.error.HTTPError) as e:
        call(base, f"/v1/job/{job.id}/stable", "PUT",
             {"JobVersion": 99, "Stable": True})
    assert e.value.code == 400
    out, _ = call(base, f"/v1/job/{job.id}/stable", "PUT",
                  {"JobVersion": 0, "Stable": True})
    assert out["Index"] > 0
    got, _ = call(base, f"/v1/job/{job.id}")
    assert got["Stable"] is True
