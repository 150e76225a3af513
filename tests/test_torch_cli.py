"""CLI tests driving a live agent through nomad_tpu_torch.cli.main (reference
command/*_test.go patterns: run command, assert output + exit code).

The port's copy of ``tests/test_cli.py``: every agent and server on the
CPU (``device="cpu"``).
"""

import time

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.cli.main import main


@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu", dev_mode=True, num_schedulers=2, name="cli-dev"))
    a.start()
    yield a
    a.shutdown()


def run_cli(agent, *args):
    lines = []
    code = main(["-address", agent.http_addr, *args], out=lines.append)
    return code, "\n".join(lines)


JOBFILE = """
job "cli-job" {
  datacenters = ["dc1"]
  group "g" {
    count = 2
    task "t" {
      driver = "mock"
      config { run_for = "20s" }
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""


def test_version_and_usage(agent):
    code, out = run_cli(agent, "version")
    assert code == 0 and "Nomad-TPU" in out
    code, out = run_cli(agent)
    assert code == 1 and "usage" in out
    code, out = run_cli(agent, "frobnicate")
    assert code == 1 and "unknown command" in out


def test_job_run_and_status(agent, tmp_path):
    jf = tmp_path / "job.hcl"
    jf.write_text(JOBFILE)
    code, out = run_cli(agent, "job", "run", str(jf))
    assert code == 0, out
    assert "Monitoring evaluation" in out
    assert 'finished with status "complete"' in out
    assert out.count("created: node") == 2

    code, out = run_cli(agent, "job", "status")
    assert code == 0 and "cli-job" in out

    code, out = run_cli(agent, "job", "status", "cli-job")
    assert code == 0
    assert "Summary" in out and "Allocations" in out
    assert "cli-job" in out

    code, out = run_cli(agent, "status", "cli-job")  # top-level alias
    assert code == 0 and "cli-job" in out


def test_job_plan_and_validate(agent, tmp_path):
    jf = tmp_path / "job2.hcl"
    jf.write_text(JOBFILE.replace("cli-job", "cli-plan").replace("count = 2", "count = 3"))
    code, out = run_cli(agent, "job", "validate", str(jf))
    assert code == 0 and "validation successful" in out
    code, out = run_cli(agent, "job", "plan", str(jf))
    assert code == 0, out
    assert "Job Modify Index" in out
    # plan must not register
    code, out = run_cli(agent, "job", "status", "cli-plan")
    assert code == 1


def test_node_commands(agent):
    code, out = run_cli(agent, "node", "status")
    assert code == 0 and "ready" in out
    node_id = out.splitlines()[1].split()[0]

    code, out = run_cli(agent, "node", "status", node_id)
    assert code == 0 and "Allocations" in out or code == 0

    code, out = run_cli(agent, "node", "eligibility", "-disable", node_id)
    assert code == 0 and "ineligible" in out
    code, out = run_cli(agent, "node", "eligibility", "-enable", node_id)
    assert code == 0 and "eligible" in out


def test_eval_and_alloc_status(agent):
    code, out = run_cli(agent, "job", "status", "cli-job")
    alloc_line = [l for l in out.splitlines() if l.strip() and "run" in l]
    # find an alloc id from the allocations table
    lines = out.split("Allocations")[-1].splitlines()
    alloc_id = None
    for line in lines[2:]:
        parts = line.split()
        if parts:
            alloc_id = parts[0]
            break
    assert alloc_id
    code, out = run_cli(agent, "alloc", "status", alloc_id)
    assert code == 0, out
    assert "Client Status" in out

    code, out = run_cli(agent, "eval", "status", "zzzz")
    assert code == 1


def test_job_stop(agent):
    code, out = run_cli(agent, "job", "stop", "-purge", "-detach", "cli-job")
    assert code == 0, out
    deadline = time.time() + 5
    while time.time() < deadline:
        code, out = run_cli(agent, "job", "status", "cli-job")
        if code == 1:
            break
        time.sleep(0.2)
    assert code == 1


def test_system_and_operator_and_server(agent):
    code, out = run_cli(agent, "system", "gc")
    assert code == 0
    code, out = run_cli(agent, "operator", "scheduler")
    assert code == 0 and "SchedulerConfig" in out
    code, out = run_cli(agent, "operator", "raft")
    assert code == 0 and "leader" in out
    code, out = run_cli(agent, "server", "members")
    assert code == 0 and "alive" in out
    code, out = run_cli(agent, "ui")
    assert code == 0 and "/ui/" in out


def test_agent_info(agent):
    code, out = run_cli(agent, "agent-info")
    assert code == 0 and "Server" in out


def test_job_init(agent, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out = run_cli(agent, "job", "init")
    assert code == 0 and "example.nomad" in out
    # the generated example must parse through our own HCL front end
    code, out = run_cli(agent, "job", "validate", "example.nomad")
    assert code == 0, out
    # refuses to clobber
    code, out = run_cli(agent, "job", "init")
    assert code == 1 and "already exists" in out


def test_job_eval_and_deployments(agent, tmp_path):
    jf = tmp_path / "evaljob.hcl"
    jf.write_text(JOBFILE.replace("cli-job", "cli-eval"))
    code, out = run_cli(agent, "job", "run", str(jf))
    assert code == 0, out

    code, out = run_cli(agent, "job", "eval", "cli-eval")
    assert code == 0, out
    assert 'finished with status "complete"' in out

    # no update stanza -> no deployments, but the command itself works
    code, out = run_cli(agent, "job", "deployments", "cli-eval")
    assert code == 0 and "No deployments" in out

    run_cli(agent, "job", "stop", "-purge", "-detach", "cli-eval")


def test_alloc_stop_reschedules(agent, tmp_path):
    jf = tmp_path / "stopjob.hcl"
    jf.write_text(JOBFILE.replace("cli-job", "cli-astop").replace("count = 2", "count = 1"))
    code, out = run_cli(agent, "job", "run", str(jf))
    assert code == 0, out

    code, out = run_cli(agent, "job", "status", "cli-astop")
    lines = out.split("Allocations")[-1].splitlines()
    alloc_id = next(p[0] for p in (l.split() for l in lines[2:]) if p)

    code, out = run_cli(agent, "alloc", "stop", alloc_id)
    assert code == 0, out
    assert 'finished with status "complete"' in out

    # the eval replaces the stopped alloc with a fresh one
    deadline = time.time() + 10
    while time.time() < deadline:
        code, out = run_cli(agent, "job", "status", "cli-astop")
        lines = out.split("Allocations")[-1].splitlines()
        ids = [p[0] for p in (l.split() for l in lines[2:]) if p]
        if any(i != alloc_id for i in ids):
            break
        time.sleep(0.2)
    assert any(i != alloc_id for i in ids), out
    run_cli(agent, "job", "stop", "-purge", "-detach", "cli-astop")


def test_deployment_pause_resume_cli(agent, tmp_path):
    jf = tmp_path / "depjob.hcl"
    jf.write_text(JOBFILE.replace("cli-job", "cli-dep").replace(
        'count = 2', 'count = 1\n    update { max_parallel = 1 }'))
    code, out = run_cli(agent, "job", "run", "-detach", str(jf))
    assert code == 0, out
    deadline = time.time() + 10
    dep_id = None
    while time.time() < deadline and not dep_id:
        code, out = run_cli(agent, "job", "deployments", "cli-dep")
        lines = [l for l in out.splitlines()[1:] if l.strip()]
        if code == 0 and lines and "No deployments" not in out:
            dep_id = lines[0].split()[0]
            break
        time.sleep(0.2)
    assert dep_id, out
    code, out = run_cli(agent, "deployment", "pause", dep_id)
    assert code == 0 and "paused" in out
    code, out = run_cli(agent, "deployment", "status", dep_id)
    assert code == 0 and "paused" in out
    code, out = run_cli(agent, "deployment", "resume", dep_id)
    assert code == 0 and "resumed" in out
    run_cli(agent, "job", "stop", "-purge", "-detach", "cli-dep")


def test_monitor_no_follow(agent):
    # the module-scope agent shares this process: emit a log record the
    # monitor's ring buffer is guaranteed to capture
    import logging

    logging.getLogger("nomad_tpu_torch.test").warning("cli-monitor-probe")
    code, out = run_cli(agent, "monitor", "-no-follow", "-log-level", "warn")
    assert code == 0
    assert "cli-monitor-probe" in out


def test_operator_raft_remove_peer_cli(agent):
    # dev agent runs the in-proc raft: removal must refuse cleanly
    code, out = run_cli(agent, "operator", "raft", "remove-peer",
                        "-peer-id", "nonexistent")
    assert code == 1
    code, out = run_cli(agent, "operator", "raft", "list-peers")
    assert code == 0 and "leader" in out


def test_operator_keygen_keyring_autopilot(agent):
    code, out = run_cli(agent, "operator", "keygen")
    assert code == 0
    import base64
    key = out.strip()
    assert len(base64.b64decode(key)) == 32

    # dev agent has no gossip encryption: list shows an empty ring and
    # MUTATIONS refuse cleanly
    code, out = run_cli(agent, "operator", "keyring")
    assert code == 0 and "Primary" in out
    code, out = run_cli(agent, "operator", "keyring", "-install", key)
    assert code == 1 and "error" in out

    code, out = run_cli(agent, "operator", "autopilot")
    assert code == 0 and "CleanupDeadServers" in out
    code, out = run_cli(agent, "operator", "autopilot", "set-config",
                        "-cleanup-dead-servers=false")
    assert code == 0 and "updated" in out
    code, out = run_cli(agent, "operator", "autopilot")
    assert code == 0 and '"CleanupDeadServers": false' in out


def test_top_level_aliases(agent, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out = run_cli(agent, "init")
    assert code == 0 and "example.nomad" in out
    code, out = run_cli(agent, "validate", "example.nomad")
    assert code == 0


def test_json_and_template_output(agent):
    """-json / -t on status commands (reference command/data_format.go,
    wired into node/job/alloc/eval/deployment status)."""
    import json as _json

    # node status -json: full API payloads, 4-space indent
    code, out = run_cli(agent, "node", "status", "-json")
    assert code == 0
    nodes = _json.loads(out)
    assert isinstance(nodes, list) and nodes
    assert "ID" in nodes[0]

    # node status -t: Go-template subset with range/field access
    code, out = run_cli(
        agent, "node", "status", "-t",
        '{{range .}}{{.Name}}:{{.Status}}{{"\\n"}}{{end}}')
    assert code == 0
    assert f"{nodes[0]['Name']}:ready" in out

    # single node via template
    node_id = nodes[0]["ID"]
    code, out = run_cli(agent, "node", "status", "-t", "{{.ID}}", node_id)
    assert code == 0 and out.strip() == node_id

    # job status -json (list + single); cli-job ran earlier in the module
    code, out = run_cli(agent, "job", "status", "-json")
    assert code == 0
    jobs = _json.loads(out)
    assert isinstance(jobs, list)
    if jobs:
        code, out = run_cli(agent, "job", "status", "-json", jobs[0]["ID"])
        assert code == 0
        job = _json.loads(out)
        assert job["ID"] == jobs[0]["ID"]

    # eval status -json + alloc status -t
    code, out = run_cli(agent, "eval", "status", "-json", "x-no-such")
    assert code == 1  # no match is still an error, not empty json

    evals = agent.server.fsm.state.evals()
    if evals:
        ev = evals[0]
        code, out = run_cli(agent, "eval", "status", "-json", ev.id)
        assert code == 0
        assert _json.loads(out)["ID"] == ev.id
        code, out = run_cli(agent, "eval", "status", "-t",
                            "{{.ID}} {{.Status}}", ev.id)
        assert code == 0 and ev.id in out

    allocs = agent.server.fsm.state.allocs()
    if allocs:
        al = allocs[0]
        code, out = run_cli(agent, "alloc", "status", "-t",
                            "{{.ID}}|{{.JobID}}", al.id)
        assert code == 0 and out.strip() == f"{al.id}|{al.job_id}"

    # deployment list -json (empty or not, must be a JSON array)
    code, out = run_cli(agent, "deployment", "list", "-json")
    assert code == 0
    assert isinstance(_json.loads(out), list)

    # server members -t
    code, out = run_cli(agent, "server", "members", "-t",
                        '{{range .}}{{.Name}}{{end}}')
    assert code == 0 and "cli-dev" in out

    # -json and -t together is an error (data_format.go:27)
    code, out = run_cli(agent, "node", "status", "-json", "-t", "{{.}}")
    assert code == 1 and "does not support template" in out

    # template errors surface, not swallowed
    code, out = run_cli(agent, "node", "status", "-t", "{{range .}}no end")
    assert code == 1 and "unclosed" in out


def test_template_subset_semantics():
    """Unit coverage for the Go-template subset evaluator."""
    from nomad_tpu_torch.cli.data_format import (
        FormatError, format_data, render_template,
    )

    data = {"A": {"B": [1, 2, 3]}, "Ok": True, "Null": None}
    assert render_template("{{.A.B}}", data) == "[1, 2, 3]"
    assert render_template("{{len .A.B}}", data) == "3"
    assert render_template("{{range .A.B}}<{{.}}>{{end}}", data) == "<1><2><3>"
    assert render_template("{{if .Ok}}y{{else}}n{{end}}", data) == "y"
    assert render_template("{{if .Null}}y{{else}}n{{end}}", data) == "n"
    assert render_template('{{.Missing}}', data) == "<no value>"
    assert render_template('{{"\\t"}}', data) == "\t"
    # non-ASCII literals pass through verbatim — the old blanket
    # unicode_escape decode turned each UTF-8 byte of é into its own
    # latin-1 codepoint ("cafÃ©" mojibake)
    assert render_template('{{"café"}}', data) == "café"
    assert render_template('{{"café\\n"}}', data) == "café\n"
    assert render_template('{{"\\u00e9"}}', data) == "é"
    assert render_template('{{"a\\\\b"}}', data) == "a\\b"
    # nested range
    assert render_template(
        "{{range .}}{{range .}}{{.}}{{end}};{{end}}", [[1, 2], [3]]
    ) == "12;3;"

    import pytest as _pytest
    with _pytest.raises(FormatError):
        format_data(True, "{{.}}", data)
    with _pytest.raises(FormatError):
        render_template("{{frobnicate .}}", data)
    with _pytest.raises(FormatError):
        render_template("{{end}}", data)
