"""The port's operator surface against the JAX package's: a dev ``Agent``
of each package, built around an injected ``Server`` (deterministic, ring
decorrelation off, one worker, every eval through the engine; the port's
on the CPU), the same seeded nodes (numpy), and the same HCL jobs
(service, system, batch) submitted through each package's own
``api.Client`` over HTTP.

Held equal, exactly: the (alloc name, node name) pairs; the JSON of
``/v1/job/<id>``, ``/v1/job/<id>/allocations`` and ``/v1/job/<id>/plan``
once ids, indexes and times are dropped; and the text of each package's
CLI ``job status`` and ``node status`` once ids and times are masked.

The seeded nodes are in datacenter ``dc-seed`` and the jobs ask for it,
so the dev agent's own client node (in ``dc1``) takes no placement.
"""
import re
import time

import numpy as np
import pytest

import nomad_tpu.mock as jmock
from nomad_tpu.agent import Agent as JaxAgent
from nomad_tpu.agent import AgentConfig as JaxAgentConfig
from nomad_tpu.api import Client as JaxAPIClient
from nomad_tpu.api import Config as JaxAPIConfig
from nomad_tpu.cli.main import main as jax_cli
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import Client as APIClient
from nomad_tpu_torch.api import Config as APIConfig
from nomad_tpu_torch.cli.main import main as port_cli
from nomad_tpu_torch.server import Server, ServerConfig

N_NODES = 24

SERVICE = """
job "web" {
  datacenters = ["dc-seed"]
  type = "service"
  group "app" {
    count = 30
    spread {
      attribute = "${attr.rack}"
      weight = 50
      target "r0" { percent = 50 }
      target "r1" { percent = 25 }
    }
    task "srv" {
      driver = "exec"
      config { command = "/bin/sleep" args = ["600"] }
      resources { cpu = 300 memory = 256 }
    }
  }
}
"""

SYSTEM = """
job "sys" {
  datacenters = ["dc-seed"]
  type = "system"
  group "agent" {
    task "collect" {
      driver = "exec"
      config { command = "/bin/sleep" args = ["600"] }
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""

BATCH = """
job "crunch" {
  datacenters = ["dc-seed"]
  type = "batch"
  group "work" {
    count = 25
    constraint {
      attribute = "${attr.rack}"
      operator = "!="
      value = "r3"
    }
    task "run" {
      driver = "exec"
      config { command = "/bin/true" }
      resources { cpu = 500 memory = 512 }
    }
  }
}
"""

JOBS = [("web", SERVICE), ("sys", SYSTEM), ("crunch", BATCH)]

# The seeded nodes are registered on the server directly and never
# heartbeat: with the default TTLs (10-30 s, drawn at random; the port
# adds 10 s of grace, the JAX package none) a slow run marked some of
# them down before ``node status`` read them, in one package and not the
# other. Their TTLs outlast any run.
NO_EXPIRY = {"heartbeat_min_ttl": 3600.0, "heartbeat_max_ttl": 3600.0}

PLAN = SERVICE.replace("count = 30", "count = 34").replace("cpu = 300", "cpu = 350")


def seeded_nodes(mock_mod, seed=13):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(N_NODES):
        n = mock_mod.node()
        n.id = f"00000000-0000-4000-8000-{i:012d}"
        n.name = f"seed-{i:02d}"
        n.datacenter = "dc-seed"
        n.node_resources.cpu_shares = int(rng.choice([2000, 4000, 8000]))
        n.node_resources.memory_mb = int(rng.choice([4096, 8192, 16384]))
        n.attributes["rack"] = f"r{int(rng.integers(0, 4))}"
        n.compute_class()
        nodes.append(n)
    return nodes


def wait_for(cond, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


_DROP = re.compile(r"(^ID$|^EvalID$|^DeploymentID$|Index$|Indexes$|Time$|^SubmitTime$"
                   r"|^PreviousAllocation$|^NextAllocation$|^AllocID$|^JobModifyIndex$"
                   r"|^Warnings$|^CreatedEvals$|^NodeID$|^EvalIDs$)")


def scrub(obj):
    """Drop ids, indexes and times; keep everything else. Node ids are
    seeded, but the dev client's node id is not, so node ids go too (the
    placement maps carry the node names)."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if not _DROP.search(k)}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


_MASK = [
    (re.compile(r"\b[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}\b"), "<uuid>"),
    (re.compile(r"\b[0-9a-f]{8}\b"), "<id>"),
    (re.compile(r"\b\d+(\.\d+)?(ms|s|m|h) ago\b"), "<ago>"),
]


def mask(text):
    for pattern, repl in _MASK:
        text = pattern.sub(repl, text)
    return "\n".join(line.rstrip() for line in text.splitlines())


def drive(pkg, capsys):
    """Run one package's agent through the slice; return what is held
    equal."""
    if pkg == "port":
        nodes = seeded_nodes(mock)
        srv = Server(ServerConfig(device="cpu", num_schedulers=1, deterministic=True,
                                  ring_decorrelate=False, device_min_placements=0,
                                  **NO_EXPIRY))
        agent = Agent(AgentConfig(device="cpu", dev_mode=True, name="slice"), server=srv)
        api_cls, cfg_cls, cli = APIClient, APIConfig, port_cli
    else:
        nodes = seeded_nodes(jmock)
        srv = JaxServer(JaxServerConfig(num_schedulers=1, deterministic=True,
                                        ring_decorrelate=False, device_min_placements=0,
                                        **NO_EXPIRY))
        agent = JaxAgent(JaxAgentConfig(dev_mode=True, name="slice"), server=srv)
        api_cls, cfg_cls, cli = JaxAPIClient, JaxAPIConfig, jax_cli
    names = {n.id: n.name for n in nodes}
    agent.start()
    try:
        api = api_cls(cfg_cls(address=agent.http_addr))
        wait_for(lambda: agent.client is not None and srv.fsm.state.node_by_id(
            agent.client.node.id) is not None, msg="dev client registered")
        for n in nodes:
            srv.register_node(n)
        for job_id, hcl in JOBS:
            api.jobs.register(api.jobs.parse_hcl(hcl))
            assert srv.drain_evals(60.0)
        out = {"placements": {}, "job": {}, "allocs": {}, "status": {}}
        for job_id, _ in JOBS:
            stubs = api.jobs.allocations(job_id)
            stubs = stubs[0] if isinstance(stubs, tuple) else stubs
            # a system job's allocs share one name: a list of pairs
            out["placements"][job_id] = sorted((a["Name"], names[a["NodeID"]]) for a in stubs)
            job = api.jobs.info(job_id)
            out["job"][job_id] = scrub(job[0] if isinstance(job, tuple) else job)
            out["allocs"][job_id] = sorted(
                (dict(scrub(a), NodeName=names[a["NodeID"]]) for a in stubs),
                key=lambda a: (a["Name"], a["NodeName"]))
            capsys.readouterr()
            assert cli(["job", "status", "-address", agent.http_addr, job_id]) == 0
            out["status"][job_id] = mask(capsys.readouterr().out)
        plan = api.jobs.plan(api.jobs.parse_hcl(PLAN), diff=True)
        out["plan"] = scrub(plan[0] if isinstance(plan, tuple) else plan)
        capsys.readouterr()
        assert cli(["node", "status", "-address", agent.http_addr]) == 0
        out["node_status"] = mask(capsys.readouterr().out)
        return out
    finally:
        agent.shutdown()


@pytest.fixture(scope="module")
def views():
    """Both packages' views, taken once for the module."""
    capsys = _Capture()
    with capsys:
        return {"jax": drive("jax", capsys), "port": drive("port", capsys)}


class _Capture:
    """A module-scoped stand-in for ``capsys``: stdout captured into a
    buffer while the CLIs run."""

    def __enter__(self):
        import contextlib
        import io

        self._buf = io.StringIO()
        self._redirect = contextlib.redirect_stdout(self._buf)
        self._redirect.__enter__()
        return self

    def __exit__(self, *exc):
        self._redirect.__exit__(*exc)

    def readouterr(self):
        class Out:
            pass

        out = Out()
        out.out = self._buf.getvalue()
        self._buf.seek(0)
        self._buf.truncate()
        return out


def test_placements_equal(views):
    jax, port = views["jax"]["placements"], views["port"]["placements"]
    assert {j: len(m) for j, m in port.items()} == {"web": 30, "sys": N_NODES, "crunch": 25}
    assert port == jax


@pytest.mark.parametrize("part", ["job", "allocs", "plan"])
def test_json_equal(views, part):
    assert views["port"][part] == views["jax"][part]


def test_job_status_text_equal(views):
    assert views["port"]["status"] == views["jax"]["status"]
    assert "Allocations" in views["port"]["status"]["web"]


def test_node_status_text_equal(views):
    port = views["port"]["node_status"]
    assert port == views["jax"]["node_status"]
    seeds = [line.split() for line in port.splitlines() if "seed-" in line]
    assert len(seeds) == N_NODES
    assert all(row[-2:] == ["eligible", "ready"] for row in seeds), port


def test_codec_carries_the_autopilot_config_as_the_jax_codec():
    """An ``autopilot-config`` raft entry crosses the port's wire codec:
    the same bytes as the JAX codec's, decoded back to an equal struct
    (without it a wire raft's followers could not take the entry)."""
    from nomad_tpu.rpc import codec as jcodec
    from nomad_tpu.server.autopilot import AutopilotConfig as JaxAutopilotConfig

    from nomad_tpu_torch.rpc import codec
    from nomad_tpu_torch.server.autopilot import AutopilotConfig

    cfg = AutopilotConfig(cleanup_dead_servers=False)
    data = codec.encode(cfg)
    assert codec.decode(data) == cfg
    assert data == jcodec.encode(JaxAutopilotConfig(cleanup_dead_servers=False))
