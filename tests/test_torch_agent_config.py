"""Agent config files: HCL/JSON load, merge, precedence, agent boot
(reference command/agent/config.go + config_parse.go + their tests).

The port's copy of ``tests/test_agent_config.py``: every agent and
server on the CPU (``device="cpu"``). The config file's HCL sets the
port's top-level ``device = "cpu"``.
"""

import json

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.config_file import (
    ConfigError,
    apply_file_config,
    load_agent_config,
    load_config_sources,
    merge_config,
)

HCL = """
device     = "cpu"
region     = "euw"
datacenter = "dc7"
name       = "cfg-agent"
bind_addr  = "127.0.0.1"

ports {
  http = 0
  rpc  = 0
}

server {
  enabled          = true
  bootstrap_expect = 1
  num_schedulers   = 3
  default_scheduler_config {
    scheduler_algorithm = "binpack"
  }
}

client {
  enabled    = true
  node_class = "compute"
  meta {
    team = "infra"
  }
  host_volume "data" {
    path = "/srv/data"
  }
}

telemetry {
  statsd_address = "127.0.0.1:8125"
  prefix         = "np"
}
"""


def test_hcl_file_maps_reference_keys(tmp_path):
    f = tmp_path / "agent.hcl"
    f.write_text(HCL)
    cfg = load_agent_config([str(f)])
    assert cfg.region == "euw"
    assert cfg.datacenter == "dc7"
    assert cfg.name == "cfg-agent"
    assert cfg.server_enabled and cfg.client_enabled
    assert cfg.num_schedulers == 3
    assert cfg.scheduler_algorithm == "binpack"
    assert cfg.node_class == "compute"
    assert cfg.meta == {"team": "infra"}
    assert cfg.host_volumes == {"data": "/srv/data"}
    assert cfg.telemetry_statsd_address == "127.0.0.1:8125"
    assert cfg.telemetry_prefix == "np"


def test_chunked_tier_config_keys(tmp_path):
    f = tmp_path / "agent.hcl"
    f.write_text(
        """
server {
  enabled = true
  default_scheduler_config {
    scheduler_algorithm = "tpu_binpack_chunked"
    chunk_k             = 256
    parity_sample_rate  = 0.25
  }
}
"""
    )
    cfg = load_agent_config([str(f)])
    assert cfg.scheduler_algorithm == "tpu_binpack_chunked"
    assert cfg.chunk_k == 256
    assert cfg.parity_sample_rate == 0.25


def test_chunked_tier_knobs_reach_scheduler_config():
    # ServerConfig -> leader-seeded SchedulerConfiguration plumbing
    from nomad_tpu_torch.server.server import Server, ServerConfig

    srv = Server(ServerConfig(device="cpu",
        scheduler_algorithm="tpu_binpack_chunked",
        chunk_k=64,
        parity_sample_rate=0.5,
        num_schedulers=0,
    ))
    try:
        srv.start()
        _, sc = srv.fsm.state.scheduler_config()
        assert sc.scheduler_algorithm == "tpu_binpack_chunked"
        assert sc.chunk_k == 64
        assert sc.parity_sample_rate == 0.5
    finally:
        srv.stop()


def test_json_file_and_directory_merge_order(tmp_path):
    d = tmp_path / "conf.d"
    d.mkdir()
    (d / "00-base.json").write_text(json.dumps({
        "region": "us", "ports": {"http": 1111, "rpc": 2222},
        "server": {"enabled": True, "num_schedulers": 1},
    }))
    (d / "10-override.hcl").write_text(
        'ports { http = 3333 }\nserver { num_schedulers = 5 }\n'
    )
    data = load_config_sources([str(d)])
    # later files merge over earlier, key-by-key (objects deep-merge)
    assert data["ports"] == {"http": 3333, "rpc": 2222}
    assert data["server"] == {"enabled": True, "num_schedulers": 5}
    assert data["region"] == "us"

    cfg = load_agent_config([str(d)])
    assert cfg.http_port == 3333 and cfg.rpc_port == 2222
    assert cfg.num_schedulers == 5


def test_unknown_keys_fail_loudly(tmp_path):
    f = tmp_path / "bad.hcl"
    f.write_text('regon = "typo"\n')
    with pytest.raises(ConfigError, match="regon"):
        load_agent_config([str(f)])
    f2 = tmp_path / "bad2.hcl"
    f2.write_text('server { bootstrap_expct = 3 }\n')
    with pytest.raises(ConfigError, match="bootstrap_expct"):
        load_agent_config([str(f2)])


def test_missing_path_and_bad_volume(tmp_path):
    with pytest.raises(ConfigError, match="does not exist"):
        load_config_sources([str(tmp_path / "nope.hcl")])
    f = tmp_path / "vol.hcl"
    f.write_text('client { host_volume "x" { } }\n')
    with pytest.raises(ConfigError, match="path"):
        load_agent_config([str(f)])


def test_merge_scalars_replace_objects_merge():
    out = merge_config(
        {"a": 1, "o": {"x": 1, "y": 2}, "l": [1, 2]},
        {"a": 9, "o": {"y": 3}, "l": [7]},
    )
    assert out == {"a": 9, "o": {"x": 1, "y": 3}, "l": [7]}


def test_apply_does_not_mutate_base():
    base = AgentConfig(device="cpu")
    cfg = apply_file_config(base, {"region": "apac"})
    assert cfg.region == "apac" and base.region == "global"


def test_agent_boots_from_config_file(tmp_path):
    """The e2e shape: write a file, boot a real agent from it, observe
    the configured identity through the HTTP API."""
    vol = tmp_path / "data"
    vol.mkdir()
    f = tmp_path / "boot.hcl"
    f.write_text(HCL.replace("/srv/data", str(vol)))
    cfg = load_agent_config([str(f)])
    cfg.dev_mode = True  # in-proc raft; ephemeral ports already set
    a = Agent(cfg)
    a.start()
    try:
        from nomad_tpu_torch.api import Client, Config

        api = Client(Config(address=a.http_addr))
        info = api.agent.self()
        assert info["config"]["Region"] == "euw"
        assert info["config"]["Datacenter"] == "dc7"
        assert info["member"]["Name"].startswith("cfg-agent")
        # client node registered with file-configured class + meta
        nodes, _ = api.nodes.list()
        assert nodes and nodes[0]["NodeClass"] == "compute"
    finally:
        a.shutdown()


@pytest.mark.parametrize("value, seconds", [('"60s"', 60.0), ('"1m30s"', 90.0),
                                            ('"500ms"', 0.5)])
def test_heartbeat_grace_reaches_the_server(tmp_path, value, seconds):
    """The server stanza's ``heartbeat_grace`` (a Go duration, as in
    Nomad's) sets how long a node may outlive its TTL on the agent's
    server; without it the server keeps its 10 s."""
    f = tmp_path / "grace.hcl"
    f.write_text('device = "cpu"\nports {\n  http = 0\n  rpc = 0\n}\n'
                 f"server {{\n  enabled = true\n  heartbeat_grace = {value}\n}}\n")
    cfg = load_agent_config([str(f)])
    assert cfg.heartbeat_grace == seconds
    assert load_agent_config([]).heartbeat_grace == 10.0
    cfg.dev_mode = True
    a = Agent(cfg)
    a.start()
    try:
        assert a.server.config.heartbeat_grace == seconds
        assert a.server.heartbeaters.grace == seconds
    finally:
        a.shutdown()


def test_bad_heartbeat_grace_fails_loudly(tmp_path):
    f = tmp_path / "bad.hcl"
    f.write_text('server {\n  heartbeat_grace = "soon"\n}\n')
    with pytest.raises(ConfigError, match="heartbeat_grace"):
        load_agent_config([str(f)])


def test_cli_flags_override_file(tmp_path):
    """defaults < files < flags, via the real CLI path."""
    from nomad_tpu_torch.cli.main import main as cli_main

    f = tmp_path / "agent.hcl"
    f.write_text('region = "filereg"\ndatacenter = "filedc"\n')
    # exercise only the config-assembly path: patch Agent.start via a
    # sentinel agent that records its config and exits immediately
    captured = {}

    class FakeAgent:
        def __init__(self, cfg):
            captured["cfg"] = cfg
            self.http_addr = "http://x"
            self.client = None
            self.server = None

        def start(self):
            raise KeyboardInterrupt  # unwind out of the serve loop

        def shutdown(self):
            pass

    import nomad_tpu_torch.agent as agent_pkg

    orig = agent_pkg.Agent
    agent_pkg.Agent = FakeAgent
    try:
        try:
            cli_main([
                "agent", "-config", str(f), "-dc", "flagdc", "-dev",
            ], out=lambda s: None)
        except KeyboardInterrupt:
            pass
    finally:
        agent_pkg.Agent = orig
    cfg = captured["cfg"]
    assert cfg.region == "filereg"  # from file
    assert cfg.datacenter == "flagdc"  # flag wins over file
    assert cfg.dev_mode
