"""The alloc FS API, stats and lifecycle cases of
``tests/test_logmon_fs.py`` on the port, each agent on the CPU.

Covers ``client/fs_endpoint.go`` + ``command/agent/fs_endpoint.go``
(ls/stat/cat/readat/logs over HTTP), the server→client proxy hop, the
alloc logs/fs CLI, client stats, and alloc signal/exec/restart. The
logmon cases (``TestRotatingWriter``, ``TestLogmonProcess``) are ported in
``tests/test_torch_logmon.py``.
"""
import json
import time
import urllib.request

import pytest


def wait_until(fn, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="class")
def dev_agent():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.agent.agent import Agent, AgentConfig

    agent = Agent(AgentConfig(device="cpu", name="fs-dev", dev_mode=True, gossip_enabled=False))
    agent.start()
    job = mock.job()
    job.task_groups[0].count = 1
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {
        "command": "/bin/sh",
        "args": ["-c", "echo line-out; echo line-err >&2; "
                       "echo data > $NOMAD_TASK_DIR/file.txt; sleep 60"],
    }
    agent.server.register_job(job)

    def running():
        allocs = agent.server.fsm.state.allocs_by_job("default", job.id, True)
        return allocs and allocs[0].client_status == "running"

    wait_until(running, timeout=30, msg="alloc running")
    alloc = agent.server.fsm.state.allocs_by_job("default", job.id, True)[0]
    yield agent, alloc, task.name
    agent.shutdown()


def _get(agent, path, raw=False):
    with urllib.request.urlopen(agent.http_addr + path) as r:
        data = r.read()
    return data if raw else json.loads(data)


class TestFSEndpoints:
    def test_logs_capture_rotated(self, dev_agent):
        agent, alloc, task = dev_agent
        wait_until(
            lambda: b"line-out" in _get(
                agent, f"/v1/client/fs/logs/{alloc.id}?task={task}&type=stdout",
                raw=True),
            msg="stdout captured",
        )
        err = _get(agent, f"/v1/client/fs/logs/{alloc.id}?task={task}&type=stderr",
                   raw=True)
        assert b"line-err" in err

    def test_ls_stat_cat_readat(self, dev_agent):
        agent, alloc, task = dev_agent
        wait_until(
            lambda: any(e["Name"] == "file.txt" for e in _get(
                agent, f"/v1/client/fs/ls/{alloc.id}?path=/{task}/local")),
            msg="task file visible",
        )
        st = _get(agent, f"/v1/client/fs/stat/{alloc.id}?path=/{task}/local/file.txt")
        assert not st["IsDir"] and st["Size"] == 5
        data = _get(agent, f"/v1/client/fs/cat/{alloc.id}?path=/{task}/local/file.txt",
                    raw=True)
        assert data == b"data\n"
        part = _get(
            agent,
            f"/v1/client/fs/readat/{alloc.id}?path=/{task}/local/file.txt&offset=1&limit=2",
            raw=True)
        assert part == b"at"

    def test_path_escape_rejected(self, dev_agent):
        agent, alloc, _ = dev_agent
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(agent, f"/v1/client/fs/cat/{alloc.id}?path=../../../etc/passwd")
        assert e.value.code == 403

    def test_unknown_alloc_404(self, dev_agent):
        agent, _, _ = dev_agent
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(agent, "/v1/client/fs/ls/00000000-dead-beef-0000-000000000000")
        assert e.value.code == 404

    def test_cli_alloc_logs_and_fs(self, dev_agent):
        from nomad_tpu_torch.cli.main import main as run_cli

        agent, alloc, task = dev_agent
        out = []
        code = run_cli(["-address", agent.http_addr, "alloc", "logs",
                        alloc.id[:8]], out.append)
        assert code == 0 and any("line-out" in line for line in out)
        out2 = []
        code = run_cli(["-address", agent.http_addr, "alloc", "fs",
                        alloc.id[:8], f"/{task}/local"], out2.append)
        assert code == 0 and any("file.txt" in line for line in out2)
        out3 = []
        code = run_cli(["-address", agent.http_addr, "alloc", "fs",
                        alloc.id[:8], f"/{task}/local/file.txt"], out3.append)
        assert code == 0 and any("data" in line for line in out3)


class TestCrossNodeProxy:
    def test_server_agent_proxies_to_client_agent(self):
        """Server-only agent proxies fs requests to the node's agent
        (client_fs_endpoint.go hop)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(device="cpu", num_schedulers=1, heartbeat_min_ttl=60,
                                     heartbeat_max_ttl=60), name="srv")
        server_agent = Agent(
            AgentConfig(device="cpu", name="srv", gossip_enabled=False), server=server
        )
        client = Client(ServerProxy(server), ClientConfig())
        client_agent = Agent(
            AgentConfig(device="cpu", name="cli", server_enabled=False, gossip_enabled=False),
            server=None, client=client,
        )
        try:
            server_agent.start()
            client_agent.start()
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh",
                           "args": ["-c", "echo remote-log; sleep 60"]}
            server.register_job(job)

            def running():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return allocs and allocs[0].client_status == "running"

            wait_until(running, timeout=30, msg="alloc running")
            alloc = server.fsm.state.allocs_by_job("default", job.id, True)[0]
            # ask the SERVER agent, which must hop to the client agent
            wait_until(
                lambda: b"remote-log" in _get(
                    server_agent,
                    f"/v1/client/fs/logs/{alloc.id}?task={task.name}&type=stdout",
                    raw=True),
                msg="proxied logs",
            )
        finally:
            client_agent.shutdown()
            server_agent.shutdown()


class TestClientStats:
    def test_host_and_alloc_stats(self, dev_agent):
        agent, alloc, task = dev_agent
        host = _get(agent, "/v1/client/stats")
        # server-side proxying by node id hits the same node
        host2 = _get(agent, f"/v1/client/stats?node_id={alloc.node_id}")
        assert host2["Memory"]["Total"] == host["Memory"]["Total"]
        assert host["Memory"]["Total"] > 0
        assert "LoadAvg" in host and host["Uptime"] > 0
        stats = _get(agent, f"/v1/client/allocation/{alloc.id}/stats")
        assert task in stats["Tasks"]
        assert stats["ResourceUsage"]["MemoryStats"]["RSS"] >= 0


class TestAllocLifecycle:
    def test_signal_and_exec(self, dev_agent):
        import urllib.request as _ur

        agent, alloc, task = dev_agent
        # exec through the raw_exec driver
        req = _ur.Request(
            agent.http_addr + f"/v1/client/allocation/{alloc.id}/exec",
            data=json.dumps({"Task": task, "Cmd": ["/bin/echo", "exec-ok"]}).encode(),
            method="POST")
        out = json.load(_ur.urlopen(req))
        assert out["ExitCode"] == 0 and "exec-ok" in out["Output"]
        # signal with a harmless signal
        req = _ur.Request(
            agent.http_addr + f"/v1/client/allocation/{alloc.id}/signal",
            data=json.dumps({"Signal": "SIGCONT", "Task": task}).encode(),
            method="PUT")
        assert json.load(_ur.urlopen(req)) == {"Index": 0}

    def test_cli_restart(self, dev_agent):
        from nomad_tpu_torch.cli.main import main as run_cli

        agent, alloc, task = dev_agent
        out = []
        code = run_cli(["-address", agent.http_addr, "alloc", "restart",
                        alloc.id[:8]], out.append)
        assert code == 0 and any("restarted" in line for line in out)
        # the task comes back up after the in-place restart
        wait_until(
            lambda: agent.server.fsm.state.alloc_by_id(alloc.id).client_status
            == "running",
            msg="task running again after restart",
        )
