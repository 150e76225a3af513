"""Streaming surfaces: server-push log follow, interactive alloc exec over
websocket (incl. the server→node bridge), and streaming agent monitor —
the HTTP realization of the reference's streaming RPC registry
(nomad/structs/streaming_rpc.go, command/agent/http.go:187,
alloc_endpoint.go execStream).

The port's copy of ``tests/test_streaming.py``: every agent and server
on the CPU (``device="cpu"``).
"""
import json
import threading
import time
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.agent import Agent, AgentConfig
from nomad_tpu_torch.api import Client, Config


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture()
def agent():
    a = Agent(AgentConfig(device="cpu", name="stream-agent", dev_mode=True, gossip_enabled=False))
    a.start()
    yield a
    a.shutdown()


def run_job(agent, script, task_driver="raw_exec", count=1):
    job = mock.job()
    job.task_groups[0].count = count
    task = job.task_groups[0].tasks[0]
    task.driver = task_driver
    if task_driver == "raw_exec":
        task.config = {"command": "/bin/sh", "args": ["-c", script]}
    else:
        task.config = {"run_for": "60s"}
    task.resources.networks = []
    agent.server.register_job(job)

    def running():
        allocs = agent.server.fsm.state.allocs_by_job("default", job.id, True)
        return [a for a in allocs if a.client_status == "running"]

    wait_until(lambda: running(), msg="alloc running")
    return job, running()[0]


class TestLogFollowStreaming:
    def test_server_push_log_follow(self, agent):
        """A follow=true log request receives bytes written AFTER the
        stream opened — pushed by the agent, not polled."""
        job, alloc = run_job(
            agent,
            'i=0; while true; do echo "line-$i"; i=$((i+1)); sleep 0.2; done',
        )
        api = Client(Config(address=agent.http_addr))
        got = []
        stream = api.alloc_fs.logs_follow(alloc.id, "web", origin="end", offset=0)

        def consume():
            for chunk in stream:
                got.append(chunk)
                if len(b"".join(got).splitlines()) >= 3:
                    return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=20)
        joined = b"".join(got)
        assert b"line-" in joined, f"no pushed log lines: {joined[:200]!r}"
        assert len(joined.splitlines()) >= 3


class TestInteractiveExec:
    def test_exec_round_trip_local(self, agent):
        """Interactive session against `cat`: stdin comes back as stdout,
        EOF exits 0 — driven through CLI-grade SDK plumbing."""
        job, alloc = run_job(agent, "sleep 60")
        api = Client(Config(address=agent.http_addr))
        stream = api.allocations.exec_stream(alloc.id, "web", ["/bin/cat"])
        try:
            stream.send_stdin(b"hello interactive exec\n")
            chunk = stream.read_output()
            assert chunk is not None
            assert b"hello interactive exec" in chunk
            stream.send_stdin(b"second line\n")
            chunk = stream.read_output()
            assert chunk is not None and b"second line" in chunk
            stream.close_stdin()
            while stream.read_output() is not None:
                pass
            assert stream.exit_code == 0
        finally:
            stream.close()

    def test_exec_shell_session_via_cli(self, agent, monkeypatch):
        """CLI `alloc exec -i` round-trips a shell session against a live
        agent (VERDICT item 8 done-criterion)."""
        import io
        import sys as sys_mod

        from nomad_tpu_torch.cli.main import main as cli_main

        job, alloc = run_job(agent, "sleep 60")
        stdin_buf = io.BytesIO(b"echo cli-exec-$((6*7))\nexit 3\n")
        stdout_buf = io.BytesIO()

        class FakeStd:
            def __init__(self, buf):
                self.buffer = buf

            def flush(self):
                pass

        monkeypatch.setattr(sys_mod, "stdin", FakeStd(stdin_buf))
        monkeypatch.setattr(sys_mod, "stdout", FakeStd(stdout_buf))
        code = cli_main([
            "-address", agent.http_addr,
            "alloc", "exec", "-i", "-task", "web", alloc.id[:8], "/bin/sh",
        ])
        out = stdout_buf.getvalue().decode()
        assert "cli-exec-42" in out
        assert code == 3

    def test_exec_bridged_through_server_agent(self):
        """Exec against the SERVER agent for an alloc on a separate client
        node: the websocket is bridged server→node (the streaming-RPC
        hop)."""
        server_agent = Agent(AgentConfig(device="cpu",
            name="exec-srv", gossip_enabled=False, client_enabled=False,
        ))
        server_agent.start()
        client_agent = Agent(AgentConfig(device="cpu",
            name="exec-cli", server_enabled=False, client_enabled=True,
            gossip_enabled=False,
            servers=["{}:{}".format(*server_agent.rpc.addr)],
        ))
        try:
            client_agent.start()
            wait_until(lambda: len(server_agent.server.fsm.state.nodes()) == 1,
                       msg="client node registered")
            job, alloc = run_job(server_agent, "sleep 60")
            # talk to the SERVER agent's HTTP API; alloc runs on the client
            assert client_agent.client.allocrunners.get(alloc.id) is not None
            api = Client(Config(address=server_agent.http_addr))
            stream = api.allocations.exec_stream(alloc.id, "web", ["/bin/cat"])
            try:
                stream.send_stdin(b"bridged-exec\n")
                chunk = stream.read_output()
                assert chunk is not None and b"bridged-exec" in chunk
                stream.close_stdin()
                while stream.read_output() is not None:
                    pass
                assert stream.exit_code == 0
            finally:
                stream.close()
        finally:
            client_agent.shutdown()
            server_agent.shutdown()

    def test_exec_streaming_mock_driver(self, agent):
        """The mock driver's echo session exercises the plumbing without
        real processes."""
        job, alloc = run_job(agent, "", task_driver="mock")
        api = Client(Config(address=agent.http_addr))
        stream = api.allocations.exec_stream(alloc.id, "web", ["noop"])
        try:
            stream.send_stdin(b"echo-me")
            chunk = stream.read_output()
            assert chunk == b"echo-me"
            stream.close_stdin()
            while stream.read_output() is not None:
                pass
            assert stream.exit_code == 0
        finally:
            stream.close()


class TestMonitorStreaming:
    def test_monitor_server_push(self, agent):
        """/v1/agent/monitor?follow=true pushes log lines emitted AFTER
        the stream opened."""
        import logging

        url = agent.http_addr + "/v1/agent/monitor?follow=true&log_level=info"
        resp = urllib.request.urlopen(url, timeout=10)
        got = []

        def consume():
            while True:
                chunk = resp.read1(8192)
                if not chunk:
                    return
                got.append(chunk)
                if b"streaming-sentinel" in b"".join(got):
                    return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.5)
        # warning: above the root default level, so the monitor's handler
        # on the "nomad_tpu_torch" logger definitely sees it
        logging.getLogger("nomad_tpu_torch.test").warning(
            "streaming-sentinel emitted after stream start"
        )
        t.join(timeout=10)
        resp.close()
        assert b"streaming-sentinel" in b"".join(got)
