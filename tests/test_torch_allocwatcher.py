"""``tests/test_allocwatcher.py::TestRemoteMigration`` on the port: an
alloc's data fetched from another agent over the alloc FS API. The cases
that need no agent are ported in ``tests/test_torch_client.py``.
"""
import os
import time

from nomad_tpu_torch.client.allocwatcher import PrevAllocWatcher


class FakeRunner:
    def __init__(self, status="running"):
        self.status = status

    def client_status(self):
        return self.status


class FakeAlloc:
    def __init__(self, alloc_id, job=None, task_group="tg"):
        self.id = alloc_id
        self.job = job
        self.task_group = task_group


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


class TestRemoteMigration:
    def test_fetch_tree_over_fs_api(self, tmp_path):
        """Remote prev alloc: the watcher walks ls/cat on the owning
        node's agent (remotePrevAlloc semantics)."""
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(device="cpu", num_schedulers=0))
        client = Client(ServerProxy(server), ClientConfig())
        agent = Agent(AgentConfig(device="cpu", name="remote", gossip_enabled=False),
                      server=server, client=client)
        try:
            agent.start()
            # fabricate a terminal prev alloc's data dir on the remote node
            prev_id = "11111111-2222-3333-4444-555555555555"
            data = os.path.join(client.alloc_dir_base, prev_id, "alloc", "data")
            os.makedirs(os.path.join(data, "sub"))
            open(os.path.join(data, "top.txt"), "w").write("T")
            open(os.path.join(data, "sub", "nested.txt"), "w").write("N")

            http_addr = "{}:{}".format(*agent.http.addr)
            w = PrevAllocWatcher(
                FakeAlloc("new"), prev_id,
                local_runner_lookup=lambda a: None,
                alloc_dir_base=str(tmp_path),
                remote_alloc_info=lambda a: {
                    "client_status": "complete", "node_http_addr": http_addr,
                },
            )
            dest = os.path.join(str(tmp_path), "new", "alloc", "data")
            w._migrate_remote(http_addr, dest)
            assert open(os.path.join(dest, "top.txt")).read() == "T"
            assert open(os.path.join(dest, "sub", "nested.txt")).read() == "N"
        finally:
            agent.shutdown()
