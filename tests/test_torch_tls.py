"""Mutual-TLS RPC tests (reference helper/tlsutil + the agent tls
stanza): encrypted transport, client-cert enforcement, and a full
TLS cluster (server agent + remote client agent) running a job.

The port's copy of ``tests/test_tls.py``: every agent and server on the
CPU (``device="cpu"``).
"""
import time

import pytest

from nomad_tpu_torch.rpc.transport import RPCClient, RPCServer, TLSConfig
from tls_helper import make_cluster_certs


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return make_cluster_certs(str(tmp_path_factory.mktemp("tls")))


class TestTLSTransport:
    def test_mutual_tls_round_trip(self, certs):
        srv_tls = TLSConfig(*certs["server"])
        cli_tls = TLSConfig(*certs["client"])
        rpc = RPCServer(tls=srv_tls)
        rpc.register("Echo.hello", lambda x: f"hello {x}")
        rpc.start()
        try:
            cli = RPCClient(*rpc.addr, tls=cli_tls)
            assert cli.call("Echo.hello", "tls") == "hello tls"
            cli.close()
        finally:
            rpc.stop()

    def test_plaintext_client_rejected(self, certs):
        rpc = RPCServer(tls=TLSConfig(*certs["server"]))
        rpc.register("Echo.hello", lambda x: x)
        rpc.start()
        try:
            cli = RPCClient(*rpc.addr)  # no TLS
            with pytest.raises(Exception):
                cli.call("Echo.hello", "x")
            cli.close()
        finally:
            rpc.stop()

    def test_client_without_cert_rejected(self, certs, tmp_path):
        """Mutual TLS: a client presenting no certificate fails the
        handshake even with the right CA."""
        import ssl
        import socket

        rpc = RPCServer(tls=TLSConfig(*certs["server"]))
        rpc.register("Echo.hello", lambda x: x)
        rpc.start()
        try:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.load_verify_locations(certs["server"][0])
            ctx.check_hostname = False
            with pytest.raises(ssl.SSLError):
                s = socket.create_connection(rpc.addr, timeout=5)
                ws = ctx.wrap_socket(s)
                ws.send(b"x")  # handshake failure may surface on first IO
                ws.recv(1)
        finally:
            rpc.stop()


class TestServerHostnameVerification:
    def test_pinned_name_accepts_real_server(self, certs):
        srv_tls = TLSConfig(*certs["server"])
        cli_tls = TLSConfig(*certs["client"], server_name="server.global.nomad")
        assert cli_tls.pin_server_name
        rpc = RPCServer(tls=srv_tls)
        rpc.register("Echo.hello", lambda x: x)
        rpc.start()
        try:
            cli = RPCClient(*rpc.addr, tls=cli_tls)
            assert cli.call("Echo.hello", "pin") == "pin"
            cli.close()
        finally:
            rpc.stop()

    def test_client_cert_cannot_impersonate_server(self, certs):
        """A cluster-CA client cert presented by a listener must be
        rejected by callers pinning the server role name — otherwise any
        agent cert holder can MITM the RPC plane."""
        impostor = RPCServer(tls=TLSConfig(*certs["client"]))
        impostor.register("Echo.hello", lambda x: x)
        impostor.start()
        try:
            cli = RPCClient(
                *impostor.addr,
                tls=TLSConfig(*certs["client"], server_name="server.global.nomad"),
            )
            with pytest.raises(Exception):
                cli.call("Echo.hello", "x")
            cli.close()
        finally:
            impostor.stop()

    def test_opt_out_restores_ca_only_check(self, certs):
        cli_tls = TLSConfig(*certs["client"], server_name="server.global.nomad",
                            verify_server_hostname=False)
        assert not cli_tls.pin_server_name
        rpc = RPCServer(tls=TLSConfig(*certs["client"]))
        rpc.register("Echo.hello", lambda x: x)
        rpc.start()
        try:
            cli = RPCClient(*rpc.addr, tls=cli_tls)
            assert cli.call("Echo.hello", "ok") == "ok"
            cli.close()
        finally:
            rpc.stop()


class TestTLSCluster:
    def test_server_and_remote_client_over_tls(self, certs):
        """Full topology on mutual TLS: server agent + client-only agent
        dialing over the encrypted RPC plane, job placed and running."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig

        ca, crt, key = certs["server"]
        server_agent = Agent(AgentConfig(device="cpu",
            name="tls-srv", gossip_enabled=False,
            tls_ca_file=ca, tls_cert_file=crt, tls_key_file=key,
        ))
        cca, ccrt, ckey = certs["client"]
        client_agent = Agent(AgentConfig(device="cpu",
            name="tls-cli", server_enabled=False, client_enabled=True,
            gossip_enabled=False,
            servers=["{}:{}".format(*server_agent.rpc.addr)],
            tls_ca_file=cca, tls_cert_file=ccrt, tls_key_file=ckey,
        ))
        try:
            server_agent.start()
            client_agent.start()
            server = server_agent.server
            wait_until(lambda: len(server.fsm.state.nodes()) == 1,
                       msg="node registered over TLS")
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "mock"
            task.config = {"run_for": "30s"}
            server.register_job(job)
            wait_until(
                lambda: any(
                    a.client_status == "running"
                    for a in server.fsm.state.allocs_by_job("default", job.id, True)
                ),
                timeout=60, msg="alloc running over TLS transport",
            )
        finally:
            client_agent.shutdown()
            server_agent.shutdown()


class TestHTTPSAgent:
    def test_https_api_with_sdk(self, certs):
        """The /v1 API over HTTPS with mTLS: SDK and endpoints work; a
        client without certs is refused."""
        from nomad_tpu_torch.api import APIError, Client, Config
        from nomad_tpu_torch.agent.agent import Agent, AgentConfig

        ca, crt, key = certs["server"]
        agent = Agent(AgentConfig(device="cpu",
            name="https", gossip_enabled=False, num_schedulers=0,
            tls_ca_file=ca, tls_cert_file=crt, tls_key_file=key,
            tls_http=True,
        ))
        try:
            agent.start()
            assert agent.http_addr.startswith("https://")
            cca, ccrt, ckey = certs["client"]
            api = Client(Config(address=agent.http_addr, ca_cert=cca,
                                client_cert=ccrt, client_key=ckey,
                                tls_skip_verify=True))
            jobs, _ = api.jobs.list()
            assert jobs == []
            info = api.agent.self()
            if isinstance(info, tuple):
                info = info[0]
            assert info["config"]["NodeName"] == "https"
            # no client cert → handshake refused
            import ssl as ssl_mod

            bare = Client(Config(address=agent.http_addr, ca_cert=cca,
                                 tls_skip_verify=True))
            # the mTLS refusal surfaces as APIError (URLError-wrapped) or
            # a raw SSLError depending on where the reset lands
            with pytest.raises((APIError, ssl_mod.SSLError, OSError)):
                bare.jobs.list()
        finally:
            agent.shutdown()
