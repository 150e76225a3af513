"""The port's Vault and Consul integrations
(``nomad_tpu_torch/integrations/``) and the server's Vault path, held
against the JAX package.

``TestVaultClient`` and ``TestServerVaultLifecycle`` of
``tests/test_integrations.py`` run on the port, against the port's
``MockVaultServer``, and each Vault-side result is compared with the JAX
package's on the same calls. The client half of the lifecycle (the task
runner's vault hook and its status updates) waits for the client: here
the test makes the node's calls itself (``derive_vault_token`` with the
node's secret, ``update_allocs_from_client`` when the task ends).

``TestConsulClient``, ``TestConsulConnect``, ``TestScriptChecks`` and
``TestTaskServiceRegistration`` of the same file run on a port ``Server``
(``device="cpu"``) and a port ``Client``, against the port's
``MockConsulServer``: service and script-check registration through the
task lifecycle, and Connect's sidecar injection and envoy bootstrap.
"""
import time

import pytest

import nomad_tpu.integrations.vault as jvault
import nomad_tpu.mock as jmock
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

from nomad_tpu_torch import mock
from nomad_tpu_torch.integrations.consul import ConsulClient, ConsulConfig, MockConsulServer
from nomad_tpu_torch.integrations.vault import (
    MockVaultServer,
    VaultClient,
    VaultConfig,
    VaultError,
)
from nomad_tpu_torch.server import Server, ServerConfig
from test_torch_jobspec import outcome

PORT = dict(vault=(MockVaultServer, VaultClient, VaultConfig, VaultError), mock=mock,
            server=(Server, lambda **kw: ServerConfig(device="cpu", **kw)))
JAX = dict(vault=(jvault.MockVaultServer, jvault.VaultClient, jvault.VaultConfig,
                  jvault.VaultError),
           mock=jmock, server=(JaxServer, lambda **kw: JaxServerConfig(**kw)))


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def vault():
    srv = MockVaultServer().start()
    yield srv
    srv.stop()


# -- TestVaultClient ----------------------------------------------------------


class TestVaultClient:
    def test_derive_renew_revoke(self, vault):
        client = VaultClient(VaultConfig(enabled=True, address=vault.address, token="root"))
        derived = client.derive_token(["db-read", "kv-write"])
        assert derived["token"].startswith("s.") and derived["accessor"]
        tok = vault.by_accessor[derived["accessor"]]
        assert tok.policies == ["db-read", "kv-write"]
        client.renew(derived["token"])
        assert tok.renewals == 1
        client.revoke_accessor(derived["accessor"])
        assert tok.revoked

    def test_bad_server_token_rejected(self, vault):
        client = VaultClient(VaultConfig(enabled=True, address=vault.address, token="wrong"))
        with pytest.raises(VaultError):
            client.derive_token(["p"])

    def test_revoke_accessors_reports_failures(self, vault):
        client = VaultClient(VaultConfig(enabled=True, address=vault.address, token="root"))
        ok = client.derive_token(["a"])
        failed = client.revoke_accessors([ok["accessor"], "no-such-accessor"])
        assert failed == ["no-such-accessor"]


def _client_calls(pkg):
    """The Vault client's calls on each package's own mock server: what
    each returned or raised, tokens and accessors elided."""
    mock_cls, client_cls, cfg_cls, _err = pkg["vault"]
    srv = mock_cls().start()
    try:
        good = client_cls(cfg_cls(enabled=True, address=srv.address, token="root"))
        bad = client_cls(cfg_cls(enabled=True, address=srv.address, token="wrong"))
        derived = good.derive_token(["db-read", "kv-write"])
        tok = srv.by_accessor[derived["accessor"]]
        out = {"keys": sorted(derived), "prefix": derived["token"][:2],
               "policies": tok.policies}
        good.renew(derived["token"])
        out["renewals"] = tok.renewals
        out["failed"] = good.revoke_accessors([derived["accessor"], "no-such-accessor"])
        out["revoked"] = tok.revoked
        out["bad_token"] = outcome(bad.derive_token, ["p"])[:2]
        out["renew_unknown"] = outcome(good.renew, "s.nope")[:2]
        return out
    finally:
        srv.stop()


def test_vault_client_equals_the_jax_client():
    port, ref = _client_calls(PORT), _client_calls(JAX)
    assert port == ref
    assert port["failed"] == ["no-such-accessor"] and port["revoked"]


# -- TestServerVaultLifecycle -------------------------------------------------


def _lifecycle(pkg):
    """A Vault-enabled server: a job with a vault stanza is placed, the
    node derives its task's token, the task ends and the node says so;
    the token is revoked and its accessor untracked."""
    mock_cls, _client, cfg_cls, _err = pkg["vault"]
    server_cls, server_cfg = pkg["server"]
    vault_srv = mock_cls().start()
    server = server_cls(server_cfg(
        num_schedulers=1, heartbeat_min_ttl=60, heartbeat_max_ttl=60,
        vault=cfg_cls(enabled=True, address=vault_srv.address, token="root")))
    try:
        assert server.vault is not None
        server.start()
        node = pkg["mock"].node()
        server.register_node(node)
        job = pkg["mock"].job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.vault = {"policies": ["db-read"], "env": True}
        server.register_job(job)

        def placed():
            return server.fsm.state.allocs_by_job("default", job.id, True)

        wait_until(lambda: placed(), msg="alloc placed")
        alloc = placed()[0]
        out = {"unauthenticated": outcome(server.derive_vault_token, alloc.id, [task.name])[:2]}
        tokens = server.derive_vault_token(alloc.id, [task.name], node.id, node.secret_id)
        accessors = server.fsm.state.vault_accessors_by_alloc(alloc.id)
        tok = vault_srv.by_accessor[accessors[0]["accessor"]]
        out.update(tasks=sorted(tokens), tracked=[a["task"] for a in accessors],
                   policies=tok.policies, same_token=tokens[task.name] == tok.token,
                   revoked_before=tok.revoked)
        done = server.fsm.state.alloc_by_id(alloc.id).copy()
        done.client_status = "complete"
        server.update_allocs_from_client([done])
        wait_until(lambda: tok.revoked, msg="token revoked when the alloc ends")
        wait_until(lambda: server.fsm.state.vault_accessors_by_alloc(alloc.id) == [],
                   msg="accessor untracked")
        out["revoked_after"] = tok.revoked
        return out
    finally:
        server.stop()
        vault_srv.stop()


class TestServerVaultLifecycle:
    def test_derive_tracks_and_terminal_revokes(self):
        port, ref = _lifecycle(PORT), _lifecycle(JAX)
        assert port == ref
        assert port["tracked"] == [mock.job().task_groups[0].tasks[0].name]
        assert port["policies"] == ["db-read"] and port["same_token"]
        assert not port["revoked_before"] and port["revoked_after"]
        assert port["unauthenticated"] == ("error", "PermissionError")

    def test_vault_job_rejected_without_vault(self):
        server = Server(ServerConfig(device="cpu", num_schedulers=0))
        job = mock.job()
        job.task_groups[0].tasks[0].vault = {"policies": ["p"]}
        with pytest.raises(ValueError, match="vault stanza"):
            server.register_job(job)
        server.stop()

    def test_derive_requires_matching_node_secret(self, vault):
        """DeriveVaultToken is node-authenticated: the caller must present
        the placed node's secret_id, and the alloc must live on that node
        (node_endpoint.go:1370) — otherwise any RPC caller could mint
        tokens for any policy set."""
        server = Server(ServerConfig(
            device="cpu", num_schedulers=0,
            vault=VaultConfig(enabled=True, address=vault.address, token="root"),
        ))
        try:
            node = mock.node()
            other = mock.node()
            server.register_node(node)
            server.register_node(other)
            job = mock.job()
            task = job.task_groups[0].tasks[0]
            task.vault = {"policies": ["db-read"]}
            alloc = mock.alloc()
            alloc.job = job
            alloc.job_id = job.id
            alloc.node_id = node.id
            server.raft_apply("alloc-update", [alloc])

            # no credentials
            with pytest.raises(PermissionError):
                server.derive_vault_token(alloc.id, [task.name])
            # wrong secret
            with pytest.raises(PermissionError):
                server.derive_vault_token(alloc.id, [task.name], node.id, "bogus")
            # right secret, wrong node (alloc not placed there)
            with pytest.raises(PermissionError):
                server.derive_vault_token(alloc.id, [task.name], other.id, other.secret_id)
            # the placed node with its real secret succeeds
            tokens = server.derive_vault_token(alloc.id, [task.name], node.id, node.secret_id)
            assert task.name in tokens
        finally:
            server.stop()


def test_vault_enabled_server_config_builds_its_client(vault):
    """A ServerConfig with Vault enabled gives the server its VaultClient
    (the import at construction), as the JAX server does; disabled, none."""
    on = Server(ServerConfig(device="cpu", num_schedulers=0, vault=VaultConfig(
        enabled=True, address=vault.address, token="root")))
    off = Server(ServerConfig(device="cpu", num_schedulers=0,
                              vault=VaultConfig(enabled=False)))
    ref = JaxServer(JaxServerConfig(num_schedulers=0, vault=jvault.VaultConfig(
        enabled=True, address=vault.address, token="root")))
    try:
        assert isinstance(on.vault, VaultClient) and off.vault is None
        assert type(ref.vault).__name__ == type(on.vault).__name__
        assert on.vault.derive_token(["x"])["token"].startswith("s.")
    finally:
        for s in (on, off, ref):
            s.stop()


# -- Consul: tests/test_integrations.py's TestConsulClient, TestConsulConnect,
# -- TestScriptChecks and TestTaskServiceRegistration on a port Server + Client


@pytest.fixture
def consul():
    srv = MockConsulServer().start()
    yield srv
    srv.stop()


class TestConsulClient:
    def test_register_deregister(self, consul):
        client = ConsulClient(ConsulConfig(address=consul.address))
        client.register_service("web-1", "web", address="10.0.0.1", port=8080,
                                tags=["prod"])
        services = client.services()
        assert services["web-1"]["Name"] == "web"
        assert services["web-1"]["Tags"] == ["prod"]
        client.deregister_service("web-1")
        assert client.services() == {}


class TestConsulConnect:
    def test_sidecar_injection_hook(self):
        """Registering a job with a connect stanza injects the sidecar
        task + proxy port (job_endpoint_hook_connect.go:99)."""
        from nomad_tpu_torch.server.server import Server, ServerConfig
        from nomad_tpu_torch.structs.structs import NetworkResource, Service

        server = Server(ServerConfig(device="cpu", num_schedulers=0))
        try:
            job = mock.job()
            tg = job.task_groups[0]
            tg.networks = [NetworkResource(mbits=10)]
            tg.services = [Service(
                name="web-api", port_label="http",
                connect={"sidecar_service": {}},
            )]
            server.register_job(job)
            stored = server.fsm.state.job_by_id("default", job.id)
            tg2 = stored.task_groups[0]
            sidecars = [t for t in tg2.tasks if t.kind == "connect-proxy:web-api"]
            assert len(sidecars) == 1
            assert sidecars[0].name == "connect-proxy-web-api"
            assert sidecars[0].driver == "docker"
            labels = [p.label for p in tg2.networks[0].dynamic_ports]
            assert "connect-proxy-web-api" in labels
            # re-registering must not double-inject
            server.register_job(stored)
            stored2 = server.fsm.state.job_by_id("default", job.id)
            again = [t for t in stored2.task_groups[0].tasks
                     if t.kind == "connect-proxy:web-api"]
            assert len(again) == 1
        finally:
            server.stop()

    def test_connect_requires_single_network(self):
        from nomad_tpu_torch.server.server import Server, ServerConfig
        from nomad_tpu_torch.structs.structs import Service

        server = Server(ServerConfig(device="cpu", num_schedulers=0))
        try:
            job = mock.job()
            tg = job.task_groups[0]
            tg.networks = []  # no group network
            tg.services = [Service(name="api", connect={"sidecar_service": {}})]
            with pytest.raises(ValueError, match="exactly 1 network"):
                server.register_job(job)
        finally:
            server.stop()

    def test_sidecar_and_proxy_registered_in_consul(self, consul):
        """End-to-end: a connect job's group service AND its sidecar proxy
        service (Kind=connect-proxy, DestinationServiceName) land in the
        mock Consul; the injected sidecar task actually runs."""
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.integrations.consul import ConsulConfig
        from nomad_tpu_torch.server.server import Server, ServerConfig
        from nomad_tpu_torch.structs.structs import NetworkResource, Service

        server = Server(ServerConfig(
            device="cpu", num_schedulers=1, heartbeat_min_ttl=60, heartbeat_max_ttl=60,
        ))
        server.start()
        client = Client(ServerProxy(server), ClientConfig(
            consul=ConsulConfig(address=consul.address),
        ))
        try:
            client.start()
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = 1
            tg.networks = [NetworkResource(mbits=10)]
            task = tg.tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh", "args": ["-c", "sleep 60"]}
            task.resources.networks = []
            tg.services = [Service(
                name="countdash", port_label="connect-proxy-countdash",
                connect={
                    "sidecar_service": {},
                    # non-docker environment: run a stand-in proxy
                    "sidecar_task": {
                        "driver": "raw_exec",
                        "config": {"command": "/bin/sh",
                                   "args": ["-c", "sleep 60"]},
                    },
                },
            )]
            server.register_job(job)

            def running():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return [a for a in allocs if a.client_status == "running"]

            wait_until(lambda: running(), msg="connect alloc running")
            alloc = running()[0]
            # both tasks (app + injected sidecar) run
            ar = client.allocrunners[alloc.id]
            assert set(ar.task_runners) == {"web", "connect-proxy-countdash"}

            # envoy bootstrap hook: the sidecar task's secrets dir holds
            # the generated bootstrap config (envoybootstrap_hook.go)
            import json as _json
            import os as _os

            sidecar_tr = ar.task_runners["connect-proxy-countdash"]
            bs_path = _os.path.join(sidecar_tr.task_dir.secrets_dir,
                                    "envoy_bootstrap.json")
            assert _os.path.exists(bs_path)
            bs = _json.load(open(bs_path))
            assert bs["node"]["cluster"] == "countdash"
            assert bs["node"]["id"].endswith("-countdash-sidecar-proxy")
            assert alloc.id in bs["node"]["id"]

            wait_until(
                lambda: any("sidecar-proxy" in sid for sid in consul.services),
                msg="proxy service registered",
            )
            group_svcs = {s["Name"]: s for s in consul.services.values()}
            assert "countdash" in group_svcs
            proxy = group_svcs["countdash-sidecar-proxy"]
            assert proxy["Kind"] == "connect-proxy"
            assert proxy["Proxy"]["DestinationServiceName"] == "countdash"
            # the proxy advertises the injected dynamic port
            assert proxy["Port"] > 0

            # stop -> THIS alloc's service instances deregister. Assert by
            # service ID (which embeds the alloc id): the scheduler may
            # already have placed a replacement alloc that re-registers
            # the same service NAMES, so name-based checks race.
            server.stop_alloc(alloc.id)
            wait_until(
                lambda: not any(alloc.id in sid for sid in consul.services),
                msg="group services deregistered",
            )
        finally:
            client.shutdown()
            server.stop()


class TestScriptChecks:
    def test_script_check_heartbeats_ttl(self, consul):
        """Script checks run through the driver exec API and heartbeat a
        TTL check in Consul (command/agent/consul/script.go): a passing
        command reports passing; a failing one reports critical; the
        check deregisters with the task."""
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig
        from nomad_tpu_torch.structs.structs import Service

        server = Server(ServerConfig(device="cpu", num_schedulers=1, heartbeat_min_ttl=60,
                                     heartbeat_max_ttl=60))
        server.start()
        client = Client(
            ServerProxy(server),
            ClientConfig(consul=ConsulConfig(address=consul.address)),
        )
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh", "args": ["-c", "sleep 60"]}
            task.resources.networks = []
            task.services = [Service(name="scripted", checks=[
                {"name": "ok-check", "type": "script",
                 "command": "/bin/sh", "args": ["-c", "echo healthy; exit 0"],
                 "interval": "1s", "timeout": "5s"},
                {"name": "bad-check", "type": "script",
                 "command": "/bin/sh", "args": ["-c", "echo broken; exit 2"],
                 "interval": "1s", "timeout": "5s"},
            ])]
            server.register_job(job)

            def check(name):
                for cid, c in consul.checks.items():
                    if c["Name"] == name:
                        return c
                return None

            wait_until(lambda: check("ok-check") is not None
                       and check("ok-check")["Status"] == "passing",
                       msg="passing script check")
            assert "healthy" in check("ok-check")["Output"]
            wait_until(lambda: check("bad-check") is not None
                       and check("bad-check")["Status"] == "critical",
                       msg="critical script check")
            assert "broken" in check("bad-check")["Output"]
            # script checks registered against the service, TTL-style
            cid = next(c for c, v in consul.checks.items()
                       if v["Name"] == "ok-check")
            assert consul.checks[cid]["ServiceID"].startswith("_nomad-task-")
            assert consul.checks[cid]["TTL"]

            # stop -> the stopped task's checks deregister. Match on the
            # captured check ID (it embeds the alloc id), not the check
            # name: stop_alloc is a migrate, so the replacement alloc
            # re-registers the same names and can overlap the old
            # task's kill window.
            allocs = server.fsm.state.allocs_by_job("default", job.id, True)
            server.stop_alloc(allocs[0].id)
            wait_until(lambda: cid not in consul.checks,
                       msg="stopped task's script checks deregistered")
        finally:
            client.shutdown()
            server.stop()


class TestTaskServiceRegistration:
    def test_services_follow_task_lifecycle(self, consul):
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig
        from nomad_tpu_torch.structs.structs import Service

        server = Server(ServerConfig(device="cpu", num_schedulers=1, heartbeat_min_ttl=60,
                                     heartbeat_max_ttl=60))
        server.start()
        client = Client(
            ServerProxy(server),
            ClientConfig(consul=ConsulConfig(address=consul.address)),
        )
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "mock"
            task.config = {"run_for": "2s"}
            task.services = [Service(name="web", tags=["v1"],
                                     checks=[{"name": "alive", "ttl": "10s"}])]
            server.register_job(job)

            wait_until(lambda: len(consul.services) == 1,
                       msg="service registered while running")
            (sid, svc), = consul.services.items()
            assert svc["Name"] == "web" and svc["Tags"] == ["v1"]
            assert sid.startswith("_nomad-task-")
            assert svc["Checks"][0]["Name"] == "alive"

            wait_until(lambda: len(consul.services) == 0, timeout=60,
                       msg="service deregistered after exit")
        finally:
            client.shutdown()
            server.stop()
