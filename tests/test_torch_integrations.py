"""The port's Vault integration (``nomad_tpu_torch/integrations/vault``)
and the server's Vault path, held against the JAX package.

``TestVaultClient`` and ``TestServerVaultLifecycle`` of
``tests/test_integrations.py`` run on the port, against the port's
``MockVaultServer``, and each Vault-side result is compared with the JAX
package's on the same calls. The client half of the lifecycle (the task
runner's vault hook and its status updates) waits for the client: here
the test makes the node's calls itself (``derive_vault_token`` with the
node's secret, ``update_allocs_from_client`` when the task ends).
"""
import time

import pytest

import nomad_tpu.integrations.vault as jvault
import nomad_tpu.mock as jmock
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

from nomad_tpu_torch import mock
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
