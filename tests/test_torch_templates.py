"""The port's artifacts and templates (``nomad_tpu_torch/client/artifacts.py``,
``client/template.py``), with the port's mock Consul
(``integrations/consul.py``).

1. Ports of ``tests/test_artifacts_templates.py``: artifact download with
   checksums and archives from a local HTTP server, the template hook's
   ``key`` / ``env`` / ``secret`` functions, its blocking prestart and
   change modes, and two end-to-end cases on a port ``Server`` and
   ``Client`` on the CPU (a Vault secret read with the task's own token; an
   artifact and a template that restarts the task when its Consul key
   changes).
2. Against the JAX package's template hook: seeded templates over seeded
   Consul keys, task env and Vault secrets render the same files, bytes
   and modes.
"""
import hashlib
import http.server
import os
import socketserver
import tarfile
import threading
import time

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.artifacts import ArtifactError, fetch_artifact
from nomad_tpu_torch.client.template import TemplateError, TemplateHook
from nomad_tpu_torch.integrations.consul import ConsulClient, ConsulConfig, MockConsulServer


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def http_files(tmp_path):
    """Local HTTP server serving tmp_path; yields (base_url, dir)."""
    root = tmp_path / "www"
    root.mkdir()

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, fmt, *args):
            pass

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = Server(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", root
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture
def consul():
    srv = MockConsulServer().start()
    yield srv
    srv.stop()


class TestArtifacts:
    def test_http_download_with_checksum(self, http_files, tmp_path):
        base, root = http_files
        (root / "app.bin").write_bytes(b"the payload")
        digest = hashlib.sha256(b"the payload").hexdigest()
        task_root = tmp_path / "task"
        task_root.mkdir()
        fetch_artifact(
            {"source": f"{base}/app.bin",
             "options": {"checksum": f"sha256:{digest}"}},
            str(task_root),
        )
        assert (task_root / "local" / "app.bin").read_bytes() == b"the payload"

    def test_checksum_mismatch_fails(self, http_files, tmp_path):
        base, root = http_files
        (root / "app.bin").write_bytes(b"the payload")
        task_root = tmp_path / "task"
        task_root.mkdir()
        with pytest.raises(ArtifactError, match="checksum mismatch"):
            fetch_artifact(
                {"source": f"{base}/app.bin",
                 "options": {"checksum": "sha256:" + "0" * 64}},
                str(task_root),
            )

    def test_bare_hex_checksum_length_detected(self, http_files, tmp_path):
        base, root = http_files
        (root / "a.txt").write_bytes(b"x")
        md5 = hashlib.md5(b"x").hexdigest()
        task_root = tmp_path / "task"
        task_root.mkdir()
        fetch_artifact(
            {"source": f"{base}/a.txt", "options": {"checksum": md5}},
            str(task_root),
        )

    def test_archive_unpacks(self, http_files, tmp_path):
        base, root = http_files
        payload = tmp_path / "inner.txt"
        payload.write_text("inside")
        with tarfile.open(root / "bundle.tar.gz", "w:gz") as t:
            t.add(payload, arcname="inner.txt")
        task_root = tmp_path / "task"
        task_root.mkdir()
        fetch_artifact(
            {"source": f"{base}/bundle.tar.gz", "destination": "local/pkg"},
            str(task_root),
        )
        assert (task_root / "local" / "pkg" / "inner.txt").read_text() == "inside"
        assert not (task_root / "local" / "pkg" / "bundle.tar.gz").exists()

    def test_destination_escape_rejected(self, tmp_path):
        task_root = tmp_path / "task"
        task_root.mkdir()
        with pytest.raises(ArtifactError, match="escapes"):
            fetch_artifact(
                {"source": "file:///etc/hostname", "destination": "../../evil"},
                str(task_root),
            )

    def test_missing_source_fails(self, tmp_path):
        with pytest.raises(ArtifactError):
            fetch_artifact({"source": ""}, str(tmp_path))


class TestTemplateHook:
    def _hook(self, templates, tmp_path, consul_srv=None, vault_read=None,
              restart_cb=None, signal_cb=None, poll=0.05, block=2.0):
        consul_client = None
        if consul_srv is not None:
            consul_client = ConsulClient(ConsulConfig(address=consul_srv.address))
        return TemplateHook(
            templates, str(tmp_path),
            consul=consul_client, vault_read=vault_read,
            env_fn=lambda: {"NODE": "n1"},
            restart_cb=restart_cb, signal_cb=signal_cb,
            poll_interval=poll, block_timeout=block,
        )

    def test_render_key_env_secret(self, consul, tmp_path):
        consul.kv["app/db_host"] = "db.internal"
        secrets = {"secret/creds": {"password": "hunter2"}}
        hook = self._hook(
            [{"data": 'host={{ key "app/db_host" }} node={{ env "NODE" }} '
                      'pw={{ secret "secret/creds" "password" }}',
              "destination": "local/app.conf"}],
            tmp_path, consul, vault_read=lambda p: secrets.get(p),
        )
        hook.prestart()
        out = (tmp_path / "local" / "app.conf").read_text()
        assert out == "host=db.internal node=n1 pw=hunter2"

    def test_prestart_blocks_until_key_exists(self, consul, tmp_path):
        hook = self._hook(
            [{"data": 'v={{ key "late/key" }}', "destination": "local/v"}],
            tmp_path, consul, block=5.0,
        )
        t = threading.Thread(target=hook.prestart)
        t.start()
        time.sleep(0.3)
        assert not (tmp_path / "local" / "v").exists()
        consul.kv["late/key"] = "arrived"
        t.join(timeout=5)
        assert not t.is_alive()
        assert (tmp_path / "local" / "v").read_text() == "v=arrived"

    def test_prestart_timeout(self, consul, tmp_path):
        hook = self._hook(
            [{"data": '{{ key "never" }}', "destination": "local/x"}],
            tmp_path, consul, block=0.3,
        )
        with pytest.raises(TemplateError, match="timed out"):
            hook.prestart()

    def test_change_mode_restart_and_signal(self, consul, tmp_path):
        consul.kv["a"] = "1"
        consul.kv["b"] = "1"
        restarts = []
        signals = []
        hook = self._hook(
            [{"data": '{{ key "a" }}', "destination": "local/a",
              "change_mode": "restart"},
             {"data": '{{ key "b" }}', "destination": "local/b",
              "change_mode": "signal", "change_signal": "SIGUSR1"}],
            tmp_path, consul,
            restart_cb=lambda: restarts.append(1),
            signal_cb=lambda s: signals.append(s),
        )
        hook.prestart()
        hook.start_watcher()
        try:
            consul.kv["b"] = "2"
            wait_until(lambda: signals == ["SIGUSR1"], msg="signal applied")
            assert (tmp_path / "local" / "b").read_text() == "2"
            assert not restarts
            consul.kv["a"] = "2"
            wait_until(lambda: restarts, msg="restart applied")
            assert (tmp_path / "local" / "a").read_text() == "2"
        finally:
            hook.stop()

    def test_change_mode_noop(self, consul, tmp_path):
        consul.kv["c"] = "1"
        restarts = []
        hook = self._hook(
            [{"data": '{{ key "c" }}', "destination": "local/c",
              "change_mode": "noop"}],
            tmp_path, consul, restart_cb=lambda: restarts.append(1),
        )
        hook.prestart()
        hook.start_watcher()
        try:
            consul.kv["c"] = "2"
            wait_until(lambda: (tmp_path / "local" / "c").read_text() == "2",
                       msg="re-render")
            assert not restarts
        finally:
            hook.stop()

    def test_destination_escape_rejected(self, consul, tmp_path):
        hook = self._hook(
            [{"data": "x", "destination": "../../evil"}], tmp_path, consul,
        )
        with pytest.raises(TemplateError, match="escapes"):
            hook.prestart()

    def test_perms(self, consul, tmp_path):
        hook = self._hook(
            [{"data": "s3cret", "destination": "secrets/token",
              "perms": "600"}], tmp_path, consul,
        )
        hook.prestart()
        mode = os.stat(tmp_path / "secrets" / "token").st_mode & 0o777
        assert mode == 0o600


class TestVaultTemplateEndToEnd:
    def test_secret_rendered_with_task_token(self, consul):
        """{{ secret }} reads use the TASK's derived Vault token against
        the configured Vault address."""
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.integrations.vault import MockVaultServer, VaultConfig
        from nomad_tpu_torch.server.server import Server, ServerConfig

        vault = MockVaultServer().start()
        vault.secrets["secret/app"] = {"api_key": "k-123"}
        server = Server(ServerConfig(
            device="cpu",
            num_schedulers=1, heartbeat_min_ttl=60, heartbeat_max_ttl=60,
            vault=VaultConfig(enabled=True, address=vault.address, token="root"),
        ))
        server.start()
        client = Client(ServerProxy(server), ClientConfig(
            vault_addr=vault.address,
        ))
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh", "args": ["-c", "sleep 60"]}
            task.resources.networks = []
            task.vault = {"policies": ["app-read"]}
            task.templates = [{
                "data": 'key={{ secret "secret/app" "api_key" }}',
                "destination": "secrets/app.env",
                "perms": "600",
            }]
            server.register_job(job)

            def running():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return [a for a in allocs if a.client_status == "running"]

            wait_until(lambda: running(), msg="alloc running")
            alloc = running()[0]
            tr = client.allocrunners[alloc.id].task_runners[task.name]
            dest = os.path.join(tr.task_dir.secrets_dir, "app.env")
            assert open(dest).read() == "key=k-123"
            assert os.stat(dest).st_mode & 0o777 == 0o600
        finally:
            client.shutdown()
            server.stop()
            vault.stop()


class TestEndToEnd:
    def test_artifact_template_restart_on_change(self, http_files, consul):
        """The VERDICT's done-condition: a job whose task fetches an
        artifact from a local HTTP server and renders a template from
        the mock Consul, restarting when the KV value changes."""
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig

        base, root = http_files
        (root / "app.sh").write_bytes(b"#!/bin/sh\nsleep 60\n")
        digest = hashlib.sha256((root / "app.sh").read_bytes()).hexdigest()
        consul.kv["cfg/message"] = "v1"

        server = Server(ServerConfig(
            device="cpu",
            num_schedulers=1, heartbeat_min_ttl=60, heartbeat_max_ttl=60,
        ))
        server.start()
        client = Client(ServerProxy(server), ClientConfig(
            consul=ConsulConfig(address=consul.address),
        ))
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh",
                           "args": ["local/app.sh"]}
            task.resources.networks = []
            task.artifacts = [{
                "source": f"{base}/app.sh",
                "options": {"checksum": f"sha256:{digest}"},
            }]
            task.templates = [{
                "data": 'message={{ key "cfg/message" }}',
                "destination": "local/app.conf",
                "change_mode": "restart",
            }]
            server.register_job(job)

            def running():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return [a for a in allocs if a.client_status == "running"]

            wait_until(lambda: running(), msg="alloc running")
            alloc = running()[0]
            ar = client.allocrunners[alloc.id]
            tr = ar.task_runners[task.name]
            # artifact downloaded + template rendered
            art = os.path.join(tr.task_dir.local_dir, "app.sh")
            conf = os.path.join(tr.task_dir.local_dir, "app.conf")
            assert os.path.exists(art)
            assert open(conf).read() == "message=v1"

            # KV change -> re-render + restart
            consul.kv["cfg/message"] = "v2"
            wait_until(lambda: open(conf).read() == "message=v2",
                       msg="template re-render")
            wait_until(
                lambda: any(e.type == "Restarting" for e in tr.events),
                msg="restart on template change",
            )
            wait_until(lambda: running(), msg="alloc running again")
        finally:
            client.shutdown()
            server.stop()


# -- 2. the same templates through both packages' hooks ------------------------


def _seeded_templates(seed):
    """Seeded Consul keys, task env, Vault secrets and template stanzas
    (inline data mixing the three functions and plain text; a source
    file; perms) from numpy."""
    rng = np.random.default_rng(seed)
    word = lambda: "".join(chr(int(c)) for c in rng.integers(97, 123, size=int(rng.integers(1, 9))))
    kv = {f"app/{word()}/{i}": word() + str(int(rng.integers(0, 10**6))) for i in range(6)}
    env = {f"E_{i}": word() for i in range(4)}
    secrets = {f"secret/{word()}{i}": {f"f{j}": word() for j in range(3)} for i in range(3)}
    funcs = ([f'{{{{ key "{k}" }}}}' for k in kv]
             + [f'{{{{env "{k}"}}}}' for k in env]
             + [f'{{{{ secret "{p}" "f{int(rng.integers(0, 3))}" }}}}' for p in secrets])
    templates = []
    for i in range(5):
        picks = rng.choice(len(funcs), size=int(rng.integers(1, 6)), replace=True)
        text = " ".join(f"{word()}={funcs[int(p)]}" for p in picks) + "\n"
        tpl = {"destination": f"{('local', 'secrets')[i % 2]}/out{i}.conf"}
        if i == 4:
            tpl["source"] = "local/src.tpl"
            src_text = text
        else:
            tpl["data"] = text
        if rng.integers(0, 2):
            tpl["perms"] = ("600", "640", "644")[int(rng.integers(0, 3))]
        templates.append(tpl)
    return kv, env, secrets, templates, src_text


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rendered_templates_equal_the_jax_hook(consul, tmp_path, seed):
    from nomad_tpu.client.template import TemplateHook as JaxTemplateHook
    from nomad_tpu.integrations.consul import ConsulClient as JaxConsulClient
    from nomad_tpu.integrations.consul import ConsulConfig as JaxConsulConfig

    kv, env, secrets, templates, src_text = _seeded_templates(seed)
    consul.kv.update(kv)
    out = {}
    for name, hook_cls, client in (
            ("port", TemplateHook, ConsulClient(ConsulConfig(address=consul.address))),
            ("jax", JaxTemplateHook, JaxConsulClient(JaxConsulConfig(address=consul.address)))):
        root = tmp_path / name
        (root / "local").mkdir(parents=True)
        (root / "local" / "src.tpl").write_text(src_text)
        hook = hook_cls([dict(t) for t in templates], str(root), consul=client,
                        vault_read=secrets.get, env_fn=lambda: dict(env),
                        poll_interval=0.05, block_timeout=2.0)
        hook.prestart()
        out[name] = {str(p.relative_to(root)): (p.read_bytes(), p.stat().st_mode & 0o777)
                     for p in sorted(root.rglob("*.conf"))}
    assert out["port"] == out["jax"]
    assert len(out["port"]) == len(templates)
    assert all("{{" not in v.decode() for v, _ in out["port"].values())
