"""The port's task drivers and driver plugins.

1. Ports of ``tests/test_drivers_extra.py`` (docker against the in-tree
   fake daemon of ``tests/fake_docker.py``; java and qemu as command
   construction and gating) on ``nomad_tpu_torch.client.drivers``.
2. Ports of ``tests/test_plugins.py``'s driver-plugin and catalog cases
   (``TestExternalDriver``, ``TestCatalog``,
   ``TestClientWithExternalDriver``): built-in drivers served out of
   process by ``python -m nomad_tpu_torch.plugins.launch driver <name>``
   over the port's transport and codec, a discovered plugin executable,
   and a port ``Client`` running an alloc through a subprocess driver
   against a port ``Server`` on the CPU. (Its device-plugin, schema and
   HCL-spec cases are in ``tests/test_torch_devices.py``.)
"""
import os
import stat
import sys
import threading
import time

import pytest

from nomad_tpu_torch.client.drivers.base import (
    DriverError,
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    TaskConfig,
    new_driver,
)
from nomad_tpu_torch.client.drivers.docker import DockerDriver
from nomad_tpu_torch.client.drivers.java_driver import JavaDriver, java_cmd_args
from nomad_tpu_torch.client.drivers.qemu import QemuDriver, qemu_args
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER
from nomad_tpu_torch.plugins.catalog import (
    Catalog,
    launch_builtin_driver,
    register_external_driver,
    shutdown_external_instances,
)

from fake_docker import FakeDocker


# -- 1. tests/test_drivers_extra.py on the port -------------------------------


@pytest.fixture
def dockerd(tmp_path):
    sock = str(tmp_path / "docker.sock")
    fake = FakeDocker(sock).start()
    yield fake
    fake.stop()


@pytest.fixture
def driver(dockerd):
    d = DockerDriver(dockerd.socket_path)
    d.coordinator.image_gc = True
    return d


class TestDockerDriver:
    def test_fingerprint(self, driver, tmp_path):
        fp = driver.fingerprint()
        assert fp.health == HEALTH_HEALTHY
        assert fp.attributes["driver.docker.version"] == "fake-24.0"
        dead = DockerDriver(str(tmp_path / "nope.sock"))
        assert dead.fingerprint().health == HEALTH_UNDETECTED

    def test_full_lifecycle(self, driver, dockerd, tmp_path):
        cfg = TaskConfig(
            id="a1/web", name="web", alloc_id="a1",
            env={"PORT": "80"},
            config={"image": "redis:7", "command": "redis-server",
                    "args": ["--appendonly", "yes"]},
            cpu_limit=500, memory_limit_mb=256,
        )
        handle = driver.start_task(cfg)
        cid = handle.driver_state["container_id"]
        assert "redis:7" in dockerd.images, "image pulled"
        c = dockerd.containers[cid]
        assert c.state == "running"
        assert c.config["Cmd"] == ["redis-server", "--appendonly", "yes"]
        assert "PORT=80" in c.config["Env"]
        assert c.config["HostConfig"]["Memory"] == 256 << 20
        assert driver.inspect_task("a1/web").state == "running"
        assert driver.wait_task("a1/web", timeout=0.2) is None

        stats = driver.task_stats("a1/web")
        assert stats.memory_rss_bytes == 1024 * 1024

        dockerd.finish(cid, 3)
        res = driver.wait_task("a1/web", timeout=5.0)
        assert res is not None and res.exit_code == 3
        driver.destroy_task("a1/web")
        assert cid not in dockerd.containers
        assert "redis:7" in dockerd.removed_images, "image gc on last release"

    def test_stop_uses_graceful_then_kill(self, driver, dockerd):
        cfg = TaskConfig(id="a2/t", name="t", alloc_id="a2",
                         config={"image": "busybox:latest"})
        handle = driver.start_task(cfg)
        cid = handle.driver_state["container_id"]
        driver.stop_task("a2/t", timeout_s=1.0)
        res = driver.wait_task("a2/t", timeout=5.0)
        assert res is not None
        assert dockerd.containers[cid].state == "exited"

    def test_image_refcounting(self, driver, dockerd):
        h1 = driver.start_task(TaskConfig(id="r1/t", name="t", alloc_id="r1",
                                          config={"image": "shared:1"}))
        h2 = driver.start_task(TaskConfig(id="r2/t", name="t", alloc_id="r2",
                                          config={"image": "shared:1"}))
        assert dockerd.images["shared:1"] == 1, "one pull for two tasks"
        dockerd.finish(h1.driver_state["container_id"], 0)
        driver.wait_task("r1/t", timeout=5)
        driver.destroy_task("r1/t")
        assert "shared:1" not in dockerd.removed_images, "still referenced"
        dockerd.finish(h2.driver_state["container_id"], 0)
        driver.wait_task("r2/t", timeout=5)
        driver.destroy_task("r2/t")
        assert "shared:1" in dockerd.removed_images

    def test_log_pump_demuxes_streams(self, driver, dockerd, tmp_path):
        out_path = str(tmp_path / "t.stdout.0")
        err_path = str(tmp_path / "t.stderr.0")
        cfg = TaskConfig(id="l1/t", name="t", alloc_id="l1",
                         config={"image": "busybox:latest"},
                         stdout_path=out_path, stderr_path=err_path)
        handle = driver.start_task(cfg)
        cid = handle.driver_state["container_id"]
        dockerd.add_log(cid, 1, b"to stdout\n")
        dockerd.add_log(cid, 2, b"to stderr\n")
        # the pump reads the (non-follow in fake) stream once available
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if os.path.exists(out_path) and os.path.getsize(out_path) > 0:
                break
            time.sleep(0.05)
        assert open(out_path, "rb").read() == b"to stdout\n"
        assert open(err_path, "rb").read() == b"to stderr\n"
        dockerd.finish(cid, 0)

    def test_reconciler_removes_dangling(self, driver, dockerd):
        handle = driver.start_task(TaskConfig(id="k1/t", name="t", alloc_id="k1",
                                              config={"image": "busybox:latest"}))
        tracked_cid = handle.driver_state["container_id"]
        # a leaked container with the nomad label
        from fake_docker import FakeContainer

        leaked = FakeContainer("nomad-leaked", {
            "Labels": {"com.hashicorp.nomad.alloc_id": "dead"}})
        dockerd.containers[leaked.id] = leaked
        removed = driver.reconcile_dangling()
        assert removed == [leaked.id]
        assert tracked_cid in dockerd.containers, "tracked container kept"

    def test_recover_running_container(self, driver, dockerd):
        cfg = TaskConfig(id="rec/t", name="t", alloc_id="rec",
                         config={"image": "busybox:latest"})
        handle = driver.start_task(cfg)
        fresh = DockerDriver(dockerd.socket_path)
        fresh.recover_task(handle)
        assert fresh.inspect_task("rec/t").state == "running"
        dockerd.finish(handle.driver_state["container_id"], 0)
        assert fresh.wait_task("rec/t", timeout=5.0) is not None

    def test_pull_failure_surfaces(self, driver, dockerd):
        dockerd.fail_pull = True
        with pytest.raises(DriverError, match="pull failed"):
            driver.start_task(TaskConfig(id="p/t", name="t", alloc_id="p",
                                         config={"image": "nope:latest"}))

    def test_exec(self, driver, dockerd):
        handle = driver.start_task(TaskConfig(id="e/t", name="t", alloc_id="e",
                                              config={"image": "busybox:latest"}))
        out, code = driver.exec_task("e/t", ["echo", "hi"], timeout_s=5.0)
        assert code == 7  # fake reports ExitCode 7
        assert out == b"hi\n", "attached exec output demuxed"
        dockerd.finish(handle.driver_state["container_id"], 0)


class TestJavaDriver:
    def test_cmd_args(self):
        assert java_cmd_args({"jar_path": "/x/app.jar", "args": ["serve"],
                              "jvm_options": ["-Xmx256m"]}) == \
            ["-Xmx256m", "-jar", "/x/app.jar", "serve"]
        assert java_cmd_args({"class": "com.App", "class_path": "/lib/*"}) == \
            ["-cp", "/lib/*", "com.App"]
        with pytest.raises(DriverError):
            java_cmd_args({})

    def test_fingerprint_gated(self):
        import shutil

        fp = JavaDriver().fingerprint()
        if shutil.which("java"):
            assert fp.health == HEALTH_HEALTHY
        else:
            assert fp.health == HEALTH_UNDETECTED


class TestQemuDriver:
    def test_args(self):
        cfg = TaskConfig(name="vm", memory_limit_mb=1024,
                         config={"image_path": "/img/linux.qcow2",
                                 "port_map": {"22": 2222}})
        args = qemu_args(cfg)
        assert "-m" in args and "1024M" in args
        assert "file=/img/linux.qcow2" in " ".join(args)
        assert any("hostfwd=tcp::2222-:22" in a for a in args)
        with pytest.raises(DriverError):
            qemu_args(TaskConfig(config={}))

    def test_fingerprint_gated(self):
        import shutil

        fp = QemuDriver().fingerprint()
        if shutil.which("qemu-system-x86_64"):
            assert fp.health == HEALTH_HEALTHY
        else:
            assert fp.health == HEALTH_UNDETECTED


# -- 2. tests/test_plugins.py's driver-plugin and catalog cases on the port ---


@pytest.fixture
def ext_mock():
    drv = launch_builtin_driver("mock")
    yield drv
    drv.close()


class TestExternalDriver:
    def test_handshake_and_info(self, ext_mock):
        info = ext_mock.plugin_info()
        assert info.type == PLUGIN_TYPE_DRIVER
        assert info.name == "mock"
        assert ext_mock.capabilities.send_signals is True

    def test_full_task_lifecycle_across_process(self, ext_mock):
        cfg = TaskConfig(id="t1", name="web",
                         config={"run_for": "200ms", "exit_code": 3})
        handle = ext_mock.start_task(cfg)
        assert handle.driver == "mock" and handle.state == "running"
        status = ext_mock.inspect_task("t1")
        assert status.state in ("running", "exited")
        res = ext_mock.wait_task("t1", timeout=5.0)
        assert res is not None and res.exit_code == 3
        assert ext_mock.inspect_task("t1").state == "exited"
        ext_mock.destroy_task("t1")
        with pytest.raises(DriverError):
            ext_mock.inspect_task("t1")

    def test_concurrent_wait_and_stop(self, ext_mock):
        """wait_task blocks in the plugin while stop_task lands on another
        pooled connection — the go-plugin concurrency property."""
        ext_mock.start_task(TaskConfig(id="t2", name="w",
                                       config={"run_for": "30s"}))
        results = {}

        def waiter():
            results["res"] = ext_mock.wait_task("t2", timeout=10.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.2)
        ext_mock.stop_task("t2", timeout_s=2.0)
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert results["res"] is not None and results["res"].signal == 15

    def test_driver_error_crosses_boundary(self, ext_mock):
        with pytest.raises(DriverError, match="boom"):
            ext_mock.start_task(TaskConfig(id="t3", name="w",
                                           config={"start_error": "boom"}))

    def test_plugin_crash_surfaces_as_driver_error(self):
        drv = launch_builtin_driver("mock")
        drv.client.process.kill()
        drv.client.process.wait(timeout=5)
        with pytest.raises(DriverError):
            drv.start_task(TaskConfig(id="t4", name="w", config={}))
        drv.close()

    def test_registered_external_driver_is_shared(self):
        register_external_driver("mock")
        try:
            a = new_driver("mock")
            b = new_driver("mock")
            assert a is b, "one subprocess instance shared across tasks"
            a.start_task(TaskConfig(id="s1", name="w", config={"run_for": 0}))
            assert b.wait_task("s1", timeout=5.0) is not None
        finally:
            shutdown_external_instances()
            # restore the in-process registration for other tests
            from nomad_tpu_torch.client.drivers.mock_driver import MockDriver, register
            register("mock", MockDriver)


class TestCatalog:
    def test_discovery_launches_executables(self, tmp_path):
        script = tmp_path / "nomad-driver-extmock"
        script.write_text(
            "#!/bin/sh\nexec {} -m nomad_tpu_torch.plugins.launch driver mock\n".format(sys.executable)
        )
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        (tmp_path / "ignored.txt").write_text("not a plugin")
        cat = Catalog(str(tmp_path)).discover()
        try:
            assert list(cat.drivers) == ["mock"]
            drv = cat.drivers["mock"]
            drv.start_task(TaskConfig(id="c1", name="w", config={"run_for": 0}))
            assert drv.wait_task("c1", timeout=5.0) is not None
        finally:
            cat.close()
            from nomad_tpu_torch.client.drivers.mock_driver import MockDriver, register
            register("mock", MockDriver)


class TestClientWithExternalDriver:
    def test_alloc_runs_through_subprocess_driver(self):
        """Full client path — alloc runner → task runner → driver — with
        the driver out-of-process (the reference's production topology)."""
        import time as _time

        from nomad_tpu_torch import mock
        from nomad_tpu_torch.client.client import Client, ClientConfig, ServerProxy
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(device="cpu", num_schedulers=1, heartbeat_min_ttl=60,
                                     heartbeat_max_ttl=60))
        server.start()
        client = Client(
            ServerProxy(server),
            ClientConfig(external_drivers={"mock": {}}),
        )
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].driver = "mock"
            job.task_groups[0].tasks[0].config = {"run_for": "30s"}
            server.register_job(job)
            deadline = _time.monotonic() + 30
            while _time.monotonic() < deadline:
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                if allocs and allocs[0].client_status == "running":
                    break
                _time.sleep(0.2)
            else:
                raise AssertionError("alloc never reached running via external driver")
            from nomad_tpu_torch.plugins.driver_plugin import ExternalDriver
            drv = client.resolve_driver("mock")
            assert isinstance(drv, ExternalDriver), "client-owned subprocess driver"
            # the global registry is untouched: another client in this
            # process still gets the in-process driver
            from nomad_tpu_torch.client.drivers.mock_driver import MockDriver
            assert isinstance(new_driver("mock"), MockDriver)
        finally:
            client.shutdown()
            server.stop()
