"""The port's client runtime (``nomad_tpu_torch/client/``): drivers, the
task environment, task and alloc runners, the alloc watcher, the state
DB, fingerprinting and the ``Client`` against a port ``Server`` on the CPU.

1. Ports of ``tests/test_client.py`` (its nine cases). The end-to-end
   cases run the port's server with its engine on the CPU (the int arm,
   ``device_min_placements=0``: every eval through the plain versions of
   the kernels), where the reference runs host binpack.
2. Ports of ``tests/test_allocwatcher.py``'s cases that need no Agent
   (``TestWaitTerminal``, ``TestLocalMigration``,
   ``TestEndToEndMigration``), ``tests/test_devicemanager.py``'s
   ``TestEndToEndDeviceScheduling`` (with the mock plugin, and with the
   cuda plugin over a stood-in ``torch.cuda``), and
   ``tests/test_rpc.py::test_client_over_wire_runs_job`` through
   ``client/servers.py``'s failover proxy.
3. Against the JAX package, same seeded inputs, exact equality: the task
   environment, the node fingerprint, the device env of a mock-device
   reservation, and the end state of ``test_client``'s four jobs on a JAX
   ``Server`` + ``Client`` and on a port ``Server(device="cpu")`` +
   ``Client``.
4. A task assigned devices on a client with no device plugin starts
   without them, as in the reference (held against its ``AllocRunner``).
"""
import os
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig, ServerProxy
from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.allocwatcher import PrevAllocWatcher
from nomad_tpu_torch.client.drivers.base import TaskConfig, new_driver
from nomad_tpu_torch.client.taskenv import TaskEnvBuilder
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.structs import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_RUNNING,
    RequestedDevice,
    RestartPolicy,
    UpdateStrategy,
)

GPU_NAME = "NVIDIA H100 80GB HBM3"


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def engine_config(**kw):
    """The port's server on the CPU through its engine, int arm."""
    return ServerConfig(device="cpu", deterministic=True, device_min_placements=0, **kw)


# -- 1. tests/test_client.py on the port -----------------------------------------


def test_mock_driver_lifecycle():
    d = new_driver("mock")
    h = d.start_task(TaskConfig(id="t1", name="t", config={"run_for": 0.05, "exit_code": 3}))
    assert h.state == "running"
    res = d.wait_task("t1", timeout=5.0)
    assert res.exit_code == 3
    status = d.inspect_task("t1")
    assert status.state == "exited"
    d.destroy_task("t1")


def test_raw_exec_driver_runs_real_process(tmp_path):
    ad = AllocDir(str(tmp_path), "alloc1")
    ad.build()
    td = ad.new_task_dir("t")
    td.build()
    os.makedirs(td.log_dir, exist_ok=True)
    d = new_driver("raw_exec")
    cfg = TaskConfig(
        id="t1",
        name="t",
        config={"command": "/bin/sh", "args": ["-c", "echo hello-$WHO"]},
        env={"WHO": "nomad"},
        task_dir=td,
        stdout_path=os.path.join(td.log_dir, "t.stdout.0"),
        stderr_path=os.path.join(td.log_dir, "t.stderr.0"),
    )
    d.start_task(cfg)
    res = d.wait_task("t1", timeout=10.0)
    assert res.exit_code == 0
    with open(cfg.stdout_path) as f:
        assert f.read().strip() == "hello-nomad"
    d.destroy_task("t1")


def test_raw_exec_stop_escalates_to_kill(tmp_path):
    d = new_driver("raw_exec")
    cfg = TaskConfig(
        id="t1", name="t",
        config={"command": "/bin/sh", "args": ["-c", "trap '' TERM; sleep 60"]},
    )
    d.start_task(cfg)
    time.sleep(0.2)
    start = time.monotonic()
    d.stop_task("t1", timeout_s=0.5)
    res = d.wait_task("t1", timeout=5.0)
    assert time.monotonic() - start < 5.0
    assert res.signal == 9  # escalated


def test_task_env_interpolation():
    node = mock.node()
    node.attributes["kernel.name"] = "linux"
    alloc = mock.alloc()
    job = mock.job()
    alloc.job = job
    alloc.job_id = job.id
    alloc.task_group = job.task_groups[0].name
    alloc.name = f"{job.id}.web[2]"
    task = job.task_groups[0].tasks[0]
    task.env = {"K": "${attr.kernel.name}", "NODE": "${node.datacenter}"}
    env = TaskEnvBuilder(node, alloc, task).build()
    assert env["K"] == "linux"
    assert env["NODE"] == node.datacenter
    assert env["NOMAD_ALLOC_INDEX"] == "2"
    assert env["NOMAD_JOB_ID"] == job.id


@pytest.fixture
def cluster(tmp_path):
    s = Server(engine_config(num_schedulers=2))
    s.start()
    c = Client(ServerProxy(s), ClientConfig(state_dir=str(tmp_path / "client")))
    c.start()
    yield s, c
    c.shutdown()
    s.stop()


def batch_echo_job(mock_mod=mock):
    job = mock_mod.job()
    job.type = "batch"
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy.attempts = 0
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", "echo done"]}
    task.restart_policy = RestartPolicy(attempts=0, mode="fail")
    return job


def test_client_runs_real_job_end_to_end(cluster):
    server, client = cluster
    job = batch_echo_job()
    server.register_job(job)
    wait_for(
        lambda: any(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
        ),
        msg="batch job completed via real subprocess",
    )
    allocs = server.fsm.state.allocs_by_job(job.namespace, job.id, True)
    states = allocs[0].task_states
    assert states and all(s.successful() for s in states.values())


def test_failing_task_reports_failed(cluster):
    server, client = cluster
    job = batch_echo_job()
    job.task_groups[0].tasks[0].config = {"command": "/bin/sh", "args": ["-c", "exit 7"]}
    server.register_job(job)
    wait_for(
        lambda: any(
            a.client_status == ALLOC_CLIENT_FAILED
            for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
        ),
        msg="failed status synced",
    )


def test_service_job_health_feeds_deployment(cluster):
    """The alloc health watcher reports healthy -> deployment succeeds with
    no test-side simulation."""
    server, client = cluster
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = UpdateStrategy(
        max_parallel=2, min_healthy_time_ns=int(0.2e9)
    )
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", "sleep 300"]}
    server.register_job(job)
    wait_for(
        lambda: (
            (d := server.fsm.state.latest_deployment_by_job_id(job.namespace, job.id))
            is not None
            and d.status == "successful"
        ),
        timeout=20.0,
        msg="deployment driven healthy by the client",
    )
    assert server.fsm.state.job_by_id(job.namespace, job.id).stable is True


def test_stop_job_stops_allocs(cluster):
    server, client = cluster
    job = mock.job()
    job.task_groups[0].count = 1
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", "sleep 300"]}
    server.register_job(job)
    wait_for(
        lambda: any(
            a.client_status == ALLOC_CLIENT_RUNNING
            for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
        ),
        msg="running",
    )
    server.deregister_job(job.namespace, job.id)
    wait_for(
        lambda: all(
            a.client_terminal_status() or a.server_terminal_status()
            for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
        ),
        msg="allocs terminal after stop",
    )
    wait_for(lambda: all(tr.done.is_set() for ar in client.allocrunners.values()
                         for tr in ar.task_runners.values()), msg="runner stopped")


def test_client_restart_recovers_allocs(tmp_path):
    """Client restart: persisted state restores runners and re-attaches the
    live process (client.go:991 restore + RecoverTask)."""
    s = Server(engine_config(num_schedulers=2))
    s.start()
    state_dir = str(tmp_path / "client")
    c = Client(ServerProxy(s), ClientConfig(state_dir=state_dir, persist_state=True))
    c.start()
    try:
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh", "args": ["-c", "sleep 300"]}
        server_job_ns, server_job_id = job.namespace, job.id
        s.register_job(job)
        wait_for(
            lambda: any(
                a.client_status == ALLOC_CLIENT_RUNNING
                for a in s.fsm.state.allocs_by_job(server_job_ns, server_job_id, True)
            ),
            msg="running before restart",
        )
        pid = None
        for ar in c.allocrunners.values():
            for tr in ar.task_runners.values():
                pid = tr.handle.driver_state.get("pid")
        assert pid is not None

        # "crash" the client without stopping tasks
        c._shutdown.set()
        c.state_db.close()

        c2 = Client(
            ServerProxy(s),
            ClientConfig(state_dir=state_dir, persist_state=True),
            node=c.node,
        )
        c2.start()
        try:
            assert c2.num_allocs() == 1
            os.kill(pid, 0)  # original process still alive and re-attached
        finally:
            c2.shutdown()
    finally:
        c.shutdown()
        s.stop()


# -- 2. the alloc watcher, device scheduling and the wire -------------------------


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


class TestWaitTerminal:
    def test_waits_for_local_runner_terminal(self):
        import threading

        runner = FakeRunner("running")
        w = PrevAllocWatcher(
            FakeAlloc("new"), "prev",
            local_runner_lookup=lambda a: runner,
            alloc_dir_base="/nonexistent",
            poll_interval=0.01, timeout=5.0,
        )
        done = threading.Event()
        t = threading.Thread(target=lambda: (w._wait_terminal(), done.set()))
        t.start()
        time.sleep(0.15)
        assert not done.is_set(), "must still be waiting on a running prev alloc"
        runner.status = "complete"
        t.join(timeout=2.0)
        assert done.is_set()

    def test_unknown_prev_alloc_does_not_block(self):
        w = PrevAllocWatcher(
            FakeAlloc("new"), "prev",
            local_runner_lookup=lambda a: None,
            alloc_dir_base="/nonexistent",
            remote_alloc_info=lambda a: None,  # GC'd
            poll_interval=0.01, timeout=5.0,
        )
        start = time.monotonic()
        w._wait_terminal()
        assert time.monotonic() - start < 1.0

    def test_remote_status_polled(self):
        statuses = iter(["running", "running", "complete"])
        w = PrevAllocWatcher(
            FakeAlloc("new"), "prev",
            local_runner_lookup=lambda a: None,
            alloc_dir_base="/nonexistent",
            remote_alloc_info=lambda a: {"client_status": next(statuses)},
            poll_interval=0.01, timeout=5.0,
        )
        w._wait_terminal()  # returns once the iterator yields terminal


class TestLocalMigration:
    def test_move_and_copy(self, tmp_path):
        src = tmp_path / "prev" / "alloc" / "data"
        src.mkdir(parents=True)
        (src / "state.db").write_text("precious")
        dest = tmp_path / "new" / "alloc" / "data"

        PrevAllocWatcher._migrate_local(str(src), str(dest), move=True)
        assert (dest / "state.db").read_text() == "precious"
        assert os.path.isdir(src) and not os.listdir(src), "moved, dir recreated"

        # copy mode keeps the source
        (src / "again.txt").write_text("x")
        dest2 = tmp_path / "new2" / "alloc" / "data"
        PrevAllocWatcher._migrate_local(str(src), str(dest2), move=False)
        assert (dest2 / "again.txt").read_text() == "x"
        assert (src / "again.txt").exists()


class TestEndToEndMigration:
    def test_data_follows_rescheduled_alloc(self):
        """Job with sticky+migrate ephemeral disk: alloc writes to
        $NOMAD_ALLOC_DIR/data, gets stopped (migrate transition), and the
        replacement alloc finds the data in ITS alloc dir
        (generic_sched.go:630 findPreferredNode + allocwatcher migrate)."""
        server = Server(engine_config(num_schedulers=1, heartbeat_min_ttl=60,
                                      heartbeat_max_ttl=60))
        server.start()
        client = Client(ServerProxy(server), ClientConfig())
        try:
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].ephemeral_disk.sticky = True
            job.task_groups[0].ephemeral_disk.migrate = True
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {
                "command": "/bin/sh",
                "args": ["-c",
                         "echo payload-42 > $NOMAD_ALLOC_DIR/data/keep.txt; sleep 300"],
            }
            server.register_job(job)

            def first_running():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return [a for a in allocs if a.client_status == "running"]

            wait_for(lambda: first_running(), timeout=30, msg="first alloc running")
            old = first_running()[0]
            marker = os.path.join(client.alloc_dir_base, old.id,
                                  "alloc", "data", "keep.txt")
            wait_for(lambda: os.path.exists(marker), timeout=30, msg="task wrote data")

            server.stop_alloc(old.id)

            def replacement():
                allocs = server.fsm.state.allocs_by_job("default", job.id, True)
                return [a for a in allocs
                        if a.id != old.id and a.client_status == "running"]

            wait_for(lambda: replacement(), timeout=60, msg="replacement alloc")
            new = replacement()[0]
            assert new.previous_allocation == old.id
            migrated = os.path.join(client.alloc_dir_base, new.id,
                                    "alloc", "data", "keep.txt")
            wait_for(lambda: os.path.exists(migrated), timeout=30, msg="data migrated")
            assert open(migrated).read().strip() == "payload-42"
        finally:
            client.shutdown()
            server.stop()


def fake_cuda(monkeypatch, names):
    """``torch.cuda`` as a host with these cards would report them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(names))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(names))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: names[i])


def _run_device_job(tmp_path, plugins, ask, count):
    """``TestEndToEndDeviceScheduling``'s path: a client with these
    built-in device plugins, a raw_exec task asking ``count`` of ``ask``
    that dumps its env. Returns (the alloc's assigned device ids, the
    task's env)."""
    server = Server(engine_config(num_schedulers=1, heartbeat_min_ttl=60,
                                  heartbeat_max_ttl=60))
    server.start()
    client = Client(ServerProxy(server), ClientConfig(
        state_dir=str(tmp_path / "client"), device_plugins=plugins))
    try:
        client.start()
        stored = server.fsm.state.node_by_id(client.node.id)
        assert stored.node_resources.devices, "devices registered"
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh",
                       "args": ["-c", "env > $NOMAD_TASK_DIR/envdump; sleep 30"]}
        task.resources.devices = [RequestedDevice(name=ask, count=count)]
        server.register_job(job)
        alloc = None

        def running():
            nonlocal alloc
            allocs = server.fsm.state.allocs_by_job("default", job.id, True)
            alloc = allocs[0] if allocs and allocs[0].client_status == "running" else None
            return alloc is not None

        wait_for(running, timeout=30, msg="alloc running")
        ids = sorted(i for d in alloc.allocated_resources.tasks[task.name].devices
                     for i in d.device_ids)
        dump = os.path.join(client.alloc_dir_base, alloc.id, task.name, "local", "envdump")
        wait_for(lambda: os.path.exists(dump) and os.path.getsize(dump) > 0, msg="env dump")
        env = dict(line.split("=", 1) for line in open(dump).read().splitlines()
                   if "=" in line)
        return ids, env
    finally:
        client.shutdown()
        server.stop()


class TestEndToEndDeviceScheduling:
    def test_task_gets_device_env(self, tmp_path):
        """Job asks for a device → scheduler assigns instances →
        task runner reserves → task process sees the reservation env."""
        ids, env = _run_device_job(tmp_path, {"mock-device": {"count": 2}}, "gpu/mock", 2)
        assert ids == ["mock-0", "mock-1"]
        assert env["MOCK_VISIBLE_DEVICES"] == "mock-0,mock-1"

    def test_cuda_task_gets_the_assigned_card(self, tmp_path, monkeypatch):
        """The cuda plugin (``{"cuda": {}}``) with ``torch.cuda`` stood in
        for two cards: the task's ``CUDA_VISIBLE_DEVICES`` is the card the
        server assigned."""
        fake_cuda(monkeypatch, [GPU_NAME, GPU_NAME])
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        ids, env = _run_device_job(tmp_path, {"cuda": {}}, f"nvidia/gpu/{GPU_NAME}", 1)
        assert len(ids) == 1 and ids[0] in ("0", "1")
        assert env["CUDA_VISIBLE_DEVICES"] == ids[0]

    def test_cuda_task_gets_the_host_card_under_a_visible_set(self, tmp_path, monkeypatch):
        """A client started with ``CUDA_VISIBLE_DEVICES=3``: its one card
        is ordinal 0 to it, and the task gets physical card 3, not 0."""
        fake_cuda(monkeypatch, [GPU_NAME])
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
        ids, env = _run_device_job(tmp_path, {"cuda": {}}, f"nvidia/gpu/{GPU_NAME}", 1)
        assert ids == ["0"]
        assert env["CUDA_VISIBLE_DEVICES"] == "3"


def _device_alloc(mock_mod, structs_mod, tg_restart):
    """An alloc whose mock task (run for 10 s) was assigned one card."""
    alloc = mock_mod.alloc()
    task = alloc.job.task_groups[0].tasks[0]
    task.driver = "mock"
    task.config = {"run_for": "10s"}
    alloc.job.task_groups[0].restart_policy = tg_restart
    alloc.allocated_resources.tasks[task.name].devices = [structs_mod.AllocatedDeviceResource(
        vendor="nvidia", type="gpu", name=GPU_NAME, device_ids=["0"])]
    return alloc


def _device_task_outcome(allocrunner_mod, mock_mod, alloc, base_dir):
    """Run ``alloc`` on a client with no device plugin; once the task has
    started or ended, return its state, failure flag, whether it holds a
    driver handle, and its event types."""
    ar = allocrunner_mod.AllocRunner(alloc, base_dir, node=mock_mod.node())
    ar.run()
    tr = ar.task_runners[alloc.job.task_groups[0].tasks[0].name]
    wait_for(lambda: any(e.type == "Started" for e in tr.events) or tr.done.is_set(),
             msg="task start")
    outcome = (tr.state.state, tr.state.failed, tr.handle is not None,
               [e.type for e in tr.events])
    ar.destroy()
    return outcome


def test_task_with_devices_fails_on_a_client_without_device_plugins(tmp_path):
    """A task assigned device instances on a client that runs no device
    plugin starts without them, as the reference's device hook does (the
    port once failed it here); no driver failure is recorded."""
    from nomad_tpu_torch.client import allocrunner
    from nomad_tpu_torch.structs import structs

    alloc = _device_alloc(mock, structs, RestartPolicy(attempts=0, mode="fail"))
    state, failed, started, events = _device_task_outcome(
        allocrunner, mock, alloc, str(tmp_path))
    assert started and not failed and state == "running"
    assert "Driver Failure" not in events


def test_task_with_devices_on_a_plugin_less_client_runs_as_in_jax(tmp_path):
    """Both packages' ``AllocRunner`` on the same device-assigned alloc, on
    a client with no device plugin: the same task state, failure flag,
    start and event types."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.client import allocrunner as jallocrunner
    from nomad_tpu_torch.client import allocrunner
    from nomad_tpu_torch.structs import structs

    alloc = _device_alloc(mock, structs, RestartPolicy(attempts=0, mode="fail"))
    ours = _device_task_outcome(allocrunner, mock, alloc, str(tmp_path / "port"))
    theirs = _device_task_outcome(jallocrunner, jmock, _to_jax(alloc), str(tmp_path / "jax"))
    assert ours == theirs
    assert ours[2] and not ours[1]


@pytest.fixture
def wire_cluster(tmp_path):
    from nomad_tpu_torch.client.servers import FailoverServerProxy, ServersManager
    from nomad_tpu_torch.rpc.endpoints import bind_server
    from nomad_tpu_torch.rpc.transport import RPCServer

    s = Server(engine_config(num_schedulers=2))
    s.start()
    rpc = RPCServer()
    bind_server(s, rpc)
    rpc.start()
    proxy = FailoverServerProxy(ServersManager([rpc.addr]))
    c = Client(proxy, ClientConfig(state_dir=str(tmp_path / "client")))
    c.start()
    yield s, c, rpc
    c.shutdown()
    proxy.close()
    rpc.stop()
    s.stop()


def test_client_over_wire_runs_job(wire_cluster):
    from nomad_tpu_torch.rpc.transport import RPCClient
    from nomad_tpu_torch.structs.structs import Evaluation

    server, client, rpc = wire_cluster
    assert server.fsm.state.node_by_id(client.node.id) is not None

    job = mock.job()
    job.type = "batch"
    job.task_groups[0].count = 1
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", "echo wire"]}
    task.restart_policy = RestartPolicy(attempts=0, mode="fail")

    # submit over the wire too
    submit = RPCClient(*rpc.addr)
    eval_id = submit.call("Job.Register", job)
    assert eval_id

    wait_for(
        lambda: any(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
        ),
        msg="job completed over the wire",
    )
    # read APIs over the wire
    allocs = submit.call("Job.Allocations", job.namespace, job.id)
    assert len(allocs) == 1 and allocs[0].client_status == ALLOC_CLIENT_COMPLETE
    ev = submit.call("Eval.GetEval", eval_id)
    assert isinstance(ev, Evaluation)
    index, config = submit.call("Operator.SchedulerGetConfiguration")
    assert config.scheduler_algorithm == "tpu_binpack"
    submit.close()


# -- 3. against the JAX package ----------------------------------------------------


def _to_jax(obj):
    """The same struct as the JAX package's, through both codecs."""
    from nomad_tpu.rpc import codec as jcodec
    from nomad_tpu_torch.rpc import encode

    return jcodec.decode(encode(obj))


def _seeded_env_inputs(seed):
    """A node, an alloc (with its job) and a task with seeded attributes,
    meta, resources, alloc index and env templates (numpy)."""
    rng = np.random.default_rng(seed)
    word = lambda: "".join(chr(int(c)) for c in rng.integers(97, 123, size=int(rng.integers(1, 8))))
    node = mock.node()
    node.datacenter = f"dc{int(rng.integers(1, 5))}"
    node.node_class = word()
    node.attributes.update({f"a.{word()}": word() for _ in range(4)})
    node.meta.update({f"m{i}": word() for i in range(3)})
    job = mock.job()
    job.meta = {f"jm{i}": word() for i in range(int(rng.integers(0, 3)))}
    tg = job.task_groups[0]
    tg.meta = {f"gm{i}": word() for i in range(int(rng.integers(0, 3)))}
    task = tg.tasks[0]
    task.meta = {f"tm{i}": word() for i in range(int(rng.integers(0, 3)))}
    task.resources.cpu = int(rng.integers(100, 4000))
    task.resources.memory_mb = int(rng.integers(64, 8192))
    refs = (["${node.unique.id}", "${node.unique.name}", "${node.datacenter}",
             "${node.class}", "${node.region}", "${env.NOMAD_ALLOC_INDEX}",
             "${env.NOMAD_CPU_LIMIT}", "${nope.x}"]
            + [f"${{attr.{k}}}" for k in node.attributes]
            + [f"${{meta.{k}}}" for k in node.meta])
    task.env = {f"V{i}": "-".join(refs[int(j)] for j in rng.choice(len(refs), size=3))
                for i in range(6)}
    alloc = mock.alloc()
    alloc.job = job
    alloc.job_id = job.id
    alloc.task_group = tg.name
    alloc.name = f"{job.id}.{tg.name}[{int(rng.integers(0, 1000))}]"
    return node, alloc, task


@pytest.mark.parametrize("seed", range(4))
def test_task_env_equals_the_jax_builder(tmp_path, seed):
    from nomad_tpu.client.allocdir import AllocDir as JaxAllocDir
    from nomad_tpu.client.taskenv import TaskEnvBuilder as JaxTaskEnvBuilder

    node, alloc, task = _seeded_env_inputs(seed)
    jnode, jalloc, jtask = _to_jax(node), _to_jax(alloc), _to_jax(task)
    td = AllocDir(str(tmp_path), alloc.id).new_task_dir(task.name)
    jtd = JaxAllocDir(str(tmp_path), alloc.id).new_task_dir(task.name)
    port = TaskEnvBuilder(node, alloc, task).set_task_dirs(td).build()
    jax_env = JaxTaskEnvBuilder(jnode, jalloc, jtask).set_task_dirs(jtd).build()
    assert port == jax_env
    assert port["NOMAD_ALLOC_INDEX"] == alloc.name.rsplit("[", 1)[1][:-1]
    assert all("${" not in v or "${nope.x}" in task.env[k] for k, v in port.items()
               if k.startswith("V"))


# fingerprint keys whose values the two packages set differently by design:
# none. Each package fingerprints the same host with the same drivers.
FINGERPRINT_DIFFERS_BY_DESIGN = ()


def test_fingerprint_equals_the_jax_fingerprint(monkeypatch):
    """Both packages fingerprint the same host view: the disk's free bytes
    and the CPU's clock, which move between two reads on a busy host, are
    read once and held for both."""
    import builtins
    import io
    import shutil

    from nomad_tpu.client.fingerprint import fingerprint_node as jfingerprint
    from nomad_tpu.structs.structs import Node as JaxNode

    from nomad_tpu_torch.client.fingerprint import fingerprint_node
    from nomad_tpu_torch.structs.structs import Node

    usage = shutil.disk_usage("/")
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage)
    with open("/proc/cpuinfo") as f:
        cpuinfo = f.read()
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open", lambda path, *a, **k: io.StringIO(cpuinfo)
                        if path == "/proc/cpuinfo" else real_open(path, *a, **k))
    port, jnode = Node(), JaxNode()
    fingerprint_node(port)
    jfingerprint(jnode)
    drop = lambda attrs: {k: v for k, v in attrs.items()
                          if k not in FINGERPRINT_DIFFERS_BY_DESIGN}
    assert drop(port.attributes) == drop(jnode.attributes)
    assert _to_jax(port.node_resources) == jnode.node_resources
    assert _to_jax(port.reserved_resources) == jnode.reserved_resources
    assert sorted(port.drivers) == sorted(jnode.drivers)
    assert {k: (d.detected, d.healthy) for k, d in port.drivers.items()} == \
        {k: (d.detected, d.healthy) for k, d in jnode.drivers.items()}
    assert port.attributes["driver.raw_exec"] == "1" and port.attributes["driver.exec"] == "1"


@pytest.mark.parametrize("seed", range(3))
def test_mock_device_reservation_env_equals_the_jax_manager(seed):
    """The env, mounts and device specs a mock-device reservation gives a
    task, for seeded plugins and seeded instance picks."""
    from nomad_tpu.client.devicemanager import DeviceManager as JaxDeviceManager
    from nomad_tpu.plugins.mock_device import MockDevicePlugin as JaxMockDevicePlugin
    from nomad_tpu.structs.structs import AllocatedDeviceResource as JaxADR

    from nomad_tpu_torch.client.devicemanager import DeviceManager
    from nomad_tpu_torch.plugins.mock_device import MockDevicePlugin
    from nomad_tpu_torch.structs.structs import AllocatedDeviceResource

    rng = np.random.default_rng(seed)
    specs = [dict(vendor=v, model=m, count=int(rng.integers(1, 9)))
             for v, m in (("nomad", "mock"), ("acme", f"m{int(rng.integers(0, 99))}"))]
    port = DeviceManager([MockDevicePlugin(**s) for s in specs])
    jax_dm = JaxDeviceManager([JaxMockDevicePlugin(**s) for s in specs])
    assert _to_jax(port.fingerprint()) == jax_dm.fingerprint()
    asks = []
    for s in specs:
        ids = [f"{s['model']}-{i}" for i in range(s["count"])]
        pick = sorted(rng.choice(ids, size=int(rng.integers(1, len(ids) + 1)), replace=False))
        asks.append((s["vendor"], s["model"], [str(i) for i in pick]))
    res = port.reserve([AllocatedDeviceResource(vendor=v, type="gpu", name=m, device_ids=ids)
                        for v, m, ids in asks])
    jres = jax_dm.reserve([JaxADR(vendor=v, type="gpu", name=m, device_ids=ids)
                           for v, m, ids in asks])
    assert res.envs == jres.envs and res.envs
    assert _to_jax(res) == jres


def _four_jobs(mock_mod, structs):
    """``test_client``'s four jobs with fixed ids: a batch echo, a failing
    batch task, a service job whose deployment the client drives healthy,
    and a service job that is stopped."""
    echo = batch_echo_job(mock_mod)
    echo.id = echo.name = "echo"
    fail = batch_echo_job(mock_mod)
    fail.id = fail.name = "fail"
    fail.task_groups[0].tasks[0].config = {"command": "/bin/sh", "args": ["-c", "exit 7"]}
    deploy = mock_mod.job()
    deploy.id = deploy.name = "deploy"
    deploy.task_groups[0].count = 2
    deploy.task_groups[0].update = structs.UpdateStrategy(max_parallel=2,
                                                          min_healthy_time_ns=int(0.2e9))
    stop = mock_mod.job()
    stop.id = stop.name = "stop"
    stop.task_groups[0].count = 1
    for job in (deploy, stop):
        job.task_groups[0].tasks[0].driver = "raw_exec"
        job.task_groups[0].tasks[0].config = {"command": "/bin/sh", "args": ["-c", "sleep 300"]}
    return echo, fail, deploy, stop


def _end_state(server_mod, client_mod, mock_mod, structs, state_dir, **server_kw):
    """Run the four jobs on one server and one client; return, per alloc,
    (job, name, client_status, task states' event types, exit codes)."""
    s = server_mod.Server(server_mod.ServerConfig(num_schedulers=2, deterministic=True,
                                                  scheduler_algorithm="binpack", **server_kw))
    s.start()
    c = client_mod.Client(client_mod.ServerProxy(s),
                          client_mod.ClientConfig(state_dir=state_dir))
    c.start()
    try:
        jobs = _four_jobs(mock_mod, structs)
        for job in jobs:
            s.register_job(job)
        st = s.fsm.state

        def allocs(job_id):
            return st.allocs_by_job("default", job_id, True)

        wait_for(lambda: [a.client_status for a in allocs("echo")] == ["complete"]
                 and [a.client_status for a in allocs("fail")] == ["failed"]
                 and (d := st.latest_deployment_by_job_id("default", "deploy")) is not None
                 and d.status == "successful"
                 and [a.client_status for a in allocs("stop")] == ["running"],
                 timeout=30, msg="four jobs at their first end state")
        s.deregister_job("default", "stop")
        wait_for(lambda: all(a.client_terminal_status() for a in allocs("stop")),
                 timeout=30, msg="stopped job terminal")
        out = []
        for job in jobs:
            for a in sorted(allocs(job.id), key=lambda a: a.name):
                out.append((job.id, a.name, a.client_status, a.desired_status, sorted(
                    (name, [e["Type"] for e in ts.events],
                     [e["Message"] for e in ts.events if e["Type"] == "Terminated"],
                     ts.state, ts.failed)
                    for name, ts in a.task_states.items())))
        return out
    finally:
        c.shutdown()
        s.stop()


def test_four_jobs_end_as_on_the_jax_client(tmp_path):
    import nomad_tpu.client as jclient
    import nomad_tpu.mock as jmock
    import nomad_tpu.server as jserver
    import nomad_tpu.structs.structs as jstructs

    import nomad_tpu_torch.client as tclient
    import nomad_tpu_torch.server as tserver
    import nomad_tpu_torch.structs.structs as tstructs

    jax_state = _end_state(jserver, jclient, jmock, jstructs, str(tmp_path / "jax"))
    port_state = _end_state(tserver, tclient, mock, tstructs, str(tmp_path / "port"),
                            device="cpu")
    assert port_state == jax_state
    by_job = {}
    for job_id, _name, status, *_ in port_state:
        by_job.setdefault(job_id, []).append(status)
    assert by_job == {"echo": ["complete"], "fail": ["failed"],
                      "deploy": ["running", "running"], "stop": ["complete"]}
    fail_events = [ev for j, *_, tasks in port_state if j == "fail" for _, _, ev, _, _ in tasks]
    assert fail_events == [["exit_code=7 signal=0"]]


def test_client_phase_jobspecs_parse():
    """chip_smoke's client-phase jobs parse with the port's jobspec: each
    limited to runner nodes, the density job spread over them, the GPU
    task asking one of the card's GPUs with its env (and none of the
    client's) on the exec driver."""
    import chip_smoke
    from nomad_tpu_torch.jobspec import parse_job

    specs = chip_smoke.client_jobs(GPU_NAME, "/usr/bin/python3", {"LD_LIBRARY_PATH": "/opt/lib"})
    jobs = {job_id: parse_job(hcl) for job_id, hcl in specs}
    assert [(j.id, j.type, j.task_groups[0].tasks[0].driver) for j in jobs.values()] == [
        ("node-agent", "system", "raw_exec"), ("c1m-density", "batch", "raw_exec"),
        ("svc-exec", "service", "exec"), ("gpu-task", "batch", "exec")]
    for j in jobs.values():
        assert [(c.ltarget, c.rtarget) for c in j.constraints] == [("${node.class}", "runner")]
    density = jobs["c1m-density"].task_groups[0]
    assert density.count == chip_smoke.CLIENTS * chip_smoke.CLIENT_ALLOCS
    assert [s.attribute for s in density.spreads] == ["${node.unique.id}"]
    gpu = jobs["gpu-task"].task_groups[0]
    task = gpu.tasks[0]
    assert [(d.name, d.count) for d in task.resources.devices] == [(f"nvidia/gpu/{GPU_NAME}", 1)]
    assert task.env == {"LD_LIBRARY_PATH": "/opt/lib",
                        "GPU_TASK_HOLD_S": str(chip_smoke.GPU_TASK_HOLD_S)}
    assert task.config["command"] == "/usr/bin/python3"
    assert task.config["args"] == ["-c", chip_smoke.GPU_TASK_SCRIPT]
    assert gpu.restart_policy.attempts == 0 and gpu.reschedule_policy.attempts == 0
