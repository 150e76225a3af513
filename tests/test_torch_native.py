"""The port's native substrate: its own build of the C++ segmented log
(``native/nomadlog/nomadlog.cpp``), the durable ``InProcRaft`` on it, and
a server that survives a restart from its data dir, and the exec driver
on the port's own build of the task executor
(``native/executor/nomad_executor.cpp``) — ports of tests/test_native.py.
Then the log against the JAX package's: a log either
package writes, the other reads, record for record; and the build: one
library however many processes ask for it at once, and a failing compiler
raises instead of leaving a half-written library behind."""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from nomad_tpu.native.log import NativeLog as JaxNativeLog

from nomad_tpu_torch import mock
from nomad_tpu_torch import native
from nomad_tpu_torch.native.log import NativeLog
from nomad_tpu_torch.server import InProcRaft, Server, ServerConfig
from nomad_tpu_torch.server.fsm import JOB_REGISTER, NODE_REGISTER, NomadFSM

REPO = Path(__file__).resolve().parent.parent


def test_native_log_roundtrip(tmp_path):
    d = str(tmp_path / "log")
    log = NativeLog(d, segment_bytes=512)
    for i in range(1, 51):
        log.append(i, f"payload-{i}".encode())
    log.sync()
    assert (log.first_index, log.last_index) == (1, 50)
    assert log.get(25) == b"payload-25"
    log.close()

    re = NativeLog(d, segment_bytes=512)
    assert (re.first_index, re.last_index) == (1, 50)
    assert re.get(50) == b"payload-50"
    re.close()


def test_native_log_truncation_survives_reopen(tmp_path):
    d = str(tmp_path / "log")
    log = NativeLog(d, segment_bytes=256)
    for i in range(1, 101):
        log.append(i, b"x" * 20)
    log.truncate_after(90)
    log.truncate_before(10)
    assert (log.first_index, log.last_index) == (10, 90)
    log.close()
    re = NativeLog(d, segment_bytes=256)
    assert (re.first_index, re.last_index) == (10, 90)
    assert re.get(5) is None and re.get(95) is None and re.get(50) is not None
    re.close()


def test_native_log_torn_write_recovery(tmp_path):
    d = str(tmp_path / "log")
    log = NativeLog(d)
    for i in range(1, 11):
        log.append(i, f"entry-{i}".encode())
    log.close()
    segs = sorted(f for f in os.listdir(d) if f.endswith(".log"))
    with open(os.path.join(d, segs[-1]), "r+b") as f:
        f.seek(-2, 2)
        f.write(b"!!")
    re = NativeLog(d)
    assert re.last_index == 9  # torn tail record dropped
    assert re.get(9) == b"entry-9"
    re.close()


def test_durable_raft_restores_state(tmp_path):
    data_dir = str(tmp_path / "raft")
    raft = InProcRaft(data_dir=data_dir)
    fsm = NomadFSM()
    peer = raft.join(fsm)
    node = mock.node()
    job = mock.job()
    raft.apply(peer, NODE_REGISTER, node)
    raft.apply(peer, JOB_REGISTER, job)
    raft.close()

    # a fresh process replays the durable log
    raft2 = InProcRaft(data_dir=data_dir)
    fsm2 = NomadFSM()
    raft2.join(fsm2)
    assert fsm2.state.node_by_id(node.id) is not None
    assert fsm2.state.job_by_id(job.namespace, job.id) is not None
    assert raft2.last_index == 2
    raft2.close()


def test_durable_raft_snapshot_compacts(tmp_path):
    data_dir = str(tmp_path / "raft")
    raft = InProcRaft(data_dir=data_dir)
    fsm = NomadFSM()
    peer = raft.join(fsm)
    nodes = [mock.node() for _ in range(5)]
    for n in nodes:
        raft.apply(peer, NODE_REGISTER, n)
    snap_index = raft.snapshot(peer)
    assert snap_index == 5
    job = mock.job()
    raft.apply(peer, JOB_REGISTER, job)
    raft.close()

    raft2 = InProcRaft(data_dir=data_dir)
    fsm2 = NomadFSM()
    raft2.join(fsm2)
    # snapshot state + post-snapshot log tail both restored
    for n in nodes:
        assert fsm2.state.node_by_id(n.id) is not None
    assert fsm2.state.job_by_id(job.namespace, job.id) is not None
    # the log itself holds only the tail
    assert raft2.store.first_index == 6
    raft2.close()


def test_server_with_data_dir_survives_restart(tmp_path):
    data_dir = str(tmp_path / "server")
    raft = InProcRaft(data_dir=data_dir)
    s = Server(
        ServerConfig(num_schedulers=2, deterministic=True, scheduler_algorithm="binpack",
                     device="cpu"),
        raft=raft,
    )
    s.start()
    try:
        for _ in range(3):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        s.register_job(job)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if len(s.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3:
                break
            time.sleep(0.05)
        allocs = s.fsm.state.allocs_by_job(job.namespace, job.id, True)
        assert len(allocs) == 3
    finally:
        s.stop()
        raft.close()

    raft2 = InProcRaft(data_dir=data_dir)
    s2 = Server(
        ServerConfig(num_schedulers=0, deterministic=True, scheduler_algorithm="binpack",
                     device="cpu"),
        raft=raft2,
    )
    try:
        # full scheduling history restored: nodes, job, allocs
        assert len(s2.fsm.state.nodes()) == 3
        assert s2.fsm.state.job_by_id(job.namespace, job.id) is not None
        assert len(s2.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3
    finally:
        s2.watch_hub.close()  # its replay notified the hub: stop the flusher
        raft2.close()


# ---------------------------------------------------------------------------
# one file format: either package reads the other's log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [
    pytest.param(NativeLog, JaxNativeLog, id="port-writes"),
    pytest.param(JaxNativeLog, NativeLog, id="jax-writes"),
])
def test_log_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    d = str(tmp_path / "log")
    payloads = {i: os.urandom(1 + (i * 37) % 300) for i in range(1, 81)}
    log = writer(d, segment_bytes=1024)
    for i, data in payloads.items():
        log.append(i, data, sync=(i % 20 == 0))
    log.truncate_before(5)
    log.truncate_after(75)
    log.sync()
    log.close()

    other = reader(d, segment_bytes=1024)
    try:
        assert (other.first_index, other.last_index) == (5, 75)
        for i in range(5, 76):
            assert other.get(i) == payloads[i], i
        assert other.get(4) is None and other.get(76) is None
        # and it appends where the writer stopped
        other.append(76, b"tail", sync=True)
    finally:
        other.close()
    again = writer(d, segment_bytes=1024)
    try:
        assert again.last_index == 76 and again.get(76) == b"tail"
    finally:
        again.close()


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


_BUILD_RACE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from nomad_tpu_torch import native
    native.BUILD_DIR = {build!r}
    print(native.ensure_built("libnomadlog.so"))
""")


def test_concurrent_processes_build_the_library_once(tmp_path):
    """Three processes ask for the library at once on a fresh build dir:
    the cross-process lock lets one compile, the others load its result,
    and all three name the same file."""
    build = str(tmp_path / "build")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACE.format(repo=str(REPO),
                                                                         build=build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    lib = os.path.join(build, "libnomadlog.so")
    assert outs == [lib] * 3
    assert sorted(os.listdir(build)) == [".lock", "libnomadlog.so"]


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native.NativeBuildError, match="native build of libnomadlog.so failed"):
        native.ensure_built("libnomadlog.so")
    assert not os.path.exists(os.path.join(str(tmp_path / "build"), "libnomadlog.so"))
    with pytest.raises(native.NativeBuildError, match="native build of nomad-executor failed"):
        native.ensure_built("nomad-executor")
    assert sorted(os.listdir(str(tmp_path / "build"))) == [".lock"]
    with pytest.raises(native.NativeBuildError, match="unknown native target"):
        native.ensure_built("no-such-target")


# -- the exec driver on the port's nomad-executor ------------------------------


def test_exec_driver_runs_through_native_executor(tmp_path):
    from nomad_tpu_torch.client.allocdir import AllocDir
    from nomad_tpu_torch.client.drivers.base import TaskConfig, new_driver

    ad = AllocDir(str(tmp_path), "alloc1")
    ad.build()
    td = ad.new_task_dir("t")
    td.build()
    os.makedirs(td.log_dir, exist_ok=True)
    d = new_driver("exec")
    cfg = TaskConfig(
        id="t1", name="t",
        config={"command": "/bin/sh", "args": ["-c", "echo exec-$MARK"]},
        env={"MARK": "native", "PATH": "/usr/bin:/bin"},
        task_dir=td,
        stdout_path=os.path.join(td.log_dir, "t.stdout.0"),
    )
    handle = d.start_task(cfg)
    assert handle.driver_state["pid"] > 0
    res = d.wait_task("t1", timeout=10.0)
    assert res is not None and res.exit_code == 0
    with open(cfg.stdout_path) as f:
        assert f.read().strip() == "exec-native"
    d.destroy_task("t1")


def test_exec_driver_kill_escalation(tmp_path):
    from nomad_tpu_torch.client.allocdir import AllocDir
    from nomad_tpu_torch.client.drivers.base import TaskConfig, new_driver

    ad = AllocDir(str(tmp_path), "alloc2")
    ad.build()
    td = ad.new_task_dir("t")
    td.build()
    d = new_driver("exec")
    cfg = TaskConfig(
        id="t1", name="t",
        config={"command": "/bin/sh", "args": ["-c", "trap '' TERM; sleep 60"],
                "kill_timeout": 0.5},
        env={"PATH": "/usr/bin:/bin"},
        task_dir=td,
    )
    d.start_task(cfg)
    time.sleep(0.3)
    start = time.monotonic()
    d.stop_task("t1", timeout_s=1.0)
    res = d.wait_task("t1", timeout=10.0)
    assert time.monotonic() - start < 10.0
    assert res is not None and res.signal == 9  # escalated by the executor


def test_exec_driver_survives_client_restart(tmp_path):
    """The executor supervises independently: 'restart' the driver and
    recover the still-running task by pid."""
    from nomad_tpu_torch.client.allocdir import AllocDir
    from nomad_tpu_torch.client.drivers.base import TaskConfig, new_driver

    ad = AllocDir(str(tmp_path), "alloc3")
    ad.build()
    td = ad.new_task_dir("t")
    td.build()
    d = new_driver("exec")
    cfg = TaskConfig(
        id="t1", name="t",
        config={"command": "/bin/sleep", "args": ["60"]},
        env={"PATH": "/usr/bin:/bin"},
        task_dir=td,
    )
    handle = d.start_task(cfg)
    time.sleep(0.2)

    d2 = new_driver("exec")  # fresh driver instance = restarted client
    d2.recover_task(handle)
    status = d2.inspect_task("t1")
    assert status.state == "running"
    os.kill(handle.driver_state["pid"], 15)  # terminate the executor
    res = d2.wait_task("t1", timeout=10.0)
    assert res is not None


def test_executor_is_built_into_the_ports_build_dir():
    """``ensure_built("nomad-executor")`` compiles the unedited top-level
    source into the port's git-ignored ``_build/`` and returns a program
    that runs; a second call returns the same file without a build."""
    path = native.ensure_built("nomad-executor")
    assert path == os.path.join(native.BUILD_DIR, "nomad-executor")
    assert os.access(path, os.X_OK)
    assert native.SOURCES["nomad-executor"] == str(REPO / "native" / "executor" /
                                                   "nomad_executor.cpp")
    mtime = os.path.getmtime(path)
    assert native.ensure_built("nomad-executor") == path and os.path.getmtime(path) == mtime
    out = subprocess.run([path], capture_output=True, text=True, timeout=30)
    assert out.returncode != 0 and "--status-file" in out.stderr
