"""The port stands alone: no JAX and nothing of nomad_tpu, and no silent
move to the CPU when CUDA is asked for. Its threaded code passes the
repo's lock and shared-state lint rules with an empty baseline."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "nomad_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "nomad_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_static_imports(path):
    """No ``import jax`` and no import of ``nomad_tpu`` anywhere in the
    port's package or chip_smoke.py (module level or inside functions)."""
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: {bad}"


def test_msgpack_only_inside_functions():
    """No module of the port imports ``msgpack``, at module level or
    inside a function: the wire codec packs and unpacks the msgpack
    format with the port's own ``rpc/wirefmt.py``."""
    bad = []
    for path in PORT_FILES:
        for sub in ast.walk(ast.parse(path.read_text())):
            if isinstance(sub, ast.Import) and any(
                    a.name.split(".")[0] == "msgpack" for a in sub.names):
                bad.append((str(path.relative_to(REPO)), sub.lineno))
            elif isinstance(sub, ast.ImportFrom) and (sub.module or "").split(".")[0] == "msgpack":
                bad.append((str(path.relative_to(REPO)), sub.lineno))
    assert not bad, bad


def _module_exists(dotted: str) -> bool:
    """Whether the port has module or package ``dotted`` (a file or a
    directory with ``__init__.py`` under the repo root)."""
    base = REPO.joinpath(*dotted.split("."))
    return base.with_suffix(".py").is_file() or (base / "__init__.py").is_file()


def _top_level_names(path: Path) -> set:
    """Names a module binds at its top level (assignments, defs, classes,
    imports), for ``from package import name``; with a PEP 562
    ``__getattr__``, also the keys of its ``_LAZY`` table whose module
    exists (``chaos/__init__.py``)."""
    names = set()
    body = ast.parse(path.read_text()).body
    if any(isinstance(n, ast.FunctionDef) and n.name == "__getattr__" for n in body):
        package = ".".join(path.relative_to(REPO).parent.parts)
        for node in body:
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                    and any(isinstance(t, ast.Name) and t.id == "_LAZY" for t in node.targets)):
                for key, value in zip(node.value.keys, node.value.values):
                    module = ast.literal_eval(value)[0]
                    if _module_exists(f"{package}.{module}"):
                        names.add(ast.literal_eval(key))
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    return names


def _missing_port_imports(path: Path) -> list:
    """Every import in ``path`` (module level or inside a function) of a
    port module that does not exist: relative imports resolved against
    the file's package, and absolute ``nomad_tpu_torch`` ones."""
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1]) if rel.name != "__init__" else list(rel.parts[:-1])
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        targets = []
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - (node.level - 1)] if node.level > 1 else package
                module = ".".join(base + ([node.module] if node.module else []))
            else:
                module = node.module or ""
            if module.split(".")[0] != "nomad_tpu_torch":
                continue
            if not _module_exists(module):
                bad.append((node.lineno, module))
                continue
            init = REPO.joinpath(*module.split("."), "__init__.py")
            for alias in node.names:
                if alias.name == "*" or not init.is_file():
                    continue
                sub = f"{module}.{alias.name}"
                if not _module_exists(sub) and alias.name not in _top_level_names(init):
                    bad.append((node.lineno, sub))
        elif isinstance(node, ast.Import):
            targets = [a.name for a in node.names if a.name.split(".")[0] == "nomad_tpu_torch"]
            bad += [(node.lineno, t) for t in targets if not _module_exists(t)]
    return bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_imports_of_port_modules_resolve(path):
    """Every import of a port module, at module level or inside a
    function, names a module the port has: an entry point must not raise
    ``ModuleNotFoundError`` for a module the port never copied (as
    ``Server.plan_job`` did for ``structs.diff``)."""
    assert not _missing_port_imports(path), f"{path}: {_missing_port_imports(path)}"


def test_missing_import_check_finds_a_missing_module(tmp_path, monkeypatch):
    """The check above on a module that imports, inside a function, one
    port module that exists and one that does not."""
    pkg = REPO / "nomad_tpu_torch" / "server"
    src = ("def f():\n    from ..structs.structs import Job\n"
           "    from ..structs.no_such_module import x\n    from . import plan_apply\n")
    probe = pkg / "_probe_missing_import.py"
    probe.write_text(src)
    try:
        assert _missing_port_imports(probe) == [(3, "nomad_tpu_torch.structs.no_such_module")]
    finally:
        probe.unlink()


def _logger_name_prefix(call: ast.Call):
    """The literal start of a ``getLogger`` call's name: the string, or
    the leading text of an f-string; None when the name is not literal."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if (isinstance(arg, ast.JoinedStr) and arg.values and isinstance(arg.values[0], ast.Constant)):
        return arg.values[0].value
    return None


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_loggers_in_the_port_namespace(path):
    """Every ``logging.getLogger`` of the port (and chip_smoke.py) names a
    logger under ``nomad_tpu_torch``, so that in a process that holds both
    packages the port's records never land in the reference's loggers."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "getLogger"):
            name = _logger_name_prefix(node)
            if name is None or not (name == "nomad_tpu_torch"
                                    or name.startswith("nomad_tpu_torch.")):
                bad.append((node.lineno, name))
    assert not bad, f"{path}: loggers outside nomad_tpu_torch at (line, name) {bad}"


_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs.structs import Evaluation, SchedulerConfiguration
    from nomad_tpu_torch.utils import metrics

    calls = []
    orig = metrics.incr_counter
    metrics.incr_counter = lambda n, v=1.0: (calls.append(n), orig(n, v))
    h = Harness(device="cpu")
    h.state.scheduler_set_config(h.next_index(), SchedulerConfiguration())
    for i in range(12):
        n = mock.node()
        n.id = "node-%d" % i
        n.name = "node-%d" % i
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    job.task_groups[0].count = 5
    h.state.upsert_job(h.next_index(), job)
    h.process("service", Evaluation(priority=50, type="service",
              triggered_by="job-register", job_id=job.id, namespace=job.namespace))
    placed = sum(len(v) for p in h.plans for v in p.node_allocation.values())
    assert placed == 5, placed
    assert "nomad.tpu_engine.handled" in calls, calls
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("ISOLATED-OK")
""")


def test_port_runs_with_jax_and_nomad_tpu_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED-OK" in out.stdout


_BLOCKED_SYSTEM_RUN = _BLOCKED_RUN.split("h = Harness(device=\"cpu\")")[0] + textwrap.dedent("""
    from nomad_tpu_torch.structs.structs import Constraint, PreemptionConfig
    from nomad_tpu_torch.tpu import kernels

    seen = []
    orig_scan, orig_forced = kernels.place_scan_batched_packed, kernels.forced_eval_packed

    def scan(packed, cs=None):
        seen.append(("place_scan", packed.dims["C"]))
        return orig_scan(packed, cs)

    def forced(packed):
        seen.append(("forced_eval", 0))
        return orig_forced(packed)

    kernels.place_scan_batched_packed, kernels.forced_eval_packed = scan, forced
    h = Harness(device="cpu")
    h.state.scheduler_set_config(h.next_index(), SchedulerConfiguration(
        preemption_config=PreemptionConfig(system_scheduler_enabled=True,
                                           service_scheduler_enabled=True)))
    for i in range(6):
        n = mock.node()
        n.id = "node-%d" % i
        n.node_resources.cpu_shares = 2000
        n.node_resources.memory_mb = 4096
        n.attributes["rack"] = "r1" if i < 3 else "r2"
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)

    def run(job, kind, rack=None):
        if rack:
            job.constraints.append(Constraint(ltarget="${{attr.rack}}", rtarget=rack, operand="="))
        job.task_groups[0].tasks[0].resources.networks = []
        h.state.upsert_job(h.next_index(), job)
        h.process(kind, Evaluation(priority=job.priority, type=kind,
                  triggered_by="job-register", job_id=job.id, namespace=job.namespace))

    low = mock.job()
    low.priority = 20
    low.task_groups[0].count = 6
    low.task_groups[0].tasks[0].resources.cpu = 1500
    run(low, "service")
    sysjob = mock.system_job()
    sysjob.task_groups[0].tasks[0].resources.cpu = 700
    run(sysjob, "system", "r1")
    high = mock.job()
    high.priority = 70
    high.task_groups[0].count = 2
    high.task_groups[0].tasks[0].resources.cpu = 1200
    run(high, "service", "r2")
    victims = [sum(len(v) for v in p.node_preemptions.values()) for p in h.plans]
    assert victims[1] > 0 and victims[2] > 0, victims
    assert ("forced_eval", 0) in seen, seen
    assert sum(1 for name, c in seen if name == "place_scan" and c > 0) >= 2, seen
    assert calls.count("nomad.tpu_engine.handled") == 3, calls
    assert "nomad.tpu_engine.fallback" not in calls, calls
    assert not any("unported" in c for c in calls), calls
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("SYSTEM-ISOLATED-OK")
""")


def test_system_and_preempting_evals_run_with_jax_and_nomad_tpu_blocked():
    """A system eval (the forced-node kernel, then its preempt pass) and
    a preempting service eval (the scan's has_pre branch), through the
    port's Harness on the CPU, in a process where importing jax or
    anything of nomad_tpu fails."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SYSTEM_RUN.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SYSTEM-ISOLATED-OK" in out.stdout


_BLOCKED_CHUNK_RUN = _BLOCKED_RUN.split("h = Harness(device=\"cpu\")")[0] + textwrap.dedent("""
    from nomad_tpu_torch.tpu import kernels

    seen = []
    orig_chunk = kernels.chunk_scan

    def chunk_scan(*args, **kwargs):
        seen.append(kwargs.get("chunk"))
        return orig_chunk(*args, **kwargs)

    kernels.chunk_scan = chunk_scan
    h = Harness(device="cpu")
    h.state.scheduler_set_config(h.next_index(), SchedulerConfiguration(
        scheduler_algorithm="tpu_binpack_chunked", parity_sample_rate=1.0))
    for i in range(12):
        n = mock.node()
        n.id = "node-%d" % i
        n.name = "node-%d" % i
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    job.task_groups[0].count = 9
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), job)
    h.process("service", Evaluation(priority=50, type="service",
              triggered_by="job-register", job_id=job.id, namespace=job.namespace),
              deterministic=False)
    placed = sum(len(v) for p in h.plans for v in p.node_allocation.values())
    assert placed == 9, placed
    assert seen, "the chunk scan never ran"
    assert calls.count("nomad.tpu_engine.chunk_dispatch") == 1, calls
    assert calls.count("nomad.tpu_engine.parity_sampled") == 1, calls
    assert "nomad.tpu_engine.chunk_fallback" not in calls, calls
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("CHUNK-ISOLATED-OK")
""")


def test_chunked_eval_runs_with_jax_and_nomad_tpu_blocked():
    """A float eval under tpu_binpack_chunked (the chunk scan, then the
    sampled-parity reference scan at rate 1) through the port's Harness
    on the CPU, in a process where importing jax or anything of
    nomad_tpu fails."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHUNK_RUN.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CHUNK-ISOLATED-OK" in out.stdout


def test_default_device_without_cuda_raises(monkeypatch):
    """Entry points default to CUDA; with none present they raise rather
    than place on the host."""
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.tpu import convert
    from nomad_tpu_torch.tpu.engine import TorchPlacementEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Harness()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchPlacementEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        convert.to_torch([np_zero()])


def np_zero():
    import numpy as np

    return np.zeros(3, np.int32)


def test_scheduler_on_cuda_without_cuda_raises(monkeypatch):
    """A scheduler told to run on CUDA raises out of process() when the
    card is missing, and places nothing."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs.structs import Evaluation, SchedulerConfiguration

    h = Harness(device="cpu")
    h.state.scheduler_set_config(h.next_index(), SchedulerConfiguration())
    for i in range(4):
        n = mock.node()
        n.id = f"n{i}"
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        h.process("service", Evaluation(priority=50, type="service",
                                        triggered_by="job-register",
                                        job_id=job.id, namespace=job.namespace))
    assert not h.plans


_BLOCKED_SERVER_RUN = textwrap.dedent("""
    import importlib.abc, sys, time
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig

    placed = {{}}
    for deterministic in (False, True):
        srv = Server(ServerConfig(device="cpu", deterministic=deterministic,
                                  device_min_placements=0))
        try:
            srv.start()
            for i in range(8):
                srv.register_node(mock.node())
            job = mock.job()
            job.task_groups[0].count = 6
            srv.register_job(job)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                live = [a for a in srv.fsm.state.allocs_by_job(job.namespace, job.id, True)
                        if a.desired_status == "run"]
                if len(live) == 6:
                    break
                time.sleep(0.02)
            placed[deterministic] = len(live)
            assert srv.device_batcher.stats["evals"] >= 1
        finally:
            srv.stop()
    assert placed == {{False: 6, True: 6}}, placed
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("SERVER-ISOLATED-OK")
""")


def test_port_server_runs_with_jax_and_nomad_tpu_blocked():
    """The server slice, both arms, in a process where importing jax or
    anything of nomad_tpu fails."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SERVER_RUN.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SERVER-ISOLATED-OK" in out.stdout


_BLOCKED_CHURN_RUN = textwrap.dedent("""
    import importlib.abc, sys, threading
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["msgpack"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})

    import nomad_tpu_torch.chaos.replay
    from nomad_tpu_torch import chaos
    from nomad_tpu_torch.analysis import lock_order, shared_state
    from nomad_tpu_torch.chaos import ChurnReplay, SLOGate, SLOThresholds, generate_trace
    from nomad_tpu_torch.rpc import RPCError, transport
    from nomad_tpu_torch.server import ServerConfig
    from nomad_tpu_torch.trace import attribution, stitch

    trace = generate_trace(seed=7, duration_s=2.0, n_nodes=8, n_jobs=3, tg_count=3,
                           n_drains=1, n_expiries=1, n_hipri=1, n_fault_windows=1,
                           leader_kill=True)
    replay = ChurnReplay(seed=7, trace=trace, n_servers=2, n_nodes=8,
                         config=ServerConfig(device="cpu", num_schedulers=2,
                                             heartbeat_min_ttl=1.2, heartbeat_max_ttl=2.0,
                                             eval_gc_interval=3600.0, device_min_placements=0),
                         settle_timeout_s=25.0)
    result = replay.run()
    inv = result["invariants"]
    assert inv["lost"] == inv["duplicated"] == inv["orphaned"] == 0 and inv["converged"], inv
    assert result["leader_kills"] == 1, result["leader_kills"]
    assert chaos.active() is None
    assert sum(s.device_batcher.stats_snapshot()["dispatches"] for s in replay.servers) > 0
    assert SLOGate(SLOThresholds(eval_ms_p99_max=None, slowest_inflight_ms_max=None,
                                 throughput_min_allocs_per_s=None)).evaluate(result)["passed"]
    assert result["bottleneck_report"]["entries"], result["bottleneck_report"]
    assert lock_order.build_static_graph() and shared_state.build_static_shared()
    assert not any(t.name.startswith("chaos-") and t.is_alive() for t in threading.enumerate())
    assert sys.modules.get("msgpack") is None
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("CHURN-ISOLATED-OK")
""")


def test_churn_replay_runs_with_jax_nomad_tpu_and_msgpack_blocked():
    """The churn modules import, and a tiny ChurnReplay (two servers on
    the CPU, a leader kill, every eval through a batcher) runs, in a
    process where importing jax, anything of nomad_tpu, or msgpack
    fails: the in-process replay never touches the wire codec."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHURN_RUN.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "CHURN-ISOLATED-OK" in out.stdout


_BLOCKED_CRASH_SERVER = textwrap.dedent("""
    import importlib.abc, os, signal, sys, threading, time
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["msgpack"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.chaos import crash_server
    from nomad_tpu_torch.rpc import RPCClient, RPCError

    port = {port}
    out = {{}}

    def drive():
        try:
            c = RPCClient("127.0.0.1", port, timeout=10.0)
            deadline = time.monotonic() + 60
            while True:
                try:
                    if c.call("Status.ping", no_forward=True, timeout=1.0) == "pong":
                        break
                except (RPCError, OSError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            while c.call("Operator.RaftStats", no_forward=True)["state"] != "leader":
                if time.monotonic() > deadline:
                    raise AssertionError("no leader")
                time.sleep(0.05)
            node = mock.node()
            assert c.call("Node.Register", node) > 0
            got = c.call("Node.GetNode", node.id)
            assert got.id == node.id and got.name == node.name, got
            out["ok"] = True
            c.close()
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=drive, daemon=True).start()
    rc = crash_server.main(["--node-id", "s0", "--rpc-port", str(port),
                            "--data-dir", {data_dir!r}, "--device", "cpu"])
    assert rc == 0 and out.get("ok"), out
    assert sys.modules.get("msgpack") is None
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("CRASH-SERVER-ISOLATED-OK")
""")


def test_crash_server_serves_the_wire_with_jax_nomad_tpu_and_msgpack_blocked(tmp_path):
    """One ``crash_server --device cpu`` (wire raft on its durable native
    log, the RPC endpoints) boots, elects itself and takes a node
    registration over the wire, in a process where importing jax,
    anything of nomad_tpu, or msgpack fails."""
    from nomad_tpu_torch.chaos.crash import _free_port

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_CRASH_SERVER.format(repo=str(REPO), port=_free_port(),
                                        data_dir=str(tmp_path / "s0"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "CRASH-SERVER-ISOLATED-OK" in out.stdout


_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["msgpack"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})
""")

_BLOCKED_DEVICE_RUN = _BLOCKER + textwrap.dedent("""
    import torch

    import chip_smoke
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client.devicemanager import DeviceManager
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.plugins.cuda_device import CUDADevicePlugin
    from nomad_tpu_torch.plugins.device import ExternalDevicePlugin
    from nomad_tpu_torch.plugins.launch import plugin_env
    from nomad_tpu_torch.plugins.transport import spawn_plugin
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs.structs import Evaluation, SchedulerConfiguration
    from nomad_tpu_torch.utils import metrics

    NAME = "NVIDIA H100 80GB HBM3"
    real = (torch.cuda.is_available, torch.cuda.device_count, torch.cuda.get_device_name)

    def card(on):
        torch.cuda.is_available, torch.cuda.device_count, torch.cuda.get_device_name = (
            (lambda: True, lambda: 1, lambda i=0: NAME) if on else real)

    # the plugin subprocess runs with the same imports blocked
    child = {child!r} + "import runpy; runpy.run_module('nomad_tpu_torch.plugins.launch', " \\
        "run_name='__main__', alter_sys=True)"
    ext = ExternalDevicePlugin("mock-device", spawn_plugin(
        [sys.executable, "-c", child, "device", "nomad_tpu_torch.plugins.mock_device:plugin"],
        env=plugin_env()))
    ext.client.call("set_config", {{"vendor": "nvidia", "model": NAME, "count": 4}}, timeout=10)
    remote = DeviceManager([ext], fingerprint_interval=0)
    groups = remote.fingerprint()
    assert [(g.vendor, g.type, g.name, len(g.instances)) for g in groups] == [
        ("nvidia", "gpu", NAME, 4)], groups
    from nomad_tpu_torch.structs.structs import AllocatedDeviceResource
    env = remote.reserve([AllocatedDeviceResource(vendor="nvidia", type="gpu", name=NAME,
                                                  device_ids=[NAME + "-3"])]).envs
    assert env == {{"MOCK_VISIBLE_DEVICES": NAME + "-3"}}, env
    remote.stop()

    card(True)
    nodes, managers = chip_smoke.gpu_fleet(mock, 8, 0, CUDADevicePlugin(), NAME)
    card(False)
    calls = []
    orig = metrics.incr_counter
    metrics.incr_counter = lambda n, v=1.0: (calls.append(n), orig(n, v))
    h = Harness(device="cpu")
    h.state.scheduler_set_config(h.next_index(), SchedulerConfiguration())
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    jobs = chip_smoke.gpu_jobs(NAME, {{"gpu1": (1, 6, 1, 0), "mixed": (1, 2, 1, 1)}})
    placed = {{}}
    for job_id, hcl in jobs:
        job = parse_job(hcl)
        h.state.upsert_job(h.next_index(), job)
        n_plans = len(h.plans)
        h.process(job.type, Evaluation(priority=job.priority, type=job.type,
                  triggered_by="job-register", job_id=job.id, namespace=job.namespace))
        placed[job_id] = [a for v in h.plans[n_plans].node_allocation.values() for a in v]
    assert [len(placed[j]) for j, _ in jobs] == [8, 6, 2], placed
    assert calls.count("nomad.tpu_engine.handled") == 3, calls
    assert "nomad.tpu_engine.fallback" not in calls, calls
    on_card = [a for a in placed["gpu-system"] if a.node_id == nodes[0].id]
    devices = [d for t in on_card[0].allocated_resources.tasks.values() for d in t.devices]
    card(True)
    env = managers[0].reserve(devices).envs
    card(False)
    assert env == {{"CUDA_VISIBLE_DEVICES": "0"}}, env
    fpga = {{n.id for n in nodes if any(d.type == "fpga" for d in n.node_resources.devices)}}
    assert all(a.node_id in fpga for a in placed["mixed-0"])
    assert sys.modules.get("msgpack") is None and sys.modules.get("jax") is None
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    print("DEVICES-ISOLATED-OK")
""")


def test_device_path_runs_with_jax_nomad_tpu_and_msgpack_blocked():
    """The device path in a process where importing jax, anything of
    nomad_tpu, or msgpack fails: a mock GPU plugin behind the subprocess
    transport (its process blocked alike) fingerprints and reserves; the
    fleet's nodes are fingerprinted by device managers (node 0 by the
    cuda plugin, ``torch.cuda`` stood in for one card); a system GPU job,
    a GPU job (D = 5) and a GPU + FPGA job (D = 6) parsed from HCL are
    placed by the engine; node 0's card is reserved as
    CUDA_VISIBLE_DEVICES=0."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_DEVICE_RUN.format(repo=str(REPO),
                                      child=_BLOCKER.format(repo=str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "DEVICES-ISOLATED-OK" in out.stdout


_BLOCKED_CLIENT_RUN = _BLOCKER + textwrap.dedent("""
    import os, tempfile, time

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import Client, ClientConfig, ServerProxy
    from nomad_tpu_torch.client.drivers import available_drivers
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs.structs import RestartPolicy

    assert available_drivers() == ["docker", "exec", "java", "mock", "qemu", "raw_exec"]
    srv = Server(ServerConfig(device="cpu", deterministic=True, device_min_placements=0))
    state_dir = tempfile.mkdtemp(prefix="blocked-client-")
    client = Client(ServerProxy(srv), ClientConfig(state_dir=state_dir, node_class="runner",
                                                   persist_state=True))
    jobs = []
    for driver, count in (("raw_exec", 3), ("exec", 2)):
        job = mock.job()
        job.type = "batch"
        job.task_groups[0].count = count
        task = job.task_groups[0].tasks[0]
        task.driver = driver
        task.config = {{"command": "/bin/sh",
                        "args": ["-c", "echo $NOMAD_ALLOC_INDEX > $NOMAD_TASK_DIR/index"]}}
        task.restart_policy = RestartPolicy(attempts=0, mode="fail")
        jobs.append(job)
    try:
        srv.start()
        client.start()
        for job in jobs:
            srv.register_job(job)
        deadline = time.monotonic() + 60
        def done():
            return [a.client_status for j in jobs
                    for a in srv.fsm.state.allocs_by_job(j.namespace, j.id, True)]
        while time.monotonic() < deadline and done() != ["complete"] * 5:
            time.sleep(0.05)
        assert done() == ["complete"] * 5, done()
        for j in jobs:
            for a in srv.fsm.state.allocs_by_job(j.namespace, j.id, True):
                task = j.task_groups[0].tasks[0].name
                path = os.path.join(client.alloc_dir_base, a.id, task, "local", "index")
                assert open(path).read().strip() == str(a.index()), (path, a.name)
        assert srv.device_batcher.stats["evals"] >= 1
    finally:
        client.shutdown()
        srv.stop()
    assert sys.modules.get("msgpack") is None
    assert not any(m == "nomad_tpu" or m.startswith("nomad_tpu.") for m in sys.modules)
    assert sys.modules.get("jax") is None
    print("CLIENT-ISOLATED-OK")
""")


def test_client_runs_jobs_with_jax_nomad_tpu_and_msgpack_blocked():
    """The client runtime in a process where importing jax, anything of
    nomad_tpu, or msgpack fails: a port server (engine on the CPU, int
    arm) and a port client with its SQLite state DB run a raw_exec batch
    job and an exec batch job (through the port's nomad-executor) to
    ``complete``, each task writing its alloc index."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLIENT_RUN.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "CLIENT-ISOLATED-OK" in out.stdout


def test_server_default_config_without_cuda_raises(monkeypatch):
    """``Server(ServerConfig())`` asks for CUDA: without a card it raises
    before starting anything, rather than carrying on on the CPU."""
    import threading

    from nomad_tpu_torch.server import Server, ServerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="cuda"):
        Server(ServerConfig())
    assert threading.active_count() == before


def test_batcher_on_cuda_without_cuda_raises(monkeypatch):
    from nomad_tpu_torch.tpu.batcher import DeviceBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceBatcher()


_BLOCKED_LINT = _BLOCKER + textwrap.dedent("""
    import runpy
    sys.argv = ["nomad_tpu_torch.analysis"] + {argv!r}
    code = 0
    try:
        runpy.run_module("nomad_tpu_torch.analysis", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code or 0
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "msgpack", "nomad_tpu")
                    and sys.modules[m] is not None)
    print("IMPORTED-FORBIDDEN", leaked, flush=True)
    sys.exit(code)
""")


def test_port_threaded_code_passes_the_lock_and_state_lint():
    """The port's own nomad-lint (``python -m nomad_tpu_torch.analysis``)
    with all thirteen rules over the whole port, with the wire modules
    (wire raft, the RPC endpoints, the crash and serve harnesses), in a
    process where importing jax, anything of nomad_tpu, or msgpack fails.
    Against an empty baseline: a finding is fixed in the port, never
    baselined."""
    baseline = Path(__file__).resolve().parent / "torch_lint_baseline.json"
    assert baseline.read_text().strip() == "[]"
    assert (REPO / "nomad_tpu_torch" / "analysis" / "baseline.json").read_text().strip() == "[]"
    from nomad_tpu_torch.analysis import default_checkers

    rules = [c.rule for c in default_checkers()]
    assert len(rules) == 13
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    argv = ["nomad_tpu_torch", "--rule", ",".join(rules), "--baseline", str(baseline)]
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_LINT.format(repo=str(REPO), argv=argv)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED-FORBIDDEN []" in out.stdout, out.stdout
    for module in ("server/wire_raft.py", "rpc/endpoints.py", "chaos/crash.py",
                   "chaos/crash_server.py", "watch/serve.py", "watch/blocking.py"):
        assert (REPO / "nomad_tpu_torch" / module).is_file(), module


_BLOCKED_SHARDED_RUN = _BLOCKER + textwrap.dedent("""
    import threading
    import numpy as np
    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.tpu.batcher import DeviceBatcher
    from nomad_tpu_torch.tpu.engine import EncodedEval, TorchPlacementEngine, example_scan_inputs

    def enc(seed):
        n_pad, static, carry, xs = example_scan_inputs(
            n_nodes=48, n_tgs=2, n_placements=6, n_spreads=1, seed=seed, dtype=np.int32)
        return EncodedEval(n_real=48, n_pad=n_pad, g=2, s=static[9].shape[1],
                           v=static[10].shape[2], p=6, dtype=np.int32, static=static,
                           carry=carry, xs=xs, missing_list=[], nodes=[], table=None,
                           start_ns=0)

    encs = [enc(s) for s in (1, 2, 3)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    b = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu",
                      mesh=make_mesh(4, eval_parallel=4, devices=["cpu"] * 4))
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, b.run(encs[i])))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    b.stop()
    assert b.stats_snapshot()["device_dispatches"] == dict(cpu=3), b.stats
    for single, got in zip(singles, out):
        for x, y in zip(single, got):
            assert np.array_equal(x, y)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "msgpack", "nomad_tpu") and sys.modules[m] is not None)
    assert not leaked, leaked
    print("SHARDED-ISOLATED-OK", flush=True)
""")


def test_sharded_batch_runs_with_jax_nomad_tpu_and_msgpack_blocked():
    """An eval-sharded ``DeviceBatcher`` batch over a mesh of four CPU
    entries, in a process where importing jax, anything of nomad_tpu, or
    msgpack fails: three shard launches, each eval's result its single
    scan's."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SHARDED_RUN.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "SHARDED-ISOLATED-OK" in out.stdout


_BLOCKED_NODES_RUN = _BLOCKER + textwrap.dedent("""
    import threading
    import numpy as np
    from nomad_tpu_torch.parallel import batched_place_scan, make_mesh
    from nomad_tpu_torch.tpu import kernels
    from nomad_tpu_torch.tpu.batcher import DeviceBatcher
    from nomad_tpu_torch.tpu.engine import (EncodedEval, TorchPlacementEngine,
                                            example_scan_inputs, example_scan_variant)

    def enc(n_pad, static, carry, xs, n):
        return EncodedEval(n_real=n, n_pad=n_pad, g=static[2].shape[0],
                           s=static[9].shape[1], v=static[10].shape[2], p=xs[0].shape[0],
                           dtype=np.int32, static=static, carry=carry, xs=xs, missing_list=[],
                           nodes=[], table=None, start_ns=0)

    phases = []
    orig = kernels.place_scan_nodes_phase
    def spy(sh, phase, p):
        phases.append(sh.nodes)
        return orig(sh, phase, p)
    kernels.place_scan_nodes_phase = spy
    encs = [enc(*example_scan_inputs(n_nodes=48, n_tgs=2, n_placements=6, n_spreads=1,
                                     seed=s, dtype=np.int32), 48) for s in (1, 2, 3)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    b = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu",
                      mesh=make_mesh(4, eval_parallel=2, devices=["cpu"] * 4))
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, b.run(encs[i])))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    b.stop()
    assert b.stats_snapshot()["device_dispatches"] == dict(cpu=4), b.stats
    assert phases and set(phases) == {{2}}, phases
    for single, got in zip(singles, out):
        for x, y in zip(single, got):
            assert np.array_equal(x, y)
    pre = enc(*example_scan_variant("preempt", n_nodes=40, n_tgs=3, n_placements=8, seed=2), 40)
    single = TorchPlacementEngine.shared("cpu").run_scan_single(pre)
    got = batched_place_scan(make_mesh(2, eval_parallel=1, devices=["cpu"] * 2))([pre])
    assert (single[4] >= 0).any()
    for x, y in zip(single, got):
        assert np.array_equal(x, y[0, :pre.p])
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "msgpack", "nomad_tpu") and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NODES-ISOLATED-OK", flush=True)
""")


def test_node_sharded_batch_runs_with_jax_nomad_tpu_and_msgpack_blocked():
    """A node-sharded ``DeviceBatcher`` batch over a (2, 2) mesh of CPU
    entries and a preempting eval over (1, 2), in a process where
    importing jax, anything of nomad_tpu, or msgpack fails: the node
    shards' phases run (``tpu/node_shard.py`` through
    ``kernels.place_scan_nodes_phase``) and each eval's result is its
    single scan's."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_NODES_RUN.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "NODES-ISOLATED-OK" in out.stdout


_BLOCKED_CLI = _BLOCKER + textwrap.dedent("""
    import runpy
    sys.argv = ["nomad_tpu_torch.cli"] + {argv!r}
    code = 0
    try:
        runpy.run_module("nomad_tpu_torch.cli", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        code = e.code or 0
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "msgpack", "nomad_tpu", "cryptography")
                    and sys.modules[m] is not None)
    print("IMPORTED-FORBIDDEN", leaked, flush=True)
    sys.exit(code)
""")

_ISOLATED_JOB = """
job "iso" {
  datacenters = ["dc1"]
  type = "batch"
  group "g" {
    task "t" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args = ["-c", "echo isolated-$NOMAD_ALLOC_INDEX"]
      }
      resources {
        cpu = 100
        memory = 64
      }
    }
  }
}
"""


def _blocked_cli(argv, **kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_CLI.format(repo=str(REPO), argv=list(argv))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO), **kw)


def test_agent_and_cli_run_a_job_with_jax_nomad_tpu_and_msgpack_blocked(tmp_path):
    """``python -m nomad_tpu_torch.cli agent -dev -device cpu`` in a process
    where importing jax, anything of nomad_tpu, or msgpack fails; the
    port's CLI, blocked the same way, runs a raw_exec batch job on it to
    ``complete``; SIGINT stops the agent with exit code 0. Neither process
    imports ``cryptography`` (gossip is not encrypted)."""
    import json
    import signal
    import socket
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"http://127.0.0.1:{port}"
    agent = _blocked_cli(["agent", "-dev", "-device", "cpu", "-http-port", str(port),
                          "-data-dir", str(tmp_path / "data")])
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(addr + "/v1/nodes", timeout=2) as r:
                    nodes = json.loads(r.read())
                if nodes and nodes[0]["Status"] == "ready":
                    break
            except OSError:
                pass
            assert agent.poll() is None and time.monotonic() < deadline, "agent not ready"
            time.sleep(0.2)
        job = tmp_path / "iso.hcl"
        job.write_text(_ISOLATED_JOB)
        run = _blocked_cli(["job", "run", "-address", addr, str(job)])
        out, _ = run.communicate(timeout=120)
        assert run.returncode == 0, out
        assert "IMPORTED-FORBIDDEN []" in out, out
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(addr + "/v1/job/iso/allocations", timeout=5) as r:
                allocs = json.loads(r.read())
            if allocs and all(a["ClientStatus"] == "complete" for a in allocs):
                break
            assert time.monotonic() < deadline, allocs
            time.sleep(0.2)
    finally:
        agent.send_signal(signal.SIGINT)
        try:
            out, _ = agent.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            agent.kill()
            out, _ = agent.communicate()
    assert agent.returncode == 0, out[-4000:]
    assert "IMPORTED-FORBIDDEN []" in out, out[-4000:]


def test_agent_on_cuda_without_cuda_raises(monkeypatch):
    """``Agent(AgentConfig())`` asks for CUDA: without a card it raises
    before it binds a port or starts a thread, rather than carrying on on
    the CPU."""
    import threading

    from nomad_tpu_torch.agent import Agent, AgentConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="cuda"):
        Agent(AgentConfig(dev_mode=True))
    with pytest.raises(RuntimeError, match="cuda"):
        Agent(AgentConfig(device="cuda", server_enabled=True))
    assert threading.active_count() == before
