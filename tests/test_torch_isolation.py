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


def test_port_threaded_code_passes_the_lock_and_state_lint():
    """nomad-lint's lock-order, condition-discipline and
    shared-state-discipline rules over the whole port, against an empty
    baseline: a finding is fixed in the port, never baselined."""
    baseline = Path(__file__).resolve().parent / "torch_lint_baseline.json"
    assert baseline.read_text().strip() == "[]"
    out = subprocess.run(
        [sys.executable, "-m", "nomad_tpu.analysis", "nomad_tpu_torch",
         "--rule", "lock-order,condition-discipline,shared-state-discipline",
         "--baseline", str(baseline)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
