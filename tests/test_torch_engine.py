"""The port's placement slice held against the JAX package, end to end.

The same scenarios (after tests/test_tpu_parity.py) run through
``nomad_tpu.scheduler.testing.Harness`` (``tpu_binpack``, deterministic:
the JAX scan) and ``nomad_tpu_torch.scheduler.testing.Harness`` on the
CPU (the port's engine with the plain PyTorch scan). Assignments
``{(plan index, alloc name) -> node name}`` and the failed-TG metrics
must be equal; no tolerance: the int arm is exact. Node and job ids come
from the seed in both packages, so both walk the same node order.
"""
import copy
import random
from types import SimpleNamespace

import pytest

import nomad_tpu.mock as jmock
import nomad_tpu.structs.structs as jstructs
from nomad_tpu.scheduler.testing import Harness as JaxHarness

import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs.structs as tstructs
from nomad_tpu_torch.scheduler.testing import Harness as TorchHarness
from nomad_tpu_torch.tpu import parity
from nomad_tpu_torch.trace import lifecycle as tlifecycle
from nomad_tpu_torch.utils import metrics as tmetrics

JAX = SimpleNamespace(mock=jmock, s=jstructs, harness=lambda: JaxHarness())
TORCH = SimpleNamespace(mock=tmock, s=tstructs,
                        harness=lambda: TorchHarness(device="cpu"))


def make_nodes(pkg, num, seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(num):
        n = pkg.mock.node()
        n.id = f"{seed:04d}0000-0000-4000-8000-{i:012d}"
        n.name = f"node-{i}"
        n.node_resources.cpu_shares = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.datacenter = rng.choice(["dc1", "dc2"])
        n.attributes["rack"] = f"r{rng.randint(0, 3)}"
        if rng.random() < 0.2:
            n.attributes["kernel.name"] = "windows"
        n.compute_class()
        nodes.append(n)
    return nodes


def new_harness(pkg, alg="tpu_binpack"):
    h = pkg.harness()
    h.state.scheduler_set_config(
        h.next_index(), pkg.s.SchedulerConfiguration(scheduler_algorithm=alg))
    return h


def register(pkg, h, job, sched_type="service", deterministic=True):
    h.state.upsert_job(h.next_index(), copy.deepcopy(job))
    ev = pkg.s.Evaluation(priority=job.priority, type=job.type,
                          triggered_by=pkg.s.EVAL_TRIGGER_JOB_REGISTER,
                          job_id=job.id, namespace=job.namespace)
    if pkg is TORCH:
        tlifecycle.on_enqueue(ev)
    h.process(sched_type, ev, deterministic=deterministic)
    return ev


def view(h):
    """Assignments and failed-TG metrics of every plan and eval update."""
    assign = {}
    for i, plan in enumerate(h.plans):
        for allocs in plan.node_allocation.values():
            for a in allocs:
                assign[(i, a.name)] = a.node_name
    evals = []
    for ev in h.evals:
        failed = {
            name: (m.coalesced_failures, m.nodes_evaluated)
            for name, m in (ev.failed_tg_allocs or {}).items()
        }
        evals.append((ev.status, failed))
    return assign, evals, len(h.create_evals)


# -- scenarios: fn(pkg, h) ----------------------------------------------------


def sc_basic_service(pkg, h):
    for n in make_nodes(pkg, 20, seed=1):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "basic"
    job.task_groups[0].count = 8
    register(pkg, h, job)


def sc_multi_tg_multi_job(pkg, h):
    for n in make_nodes(pkg, 30, seed=2):
        h.state.upsert_node(h.next_index(), n)
    for ji in range(3):
        job = pkg.mock.job()
        job.id = f"multi-{ji}"
        tg0 = job.task_groups[0]
        job.task_groups = []
        for t in range(3):
            tg = copy.deepcopy(tg0)
            tg.name = f"tg{t}"
            tg.count = 4
            tg.tasks[0].resources.cpu = 300 + 100 * t
            job.task_groups.append(tg)
        register(pkg, h, job)


def sc_batch(pkg, h):
    for n in make_nodes(pkg, 25, seed=3):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.batch_job()
    job.id = "batch"
    job.task_groups[0].count = 12
    register(pkg, h, job, "batch")


def sc_affinities(pkg, h):
    for n in make_nodes(pkg, 20, seed=4):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "aff"
    job.task_groups[0].count = 6
    job.affinities = [pkg.s.Affinity("${attr.rack}", "r1", "=", 75)]
    job.task_groups[0].affinities = [
        pkg.s.Affinity("${node.datacenter}", "dc2", "=", -30)]
    job.datacenters = ["dc1", "dc2"]
    register(pkg, h, job)


def sc_spread(pkg, h):
    for n in make_nodes(pkg, 24, seed=5):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "spread"
    job.task_groups[0].count = 10
    job.datacenters = ["dc1", "dc2"]
    job.spreads = [pkg.s.Spread("${node.datacenter}", 100, [
        pkg.s.SpreadTarget("dc1", 70), pkg.s.SpreadTarget("dc2", 30)])]
    register(pkg, h, job)


def sc_even_spread(pkg, h):
    for n in make_nodes(pkg, 16, seed=6):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "even"
    job.task_groups[0].count = 8
    job.task_groups[0].spreads = [pkg.s.Spread("${attr.rack}", 50, [])]
    register(pkg, h, job)


def sc_distinct_hosts(pkg, h):
    for n in make_nodes(pkg, 15, seed=7):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "dh"
    job.task_groups[0].count = 10
    job.constraints.append(pkg.s.Constraint(operand="distinct_hosts"))
    register(pkg, h, job)


def sc_overcommitted(pkg, h):
    for n in make_nodes(pkg, 5, seed=8):
        n.node_resources.cpu_shares = 1000
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "over"
    job.task_groups[0].count = 20
    job.task_groups[0].tasks[0].resources.cpu = 400
    register(pkg, h, job)


def sc_scale_up_down(pkg, h):
    for n in make_nodes(pkg, 18, seed=9):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "scale"
    job.task_groups[0].count = 9
    register(pkg, h, job)
    job2 = copy.deepcopy(job)
    job2.task_groups[0].count = 14
    register(pkg, h, job2)
    job3 = copy.deepcopy(job2)
    job3.task_groups[0].tasks[0].config = {"command": "/bin/new"}
    register(pkg, h, job3)          # destructive: the eviction axis
    job4 = copy.deepcopy(job3)
    job4.task_groups[0].count = 5
    register(pkg, h, job4)          # scale down: stops only


def sc_distinct_property(pkg, h):
    for n in make_nodes(pkg, 12, seed=25):
        h.state.upsert_node(h.next_index(), n)
    job = pkg.mock.job()
    job.id = "dp"
    job.task_groups[0].count = 6
    job.constraints.append(pkg.s.Constraint(
        operand="distinct_property", ltarget="${attr.rack}", rtarget="2"))
    register(pkg, h, job)


SCENARIOS = {
    "basic_service": sc_basic_service,
    "multi_tg_multi_job": sc_multi_tg_multi_job,
    "batch": sc_batch,
    "affinities": sc_affinities,
    "spread": sc_spread,
    "even_spread": sc_even_spread,
    "distinct_hosts": sc_distinct_hosts,
    "overcommitted": sc_overcommitted,
    "scale_up_down": sc_scale_up_down,
    "distinct_property": sc_distinct_property,
}


class _Counters:
    """Event-wise spy on the port's metrics counters."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = tmetrics.incr_counter

        def spy(name, value=1.0):
            self.calls.append(name)
            orig(name, value)

        monkeypatch.setattr(tmetrics, "incr_counter", spy)

    def count(self, name):
        return self.calls.count(name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_plans_equal_jax(name, monkeypatch):
    counters = _Counters(monkeypatch)
    tlifecycle.reset()
    hj = new_harness(JAX)
    SCENARIOS[name](JAX, hj)
    ht = new_harness(TORCH)
    SCENARIOS[name](TORCH, ht)

    assert view(ht) == view(hj)
    assert view(ht)[0], "scenario placed nothing"
    assert counters.count("nomad.tpu_engine.handled") >= 1
    assert counters.count("nomad.tpu_engine.unported") == 0
    assert counters.count("nomad.tpu_engine.fallback") == 0
    paths = {r["path"] for r in tlifecycle.raw_records()}
    assert "device" in paths and "host" not in paths


@pytest.mark.parametrize("name", ["spread", "scale_up_down"])
def test_port_plans_equal_host_oracle(name):
    """The port's engine against its own host binpack stack."""
    hh = new_harness(TORCH, alg="binpack")
    SCENARIOS[name](TORCH, hh)
    ht = new_harness(TORCH)
    SCENARIOS[name](TORCH, ht)
    assert view(ht)[0] == view(hh)[0]


def register_float(pkg, h, job, sched_type="service", deterministic=True,
                   _register=register):
    """``register`` for a non-deterministic eval: the float32 arm (it
    stands in for ``register`` in the scenarios)."""
    return _register(pkg, h, job, sched_type, deterministic=False)


def assign_divergence(got, ref):
    """Placement-multiset divergence (``parity.tg_multiset_divergence``)
    of two ``{(plan or job, alloc name) -> node}`` maps over the same
    keys, grouped by (plan or job, task group)."""
    from nomad_tpu_torch.tpu import parity

    assert set(got) == set(ref)
    keys = sorted(ref)
    groups = [f"{k[0]}/{k[1].rsplit('[', 1)[0]}" for k in keys]
    return parity.tg_multiset_divergence(
        [got[k] for k in keys], [ref[k] for k in keys], groups)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_float_plans_within_bound_of_jax(name, monkeypatch):
    """Non-deterministic evals (the float32 arm, the server's default)
    through both engines, within ``parity.FLOAT_DIVERGENCE_BOUND`` (0)
    placements per scenario. The host stack shuffles each eval's nodes
    with Python's ``random``, which both packages share: seeded the
    same, both walk the same node order."""
    import random
    import sys

    counters = _Counters(monkeypatch)
    module = sys.modules[__name__]
    monkeypatch.setattr(module, "register", register_float)
    views = []
    for pkg in (JAX, TORCH):
        random.seed(20)
        h = new_harness(pkg)
        SCENARIOS[name](pkg, h)
        views.append(view(h))
    vj, vt = views
    assert vt[0], "scenario placed nothing"
    assert assign_divergence(vt[0], vj[0]) <= parity.FLOAT_DIVERGENCE_BOUND
    assert vt[1:] == vj[1:]
    assert counters.count("nomad.tpu_engine.handled") >= 1
    assert counters.count("nomad.tpu_engine.unported") == 0
    assert counters.count("nomad.tpu_engine.fallback") == 0


def test_preemption_enabled_eval_is_unported(monkeypatch):
    counters = _Counters(monkeypatch)
    h = TorchHarness(device="cpu")
    cfg = tstructs.SchedulerConfiguration(scheduler_algorithm="tpu_binpack")
    cfg.preemption_config.service_scheduler_enabled = True
    h.state.scheduler_set_config(h.next_index(), cfg)
    for n in make_nodes(TORCH, 10, seed=12):
        h.state.upsert_node(h.next_index(), n)
    job = tmock.job()
    job.id = "pre"
    job.task_groups[0].count = 2
    register(TORCH, h, job)
    assert counters.count("nomad.tpu_engine.unported.preemption") == 1
    assert counters.count("nomad.tpu_engine.handled") == 0
    assert len(view(h)[0]) == 2


def test_c1m_evals_port_equals_jax_at_1000_nodes():
    """chip_smoke.py's four C1M evals (templates 0, 10, 28 and 10 again
    with cpu + 1: spread + affinity, plain service, batch, destructive
    update) at 1,000 nodes: the port's plans equal the JAX engine's."""
    import numpy as np

    from chip_smoke import c1m_jobs

    def run(pkg):
        h = new_harness(pkg)
        rng = np.random.default_rng(0)
        for i in range(1000):
            n = pkg.mock.node()
            n.id = f"00000000-0000-4000-8000-{i:012d}"
            n.name = f"bench-{i}"
            n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
            n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
            n.compute_class()
            h.state.upsert_node(h.next_index(), n)
        for job, kind in c1m_jobs(pkg.mock, pkg.s):
            register(pkg, h, job, kind)
        return view(h)

    jax_view = run(JAX)
    assert len(jax_view[0]) == 900 + 3 * 950
    assert run(TORCH) == jax_view
