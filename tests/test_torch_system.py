"""The port's system scheduler path and its device-side preemption, held
against the port's own host stack and against the JAX engine.

Ports of ``tests/test_system_engine.py`` (nine scenarios) and of
``tests/test_tpu_parity.py::TestPreemptionParity`` (four cases). Each
workload runs through ``Harness`` three times, from the same seeded
nodes and jobs (ids set from the seed, so every run walks the same node
order and names the same allocs): the port's host ``binpack`` stack,
the port's ``tpu_binpack`` engine on the CPU (the kernels' plain
versions: ``forced.py`` for K4, ``step.py`` with ``has_pre`` for the
preemption passes), and the JAX engine (``nomad_tpu``, ``tpu_binpack``).
Plans, eviction sets (victim for victim, in eviction order), eval
statuses and failed task groups must be equal; the int arm is exact.
"""
import copy
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
import nomad_tpu.structs.structs as jstructs
from nomad_tpu.scheduler.testing import Harness as JaxHarness
from nomad_tpu.tpu.engine import _build_forced_kernel

import nomad_tpu_torch.mock as tmock
import nomad_tpu_torch.structs.structs as tstructs
from nomad_tpu_torch.scheduler.testing import Harness as TorchHarness
from nomad_tpu_torch.tpu import convert, kernels, parity, step
from nomad_tpu_torch.tpu.engine import TorchPlacementEngine, example_forced_variant
from nomad_tpu_torch.utils import metrics as tmetrics

JAX = SimpleNamespace(name="jax", mock=jmock, s=jstructs, harness=lambda: JaxHarness())
TORCH = SimpleNamespace(name="torch", mock=tmock, s=tstructs,
                        harness=lambda: TorchHarness(device="cpu"))


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


def make_nodes(pkg, num, seed, cpus=(2000, 4000, 8000), all_linux_dc1=False):
    rng = random.Random(seed)
    nodes = []
    for i in range(num):
        n = pkg.mock.node()
        n.id = f"{seed:04d}0000-0000-4000-8000-{i:012d}"
        n.name = f"node-{i}"
        n.node_resources.cpu_shares = rng.choice(list(cpus))
        n.datacenter = rng.choice(["dc1", "dc2"])
        n.attributes["rack"] = f"r{rng.randint(0, 3)}"
        if rng.random() < 0.25:
            n.attributes["kernel.name"] = "windows"
        if all_linux_dc1:
            n.datacenter = "dc1"
            n.attributes["kernel.name"] = "linux"
        n.compute_class()
        nodes.append(n)
    return nodes


def system_job(pkg, job_id, cpu=None, priority=None):
    job = pkg.mock.system_job()
    job.id = job_id
    if cpu is not None:
        job.task_groups[0].tasks[0].resources.cpu = cpu
    if priority is not None:
        job.priority = priority
    return job


def new_harness(pkg, alg, preemption=None):
    h = pkg.harness()
    cfg = pkg.s.SchedulerConfiguration(scheduler_algorithm=alg)
    if preemption is not None:
        cfg.preemption_config = pkg.s.PreemptionConfig(**preemption)
    h.state.scheduler_set_config(h.next_index(), cfg)
    return h


def process(pkg, h, job, deterministic=True):
    h.state.upsert_job(h.next_index(), copy.deepcopy(job))
    ev = pkg.s.Evaluation(priority=job.priority, type=job.type,
                          triggered_by=pkg.s.EVAL_TRIGGER_JOB_REGISTER,
                          job_id=job.id, namespace=job.namespace)
    h.process(job.type, ev, deterministic=deterministic)


# -- the nine system scenarios (tests/test_system_engine.py:105-281) ----------
# fn(pkg, h, deterministic): loads the nodes and processes the jobs


def _sys_pair(nodes, jobs):
    def run(pkg, h, det):
        for n in nodes(pkg):
            h.state.upsert_node(h.next_index(), n)
        built = jobs(pkg)
        for job in built:
            h.state.upsert_job(h.next_index(), copy.deepcopy(job))
        for job in built:
            ev = pkg.s.Evaluation(priority=job.priority, type=job.type,
                                  triggered_by=pkg.s.EVAL_TRIGGER_JOB_REGISTER,
                                  job_id=job.id, namespace=job.namespace)
            h.process("system", ev, deterministic=det)
    return run


def _constraint_jobs(pkg):
    job = system_job(pkg, "sys-r1")
    job.constraints.append(pkg.s.Constraint(ltarget="${attr.rack}", rtarget="r1", operand="="))
    return [job]


def _partial_jobs(pkg):
    low = system_job(pkg, "low-half", cpu=1500, priority=20)
    low.constraints.append(pkg.s.Constraint(ltarget="${attr.rack}", rtarget="r1", operand="="))
    return [low, system_job(pkg, "high-all", cpu=900, priority=80)]


def _port_jobs(pkg):
    jobs = []
    for job_id in ("port-holder", "port-contender"):
        job = system_job(pkg, job_id)
        job.task_groups[0].tasks[0].resources.networks = [
            pkg.s.NetworkResource(mbits=10, reserved_ports=[pkg.s.Port(label="svc", value=7777)])]
        jobs.append(job)
    return jobs


def _multi_tg_jobs(pkg):
    job = system_job(pkg, "sys-multi")
    tg2 = copy.deepcopy(job.task_groups[0])
    tg2.name = "second"
    tg2.tasks[0].resources.cpu = 250
    job.task_groups.append(tg2)
    return [job]


def _destructive(pkg, h, det):
    for n in make_nodes(pkg, 8, seed=5):
        h.state.upsert_node(h.next_index(), n)
    job = system_job(pkg, "sys-update")
    process(pkg, h, job, det)
    job2 = copy.deepcopy(job)
    job2.version = 1
    job2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
    process(pkg, h, job2, det)


SCENARIOS = {
    # name: (runner, preemption switch of the system scheduler)
    "basic": (_sys_pair(lambda pkg: make_nodes(pkg, 12, seed=1),
                        lambda pkg: [system_job(pkg, "sys-basic")]), True),
    "constraint_filtering": (_sys_pair(lambda pkg: make_nodes(pkg, 16, seed=2),
                                       _constraint_jobs), True),
    "capacity_failure_no_preemption": (_sys_pair(
        lambda pkg: make_nodes(pkg, 6, seed=3, cpus=(600,)),
        lambda pkg: [system_job(pkg, "busy", cpu=300), system_job(pkg, "big", cpu=500)]), False),
    "preemption_hybrid": (_sys_pair(
        lambda pkg: make_nodes(pkg, 4, seed=4, cpus=(1000,), all_linux_dc1=True),
        lambda pkg: [system_job(pkg, "low-prio", cpu=700, priority=20),
                     system_job(pkg, "high-prio", cpu=700, priority=80)]), True),
    "preemption_partial_hybrid": (_sys_pair(
        lambda pkg: make_nodes(pkg, 8, seed=11, cpus=(2000,), all_linux_dc1=True),
        _partial_jobs), True),
    "destructive_update": (_destructive, True),
    "port_occupied": (_sys_pair(
        lambda pkg: make_nodes(pkg, 3, seed=9, all_linux_dc1=True), _port_jobs), False),
    "multi_tg": (_sys_pair(lambda pkg: make_nodes(pkg, 10, seed=6), _multi_tg_jobs), True),
    "forced_kernel": (_sys_pair(
        lambda pkg: make_nodes(pkg, 24, seed=7, cpus=(800, 2000, 4000)),
        lambda pkg: [system_job(pkg, "sys-a", cpu=600), system_job(pkg, "sys-b", cpu=1500)]),
        False),
}


def run_scenario(pkg, name, alg, deterministic=True):
    runner, pre = SCENARIOS[name]
    h = new_harness(pkg, alg, {"system_scheduler_enabled": pre})
    runner(pkg, h, deterministic)
    return h


def plan_assignments(plans):
    # system allocs share one name per TG across nodes: key by node too
    return {(i, node_id, a.name)
            for i, plan in enumerate(plans)
            for node_id, allocs in plan.node_allocation.items() for a in allocs}


def preemption_view(plans):
    """UUID-free projection of each plan's preemptions: victims by (job,
    task group) per node, preemptors by alloc name with their victims
    in eviction order (tests/test_tpu_parity.py:283-306)."""
    out = {}
    for i, plan in enumerate(plans):
        stub_by_id = {}
        for nid, stubs in plan.node_preemptions.items():
            for s in stubs:
                stub_by_id[s.id] = (nid, s.job_id, s.task_group)
            out[(i, "victims", nid)] = sorted((s.job_id, s.task_group) for s in stubs)
        for nid, allocs in plan.node_allocation.items():
            for a in allocs:
                if a.preempted_allocations:
                    out[(i, "by", nid, a.name)] = [stub_by_id.get(v)
                                                   for v in a.preempted_allocations]
    return out


def assert_same(h_ref, h_got):
    assert len(h_ref.plans) == len(h_got.plans)
    assert plan_assignments(h_ref.plans) == plan_assignments(h_got.plans)
    assert preemption_view(h_ref.plans) == preemption_view(h_got.plans)
    assert len(h_ref.create_evals) == len(h_got.create_evals)
    assert len(h_ref.evals) == len(h_got.evals)
    for re_, ge in zip(h_ref.evals, h_got.evals):
        assert re_.status == ge.status
        assert set(re_.failed_tg_allocs or {}) == set(ge.failed_tg_allocs or {})


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_system_scenario_equals_host_binpack(name, monkeypatch):
    counters = _Counters(monkeypatch)
    host = run_scenario(TORCH, name, "binpack")
    assert counters.count("nomad.tpu_engine.handled") == 0
    dev = run_scenario(TORCH, name, "tpu_binpack")
    assert_same(host, dev)
    assert counters.count("nomad.tpu_engine.handled") >= 1
    assert counters.count("nomad.tpu_engine.unported") == 0
    assert counters.count("nomad.tpu_engine.fallback") == 0
    if name.startswith("preemption"):
        assert any(k[1] == "victims" for k in preemption_view(dev.plans))
        assert counters.count("nomad.tpu_engine.system_preempt_pass") >= 1


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_system_scenario_equals_jax(name):
    assert_same(run_scenario(JAX, name, "tpu_binpack"),
                run_scenario(TORCH, name, "tpu_binpack"))


def test_system_basic_places_every_eligible_node():
    h = run_scenario(TORCH, "basic", "tpu_binpack")
    eligible = [n for n in make_nodes(TORCH, 12, seed=1)
                if n.attributes.get("kernel.name") != "windows" and n.datacenter == "dc1"]
    assert len(plan_assignments(h.plans)) == len(eligible)


@pytest.mark.parametrize("deterministic", [True, False], ids=["int", "float"])
def test_forced_kernel_bit_identical_to_scan(deterministic, monkeypatch):
    """The forced-node kernel's (chosen, scores) equal the scan's on the
    same encoded eval, asserted in-line on every system eval of the
    scenario, in both arms (tests/test_system_engine.py:281)."""
    orig = TorchPlacementEngine.run_forced
    checked = []

    def check(self, enc):
        got = orig(self, enc)
        ref = self.run_scan_single(enc)
        assert got[0].dtype == ref[0].dtype and (got[0] == ref[0]).all()
        assert got[1].dtype == ref[1].dtype and (got[1] == ref[1]).all()
        checked.append(enc.p)
        return got

    monkeypatch.setattr(TorchPlacementEngine, "run_forced", check)
    host = run_scenario(TORCH, "forced_kernel", "binpack", deterministic)
    dev = run_scenario(TORCH, "forced_kernel", "tpu_binpack", deterministic)
    assert checked, "the forced kernel should have run"
    assert plan_assignments(host.plans) == plan_assignments(dev.plans)


# -- the plain K4 against JAX _build_forced_kernel ---------------------------------


@pytest.fixture(scope="module")
def jax_forced():
    return _build_forced_kernel()


def _run_k4_both(jax_forced, static, carry, xs):
    import jax.numpy as jnp

    conv = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    jy = [np.asarray(a) for a in jax_forced(conv(static), conv(carry), conv(xs))]
    ty = convert.to_numpy(kernels.forced_eval(*convert.scan_inputs_to_torch(
        static, carry, xs, "cpu")))
    return jy, ty


def _pad_p(xs, p_pad):
    """run_forced's pow2 pad of the placement axis (forced_node = -1)."""
    p = xs[0].shape[0]
    fills = (0, -1, -1, 0, -1, 0, 0, 0, 0, -1)
    return tuple(np.pad(a, ((0, p_pad - p),) + ((0, 0),) * (a.ndim - 1), constant_values=f)
                 for a, f in zip(xs, fills))


@pytest.mark.parametrize("device_dims", [0, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forced_kernel_int_bit_identical_to_jax(jax_forced, seed, device_dims):
    n_pad, st, ca, xs = example_forced_variant(n_nodes=150, n_placements=100, seed=seed,
                                               device_dims=device_dims)
    xs = _pad_p(xs, 128)
    jy, ty = _run_k4_both(jax_forced, st, ca, xs)
    for a, b in zip(jy, ty):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert (ty[0][100:] == -1).all()
    assert 0 < (ty[0] >= 0).sum() < 100


@pytest.mark.parametrize("device_dims", [0, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forced_kernel_float_within_bound_of_jax(jax_forced, seed, device_dims):
    n_pad, st, ca, xs = example_forced_variant(n_nodes=150, n_placements=100, seed=seed,
                                               device_dims=device_dims, dtype=np.float32)
    xs = _pad_p(xs, 128)
    jy, ty = _run_k4_both(jax_forced, st, ca, xs)
    # the forced pass picks by feasibility alone: no divergence at all
    assert np.array_equal(jy[0], ty[0])
    both = ty[0] >= 0
    assert both.any()
    assert np.abs(jy[1][both].astype(np.float64) - ty[1][both]).max() <= parity.FLOAT_SCORE_TOL


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int", "float"])
def test_plain_forced_kernel_bit_identical_to_plain_scan(dtype):
    """K4 against the port's own K2 plain version on the same input,
    bit for bit in both arms."""
    for device_dims in (0, 2):
        n_pad, st, ca, xs = example_forced_variant(n_nodes=150, n_placements=120, seed=4,
                                                   device_dims=device_dims, dtype=dtype)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, "cpu")
        k4 = kernels.forced_eval(s, c, x)
        _, k2 = step.place_scan(n_pad, s, c, x)
        assert torch.equal(k4[0], k2[0]) and torch.equal(k4[1], k2[1])
        assert k4[1].dtype == k2[1].dtype


def test_forced_eval_rejects_a_candidate_axis():
    n_pad, st, ca, xs = example_forced_variant(n_nodes=40, n_placements=20, seed=1)
    st = list(st)
    st[20] = np.zeros((n_pad, 1, 4), np.int32)
    with pytest.raises(ValueError, match="candidate axis"):
        kernels.forced_eval(*convert.scan_inputs_to_torch(st, ca, xs, "cpu"))


def test_cpu_forced_eval_launches_no_kernel():
    kernels.reset_launch_counts()
    n_pad, st, ca, xs = example_forced_variant(n_nodes=40, n_placements=20, seed=2)
    kernels.forced_eval(*convert.scan_inputs_to_torch(st, ca, xs, "cpu"))
    assert kernels.LAUNCHES["forced_eval"] == 0 and kernels.LAUNCHES["forced_eval_f32"] == 0


# -- the packed K4 entry (kernels.pack_forced_inputs / forced_eval_packed) ---------


def _packed_k4(st, ca, xs):
    out, layout = kernels.forced_eval_packed(kernels.pack_forced_inputs((st, ca, xs), "cpu"))
    return convert.from_device_packed(out, layout)


@pytest.mark.parametrize("p", [100, 1, 0])
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int", "float"])
def test_packed_forced_eval_against_jax(jax_forced, dtype, p):
    """The packed entry on P placements as they come (not a power of
    two, one, none) against the JAX ``_build_forced_kernel`` on the same
    unpadded inputs: the int arm bit for bit, the float arm the same
    picks and scores within the parity bound."""
    n_pad, st, ca, xs = example_forced_variant(n_nodes=150, n_placements=max(p, 1), seed=2,
                                               dtype=dtype, device_dims=2)
    xs = tuple(a[:p] for a in xs)
    jy, _ = _run_k4_both(jax_forced, st, ca, xs)
    chosen, scores = _packed_k4(st, ca, xs)
    assert chosen.shape == scores.shape == (p,)
    assert chosen.dtype == jy[0].dtype and scores.dtype == jy[1].dtype
    assert np.array_equal(chosen, jy[0])
    if dtype == np.int32:
        assert np.array_equal(scores, jy[1])
    elif p:
        both = chosen >= 0
        assert np.abs(jy[1][both].astype(np.float64) - scores[both]).max() <= parity.FLOAT_SCORE_TOL
    if p > 1:
        assert 0 < (chosen >= 0).sum() < p


def test_packed_forced_buffer_holds_the_sixteen_inputs():
    """pack_forced_inputs keeps exactly the arrays K4 reads, each at a
    16-byte offset, and ``parts`` puts their views where the plain
    version reads them."""
    n_pad, st, ca, xs = example_forced_variant(n_nodes=40, n_placements=30, seed=3)
    packed = kernels.pack_forced_inputs((st, ca, xs), "cpu")
    assert len(packed.layout) == 16 and all(o % 16 == 0 for o, _dt, _s in packed.layout)
    assert packed.dims == {"P": 30, "N": n_pad, "D": 4, "G": 1, "has_reserved": 0,
                           "float_arm": 0}
    static, carry, xs_v = packed.parts()
    for (part, arrays) in ((static, st), (carry, ca), (xs_v, xs)):
        for view, ref in zip(part, arrays):
            if view is not None:
                assert view.numpy().dtype == np.asarray(ref).dtype
                assert np.array_equal(view.numpy(), np.asarray(ref))
    assert sum(v is not None for part in (static, carry, xs_v) for v in part) == 16


def test_packed_forced_eval_rejects_a_candidate_axis():
    n_pad, st, ca, xs = example_forced_variant(n_nodes=40, n_placements=20, seed=1)
    st = list(st)
    st[20] = np.zeros((n_pad, 1, 4), np.int32)
    with pytest.raises(ValueError, match="candidate axis"):
        kernels.pack_forced_inputs((st, ca, xs), "cpu")


@pytest.mark.parametrize("deterministic", [True, False], ids=["int", "float"])
def test_run_forced_packs_once_and_makes_no_tensor_per_array(deterministic, monkeypatch):
    """Every system eval of the forced-kernel scenario through
    ``run_forced``: one packed buffer (one host-to-device copy), one
    packed launch, one copy back, and no ``scan_inputs_to_torch``; its
    results equal the tensor entry's on the same encode."""
    from nomad_tpu_torch.tpu import engine as tengine

    calls = {"pack": 0, "h2d": 0, "launch": 0, "d2h": 0, "loose": 0}
    per_eval = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kernels, "pack_forced_inputs", spy("pack", kernels.pack_forced_inputs))
    monkeypatch.setattr(convert, "to_device_packed", spy("h2d", convert.to_device_packed))
    monkeypatch.setattr(kernels, "forced_eval_packed", spy("launch", kernels.forced_eval_packed))
    monkeypatch.setattr(tengine, "from_device_packed", spy("d2h", tengine.from_device_packed))
    monkeypatch.setattr(convert, "scan_inputs_to_torch",
                        spy("loose", convert.scan_inputs_to_torch))
    orig = TorchPlacementEngine.run_forced

    def check(self, enc):
        before = dict(calls)
        got = orig(self, enc)
        per_eval.append({k: calls[k] - before[k] for k in calls})
        ref = convert.to_numpy(kernels.forced_eval(*convert.scan_inputs_to_torch(
            enc.static, enc.carry, enc.xs, "cpu")))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        return got

    monkeypatch.setattr(TorchPlacementEngine, "run_forced", check)
    run_scenario(TORCH, "forced_kernel", "tpu_binpack", deterministic)
    assert per_eval
    assert all(c == {"pack": 1, "h2d": 1, "launch": 1, "d2h": 1, "loose": 0}
               for c in per_eval), per_eval


# -- TestPreemptionParity through the port (tests/test_tpu_parity.py:238-400) ------


def _plain_service(pkg, job_id, priority, count, cpu, mem):
    job = pkg.mock.job()
    job.id = job_id
    job.priority = priority
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.tasks[0].resources.networks = []  # networks send preemption to the host
    return job


def _uniform_nodes(pkg, num, cpu=2000, mem=4096, seed=0):
    nodes = []
    for i in range(num):
        n = pkg.mock.node()
        n.id = f"{seed:04d}0000-0000-4000-8000-{i:012d}"
        n.name = f"pnode-{i}"
        n.node_resources.cpu_shares = cpu
        n.node_resources.memory_mb = mem
        n.compute_class()
        nodes.append(n)
    return nodes


ALL_PREEMPTION = {"system_scheduler_enabled": True, "service_scheduler_enabled": True,
                  "batch_scheduler_enabled": True}


def run_preempt(pkg, alg, nodes, victims, preemptors):
    h = new_harness(pkg, alg, ALL_PREEMPTION)
    for n in nodes(pkg):
        h.state.upsert_node(h.next_index(), n)
    for phase in (victims, preemptors):
        for job in phase(pkg):
            process(pkg, h, job)
    return h


def _high_system(pkg):
    high = system_job(pkg, "sys-high", priority=80)
    high.task_groups[0].tasks[0].resources.cpu = 1000
    high.task_groups[0].tasks[0].resources.memory_mb = 512
    return [high]


PREEMPT_CASES = {
    "service_preempts_low_priority": (
        lambda pkg: _uniform_nodes(pkg, 6),
        lambda pkg: [_plain_service(pkg, "low", 20, 6, 1500, 2048)],
        lambda pkg: [_plain_service(pkg, "high", 70, 3, 1000, 1024)], True),
    "no_preemption_below_priority_delta": (
        lambda pkg: _uniform_nodes(pkg, 4),
        lambda pkg: [_plain_service(pkg, "low", 45, 4, 1500, 2048)],
        lambda pkg: [_plain_service(pkg, "close", 50, 2, 1000, 1024)], False),
    "system_job_preemption": (
        lambda pkg: _uniform_nodes(pkg, 5),
        lambda pkg: [_plain_service(pkg, "low", 20, 5, 1500, 2048)],
        _high_system, True),
}


def _fuzz_case(seed):
    rng = random.Random(seed)
    num = rng.randint(3, 10)
    cpu = rng.choice([2000, 3000])
    victims = [(f"victim-{vi}", rng.choice([10, 20, 30]), num, rng.choice([600, 900, 1200]),
                rng.choice([512, 1024, 2048])) for vi in range(rng.randint(1, 2))]
    pre = ("preemptor", rng.choice([60, 80]), rng.randint(1, num),
           rng.choice([800, 1200, 1600]), rng.choice([1024, 2048]))
    return (lambda pkg: _uniform_nodes(pkg, num, cpu=cpu, seed=seed),
            lambda pkg: [_plain_service(pkg, *v) for v in victims],
            lambda pkg: [_plain_service(pkg, *pre)])


@pytest.mark.parametrize("name", sorted(PREEMPT_CASES))
def test_preemption_parity(name, monkeypatch):
    """The device's eviction sets equal the port's host Preemptor victim
    for victim, in the same order, and the JAX engine's."""
    nodes, victims, preemptors, must_preempt = PREEMPT_CASES[name]
    counters = _Counters(monkeypatch)
    host = run_preempt(TORCH, "binpack", nodes, victims, preemptors)
    dev = run_preempt(TORCH, "tpu_binpack", nodes, victims, preemptors)
    ref = run_preempt(JAX, "tpu_binpack", nodes, victims, preemptors)
    assert_same(host, dev)
    assert_same(ref, dev)
    assert counters.count("nomad.tpu_engine.handled") >= 1
    assert counters.count("nomad.tpu_engine.unported") == 0
    assert counters.count("nomad.tpu_engine.fallback") == 0
    assert any(k[1] == "victims" for k in preemption_view(dev.plans)) == must_preempt


def test_preemption_fuzz_parity():
    """Randomized saturated clusters and a preemptor (seeds 40-45 of the
    JAX fuzz): host, port device and JAX device agree on victims, order
    and placements, and the fuzz really evicts."""
    preempting = 0
    for seed in range(40, 46):
        nodes, victims, preemptors = _fuzz_case(seed)
        host = run_preempt(TORCH, "binpack", nodes, victims, preemptors)
        dev = run_preempt(TORCH, "tpu_binpack", nodes, victims, preemptors)
        ref = run_preempt(JAX, "tpu_binpack", nodes, victims, preemptors)
        assert_same(host, dev)
        assert_same(ref, dev)
        if any(k[1] == "victims" for k in preemption_view(dev.plans)):
            preempting += 1
    assert preempting >= 2
