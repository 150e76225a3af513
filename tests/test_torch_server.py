"""The port's server slice on the CPU: register job -> EvalBroker ->
Worker -> GenericScheduler -> TorchPlacementEngine -> DeviceBatcher ->
dense plans -> async applier / Planner -> InProcRaft -> NomadFSM.

1. Against the JAX package: the same nodes and jobs through a port
   ``Server(device="cpu")`` and a JAX ``Server``, one worker each, job
   counts above ``device_min_placements``. Deterministic (the int arm,
   ring decorrelation off): the alloc -> node maps are equal. Float arm
   (the default): per-(job, task group) placement-multiset divergence
   at most ``parity.FLOAT_DIVERGENCE_BOUND`` (0; the host stack
   shuffles nodes with Python's ``random``, seeded the same for both).
2. Ports of tests/test_server.py and tests/test_pipeline.py through the
   device path (``device_min_placements=0``), in both arms.
3. Nothing falls back: a failed launch nacks the eval; nothing is placed
   on the host.

Every server is stopped in a ``finally``, and every wait is bounded.
"""
import random
import time
from collections import Counter

import pytest

from test_torch_engine import assign_divergence

import nomad_tpu.mock as jmock
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import InProcRaft, Server, ServerConfig
from nomad_tpu_torch.server.fsm import NODE_REGISTER
from nomad_tpu_torch.structs.structs import ALLOC_DESIRED_RUN, Resources
from nomad_tpu_torch.tpu import kernels, parity
from nomad_tpu_torch.trace import lifecycle
from nomad_tpu_torch.utils import metrics

ARMS = [pytest.param(True, id="int"), pytest.param(False, id="float")]


def wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def counter(name):
    total = 0.0
    sink = metrics.global_sink()
    with sink._lock:
        for iv in sink._intervals:
            agg = iv.counters.get(name)
            if agg is not None:
                total += agg.sum
    return total


def live_allocs(server, job):
    return [a for a in server.fsm.state.allocs_by_job(job.namespace, job.id, True)
            if a.desired_status == ALLOC_DESIRED_RUN]


# -- 1. the port's server against the JAX package's ------------------------


def _fleet_and_jobs(mock_mod, s):
    rng = random.Random(5)
    nodes = []
    for i in range(40):
        n = mock_mod.node()
        n.id = f"00000000-0000-4000-8000-{i:012d}"
        n.name = f"node-{i}"
        n.node_resources.cpu_shares = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.attributes["rack"] = f"r{rng.randint(0, 3)}"
        n.compute_class()
        nodes.append(n)
    web = mock_mod.job()
    web.id = "web"
    web.task_groups[0].count = 30
    spread = mock_mod.job()
    spread.id = "spread"
    spread.task_groups[0].count = 26
    spread.task_groups[0].spreads = [s.Spread(
        attribute="${attr.rack}", weight=50,
        spread_target=[s.SpreadTarget(value="r0", percent=50),
                       s.SpreadTarget(value="r1", percent=25)])]
    batch = mock_mod.batch_job()
    batch.id = "batch"
    batch.task_groups[0].count = 25
    return nodes, [web, spread, batch]


def _run_server(server_cls, cfg, mock_mod, s):
    nodes, jobs = _fleet_and_jobs(mock_mod, s)
    srv = server_cls(cfg)
    try:
        srv.start()
        for n in nodes:
            srv.register_node(n)
        random.seed(11)  # the host stack's node shuffle (float arm)
        for job in jobs:
            srv.register_job(job)
        want = sum(j.task_groups[0].count for j in jobs)
        wait_for(lambda: sum(len(live_allocs(srv, j)) for j in jobs) == want,
                 timeout=120.0, msg=f"{want} allocs placed")
        assert srv.drain_evals(30.0)
        names = {n.id: n.name for n in nodes}
        return {(j.id, a.name): names[a.node_id] for j in jobs for a in live_allocs(srv, j)}
    finally:
        srv.stop()


@pytest.mark.parametrize("deterministic", ARMS)
def test_port_server_places_as_the_jax_server(deterministic):
    import nomad_tpu.structs.structs as jstructs
    import nomad_tpu_torch.structs.structs as tstructs

    kw = dict(num_schedulers=1, deterministic=deterministic,
              ring_decorrelate=False, pipeline_async=False)
    jax_view = _run_server(JaxServer, JaxServerConfig(**kw), jmock, jstructs)
    port_view = _run_server(Server, ServerConfig(device="cpu", **kw), mock, tstructs)
    assert set(port_view) == set(jax_view)
    if deterministic:
        assert port_view == jax_view
    else:
        assert assign_divergence(port_view, jax_view) <= parity.FLOAT_DIVERGENCE_BOUND


# -- 2. ports of tests/test_server.py and tests/test_pipeline.py ------------


@pytest.fixture(params=ARMS)
def server(request):
    lifecycle.reset()
    s = Server(ServerConfig(num_schedulers=2, deterministic=request.param,
                            device_min_placements=0, device="cpu"))
    try:
        s.start()
        yield s
    finally:
        s.stop()


def test_end_to_end_job_schedule(server):
    for _ in range(5):
        server.register_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 5
    launches = dict(kernels.LAUNCHES)
    eval_id = server.register_job(job)
    wait_for(lambda: len(live_allocs(server, job)) == 5, msg="5 allocs placed")
    wait_for(lambda: server.fsm.state.eval_by_id(eval_id).status == "complete",
             msg="eval complete")
    allocs = server.fsm.state.allocs_by_job(job.namespace, job.id, True)
    assert len({a.node_id for a in allocs}) == 5  # anti-affinity spread
    assert server.device_batcher.stats["evals"] >= 1
    assert kernels.LAUNCHES == launches  # the CPU runs the plain scan


def test_scale_up_and_down(server):
    for _ in range(6):
        server.register_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    server.register_job(job)
    wait_for(lambda: len(server.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3,
             msg="initial 3")
    job2 = job.copy()
    job2.task_groups[0].count = 6
    server.register_job(job2)
    wait_for(lambda: len(live_allocs(server, job)) == 6, msg="scaled to 6")
    job3 = job.copy()
    job3.task_groups[0].count = 2
    server.register_job(job3)
    wait_for(lambda: len(live_allocs(server, job)) == 2, msg="scaled to 2")


def test_blocked_eval_unblocks_on_capacity(server):
    job = mock.job()
    job.task_groups[0].count = 2
    server.register_job(job)
    wait_for(lambda: server.blocked_evals.stats()["total_blocked"] >= 1,
             msg="eval blocked")
    assert server.fsm.state.allocs_by_job(job.namespace, job.id, True) == []
    server.register_node(mock.node())
    server.register_node(mock.node())
    wait_for(lambda: len(server.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 2,
             msg="unblocked placement")


def test_deregister_job_stops_allocs(server):
    for _ in range(3):
        server.register_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    server.register_job(job)
    wait_for(lambda: len(server.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3,
             msg="placed")
    server.deregister_job(job.namespace, job.id)
    wait_for(lambda: not live_allocs(server, job), msg="all stopped")


def test_plan_rejection_on_stale_state():
    """Two plans racing for the same capacity: the applier rejects the loser."""
    from nomad_tpu_torch.structs.structs import (
        AllocatedResources,
        AllocatedTaskResources,
        Allocation,
        Plan,
    )

    s = Server(ServerConfig(num_schedulers=0, device="cpu"))
    try:
        s.start()
        node = mock.node()  # 4000 MHz, 100 reserved
        s.register_node(node)

        def make_plan(cpu):
            job = mock.job()
            plan = Plan(priority=50, job=job)
            alloc = Allocation(
                node_id=node.id, job_id=job.id, task_group="web",
                allocated_resources=AllocatedResources(
                    tasks={"web": AllocatedTaskResources(cpu_shares=cpu, memory_mb=64)}),
            )
            plan.node_allocation[node.id] = [alloc]
            return plan

        r1 = s.plan_queue.enqueue(make_plan(3000)).future.result(timeout=5)
        assert len(r1.node_allocation) == 1  # fits
        r2 = s.plan_queue.enqueue(make_plan(3000)).future.result(timeout=5)
        # 3000 + 3000 + 100 reserved > 4000: rejected, refresh forced
        assert len(r2.node_allocation) == 0
        assert r2.refresh_index > 0
    finally:
        s.stop()


def test_multi_server_replication_and_failover():
    raft = InProcRaft()
    cfg = ServerConfig(num_schedulers=1, device="cpu", device_min_placements=0)
    servers = [Server(cfg, raft=raft, name=f"s{i}") for i in (1, 2, 3)]
    s1, s2, s3 = servers
    try:
        for s in servers:
            s.start()
        assert s1.is_leader and not s2.is_leader
        for _ in range(3):
            s1.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        s1.register_job(job)
        wait_for(lambda: len(s1.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3,
                 msg="leader placed")
        assert len(s2.fsm.state.allocs_by_job(job.namespace, job.id, True)) == 3
        raft.transfer_leadership(s2.peer)
        assert s2.is_leader and not s1.is_leader
        job2 = mock.job()
        job2.task_groups[0].count = 2
        s2.register_job(job2)
        wait_for(lambda: len(s2.fsm.state.allocs_by_job(job2.namespace, job2.id, True)) == 2,
                 msg="new leader placed")
        assert len(s1.fsm.state.allocs_by_job(job2.namespace, job2.id, True)) == 2
    finally:
        for s in servers:
            s.stop()


def _dense_job(job_id, count=8, cpu=100, mem=128):
    j = mock.job()
    j.id = job_id
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources = Resources(cpu=cpu, memory_mb=mem)
    return j


def _register_nodes(server, n, cpu=4000, mem=8192):
    for i in range(n):
        node = mock.node()
        node.name = f"pipe-{i}"
        node.node_resources.cpu_shares = cpu
        node.node_resources.memory_mb = mem
        node.compute_class()
        server.raft_apply(NODE_REGISTER, node)


@pytest.fixture(params=ARMS)
def pipe_server(request):
    lifecycle.reset()
    s = Server(ServerConfig(num_schedulers=2, deterministic=request.param,
                            device_batch=4, device_batch_window_ms=5.0,
                            device_min_placements=0, device="cpu"))
    try:
        s.start()
        yield s
    finally:
        s.stop()


def test_waves_overlap_instead_of_convoying(pipe_server):
    """Wave A parks in the DISPATCH stage (the batcher's gather window)
    while wave B's ENCODE runs inside that window."""
    server = pipe_server
    _register_nodes(server, 6)
    # hold the gather open for a second arrival: on the CPU the plain
    # scan of a small wave returns in tens of ms (the JAX test's first
    # dispatch is held open by its compile)
    server.device_batcher.window_s = 1.0
    server.device_batcher.idle_s = 1.0
    server.register_job(_dense_job("overlap-a", count=8))
    time.sleep(0.15)  # A is now inside its dispatch gather window
    server.register_job(_dense_job("overlap-b", count=8, cpu=150, mem=192))
    wait_for(lambda: server.fsm.state.count_allocs_desired_run() == 16, msg="16 placed")
    dispatches = lifecycle.pipeline_spans("dispatch")
    encodes = lifecycle.pipeline_spans("encode")
    assert dispatches and encodes
    assert any(
        d_wave != e_wave and d_t0 <= e_t0 <= d_t1
        for _, d_wave, d_t0, d_t1 in dispatches
        for _, e_wave, e_t0, e_t1 in encodes
    ), f"no encode span inside another wave's dispatch: {dispatches} {encodes}"
    assert counter("nomad.worker.async_handoff") > 0
    wait_for(lambda: server.eval_broker.stats().get("total_unacked", 0) == 0,
             timeout=10.0, msg="broker drained")
    assert lifecycle.pipeline_spans("evaluate")
    assert lifecycle.pipeline_spans("commit")


def test_occ_retry_reuses_encode_and_never_strands(pipe_server):
    """Two same-shaped plans from the same pre-commit snapshot collide on
    one node: the loser's wave re-enters the device stage from its cached
    encode (the port's batcher), and the broker drains inside the
    applier's watchdog bound."""
    server = pipe_server
    server.config.ring_decorrelate = False
    # one node a little larger than the other: both waves' binpack picks
    # the tighter one in either arm (the float arm shuffles its ring, so
    # equal nodes would collide only half the time)
    _register_nodes(server, 1, cpu=4000, mem=8192)
    _register_nodes(server, 1, cpu=4400, mem=8192)
    # both evals encode against the same empty-usage snapshot and meet
    # in one gather (held open for the second arrival)
    server.device_batcher.window_s = 0.5
    server.device_batcher.idle_s = 0.5
    before = {k: counter(k) for k in ("nomad.pipeline.partial_commit",
                                      "nomad.pipeline.redispatch",
                                      "nomad.pipeline.redispatch_encode_reuse",
                                      "nomad.pipeline.acked")}
    server.register_job(_dense_job("occ-a", count=1, cpu=2100, mem=256))
    server.register_job(_dense_job("occ-b", count=1, cpu=2100, mem=256))
    wait_for(lambda: server.fsm.state.count_allocs_desired_run() == 2,
             timeout=60.0, msg="2 placed after OCC retry")
    wait_for(lambda: server.eval_broker.stats().get("total_unacked", 0) == 0,
             timeout=server.config.pipeline_ack_timeout_s + 5.0,
             msg="broker drained within the watchdog bound")
    delta = {k: counter(k) - v for k, v in before.items()}
    if delta["nomad.pipeline.partial_commit"] == 0:
        pytest.skip("plans did not collide on this run (no partial commit)")
    assert delta["nomad.pipeline.redispatch"] > 0
    assert delta["nomad.pipeline.redispatch_encode_reuse"] > 0
    enc_by_wave = Counter(w for _, w, _, _ in lifecycle.pipeline_spans("encode"))
    assert enc_by_wave and all(n == 1 for n in enc_by_wave.values()), enc_by_wave
    disp_by_wave = Counter(w for _, w, _, _ in lifecycle.pipeline_spans("dispatch"))
    assert any(n >= 2 for n in disp_by_wave.values()), disp_by_wave
    assert delta["nomad.pipeline.acked"] >= 2


# -- 3. nothing falls back --------------------------------------------------


@pytest.mark.parametrize("deterministic", ARMS)
def test_failed_launch_nacks_the_eval_and_places_nothing(deterministic, monkeypatch):
    """A launch that fails raises out of the scheduler: the worker nacks
    the eval back to the broker, and no alloc is placed by the host."""
    def failing(static_b, carry_b, xs_b):
        raise RuntimeError("place_scan launch failed: injected")

    monkeypatch.setattr(kernels, "place_scan_batched", failing)
    s = Server(ServerConfig(num_schedulers=1, deterministic=deterministic,
                            device_min_placements=0, device="cpu"))
    try:
        s.start()
        for _ in range(4):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        s.register_job(job)
        wait_for(lambda: s.workers[0].stats["nacks"] >= 1, msg="eval nacked")
        assert s.fsm.state.allocs_by_job(job.namespace, job.id, True) == []
        assert counter("nomad.tpu_engine.dispatch_fallback_host") == 0
    finally:
        s.stop()


def test_device_mesh_over_several_gpus_is_not_ported(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        Server(ServerConfig(device="cuda", device_mesh=True))


def test_device_fault_degrades_to_host_placements_equal_to_jax():
    """The port of ``tests/test_chaos.py``'s device-fault case: with every
    ``device_dispatch`` faulted (an injected ``ChaosFault``), the port's
    server places each eval on the host path, counted as
    ``dispatch_fallback_host``, and lands every task where the JAX
    server's device path does."""
    import copy

    from nomad_tpu_torch.chaos import ChaosInjector

    def run(server_cls, cfg, mock_mod, faulted):
        nodes = [mock_mod.node() for _ in range(8)]
        job = mock_mod.job()
        job.id = job.name = "web"
        job.task_groups[0].count = 16
        job.task_groups[0].tasks[0].resources.networks = []
        for i, n in enumerate(nodes):
            n.id = f"00000000-0000-4000-8000-{i:012d}"
            n.name = f"node-{i}"
            n.compute_class()
        srv = server_cls(cfg)
        inj = ChaosInjector(seed=2)
        try:
            srv.start()
            if faulted:
                inj.arm("device_dispatch", mode="fail", prob=1.0)
            for n in nodes:
                srv.register_node(copy.deepcopy(n))
            srv.register_job(job)
            wait_for(lambda: len(live_allocs(srv, job)) == 16, msg="16 allocs placed")
            assert srv.drain_evals(10.0)
            names = {n.id: n.name for n in nodes}
            return ({a.name: names[a.node_id] for a in live_allocs(srv, job)},
                    dict(srv.device_batcher.stats))
        finally:
            inj.disarm_all()
            srv.stop()

    kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
              device_min_placements=0, device_batch=8, heartbeat_min_ttl=3600.0,
              heartbeat_max_ttl=3601.0)
    jax_map, jax_stats = run(JaxServer, JaxServerConfig(**kw), jmock, False)
    before = counter("nomad.tpu_engine.dispatch_fallback_host")
    launches = kernels.LAUNCHES["place_scan"]
    host_map, host_stats = run(Server, ServerConfig(device="cpu", **kw), mock, True)
    assert jax_stats["dispatches"] > 0, "the JAX run must use the device"
    assert host_stats["dispatches"] == 0, "the faulted run must complete no dispatch"
    assert counter("nomad.tpu_engine.dispatch_fallback_host") > before
    assert kernels.LAUNCHES["place_scan"] == launches
    assert len(host_map) == 16 and host_map == jax_map
