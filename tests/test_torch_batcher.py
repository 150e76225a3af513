"""The port's DeviceBatcher (nomad_tpu_torch/tpu/batcher.py) on the CPU.

Ports of tests/test_device_batcher.py: evals of different shapes padded
into one batch give exactly what each gives alone (the padding is
inert), the pad shapes, mixed capacity dims, stop/restart, and the
scheduler and server paths through the batcher. In both arms of the
scan (int32 and float32). On the CPU the batcher runs the plain scan
eval by eval; on CUDA one kernel launch per batch (chip_smoke.py). No
tolerance: a batched eval and the same eval alone run the same
arithmetic.

Where the JAX batcher falls back to per-eval scans on a failed batch,
the port retries on the kernel only and a launch error that remains
reaches ``run()``.
"""
import copy
import random
import threading
import time

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.structs.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    SchedulerConfiguration,
    Spread,
    SpreadTarget,
)
from nomad_tpu_torch.tpu import kernels
from nomad_tpu_torch.tpu.batcher import DeviceBatcher, _Request, pad_encoded
from nomad_tpu_torch.tpu.engine import (
    EncodedEval,
    TorchPlacementEngine,
    example_scan_inputs,
)

ARMS = [np.int32, np.float32]


def synthetic_enc(n_nodes, n_tgs, n_placements, n_spreads=1, seed=0,
                  dtype=np.float32, num_dims=4):
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=n_placements,
        n_spreads=n_spreads, seed=seed, dtype=dtype, num_dims=num_dims,
    )
    return EncodedEval(
        n_real=n_nodes, n_pad=n_pad, g=n_tgs, s=static[9].shape[1],
        v=static[10].shape[2], p=n_placements, dtype=dtype,
        static=static, carry=carry, xs=xs,
        missing_list=[], nodes=[], table=None, start_ns=0,
    )


def run_concurrent(batcher, encs, timeout=60.0):
    results = [None] * len(encs)
    errors = [None] * len(encs)

    def submit(i):
        try:
            results[i] = batcher.run(encs[i])
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(encs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a run() did not return"
    return results, errors


def engine():
    return TorchPlacementEngine.shared("cpu")


def assert_same(single, batch_r, what):
    for k, name in enumerate(("chosen", "scores", "pulls", "skipped")):
        a, b = np.asarray(single[k]), np.asarray(batch_r[k])
        assert a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name} diverged under batching")


@pytest.mark.parametrize("dtype", ARMS)
def test_heterogeneous_batch_matches_single(dtype):
    """Evals of different node counts, TG counts, placement counts and
    spread shapes padded into one batch each give exactly the single-eval
    scan's output."""
    encs = [
        synthetic_enc(17, 1, 3, n_spreads=0, seed=1, dtype=dtype),
        synthetic_enc(64, 3, 16, n_spreads=1, seed=2, dtype=dtype),
        synthetic_enc(33, 2, 7, n_spreads=2, seed=3, dtype=dtype),
        synthetic_enc(8, 1, 1, n_spreads=0, seed=4, dtype=dtype),
        synthetic_enc(50, 4, 11, n_spreads=1, seed=5, dtype=dtype),
    ]
    singles = [engine().run_scan_single(e) for e in encs]
    batcher = DeviceBatcher(max_batch=len(encs), window_ms=2000.0, device="cpu")
    try:
        batched, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert errors == [None] * len(encs)
    assert batcher.stats["max_batch_seen"] == len(encs)
    assert batcher.stats["dispatches"] == 1
    for i, (single, batch_r) in enumerate(zip(singles, batched)):
        assert_same(single, batch_r, f"eval {i}")


def preempt_enc(n_nodes, n_placements, seed, c=None, variant="preempt"):
    """An int-arm EncodedEval with a candidate axis (the ``preempt`` or
    ``preempt_forced`` variant), cut to ``c`` slots per node."""
    from nomad_tpu_torch.tpu.engine import example_scan_variant

    n_pad, static, carry, xs = example_scan_variant(
        variant, n_nodes=n_nodes, n_tgs=2, n_placements=n_placements, seed=seed)
    if c is not None:
        static = static[:20] + tuple(a[:, :c] for a in static[20:])
        carry = carry[:9] + (carry[9][:, :c],) + carry[10:]
    return EncodedEval(
        n_real=n_nodes, n_pad=n_pad, g=2, s=static[9].shape[1],
        v=static[10].shape[2], p=n_placements, dtype=np.int32,
        static=static, carry=carry, xs=xs,
        missing_list=[], nodes=[], table=None, start_ns=0)


def test_mixed_preemption_batch_matches_single():
    """Evals with no candidate axis (C = 0), with C = 5 and with C = 16,
    and a system preempt pass, in one batch: each gives exactly its
    single run, the evict column included (widened to the batch's C with
    -1 in the slots it does not have)."""
    encs = [
        synthetic_enc(40, 2, 9, seed=11, dtype=np.int32),
        preempt_enc(48, 12, seed=12, c=5),
        preempt_enc(30, 7, seed=13),
        synthetic_enc(20, 1, 4, n_spreads=0, seed=14, dtype=np.int32),
        preempt_enc(36, 10, seed=15, variant="preempt_forced"),
    ]
    singles = [engine().run_scan_single(e) for e in encs]
    batcher = DeviceBatcher(max_batch=len(encs), window_ms=2000.0, device="cpu")
    try:
        batched, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert errors == [None] * len(encs)
    assert batcher.stats["dispatches"] == 1
    evicting = 0
    for i, (single, batch_r) in enumerate(zip(singles, batched)):
        assert_same(single, batch_r, f"eval {i}")
        own, wide = np.asarray(single[4]), np.asarray(batch_r[4])
        assert wide.shape == (encs[i].p, 16)
        np.testing.assert_array_equal(wide[:, :own.shape[1]], own)
        assert (wide[:, own.shape[1]:] == -1).all()
        evicting += int((own >= 0).any())
    assert evicting == 3


@pytest.mark.parametrize("dtype", ARMS)
def test_uneven_batch_padding(dtype):
    """3 evals -> batch padded to 8; the inert pad copies do not perturb
    real results."""
    encs = [synthetic_enc(24, 2, 5, seed=s, dtype=dtype) for s in (7, 8, 9)]
    singles = [engine().run_scan_single(e) for e in encs]
    batcher = DeviceBatcher(max_batch=8, window_ms=2000.0, device="cpu")
    try:
        batched, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert errors == [None] * 3
    assert batcher.stats["dispatches"] == 1
    assert batcher.stats["padded_evals"] == 5  # 3 -> max_batch 8
    for single, batch_r in zip(singles, batched):
        assert_same(single, batch_r, "padded batch")


def test_pad_encoded_shapes():
    enc = synthetic_enc(10, 2, 4, n_spreads=1, seed=0)
    static, carry, xs = pad_encoded(
        enc, n_pad=32, g_pad=4, s_pad=2, v_pad=8, p_pad=8, dtype=np.float32,
    )
    d = enc.static[0].shape[1]
    assert static[0].shape == (32, d)          # totals
    assert static[0].dtype == np.float32
    assert static[3].shape == (4, 32)          # feat_packed (uint8 lanes)
    assert static[9].shape == (4, 2, 32)       # spread_vids
    assert static[10].shape == (4, 2, 8)       # spread_desired
    assert carry[6].shape == (4,)              # failed
    assert carry[6][enc.g:].all()              # padded TGs pre-failed
    assert xs[0].shape == (8,)
    assert (xs[0][enc.p:] == enc.g).all()      # padded steps -> failed TG
    assert (static[9] <= 7).all()              # remapped invalid vocab bucket
    assert (static[9][:, :, enc.n_pad:] == 7).all()


@pytest.mark.parametrize("dtype", ARMS)
def test_mixed_capacity_dims_batch(dtype):
    """A device job (6 capacity dims) co-batched with a deviceless job (4
    dims): D pads across the batch and results equal the single scans."""
    lean = synthetic_enc(24, 2, 5, seed=31, dtype=dtype)
    assert lean.static[0].shape[1] == 4
    wide = synthetic_enc(24, 2, 5, seed=32, dtype=dtype, num_dims=6)
    wide.static[0][:, 4] = 2  # 2 free devices per node on dim 4
    wide.static[2][:, 4] = 1  # each placement takes one
    singles = [engine().run_scan_single(e) for e in (lean, wide)]
    batcher = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu")
    try:
        batched, errors = run_concurrent(batcher, [lean, wide])
    finally:
        batcher.stop()
    assert errors == [None, None]
    for single, batch_r in zip(singles, batched):
        assert_same(single, batch_r, "mixed dims")


def test_int_and_float_evals_never_share_a_launch():
    """A gather holding both arms splits into dtype-homogeneous batches."""
    encs = [synthetic_enc(16, 1, 3, seed=1, dtype=np.int32),
            synthetic_enc(16, 1, 3, seed=2, dtype=np.float32)]
    singles = [engine().run_scan_single(e) for e in encs]
    batcher = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu")
    try:
        batched, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert errors == [None, None]
    assert batcher.stats["gathers"] == 1 and batcher.stats["dispatches"] == 2
    for single, batch_r in zip(singles, batched):
        assert_same(single, batch_r, "split batch")


def test_stop_errors_parked_requests():
    """stop() releases requests already sitting in the queue with an
    error instead of leaving them hanging."""
    batcher = DeviceBatcher(max_batch=4, window_ms=50.0, device="cpu")
    req = _Request(synthetic_enc(8, 1, 1, seed=0))
    batcher._queue.put(req)
    batcher.stop()
    assert req.event.is_set()
    assert isinstance(req.error, RuntimeError)


def test_run_after_stop_restarts_lazily():
    batcher = DeviceBatcher(max_batch=4, window_ms=50.0, device="cpu")
    batcher._ensure_started()
    batcher.stop()
    try:
        out = batcher.run(synthetic_enc(8, 1, 1, seed=0))
        assert out[0].shape == (1,)
        assert batcher.has_warmed()
    finally:
        batcher.stop()


def test_launch_error_reaches_run(monkeypatch):
    """A launch that fails, in the batch and again in the per-eval retry,
    raises out of every waiting run(): nothing is placed elsewhere."""
    calls = []

    def failing(static_b, carry_b, xs_b):
        calls.append(static_b[0].shape[0])
        raise RuntimeError("place_scan launch failed: injected")

    monkeypatch.setattr(kernels, "place_scan_batched", failing)
    encs = [synthetic_enc(16, 1, 2, seed=s) for s in (0, 1)]
    batcher = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu")
    try:
        results, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert results == [None, None]
    assert all(isinstance(e, RuntimeError) and "injected" in str(e) for e in errors)
    assert calls == [2, 1, 1]  # the batch, then one retry per eval
    assert not batcher.has_warmed()


def test_failed_batch_retries_each_eval_on_the_kernel():
    """A poisoned co-batched eval does not fail its companion: the
    dispatcher retries each request alone through the same scan, and
    only the poisoned one gets an error."""
    good = synthetic_enc(16, 1, 2, seed=0)
    bad = synthetic_enc(16, 1, 2, seed=1)
    bad.static = bad.static[:-1]  # drop an array: the stacked batch raises
    single = engine().run_scan_single(good)
    batcher = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu")
    try:
        results, errors = run_concurrent(batcher, [good, bad])
    finally:
        batcher.stop()
    assert errors[0] is None, f"good eval failed: {errors[0]}"
    assert_same(single, results[0], "retried eval")
    assert errors[1] is not None


def make_nodes(num, seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(num):
        n = mock.node()
        n.id = f"{seed:04d}0000-0000-4000-8000-{i:012d}"
        n.name = f"node-{i}"
        n.node_resources.cpu_shares = rng.choice([2000, 4000, 8000])
        n.node_resources.memory_mb = rng.choice([4096, 8192, 16384])
        n.attributes["rack"] = f"r{rng.randint(0, 3)}"
        n.compute_class()
        nodes.append(n)
    return nodes


def scheduler_plans(nodes, jobs, batcher=None, deterministic=True):
    h = Harness(device="cpu")
    if batcher is not None:
        h.device_batcher = batcher
    h.state.scheduler_set_config(
        h.next_index(), SchedulerConfiguration(scheduler_algorithm="tpu_binpack"))
    for n in nodes:
        h.state.upsert_node(h.next_index(), copy.deepcopy(n))
    for job in jobs:
        h.state.upsert_job(h.next_index(), copy.deepcopy(job))
    random.seed(3)
    for job in jobs:
        ev = Evaluation(priority=job.priority, type=job.type,
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        job_id=job.id, namespace=job.namespace)
        h.process("service", ev, deterministic=deterministic)
    out = {}
    for plan in h.plans:
        for node_id, allocs in plan.node_allocation.items():
            for a in allocs:
                out[(a.job_id, a.name)] = node_id
    for plan in h.plans:
        for block in plan.dense_placements:
            for name, node_id in zip(block.names, block.node_ids):
                out[(block.job_id, name)] = node_id
    return out


@pytest.mark.parametrize("deterministic", [True, False])
def test_scheduler_plans_identical_via_batcher(deterministic):
    """The scheduler routed through the DeviceBatcher gives the same
    plans as the direct single-scan engine path."""
    nodes = make_nodes(30, seed=42)
    jobs = []
    for i in range(4):
        job = mock.job()
        job.id = f"job-batch-{i}"
        job.task_groups[0].count = 3
        if i % 2:
            job.task_groups[0].spreads = [Spread(
                attribute="${meta.rack}", weight=50,
                spread_target=[SpreadTarget(value="r0", percent=50),
                               SpreadTarget(value="r1", percent=50)],
            )]
        jobs.append(job)
    direct = scheduler_plans(nodes, jobs, None, deterministic)
    batcher = DeviceBatcher(max_batch=4, window_ms=5.0, device="cpu")
    try:
        via_batcher = scheduler_plans(nodes, jobs, batcher, deterministic)
    finally:
        batcher.stop()
    assert direct == via_batcher
    assert len(via_batcher) == sum(j.task_groups[0].count for j in jobs)
    assert batcher.stats["evals"] == len(jobs)


@pytest.mark.parametrize("deterministic", [True, False])
def test_concurrent_evals_share_device_dispatch(deterministic):
    """N concurrent evals on a running server are placed through fewer
    batched launches than evals, with every allocation placed."""
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker

    # The gather window is the server's default (2,000 ms): the
    # demand-aware gather then holds for every encode the workers have
    # announced. A 25 ms window closes before a second worker's encode
    # arrives when encodes finish more than 25 ms apart (a loaded host,
    # the int arm's slower encode), and every launch then carries one
    # eval.
    server = Server(ServerConfig(
        num_schedulers=0, device_batch=8, device_batch_window_ms=2000.0,
        device_min_placements=0, deterministic=deterministic, device="cpu",
    ))
    try:
        server.start()
        for i in range(12):
            n = mock.node()
            n.name = f"srv-node-{i}"
            n.compute_class()
            server.register_node(n)
        # enqueue all evals BEFORE workers exist so the flood hits the
        # broker at once
        jobs = []
        for i in range(8):
            job = mock.job()
            job.id = f"batched-job-{i}"
            job.task_groups[0].count = 2
            jobs.append(job)
            server.register_job(job)
        for i in range(4):
            w = Worker(server, i)
            server.workers.append(w)
            w.start()

        def placed():
            return sum(1 for j in jobs
                       for _ in server.fsm.state.allocs_by_job("default", j.id, True))

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and placed() < 16:
            time.sleep(0.05)
        assert placed() == 16, f"only {placed()}/16 allocs placed"
        stats = server.device_batcher.stats
        assert stats["evals"] >= 8
        assert stats["max_batch_seen"] >= 2, f"no eval batching observed: {stats}"
        assert stats["dispatches"] < stats["evals"], stats
    finally:
        server.stop()
