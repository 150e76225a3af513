"""The port's eval axis (nomad_tpu_torch/parallel/sharding.py and
``DeviceBatcher(mesh=...)``) on the CPU, against the JAX package's mesh.

The port's mesh is a grid of ``torch.device``s; here every entry is
``"cpu"``, so each shard runs the plain scan, eval by eval, as one shard
launch (``kernels.place_scan_batched_packed``) would on a card. Held:
``make_mesh``'s grid equal to the reference's for every device count and
``eval_parallel`` up to 8 (the reference on its 8-device CPU mesh); the
sharding table equal to the reference's ``PartitionSpec``s and to the
packed slab's axes; an eval-sharded batch equal bit for bit to the
unsharded single scans and to the JAX package's mesh-sharded batch (int
arm; float arm within ``tpu/parity.py``'s bound); a mesh with a node
axis builds, its ``n_pad`` and node slices as ``node_slices`` gives; a
port ``Server`` with ``device_mesh=True`` places a C1M-shaped mix as the
JAX server with ``device_mesh=True`` does.
"""
import contextlib
import random
import threading

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
import nomad_tpu.structs.structs as jstructs
import nomad_tpu.tpu.batcher as jbatcher
import nomad_tpu.tpu.engine as jengine
from nomad_tpu.parallel import batched_scan_shardings as jax_shardings
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

import nomad_tpu_torch.structs.structs as tstructs
from nomad_tpu_torch import mock
from nomad_tpu_torch.parallel import (
    batched_place_scan, batched_scan_shardings, make_mesh, node_slices)
from nomad_tpu_torch.parallel import sharding
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.structs import ALLOC_DESIRED_RUN
from nomad_tpu_torch.tpu import kernels, parity
from nomad_tpu_torch.tpu.batcher import DeviceBatcher, batch_dims, pack_batch, pack_node_shards
from nomad_tpu_torch.tpu.convert import HostSlab
from nomad_tpu_torch.tpu.engine import EncodedEval, TorchPlacementEngine, example_scan_inputs

CPUS = [torch.device("cpu")] * 8


def cpu_mesh(n, eval_parallel):
    return make_mesh(n, eval_parallel=eval_parallel, devices=CPUS)


def synthetic_enc(n_nodes, n_tgs, n_placements, n_spreads=1, seed=0, dtype=np.float32):
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=n_placements,
        n_spreads=n_spreads, seed=seed, dtype=dtype)
    return EncodedEval(
        n_real=n_nodes, n_pad=n_pad, g=n_tgs, s=static[9].shape[1],
        v=static[10].shape[2], p=n_placements, dtype=dtype,
        static=static, carry=carry, xs=xs,
        missing_list=[], nodes=[], table=None, start_ns=0)


def jax_enc(e):
    """The same numpy arrays as a JAX package ``EncodedEval``."""
    return jengine.EncodedEval(
        n_real=e.n_real, n_pad=e.n_pad, g=e.g, s=e.s, v=e.v, p=e.p, dtype=e.dtype,
        static=e.static, carry=e.carry, xs=e.xs, missing_list=[], nodes=[], table=None,
        start_ns=0)


def run_concurrent(batcher, encs, timeout=300.0):
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


def assert_same(ref, got, what):
    for k, name in enumerate(("chosen", "scores", "pulls", "skipped", "evict")):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name} diverged")


class LaunchSpy:
    """Counts the shard launches (``kernels.place_scan_batched_packed``)
    and the B each was given."""

    def __init__(self, monkeypatch):
        self.bs = []
        orig = kernels.place_scan_batched_packed

        def spy(packed, cs=None):
            self.bs.append(packed.dims["B"])
            return orig(packed, cs)

        monkeypatch.setattr(kernels, "place_scan_batched_packed", spy)


# -- the grid and the table -------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_grid_equals_the_reference(n):
    import jax

    assert len(jax.devices()) >= 8
    for ep in range(0, 10):
        ref = jax_make_mesh(n, eval_parallel=ep)
        got = cpu_mesh(n, ep)
        assert dict(got.shape) == dict(ref.shape), (n, ep)
        assert list(got.shape) == list(ref.shape) == ["evals", "nodes"]
        assert got.devices.shape == ref.devices.shape, (n, ep)


def test_make_mesh_defaults_to_the_visible_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh(eval_parallel=4)
    assert dict(mesh.shape) == {"evals": 4, "nodes": 1}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [str(d) for d in make_mesh(2, eval_parallel=2).devices.flat] == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert sharding.visible_devices("cuda") == []
    assert sharding.visible_devices("cpu") == [torch.device("cpu")]


def test_shardings_equal_the_reference_and_the_slab():
    """Each spec equals the reference's ``PartitionSpec``, entry by entry;
    on a packed batch the ``evals`` axis is the batch and every ``nodes``
    axis is the batch's padded node count."""
    ref = jax_shardings(jax_make_mesh(8, eval_parallel=2))
    got = batched_scan_shardings(cpu_mesh(8, 2))
    encs = [synthetic_enc(40, 2, 5, seed=s, dtype=np.int32) for s in (1, 2, 3)]
    dims = batch_dims(encs)
    parts = pack_batch(encs, dims, 4, "cpu").parts()
    assert [len(p) for p in got] == [len(p) for p in parts] == [len(p) for p in ref]
    for rp, gp in zip(ref, got):
        for r, g in zip(rp, gp):
            assert tuple(r.spec) == g
    shapes = [tuple(t.shape) for part in parts for t in part]
    specs = [s for part in got for s in part]
    assert len(shapes) == len(specs) == 48
    for k, (shape, spec) in enumerate(zip(shapes, specs)):
        assert len(shape) == len(spec), k
        assert spec[0] == "evals" and shape[0] == 4, k
        for size, axis in zip(shape, spec):
            if axis == "nodes" and size:
                assert size == dims["n_pad"], (k, shape, spec)


# -- the eval-sharded batch ---------------------------------------------------


CASES = {
    # tests/test_device_batcher.py:170-190, in the port's float32 arm
    "small": (lambda: [synthetic_enc(32, 2, 6, seed=s) for s in (11, 12)], (4, 2), 2),
    # tests/test_device_batcher.py:192-215: C1M-shaped, int32
    "c1m": (lambda: [synthetic_enc(512, 2, 48, n_spreads=1, seed=100 + s, dtype=np.int32)
                     for s in range(4)], (8, 2), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_batch_equals_single_scans_and_the_jax_mesh(case, monkeypatch):
    """On a mesh of four CPU entries, (4, 1): one batch, one shard launch
    per group holding a real eval (each with B = 1), the results in eval
    order equal to each eval's unsharded single scan bit for bit, and to
    the JAX package's mesh-sharded batch (the reference's own grid)."""
    make, (jn, jep), launches = CASES[case]
    encs = make()
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    spy = LaunchSpy(monkeypatch)
    mesh = cpu_mesh(4, 4)
    assert dict(mesh.shape) == {"evals": 4, "nodes": 1}
    ours = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu", mesh=mesh)
    try:
        got, errors = run_concurrent(ours, encs)
    finally:
        ours.stop()
    assert errors == [None] * len(encs)
    assert ours.stats["dispatches"] == 1 and ours.stats["padded_evals"] == 4 - len(encs)
    assert spy.bs == [1] * launches
    assert ours.stats_snapshot()["device_dispatches"] == {"cpu": launches}
    for i, (single, g) in enumerate(zip(singles, got)):
        assert_same(single, g, f"eval {i} sharded against its single scan")

    theirs = jbatcher.DeviceBatcher(max_batch=4, window_ms=2000.0,
                                    mesh=jax_make_mesh(jn, eval_parallel=jep))
    try:
        ref, jerrors = run_concurrent(theirs, [jax_enc(e) for e in encs])
    finally:
        theirs.stop()
    assert jerrors == [None] * len(encs)
    assert theirs.stats["dispatches"] == 1
    for i, (r, g) in enumerate(zip(ref, got)):
        if encs[i].dtype == np.int32:
            assert_same(r, g, f"eval {i} against the JAX mesh batch")
        else:
            parity.check_float_scan(((), tuple(r[:4])), ((), tuple(g[:4])),
                                    encs[i].xs[0][: encs[i].p], f"eval {i}")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_batched_place_scan_splits_launches_and_gathers(dtype, monkeypatch):
    """``batched_place_scan(mesh)``: five evals on a (2, 1) mesh run as
    two shard launches of three slots each (the batch rounds up to six),
    gathered back in eval order without the filler."""
    encs = [synthetic_enc(24 + 8 * s, 1 + s % 3, 4 + s, seed=20 + s, dtype=dtype)
            for s in range(5)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    spy = LaunchSpy(monkeypatch)
    out = batched_place_scan(cpu_mesh(2, 2))(encs)
    assert spy.bs == [3, 3]
    assert all(a.shape[0] == 5 for a in out)
    for i, single in enumerate(singles):
        p = encs[i].p
        assert_same(single, [a[i, :p] for a in out], f"eval {i}")


@pytest.mark.parametrize("ep", [None, 2])
def test_a_batch_times_its_packing_outside_the_device_phase(ep, monkeypatch):
    """With a mesh or without one (a one-entry mesh of the batcher's
    device) a batch runs through the same shard launcher: one launch a
    shard, counted by device, each result equal to its single scan, and
    the ``device`` phase (copy in, launch, synchronize, copy back) never
    covers the slab write (``pad_stack``)."""
    from nomad_tpu_torch.utils import phases

    encs = [synthetic_enc(64, 2, 8, seed=30 + s, dtype=np.int32) for s in range(4)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    spy = LaunchSpy(monkeypatch)
    monkeypatch.setattr(phases, "_COALESCE_GAP", 0.0)
    b = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu",
                      mesh=None if ep is None else cpu_mesh(ep, ep))
    phases.enable()
    try:
        got, errors = run_concurrent(b, encs)
        spans = {k: phases._merged(v, float("-inf"), float("inf"))
                 for k, v in phases._intervals.items()}
    finally:
        phases.disable()
        b.stop()
    assert errors == [None] * len(encs)
    shards = ep or 1
    assert b.stats["dispatches"] == 1
    assert spy.bs == [len(encs) // shards] * shards
    assert b.stats_snapshot()["device_dispatches"] == {"cpu": shards}
    assert spans["pad_stack"] and spans["device"]
    assert phases._intersect_len(spans["pad_stack"], spans["device"]) == 0.0
    for i, (single, g) in enumerate(zip(singles, got)):
        assert_same(single, g, f"eval {i}")


def test_node_axis_raises_when_the_batcher_is_built():
    """The name is kept from when a node axis raised here: both builds
    now succeed (the node axis is ported; ``tests/test_torch_nodes.py``
    holds its results), and the batcher rounds ``n_pad`` up to a
    multiple of ``nodes`` and splits it as ``node_slices`` gives."""
    mesh = cpu_mesh(4, 2)
    assert dict(mesh.shape) == {"evals": 2, "nodes": 2}
    assert callable(batched_place_scan(mesh))
    mesh3 = make_mesh(6, eval_parallel=2, devices=CPUS[:6])
    assert dict(mesh3.shape) == {"evals": 2, "nodes": 3}
    encs = [synthetic_enc(100, 2, 5, seed=s, dtype=np.int32) for s in (1, 2)]
    for m, nodes in ((mesh, 2), (mesh3, 3)):
        launcher = DeviceBatcher(device="cpu", mesh=m)._shards
        assert (launcher.ep, launcher.nodes) == (2, nodes)
        dims = batch_dims(encs, nodes)
        assert dims["n_pad"] == -(-128 // nodes) * nodes
        shards = pack_node_shards(encs, dims, 2, launcher.grid[0], HostSlab(pin=False),
                                  [HostSlab(pin=False) for _ in range(nodes)],
                                  [contextlib.nullcontext() for _ in range(nodes)])
        assert [(sh.lo, sh.lo + sh.dims["N"]) for sh in shards] == node_slices(dims["n_pad"],
                                                                              nodes)


def test_a_failed_shard_fails_the_batch_as_one_batch(monkeypatch):
    """A shard launch that raises fails the whole batch, which is retried
    eval by eval through the shards; an error that remains reaches each
    ``run()``. Nothing runs unsharded."""
    encs = [synthetic_enc(20, 1, 3, seed=s, dtype=np.int32) for s in (1, 2, 3)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    orig = kernels.place_scan_batched_packed
    calls = []

    def second_fails(packed, cs=None):
        calls.append(packed.dims["B"])
        if len(calls) == 2:
            raise RuntimeError("shard launch failed")
        return orig(packed, cs)

    monkeypatch.setattr(kernels, "place_scan_batched_packed", second_fails)
    b = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu", mesh=cpu_mesh(2, 2))
    try:
        got, errors = run_concurrent(b, encs)
    finally:
        b.stop()
    assert errors == [None] * 3
    # the batch (two shards of two), then each eval alone (one launch each)
    assert calls == [2, 2, 1, 1, 1]
    for single, g in zip(singles, got):
        assert_same(single, g, "retried eval")

    def always_fails(packed, cs=None):
        raise RuntimeError("shard launch failed")

    monkeypatch.setattr(kernels, "place_scan_batched_packed", always_fails)
    b = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu", mesh=cpu_mesh(2, 2))
    try:
        got, errors = run_concurrent(b, encs)
    finally:
        b.stop()
    assert got == [None] * 3
    assert all(isinstance(e, RuntimeError) and "shard launch failed" in str(e)
               for e in errors)


# -- the server -----------------------------------------------------------------


N_FLEET = 64


def c1m_fleet(pkg_mock):
    """A C1M-shaped fleet (bench.py's seeded capacities), cut to 64 nodes."""
    rng = np.random.default_rng(7)
    nodes = []
    for i in range(N_FLEET):
        n = pkg_mock.node()
        n.id = f"00000000-0000-4000-8000-{i:012d}"
        n.name = f"bench-{i}"
        n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
        n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
        n.compute_class()
        nodes.append(n)
    return nodes


def c1m_mix(pkg_mock, structs):
    """bench.py c1m_mixed_jobs' templates 0 (service with spread and
    affinity), 10 (service) and 28 (batch), counts cut to fit the fleet."""
    jobs = []
    for t, kind, cpu, mem, count, stanzas in ((0, "service", 8, 16, 90, True),
                                              (10, "service", 16, 48, 70, False),
                                              (28, "batch", 8, 16, 60, False)):
        j = pkg_mock.job() if kind == "service" else pkg_mock.batch_job()
        j.id = f"c1m-{t}"
        tg = j.task_groups[0]
        tg.count = count
        tg.ephemeral_disk.size_mb = 50
        tg.tasks[0].resources = structs.Resources(cpu=cpu, memory_mb=mem)
        if stanzas:
            tg.spreads = [structs.Spread(
                attribute="${node.datacenter}", weight=50,
                spread_target=[structs.SpreadTarget(value="dc1", percent=100)])]
            tg.affinities = [structs.Affinity(
                ltarget="${attr.kernel.name}", rtarget="linux", operand="=", weight=50)]
        jobs.append(j)
    return jobs


def place_mix(server_cls, cfg, pkg_mock, structs):
    nodes, jobs = c1m_fleet(pkg_mock), c1m_mix(pkg_mock, structs)
    srv = server_cls(cfg)
    try:
        mesh = srv.device_batcher.mesh
        srv.start()
        for n in nodes:
            srv.register_node(n)
        random.seed(3)
        for job in jobs:
            srv.register_job(job)
        assert srv.drain_evals(240.0)
        names = {n.id: n.name for n in nodes}
        placed = {(j.id, a.name): names[a.node_id] for j in jobs
                  for a in srv.fsm.state.allocs_by_job(j.namespace, j.id, True)
                  if a.desired_status == ALLOC_DESIRED_RUN}
        return placed, mesh, srv.device_batcher.stats
    finally:
        srv.stop()


def test_mesh_server_places_as_the_jax_mesh_server(monkeypatch):
    """``device_mesh=True`` and ``device_batch`` 8 with eight devices
    (the port's device list patched to eight CPU entries; the JAX server
    on its 8-device CPU mesh): both grids are (8, 1), and the int arm
    places the C1M-shaped mix on the same nodes."""
    monkeypatch.setattr(sharding, "visible_devices", lambda kind="cuda": list(CPUS))
    kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
              pipeline_async=False, device_min_placements=0, device_mesh=True,
              device_batch=8)
    ref, jmesh, _ = place_mix(JaxServer, JaxServerConfig(**kw), jmock, jstructs)
    got, mesh, stats = place_mix(Server, ServerConfig(device="cpu", **kw), mock, tstructs)
    assert dict(jmesh.shape) == dict(mesh.shape) == {"evals": 8, "nodes": 1}
    assert stats["device_dispatches"].get("cpu", 0) >= 3
    assert len(got) == sum(j.task_groups[0].count for j in c1m_mix(mock, tstructs))
    assert got == ref
