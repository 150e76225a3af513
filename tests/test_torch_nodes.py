"""The port's node axis (``parallel.sharding.node_slices``,
``tpu/node_shard.py``, ``kernels.place_scan_nodes_phase`` and the node
shards of ``tpu.batcher.ShardLauncher``) on the CPU, against the JAX
package's ("evals", "nodes") mesh and the port's unsharded scans.

Every mesh entry here is ``"cpu"``: a node shard runs the plain version
of the node-sharded scan, its three per-step exchanges copied between
the shards' gathered partial buffers between phases, as the card's
launches are ordered. Held: the reference's C1M-slice case over a
(2, 4) mesh equal bit for bit to the JAX ``DeviceBatcher`` over its
(2, 4) mesh on the 8-device CPU mesh and to the port's unsharded scans
(int arm; float arm within ``tpu/parity.py`` of the JAX batch and bit
for bit against the port's unsharded scans); node counts 2 and 4 over a
shard with no real node, a ring offset in a later shard, a limit window
across shards, a forced node of another shard and ``has_pre`` with its
evictions, bit for bit against the unsharded plain scan (the last also
against the JAX engine); a port ``Server`` whose mesh has a node axis
placing as the JAX mesh server; a failed node shard failing its batch.
"""
import threading

import numpy as np
import pytest
import torch

import nomad_tpu.mock as jmock
import nomad_tpu.structs.structs as jstructs
import nomad_tpu.tpu.batcher as jbatcher
import nomad_tpu.tpu.engine as jengine
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

import nomad_tpu_torch.structs.structs as tstructs
from nomad_tpu_torch import mock
from nomad_tpu_torch.parallel import batched_place_scan, make_mesh, node_slices, sharding
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.tpu import convert, engine, kernels, node_shard, parity, step
from nomad_tpu_torch.tpu.batcher import DeviceBatcher, ShardLauncher, batch_dims
from nomad_tpu_torch.tpu.engine import EncodedEval, TorchPlacementEngine, example_scan_inputs

CPUS = [torch.device("cpu")] * 8
NAMES = ("chosen", "scores", "pulls", "skipped", "evict")


def cpu_mesh(n, eval_parallel):
    return make_mesh(n, eval_parallel=eval_parallel, devices=CPUS)


def enc_of(n_pad, static, carry, xs, n_real, dtype):
    return EncodedEval(
        n_real=n_real, n_pad=n_pad, g=static[2].shape[0], s=static[9].shape[1],
        v=static[10].shape[2], p=xs[0].shape[0], dtype=dtype, static=static, carry=carry,
        xs=xs, missing_list=[], nodes=[], table=None, start_ns=0)


def synthetic_enc(n_nodes, n_tgs, n_placements, n_spreads=1, seed=0, dtype=np.float32):
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=n_placements,
        n_spreads=n_spreads, seed=seed, dtype=dtype)
    return enc_of(n_pad, static, carry, xs, n_nodes, dtype)


def variant_enc(variant, n_nodes, n_placements=24, seed=3, dtype=np.int32):
    n_pad, static, carry, xs = engine.example_scan_variant(
        variant, n_nodes=n_nodes, n_tgs=3, n_placements=n_placements, seed=seed, dtype=dtype)
    return enc_of(n_pad, static, carry, xs, n_nodes, dtype)


def jax_enc(e):
    return jengine.EncodedEval(
        n_real=e.n_real, n_pad=e.n_pad, g=e.g, s=e.s, v=e.v, p=e.p, dtype=e.dtype,
        static=e.static, carry=e.carry, xs=e.xs, missing_list=[], nodes=[], table=None,
        start_ns=0)


def run_concurrent(batcher, encs, timeout=300.0):
    results, errors = [None] * len(encs), [None] * len(encs)

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


def assert_same(ref, got, what, names=NAMES):
    for k, name in enumerate(names):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name} diverged")


class PhaseSpy:
    """Counts the node-sharded phase calls by (shard, phase) and any K3
    launch (``place_scan_batched_packed``), which must not run."""

    def __init__(self, monkeypatch):
        self.phases, self.k3 = [], []
        orig = kernels.place_scan_nodes_phase

        def spy(sh, phase, p):
            self.phases.append((sh.shard, phase, p, sh.dims["B"], sh.dims["N"]))
            return orig(sh, phase, p)

        monkeypatch.setattr(kernels, "place_scan_nodes_phase", spy)
        monkeypatch.setattr(kernels, "place_scan_batched_packed",
                            lambda *a, **k: self.k3.append(1))


# -- the reference's case -----------------------------------------------------


C1M = {
    # tests/test_device_batcher.py:193-230: 512 nodes, 2 TGs, 48
    # placements, 1 spread, seeds 100-103
    np.int32: lambda: [synthetic_enc(512, 2, 48, n_spreads=1, seed=100 + s, dtype=np.int32)
                       for s in range(4)],
    np.float32: lambda: [synthetic_enc(512, 2, 48, n_spreads=1, seed=100 + s,
                                       dtype=np.float32) for s in range(4)],
}


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int32", "float32"])
def test_c1m_slice_over_a_2x4_mesh_equals_the_jax_mesh_batcher(dtype, monkeypatch):
    """The reference's ``test_mesh_sharded_c1m_slice_bit_identical`` on
    the port: one batch over ("evals": 2, "nodes": 4), each eval group's
    512 nodes in four slices of 128. It equals the port's unsharded
    single scans bit for bit (both arms: no float sum crosses shards) and
    the JAX ``DeviceBatcher`` over its (2, 4) mesh (int bit for bit;
    float within ``tpu/parity.py``). No K3 launch runs: every step is
    three phases on each of the four shards of each group."""
    encs = C1M[dtype]()
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    spy = PhaseSpy(monkeypatch)
    mesh = cpu_mesh(8, 2)
    assert dict(mesh.shape) == {"evals": 2, "nodes": 4}
    ours = DeviceBatcher(max_batch=4, window_ms=2000.0, device="cpu", mesh=mesh)
    try:
        got, errors = run_concurrent(ours, encs)
    finally:
        ours.stop()
    assert errors == [None] * 4
    assert ours.stats["dispatches"] == 1
    assert ours.stats_snapshot()["device_dispatches"] == {"cpu": 8}
    assert spy.k3 == []
    p_pad = batch_dims(encs, 4)["p_pad"]
    # 2 groups x 4 shards x (3 phases a step + the last step's phase A)
    assert len(spy.phases) == 2 * 4 * (3 * p_pad + 1)
    assert {(s, n) for s, _ph, _p, _b, n in spy.phases} == {(s, 128) for s in range(4)}
    for i, (single, g) in enumerate(zip(singles, got)):
        assert_same(single, g, f"eval {i} node-sharded against its single scan")

    theirs = jbatcher.DeviceBatcher(max_batch=4, window_ms=2000.0,
                                    mesh=jax_make_mesh(8, eval_parallel=2))
    try:
        ref, jerrors = run_concurrent(theirs, [jax_enc(e) for e in encs])
    finally:
        theirs.stop()
    assert jerrors == [None] * 4
    assert theirs.stats["dispatches"] == 1
    for i, (r, g) in enumerate(zip(ref, got)):
        if dtype == np.int32:
            assert_same(r, g, f"eval {i} against the JAX mesh batch", NAMES[:4])
        else:
            parity.check_float_scan(((), tuple(r[:4])), ((), tuple(g[:4])),
                                    encs[i].xs[0][: encs[i].p], f"eval {i}")


# -- the plain version's edge cases --------------------------------------------


def _offset_late(nodes):
    """The ring offset inside the last shard: the window wraps from the
    last shard into the first."""
    e = synthetic_enc(100, 2, 20, seed=41, dtype=np.int32)
    carry = list(e.carry)
    carry[5] = np.int32(93)
    return enc_of(e.n_pad, e.static, tuple(carry), e.xs, e.n_real, np.int32)


def _window_across(nodes):
    """A limit window of 6 from two nodes before a slice's end: its
    candidates lie in two shards (and, with many low scores skipped,
    further)."""
    e = synthetic_enc(120, 2, 24, seed=42, dtype=np.int32)
    per = e.n_pad // nodes
    carry, xs = list(e.carry), list(e.xs)
    carry[5] = np.int32(per - 2)
    xs[5] = np.full_like(xs[5], 6)
    return enc_of(e.n_pad, e.static, tuple(carry), tuple(xs), e.n_real, np.int32)


def _forced_elsewhere(nodes):
    """Every step forced onto a node of the last shard."""
    e = variant_enc("forced", 100)
    xs = list(e.xs)
    per = e.n_pad // nodes
    fn = np.asarray(xs[9]).copy()
    fn[:, 0] = np.where(np.arange(fn.shape[0]) % 3 == 2, -1,
                        (nodes - 1) * per + np.arange(fn.shape[0]) % 4)
    xs[9] = fn.astype(np.int32)
    return enc_of(e.n_pad, e.static, e.carry, tuple(xs), e.n_real, np.int32)


EDGE_CASES = {
    "offset_in_a_later_shard": _offset_late,
    "limit_window_across_shards": _window_across,
    "forced_node_of_another_shard": _forced_elsewhere,
    "has_pre": lambda nodes: variant_enc("preempt", 100),
    "has_pre_forced": lambda nodes: variant_enc("preempt_forced", 100),
    "all_branches": lambda nodes: variant_enc("all", 100),
}


@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_node_shards_equal_the_unsharded_plain_scan(case, nodes):
    """``node_shard.place_scan_nodes`` over ``nodes`` shards: outputs and
    final carry equal to ``step.place_scan`` bit for bit, and the same
    eval through ``batched_place_scan`` over a (1, nodes) mesh equal to
    it too."""
    enc = EDGE_CASES[case](nodes)
    s, c, x = convert.scan_inputs_to_torch(enc.static, enc.carry, enc.xs, "cpu")
    stats = {}
    ref = step.place_scan(enc.n_pad, s, c, x, stats)
    got = node_shard.place_scan_nodes(enc.n_pad, s, c, x, nodes)
    assert_same(ref[1], got[1], f"{case} over {nodes} shards")
    for i, (a, b) in enumerate(zip(ref[0], got[0])):
        assert a.dtype == b.dtype and torch.equal(a, b), (case, nodes, "carry", i)
    if case.startswith("has_pre"):
        assert int((ref[1][4] >= 0).any(dim=1).sum()) >= 1, "no step evicted"
    out = batched_place_scan(cpu_mesh(nodes, 1))([enc])
    assert_same([y.numpy() for y in ref[1]], [a[0, :enc.p] for a in out], f"{case} batched")


@pytest.mark.parametrize("nodes", [2, 4])
def test_a_shard_with_no_real_node(nodes):
    """A batch of an 8-node eval and a 100-node eval pads both to 128
    nodes: the small eval's later shards hold no real node, and each
    eval equals its unsharded scan."""
    encs = [synthetic_enc(5, 2, 12, seed=51, dtype=np.int32),
            synthetic_enc(100, 2, 16, seed=52, dtype=np.int32)]
    dims = batch_dims(encs, nodes)
    assert dims["n_pad"] == 128 and node_slices(128, nodes)[1][0] >= 8
    launcher = ShardLauncher(cpu_mesh(nodes, 1))
    out = launcher(encs, dims, 2)
    for i, e in enumerate(encs):
        single = TorchPlacementEngine.shared("cpu").run_scan_single(e)
        assert_same(single, [a[i, :e.p] for a in out], f"eval {i}")


def test_has_pre_equals_the_jax_engine():
    """A preempting eval (the ``preempt`` variant, at least one step
    evicting) over (1, 2) and (1, 4) meshes: equal to the JAX engine's
    ``run_scan_single`` bit for bit, evictions included (the JAX evict
    column is int64, the port's int32, as in ``test_torch_preempt.py``:
    the values are compared)."""
    enc = variant_enc("preempt", 100, n_placements=20, seed=5)
    ref = [np.asarray(r) for r in jengine.TpuPlacementEngine.shared().run_scan_single(
        jax_enc(enc))]
    assert int((ref[4] >= 0).any(axis=1).sum()) >= 1
    ref[4] = ref[4].astype(np.int32)
    for nodes in (2, 4):
        out = batched_place_scan(cpu_mesh(nodes, 1))([enc])
        assert_same(ref, [a[0, :enc.p] for a in out], f"has_pre over {nodes} shards against JAX")


def test_a_failed_node_shard_fails_the_batch(monkeypatch):
    """A node shard's phase that raises fails the whole batch, which is
    retried eval by eval through the node shards; an error that remains
    reaches each ``run()``."""
    encs = [synthetic_enc(20, 1, 3, seed=s, dtype=np.int32) for s in (1, 2)]
    singles = [TorchPlacementEngine.shared("cpu").run_scan_single(e) for e in encs]
    orig = kernels.place_scan_nodes_phase
    calls = []

    def fails_once(sh, phase, p):
        calls.append(sh.dims["B"])
        if len(calls) == 5:
            raise RuntimeError("node shard failed")
        return orig(sh, phase, p)

    monkeypatch.setattr(kernels, "place_scan_nodes_phase", fails_once)
    b = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu", mesh=cpu_mesh(2, 1))
    try:
        got, errors = run_concurrent(b, encs)
    finally:
        b.stop()
    assert errors == [None, None]
    assert calls[:5] == [2] * 5 and set(calls[5:]) == {1}
    for single, g in zip(singles, got):
        assert_same(single, g, "retried eval")

    def always(sh, phase, p):
        raise RuntimeError("node shard failed")

    monkeypatch.setattr(kernels, "place_scan_nodes_phase", always)
    b = DeviceBatcher(max_batch=2, window_ms=2000.0, device="cpu", mesh=cpu_mesh(2, 1))
    try:
        got, errors = run_concurrent(b, encs)
    finally:
        b.stop()
    assert got == [None, None]
    assert all(isinstance(e, RuntimeError) and "node shard failed" in str(e) for e in errors)


# -- the server -------------------------------------------------------------------


def test_node_mesh_server_places_as_the_jax_mesh_server(monkeypatch):
    """``device_mesh=True`` with ``device_batch`` 4 over eight devices
    (the port's device list patched to eight CPU entries; the JAX server
    on its 8-device CPU mesh): both grids are (4, 2), a node axis, and
    the int arm places the C1M-shaped mix of
    ``test_torch_parallel.py``'s server case on the same nodes."""
    from test_torch_parallel import c1m_mix, place_mix

    monkeypatch.setattr(sharding, "visible_devices", lambda kind="cuda": list(CPUS))
    calls = []
    orig = kernels.place_scan_nodes_phase

    def spy(sh, phase, p):
        calls.append(sh.nodes)
        return orig(sh, phase, p)

    monkeypatch.setattr(kernels, "place_scan_nodes_phase", spy)
    kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
              pipeline_async=False, device_min_placements=0, device_mesh=True,
              device_batch=4)
    ref, jmesh, _ = place_mix(JaxServer, JaxServerConfig(**kw), jmock, jstructs)
    got, mesh, stats = place_mix(Server, ServerConfig(device="cpu", **kw), mock, tstructs)
    assert dict(jmesh.shape) == dict(mesh.shape) == {"evals": 4, "nodes": 2}
    assert calls and set(calls) == {2}
    assert stats["device_dispatches"].get("cpu", 0) >= 6
    assert len(got) == sum(j.task_groups[0].count for j in c1m_mix(mock, tstructs))
    assert got == ref
