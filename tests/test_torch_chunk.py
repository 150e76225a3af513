"""The chunked throughput tier of the port (``tpu_binpack_chunked``)
against the JAX package, on the CPU.

The port's plain chunk scan (``nomad_tpu_torch/tpu/chunk.py``, reached
through ``kernels.chunk_scan`` on CPU tensors) is held against
``nomad_tpu.tpu.engine._build_chunk_scan`` step by step on the same
numpy inputs (``example_chunk_variant`` / ``example_scan_inputs``, made
from a seed). The check is ``parity.check_chunk_scan``: every step's set
of chosen nodes equal (divergence 0), ``valid``, ``placed``, the
deficit, the integer carries and the integer-valued float carries
exact, scores within ``parity.FLOAT_SCORE_TOL`` (1e-5: ``pow(10, x)`` is
not bit-equal between XLA's CPU backend and PyTorch's); and, since
``lax.top_k`` breaks ties by the lower index, ``top_idx`` equal over all
K slots, the invalid ones included.

Then the tier around the scan: ``run_chunked``'s per-TG expansion and
the sampled-parity tally against the JAX engine's, the counterparts of
``tests/test_chunk_scan.py``'s ten tests, and Harness slices under
``tpu_binpack_chunked``: float evals equal to the JAX Harness's plans by
per-TG multiset, int evals falling back to the exact scan and equal to
the host binpack stack.
"""
import copy
import random
import time

import numpy as np
import pytest
import torch

import nomad_tpu.tpu.engine as jengine
from nomad_tpu.tpu.engine import EncodedEval as JaxEncodedEval
from nomad_tpu.tpu.engine import TpuPlacementEngine, _build_chunk_scan
from nomad_tpu.tpu.engine import chunk_schedule as jax_chunk_schedule

import nomad_tpu_torch.tpu.engine as tengine
from nomad_tpu_torch.tpu import chunk, convert, kernels, parity
from nomad_tpu_torch.tpu.batcher import assert_chunk_gate
from nomad_tpu_torch.tpu.encode import DIM_CPU, DIM_MEM
from nomad_tpu_torch.tpu.engine import (
    CHUNK_VARIANTS,
    EncodedEval,
    TorchPlacementEngine,
    example_chunk_variant,
    example_scan_inputs,
)

import test_torch_engine as te


@pytest.fixture(scope="module")
def jax_scans():
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = _build_chunk_scan(k)
        return cache[k]

    return get


def _jax_chunk(scan, n_pad, static, carry, xs, deficit=None):
    import jax.numpy as jnp

    conv = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    args = (n_pad, conv(static), conv(carry), conv(xs))
    jc, jd, jy = scan(*args) if deficit is None else scan(*args, jnp.asarray(deficit))
    return ([np.asarray(a) for a in jc], np.asarray(jd), [np.asarray(a) for a in jy])


def _port_chunk(n_pad, static, carry, xs, k, deficit=None):
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    d = None if deficit is None else convert.to_torch([deficit], "cpu")[0]
    tc, td, ty = kernels.chunk_scan(n_pad, st, ca, x, d, chunk=k)
    return (list(convert.to_numpy(tc)), td.numpy(), list(convert.to_numpy(ty)))


def _f32(t):
    return tuple(np.asarray(a).astype(np.float32) if np.asarray(a).dtype.kind == "f"
                 else np.asarray(a) for a in t)


def _check(ref, got, what="chunk scan"):
    """The stated check, with top_idx equal over all K slots and the JAX
    output dtypes."""
    for a, b in zip(ref[2], got[2]):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert ref[1].dtype == got[1].dtype == np.int32
    div, diff, all_slots, _exact = parity.check_chunk_scan(ref, got, what)
    assert div == 0 and diff <= parity.FLOAT_SCORE_TOL
    assert all_slots, f"{what}: top_idx differs in some slot"


# -- the plain chunk scan against _build_chunk_scan ---------------------------


@pytest.mark.parametrize("k", [4, 16, 128])
@pytest.mark.parametrize("variant", CHUNK_VARIANTS)
def test_plain_chunk_scan_matches_jax(jax_scans, variant, k):
    n_nodes = 160 if k == 128 else 72
    n_pad, static, carry = example_chunk_variant(variant, n_nodes=n_nodes, n_tgs=3, seed=k)
    xs = chunk.chunk_schedule([(0, 2 * k + 3), (1, k), (2, 3 * k // 2)], k, retry_rounds=2)
    ref = _jax_chunk(jax_scans(k), n_pad, static, carry, xs)
    got = _port_chunk(n_pad, static, carry, xs, k)
    _check(ref, got, f"{variant} K={k}")
    assert int(got[2][3].sum()) > 0


@pytest.mark.parametrize("variant", ["tight", "c1m"])
def test_plain_chunk_scan_bulk_to_tail_deficit_handoff(jax_scans, variant):
    """The C1M two-phase shape (bench.py:232-258): a bulk phase at a
    large K, then a tail at a smaller K with retry rounds, fed the
    bulk's carry and its int32 deficit."""
    n_pad, static, carry = example_chunk_variant(variant, n_nodes=300, n_tgs=2, seed=3)
    bulk_k, tail_k = 128, 16
    xb = chunk.chunk_schedule([(0, 300), (1, 260)], bulk_k)
    xt = chunk.chunk_schedule([(0, 40), (1, 30)], tail_k, retry_rounds=4)
    ref_b = _jax_chunk(jax_scans(bulk_k), n_pad, static, carry, xb)
    got_b = _port_chunk(n_pad, static, carry, xb, bulk_k)
    _check(ref_b, got_b, "bulk")
    ref_t = _jax_chunk(jax_scans(tail_k), n_pad, static, ref_b[0], xt, ref_b[1])
    got_t = _port_chunk(n_pad, static, got_b[0], xt, tail_k, got_b[1])
    _check(ref_t, got_t, "tail")
    if variant == "tight":
        assert int(ref_b[1].sum()) > 0, "the bulk left no deficit to hand over"


@pytest.mark.parametrize("variant,n_nodes,k", [
    ("c1m", 8192, 5000),
    ("open", 8192, 5000),
    ("spread_affinity", 1024, "n_pad"),
    ("tight", 640, "n_pad"),
])
def test_plain_chunk_scan_past_4096_and_at_n_pad_matches_jax(jax_scans, variant, n_nodes, k):
    """Any chunk size up to n_pad, as ``lax.top_k`` takes it: K = 5,000
    on 8,192 nodes (the kernel's shared-memory list holds 4,096) and
    K = n_pad, through ``kernels.chunk_scan`` against
    ``_build_chunk_scan``."""
    n_pad, static, carry = example_chunk_variant(variant, n_nodes=n_nodes, n_tgs=2, seed=11)
    k = n_pad if k == "n_pad" else k
    xs = chunk.chunk_schedule([(0, k + 37), (1, k // 2)], k, retry_rounds=1)
    ref = _jax_chunk(jax_scans(k), n_pad, static, carry, xs)
    got = _port_chunk(n_pad, static, carry, xs, k)
    _check(ref, got, f"{variant} K={k}")
    assert int(got[2][3].sum()) > 0


def test_plain_chunk_scan_zero_affinity_axis_matches_jax(jax_scans):
    """The r2 crash shape: example_scan_inputs' zero-size affinity axis,
    its own feasibility plane, through both."""
    n_pad, static, carry, _ = example_scan_inputs(n_nodes=96, n_tgs=2, n_placements=8, seed=9)
    assert static[4].shape[0] == 0
    xs = chunk.chunk_schedule([(0, 50), (1, 40)], 16, retry_rounds=1)
    _check(_jax_chunk(jax_scans(16), n_pad, static, carry, xs),
           _port_chunk(n_pad, static, carry, xs, 16), "zero affinity axis")


def test_chunk_schedule_matches_jax():
    for counts, k, rr in (([(0, 300), (1, 5), (2, 129)], 128, 0),
                          ([(1, 0), (0, 17)], 4, 3), ([], 8, 2)):
        for a, b in zip(chunk.chunk_schedule(counts, k, rr), jax_chunk_schedule(counts, k, rr)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_top_k_order_is_lax_top_k_order():
    """Descending score, ties by the lower index, IEEE total order (+0
    above -0); torch.topk fixes none of it."""
    import jax
    import torch

    x = np.array([-0.0, 0.0, -0.0, 1.0, -np.inf, -np.inf, 0.0, 1.0, 0.5], np.float32)
    vals, idx = chunk.top_k_ordered(torch.from_numpy(x), x.size)
    jv, ji = jax.lax.top_k(x, x.size)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(vals.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_check_has_teeth(jax_scans, monkeypatch):
    """+1e-3 on the score of the node the JAX scan picks first breaks
    the check."""
    n_pad, static, carry = example_chunk_variant("spread_affinity", n_nodes=72, seed=2)
    xs = chunk.chunk_schedule([(0, 20), (1, 20)], 4)
    ref = _jax_chunk(jax_scans(4), n_pad, static, carry, xs)
    node = int(ref[2][0][0, 0])
    orig = chunk.masked_scores

    def nudged(*args):
        row = orig(*args).clone()
        row[node] += 1e-3
        return row

    monkeypatch.setattr(chunk, "masked_scores", nudged)
    with pytest.raises(AssertionError):
        _check(ref, _port_chunk(n_pad, static, carry, xs, 4))


# -- counterparts of tests/test_chunk_scan.py ---------------------------------


def _chunk_inputs(n_nodes=64, n_tgs=2, seed=0, open_feas=False):
    n_pad, static, carry, _xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=8, seed=seed)
    assert static[4].shape[0] == 0, "fixture must carry the zero-G aff axis"
    static = list(static)
    if open_feas:
        static[3] = np.ones_like(static[3])
    return n_pad, _f32(tuple(static)), _f32(carry)


def test_chunk_scan_zero_affinity_axis_regression(jax_scans):
    n_pad, static, carry = _chunk_inputs(open_feas=True)
    xs = chunk.chunk_schedule([(0, 20), (1, 20)], 16)
    got = _port_chunk(n_pad, static, carry, xs, 16)
    assert int(got[2][3].sum()) == 40
    assert (got[1] == 0).all()
    _check(_jax_chunk(jax_scans(16), n_pad, static, carry, xs), got)


def test_chunk_scan_respects_capacity_and_counts(jax_scans):
    n_pad, static, carry = _chunk_inputs(n_nodes=32, open_feas=True)
    totals, reserved, asks = static[0], static[1], static[2]
    tg_idx, want = xs = chunk.chunk_schedule([(0, 30), (1, 30)], 8, retry_rounds=2)
    got = _port_chunk(n_pad, static, carry, xs, 8)
    used, tg_counts, job_counts = got[0][0], got[0][1], got[0][2]
    assert (used + reserved <= totals + 1e-5).all()
    assert (job_counts == tg_counts.sum(axis=0)).all()
    assert job_counts.sum() == int(got[2][3].sum())
    top_idx, valid = got[2][0], got[2][2]
    replay = np.zeros_like(used)
    for si in range(top_idx.shape[0]):
        a = asks[int(tg_idx[si])]
        for k in range(top_idx.shape[1]):
            if valid[si, k]:
                n = int(top_idx[si, k])
                assert (replay[n] + reserved[n] + a <= totals[n] + 1e-5).all()
                replay[n] += a
    assert np.allclose(replay, used, atol=1e-4)
    _check(_jax_chunk(jax_scans(8), n_pad, static, carry, xs), got)


def test_chunk_scan_deficit_rolls_into_retry_rounds(jax_scans):
    n_pad, static, carry = _chunk_inputs(n_nodes=16)
    static = list(static)
    feas = np.zeros_like(static[3])
    feas[:, :3] = True  # only 3 feasible nodes per TG
    static[3] = feas
    totals = static[0].copy()
    totals[:, DIM_CPU] = 300.0
    totals[:, DIM_MEM] = 600.0
    static[0] = totals
    asks = static[2].copy()
    asks[:, DIM_CPU] = 100.0
    asks[:, DIM_MEM] = 100.0
    static[2] = asks
    static[1] = np.zeros_like(static[1])
    static = tuple(static)
    xs = chunk.chunk_schedule([(0, 50)], 8, retry_rounds=3)
    got = _port_chunk(n_pad, static, carry, xs, 8)
    n_placed = int(got[2][3].sum())
    assert n_placed == 9  # 3 nodes x 3 allocs (cpu binds)
    assert int(got[1][0]) == 50 - n_placed
    _check(_jax_chunk(jax_scans(8), n_pad, static, carry, xs), got)


def test_chunk_scan_distinct_hosts(jax_scans):
    n_pad, static, carry = _chunk_inputs(n_nodes=16, n_tgs=2, open_feas=True)
    static = list(static)
    static[6] = np.ones(2, bool)  # job-level distinct_hosts
    static = tuple(static)
    xs = chunk.chunk_schedule([(0, 10), (1, 10)], 8, retry_rounds=1)
    got = _port_chunk(n_pad, static, carry, xs, 8)
    assert got[0][2].max() <= 1
    assert int(got[2][3].sum()) == 16
    _check(_jax_chunk(jax_scans(8), n_pad, static, carry, xs), got)


def test_chunk_scan_spread_prefers_undersubscribed_values(jax_scans):
    n_pad, static, carry = _chunk_inputs(n_nodes=64, n_tgs=1, open_feas=True)
    xs = chunk.chunk_schedule([(0, 32)], 4)
    got = _port_chunk(n_pad, static, carry, xs, 4)
    assert int(got[2][3].sum()) == 32
    real = got[0][3][0, 0][:-1]  # drop the invalid bucket
    assert real.sum() == 32
    assert real.max() - real.min() <= 8
    _check(_jax_chunk(jax_scans(4), n_pad, static, carry, xs), got)


def _encs(n_nodes=64, n_tgs=2, p=40, seed=3, open_feas=True, dtype=np.float32):
    """The same chunk-eligible eval as a port and a JAX EncodedEval."""
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=p, seed=seed)
    static = list(static)
    if open_feas:
        static[3] = np.ones_like(static[3])

    def cast(t):
        return tuple(np.asarray(a).astype(dtype) if np.asarray(a).dtype.kind == "f"
                     else np.asarray(a) for a in t)

    out = []
    for cls in (EncodedEval, JaxEncodedEval):
        out.append(cls(
            n_real=n_nodes, n_pad=n_pad, g=n_tgs, s=static[9].shape[1],
            v=static[10].shape[2], p=p, dtype=dtype,
            static=cast(tuple(static)), carry=cast(carry), xs=xs,
            missing_list=[None] * p, nodes=[], table=None,
            start_ns=time.monotonic_ns(), dense_ok=True))
    return out


@pytest.fixture
def engines():
    return TorchPlacementEngine("cpu"), TpuPlacementEngine.shared()


def test_chunk_eligibility_gates(engines):
    enc, jenc = _encs()
    for e, eng in zip((enc, jenc), engines):
        cls = type(eng)
        assert cls._chunk_eligible(e) is None
        e.pre_allocs = {0: []}
        assert cls._chunk_eligible(e) == "preemption tables"
        e.pre_allocs = None
        e.dense_ok = False
        assert cls._chunk_eligible(e) == "not dense"
        e.dense_ok = True
        e.dtype = np.int32
        assert cls._chunk_eligible(e) == "int mode"
        e.dtype = np.float32
        xs = list(e.xs)
        evict = np.asarray(xs[2]).copy()
        evict[0] = 5
        xs[2] = evict
        e.xs = tuple(xs)
        assert cls._chunk_eligible(e) == "eviction axis"


def test_batcher_asserts_chunk_gate_on_preempting_eval(engines):
    enc, _ = _encs()
    assert_chunk_gate(enc)
    enc.pre_allocs = {0: []}
    with pytest.raises(AssertionError, match="preempting"):
        assert_chunk_gate(enc)
    with pytest.raises(AssertionError):
        engines[0].run_chunked(enc)
    enc.pre_allocs = None
    xs = list(enc.xs)
    xs[2] = np.full_like(np.asarray(xs[2]), 3)
    enc.xs = tuple(xs)
    with pytest.raises(AssertionError, match="eviction steps"):
        assert_chunk_gate(enc)


@pytest.mark.parametrize("chunk_k", [16, 128])
def test_run_chunked_places_all_in_parity_result_shape(engines, chunk_k):
    """The expansion to per-placement arrays equals the JAX engine's."""
    enc, jenc = _encs(p=60)
    got = engines[0].run_chunked(enc, chunk_k=chunk_k)
    ref = engines[1].run_chunked(jenc, chunk_k=chunk_k)
    chosen, scores, pulls, skipped, evict = got
    assert chosen.shape == (enc.p,) and (chosen >= 0).all()
    assert chosen.max() < enc.n_real
    assert (pulls == enc.n_real).all() and not skipped.any()
    assert evict.shape == (enc.p, 0)
    assert np.array_equal(chosen, ref[0])
    assert np.abs(scores - ref[1]).max() <= parity.FLOAT_SCORE_TOL
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(pulls, ref[2]) and np.array_equal(skipped, ref[3])


@pytest.mark.parametrize("n_nodes,p,chunk_k", [(8192, 9000, 5000), (600, 900, 100_000)])
def test_run_chunked_any_chunk_k_equals_jax(engines, n_nodes, p, chunk_k):
    """``chunk_k`` past 4,096, and past n_pad (clamped to it), through
    ``run_chunked``: the JAX engine's per-placement result."""
    enc, jenc = _encs(n_nodes=n_nodes, p=p, seed=6)
    got = engines[0].run_chunked(enc, chunk_k=chunk_k)
    ref = engines[1].run_chunked(jenc, chunk_k=chunk_k)
    assert (got[0] >= 0).sum() > 0
    assert np.array_equal(got[0], ref[0])
    assert np.abs(got[1] - ref[1]).max() <= parity.FLOAT_SCORE_TOL
    for a, b in zip(got[2:], ref[2:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_packed_copy_round_trips_every_array_of_an_encode():
    """One buffer, 16-byte aligned slots, each view of the encode's
    dtype and shape and equal to it, none aliasing the encode, and the
    numpy arrays back from it; ``run_chunked`` moves its inputs with one
    packed copy, never ``scan_inputs_to_torch``."""
    enc, _ = _encs(p=50)
    steps = chunk.chunk_schedule([(0, 30), (1, 20)], 16, retry_rounds=1)
    deficit = np.zeros(2, np.int32)
    arrays = (*enc.static, *enc.carry, *steps, deficit)
    packed = kernels.pack_chunk_inputs(enc.n_pad, enc.static, enc.carry, steps, deficit, 16,
                                       "cpu")
    buf, layout = packed.buf, packed.layout
    views = convert.unpack(buf, layout)
    assert len(views) == len(arrays) == 41 and buf.dtype == torch.uint8 and buf.dim() == 1
    assert packed.dims["K"] == 16 and packed.dims["T"] == steps[0].shape[0]
    parts = packed.parts()
    assert [len(parts[0]), len(parts[1]), len(parts[2])] == [26, 12, 2]
    assert parts[3].data_ptr() == views[kernels.CHUNK_DEFICIT].data_ptr()
    base = buf.data_ptr()
    for (off, _dt, _shape), a, t in zip(layout, arrays, views):
        a = np.asarray(a)
        assert off % 16 == 0 and (t.numel() == 0 or t.data_ptr() == base + off)
        assert t.dtype == convert._TORCH_OF[a.dtype] and tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), a)
    assert any(a.ndim == 0 for a in map(np.asarray, arrays))
    assert any(np.asarray(a).dtype == np.bool_ for a in arrays)
    parts[1][0].add_(1.0)  # the carry's used: the encode stays as it was
    assert not np.array_equal(parts[1][0].numpy(), enc.carry[0])
    back = convert.from_device_packed(buf, layout)
    for a, b, t in zip(arrays, back, views):
        assert b.dtype == np.asarray(a).dtype and b.shape == np.asarray(a).shape
        assert np.array_equal(b, t.numpy())

    calls = {"packed": 0, "loose": 0}
    orig_packed, orig_loose = convert.to_device_packed, convert.scan_inputs_to_torch

    def packed_copy(*args, **kwargs):
        calls["packed"] += 1
        return orig_packed(*args, **kwargs)

    def loose(*args, **kwargs):
        calls["loose"] += 1
        return orig_loose(*args, **kwargs)

    convert.to_device_packed, convert.scan_inputs_to_torch = packed_copy, loose
    try:
        TorchPlacementEngine("cpu").run_chunked(enc, chunk_k=16)
    finally:
        convert.to_device_packed, convert.scan_inputs_to_torch = orig_packed, orig_loose
    assert calls == {"packed": 1, "loose": 0}


@pytest.mark.parametrize("variant", ["spread_affinity", "tight"])
def test_chunk_scan_packed_equals_chunk_scan(variant):
    """The packed entry (the kernel reads the buffer through its layout)
    gives ``chunk_scan``'s outputs, and updates the buffer's carry and
    deficit in place as ``chunk_scan`` updates its tensors; the packing
    checks the inputs as ``chunk_scan`` does."""
    n_pad, static, carry = example_chunk_variant(variant, n_nodes=300, n_tgs=2, seed=8)
    xs = chunk.chunk_schedule([(0, 140), (1, 90)], 32, retry_rounds=2)
    deficit = np.zeros(2, np.int32)
    packed = kernels.pack_chunk_inputs(n_pad, static, carry, xs, deficit, 32, "cpu")
    out, out_layout = kernels.chunk_scan_packed(packed)
    got = convert.from_device_packed(out, out_layout)
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    ref_c, ref_d, ref_y = kernels.chunk_scan(n_pad, st, ca, x, chunk=32)
    for a, b in zip(got, convert.to_numpy(ref_y)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _s, p_carry, _x, p_deficit = packed.parts()
    for a, b in zip(p_carry, ref_c):
        assert torch.equal(a, b)
    assert torch.equal(p_deficit, ref_d)
    with pytest.raises(ValueError, match="26 static"):
        kernels.pack_chunk_inputs(n_pad, static[:25], carry, xs, deficit, 32, "cpu")
    with pytest.raises(TypeError, match="deficit"):
        kernels.pack_chunk_inputs(n_pad, static, carry, xs, deficit.astype(np.int64), 32, "cpu")
    with pytest.raises(ValueError, match="chunk size"):
        kernels.pack_chunk_inputs(n_pad, static, carry, xs, deficit, n_pad + 1, "cpu")


def test_run_chunked_short_capacity_leaves_rows_unfilled(engines):
    """Rows the retry rounds cannot fill come back chosen = -1, as in
    the JAX engine."""
    encs = _encs(n_nodes=20, p=90, seed=4)
    for e in encs:
        totals = e.static[0].copy()
        totals[:, DIM_CPU] = np.minimum(totals[:, DIM_CPU], 700.0)
        e.static = (totals,) + e.static[1:]
    got = engines[0].run_chunked(encs[0], chunk_k=8)
    ref = engines[1].run_chunked(encs[1], chunk_k=8)
    assert (got[0] < 0).any()
    assert np.array_equal(got[0], ref[0])


def test_sampled_parity_catches_injected_perturbation(engines):
    """The tallies equal the JAX engine's with both RNGs seeded alike,
    and a rebound placement raises the divergence."""
    enc, jenc = _encs()
    eng, jeng = engines
    chosen = eng.run_chunked(enc, chunk_k=16)[0]
    jchosen = jeng.run_chunked(jenc, chunk_k=16)[0]
    stats = []
    for e, en, c, mod in ((enc, eng, chosen, tengine), (jenc, jeng, jchosen, jengine)):
        mod._PARITY_SAMPLE_RNG.seed(0)
        en.reset_parity_samples()
        en._maybe_sample_parity(e, c, rate=1.0)
        stats.append(en.parity_sample_stats())
    baseline = stats[0]
    assert baseline == stats[1]
    assert baseline["evals_sampled"] == 1
    assert baseline["placements_checked"] == enc.p

    ref = eng.run_scan_single(enc)[0][: enc.p]
    tg_idx = np.asarray(enc.xs[0])[: enc.p]
    ref_nodes = set(ref[tg_idx == tg_idx[0]].tolist())
    bad = next(n for n in range(enc.n_real) if n not in ref_nodes)
    perturbed = chosen.copy()
    perturbed[0] = bad
    tengine._PARITY_SAMPLE_RNG.seed(0)
    eng.reset_parity_samples()
    eng._maybe_sample_parity(enc, perturbed, rate=1.0)
    out = eng.parity_sample_stats()
    assert out["placements_diverged"] > baseline["placements_diverged"]
    assert out["divergence_rate"] > baseline["divergence_rate"]


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_sampled_parity_rate_decisions_match_jax(engines, rate):
    """rate 0 records nothing; at 0.3 the same evals are sampled as in
    the JAX engine when both RNGs start alike."""
    enc, jenc = _encs()
    eng, jeng = engines
    chosen = eng.run_chunked(enc, chunk_k=16)[0]
    jchosen = jeng.run_chunked(jenc, chunk_k=16)[0]
    tengine._PARITY_SAMPLE_RNG.seed(11)
    jengine._PARITY_SAMPLE_RNG.seed(11)
    eng.reset_parity_samples()
    jeng.reset_parity_samples()
    for _ in range(6):
        eng._maybe_sample_parity(enc, chosen, rate=rate)
        jeng._maybe_sample_parity(jenc, jchosen, rate=rate)
    assert eng.parity_sample_stats() == jeng.parity_sample_stats()
    if rate == 0.0:
        assert eng.parity_sample_stats()["evals_sampled"] == 0


# -- Harness slices under tpu_binpack_chunked ---------------------------------


def _chunk_jobs(pkg):
    """Three float jobs: a service job, a batch job, and a service job
    with a targeted spread and an affinity (C1M's stanzas)."""
    s = pkg.s
    svc = pkg.mock.job()
    svc.id = "chunk-svc"
    svc.task_groups[0].count = 40
    svc.task_groups[0].tasks[0].resources.networks = []
    batch = pkg.mock.batch_job()
    batch.id = "chunk-batch"
    batch.task_groups[0].count = 30
    stanza = pkg.mock.job()
    stanza.id = "chunk-stanza"
    stanza.task_groups[0].count = 30
    stanza.task_groups[0].tasks[0].resources.networks = []
    stanza.task_groups[0].spreads = [s.Spread(
        attribute="${node.datacenter}", weight=50,
        spread_target=[s.SpreadTarget(value="dc1", percent=70),
                       s.SpreadTarget(value="dc2", percent=30)])]
    stanza.task_groups[0].affinities = [s.Affinity(
        ltarget="${attr.rack}", rtarget="r1", operand="=", weight=50)]
    return [(svc, "service"), (batch, "batch"), (stanza, "service")]


def _chunk_harness_views(pkg, monkeypatch=None):
    random.seed(31)
    h = te.new_harness(pkg, alg="tpu_binpack_chunked")
    for n in te.make_nodes(pkg, 64, seed=12):
        h.state.upsert_node(h.next_index(), n)
    for job, kind in _chunk_jobs(pkg):
        te.register(pkg, h, job, kind, deterministic=False)
    return te.view(h)


def test_chunked_harness_plans_equal_jax(monkeypatch):
    """Float evals through the port's Harness and the JAX Harness under
    tpu_binpack_chunked: every eval takes the chunk kernel's plain
    version, and the plans are equal by per-TG multiset."""
    counters = te._Counters(monkeypatch)
    calls = []
    orig = kernels.chunk_scan

    def spy(*args, **kwargs):
        calls.append(args[0])
        return orig(*args, **kwargs)

    monkeypatch.setattr(kernels, "chunk_scan", spy)
    tengine._PARITY_SAMPLE_RNG.seed(5)
    jengine._PARITY_SAMPLE_RNG.seed(5)
    vj = _chunk_harness_views(te.JAX)
    vt = _chunk_harness_views(te.TORCH)
    assert len(vt[0]) == 100
    assert te.assign_divergence(vt[0], vj[0]) == 0
    assert vt[1:] == vj[1:]
    assert len(calls) == 3
    assert counters.count("nomad.tpu_engine.chunk_dispatch") == 3
    assert counters.count("nomad.tpu_engine.chunk_fallback") == 0


def test_chunked_algorithm_deterministic_fallback(monkeypatch):
    """tpu_binpack_chunked on deterministic evals: every eval is
    chunk-ineligible (int arm), takes the exact scan and equals the
    host binpack stack's plans (tests/test_tpu_parity.py:904)."""
    counters = te._Counters(monkeypatch)
    nodes = te.make_nodes(te.TORCH, 25, seed=21)
    jobs = []
    for i in range(3):
        j = te.TORCH.mock.job()
        j.id = f"chunked-fb-{i}"
        j.task_groups[0].count = 10
        jobs.append(j)
    plans = {}
    for alg in ("binpack", "tpu_binpack_chunked"):
        h = te.new_harness(te.TORCH, alg=alg)
        for n in nodes:
            h.state.upsert_node(h.next_index(), copy.deepcopy(n))
        for job in jobs:
            te.register(te.TORCH, h, job)
        plans[alg] = te.view(h)[0]
    assert plans["binpack"] == plans["tpu_binpack_chunked"]
    assert len(plans["binpack"]) == 30
    assert counters.count("nomad.tpu_engine.chunk_fallback") == 3
    assert counters.count("nomad.tpu_engine.chunk_dispatch") == 0


def _dp_job(pkg):
    job = pkg.mock.job()
    job.id = "dp-chunk"
    job.task_groups[0].count = 12
    job.task_groups[0].tasks[0].resources.networks = []
    job.constraints.append(pkg.s.Constraint(
        operand="distinct_property", ltarget="${attr.rack}", rtarget="2"))
    return job


def test_chunked_tier_ignores_distinct_property_as_the_reference_does():
    """A reference defect the port keeps (ROADMAP.md Queue 3): the chunk
    gate does not refuse distinct_property and the chunk step reads no
    dp_* input, so a job limited to 2 allocs per rack value is placed
    past its limit on this tier, in both packages alike, while the
    exact scan holds the limit."""
    placed = {}
    for pkg in (te.JAX, te.TORCH):
        for alg in ("tpu_binpack", "tpu_binpack_chunked"):
            random.seed(8)
            h = te.new_harness(pkg, alg=alg)
            for n in te.make_nodes(pkg, 12, seed=25):
                h.state.upsert_node(h.next_index(), n)
            te.register(pkg, h, _dp_job(pkg), deterministic=False)
            assign = te.view(h)[0]
            racks = {n.name: n.attributes["rack"] for n in h.state.nodes()}
            per_rack = {}
            for node in assign.values():
                per_rack[racks[node]] = per_rack.get(racks[node], 0) + 1
            placed[(pkg is te.TORCH, alg)] = (assign, per_rack)
    for port in (False, True):
        assert max(placed[(port, "tpu_binpack")][1].values()) <= 2
        assert max(placed[(port, "tpu_binpack_chunked")][1].values()) > 2
    assert placed[(True, "tpu_binpack_chunked")][0] == placed[(False, "tpu_binpack_chunked")][0]
