"""The port's CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc; skipped (with the reason) elsewhere. On
the GPU host, from the repo root:

    python -m pytest -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernel at the main path's full size; these
are small shapes for iterating on the kernel. Int arm: no tolerance (it
is exact). Float arm: no placement may diverge, and scores at equal
picks agree within ``parity.FLOAT_SCORE_TOL`` (1e-5).
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.tpu import convert, kernels, parity, step
from nomad_tpu_torch.tpu.engine import SCAN_VARIANTS, example_scan_variant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _equal(a_out, b_out):
    (ac, ay), (bc, by) = a_out, b_out
    return (all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ay, by))
            and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ac, bc)))


@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_kernel_equals_plain(cuda, variant):
    n_pad, st, ca, xs = example_scan_variant(variant, n_nodes=700, n_tgs=3,
                                             n_placements=64, seed=4)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    plain = step.place_scan(n_pad, s, c, x)
    before = kernels.LAUNCHES["place_scan"]
    out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["place_scan"] == before + 1
    assert _equal(out, plain)


def test_batched_equals_single_launches(cuda):
    import numpy as np

    evals = [example_scan_variant("all", n_nodes=300, n_placements=32, seed=s)
             for s in (1, 2)]
    n_pad = evals[0][0]
    singles = []
    for _, st, ca, xs in evals:
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
        singles.append(kernels.place_scan(n_pad, s, c, x))
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
    carry_b, ys_b = kernels.place_scan_batched(*convert.scan_inputs_to_torch(*stacked, cuda))
    for b, single in enumerate(singles):
        assert _equal((tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b)), single)


def test_kernel_rejects_cpu_mixed_devices(cuda):
    n_pad, st, ca, xs = example_scan_variant("s1", n_nodes=64, seed=1)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    x = (x[0].cpu(),) + x[1:]
    with pytest.raises(ValueError, match="several devices"):
        kernels.place_scan(n_pad, s, c, x)


@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_float_kernel_matches_plain(cuda, variant):
    n_pad, st, ca, xs = example_scan_variant(variant, n_nodes=700, n_tgs=3,
                                             n_placements=64, seed=4,
                                             dtype=np.float32)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    plain = step.place_scan(n_pad, s, c, x)
    before = dict(kernels.LAUNCHES)
    out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["place_scan_f32"] == before["place_scan_f32"] + 1
    assert kernels.LAUNCHES["place_scan"] == before["place_scan"]
    assert out[1][1].dtype == torch.float32
    parity.check_float_scan(plain, out, xs[0], f"float variant {variant}")


def test_float_batched_equals_single_launches(cuda):
    evals = [example_scan_variant("all", n_nodes=300, n_placements=32, seed=s,
                                  dtype=np.float32) for s in (1, 2, 3)]
    n_pad = evals[0][0]
    singles = []
    for _, st, ca, xs in evals:
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
        singles.append(kernels.place_scan(n_pad, s, c, x))
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
    carry_b, ys_b = kernels.place_scan_batched(*convert.scan_inputs_to_torch(*stacked, cuda))
    for b, single in enumerate(singles):
        assert _equal((tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b)), single)


@pytest.mark.parametrize("variant", ["preempt", "preempt_forced"])
def test_has_pre_kernel_equals_plain(cuda, variant):
    """The scan's preemption branch (int arm) against its plain version:
    every output, the evict column and the final carry, bit for bit."""
    from nomad_tpu_torch.tpu.engine import example_scan_variant as variant_inputs

    n_pad, st, ca, xs = variant_inputs(variant, n_nodes=700, n_tgs=3, n_placements=64, seed=4)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    plain = step.place_scan(n_pad, s, c, x)
    before = dict(kernels.LAUNCHES)
    out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["place_scan"] == before["place_scan"] + 1
    assert kernels.LAUNCHES["place_scan_has_pre"] == before["place_scan_has_pre"] + 1
    assert _equal(out, plain)
    assert (out[1][4] >= 0).any()


def test_has_pre_batched_mixed_c_equals_single_launches(cuda):
    """Three evals, one without a candidate axis, through the
    DeviceBatcher on the card (one launch) against single launches."""
    from nomad_tpu_torch.tpu.batcher import DeviceBatcher
    from nomad_tpu_torch.tpu.engine import TorchPlacementEngine

    from test_torch_batcher import preempt_enc, run_concurrent, synthetic_enc

    encs = [preempt_enc(300, 24, seed=1), synthetic_enc(200, 2, 9, seed=2, dtype=np.int32),
            preempt_enc(250, 20, seed=3, c=5)]
    engine = TorchPlacementEngine.shared(cuda)
    singles = [engine.run_scan_single(e) for e in encs]
    batcher = DeviceBatcher(max_batch=len(encs), window_ms=2000.0, device=cuda)
    try:
        batched, errors = run_concurrent(batcher, encs)
    finally:
        batcher.stop()
    assert errors == [None] * len(encs) and batcher.stats["dispatches"] == 1
    for single, got in zip(singles, batched):
        for a, b in zip(single[:4], got[:4]):
            assert np.array_equal(a, b)
        c = single[4].shape[1]
        assert np.array_equal(single[4], got[4][:, :c])


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int", "float"])
@pytest.mark.parametrize("device_dims", [0, 2])
def test_forced_kernel_equals_plain_and_scan(cuda, dtype, device_dims):
    """K4 against its plain version and against the scan kernel on the
    same input, bit for bit in both arms, with a padded placement axis."""
    from nomad_tpu_torch.tpu.engine import example_forced_variant

    n_pad, st, ca, xs = example_forced_variant(n_nodes=600, n_placements=500, seed=3,
                                               dtype=dtype, device_dims=device_dims)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    name = "forced_eval" if dtype == np.int32 else "forced_eval_f32"
    before = kernels.LAUNCHES[name]
    got = kernels.forced_eval(s, c, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    plain = kernels._forced.forced_eval(s, c, x)
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, plain))
    _, scan = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x)
    assert torch.equal(got[0].cpu(), scan[0].cpu()) and torch.equal(got[1].cpu(), scan[1].cpu())


def _chunk_case(cuda, variant, n_nodes, k, counts, retry_rounds=2):
    from nomad_tpu_torch.tpu import chunk
    from nomad_tpu_torch.tpu.engine import example_chunk_variant

    n_pad, st, ca = example_chunk_variant(variant, n_nodes=n_nodes, n_tgs=len(counts), seed=5)
    xs = chunk.chunk_schedule(list(enumerate(counts)), k, retry_rounds=retry_rounds)
    return n_pad, convert.scan_inputs_to_torch(st, ca, xs, cuda)


@pytest.mark.parametrize("variant,n_nodes,k,counts", [
    ("open", 700, 16, [90, 70]),
    ("c1m", 2000, 1024, [3000, 2500]),
    ("spread_affinity", 700, 128, [300, 250]),
    ("distinct_hosts", 300, 64, [200, 200]),
    ("tight", 900, 128, [400, 300]),
])
def test_chunk_kernel_equals_plain(cuda, variant, n_nodes, k, counts):
    """K5 on the card against its plain version on the card: every step's
    chosen set equal, integer outputs and carries exact, scores within
    ``parity.FLOAT_SCORE_TOL``, top_idx equal over all K slots."""
    from nomad_tpu_torch.tpu import chunk

    n_pad, (s, c, x) = _chunk_case(cuda, variant, n_nodes, k, counts)
    plain = chunk.chunk_scan(n_pad, s, c, x, chunk=k)
    before = kernels.LAUNCHES["chunk_scan"]
    got = kernels.chunk_scan(n_pad, s, tuple(t.clone() for t in c), x, chunk=k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chunk_scan"] == before + 1
    parity.check_chunk_scan(plain, got, f"chunk {variant}")
    assert torch.equal(plain[2][0].cpu(), got[2][0].cpu())


def test_chunk_kernel_deficit_handoff(cuda):
    """A bulk phase at K = 256, then a tail at K = 64 with retry rounds
    fed the bulk's carry and deficit, kernel against plain."""
    from nomad_tpu_torch.tpu import chunk

    n_pad, (s, c, x) = _chunk_case(cuda, "tight", 1500, 256, [500, 400], retry_rounds=0)
    tail = chunk.chunk_schedule([(0, 60), (1, 40)], 64, retry_rounds=4)
    xt = convert.to_torch(tail, cuda)
    pc, pd, py = chunk.chunk_scan(n_pad, s, c, x, chunk=256)
    plain = chunk.chunk_scan(n_pad, s, pc, xt, pd, chunk=64)
    kc, kd, ky = kernels.chunk_scan(n_pad, s, tuple(t.clone() for t in c), x, chunk=256)
    parity.check_chunk_scan((pc, pd, py), (kc, kd, ky), "bulk")
    got = kernels.chunk_scan(n_pad, s, kc, xt, kd, chunk=64)
    parity.check_chunk_scan(plain, got, "tail")
    assert int(got[1].sum()) > 0


# -- the cluster launch: every cluster size the plan allows -------------------

CLUSTER_SIZES = (1, 2, 4, 8, 16)


def _cut_nodes(st, ca, xs, n):
    """The eval cut to its first ``n`` nodes (an axis that no cluster size
    divides): node axes sliced, n_real and the ring offset kept inside,
    per-placement node ids past the cut dropped (-1)."""
    st, ca, xs = list(st), list(ca), list(xs)
    for k, axis in ((0, 0), (3, 1), (4, 1), (9, 2), (17, 1), (20, 0), (21, 0), (22, 0),
                    (23, 0), (24, 0), (25, 0)):
        st[k] = np.take(st[k], range(n), axis=axis)
    if st[1].shape[0]:
        st[1] = st[1][:n]
    if st[16].shape[1]:
        st[16] = st[16][:, :n]
    st[15] = np.minimum(st[15], n)
    for k, axis in ((0, 0), (1, 1), (2, 0), (9, 0)):
        ca[k] = np.take(ca[k], range(n), axis=axis)
    for k in (7, 10):
        if ca[k].shape[0]:
            ca[k] = ca[k][:n]
    ca[5] = ca[5] % n
    for k in (1, 2, 9):
        xs[k] = np.where(xs[k] >= n, -1, xs[k]).astype(xs[k].dtype)
    return tuple(st), tuple(ca), tuple(xs)


def _arm_case(arm, n_nodes, p, seed, variant=None):
    dtype = np.float32 if arm == "float" else np.int32
    variant = variant or ("preempt" if arm == "has_pre" else "all")
    return example_scan_variant(variant, n_nodes=n_nodes, n_tgs=3, n_placements=p, seed=seed,
                                dtype=dtype)


def _check_arm(arm, plain, out, tg, what):
    if arm == "float":
        parity.check_float_scan(plain, out, tg, what)
    else:
        assert _equal(out, plain), what


@pytest.mark.parametrize("variant", SCAN_VARIANTS + ("preempt", "preempt_forced"))
def test_kernel_equals_plain_at_every_cluster_size(cuda, variant):
    """Each variant at every cluster size: the int arm (and has_pre) bit
    for bit with the plain version, the float arm within the bound and
    bit for bit across cluster sizes."""
    arms = ("int",) if variant.startswith("preempt") else ("int", "float")
    for arm in arms:
        n_pad, st, ca, xs = _arm_case(arm, 700, 48, 7, variant)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
        plain = step.place_scan(n_pad, s, c, x)
        first = None
        for cs in CLUSTER_SIZES:
            batched = tuple(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x))
            assert kernels.scan_plan(*batched, cs=cs).cs == cs
            out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x, cs=cs)
            torch.cuda.synchronize()
            _check_arm(arm, plain, out, x[0], f"{variant} {arm} CS={cs}")
            first = first or out
            assert _equal(out, first), f"{variant} {arm}: CS={cs} differs from CS=1"


@pytest.mark.parametrize("arm", ["int", "float", "has_pre"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_uneven_node_axis_at_every_cluster_size(cuda, arm, B):
    """B evals of 997 nodes (no cluster size divides it) in one launch at
    every cluster size, each eval against its plain version."""
    evals = [_cut_nodes(*_arm_case(arm, 1000, 24, 40 + b)[1:], 997) for b in range(B)]
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in range(3)]
    sb, cb, xb = convert.scan_inputs_to_torch(*stacked, cuda)
    plains = [step.place_scan(997, tuple(t[b] for t in sb), tuple(t[b] for t in cb),
                              tuple(t[b] for t in xb)) for b in range(B)]
    assert kernels.scan_plan(sb, cb, xb).cs == min(4, 128 // B)
    for cs in CLUSTER_SIZES:
        carry_b, ys_b = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb, cs=cs)
        torch.cuda.synchronize()
        for b, plain in enumerate(plains):
            got = (tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b))
            _check_arm(arm, plain, got, xb[0][b], f"{arm} B={B} CS={cs} eval {b}")


@pytest.mark.parametrize("arm", ["int", "float", "has_pre"])
def test_ctas_without_nodes(cuda, arm):
    """Eight nodes over clusters of 16 and 8: CTAs 8-15 own no node and
    take part in every barrier."""
    n_pad, st, ca, xs = _arm_case(arm, 6, 20, 3)
    assert n_pad == 8
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    plain = step.place_scan(n_pad, s, c, x)
    for cs in (16, 8):
        plan = kernels.scan_plan(*(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x)),
                                 cs=cs)
        assert plan.slices[-1] == (8, 8) if cs == 16 else plan.per == 1
        out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x, cs=cs)
        torch.cuda.synchronize()
        _check_arm(arm, plain, out, x[0], f"{arm} CS={cs}")


def _widen_vocab(st, ca, v):
    """The spreads' value vocabulary widened to ``v`` (a per-node
    attribute's size): the tables padded with zeros, and every other
    node moved to a value of its own."""
    st, ca = list(st), list(ca)
    pad = ((0, 0), (0, 0), (0, v - st[10].shape[2]))
    st[10] = np.pad(st[10], pad)
    ca[3] = np.pad(ca[3], pad)
    ca[4] = np.pad(ca[4], pad)
    node = np.arange(st[9].shape[2])
    st[9] = np.where(node % 2 == 1, node % (v - 1), st[9]).astype(st[9].dtype)
    return tuple(st), tuple(ca)


@pytest.mark.parametrize("arm,cs", [("int", 1), ("float", 1), ("has_pre", 4)])
def test_global_fallbacks_equal_plain(cuda, arm, cs):
    """20,000 nodes at a small cluster size, with a spread vocabulary as
    large as the node axis: the plan leaves per-node slices in their
    tensors and the spread replicas in the per-CTA global arena, and the
    kernel still equals the plain version."""
    n_pad, st, ca, xs = _arm_case(arm, 20000, 12, 9, "preempt" if arm == "has_pre" else "all")
    if arm != "has_pre":
        st, ca = _widen_vocab(st, ca, n_pad + 1)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    plan = kernels.scan_plan(*(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x)), cs=cs)
    assert plan.cs == cs and "used" in plan.in_global
    assert arm == "has_pre" or "spread_counts" in plan.arena
    plain = step.place_scan(n_pad, s, c, x)
    out = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x, cs=cs)
    torch.cuda.synchronize()
    _check_arm(arm, plain, out, x[0], f"{arm} CS={cs} with global fallbacks")


def test_k8_sweep_equals_plain(cuda):
    """The scan's isqrt64, coord_q and floordiv_pos (double precision with
    an integer fix-up) against isqrt_t / coord_q_t and torch's floor
    division on the card, over the edge cases of
    ``kernels.k8_sweep_inputs``."""
    from nomad_tpu_torch.tpu import preempt

    n, needed, res, num, den = (torch.from_numpy(a).to(cuda)
                                for a in kernels.k8_sweep_inputs(3, 1 << 18))
    isq, cq, fq = kernels.k8_sweep(n, needed, res, num, den)
    assert torch.equal(isq, preempt.isqrt_t(n))
    assert torch.equal(cq, preempt.coord_q_t(needed, res))
    assert torch.equal(fq, torch.div(num, den, rounding_mode="floor"))


# -- K5: the chunk kernel's cluster at every cluster size ----------------------


@pytest.mark.parametrize("variant,n_nodes,k,counts", [
    ("open", 700, 16, [90, 70]),
    ("c1m", 2000, 1024, [3000, 2500]),
    ("spread_affinity", 700, 128, [300, 250]),
    ("distinct_hosts", 300, 64, [200, 200]),
    ("tight", 900, 128, [400, 300]),
    ("open", 6, 4, [10, 5]),                   # CTAs that own no node
    ("c1m", 8192, 5000, [9000, 6000]),        # past the shared-memory list
    ("spread_affinity", 1024, "n_pad", [1500, 900]),
    ("open", 32768, "n_pad", [40000]),         # K = n_pad at n_pad >= 32,768
])
def test_chunk_kernel_equals_plain_at_every_cluster_size(cuda, variant, n_nodes, k, counts):
    """K5 at every cluster size the plan allows (a smaller one is refused
    by the plan), each against the plain version on the card and bit for
    bit against the others; C1M's mock nodes tie exactly, so the
    threshold's ties straddle the slices."""
    from nomad_tpu_torch.tpu import chunk

    n_pad = example_chunk_variant_n_pad(variant, n_nodes)
    k = n_pad if k == "n_pad" else k
    n_pad, (s, c, x) = _chunk_case(cuda, variant, n_nodes, k, counts, retry_rounds=1)
    plain = chunk.chunk_scan(n_pad, s, c, x, chunk=k)
    first = None
    for cs in CLUSTER_SIZES:
        try:
            kernels.chunk_scan_plan(s, k, cs)
        except ValueError:
            assert cs < kernels.chunk_scan_plan(s, k).cs
            continue
        before = kernels.LAUNCHES["chunk_scan"]
        got = kernels.chunk_scan(n_pad, s, tuple(t.clone() for t in c), x, chunk=k, cs=cs)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["chunk_scan"] == before + 1
        parity.check_chunk_scan(plain, got, f"chunk {variant} K={k} CS={cs}")
        assert torch.equal(plain[2][0].cpu(), got[2][0].cpu())
        first = first or got
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got[2], first[2]))


def example_chunk_variant_n_pad(variant, n_nodes):
    from nomad_tpu_torch.tpu.engine import example_chunk_variant

    return example_chunk_variant(variant, n_nodes=n_nodes, n_tgs=1, seed=5)[0]


def test_chunk_sections_cover_the_steps(cuda):
    """Section timing: every part of a step counted on every CTA, the
    launch's outputs unchanged."""
    from nomad_tpu_torch.tpu import chunk

    n_pad, (s, c, x) = _chunk_case(cuda, "spread_affinity", 700, 64, [200, 100])
    plain = chunk.chunk_scan(n_pad, s, c, x, chunk=64)
    got, cycles = kernels.chunk_scan_sections(n_pad, s, tuple(t.clone() for t in c), x, chunk=64)
    torch.cuda.synchronize()
    parity.check_chunk_scan(plain, got, "sections")
    assert cycles.shape == (kernels.chunk_scan_plan(s, 64).cs, len(kernels.CHUNK_SECTIONS))
    assert bool((cycles > 0).all())


# -- K3 past the clusters the card holds at once -------------------------------


def test_batched_in_waves_past_the_resident_clusters(cuda):
    """n_pad 33,024 with more evals than the card holds clusters of the
    plan's size at once: the launch runs in waves and equals single
    launches of the same evals bit for bit."""
    base = [example_scan_variant("all", n_nodes=33000, n_tgs=2, n_placements=4, seed=60 + i)
            for i in range(4)]
    n_pad = base[0][0]
    assert n_pad == 33024
    singles = []
    for _, st, ca, xs in base:
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
        singles.append(kernels.place_scan(n_pad, s, c, x))
    B = 80
    for _ in range(2):
        evals = [base[b % 4] for b in range(B)]
        stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
        sb, cb, xb = convert.scan_inputs_to_torch(*stacked, cuda)
        plan = kernels.scan_plan(sb, cb, xb)
        if kernels.scan_waves(plan, B, True) > 1:
            break
        B = kernels.max_active_clusters(plan.cs, plan.smem_bytes, True) + 1
    assert kernels.scan_waves(plan, B, True) > 1
    carry_b, ys_b = kernels.place_scan_batched(sb, cb, xb)
    torch.cuda.synchronize()
    for b in range(B):
        got = (tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b))
        assert _equal(got, singles[b % 4]), f"eval {b}"


@pytest.mark.parametrize("variant,k", [("spread_affinity", 64), ("c1m", 5000)])
def test_chunk_packed_entry_equals_tensor_entry(cuda, variant, k):
    """``kernels.chunk_scan_packed`` on one pinned-and-copied buffer, on a
    stream of its own, gives the tensor entry's outputs and carry."""
    from nomad_tpu_torch.tpu.engine import example_chunk_variant

    from nomad_tpu_torch.tpu import chunk

    n_pad, st, ca = example_chunk_variant(variant, n_nodes=8192 if k > 4096 else 700,
                                          n_tgs=2, seed=3)
    xs = chunk.chunk_schedule([(0, 2 * k + 5), (1, k)], k, retry_rounds=1)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, cuda)
    ref = kernels.chunk_scan(n_pad, s, c, x, chunk=k)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        packed = kernels.pack_chunk_inputs(n_pad, st, ca, xs, np.zeros(2, np.int32), k, cuda)
        out, out_layout = kernels.chunk_scan_packed(packed)
        got = convert.from_device_packed(out, out_layout)
    for a, b in zip(got, convert.to_numpy(ref[2])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _s, p_carry, _x, p_deficit = packed.parts()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(p_carry, ref[0]))
    assert torch.equal(p_deficit, ref[1])
