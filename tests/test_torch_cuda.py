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
