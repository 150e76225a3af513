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
