"""How the float arm of the placement scan is held against a reference.

The int arm is exact: every comparison there is bit for bit. The float
arm rounds in f32, and ``pow(10, x)`` is not bit-equal between XLA's CPU
backend, PyTorch's CPU kernels and CUDA's ``powf``, so a float scan is
held against another by two numbers:

  * the per-task-group placement-multiset divergence of the chosen
    nodes, the measure of the JAX engine's sampled parity check
    (``nomad_tpu/tpu/engine.py:1358`` ``_maybe_sample_parity``): for
    each task group, how many of its placements are on nodes the
    reference did not pick as often;
  * the largest score difference over the placements where both picked
    the same node.

``FLOAT_SCORE_TOL`` bounds the second: scores are means of terms of
magnitude at most a few units, so a few f32 ulps of ``pow`` come to
well under 1e-6; 1e-5 leaves room for the order of the spread sum.
``FLOAT_DIVERGENCE_BOUND`` bounds the first: 0, since on the seeded
inputs of the tests and ``chip_smoke.py`` no near-tie flips a pick.
``check_float_scan`` applies both to two scans' outputs.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import numpy as np

FLOAT_SCORE_TOL = 1e-5
FLOAT_DIVERGENCE_BOUND = 0


def tg_multiset_divergence(got, ref, tg_idx) -> int:
    """Placements (per task group, as multisets of chosen nodes) of
    ``got`` that ``ref`` does not match."""
    got, ref, tg_idx = (np.asarray(a) for a in (got, ref, tg_idx))
    diverged = 0
    for gi in np.unique(tg_idx):
        sel = tg_idx == gi
        diverged += sum((Counter(got[sel].tolist())
                         - Counter(ref[sel].tolist())).values())
    return int(diverged)


def score_diff_at_equal_picks(chosen_a, scores_a, chosen_b, scores_b) -> Tuple[int, float]:
    """(placements where both chose the same node, the largest absolute
    score difference among them; 0.0 when there are none)."""
    ca, cb = np.asarray(chosen_a), np.asarray(chosen_b)
    same = ca == cb
    if not same.any():
        return 0, 0.0
    sa = np.asarray(scores_a, np.float64)[same]
    sb = np.asarray(scores_b, np.float64)[same]
    return int(same.sum()), float(np.abs(sa - sb).max())


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def check_float_scan(ref, got, tg_idx, what: str = "float scan") -> Tuple[int, float, bool]:
    """Hold a float-arm scan's ``(carry, (chosen, scores, pulls, skipped,
    evict))`` against a reference's (tensors or numpy arrays): at most
    ``FLOAT_DIVERGENCE_BOUND`` placements diverge per task group, scores
    at equal picks within ``FLOAT_SCORE_TOL``, pulls and skipped flags
    equal, and, when no placement diverged, integer carries equal and
    float carries within ``FLOAT_SCORE_TOL``. Returns (divergence, max
    |dscore| at equal picks, bit-exact?); raises AssertionError naming
    ``what`` on a breach."""
    (rc, ry), (gc, gy) = ref, got
    ry, gy = [_np(a) for a in ry], [_np(a) for a in gy]
    div = tg_multiset_divergence(gy[0], ry[0], _np(tg_idx))
    _, diff = score_diff_at_equal_picks(ry[0], ry[1], gy[0], gy[1])
    if div > FLOAT_DIVERGENCE_BOUND or diff > FLOAT_SCORE_TOL:
        raise AssertionError(f"{what}: {div} placements diverged, max |dscore| {diff}")
    exact = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(ry, gy))
    if div:
        return div, diff, exact
    for name, a, b in zip(("pulls", "skipped", "evict"), ry[2:], gy[2:]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    for i, (a, b) in enumerate(zip(rc, gc)):
        a, b = _np(a), _np(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: final carry entry {i} dtype or shape differs")
        if a.dtype.kind == "f":
            if a.size and float(np.abs(a.astype(np.float64) - b).max()) > FLOAT_SCORE_TOL:
                raise AssertionError(f"{what}: float carry entry {i} differs")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{what}: final carry entry {i} differs")
        exact = exact and np.array_equal(a, b)
    return div, diff, exact
