"""Plain PyTorch version of the chunked throughput scan (K5).

The same program as ``nomad_tpu/tpu/engine.py`` ``_build_chunk_scan``
(``:3033-3210``): each step places up to K instances of one task group
on the top-K scoring distinct feasible nodes, in the float arm only.
Every chosen node is capacity-checked for one ask, so the plan is
valid; scores refresh between chunks, not between placements. A per-TG
deficit rides beside the carry: a chunk that places fewer than asked
rolls the shortfall into that task group's later steps, including the
want = 0 retry steps ``chunk_schedule(retry_rounds=...)`` appends.

It is what ``kernels.chunk_scan`` runs for tensors on the CPU, and what
the CUDA kernel (``csrc/chunk_scan.cu``) is held against on the card.

Call contract (the JAX ``chunk_scan``'s): ``chunk_scan(n_pad, static,
carry, xs, deficit=None) -> (carry, deficit, (top_idx, top_scores,
valid, placed))`` with the float arm's 26 static and 12 carry arrays
and ``xs = (tg_idx, want)``, int32 ``[T]``. Outputs: ``top_idx`` int32
``[T, K]``, ``top_scores`` f32 ``[T, K]`` (0 where not valid),
``valid`` bool ``[T, K]``, ``placed`` int32 ``[T]``; ``deficit`` int32
``[G]``. Pure: the inputs are not modified.

The top-K order is explicit: descending score, then ascending node
index, which is ``lax.top_k``'s order (floats in IEEE total order: +0
above -0, a NaN above +inf). ``torch.topk`` fixes no order among ties,
and C1M's mock nodes tie exactly, so the plain version sorts a 32-bit
order-preserving key of each node's masked score with a stable
descending sort, and the kernel selects and sorts the same keys.

Like the JAX step it reads no distinct_property, reschedule-penalty,
eviction or preemption input (``_chunk_eligible`` keeps such evals off
the tier, except distinct_property: see ROADMAP.md) and leaves
``spread_entry``, ``offset``, ``failed`` and the rest of the carry as
they are. Each operation rounds on its own in f32, in the JAX
program's order; the spread terms are summed over s = 0..S-1 in index
order, and every divisor is a tensor on the inputs' device (as in
``step.py``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .encode import DIM_CPU, DIM_MEM
from .intscore import (
    FEAT_AFF_BIT,
    FEAT_FEAS_BIT,
    pack_presence_lanes_torch,
    popcount4_torch,
    unpack_feat_lane_torch,
)
from .step import F32_BIG, _gather_vid

#: default chunk size (engine.py:3030)
CHUNK_K = 128

I32, I64, F32 = torch.int32, torch.int64, torch.float32


def chunk_schedule(counts_by_tg: Sequence[Tuple[int, int]], chunk: int = CHUNK_K,
                   retry_rounds: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-TG placement counts into (tg_idx, want) step arrays
    (engine.py:3213-3237).

    Round-robin across task groups: scheduling one TG to completion
    before the next starves the last TGs of capacity and piles the
    whole deficit on them. ``retry_rounds`` appends want = 0 sweeps per
    TG: the scan's deficit carry drains any shortfall through them,
    never over-placing (a want = 0 step with zero deficit is a no-op)."""
    remaining = {gi: count for gi, count in counts_by_tg}
    tg_steps: List[Tuple[int, int]] = []
    while any(v > 0 for v in remaining.values()):
        for gi, _count in counts_by_tg:
            if remaining[gi] <= 0:
                continue
            take = min(remaining[gi], chunk)
            tg_steps.append((gi, take))
            remaining[gi] -= take
    for _ in range(max(0, retry_rounds)):
        for gi, _count in counts_by_tg:
            tg_steps.append((gi, 0))
    tg_idx = np.asarray([s[0] for s in tg_steps], np.int32)
    want = np.asarray([s[1] for s in tg_steps], np.int32)
    return tg_idx, want


def score_key(masked: torch.Tensor) -> torch.Tensor:
    """The 32-bit order-preserving key of each f32 value, as int64 in
    [0, 2**32): IEEE total order (-inf below every finite value, -0
    below +0), the order ``lax.top_k`` sorts in. The kernel computes
    the same key as a uint32."""
    bits = masked.contiguous().view(I32).to(I64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    return torch.where(neg, 0xFFFFFFFF - bits, bits | 0x80000000)


def top_k_ordered(masked: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest entries of ``masked`` by
    descending score, ties by ascending index (``lax.top_k``)."""
    order = torch.sort(score_key(masked), descending=True, stable=True).indices[:k]
    return masked[order], order.to(I32)


def masked_scores(static, carry, g: int) -> torch.Tensor:
    """One step's masked score row (engine.py:3079-3166): each node's f32
    score where it is feasible for one ask of task group ``g``, -inf
    elsewhere."""
    (totals, reserved, asks, feat_packed, aff_score, desired_counts,
     dh_job, dh_tg, _limits, spread_vids, spread_desired, spread_weights,
     _has_targets, spread_active, sum_spread_weights, n_real, *_extra) = static
    used, tg_counts, job_counts, spread_counts = carry[:4]
    dev = totals.device
    n_pad = totals.shape[0]
    f = lambda v: torch.tensor(v, dtype=F32, device=dev)  # noqa: E731
    one, zero, minus_one, eps = f(1.0), f(0.0), f(-1.0), f(1e-9)
    iota = torch.arange(n_pad, dtype=I32, device=dev)

    ask = asks[g]
    feat_g = feat_packed[g]
    feas_g = unpack_feat_lane_torch(feat_g, FEAT_FEAS_BIT)
    tg_counts_g = tg_counts[g]

    util = used + reserved + ask[None, :]
    fits = (util <= totals).all(dim=-1)
    if bool(dh_job[g]):
        dh_mask = job_counts == 0
    elif bool(dh_tg[g]):
        dh_mask = ~((tg_counts_g > 0) & (job_counts > 0))
    else:
        dh_mask = torch.ones(n_pad, dtype=torch.bool, device=dev)
    feasible = feas_g & fits & dh_mask & (iota < n_real.to(I32))

    node_cpu = totals[:, DIM_CPU] - reserved[:, DIM_CPU]
    node_mem = totals[:, DIM_MEM] - reserved[:, DIM_MEM]
    free_cpu = one - util[:, DIM_CPU] / torch.maximum(node_cpu, eps)
    free_mem = one - util[:, DIM_MEM] / torch.maximum(node_mem, eps)
    ten = f(10.0)
    fitness = f(20.0) - (torch.pow(ten, free_cpu) + torch.pow(ten, free_mem))
    binpack = torch.minimum(torch.maximum(fitness, zero), f(18.0)) / f(18.0)

    anti_present = tg_counts_g > 0
    anti = torch.where(anti_present,
                       -(tg_counts_g.to(F32) + one) / desired_counts[g].to(F32), zero)

    # the zero-size affinity axis (affinity-free evals; the r2 crash
    # shape of tests/test_chunk_scan.py) scores no affinity term
    if aff_score.shape[0] == 0:
        aff = torch.zeros(n_pad, dtype=F32, device=dev)
        aff_p = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    else:
        aff = aff_score[g]
        aff_p = unpack_feat_lane_torch(feat_g, FEAT_AFF_BIT)

    # targeted spread only (the chunk step reads no spread_has_targets)
    vids = spread_vids[g]                                      # [S, N]
    used_count = _gather_vid(spread_counts[g], vids) + one     # [S, N]
    d = _gather_vid(spread_desired[g], vids)
    missing = vids == (spread_desired.shape[-1] - 1)
    weight_frac = spread_weights[g][:, None] / torch.maximum(sum_spread_weights[g], eps)
    pos = d > zero
    targeted = torch.where(
        pos,
        (d - used_count) / torch.where(pos, d, one) * weight_frac,
        torch.where(d == zero, -f(F32_BIG), minus_one),
    )
    per_spread = torch.where(missing, minus_one, targeted)
    per_spread = torch.where(spread_active[g][:, None], per_spread, zero)
    spread_total = torch.zeros_like(binpack)
    for s in range(per_spread.shape[0]):
        spread_total = spread_total + per_spread[s]
    spread_p = spread_total != zero

    # no reschedule penalties on this tier: that lane rides constant-false
    presence = pack_presence_lanes_torch(
        anti_present, torch.zeros_like(anti_present), aff_p, spread_p)
    num_terms = (1 + popcount4_torch(presence)).to(F32)
    final = (binpack + anti + torch.where(aff_p, aff, zero) + spread_total) / num_terms
    return torch.where(feasible, final, f(float("-inf")))


def chunk_step(static, carry, deficit, g: int, want: int, chunk: int):
    """One chunk of task group ``g`` (engine.py:3064-3195). ``carry`` and
    ``deficit`` are updated in place (the caller owns clones); returns
    the step's ``(top_idx, top_scores, valid, placed)``."""
    masked = masked_scores(static, carry, g)
    dev = masked.device
    top_scores, top_idx = top_k_ordered(masked, chunk)
    want_total = want + int(deficit[g])
    want_eff = min(want_total, chunk)
    valid = ((torch.arange(chunk, dtype=I32, device=dev) < want_eff)
             & (top_scores > float("-inf")))
    placed = int(valid.sum())
    deficit[g] = want_total - placed

    # the chosen nodes are distinct: each gains one ask and one count
    used, tg_counts, job_counts, spread_counts = carry[:4]
    asks, spread_vids, spread_active = static[2], static[9], static[13]
    nodes = top_idx[valid].to(I64)
    used[nodes] = used[nodes] + asks[g][None, :]
    tg_counts[g, nodes] += 1
    job_counts[nodes] += 1
    v_plus = spread_counts.shape[-1]
    for s in range(spread_counts.shape[1]):
        if not bool(spread_active[g, s]):
            continue
        vid = spread_vids[g, s, nodes].to(I64)
        vid = vid[(vid >= 0) & (vid < v_plus)]
        # per value, how many chosen nodes carry it: an exact f32 count
        add = torch.bincount(vid, minlength=v_plus).to(F32)
        spread_counts[g, s] = spread_counts[g, s] + add
    out_scores = torch.where(valid, top_scores, torch.zeros_like(top_scores))
    return top_idx, out_scores, valid, placed


def chunk_scan(n_pad: int, static, carry, xs, deficit=None, chunk: int = CHUNK_K):
    """Scan the chunk step over ``xs = (tg_idx, want)`` with chunk size
    ``chunk`` (K, the ``chunk_k`` of JAX's ``_build_chunk_scan``; at most ``n_pad``).
    Pure: returns ``(final_carry, deficit_out, (top_idx, top_scores,
    valid, placed))`` on the inputs' device. The deficit rides along so
    a multi-phase schedule (bulk chunks, then tail chunks) hands
    unfilled counts to the next phase (engine.py:3197-3208)."""
    totals = static[0]
    if totals.dtype != F32:
        raise NotImplementedError(f"the chunk scan runs in the float arm only (got {totals.dtype})")
    if totals.shape[0] != n_pad:
        raise ValueError(f"n_pad {n_pad} != node axis {totals.shape[0]}")
    if static[1].shape[0] != n_pad:
        raise ValueError("the chunk scan needs full-height reserved (not folded into totals)")
    if not 1 <= chunk <= n_pad:
        raise ValueError(f"chunk size {chunk} outside [1, n_pad={n_pad}]")
    dev = totals.device
    g_count = static[2].shape[0]
    carry = tuple(c.clone() for c in carry)
    deficit = (torch.zeros(g_count, dtype=I32, device=dev) if deficit is None
               else deficit.clone())
    tg_idx, want = xs
    outs = [chunk_step(static, carry, deficit, g, w, chunk)
            for g, w in zip(tg_idx.tolist(), want.tolist())]
    t = len(outs)
    if t:
        top_idx = torch.stack([o[0] for o in outs])
        top_scores = torch.stack([o[1] for o in outs])
        valid = torch.stack([o[2] for o in outs])
    else:
        top_idx = torch.zeros((0, chunk), dtype=I32, device=dev)
        top_scores = torch.zeros((0, chunk), dtype=F32, device=dev)
        valid = torch.zeros((0, chunk), dtype=torch.bool, device=dev)
    placed = torch.tensor([o[3] for o in outs], dtype=I32, device=dev)
    return carry, deficit, (top_idx, top_scores, valid, placed)
