"""Device-side preemption: vectorized eviction-set construction.

Vectorizes the reference's eviction selection (``scheduler/preemption.go``
:198 PreemptForTaskGroup, :608-660 distance metrics, :663 grouping) as an
exact integer spec in the ``tpu/intscore.py`` discipline: every runtime
operation is an int32/int64 add, multiply, shift, compare or floor
division — bit-identical on every backend — so the device scan's eviction
sets match a pure-Python evaluation of the same spec ON THE REAL CHIP.

The reference algorithm (host oracle, ``scheduler/preemption.py``):

  1. candidates = non-terminal allocs on the node, minus the placing job's
     own allocs; ELIGIBLE candidates additionally have a job and a
     priority at least PRIORITY_DELTA below the placing job's
  2. node remaining = capacity - reserved - sum(ALL candidates) (the
     reference subtracts ineligible candidates too; own-job allocs are
     invisible to the met-check)
  3. greedy: sweep priority groups ascending; within the current group
     pick argmin of distance(resources still needed, candidate) +
     max_parallel penalty (first occurrence on ties), add its resources to
     ``available``, subtract from ``needed``; stop when
     available >= original ask on (cpu, mem, disk) — ``superset`` ignores
     networks. Never met -> no preemption.
  4. second pass: re-rank the greedy set by distance vs the FRESH ask,
     DESCENDING (stable: ties keep greedy order), keep the shortest
     prefix whose resources + remaining meet the ask.

Int spec (Q16 fixed point — THE deterministic-mode spec, used by the host
``Preemptor`` when ``ctx.deterministic`` and by the device kernel, so the
two agree bit-for-bit):

  coordinate  c_d = floor((needed_d - res_d) << 16 / needed_d) when
              needed_d > 0 else 0, clamped to [-CQ_CAP, CQ_CAP]
  distance    dist = isqrt(sum_d c_d**2)      (floor integer sqrt, Q16)
  penalty     ((num_preempted + 1) - max_parallel) * 50 << 16
              when max_parallel > 0 and num_preempted >= max_parallel
  key         dist + penalty

Precision vs the reference's float64: coordinates track the real ratios
within 2**-16 relative and the floor-isqrt collapses only sub-2**-16
relative distance gaps, so orderings agree with the float64 oracle
whenever true distance gaps exceed ~1e-4 — which real resource shapes
(integer MHz/MB asks) clear by orders of magnitude. Exact ties fall to
the same first-occurrence / stable-sort tie-break in both systems.

Magnitude gates (enforced by ``encode.build_preempt_tables``; host
fallback otherwise): resources and asks <= 2**28, candidates per node
<= C_MAX, distinct (job, namespace, task_group) preemption-count groups
<= GP_MAX. The per-coordinate clamp bounds sum-of-squares below 2**62,
so the int64 isqrt is exact.

Copied from ``nomad_tpu/tpu/preempt.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``: the
constants and the pure-Python oracle (the encoder's candidate tables and
the host Preemptor use them), and the device half as PyTorch functions,
the plain versions of what the CUDA scan computes in its ``has_pre``
branch (``csrc/place_scan.cu``, ``csrc/common.cuh``):

  ``isqrt_t``          K8  ``isqrt_jnp``         (``preempt.py:171-188``)
  ``coord_q_t``        K8  ``coord_q_jnp``       (``:191-198``)
  ``greedy_select_t``  K6  ``greedy_select_jnp`` (``:201-240``)
  ``second_pass_t``    K7  ``second_pass_jnp``   (``:243-271``)

Each takes and returns the shapes and dtypes of its jnp counterpart.
``jnp.floor_divide`` floors and ``needed - res`` is often negative, so
the division is ``torch.div(..., rounding_mode="floor")``; the Q16 shift
of a possibly negative difference is written as a multiply by
``CQ_ONE`` (the same value: every magnitude stays far below 2**63).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

CQ_BITS = 16
CQ_ONE = 1 << CQ_BITS
# Per-coordinate clamp: |c_d| <= 2**30 keeps sum(c**2) <= 3*2**60 < 2**62.
CQ_CAP = 1 << 30
# Reference MAX_PARALLEL_PENALTY (50.0), in Q16.
PENALTY_UNIT = 50
# Reference PRIORITY_DELTA (minimum priority gap for eligibility).
PRIORITY_DELTA = 10
# Encode gates (host fallback above these).
C_MAX = 16
GP_MAX = 64
RES_CAP = 1 << 28
_BIG = 1 << 62
_I32_MAX = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Pure-Python spec (the oracle — exact integer math, host-side).
# ---------------------------------------------------------------------------


def coord_q_py(needed_d: int, res_d: int) -> int:
    if needed_d <= 0:
        return 0
    q = ((int(needed_d) - int(res_d)) << CQ_BITS) // int(needed_d)
    return max(-CQ_CAP, min(CQ_CAP, q))


def dist_q_py(needed3: Sequence[int], res3: Sequence[int]) -> int:
    s = 0
    for d in range(3):
        c = coord_q_py(int(needed3[d]), int(res3[d]))
        s += c * c
    return math.isqrt(s)


def penalty_q_py(max_parallel: int, num_preempted: int) -> int:
    if max_parallel > 0 and num_preempted >= max_parallel:
        return ((num_preempted + 1) - max_parallel) * PENALTY_UNIT << CQ_BITS
    return 0


def select_eviction_set_py(
    ask3: Sequence[int],
    remaining3: Sequence[int],
    res3: Sequence[Sequence[int]],
    prio: Sequence[int],
    pen: Sequence[int],
    elig: Sequence[bool],
) -> Optional[List[int]]:
    """The full greedy + second-pass spec over flat candidate arrays in
    node insertion order. Returns candidate indices in final (second-pass)
    order, or None when the ask cannot be met.

    ``remaining3`` is the node remaining AFTER subtracting all candidates
    (the reference's node_remaining_resources at greedy start). ``pen``
    is the Q16 penalty per candidate (static across greedy rounds, like
    the reference's per-group penalty vector).

    The single loop with a per-round minimum-alive-priority restriction
    is exactly the reference's ascending priority-group sweep: a group is
    exhausted before the minimum moves to the next priority, and the
    met-check runs after every eviction.
    """
    n = len(prio)
    alive = [bool(elig[i]) for i in range(n)]
    needed = [int(a) for a in ask3]
    avail = [int(r) for r in remaining3]
    ask = [int(a) for a in ask3]
    order: List[int] = []
    met = False
    while not met and any(alive):
        pmin = min(prio[i] for i in range(n) if alive[i])
        best_key = None
        best_i = -1
        for i in range(n):
            if not alive[i] or prio[i] != pmin:
                continue
            key = dist_q_py(needed, res3[i]) + int(pen[i])
            if best_key is None or key < best_key:
                best_key = key
                best_i = i
        alive[best_i] = False
        order.append(best_i)
        for d in range(3):
            avail[d] += int(res3[best_i][d])
            needed[d] -= int(res3[best_i][d])
        met = all(avail[d] >= ask[d] for d in range(3))
    if not met:
        return None

    # Second pass: distance vs the FRESH ask, descending, stable (ties
    # keep greedy order); shortest covering prefix.
    d2 = [dist_q_py(ask, res3[i]) for i in order]
    srt = sorted(range(len(order)), key=d2.__getitem__, reverse=True)
    avail = [int(r) for r in remaining3]
    out: List[int] = []
    for k in srt:
        i = order[k]
        out.append(i)
        for d in range(3):
            avail[d] += int(res3[i][d])
        if all(avail[d] >= ask[d] for d in range(3)):
            break
    return out


# ---------------------------------------------------------------------------
# Device half, plain PyTorch (the CUDA scan's has_pre branch holds to it).
# ---------------------------------------------------------------------------

I32, I64 = torch.int32, torch.int64


def isqrt_t(n: torch.Tensor) -> torch.Tensor:
    """Floor integer square root of an int64 tensor, 0 <= n < 2**62
    (``isqrt_jnp``): 31 restoring rounds of int64 add/shift/compare,
    exact where a float square root is not."""
    n = n.to(I64)
    x = torch.zeros_like(n)
    r = n
    for shift in range(60, -1, -2):
        bit = 1 << shift
        t = x + bit
        take = r >= t
        r = torch.where(take, r - t, r)
        x = torch.where(take, (x >> 1) + bit, x >> 1)
    return x


def coord_q_t(needed_d: torch.Tensor, res_d: torch.Tensor) -> torch.Tensor:
    """Q16 distance coordinate of int64 tensors, broadcastable
    (``coord_q_jnp``): floor((needed - res) * 2**16 / needed) where
    needed > 0, else 0, clipped to +-CQ_CAP."""
    q = torch.div((needed_d - res_d) * CQ_ONE, needed_d.clamp(min=1),
                  rounding_mode="floor")
    q = torch.where(needed_d > 0, q, torch.zeros_like(q))
    return q.clamp(-CQ_CAP, CQ_CAP)


def greedy_select_t(ask3, res3, prio, pen, alive0, remaining0, stats=None):
    """The greedy eviction sweep over every row at once
    (``greedy_select_jnp``).

    ask3 [3] int64, res3 [N, C, 3] int64, prio [N, C] int32, pen [N, C]
    int64, alive0 [N, C] bool (eligible and not yet evicted), remaining0
    [N, 3] int64. Returns (sel_ord [N, C] int32: the round that took the
    slot or -1, met [N] bool). C rounds; in each, the alive slots of the
    lowest priority are keyed by isqrt(sum coord_q**2) + pen and the
    first minimum is taken. The rounds stop once no row is still
    searching (the jnp version's later rounds take nothing then).
    ``stats``, a dict, gains ``greedy_keys``: the keys computed on rows
    still searching (the work the result needs)."""
    n_pad, c_w = res3.shape[0], res3.shape[1]
    dev = res3.device
    alive = alive0.clone()
    needed = ask3.to(I64)[None, :].expand(n_pad, 3).clone()
    avail = remaining0.to(I64).clone()
    met = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    sel_ord = torch.full((n_pad, c_w), -1, dtype=I32, device=dev)
    i32_max = torch.full_like(prio, _I32_MAX)
    big = torch.full((n_pad, c_w), _BIG, dtype=I64, device=dev)
    for t in range(c_w):
        active = (~met) & alive.any(dim=1)
        pmin = torch.where(alive, prio, i32_max).amin(dim=1)
        cand = alive & (prio == pmin[:, None])
        keys = int((cand & active[:, None]).sum())
        if keys == 0:
            break
        if stats is not None:
            stats["greedy_keys"] = stats.get("greedy_keys", 0) + keys
        q = coord_q_t(needed[:, None, :], res3)                   # [N, C, 3]
        key = isqrt_t((q * q).sum(dim=-1)) + pen
        key = torch.where(cand, key, big)
        kmin = key.amin(dim=1)
        is_min = cand & (key == kmin[:, None])
        # first occurrence on ties (the reference's strict-< argmin scan)
        first = is_min & (torch.cumsum(is_min.to(I32), dim=1, dtype=I32) == 1)
        take = first & active[:, None]
        sel_ord = torch.where(take, torch.full_like(sel_ord, t), sel_ord)
        freed = torch.where(take[:, :, None], res3, torch.zeros_like(res3)).sum(dim=1)
        avail = avail + freed
        needed = needed - freed
        alive = alive & ~take
        did = take.any(dim=1)
        met = met | (did & (avail >= ask3[None, :]).all(dim=1))
    return sel_ord, met


def second_pass_t(ask3, res3_ch, sel_ord_ch, remaining_ch):
    """The second-pass filter of ONE row's greedy set
    (``second_pass_jnp``): ranks by distance to the fresh ask,
    descending, ties in greedy order; keeps the shortest rank prefix
    whose resources plus ``remaining_ch`` meet the ask. Returns (keep
    [C] bool, rank [C] int64: the jnp version's rank is a ``jnp.sum`` of
    int32, which x64 promotes to int64)."""
    selected = sel_ord_ch >= 0
    q = coord_q_t(ask3[None, :].to(I64), res3_ch)
    d2 = isqrt_t((q * q).sum(dim=-1))                             # [C]
    before = (d2[None, :] > d2[:, None]) | (
        (d2[None, :] == d2[:, None]) & (sel_ord_ch[None, :] < sel_ord_ch[:, None]))
    rank = (before & selected[None, :]).sum(dim=1, dtype=I64)
    i32_max = torch.full_like(rank, _I32_MAX)
    rank = torch.where(selected, rank, i32_max)
    prefix = selected[None, :] & (rank[None, :] <= rank[:, None])
    cum = torch.where(prefix[:, :, None], res3_ch[None, :, :],
                      torch.zeros_like(res3_ch)[None, :, :]).sum(dim=1)
    met_c = (remaining_ch[None, :] + cum >= ask3[None, :]).all(dim=1)
    first_met = torch.where(selected & met_c, rank, i32_max).min()
    keep = selected & (rank <= first_met)
    return keep, rank
