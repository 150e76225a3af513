"""Plain PyTorch version of the placement scan, both arms.

The same program as ``nomad_tpu/tpu/engine.py`` ``_make_step`` (one
placement over all N nodes) scanned over an eval's P placements by
``_build_place_scan``, written step by step in torch ops. It is the
reference the hand-written CUDA kernel (``csrc/place_scan.cu``) is held
against, and what ``kernels.place_scan`` runs for tensors on the CPU.
Nothing on the main path calls it when the tensors are on CUDA.

Call contract (the JAX scan's): ``place_scan(n_pad, static, carry, xs)
-> (carry, (chosen, scores, pulls, skipped, evict))``, with the 26
static, 12 carry and 10 per-placement arrays in the order
``encode_eval`` builds them. The dtype of ``totals`` picks the arm:

  * int32 (``deterministic=True``): the exact integer spec, int64
    score60 selection (``engine.py:471-574``);
  * float32 (the server's default): f32 scores from ``pow(10, free)``
    binpack, ``-(c+1)/desired`` anti-affinity, the reschedule penalty,
    targeted and even spread, divided by the number of terms
    (``engine.py:575-639``). Each operation rounds on its own, in the
    JAX program's order, and every divisor is a tensor on the inputs'
    device (PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead).

Every branch a generic eval takes is covered in both arms:

  * eviction of the previous alloc and its revert on failure;
  * the affinity G axis present or absent;
  * distinct_hosts, the forced-node restriction, distinct_property;
  * the reschedule penalty axis;
  * targeted and even spread boosts;
  * the packed-lane ring cumsum (n_pad < PACK_COUNT_MAX) and the two
    plain cumsums above it.

Preemption (a candidate axis C > 0) raises: its kernels come with the
preemption slice.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

import torch

from .encode import DIM_CPU, DIM_MEM
from .intscore import (
    BIG_FP,
    E27_BITS,
    E27_ONE,
    FEAT_AFF_BIT,
    FEAT_FEAS_BIT,
    PACK_COUNT_MAX,
    RECIP_BITS,
    TERM_BITS,
    TERM_ONE,
    pack_count_lanes_torch,
    pack_presence_lanes_torch,
    popcount4_torch,
    unpack_count_hi_torch,
    unpack_count_lo_torch,
    unpack_feat_lane_torch,
)

MAX_SKIP = 3
# jnp.iinfo(jnp.int64).min // 4 (engine.py:573)
NEG_INF = -(1 << 63) // 4
INT32_MAX = 2**31 - 1

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
#: jnp.finfo(jnp.float32).max / 16.0 (engine.py:587), the clamp of a
#: targeted spread boost whose desired count is 0
F32_BIG = float(torch.finfo(F32).max) / 16.0


def _check_arm(static) -> None:
    totals, pre_res = static[0], static[20]
    if totals.dtype not in (I32, F32):
        raise NotImplementedError(
            f"the scan has an int32 and a float32 arm (got {totals.dtype})")
    if pre_res.shape[1] > 0:
        raise NotImplementedError(
            "preemption (candidate axis C > 0) is not ported")


def _gather_vid(table, vids):
    """table[r, vids[r, i]] for a [R, V] table and [R, N] value ids;
    0 where an id lies outside [0, V) (the one-hot sum's result)."""
    v = table.shape[-1]
    ok = (vids >= 0) & (vids < v)
    got = torch.gather(table, 1, vids.clamp(0, v - 1).to(I64))
    return torch.where(ok, got, torch.zeros_like(got))


def _step(static, carry, x, skip_step: bool):
    """One placement. ``carry`` is updated in place (the caller owns
    clones of the initial carry); returns the step's outputs."""
    (totals, reserved, asks, feat_packed, aff_score, desired_counts,
     dh_job, dh_tg, _limits, spread_vids, spread_desired, spread_weights,
     spread_has_targets, spread_active, _sum_spread_weights, n_real,
     e_ask, dp_vids, dp_limit, dp_applies,
     _pre_res, _pre_prio, _pre_elig, _pre_mp, _pre_gid, _pre_evf) = static
    (used, tg_counts, job_counts, spread_counts, spread_entry, offset_t,
     failed, e_base, dp_counts, _pre_alive, _pre_remaining, _pre_counts) = carry
    (g, penalty_idx, evict_node, evict_res, evict_tg, limit, sum_sw,
     ev_factor, rev_factor, forced_node) = x

    dev = totals.device
    n_pad = totals.shape[0]
    v_plus = spread_desired.shape[-1]
    iota = torch.arange(n_pad, dtype=I32, device=dev)
    offset = int(offset_t)
    n_real_i = int(n_real)

    # -- eviction of the previous alloc (engine.py:291-332) ---------------
    has_evict = evict_res.shape[-1] > 0
    if has_evict:
        do_evict = evict_node >= 0 and not skip_step
        ev_node = max(evict_node, 0)
        ev_tg = max(evict_tg, 0)
        ev_dec = torch.zeros(spread_active.shape[1], dtype=torch.bool, device=dev)
        ev_vid = spread_vids[ev_tg, :, ev_node]                     # [S]
        if do_evict:
            used[ev_node] -= evict_res
            job_counts[ev_node] -= 1
            if evict_tg >= 0:
                tg_counts[ev_tg, ev_node] -= 1
                ev_dec = spread_active[ev_tg].clone()
            _add_vid(spread_counts[ev_tg], ev_vid, -ev_dec.to(spread_counts.dtype))
            if e_base.shape[0]:
                e_base[ev_node] = (
                    (e_base[ev_node].to(I64) * ev_factor.to(I64)) >> E27_BITS
                ).to(I32)

    # -- row selects (engine.py:335-354) ----------------------------------
    ask = asks[g]                                              # [D]
    feat_g = feat_packed[g]                                    # [N] uint8
    feas_g = unpack_feat_lane_torch(feat_g, FEAT_FEAS_BIT)
    tg_counts_g = tg_counts[g]
    desired_g = int(desired_counts[g])
    if aff_score.shape[0] == 0:
        aff = torch.zeros(n_pad, dtype=totals.dtype, device=dev)
        aff_p = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    else:
        aff = aff_score[g]
        aff_p = unpack_feat_lane_torch(feat_g, FEAT_AFF_BIT)

    # -- feasibility (engine.py:361-436) ----------------------------------
    if reserved.shape[0]:
        util = used + reserved + ask[None, :]
    else:
        util = used + ask[None, :]
    fits = (util <= totals).all(dim=-1)
    if bool(dh_job[g]):
        dh_mask = job_counts == 0
    elif bool(dh_tg[g]):
        dh_mask = ~((tg_counts_g > 0) & (job_counts > 0))
    else:
        dh_mask = torch.ones(n_pad, dtype=torch.bool, device=dev)
    feasible = feas_g & fits & dh_mask
    unforced = True
    if forced_node.shape[-1]:
        fnode = int(forced_node[0])
        unforced = fnode < 0
        feasible = feasible & ((fnode < 0) | (iota == fnode))
    if dp_vids.shape[0]:
        v2 = dp_counts.shape[-1]
        dp_cnt_n = _gather_vid(dp_counts.clamp(min=0), dp_vids)    # [Ddp, N]
        dp_applies_g = dp_applies[g]                               # [Ddp]
        dp_missing = dp_vids == (v2 - 1)
        dp_ok = (~dp_applies_g[:, None]) | (
            (~dp_missing) & (dp_cnt_n < dp_limit[:, None]))
        feasible = feasible & dp_ok.all(dim=0)

    # -- score terms (engine.py:438-639) ----------------------------------
    if penalty_idx.shape[-1] == 0:
        pmask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    else:
        pmask = (iota[:, None] == penalty_idx[None, :]).any(dim=-1)
    # the task group's rows that both score arms read
    terms = SimpleNamespace(
        desired_g=desired_g, desired_g_t=desired_counts[g],
        tg_counts_g=tg_counts_g, pmask=pmask,
        aff=aff, aff_p=aff_p, vids=spread_vids[g],
        s_counts=spread_counts[g].clamp(min=0), s_entry=spread_entry[g],
        desired_sv=spread_desired[g], weights_s=spread_weights[g],
        has_targets_s=spread_has_targets[g], active_s=spread_active[g],
        sum_sw=sum_sw)
    if totals.dtype == I32:
        final, e_sel, neg_inf = _score_int(terms, e_base, e_ask[g])
    else:
        final, neg_inf = _score_float(terms, totals, reserved, util)
        e_sel = None
    vids = terms.vids
    active_s = terms.active_s

    # -- ring-ordered limit + max-score selection (engine.py:660-723) -----
    valid = iota < n_real_i
    nr = max(n_real_i, 1)
    feas_v = feasible & valid
    low = feas_v & (final <= 0)

    def ring_cumsum(a_int):
        s_nat = torch.cumsum(a_int, dim=0, dtype=I32)
        total = s_nat[-1]
        before = torch.where(iota < offset, a_int, torch.zeros_like(a_int)).sum(
            dtype=I32)
        ring = torch.where(iota >= offset, s_nat - before, s_nat + (total - before))
        return ring, total

    if n_pad < PACK_COUNT_MAX:
        packed_cum, packed_total = ring_cumsum(pack_count_lanes_torch(low, feas_v))
        low_cum = unpack_count_lo_torch(packed_cum)
        feas_cum = unpack_count_hi_torch(packed_cum)
        low_total = int(unpack_count_lo_torch(packed_total))
        feas_total = int(unpack_count_hi_torch(packed_total))
    else:
        low_cum, low_total_t = ring_cumsum(low.to(I32))
        feas_cum, feas_total_t = ring_cumsum(feas_v.to(I32))
        low_total, feas_total = int(low_total_t), int(feas_total_t)

    skipped = low & (low_cum <= MAX_SKIP)
    skip_cum = low_cum.clamp(max=MAX_SKIP)
    ret = feas_v & ~skipped
    ret_cum = feas_cum - skip_cum
    ret_excl = ret_cum - ret.to(I32)

    pulled = valid & (ret_excl < limit)
    src_cand = ret & pulled
    ret_total = feas_total - min(low_total, MAX_SKIP)
    backlog_n = max(limit - ret_total, 0)
    skip_excl = skip_cum - skipped.to(I32)
    backlog_cand = skipped & (skip_excl < backlog_n)
    cand = src_cand | backlog_cand

    rank = torch.where(src_cand, ret_excl, ret_total + skip_excl)
    cand_scores = torch.where(cand, final, torch.full_like(final, neg_inf))
    best_score = cand_scores.max().item()
    winners = cand & (cand_scores == best_score)
    best_rank = int(torch.where(winners, rank, torch.full_like(rank, INT32_MAX)).min())
    chosen = -1
    if bool(cand.any()) and not skip_step:
        # torch.argmax takes no bools and returns the first maximum
        chosen = int(torch.argmax((winners & (rank == best_rank)).to(I32)))
    pulls = 0 if skip_step else int(pulled.sum())
    if not skip_step:
        offset_t.fill_((offset + pulls) % nr)

    # -- apply placement (engine.py:726-754) ------------------------------
    success = chosen >= 0
    if success:
        ch = chosen
        used[ch] += ask
        tg_counts[g, ch] += 1
        job_counts[ch] += 1
        inc = active_s.to(spread_counts.dtype)                 # [S]
        ch_vid = vids[:, ch]
        _add_vid(spread_counts[g], ch_vid, inc)
        _or_vid(spread_entry[g], ch_vid, active_s)
        if e_sel is not None:
            e_base[ch] = e_sel[ch].to(I32)
        if dp_vids.shape[0]:
            _add_vid(dp_counts, dp_vids[:, ch], dp_applies_g.to(I32))

    # -- failed placement: revert eviction, mark TG failed (:835-857) -----
    if has_evict and do_evict and not success:
        used[ev_node] += evict_res
        job_counts[ev_node] += 1
        if evict_tg >= 0:
            tg_counts[ev_tg, ev_node] += 1
        _add_vid(spread_counts[ev_tg], ev_vid, ev_dec.to(spread_counts.dtype))
        if e_base.shape[0]:
            e_base[ev_node] = (
                (e_base[ev_node].to(I64) * rev_factor.to(I64)) >> E27_BITS
            ).to(I32)
    if not success and not skip_step and unforced:
        failed[g] = True

    return chosen, (best_score if success else 0), pulls


def _spread_lookup(t):
    """Per spread and node: the value's count (floored at 0), its
    desired count, and whether the node lacks the property."""
    current = _gather_vid(t.s_counts, t.vids)                  # [S, N]
    d = _gather_vid(t.desired_sv, t.vids)
    missing = t.vids == (t.desired_sv.shape[-1] - 1)
    return current, d, missing


def _score_int(t, e_base, ea):
    """The exact integer spec (engine.py:471-574): the int64 score60 of
    every node, the selection-time exponentials and the non-candidate
    score."""
    n_pad = t.tg_counts_g.shape[0]
    dev = t.tg_counts_g.device
    anti_present = t.tg_counts_g > 0
    current, d, missing = _spread_lookup(t)
    current = current.to(I64)
    d64 = d.to(I64)
    invalid_bucket = t.desired_sv.shape[-1] - 1
    has_entries = t.s_entry[:, :invalid_bucket].any(dim=-1)    # [S]

    e_sel = (e_base.to(I64) * ea.to(I64)) >> E27_BITS          # [N, 2]
    fit = (20 * E27_ONE - e_sel[:, 0] - e_sel[:, 1]).clamp(0, 18 * E27_ONE)
    binpack = torch.div(fit * 4, 9, rounding_mode="floor")

    rsh = RECIP_BITS - TERM_BITS
    q_d = (1 << RECIP_BITS) // max(t.desired_g, 1)
    zero64 = torch.zeros(n_pad, dtype=I64, device=dev)
    anti = torch.where(
        anti_present, -(((t.tg_counts_g.to(I64) + 1) * q_d) >> rsh), zero64)
    resched = torch.where(t.pmask, zero64 - TERM_ONE, zero64)

    u64 = current + 1
    w64 = t.weights_s.to(I64)[:, None]
    sw64 = max(int(t.sum_sw), 1)
    t_num = (d64 - 100 * u64) * w64 * TERM_ONE
    t_den = d64.clamp(min=1) * sw64
    targeted_raw = torch.where(
        d64 > 0,
        torch.div(t_num, t_den, rounding_mode="floor"),
        torch.where(d64 == 0, torch.full_like(d64, -BIG_FP),
                    torch.full_like(d64, -TERM_ONE)),
    )

    large = 1 << 40
    sc64 = t.s_counts.to(I64)[:, :invalid_bucket]
    se = t.s_entry[:, :invalid_bucket]
    min_c = torch.where(
        has_entries,
        torch.where(se, sc64, torch.full_like(sc64, large)).min(dim=-1).values,
        torch.zeros_like(has_entries, dtype=I64))
    max_c = torch.where(
        has_entries,
        torch.where(se, sc64, torch.full_like(sc64, -large)).max(dim=-1).values,
        torch.zeros_like(has_entries, dtype=I64))
    r_min = torch.div(torch.full_like(min_c, 1 << RECIP_BITS),
                      min_c.clamp(min=1), rounding_mode="floor")
    min_cn = min_c[:, None]
    max_cn = max_c[:, None]
    minus_one = torch.full_like(current, -TERM_ONE)
    delta_boost = torch.where(
        min_cn == 0, minus_one, ((min_cn - current) * r_min[:, None]) >> rsh)
    even = torch.where(
        current != min_cn,
        delta_boost,
        torch.where(
            min_cn == max_cn,
            minus_one,
            torch.where(min_cn == 0, torch.full_like(current, TERM_ONE),
                        ((max_cn - min_cn) * r_min[:, None]) >> rsh),
        ),
    )
    even = torch.where(has_entries[:, None], even, torch.zeros_like(even))

    per_spread = torch.where(t.has_targets_s[:, None], targeted_raw, even)
    per_spread = torch.where(missing, minus_one, per_spread)
    per_spread = torch.where(t.active_s[:, None], per_spread,
                             torch.zeros_like(per_spread))
    spread_total = per_spread.sum(dim=0)                       # [N] int64
    spread_p = spread_total != 0

    presence = pack_presence_lanes_torch(anti_present, t.pmask, t.aff_p, spread_p)
    num_terms = 1 + popcount4_torch(presence)
    factor = (60 // num_terms).to(I64)
    final = (binpack + anti + resched
             + torch.where(t.aff_p, t.aff.to(I64), zero64) + spread_total) * factor
    return final, e_sel, NEG_INF


def _score_float(t, totals, reserved, util):
    """The float32 arm (engine.py:575-639): the f32 score of every node
    and the non-candidate score. Constants that divide are f32 tensors
    on the device (see the module doc)."""
    dev = totals.device
    f = lambda v: torch.tensor(v, dtype=F32, device=dev)  # noqa: E731
    one, zero, minus_one, eps = f(1.0), f(0.0), f(-1.0), f(1e-9)
    if reserved.shape[0]:
        node_cpu = totals[:, DIM_CPU] - reserved[:, DIM_CPU]
        node_mem = totals[:, DIM_MEM] - reserved[:, DIM_MEM]
    else:
        node_cpu, node_mem = totals[:, DIM_CPU], totals[:, DIM_MEM]
    free_cpu = one - util[:, DIM_CPU] / torch.maximum(node_cpu, eps)
    free_mem = one - util[:, DIM_MEM] / torch.maximum(node_mem, eps)
    ten = f(10.0)
    fitness = f(20.0) - (torch.pow(ten, free_cpu) + torch.pow(ten, free_mem))
    binpack = torch.minimum(torch.maximum(fitness, zero), f(18.0)) / f(18.0)

    anti_present = t.tg_counts_g > 0
    collisions = t.tg_counts_g.to(F32)
    desired = t.desired_g_t.to(F32)
    anti = torch.where(anti_present, -(collisions + one) / desired, zero)
    resched = torch.where(t.pmask, minus_one, zero)

    current, d, missing = _spread_lookup(t)                    # f32 [S, N]
    big = f(F32_BIG)
    used_count = current + one
    weight_frac = t.weights_s[:, None] / torch.maximum(t.sum_sw, eps)
    pos = d > zero
    targeted_raw = torch.where(
        pos,
        (d - used_count) / torch.where(pos, d, one) * weight_frac,
        torch.where(d == zero, -big, minus_one),
    )

    invalid_bucket = t.desired_sv.shape[-1] - 1
    has_entries = t.s_entry[:, :invalid_bucket].any(dim=-1)    # [S]
    scf = t.s_counts[:, :invalid_bucket]
    se = t.s_entry[:, :invalid_bucket]
    inf = f(float("inf"))
    min_c = torch.where(has_entries, torch.where(se, scf, inf).amin(dim=-1), zero)
    max_c = torch.where(has_entries, torch.where(se, scf, -inf).amax(dim=-1), zero)
    min_cn = min_c[:, None]
    max_cn = max_c[:, None]
    min_div = torch.maximum(min_cn, eps)
    delta_boost = torch.where(min_cn == zero, minus_one, (min_cn - current) / min_div)
    even = torch.where(
        current != min_cn,
        delta_boost,
        torch.where(
            min_cn == max_cn,
            minus_one,
            torch.where(min_cn == zero, one, (max_cn - min_cn) / min_div),
        ),
    )
    even = torch.where(has_entries[:, None], even, zero)

    per_spread = torch.where(t.has_targets_s[:, None], targeted_raw, even)
    per_spread = torch.where(missing, minus_one, per_spread)
    per_spread = torch.where(t.active_s[:, None], per_spread, zero)
    # summed over s = 0..S-1 in index order
    spread_total = torch.zeros_like(binpack)
    for s in range(per_spread.shape[0]):
        spread_total = spread_total + per_spread[s]
    spread_p = spread_total != zero

    presence = pack_presence_lanes_torch(anti_present, t.pmask, t.aff_p, spread_p)
    num_terms = (1 + popcount4_torch(presence)).to(F32)
    final = (binpack + anti + resched + torch.where(t.aff_p, t.aff, zero)
             + spread_total) / num_terms
    return final, float("-inf")


def _add_vid(counts, vids, inc) -> None:
    """counts[s, vids[s]] += inc[s] for a [S, V] table, skipping ids
    outside [0, V) (a one-hot add with no match)."""
    for s, vid in enumerate(vids.tolist()):
        if 0 <= vid < counts.shape[1]:
            counts[s, vid] += inc[s]


def _or_vid(entry, vids, flags) -> None:
    for s, vid in enumerate(vids.tolist()):
        if 0 <= vid < entry.shape[1] and bool(flags[s]):
            entry[s, vid] = True


def place_scan(n_pad: int, static, carry, xs) -> Tuple[tuple, tuple]:
    """Scan the step over the eval's placements. Pure: the input carry is
    not modified; returns ``(final_carry, (chosen, scores, pulls,
    skipped, evict))`` on the inputs' device."""
    _check_arm(static)
    if static[0].shape[0] != n_pad:
        raise ValueError(f"n_pad {n_pad} != node axis {static[0].shape[0]}")
    carry = tuple(c.clone() for c in carry)
    failed = carry[6]
    (tg_idx, penalty_idx, evict_node, evict_res, evict_tg, limit_p,
     sum_sw_p, ev_factor, rev_factor, forced_node) = xs
    p_count = tg_idx.shape[0]
    tg_l = tg_idx.tolist()
    ev_node_l = evict_node.tolist()
    ev_tg_l = evict_tg.tolist()
    limit_l = limit_p.tolist()
    float_arm = static[0].dtype == F32
    # the int arm reads the weight sum as an exact Python int, the float
    # arm as the f32 element itself
    sw_l = list(sum_sw_p) if float_arm else sum_sw_p.tolist()
    chosen: List[int] = []
    scores: list = []
    pulls: List[int] = []
    skipped: List[bool] = []
    for p in range(p_count):
        g = tg_l[p]
        skip_step = bool(failed[g])
        if skip_step:
            # a step of a failed task group (or a batch's padding)
            # changes nothing of the carry (engine.py:284, :722-723)
            chosen.append(-1)
            scores.append(0)
            pulls.append(0)
            skipped.append(True)
            continue
        x = (g, penalty_idx[p], ev_node_l[p], evict_res[p], ev_tg_l[p],
             limit_l[p], sw_l[p], ev_factor[p], rev_factor[p], forced_node[p])
        c, s, n = _step(static, carry, x, skip_step)
        chosen.append(c)
        scores.append(s)
        pulls.append(n)
        skipped.append(skip_step)
    dev = static[0].device
    ys = (
        torch.tensor(chosen, dtype=I32, device=dev),
        torch.tensor(scores, dtype=F32 if float_arm else I64, device=dev),
        torch.tensor(pulls, dtype=I32, device=dev),
        torch.tensor(skipped, dtype=torch.bool, device=dev),
        torch.zeros((p_count, 0), dtype=I32, device=dev),
    )
    return carry, ys
