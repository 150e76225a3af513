"""Plain PyTorch version of the node-sharded placement scan.

The reference shards every ``[N]`` table of an eval over its mesh's
``"nodes"`` axis and lets XLA insert the collectives that each scan
step needs (``nomad_tpu/parallel/sharding.py:1-16``, ``:41-93``, around
``_make_step``, ``nomad_tpu/tpu/engine.py:213``). Here the step of
``step._step`` is split at its three exchanges into per-shard phases:

  * phase A: the previous step's eviction counts (exchange 3) into the
    ``pre_counts`` replica, this step's eviction of the previous alloc
    (its owner and every replica), feasibility and the score of every
    node of the shard's slice (with the greedy of ``has_pre``), and the
    slice's counts of (low, feasible) and of those before the ring
    offset: partial 1;
  * phase B: the CS partials 1 give every shard the same totals and its
    own prefix; the ring-ordered LimitIterator emulation over the slice
    and its best ``(max score, min rank, first index)`` candidate with
    its fits bit, value ids and the slice's pull count: partial 2;
  * phase C: every shard combines the partials 2 to the same winner and
    pull count, its owner commits the placement to its slice and every
    shard to its replicas (spread counts and entries, distinct_property
    counts, the ring offset, the failed flags); on an eviction step the
    owner runs the second pass and writes the evicted slots' count
    groups: partial 3 (every other shard writes an empty one).

A shard holds the slice ``[lo, hi)`` (``parallel.sharding.node_slices``)
of every array the reference's table names ``"nodes"``
(``parallel.sharding.NODE_AXES``) and a replica of everything else; the
step's inputs (``xs``) are replicated. The value ids of the node that an
eviction step frees are replicated too (``evict_vids``), since every
shard's replica of the spread counts takes the eviction. Node indices
in the partials, the forced node, the penalty nodes, ``n_real`` and the
ring offset stay global. The integer/float program is ``step._step``'s:
the int arm's outputs and carry are the unsharded scan's bit for bit;
in the float arm no sum crosses shards (counts are integers, the
selection a total order), so it is bit for bit too.

Partials are int32 rows, the layout the CUDA kernel
(``csrc/place_scan_nodes.cu``) writes and reads:

  * 1: ``low, feas, low_before, feas_before`` (``W1`` = 4);
  * 2: score (int arm: the int64's two words, low first; float arm: the
    f32's bits, then 0), rank, global index, fits, pulls, the best
    node's spread value ids (S) and distinct_property value ids (DP);
    no candidate: score -inf, rank and index INT32_MAX, ids 0;
  * 3: the count group of each evicted slot, else -1 (C words).

``place_scan_nodes`` loops the phases over the shards and the steps on
one eval, the partials stacked between phases: it is what
``kernels.place_scan_nodes_phase`` runs for a shard on the CPU and what
the card's kernel is held against.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import torch

from ..parallel.sharding import NODE_AXES, node_slices
from .intscore import E27_BITS, FEAT_AFF_BIT, FEAT_FEAS_BIT, unpack_feat_lane_torch
from .preempt import greedy_select_t, second_pass_t
from .step import (
    INT32_MAX,
    MAX_SKIP,
    _add_vid,
    _check_arm,
    _gather_vid,
    _or_vid,
    _preempt_penalty,
    _score_float,
    _score_int,
)

I32, I64, F32 = torch.int32, torch.int64, torch.float32
#: partial 1's width; partial 2's fixed words before the value ids
W1 = 4
W2_FIXED = 6


def w2(S: int, DP: int) -> int:
    """Partial 2's width for S spreads and DP distinct_property dims."""
    return W2_FIXED + S + DP


def evict_vids(spread_vids, evict_node, evict_tg) -> torch.Tensor:
    """``[P, S]`` int32 (``[B, P, S]`` for a batch, every argument with
    its leading eval axis): the spread value ids of the node each step
    evicts from, ``spread_vids[max(evict_tg, 0), :, max(evict_node,
    0)]`` as ``step._step`` reads them, from the eval's whole arrays."""
    g = evict_tg.to(I64).clamp(min=0)
    n = evict_node.to(I64).clamp(min=0)
    if spread_vids.dim() == 4:
        b = torch.arange(spread_vids.shape[0])[:, None]
        return spread_vids[b, g, :, n].to(I32)
    return spread_vids[g, :, n].to(I32)


def slice_nodes(arrays: Sequence, lo: int, hi: int, batched: bool = False) -> tuple:
    """Views of the 48 scan arrays (``(*static, *carry, *xs)``) with
    every node axis cut to ``[lo, hi)``; ``batched`` when each carries a
    leading eval axis."""
    out = []
    for a, ax in zip(arrays, NODE_AXES):
        if ax is not None:
            ax = ax if batched else ax - 1
            a = a[(slice(None),) * ax + (slice(lo, hi),)]
        out.append(a)
    return tuple(out)


def _score_words(score, float_arm: bool) -> List[int]:
    if float_arm:
        return [int(torch.tensor([score], dtype=F32).view(I32)[0]), 0]
    return torch.tensor([int(score)], dtype=I64).view(I32).tolist()


def _score_of(words: torch.Tensor, float_arm: bool):
    if float_arm:
        return float(words[:1].clone().view(F32)[0])
    return int(words[:2].clone().view(I64)[0])


class ShardScan:
    """One eval's node shard: ``static`` / ``carry`` hold the shard's
    slices and replicas (the carry is updated in place), ``xs`` and
    ``ev_vids`` (``evict_vids``) the replicated step inputs; ``lo`` is
    the slice's first global node, ``shard`` its place among the
    shards. ``ys`` (chosen, scores, pulls, skipped, evict), updated in
    place: shard 0 writes the step outputs, the owner of a chosen node
    its evict row. ``stats`` (a dict or None) gains the preemption work
    done, as ``step.place_scan``'s."""

    def __init__(self, static, carry, xs, ev_vids, lo: int, shard: int, ys, stats=None) -> None:
        _check_arm(static)
        self.static, self.carry, self.xs, self.ev_vids = static, carry, xs, ev_vids
        self.lo, self.shard, self.ys, self.stats = lo, shard, ys, stats
        self.n_s = static[0].shape[0]
        self.float_arm = static[0].dtype == F32
        dev = static[0].device
        self.iota = lo + torch.arange(self.n_s, dtype=I32, device=dev)
        self.step = None  # what phase A leaves for B and C

    # -- the step's inputs ------------------------------------------------

    def _x(self, p: int):
        (tg_idx, penalty_idx, evict_node, evict_res, evict_tg, limit_p, sum_sw_p,
         ev_factor, rev_factor, forced_node) = self.xs
        sum_sw = sum_sw_p[p] if self.float_arm else int(sum_sw_p[p])
        fnode = int(forced_node[p][0]) if forced_node.shape[-1] else -1
        return SimpleNamespace(
            g=int(tg_idx[p]), penalty=penalty_idx[p], ev_node=int(evict_node[p]),
            ev_res=evict_res[p], ev_tg=int(evict_tg[p]), limit=int(limit_p[p]),
            sum_sw=sum_sw, ev_factor=ev_factor[p], rev_factor=rev_factor[p],
            fnode=fnode, has_forced=forced_node.shape[-1] > 0)

    def _own(self, node: int) -> int:
        """The local index of a global node this shard owns, else -1."""
        li = node - self.lo
        return li if 0 <= li < self.n_s else -1

    def _evict_counts(self, x, p: int, sign: int) -> None:
        """The eviction (sign -1) or its revert (+1) on the owner's slice
        and on every shard's spread-count replica (step.py's order)."""
        (_totals, _res, _asks, _feat, _aff, _des, _dhj, _dht, _lim, _sv, _sd, _sw, _sht,
         spread_active, *_rest) = self.static
        used, tg_counts, job_counts, spread_counts = self.carry[:4]
        e_base = self.carry[7]
        li = self._own(max(x.ev_node, 0))
        ev_tg = max(x.ev_tg, 0)
        if li >= 0:
            if sign < 0:
                used[li] -= x.ev_res
            else:
                used[li] += x.ev_res
            job_counts[li] += sign
            if x.ev_tg >= 0:
                tg_counts[ev_tg, li] += sign
            if e_base.shape[0]:
                factor = x.ev_factor if sign < 0 else x.rev_factor
                e_base[li] = ((e_base[li].to(I64) * factor.to(I64)) >> E27_BITS).to(I32)
        dec = (spread_active[ev_tg].clone() if x.ev_tg >= 0
               else torch.zeros(spread_active.shape[1], dtype=torch.bool,
                                device=spread_active.device))
        inc = dec.to(spread_counts.dtype)
        _add_vid(spread_counts[ev_tg], self.ev_vids[p], -inc if sign < 0 else inc)

    # -- phase A ------------------------------------------------------------

    def phase_a(self, p: int, gath3: torch.Tensor) -> torch.Tensor:
        """Apply the gathered partials 3 (``[shards, C]``) to the
        ``pre_counts`` replica, then, unless step ``p`` is skipped (or
        past the last), evict and score the slice. Returns partial 1."""
        (totals, reserved, asks, feat_packed, aff_score, desired_counts,
         dh_job, dh_tg, _limits, spread_vids, spread_desired, spread_weights,
         spread_has_targets, spread_active, _ssw, n_real,
         e_ask, dp_vids, dp_limit, dp_applies,
         pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf) = self.static
        (used, tg_counts, job_counts, spread_counts, spread_entry, offset_t,
         failed, e_base, dp_counts, pre_alive, pre_remaining, pre_counts) = self.carry
        gp = pre_counts.shape[0]
        for gid in gath3.flatten().tolist():
            if 0 <= gid < gp:
                pre_counts[gid] += 1
        self.step = None
        part = torch.zeros(W1, dtype=I32)
        if p >= self.xs[0].shape[0]:
            return part
        x = self._x(p)
        g = x.g
        if bool(failed[g]):
            return part
        dev = totals.device
        iota, n_s = self.iota, self.n_s
        offset, n_real_i = int(offset_t), int(n_real)
        do_evict = self.xs[3].shape[-1] > 0 and x.ev_node >= 0
        if do_evict:
            self._evict_counts(x, p, -1)

        ask = asks[g]
        feat_g = feat_packed[g]
        feas_g = unpack_feat_lane_torch(feat_g, FEAT_FEAS_BIT)
        tg_counts_g = tg_counts[g]
        if aff_score.shape[0] == 0:
            aff = torch.zeros(n_s, dtype=totals.dtype, device=dev)
            aff_p = torch.zeros(n_s, dtype=torch.bool, device=dev)
        else:
            aff = aff_score[g]
            aff_p = unpack_feat_lane_torch(feat_g, FEAT_AFF_BIT)
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
            dh_mask = torch.ones(n_s, dtype=torch.bool, device=dev)
        feasible = feas_g & dh_mask
        if x.has_forced:
            feasible = feasible & ((x.fnode < 0) | (iota == x.fnode))
        dp_applies_g = None
        if dp_vids.shape[0]:
            v2 = dp_counts.shape[-1]
            dp_cnt_n = _gather_vid(dp_counts.clamp(min=0), dp_vids)
            dp_applies_g = dp_applies[g]
            dp_missing = dp_vids == (v2 - 1)
            dp_ok = (~dp_applies_g[:, None]) | ((~dp_missing) & (dp_cnt_n < dp_limit[:, None]))
            feasible = feasible & dp_ok.all(dim=0)

        has_pre = pre_res.shape[1] > 0
        sel_ord = rows = ask3 = None
        if has_pre:
            ask3 = ask[:3].to(I64)
            pen = _preempt_penalty(pre_gid, pre_mp, pre_counts)
            alive_e = pre_alive & pre_elig
            res3 = pre_res[:, :, :3].to(I64)
            most = pre_remaining + torch.where(alive_e[:, :, None], res3,
                                               torch.zeros_like(res3)).sum(dim=1)
            can_meet = (most >= ask3[None, :]).all(dim=1)
            rows = torch.nonzero(feasible & ~fits & (iota < n_real_i) & can_meet).flatten()
            met = torch.zeros(n_s, dtype=torch.bool, device=dev)
            if rows.numel():
                sel_ord, met_rows = greedy_select_t(
                    ask3, res3[rows], pre_prio[rows], pen[rows], alive_e[rows],
                    pre_remaining[rows], self.stats)
                met[rows] = met_rows
            if self.stats is not None:
                self.stats["greedy_rows"] = self.stats.get("greedy_rows", 0) + int(rows.numel())
            feasible = feasible & (fits | met)
        else:
            feasible = feasible & fits

        if x.penalty.shape[-1] == 0:
            pmask = torch.zeros(n_s, dtype=torch.bool, device=dev)
        else:
            pmask = (iota[:, None] == x.penalty[None, :]).any(dim=-1)
        terms = SimpleNamespace(
            desired_g=int(desired_counts[g]), desired_g_t=desired_counts[g],
            tg_counts_g=tg_counts_g, pmask=pmask, aff=aff, aff_p=aff_p,
            vids=spread_vids[g], s_counts=spread_counts[g].clamp(min=0),
            s_entry=spread_entry[g], desired_sv=spread_desired[g],
            weights_s=spread_weights[g], has_targets_s=spread_has_targets[g],
            active_s=spread_active[g], sum_sw=x.sum_sw)
        if self.float_arm:
            final, neg_inf = _score_float(terms, totals, reserved, util)
            e_sel = None
        else:
            final, e_sel, neg_inf = _score_int(terms, e_base, e_ask[g])

        valid = iota < n_real_i
        feas_v = feasible & valid
        low = feas_v & (final <= 0)
        before = iota < offset
        part = torch.tensor([int(low.sum()), int(feas_v.sum()), int((low & before).sum()),
                             int((feas_v & before).sum())], dtype=I32)
        self.step = SimpleNamespace(
            x=x, do_evict=do_evict, final=final, neg_inf=neg_inf, feas_v=feas_v, low=low,
            fits=fits, e_sel=e_sel, rows=rows, sel_ord=sel_ord, ask3=ask3,
            dp_applies_g=dp_applies_g, offset=offset, n_real=n_real_i)
        return part

    # -- phase B ------------------------------------------------------------

    def phase_b(self, gath1: torch.Tensor) -> torch.Tensor:
        """From the gathered partials 1 (``[shards, 4]``): the ring
        cumsums, the limit window and the slice's best candidate.
        Returns partial 2 (all -1 where the step is skipped: nothing
        reads it)."""
        st = self.step
        S, DP = self.static[9].shape[1], self.static[17].shape[0]
        if st is None:
            return torch.full((w2(S, DP),), -1, dtype=I32)
        tot = gath1.to(I64).sum(dim=0).tolist()
        pfx = gath1[:self.shard].to(I64).sum(dim=0).tolist()
        tot_low, tot_feas, low_b, feas_b = tot
        iota, offset, limit = self.iota, st.offset, st.x.limit
        low_i, feas_i = st.low.to(I32), st.feas_v.to(I32)
        nat_low = pfx[0] + torch.cumsum(low_i, dim=0, dtype=I32)
        nat_feas = pfx[1] + torch.cumsum(feas_i, dim=0, dtype=I32)
        ring = iota >= offset
        low_cum = torch.where(ring, nat_low - low_b, nat_low + (tot_low - low_b))
        feas_cum = torch.where(ring, nat_feas - feas_b, nat_feas + (tot_feas - feas_b))
        skipped = st.low & (low_cum <= MAX_SKIP)
        skip_cum = low_cum.clamp(max=MAX_SKIP)
        ret = st.feas_v & ~skipped
        ret_excl = feas_cum - skip_cum - ret.to(I32)
        pulled = (iota < st.n_real) & (ret_excl < limit)
        src_cand = ret & pulled
        ret_total = tot_feas - min(tot_low, MAX_SKIP)
        backlog_n = max(limit - ret_total, 0)
        skip_excl = skip_cum - skipped.to(I32)
        backlog_cand = skipped & (skip_excl < backlog_n)
        cand = src_cand | backlog_cand
        rank = torch.where(src_cand, ret_excl, ret_total + skip_excl)
        pulls = int(pulled.sum())
        g = st.x.g
        if bool(cand.any()):
            final = st.final
            cand_scores = torch.where(cand, final, torch.full_like(final, st.neg_inf))
            best = cand_scores.max().item()
            winners = cand & (cand_scores == best)
            best_rank = int(torch.where(winners, rank, torch.full_like(rank, INT32_MAX)).min())
            li = int(torch.argmax((winners & (rank == best_rank)).to(I32)))
            vids = (self.static[9][g, :, li].tolist() + self.static[17][:, li].tolist())
            row = (_score_words(best, self.float_arm)
                   + [best_rank, self.lo + li, int(bool(st.fits[li])), pulls] + vids)
        else:
            row = (_score_words(st.neg_inf, self.float_arm)
                   + [INT32_MAX, INT32_MAX, 0, pulls] + [0] * (S + DP))
        return torch.tensor(row, dtype=I32)

    # -- phase C ------------------------------------------------------------

    def phase_c(self, p: int, gath2: torch.Tensor) -> torch.Tensor:
        """From the gathered partials 2 (``[shards, W2]``): the winner,
        the step's outputs (shard 0), the commit on the owner and every
        replica, the revert of a failed step's eviction. Returns partial
        3."""
        (_totals, _res, asks, _feat, _aff, _des, _dhj, _dht, _lim, spread_vids, _sd, _sw,
         _sht, spread_active, _ssw, _nr, e_ask, dp_vids, _dpl, _dpa,
         pre_res, _pp, _pe, _pm, pre_gid, pre_evf) = self.static
        (used, tg_counts, job_counts, spread_counts, spread_entry, offset_t,
         failed, e_base, dp_counts, pre_alive, pre_remaining, _pc) = self.carry
        chosen_y, scores_y, pulls_y, skipped_y, evict_y = self.ys
        c_w = pre_res.shape[1]
        part = torch.full((c_w,), -1, dtype=I32)
        st = self.step
        if st is None:
            if self.shard == 0:
                chosen_y[p], scores_y[p], pulls_y[p], skipped_y[p] = -1, 0, 0, True
            return part
        x, g = st.x, st.x.g
        S = spread_vids.shape[1]
        win, pulls, owner_row = None, 0, None
        for r in range(gath2.shape[0]):
            row = gath2[r]
            pulls += int(row[5])
            if int(row[3]) == INT32_MAX:
                continue
            cand = (_score_of(row, self.float_arm), int(row[2]), int(row[3]))
            if win is None or cand[0] > win[0] or (cand[0] == win[0] and cand[1:] < win[1:]):
                win, owner_row = cand, row
        chosen = -1 if win is None else win[2]
        success = chosen >= 0
        offset_t.fill_((st.offset + pulls) % max(st.n_real, 1))
        if self.shard == 0:
            chosen_y[p] = chosen
            scores_y[p] = win[0] if success else 0
            pulls_y[p] = pulls
            skipped_y[p] = False
        if success:
            li = self._own(chosen)
            if li >= 0:
                used[li] += asks[g]
                tg_counts[g, li] += 1
                job_counts[li] += 1
                if st.e_sel is not None:
                    e_base[li] = st.e_sel[li].to(I32)
            vids = owner_row[W2_FIXED:]
            active_s = spread_active[g]
            _add_vid(spread_counts[g], vids[:S], active_s.to(spread_counts.dtype))
            _or_vid(spread_entry[g], vids[:S], active_s)
            if dp_vids.shape[0]:
                _add_vid(dp_counts, vids[S:], st.dp_applies_g.to(I32))
            if c_w and not bool(owner_row[4]) and li >= 0:
                self._commit_evictions(p, li, part)
        if st.do_evict and not success:
            self._evict_counts(x, p, +1)
        if not success and x.fnode < 0:
            failed[g] = True
        return part

    def _commit_evictions(self, p: int, li: int, part: torch.Tensor) -> None:
        """The owner's commit of the chosen row's eviction set
        (engine.py:761-832, as ``step._step``): the second pass over the
        greedy order of phase A, the freed capacity, the running Q27
        product, the slots' alive bits and the row's remaining; the
        evicted slots' count groups go to ``part`` (partial 3)."""
        st = self.step
        pre_res, pre_gid, pre_evf = self.static[20], self.static[24], self.static[25]
        used, e_base, pre_alive, pre_remaining = (self.carry[0], self.carry[7],
                                                  self.carry[9], self.carry[10])
        gp = self.carry[11].shape[0]
        res3 = pre_res[li, :, :3].to(I64)
        sel = st.sel_ord[int(torch.searchsorted(st.rows, li))]
        keep, rank = second_pass_t(st.ask3, res3, sel, pre_remaining[li])
        if self.stats is not None:
            self.stats["second_pass_rows"] = self.stats.get("second_pass_rows", 0) + 1
        freed4 = torch.where(keep[:, None], pre_res[li],
                             torch.zeros_like(pre_res[li])).sum(dim=0, dtype=I32)
        used[li, :4] -= freed4
        if e_base.shape[0]:
            eb = e_base[li].to(I64)
            for ci in torch.nonzero(keep).flatten().tolist():
                eb = (eb * pre_evf[li, ci].to(I64)) >> E27_BITS
            e_base[li] = eb.to(I32)
        pre_alive[li] &= ~keep
        pre_remaining[li] += torch.where(keep[:, None], res3, torch.zeros_like(res3)).sum(dim=0)
        gids = pre_gid[li]
        for c in torch.nonzero(keep).flatten().tolist():
            gid = int(gids[c])
            if 0 <= gid < gp:
                part[c] = gid
        self.ys[4][p] = torch.where(keep, rank.to(I32), self.ys[4][p])


def scan_outputs(p_count: int, c_w: int, float_arm: bool, device=None) -> tuple:
    """Fresh ``(chosen, scores, pulls, skipped, evict)`` for P steps, as
    the kernel's output buffer starts (evict -1)."""
    return (torch.full((p_count,), -1, dtype=I32, device=device),
            torch.zeros(p_count, dtype=F32 if float_arm else I64, device=device),
            torch.zeros(p_count, dtype=I32, device=device),
            torch.zeros(p_count, dtype=torch.bool, device=device),
            torch.full((p_count, c_w), -1, dtype=I32, device=device))


def run_phases(shards: Sequence[ShardScan], p_count: int) -> None:
    """The phase loop over the steps: each phase on every shard, its
    partials stacked (the exchange) before the next phase; a last
    phase A applies the last step's partials 3."""
    c_w = shards[0].static[20].shape[1]
    gath3 = torch.full((len(shards), c_w), -1, dtype=I32)
    for p in range(p_count + 1):
        gath1 = torch.stack([sh.phase_a(p, gath3) for sh in shards])
        if p == p_count:
            break
        gath2 = torch.stack([sh.phase_b(gath1) for sh in shards])
        gath3 = torch.stack([sh.phase_c(p, gath2) for sh in shards])


def place_scan_nodes(n_pad: int, static, carry, xs, nodes: int,
                     stats: Optional[dict] = None) -> Tuple[tuple, tuple]:
    """One eval's scan over ``nodes`` node shards (``node_slices(n_pad,
    nodes)``), every exchange through the stacked partials. Pure, as
    ``step.place_scan``: returns ``(final_carry, (chosen, scores, pulls,
    skipped, evict))``, the carry's slices joined and its replicas
    shard 0's (every shard's are equal)."""
    _check_arm(static)
    if static[0].shape[0] != n_pad:
        raise ValueError(f"n_pad {n_pad} != node axis {static[0].shape[0]}")
    carry = tuple(c.clone() for c in carry)
    arrays = (*static, *carry, *xs)
    ev = evict_vids(static[9], xs[2], xs[4])
    p_count, c_w = xs[0].shape[0], static[20].shape[1]
    float_arm = static[0].dtype == F32
    ys0 = scan_outputs(p_count, c_w, float_arm, static[0].device)
    shards, carries = [], []
    for k, (lo, hi) in enumerate(node_slices(n_pad, nodes)):
        part = slice_nodes(arrays, lo, hi)
        shard_carry = tuple(c.clone() for c in part[26:38])
        carries.append(shard_carry)
        ys = ys0 if k == 0 else (*ys0[:4], torch.full_like(ys0[4], -1))
        shards.append(ShardScan(part[:26], shard_carry, part[38:], ev, lo, k, ys, stats))
    run_phases(shards, p_count)
    for sh in shards[1:]:
        ys0[4].copy_(torch.maximum(ys0[4], sh.ys[4]))
    out = []
    for i, (c, ax) in enumerate(zip(carry, NODE_AXES[26:38])):
        if ax is None:
            out.append(carries[0][i])
        else:
            out.append(torch.cat([cs[i] for cs in carries], dim=ax - 1))
    return tuple(out), ys0
