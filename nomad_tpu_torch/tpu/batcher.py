"""DeviceBatcher: gathers concurrent evals into ONE kernel launch.

The analog of the reference's N scheduler workers per server
(nomad/server.go:1307 setupWorkers, worker.go:244). Host workers still
dequeue and run the scheduler logic concurrently; when each reaches its
placement step it submits an ``EncodedEval`` here and blocks. A
dispatcher thread gathers the requests that arrive within a small
window, pads them to shared bucketed shapes, stacks them along a
leading eval axis and runs ``kernels.place_scan_batched`` on the
batcher's device: one launch of the placement scan for the whole batch
(K3, one thread block per eval), or on the CPU its plain version eval
by eval.

Per-eval semantics are untouched: the batched kernel runs the exact
single-eval scan per block, so each eval's plan is identical to what a
single launch produces; cross-eval conflicts resolve in the plan
applier exactly as with the reference's optimistically-concurrent
workers.

Port of ``nomad_tpu/tpu/batcher.py``: ``pad_encoded``,
``_pad_and_stack``, ``_buckets``, the gather loop and the demand-aware
``expect`` are copied (numpy). What differs:

  * a batch is not padded and stacked array by array: ``pack_batch``
    writes the padded, stacked batch straight into one reused host slab
    (pinned on CUDA; ``pad_encoded``'s fills and value remaps, one slice
    assignment per array per eval) and moves it with ONE copy on the
    dispatcher's own stream; ``kernels.place_scan_batched_packed`` reads
    it through offsets and writes every output into one buffer, brought
    back with one copy (``pad_encoded`` and ``_pad_and_stack`` stay as
    the reference the slab is tested against);
  * there are no shapes to compile, so there is no bucket prewarming:
    the kernels are built (``kernels.build_all``) at the first batch;
    ``has_warmed()`` keeps its meaning: at least one batch completed;
  * a failed batch is retried eval by eval on the kernel only, and a
    failure that remains is raised to each waiting ``run()``: nothing
    is placed on the host instead;
  * the bucket-padding copies of a batch have every task group
    pre-failed, so each of their steps is skipped;
  * a device mesh (``parallel.sharding.make_mesh``) shards the eval
    axis and the node axis: ``DeviceBatcher(mesh=...)`` rounds ``b_pad``
    up to a multiple of the mesh's ``evals`` and ``n_pad`` to one of its
    ``nodes``, as the reference does, and ``ShardLauncher`` runs each of
    the ``evals`` contiguous groups as its own K3 launch on its own slab
    and stream of its device, or, with ``nodes > 1``, over node shards
    whose exchanges go between launches (without a mesh, a batch is the
    one shard of a one-entry mesh).

The chunked tier's evals do not come here: the engine runs them one by
one through ``kernels.chunk_scan`` (``engine.run_chunked``), which
re-asserts the tier's gate with ``assert_chunk_gate`` (copied from
``nomad_tpu/tpu/batcher.py:60-77``).
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..chaos.injector import fire as chaos_fire
from ..parallel.sharding import make_mesh
from ..utils.lock_witness import witness_lock
from ..utils.race_witness import tracked_dict
from . import kernels
from .convert import DeviceLike, HostSlab, from_device_packed, put_bytes, resolve_device
from .engine import EncodedEval, _round_up
from .intscore import E27_ONE as _E27_NEUTRAL

logger = logging.getLogger("nomad_tpu_torch.tpu.batcher")

#: a batch's host sections (``DeviceBatcher.section_profile``): the slab
#: write, the copy in, the launch with its synchronize, the copy back
BATCH_SECTIONS = ("slab", "h2d", "launch", "d2h")


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def assert_chunk_gate(enc: EncodedEval) -> None:
    """Dispatch-side re-assertion of the chunked tier's eligibility gate
    (``engine._chunk_eligible`` decides routing; this catches a bypass).

    The chunk step has no eviction scoring and passes the preemption
    carry through untouched, so a preempting or destructive eval reaching
    the chunked scan would silently drop its evictions, and the deficit
    carry would then re-ask for capacity the preemption was supposed to
    free, over-placing on retry rounds. Such evals must take the exact
    scan. Raises AssertionError (also under ``python -O``)."""
    if enc.pre_allocs is not None:
        raise AssertionError(
            "chunked tier dispatched a preempting eval (pre_allocs present); "
            "preemption must take the bit-parity scan")
    if (np.asarray(enc.xs[2]) >= 0).any():
        raise AssertionError(
            "chunked tier dispatched an eval with eviction steps; "
            "destructive updates must take the bit-parity scan")


def pad_encoded(enc: EncodedEval, n_pad: int, g_pad: int, s_pad: int,
                v_pad: int, p_pad: int, dtype,
                d_pad: int = 0, k_pad: Optional[int] = None,
                aff_pad: Optional[int] = None,
                evd_pad: Optional[int] = None,
                fac_pad: Optional[int] = None,
                dpd_pad: Optional[int] = None,
                dpv_pad: Optional[int] = None,
                fnd_pad: Optional[int] = None,
                prec_pad: Optional[int] = None,
                pregp_pad: Optional[int] = None) -> Tuple[tuple, tuple, tuple]:
    """Pad one eval's arrays to the batch's shared bucketed dims.

    Padding is semantically inert by construction:
      - nodes beyond n_real are infeasible and outside the ring window
      - task-group slots >= g are born with failed=True in the carry
      - placement steps beyond p index a padded (pre-failed) TG slot, so
        the scan body skips them (skip_step) and mutates nothing
      - spread rows beyond s are inactive; the invalid vocab bucket is
        remapped from v-1 to v_pad-1
      - capacity dims beyond the eval's own (device dims of co-batched
        device jobs) pad zero ask against zero totals: 0 <= 0 fits
    """
    (totals, reserved, asks, feat_packed, aff_score, desired_counts,
     dh_job, dh_tg, limits, spread_vids, spread_desired, spread_weights,
     spread_has_targets, spread_active, sum_spread_weights, n_real,
     e_ask, dp_vids, dp_limit, dp_applies,
     pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf) = enc.static
    (used0, tg_counts0, job_counts0, spread_counts0, spread_entry0,
     offset0, failed0, e_base0, dp_counts0,
     pre_alive0, pre_remaining0, pre_counts0) = enc.carry
    (tg_idx, penalty_idx, evict_node, evict_res, evict_tg,
     limit_p, sum_sw_p, ev_factor, rev_factor, forced_node) = enc.xs

    n0, g0, s0, v0, p0 = enc.n_pad, enc.g, enc.s, enc.v, enc.p
    d0 = totals.shape[1]
    if d_pad <= 0:
        d_pad = d0
    if k_pad is None:
        k_pad = penalty_idx.shape[1]
    if aff_pad is None:
        aff_pad = aff_score.shape[0]
    if evd_pad is None:
        evd_pad = evict_res.shape[1]
    if fac_pad is None:
        fac_pad = ev_factor.shape[1]
    if dpd_pad is None:
        dpd_pad = dp_vids.shape[0]
    if dpv_pad is None:
        dpv_pad = dp_counts0.shape[1]
    if fnd_pad is None:
        fnd_pad = forced_node.shape[1]
    if prec_pad is None:
        prec_pad = pre_res.shape[1]
    if pregp_pad is None:
        pregp_pad = pre_counts0.shape[0]
    dn, dg, ds, dv, dp = (n_pad - n0, g_pad - g0, s_pad - s0,
                          v_pad - v0, p_pad - p0)
    dd = d_pad - d0
    assert min(dn, dg, ds, dv, dp, dd) >= 0
    assert k_pad >= penalty_idx.shape[1] and aff_pad >= aff_score.shape[0]
    assert dp == 0 or g_pad > g0  # padded steps need a pre-failed TG slot

    def pad(arr, widths, fill=0):
        if all(w == (0, 0) for w in widths):
            return np.asarray(arr, dtype=arr.dtype)
        return np.pad(arr, widths, constant_values=fill)

    f = lambda a: np.asarray(a, dtype)  # noqa: E731 — common float cast

    # spread_vids: remap this eval's invalid bucket (v0-1) onto the shared
    # one (v_pad-1) BEFORE padding, then pad new cells as invalid too
    vids = np.where(spread_vids >= v0 - 1, v_pad - 1, spread_vids)
    vids = pad(vids, ((0, dg), (0, ds), (0, dn)), v_pad - 1)

    static = (
        pad(f(totals), ((0, dn), (0, dd))),
        # int-mode evals fold reserved into totals and pass it ZERO-height
        # (rows only — the D axis must still pad so the batch stacks)
        pad(f(reserved), ((0, dn if reserved.shape[0] else 0), (0, dd))),
        pad(f(asks), ((0, dg), (0, dd))),
        # packed feature plane (intscore.pack_feat_planes): padded TG rows
        # and padded nodes get 0 = infeasible with no affinity lane
        pad(feat_packed, ((0, dg), (0, dn)), 0),
        # aff_score may have a ZERO G axis (shape-specialized absent
        # affinities): the batch target is 0 when every co-batched eval
        # lacks affinities (keeping the specialization), else g_pad —
        # padded zero rows are inert either way
        pad(f(aff_score), ((0, aff_pad - aff_score.shape[0]), (0, dn))),
        pad(desired_counts, ((0, dg),), 1),
        pad(dh_job, ((0, dg),), False),
        pad(dh_tg, ((0, dg),), False),
        pad(limits, ((0, dg),), 0),
        vids.astype(np.int32),
        pad(f(spread_desired), ((0, dg), (0, ds), (0, dv)), -1.0),
        pad(f(spread_weights), ((0, dg), (0, ds))),
        pad(spread_has_targets, ((0, dg), (0, ds)), False),
        pad(spread_active, ((0, dg), (0, ds)), False),
        pad(f(sum_spread_weights), ((0, dg),)),
        np.int32(n_real),
        # Q27 exponential ask factors (int mode; zero-sized in float
        # batches). Padded cells get the neutral factor — padded nodes
        # are infeasible and padded TG slots pre-failed anyway.
        pad(e_ask, ((0, (g_pad - e_ask.shape[0]) if e_ask.shape[0] else 0),
                    (0, (n_pad - e_ask.shape[1]) if e_ask.shape[0] else 0),
                    (0, 0)), _E27_NEUTRAL),
        # distinct_property: remap this eval's MISSING bucket onto the
        # batch's (dpv_pad-1) before padding; padded constraint rows
        # apply to no TG
        pad(
            np.where(dp_vids >= dp_counts0.shape[1] - 1, dpv_pad - 1, dp_vids)
            if dp_vids.shape[0] else dp_vids.reshape(0, n0),
            ((0, dpd_pad - dp_vids.shape[0]), (0, dn)), dpv_pad - 1,
        ),
        pad(dp_limit, ((0, dpd_pad - dp_limit.shape[0]),), 1),
        pad(dp_applies, ((0, dg), (0, dpd_pad - dp_applies.shape[1])), False),
        # preemption candidate axis: ZERO-width when no co-batched eval
        # preempts; mixed batches widen with inert slots
        pad(pre_res, ((0, dn), (0, prec_pad - pre_res.shape[1]), (0, 0)), 0),
        pad(pre_prio, ((0, dn), (0, prec_pad - pre_prio.shape[1])), 0),
        pad(pre_elig, ((0, dn), (0, prec_pad - pre_elig.shape[1])), False),
        pad(pre_mp, ((0, dn), (0, prec_pad - pre_mp.shape[1])), 0),
        pad(pre_gid, ((0, dn), (0, prec_pad - pre_gid.shape[1])), 0),
        pad(pre_evf, ((0, dn), (0, prec_pad - pre_evf.shape[1]), (0, 0)),
            _E27_NEUTRAL),
    )
    carry = (
        pad(f(used0), ((0, dn), (0, dd))),
        pad(tg_counts0, ((0, dg), (0, dn)), 0),
        pad(job_counts0, ((0, dn),), 0),
        pad(f(spread_counts0), ((0, dg), (0, ds), (0, dv))),
        pad(spread_entry0, ((0, dg), (0, ds), (0, dv)), False),
        np.int32(offset0),
        # padded TG slots are pre-failed -> padded steps are no-ops
        pad(failed0, ((0, dg),), True),
        pad(e_base0, ((0, dn if e_base0.shape[0] else 0), (0, 0)),
            _E27_NEUTRAL),
        pad(dp_counts0, ((0, dpd_pad - dp_counts0.shape[0]),
                         (0, dpv_pad - dp_counts0.shape[1])), 0),
        pad(pre_alive0, ((0, dn), (0, prec_pad - pre_alive0.shape[1])), False),
        # pre_remaining rides a zero-HEIGHT row axis when this eval has no
        # candidate tables; a preempt batch needs full rows
        (pad(pre_remaining0, ((0, dn), (0, 0)), 0)
         if pre_remaining0.shape[0]
         else np.zeros((n_pad if prec_pad else 0, 3), np.int64)),
        pad(pre_counts0, ((0, pregp_pad - pre_counts0.shape[0]),), 0),
    )
    xs = (
        pad(tg_idx, ((0, dp),), g0),  # g0 = first padded (pre-failed) slot
        # K axis may be zero (no reschedule history) — pad to the batch's
        # K with -1 sentinels, which match nothing
        pad(penalty_idx, ((0, dp), (0, k_pad - penalty_idx.shape[1])), -1),
        pad(evict_node, ((0, dp),), -1),
        # eviction axes may be ZERO-width (no destructive updates in the
        # whole batch); a mixed batch widens with inert fills
        pad(f(evict_res), ((0, dp), (0, evd_pad - evict_res.shape[1]))),
        pad(evict_tg, ((0, dp),), -1),
        pad(limit_p, ((0, dp),), 0),
        pad(f(sum_sw_p), ((0, dp),), 1.0),
        pad(ev_factor, ((0, dp), (0, fac_pad - ev_factor.shape[1])), _E27_NEUTRAL),
        pad(rev_factor, ((0, dp), (0, fac_pad - rev_factor.shape[1])), _E27_NEUTRAL),
        pad(forced_node, ((0, dp), (0, fnd_pad - forced_node.shape[1])), -1),
    )
    return static, carry, xs


def batch_dims(encs: List[EncodedEval], nodes: int = 1) -> Dict[str, object]:
    """The shared bucketed dims of a batch of evals of one dtype:
    ``pad_encoded``'s keyword arguments. ``n_pad`` is rounded up to a
    multiple of ``nodes``, the mesh's node axis, as the reference rounds
    it (``nomad_tpu/tpu/batcher.py:784-795``)."""
    # G always gets a padded slot so padded steps have a pre-failed TG to
    # point at
    g_pad = _pow2ceil(max(e.g for e in encs) + 1)
    # S stays ZERO when no co-batched eval has spreads; mixed batches
    # widen — same pattern as the affinity axis
    s_raw = max(e.s for e in encs)
    # COARSE placement-count buckets (16/64/256/1024, pow2 beyond)
    p_raw = max(e.p for e in encs)
    p_pad = (
        16 if p_raw <= 16 else 64 if p_raw <= 64
        else 256 if p_raw <= 256 else 1024 if p_raw <= 1024
        else _pow2ceil(p_raw)
    )
    d_pad = max(e.static[0].shape[1] for e in encs)
    # absent-feature axes stay ZERO when the whole batch lacks them;
    # mixed batches widen; the preemption candidate axis is zero when no
    # co-batched eval preempts
    prec_raw = max(e.static[20].shape[1] for e in encs)
    prec_pad = _pow2ceil(prec_raw) if prec_raw else 0
    n_pad = max(_round_up(e.n_real) for e in encs)
    return dict(
        n_pad=-(-n_pad // nodes) * nodes, g_pad=g_pad,
        s_pad=_pow2ceil(s_raw) if s_raw else 0,
        v_pad=_pow2ceil(max(max(e.v for e in encs), 2)), p_pad=p_pad,
        dtype=encs[0].dtype, d_pad=d_pad,
        k_pad=max(e.xs[1].shape[1] for e in encs),
        aff_pad=g_pad if max(e.static[4].shape[0] for e in encs) else 0,
        evd_pad=d_pad if max(e.xs[3].shape[1] for e in encs) else 0,
        fac_pad=max(e.xs[7].shape[1] for e in encs),
        dpd_pad=max(e.static[17].shape[0] for e in encs),
        dpv_pad=max(e.carry[8].shape[1] for e in encs),
        fnd_pad=max(e.xs[9].shape[1] for e in encs),
        prec_pad=prec_pad,
        pregp_pad=(_pow2ceil(max(max(e.carry[11].shape[0] for e in encs), 1))
                   if prec_pad else 0),
    )


def _slab_entries(enc: EncodedEval, d: Dict[str, object]):
    """One eval's 48 arrays as ``pad_encoded`` pads them, without
    padding: per array ``(data, pads, fill, dtype)``, the data written
    at the block's origin (after ``pad_encoded``'s value remaps), the
    amount padded after each axis, the pad value, and the dtype it is
    cast to (None: its own)."""
    (totals, reserved, asks, feat_packed, aff_score, desired_counts,
     dh_job, dh_tg, limits, spread_vids, spread_desired, spread_weights,
     spread_has_targets, spread_active, sum_spread_weights, n_real,
     e_ask, dp_vids, dp_limit, dp_applies,
     pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf) = enc.static
    (used0, tg_counts0, job_counts0, spread_counts0, spread_entry0,
     offset0, failed0, e_base0, dp_counts0,
     pre_alive0, pre_remaining0, pre_counts0) = enc.carry
    (tg_idx, penalty_idx, evict_node, evict_res, evict_tg,
     limit_p, sum_sw_p, ev_factor, rev_factor, forced_node) = enc.xs
    n_pad, g_pad, p_pad = d["n_pad"], d["g_pad"], d["p_pad"]
    v_pad, prec_pad, dpd_pad = d["v_pad"], d["prec_pad"], d["dpd_pad"]
    dpv_pad, fac_pad = d["dpv_pad"], d["fac_pad"]
    dn, dg, ds = n_pad - enc.n_pad, g_pad - enc.g, d["s_pad"] - enc.s
    dv, dp = v_pad - enc.v, p_pad - enc.p
    dd = (d["d_pad"] or totals.shape[1]) - totals.shape[1]
    if dp and g_pad <= enc.g:
        raise ValueError("pack_batch: padded steps need a pre-failed task-group slot")
    f, i32, neutral = np.dtype(d["dtype"]), np.dtype(np.int32), _E27_NEUTRAL
    dc = lambda a: prec_pad - a.shape[1]  # noqa: E731 — the candidate axis
    return (
        (totals, (dn, dd), 0, f),
        (reserved, (dn if reserved.shape[0] else 0, dd), 0, f),
        (asks, (dg, dd), 0, f),
        (feat_packed, (dg, dn), 0, None),
        (aff_score, (d["aff_pad"] - aff_score.shape[0], dn), 0, f),
        (desired_counts, (dg,), 1, None),
        (dh_job, (dg,), False, None),
        (dh_tg, (dg,), False, None),
        (limits, (dg,), 0, None),
        # this eval's invalid vocab bucket (v0-1) onto the batch's (v_pad-1)
        (np.where(spread_vids >= enc.v - 1, v_pad - 1, spread_vids), (dg, ds, dn), v_pad - 1, i32),
        (spread_desired, (dg, ds, dv), -1.0, f),
        (spread_weights, (dg, ds), 0, f),
        (spread_has_targets, (dg, ds), False, None),
        (spread_active, (dg, ds), False, None),
        (sum_spread_weights, (dg,), 0, f),
        (n_real, (), 0, i32),
        (e_ask, ((g_pad - e_ask.shape[0], n_pad - e_ask.shape[1], 0) if e_ask.shape[0]
                 else (0, 0, 0)), neutral, None),
        # this eval's MISSING distinct_property bucket onto the batch's
        (np.where(dp_vids >= dp_counts0.shape[1] - 1, dpv_pad - 1, dp_vids)
         if dp_vids.shape[0] else dp_vids.reshape(0, enc.n_pad),
         (dpd_pad - dp_vids.shape[0], dn), dpv_pad - 1, None),
        (dp_limit, (dpd_pad - dp_limit.shape[0],), 1, None),
        (dp_applies, (dg, dpd_pad - dp_applies.shape[1]), False, None),
        (pre_res, (dn, dc(pre_res), 0), 0, None),
        (pre_prio, (dn, dc(pre_prio)), 0, None),
        (pre_elig, (dn, dc(pre_elig)), False, None),
        (pre_mp, (dn, dc(pre_mp)), 0, None),
        (pre_gid, (dn, dc(pre_gid)), 0, None),
        (pre_evf, (dn, dc(pre_evf), 0), neutral, None),
        (used0, (dn, dd), 0, f),
        (tg_counts0, (dg, dn), 0, None),
        (job_counts0, (dn,), 0, None),
        (spread_counts0, (dg, ds, dv), 0, f),
        (spread_entry0, (dg, ds, dv), False, None),
        (offset0, (), 0, i32),
        # padded TG slots are pre-failed -> padded steps are no-ops
        (failed0, (dg,), True, None),
        (e_base0, (dn if e_base0.shape[0] else 0, 0), neutral, None),
        (dp_counts0, (dpd_pad - dp_counts0.shape[0], dpv_pad - dp_counts0.shape[1]), 0, None),
        (pre_alive0, (dn, dc(pre_alive0)), False, None),
        # zero-HEIGHT rows without candidate tables; a preempt batch
        # needs full rows (zeros)
        ((pre_remaining0, (dn, 0), 0, None) if pre_remaining0.shape[0]
         else (np.zeros((0, 3), np.int64), (n_pad if prec_pad else 0, 0), 0, None)),
        (pre_counts0, (d["pregp_pad"] - pre_counts0.shape[0],), 0, None),
        # padded steps point at the first padded (pre-failed) TG slot
        (tg_idx, (dp,), enc.g, None),
        (penalty_idx, (dp, d["k_pad"] - penalty_idx.shape[1]), -1, None),
        (evict_node, (dp,), -1, None),
        (evict_res, (dp, d["evd_pad"] - evict_res.shape[1]), 0, f),
        (evict_tg, (dp,), -1, None),
        (limit_p, (dp,), 0, None),
        (sum_sw_p, (dp,), 1.0, f),
        (ev_factor, (dp, fac_pad - ev_factor.shape[1]), neutral, None),
        (rev_factor, (dp, fac_pad - rev_factor.shape[1]), neutral, None),
        (forced_node, (dp, d["fnd_pad"] - forced_node.shape[1]), -1, None),
    )


def _write_slab(encs: List[EncodedEval], dims: Dict[str, object], b_pad: int,
                slab: HostSlab):
    """Write the padded, stacked batch into ``slab``: each of the 48
    arrays a ``[b_pad, ...]`` block at a 16-byte offset, filled with its
    pad value, each eval's data written at the block's origin with one
    slice assignment, the filler evals (``b_pad`` past the batch) copies
    of eval 0 with every task group failed, as ``_pad_and_stack`` makes
    them. Returns the layout, its end in bytes and the blocks (numpy
    views of the slab)."""
    entries = [_slab_entries(e, dims) for e in encs]
    layout, off = [], 0
    for k, first in enumerate(entries[0]):
        shapes = set()
        for ent in entries:
            data, pads, _fill, dt = ent[k]
            data = np.asarray(data)
            if min(pads, default=0) < 0:
                raise ValueError(f"pack_batch: array {k} is wider than the batch's dims")
            shapes.add(tuple(n + w for n, w in zip(data.shape, pads)))
        if len(shapes) != 1:
            raise ValueError(f"pack_batch: array {k} pads to several shapes {sorted(shapes)}")
        dt = np.result_type(*(np.asarray(ent[k][0]).dtype if ent[k][3] is None else ent[k][3]
                              for ent in entries))
        off = -(-off // 16) * 16
        layout.append((off, dt, (b_pad, *shapes.pop())))
        off += int(np.prod(layout[-1][2], dtype=np.int64)) * dt.itemsize
    raw = slab.take(off)
    # every write holds the GIL where it can (convert.put_bytes): the
    # dispatcher shares it with the server's busy worker threads
    mv = memoryview(raw)
    blocks = []
    for k, (o, dt, shape) in enumerate(layout):
        block = np.ndarray(shape, dt, raw, o)
        blocks.append(block)
        row = block[0].nbytes
        fill0 = entries[0][k][2]
        mv[o:o + block.nbytes] = np.array(fill0, dt).tobytes() * block.size
        for b, ent in enumerate(entries):
            data, _pads, fill, _dt = ent[k]
            if fill != fill0:
                mv[o + b * row:o + (b + 1) * row] = np.array(fill, dt).tobytes() * block[0].size
            data = np.asarray(data, dt)
            if data.shape[1:] == block.shape[2:]:  # the eval's data is the row's head
                put_bytes(mv, o + b * row, data)
            else:
                block[(b, *(slice(0, n) for n in data.shape))] = data
        for f in range(len(encs), b_pad):
            mv[o + f * row:o + (f + 1) * row] = mv[o:o + row]
            if k == kernels._SCAN_INPUTS["failed"]:  # the fillers' steps all skip
                block[f] = True
    return layout, off, blocks


def pack_batch(encs: List[EncodedEval], dims: Dict[str, object], b_pad: int,
               device: DeviceLike = "cuda", slab: Optional[HostSlab] = None,
               times: Optional[Dict[str, float]] = None) -> kernels.PackedScan:
    """The batch ``_pad_and_stack`` makes (``dims`` from ``batch_dims``,
    ``b_pad`` evals with fillers) as one packed buffer on ``device``:
    written into ``slab`` (a new one when None) and moved with ONE
    ``non_blocking`` copy on the current stream. ``times`` (a dict)
    gains the host ms of the slab write (``slab``) and of the copy
    (``h2d``), which count as the ``pad_stack`` and ``device`` phases."""
    from ..utils import phases as _phases

    dev = resolve_device(device)
    if slab is None:
        slab = HostSlab(pin=dev.type == "cuda")
    t0 = time.perf_counter()
    with _phases.track("pad_stack"):
        layout, nbytes, blocks = _write_slab(encs, dims, b_pad, slab)
        m = kernels._check_batched(blocks[kernels.SCAN_STATIC], blocks[kernels.SCAN_CARRY],
                                   blocks[kernels.SCAN_XS])
    t1 = time.perf_counter()
    with _phases.track("device"):
        buf = slab.to_device(nbytes, dev)
    if times is not None:
        times["slab"] = times.get("slab", 0.0) + (t1 - t0) * 1e3
        times["h2d"] = times.get("h2d", 0.0) + (time.perf_counter() - t1) * 1e3
    return kernels.PackedScan(buf, layout, m)


class ShardLauncher:
    """A ``parallel.sharding.Mesh`` over a batch. The eval axis: a batch
    of ``b_pad`` slots (a multiple of the mesh's ``evals``) splits into
    ``evals`` contiguous groups of ``b_pad / evals``; a group with no
    real eval is not launched. Every launched shard is synchronized and
    the outputs come back concatenated in eval order, the filler evals
    dropped. A shard's error propagates: nothing runs unsharded, on the
    host or through the plain version instead (on the CPU the plain
    version is what a CPU shard runs). A ``DeviceBatcher`` given no mesh
    runs every batch through a one-entry mesh of its device: one shard,
    one launch.

    With ``nodes`` = 1 each group is packed into its own host slab
    (pinned on CUDA; ``pack_batch``) and run as its own K3 launch
    (``kernels.place_scan_batched_packed``, whose launch plan is made for
    the group's own B) on its own stream of its device.

    With ``nodes`` > 1 each group's padded node axis (``n_pad``, a
    multiple of ``nodes``: ``batch_dims``) splits further into
    ``parallel.sharding.node_slices``: shard ``j`` of group ``k`` runs on
    ``mesh.devices[k, j]`` with its own slab (``pack_node_shards``: the
    node-axis arrays sliced, the rest whole) and stream, and the step
    loop runs on the host: for every step, phases A, B and C
    (``kernels.place_scan_nodes_phase``), each one launch a shard.
    Before a phase, each shard's stream waits on the events the group's
    other shards recorded after their previous phase; after it, the
    shard copies its row of the phase's partials into every other
    shard's gathered buffer (``Tensor.copy_``, peer or same device) on
    its own stream and records its event. No launch waits on another:
    every exchange between shards is in stream order, between launches,
    so it runs alike on one card given several times, on several cards
    and on the CPU. A mesh that names one card several times runs this
    path too. The outputs come from shard 0 (the evict rows from each
    chosen node's owner)."""

    def __init__(self, mesh) -> None:
        ep, nn = int(mesh.shape["evals"]), int(mesh.shape["nodes"])
        # a shard is a run of whole evals (every slab entry's eval axis
        # leads, parallel.sharding.batched_scan_shardings), and with a
        # node axis a slice of their nodes
        self.ep, self.nodes = ep, nn
        self.grid = [[resolve_device(d) for d in row] for row in mesh.devices]
        self._slabs = [[HostSlab(pin=d.type == "cuda") for d in row] for row in self.grid]
        # the group's whole padded batch, written once and then sliced
        self._whole = [HostSlab(pin=False) for _ in range(ep)] if nn > 1 else []
        self._streams: List[List[Optional[torch.cuda.Stream]]] = [[None] * nn for _ in range(ep)]

    def round_batch(self, b: int) -> int:
        """``b`` rounded up to a multiple of the eval axis."""
        return -(-b // self.ep) * self.ep

    def _stream(self, k: int, j: int = 0):
        """Shard ``(k, j)``'s own CUDA stream made current (created at its
        first launch); a no-op on the CPU."""
        dev = self.grid[k][j]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if self._streams[k][j] is None:
            self._streams[k][j] = torch.cuda.Stream(device=dev)
        return torch.cuda.stream(self._streams[k][j])

    def __call__(self, encs: List[EncodedEval], dims: Dict[str, object], b_pad: int,
                 times: Optional[Dict[str, float]] = None, launched: Optional[list] = None):
        """Run ``encs`` (one dtype, ``dims`` from ``batch_dims``) as
        ``b_pad`` slots over the shards; returns ``(chosen, scores, pulls,
        skipped, evict)``, each ``[len(encs), P_pad, ...]``. ``times``
        gains the host ms by ``BATCH_SECTIONS``; ``launched`` (a list)
        gains the device of each shard launched."""
        if b_pad % self.ep or b_pad < len(encs):
            raise ValueError(f"ShardLauncher: b_pad {b_pad} is not a multiple of "
                             f"{self.ep} holding {len(encs)} evals")
        if dims["n_pad"] % self.nodes:
            raise ValueError(f"ShardLauncher: n_pad {dims['n_pad']} is not a multiple of "
                             f"the node axis {self.nodes} (batch_dims(encs, nodes))")
        if any(d.type == "cuda" for row in self.grid for d in row):
            kernels.build_all()
        times = {} if times is None else times
        per = b_pad // self.ep
        groups = [(k, encs[k * per:(k + 1) * per]) for k in range(self.ep)]
        groups = [(k, g) for k, g in groups if g]
        if self.nodes > 1:
            outs = self._run_node_shards(groups, dims, per, times, launched)
        else:
            outs = self._run_eval_shards(groups, dims, per, times, launched)
        b = len(encs)
        return tuple(np.concatenate([o[i] for o in outs])[:b] for i in range(5))

    def _run_eval_shards(self, groups, dims, per, times, launched):
        """One K3 launch a group (``nodes`` = 1)."""
        from ..utils import phases as _phases

        launch_ms = 0.0
        runs = []
        for k, group in groups:
            with self._stream(k):
                # the slab write (pad_stack) and its one copy in (device)
                packed = pack_batch(group, dims, per, self.grid[k][0], self._slabs[k][0], times)
                with _phases.track("device"):
                    t0 = time.perf_counter()
                    runs.append((k, kernels.place_scan_batched_packed(packed)))
                    launch_ms += (time.perf_counter() - t0) * 1e3
            if launched is not None:
                launched.append(self.grid[k][0])
        with _phases.track("device"):
            t1 = time.perf_counter()
            for k, _ in runs:
                if self.grid[k][0].type == "cuda":
                    self._streams[k][0].synchronize()
            t2 = time.perf_counter()
            outs = []
            for k, (out, out_layout) in runs:
                with self._stream(k):
                    outs.append(from_device_packed(out, out_layout))
            t3 = time.perf_counter()
        times["launch"] = launch_ms + (t2 - t1) * 1e3
        times["d2h"] = (t3 - t2) * 1e3
        return outs

    def _run_node_shards(self, groups, dims, per, times, launched):
        """Each group over ``nodes`` node shards, the phase loop on the
        host (``run_node_phases``)."""
        from ..utils import phases as _phases

        nn = self.nodes
        rows, keys = [], []
        for k, group in groups:
            rows.append(pack_node_shards(group, dims, per, self.grid[k], self._whole[k],
                                         self._slabs[k],
                                         [self._stream(k, j) for j in range(nn)], times))
            keys.append(k)
            if launched is not None:
                launched.extend(self.grid[k])
        with _phases.track("device"):
            return run_node_phases(rows, lambda r, j: self._stream(keys[r], j),
                                   int(dims["p_pad"]), times)


def run_node_phases(rows, stream_of, p_count: int,
                    times: Optional[Dict[str, float]] = None) -> List[tuple]:
    """The node-sharded scan's step loop over ``rows`` (each the
    ``kernels.NodeShard``s of one eval group, in shard order; several
    groups run side by side): for every step, phases A, B and C, each
    one ``kernels.place_scan_nodes_phase`` launch a shard on its stream
    (``stream_of(row, shard)``: a context that makes it current), then a
    last phase A that takes in the last step's partials 3. Before a
    phase every shard's stream waits on the events its group's other
    shards recorded after their previous phase (all of a phase's waits
    are enqueued before any of its records); after it, each shard
    copies its row of the phase's partials into the others' gathered
    buffers on its own stream and records its event. Then every stream
    is synchronized and each group's outputs come back: ``(chosen,
    scores, pulls, skipped, evict)`` of shard 0, the evict rows from each
    chosen node's owner. ``times`` gains the host ms of the loop with its
    synchronize (``launch``) and of the copies back (``d2h``)."""
    events = [[torch.cuda.Event() if sh.buf.device.type == "cuda" else None for sh in row]
              for row in rows]
    t0 = time.perf_counter()
    for p in range(p_count + 1):
        for phase in range(kernels.NODE_PHASES):
            if p == p_count and phase:
                break
            for r, row in enumerate(rows):
                _node_phase(row, events[r], lambda j: stream_of(r, j), phase, p,
                            first=p == 0 and phase == 0)
    for r, row in enumerate(rows):
        for j, sh in enumerate(row):
            if sh.buf.device.type == "cuda":
                with stream_of(r, j):
                    torch.cuda.current_stream(sh.buf.device).synchronize()
    t1 = time.perf_counter()
    outs = []
    for r, row in enumerate(rows):
        got = []
        for j, sh in enumerate(row):
            with stream_of(r, j):
                got.append(sh.outputs())
        evict = got[0][4]
        for o in got[1:]:
            evict = np.maximum(evict, o[4])
        outs.append((*got[0][:4], evict))
    if times is not None:
        times["launch"] = times.get("launch", 0.0) + (t1 - t0) * 1e3
        times["d2h"] = times.get("d2h", 0.0) + (time.perf_counter() - t1) * 1e3
    return outs


def _node_phase(row, events, stream_of, phase: int, p: int, first: bool) -> None:
    """One phase of one step on every node shard of one group
    (``run_node_phases``)."""
    nn = len(row)
    if not first:
        for j, sh in enumerate(row):
            if events[j] is None:
                continue
            with stream_of(j):
                st = torch.cuda.current_stream(sh.buf.device)
                for i in range(nn):
                    if i != j and events[i] is not None:
                        st.wait_event(events[i])
    for j, sh in enumerate(row):
        with stream_of(j):
            kernels.place_scan_nodes_phase(sh, phase, p)
            own = sh.gath[phase][j]
            for i, other in enumerate(row):
                if i != j and own.numel():
                    other.gath[phase][j].copy_(own, non_blocking=True)
            if events[j] is not None:
                events[j].record()


def pack_node_shards(encs: List[EncodedEval], dims: Dict[str, object], b_pad: int,
                     devices, whole: HostSlab, slabs, streams,
                     times: Optional[Dict[str, float]] = None) -> List["kernels.NodeShard"]:
    """The batch ``pack_batch`` makes, split over ``len(devices)`` node
    shards (``parallel.sharding.node_slices`` of ``dims["n_pad"]``): the
    padded, stacked batch is written once into ``whole``, then each
    shard's arrays (every node axis cut to its slice,
    ``node_shard.slice_nodes``; the rest whole) and the batch's
    replicated ``node_shard.evict_vids`` go into its own slab and over
    to its device with one copy, on its stream (``streams``: one context
    a shard). ``times`` gains ``slab`` and ``h2d`` as ``pack_batch``'s."""
    from ..parallel.sharding import node_slices
    from ..utils import phases as _phases
    from . import node_shard

    nn = len(devices)
    t0 = time.perf_counter()
    with _phases.track("pad_stack"):
        _layout, _nbytes, blocks = _write_slab(encs, dims, b_pad, whole)
        kernels._check_batched(blocks[kernels.SCAN_STATIC], blocks[kernels.SCAN_CARRY],
                               blocks[kernels.SCAN_XS])
        ev = node_shard.evict_vids(*(torch.from_numpy(blocks[i]) for i in (9, 40, 42))).numpy()
        parts = []
        for lo, hi in node_slices(int(dims["n_pad"]), nn):
            arrays = [*node_shard.slice_nodes(blocks, lo, hi, batched=True), ev]
            parts.append((lo, _write_arrays(arrays, slabs[len(parts)])))
    t1 = time.perf_counter()
    out = []
    with _phases.track("device"):
        for j, (lo, (layout, nbytes)) in enumerate(parts):
            with streams[j]:
                buf = slabs[j].to_device(nbytes, devices[j])
                out.append(kernels.NodeShard(buf, layout, lo, j, nn))
    if times is not None:
        times["slab"] = times.get("slab", 0.0) + (t1 - t0) * 1e3
        times["h2d"] = times.get("h2d", 0.0) + (time.perf_counter() - t1) * 1e3
    return out


def _write_arrays(arrays, slab: HostSlab):
    """Each numpy array into ``slab`` at a 16-byte offset, in order
    (``convert.put_bytes``); returns the layout and its end."""
    layout, off = [], 0
    for a in arrays:
        off = -(-off // 16) * 16
        layout.append((off, a.dtype, tuple(a.shape)))
        off += a.nbytes
    mv = memoryview(slab.take(off))
    for (o, _dt, _shape), a in zip(layout, arrays):
        put_bytes(mv, o, a)
    return layout, off


class _Request:
    __slots__ = ("enc", "event", "result", "error", "t_enqueue")

    def __init__(self, enc: EncodedEval) -> None:
        self.enc = enc
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()


class DeviceBatcher:
    """Gather-window batcher in front of the eval-batched placement scan.

    ``run(enc)`` blocks the calling worker until its eval's slice of the
    batched result is ready. The dispatcher thread starts lazily on first
    use and stops with ``stop()``. ``device`` is where the batches run:
    CUDA unless the caller asks for the CPU.
    """

    def __init__(self, max_batch: int = 8, window_ms: float = 1.0,
                 idle_ms: float = 0.0, queue_max: int = 4096,
                 device: DeviceLike = "cuda", mesh=None) -> None:
        self.device = resolve_device(device)
        # batches sharded over a parallel.sharding.Mesh (evals, and with
        # nodes > 1 each eval's node tables); None runs each batch as one
        # launch on ``device``, the one-entry mesh's one shard
        self.mesh = mesh
        self._shards = ShardLauncher(
            mesh if mesh is not None else make_mesh(1, devices=[self.device]))
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        # Adaptive gather: with idle_ms > 0 the batch keeps growing while
        # requests keep ARRIVING within idle_ms of each other (encode of a
        # burst trickles evals in), dispatching when the stream pauses;
        # window_ms then acts as the total cap. 0 = fixed-window behavior.
        self.idle_s = max(0.0, float(idle_ms)) / 1000.0
        # Bounded request queue: a wedged dispatcher must surface as
        # worker backpressure (blocking put), not unbounded growth.
        # queue_max <= 0 means unbounded.
        self.queue_max = int(queue_max)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(0, self.queue_max)
        )
        self._lock = witness_lock("batcher.DeviceBatcher._lock")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # observability — the server publishes these as
        # nomad.device_batcher.* gauges in its stats sweep. Written by the
        # dispatcher thread; every read-modify-write takes _lock.
        self.stats = tracked_dict("batcher.DeviceBatcher.stats", {  # guarded-by: _lock
            "dispatches": 0,
            "evals": 0,
            "max_batch_seen": 0,
            "padded_evals": 0,
            # wave-fill accounting: gathers = gather rounds closed,
            # full_gathers = rounds that filled max_batch
            "gathers": 0,
            "full_gathers": 0,
            # gather-window latency (enqueue -> dispatch start)
            "gather_wait_ms_total": 0.0,
            "gather_wait_ms_max": 0.0,
            # per-dispatch timing split: host pad/stack vs device compute
            # (host-to-device copy, launch and the stream synchronize) vs
            # the device-to-host copy of the outputs
            "pad_stack_ms_total": 0.0,
            "compute_ms_total": 0.0,
            "transfer_ms_total": 0.0,
            "d2h_bytes_total": 0,
            # K3 launches by device (a sharded batch launches once per
            # shard that holds a real eval)
            "device_dispatches": {},
        })
        # Demand-aware gather (guarded-by: _lock): workers announce an
        # encode-in-flight destined for this batcher via expect(); the
        # gather loop keeps its window open while announced encodes are
        # still en route instead of breaking on a fixed idle gap. Armed
        # lazily on the first expect().
        self._expected = 0
        self._demand_aware = False
        # host ms of each batch by section (section_profile)
        self._sections: "deque[Dict[str, float]]" = deque(maxlen=4096)  # guarded-by: _lock

    # -- lifecycle -------------------------------------------------------

    def _ensure_started(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="device-batcher",
                    daemon=True,
                )
                self._thread.start()

    def stop(self, timeout: Optional[float] = 5) -> None:
        """Stop the dispatcher and release every request still queued."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        # release anyone still parked
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("device batcher stopped")
            req.event.set()

    # -- worker-facing ---------------------------------------------------

    def queue_depth(self) -> int:
        """Requests gathered but not yet dispatched."""
        return self._queue.qsize()

    def has_warmed(self) -> bool:
        """True once at least one batch has dispatched: the kernels are
        built, and the engine's retry gate (compute_placements) reroutes
        small OCC retries here."""
        with self._lock:
            return self.stats["dispatches"] > 0

    def stats_snapshot(self) -> Dict[str, object]:
        """A copy of ``stats`` taken under the lock its writers hold."""
        with self._lock:
            snap = dict(self.stats)
            snap["device_dispatches"] = dict(snap["device_dispatches"])
            return snap

    def wait_warm(self, timeout: Optional[float] = None) -> None:
        """Return once outstanding bucket warming has finished: at once,
        since the port compiles nothing per batch shape. The reference
        joins its XLA prewarm threads here; the port's kernels build at
        first use, in ``kernels.build_all``. Kept, with the reference's
        signature, for boot sequences that call it before their timed
        window (``timeout`` is accepted and unused)."""
        return None

    def expect(self, n: int = 1) -> None:
        """Announce ``n`` encodes in flight that will submit here. The
        gather loop holds its window open (up to window_ms) while
        announced work is still en route. Every expect() must be balanced
        by run(expected=True) or cancel_expected()."""
        with self._lock:
            self._demand_aware = True
            self._expected += n

    def cancel_expected(self) -> None:
        """Withdraw one expect() (encode fell back to the host path or
        raised)."""
        with self._lock:
            self._expected = max(0, self._expected - 1)

    def _expected_now(self) -> int:
        with self._lock:
            return self._expected if self._demand_aware else -1

    def run(self, enc: EncodedEval, expected: bool = False):
        """Submit one encoded eval; blocks until its results are ready.
        Returns (chosen, scores, pulls, skipped, evict) numpy arrays of
        length enc.p (already sliced back from the padded batch); raises
        the launch's error when its batch, and then its own retry,
        failed.

        ``expected=True`` consumes one prior expect() announcement."""
        if expected:
            # release the demand token before anything that can raise
            self.cancel_expected()
        chaos_fire("device_dispatch", evals=enc.p)
        self._ensure_started()
        req = _Request(enc)
        self._queue.put(req)
        while not req.event.wait(timeout=0.5):
            self._ensure_started()
        if req.error is not None:
            raise req.error
        return req.result

    # -- dispatcher ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            if self.window_s > 0 and self.max_batch > 1:
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    # adaptive mode waits only as long as the arrival gap
                    wait = min(remaining, self.idle_s) if self.idle_s else remaining
                    # demand-aware: while announced encodes are still en
                    # route, keep polling up to the window cap instead of
                    # closing the wave on an arrival gap
                    demand = self._expected_now()
                    if demand > 0:
                        wait = min(remaining, max(wait, 0.02))
                    try:
                        batch.append(self._queue.get(timeout=wait))
                    except queue.Empty:
                        if demand > 0 and self._expected_now() > 0:
                            continue  # encodes still en route
                        break  # stream paused (or window expired)
            else:
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
            with self._lock:
                self.stats["gathers"] += 1
                if len(batch) >= self.max_batch:
                    self.stats["full_gathers"] += 1
            # dtype-homogeneous sub-batches: co-batching must never change
            # an eval's arithmetic. int32 = the exact integer parity spec;
            # floats = throughput modes.
            for dtype in (np.int32, np.float64, np.float32):
                group = [r for r in batch if r.enc.dtype == dtype]
                if group:
                    self._run_batch_safe(group)

    def _run_batch_safe(self, batch: List[_Request]) -> None:
        try:
            self._run_batch(batch)
            return
        except Exception:  # noqa: BLE001 — confine the blast radius
            logger.exception(
                "batched launch failed; retrying %d evals one by one",
                len(batch),
            )
        except BaseException as e:
            for req in batch:
                req.error = e
                req.event.set()
            raise
        for req in batch:
            # the retry runs on the kernel too; an error that remains
            # goes to the waiting run()
            try:
                self._run_batch([req])
            except Exception as e:  # noqa: BLE001
                req.error = e
                req.event.set()

    def _buckets(self) -> List[int]:
        mid = max(1, self.max_batch // 4)
        out = [1]
        if mid not in out:
            out.append(mid)
        if self.max_batch not in out:
            out.append(self.max_batch)
        return sorted({self._shards.round_batch(b) for b in out})

    def dispatch_profile(self) -> Dict[str, object]:
        """Per-dispatch timing split: where does a dispatch's wall time
        go (host pad/stack vs device compute vs D2H transfer), and which
        leg binds."""
        with self._lock:
            s = dict(self.stats)
        n = s["dispatches"]
        if n == 0:
            return {"dispatches": 0, "note": "no dispatches recorded"}
        pad = s["pad_stack_ms_total"] / n
        comp = s["compute_ms_total"] / n
        xfer = s["transfer_ms_total"] / n
        gbps = 0.0
        if s["transfer_ms_total"] > 0:
            gbps = s["d2h_bytes_total"] / (s["transfer_ms_total"] / 1e3) / 1e9
        legs = {"pad/stack (host)": pad, "compute (device)": comp,
                "transfer (D2H)": xfer}
        bound = max(legs, key=legs.get)
        total = pad + comp + xfer
        note = (
            f"{bound}-bound: {legs[bound]:.2f}ms of {total:.2f}ms per "
            f"dispatch (pad/stack {pad:.2f}ms, compute {comp:.2f}ms, "
            f"transfer {xfer:.2f}ms at {gbps:.2f} GB/s D2H, "
            f"{s['evals'] / n:.1f} evals/dispatch)"
        )
        return {
            "dispatches": n,
            "evals": s["evals"],
            "pad_stack_ms_avg": round(pad, 3),
            "compute_ms_avg": round(comp, 3),
            "transfer_ms_avg": round(xfer, 3),
            "d2h_bytes_total": s["d2h_bytes_total"],
            "d2h_gbps": round(gbps, 3),
            "note": note,
        }

    def section_profile(self) -> Dict[str, object]:
        """Host ms of the recorded batches (the last 4,096) by section
        (``BATCH_SECTIONS``: the slab write, the copy in, the launch with
        the stream's synchronize, the copy back): the median and the sum
        of each."""
        with self._lock:
            rows = list(self._sections)
        out: Dict[str, object] = {"batches": len(rows)}
        for name in BATCH_SECTIONS:
            v = sorted(r[name] for r in rows)
            out[name] = {"median_ms": v[len(v) // 2] if v else 0.0, "sum_ms": sum(v)}
        return out

    def _run_batch(self, batch: List[_Request]) -> None:
        from ..utils import metrics

        t_start = metrics.now()
        encs = [r.enc for r in batch]
        # shared bucketed dims; the dispatch loop groups by dtype
        dims = batch_dims(encs, self._shards.nodes)
        b = len(encs)
        # Three batch buckets — 1, max/4, max.
        b_pad = min(x for x in self._buckets() if x >= b)
        times: Dict[str, float] = {}
        launched: List[torch.device] = []
        # one K3 launch per shard, each on its own slab and stream
        chosen, scores, pulls, skipped, evict = self._shards(encs, dims, b_pad, times, launched)
        compute_ms = times["h2d"] + times["launch"]
        metrics.add_sample("nomad.device_batcher.pad_stack", times["slab"])
        metrics.add_sample("nomad.device_batcher.dispatch", compute_ms + times["d2h"])
        metrics.add_sample("nomad.device_batcher.compute", compute_ms)
        metrics.add_sample("nomad.device_batcher.transfer", times["d2h"])
        d2h_bytes = (
            chosen.nbytes + scores.nbytes + pulls.nbytes + skipped.nbytes
            + evict.nbytes
        )

        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["evals"] += b
            self.stats["padded_evals"] += b_pad - b
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], b)
            self.stats["pad_stack_ms_total"] += times["slab"]
            self.stats["compute_ms_total"] += compute_ms
            self.stats["transfer_ms_total"] += times["d2h"]
            self.stats["d2h_bytes_total"] += d2h_bytes
            per_device = self.stats["device_dispatches"]
            for dev in launched:
                per_device[str(dev)] = per_device.get(str(dev), 0) + 1
            self._sections.append(times)
            for req in batch:
                # t_start and t_enqueue share the monotonic clock
                wait_ms = (t_start - req.t_enqueue) * 1000.0
                if wait_ms > 0:
                    self.stats["gather_wait_ms_total"] += wait_ms
                    self.stats["gather_wait_ms_max"] = max(
                        self.stats["gather_wait_ms_max"], wait_ms
                    )

        for bi, req in enumerate(batch):
            p = req.enc.p
            req.result = (
                chosen[bi, :p], scores[bi, :p], pulls[bi, :p], skipped[bi, :p],
                evict[bi, :p],
            )
            req.event.set()

    def _pad_and_stack(self, encs, n_pad, g_pad, s_pad, v_pad, p_pad, dtype,
                       d_pad, k_pad, aff_pad, evd_pad, fac_pad, dpd_pad,
                       dpv_pad, fnd_pad, prec_pad=0, pregp_pad=0):
        """The batch as ``pad_encoded`` pads each eval and ``np.stack``
        stacks it: the plain reference ``pack_batch`` is held against."""
        padded = [
            pad_encoded(e, n_pad, g_pad, s_pad, v_pad, p_pad, dtype, d_pad,
                        k_pad, aff_pad, evd_pad, fac_pad, dpd_pad, dpv_pad,
                        fnd_pad, prec_pad, pregp_pad)
            for e in encs
        ]

        b = len(padded)
        # Three batch buckets — 1, max/4, max.
        b_pad = min(x for x in self._buckets() if x >= b)
        if len(padded) < b_pad:
            # inert copies (results discarded): every task group
            # pre-failed, so each of their steps is skipped
            static0, carry0, xs0 = padded[0]
            carry0 = list(carry0)
            carry0[6] = np.ones_like(carry0[6])
            filler = (static0, tuple(carry0), xs0)
            padded.extend([filler] * (b_pad - len(padded)))

        static_b = tuple(
            np.stack([p[0][i] for p in padded]) for i in range(len(padded[0][0]))
        )
        carry_b = tuple(
            np.stack([p[1][i] for p in padded]) for i in range(len(padded[0][1]))
        )
        xs_b = tuple(
            np.stack([p[2][i] for p in padded]) for i in range(len(padded[0][2]))
        )
        return static_b, carry_b, xs_b, b, b_pad
