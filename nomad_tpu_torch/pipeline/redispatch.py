"""Retry-aware re-dispatch: partial OCC failures re-enter the device
stage from the failed wave's own encode.

When the async applier (pipeline/applier.py) sees a partial commit —
some of a wave's dense placements lost the optimistic-concurrency race
to capacity another wave grabbed first — the classic path nacks the
eval and the whole lifecycle replays: snapshot, reconcile, encode,
dispatch. But the failed wave's encode is already in hand (the engine
registers it here before dispatching, engine._pipeline_remember), and
every per-placement array in an ``EncodedEval.xs`` carries the
placement axis leading (encode.subset_encoded_rows), so the retry is:

  1. row-subset the encode to just the failed placements,
  2. patch the usage carry (carry[0]/carry[7]) to the CURRENT usage
     epoch via encode.epoch_usage_arrays — the same job-independent
     swap the whole-eval encode cache uses, so the retry sees exactly
     the capacity state that rejected it,
  3. re-dispatch through the batcher, padding into the coarse
     placement buckets that are already compile-warm from the first
     pass.

No snapshot, no reconcile, no encode — and no fresh ``encode`` stage
span, which is precisely what the OCC-storm test asserts.

Safety gates (bail to the broker-nack path, which is always correct):
the remembered encode must be dense-path (fresh placements only), free
of preemption/eviction state, free of distinct_hosts / distinct_property
constraints (their per-node counts in the carry would be stale after
the partial commit), 4-dim (the usage patch covers no device dims),
and the fleet must not have changed shape (node epoch).

Copied from ``nomad_tpu/pipeline/redispatch.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. The
re-dispatch runs on the port's engine (``TorchPlacementEngine`` on the
server's ``device``) or its ``DeviceBatcher``: an OCC retry runs on the
kernel too.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from ..structs.structs import Plan, PlanResult
from ..trace import lifecycle as _lifecycle
from ..utils import metrics
from ..utils.lock_witness import witness_lock

logger = logging.getLogger("nomad_tpu_torch.pipeline.redispatch")

# remembered encodes are references into arrays the engine already
# holds; the cap only bounds bookkeeping, not array memory
_REGISTRY_CAP = 512


class _ShimCtx:
    """The minimal EvalContext surface fleet_static/epoch_usage_arrays
    read: a state snapshot and the deterministic flag (remembered
    encodes only exist in deterministic mode — fleet_static returns
    None otherwise, and the engine's cache path requires a fleet)."""

    __slots__ = ("state", "deterministic")

    def __init__(self, state) -> None:
        self.state = state
        self.deterministic = True


class WaveEncodeRegistry:
    """eval id -> (encode, job, node_epoch) for waves currently in
    flight between device dispatch and raft commit. Bounded FIFO; the
    applier forgets entries on ack/nack."""

    def __init__(self, cap: int = _REGISTRY_CAP) -> None:
        self._lock = witness_lock("redispatch.WaveEncodeRegistry._lock")
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self.cap = cap

    def remember(self, eval_id: str, enc, job, node_epoch: int) -> None:
        with self._lock:
            self._entries.pop(eval_id, None)
            self._entries[eval_id] = (enc, job, node_epoch)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def get(self, eval_id: str) -> Optional[tuple]:
        with self._lock:
            return self._entries.get(eval_id)

    def forget(self, eval_id: str) -> None:
        with self._lock:
            self._entries.pop(eval_id, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _retry_eligible(enc) -> Optional[str]:
    """None when the remembered encode can be row-subset + usage-patched
    safely; else the reason it can't."""
    if not enc.dense_ok:
        return "not dense"
    if enc.pre_allocs is not None:
        return "preemption tables"
    static = enc.static
    if static[0].shape[1] != 4:
        return "device dims"
    # distinct_hosts / distinct_property counts in the carry are stale
    # once part of the wave committed
    if bool(np.asarray(static[6]).any()) or bool(np.asarray(static[7]).any()):
        return "distinct_hosts"
    if static[17].shape[0] > 0:
        return "distinct_property"
    # spread bucket counts are wave-relative state too
    if bool(np.asarray(static[13]).any()):
        return "spread"
    # eviction steps must be absent (no destructive placements rode
    # along); evict_node is (p,) with -1 = no eviction for that row
    if bool((np.asarray(enc.xs[2]) >= 0).any()):
        return "eviction axis"
    # forced-node (system path) encodes carry a non-empty width axis
    if enc.xs[9].ndim == 2 and enc.xs[9].shape[1] > 0:
        return "forced nodes"
    return None


class Redispatcher:
    """Builds the retry plan for a partially-committed wave, or returns
    None when the safe answer is the classic nack path."""

    def __init__(self, server, registry: WaveEncodeRegistry) -> None:
        self.server = server
        self.registry = registry

    # -- failed-placement mapping ---------------------------------------

    @staticmethod
    def _failed_keys(plan: Plan, result: PlanResult) -> List[Tuple[str, str]]:
        """(task_group, placement name) of every planned dense placement
        the applier did NOT commit."""
        committed = {
            i for b in result.dense_placements for i in b.ids
        }
        failed: List[Tuple[str, str]] = []
        for block in plan.dense_placements:
            for i, pid in enumerate(block.ids):
                if pid not in committed:
                    failed.append((block.task_group, block.names[i]))
        return failed

    # -- retry construction ---------------------------------------------

    def build_retry(self, plan: Plan, result: PlanResult) -> Optional[Plan]:
        rec = self.registry.get(plan.eval_id)
        if rec is None:
            metrics.incr_counter("nomad.pipeline.redispatch_miss")
            return None
        enc, job, node_epoch = rec

        reason = _retry_eligible(enc)
        if reason is not None:
            logger.debug("redispatch ineligible (%s): %s", plan.eval_id[:8],
                         reason)
            metrics.incr_counter("nomad.pipeline.redispatch_ineligible")
            return None

        snap = self.server.fsm.state.snapshot()
        if getattr(snap, "node_epoch", -1) != node_epoch:
            metrics.incr_counter("nomad.pipeline.redispatch_node_epoch")
            return None

        failed = self._failed_keys(plan, result)
        if not failed:
            return None
        failed_set = set(failed)
        rows = [
            k for k, m in enumerate(enc.missing_list)
            if (m.get_task_group().name, m.get_name()) in failed_set
        ]
        if len(rows) != len(failed):
            # the plan's placements don't map 1:1 onto the remembered
            # encode (shouldn't happen; refuse rather than guess)
            metrics.incr_counter("nomad.pipeline.redispatch_map_mismatch")
            return None

        retry_enc = self._patched_subset(enc, job, snap, rows)
        if retry_enc is None:
            return None

        from ..tpu.engine import TorchPlacementEngine

        engine = TorchPlacementEngine.shared(self.server.config.device)
        batcher = self.server.device_batcher
        with _lifecycle.pipeline_stage("dispatch", plan.eval_id):
            if batcher is not None:
                chosen, scores, pulls, skipped, _evict = batcher.run(retry_enc)
            else:
                chosen, scores, pulls, skipped, _evict = engine.run_scan_single(
                    retry_enc)
        p = retry_enc.p
        chosen = np.asarray(chosen)[:p]
        skipped = np.asarray(skipped)[:p]
        if (chosen < 0).any() or skipped.any():
            # capacity genuinely gone — a fresh eval pass (blocked-eval
            # machinery included) must decide, not a blind retry
            metrics.incr_counter("nomad.pipeline.redispatch_unplaced")
            return None

        blocks = self._dense_blocks(plan, job, retry_enc, chosen,
                                    np.asarray(scores)[:p],
                                    np.asarray(pulls)[:p])
        metrics.incr_counter("nomad.pipeline.redispatch")
        metrics.incr_counter("nomad.pipeline.redispatch_encode_reuse")
        return Plan(
            eval_id=plan.eval_id,
            eval_token=plan.eval_token,
            priority=plan.priority,
            all_at_once=plan.all_at_once,
            job=plan.job,
            dense_placements=blocks,
            snapshot_index=snap.latest_index,
            async_ok=True,
        )

    def _patched_subset(self, enc, job, snap, rows):
        """Row-subset the encode and swap its usage arrays to the
        snapshot's epoch (the encode-cache patch, reused)."""
        from ..tpu.encode import (
            epoch_usage_arrays,
            fleet_static,
            subset_encoded_rows,
        )
        from ..tpu.engine import EncodedEval

        ctx = _ShimCtx(snap)
        fleet = fleet_static(ctx, job, enc.nodes)
        if fleet is None:
            metrics.incr_counter("nomad.pipeline.redispatch_no_fleet")
            return None
        try:
            used0, e_base0 = epoch_usage_arrays(
                ctx, fleet, enc.n_pad, enc.dtype == np.int32, enc.dtype
            )
        except Exception:  # noqa: BLE001 — patch failure => classic path
            logger.exception("usage patch failed for redispatch")
            return None
        carry = list(enc.carry)
        carry[0] = used0
        carry[7] = e_base0
        xs_sub, ml_sub = subset_encoded_rows(enc.xs, enc.missing_list, rows)
        return EncodedEval(
            n_real=enc.n_real, n_pad=enc.n_pad, g=enc.g, s=enc.s, v=enc.v,
            p=len(rows), dtype=enc.dtype, static=enc.static,
            carry=tuple(carry), xs=xs_sub, missing_list=ml_sub,
            nodes=enc.nodes, table=enc.table,
            start_ns=time.monotonic_ns(), dense_ok=True,
        )

    @staticmethod
    def _dense_blocks(plan: Plan, job, enc, chosen, scores, pulls):
        """Committed-shape DenseTGPlacements for the retry results,
        grouped by task group (engine._apply_results_dense, minus the
        scheduler context)."""
        from ..tpu.engine import TorchPlacementEngine

        dep_by_tg = {b.task_group: b.deployment_id
                     for b in plan.dense_placements}
        scores_f = TorchPlacementEngine._scores_to_float(np.asarray(scores))
        tg_idx = enc.xs[0]
        blocks = []
        for gi in np.unique(tg_idx):
            sel = np.nonzero(tg_idx == gi)[0]
            tg = job.task_groups[int(gi)]
            blocks.append(TorchPlacementEngine._dense_block(
                job, tg, plan.eval_id,
                chosen[sel], enc.nodes,
                names=[enc.missing_list[int(k)].get_name() for k in sel],
                scores_f=scores_f[sel],
                nodes_evaluated=np.asarray(pulls)[sel].tolist(),
                nodes_available={},
                deployment_id=dep_by_tg.get(tg.name, ""),
            ))
        return blocks
