"""Capacity-pressure observability: unblock storms as first-class gauges.

The failover module (:mod:`.failover`) answers "how long were we
headless"; this one answers "how long were we *saturated*". When demand
exceeds capacity, evals park in ``BlockedEvals``; when capacity arrives
(node registrations, alloc stops, an autoscaler step) the tracker
re-enqueues them in batches — an *unblock storm*. This module measures
that storm end-to-end:

- ``unblock_to_place_ms`` — per-eval latency from the batched broker
  re-enqueue to the eval's successful ack (the placement landed). The
  p50/p99 of this distribution is the capacity-to-placement SLO the
  chaos gate bounds.
- ``unblock_batch_size`` — size of each coalesced re-enqueue batch.
  Mean > 1 during a storm is the observable proof that per-class /
  per-node / quota triggers were deduped into batched enqueues instead
  of a per-trigger stampede.
- ``blocked_depth`` peak — high-water mark of parked evals, so a run
  can assert the depth drained back to ~0 by trace end.

Producers: ``BlockedEvals`` stamps unblocked ids and batch sizes;
``EvalBroker.ack`` closes the latency sample (a dict-lookup no-op for
evals that were never blocked); the autoscaler/replay note depth.
Numeric summary fields are published under ``nomad.blocked_evals.*``
next to the tracker's own EmitStats gauges.

Copied from ``nomad_tpu/trace/capacity.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

from ..utils import metric_names, metrics
from ..utils.lock_witness import module_witness_lock

_MAX_PENDING = 131072     # unblocked-but-not-yet-placed watermark cap
_MAX_SAMPLES = 131072

_lock = module_witness_lock("capacity._lock")
_pending: Dict[str, float] = {}     # eval id -> unblock stamp (monotonic)
_place_ms: List[float] = []         # closed unblock->ack latencies
_batches: List[int] = []            # per-flush coalesced batch sizes
_peak_blocked = 0
_unblocked_total = 0
_placed_total = 0


def _percentile(sorted_vals: List[float], pct: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(len(sorted_vals) * pct))
    return sorted_vals[idx]


def mark_unblocked(eval_ids: Iterable[str], t: Optional[float] = None) -> None:
    """Stamp a batch of evals at their re-enqueue (BlockedEvals flush)."""
    global _unblocked_total
    stamp = time.monotonic() if t is None else t
    with _lock:
        for eid in eval_ids:
            _pending[eid] = stamp
            _unblocked_total += 1
        while len(_pending) > _MAX_PENDING:
            _pending.pop(next(iter(_pending)))


def observe_placed(eval_id: str, t: Optional[float] = None) -> None:
    """Close an unblock->place sample on broker ack. Cheap no-op for the
    (overwhelmingly common) eval that was never blocked."""
    global _placed_total
    if not _pending:
        return
    with _lock:
        start = _pending.pop(eval_id, None)
        if start is None:
            return
        _placed_total += 1
        ms = ((time.monotonic() if t is None else t) - start) * 1000.0
        _place_ms.append(ms)
        del _place_ms[:-_MAX_SAMPLES]
    metrics.add_sample("nomad.blocked_evals.unblock_to_place_ms", ms)


def record_batch(size: int) -> None:
    """One coalesced re-enqueue batch left for the broker."""
    with _lock:
        _batches.append(int(size))
        del _batches[:-_MAX_SAMPLES]
    metrics.add_sample("nomad.blocked_evals.unblock_batch_size", float(size))


def note_blocked_depth(depth: int) -> None:
    """Track the blocked-eval high-water mark (stats sweeps call this)."""
    global _peak_blocked
    with _lock:
        if depth > _peak_blocked:
            _peak_blocked = depth


def peak_blocked() -> int:
    with _lock:
        return _peak_blocked


def summary() -> Dict[str, object]:
    """Storm ledger for artifacts; numeric fields double as gauges."""
    with _lock:
        lat = sorted(_place_ms)
        batches = list(_batches)
        out: Dict[str, object] = {
            "unblocked_total": _unblocked_total,
            "placed_total": _placed_total,
            "pending_unblocked": len(_pending),
            "peak_blocked": _peak_blocked,
        }
    out["unblock_to_place_ms_p50"] = _percentile(lat, 0.50)
    out["unblock_to_place_ms_p99"] = _percentile(lat, 0.99)
    out["unblock_to_place_ms_max"] = lat[-1] if lat else None
    out["unblock_batches"] = len(batches)
    out["unblock_batch_size_mean"] = (
        round(sum(batches) / len(batches), 2) if batches else None
    )
    out["unblock_batch_size_max"] = max(batches) if batches else None
    return out


def publish_gauges() -> None:
    """Publish the numeric summary under ``nomad.blocked_evals.*`` (the
    leader stats sweep and flight publisher both drive this)."""
    metric_names.publish_family("nomad.blocked_evals", summary())


def reset() -> None:
    global _peak_blocked, _unblocked_total, _placed_total
    with _lock:
        _pending.clear()
        _place_ms.clear()
        _batches.clear()
        _peak_blocked = 0
        _unblocked_total = 0
        _placed_total = 0
