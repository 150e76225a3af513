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

  * the batched scan is ``kernels.place_scan_batched`` on ``device``
    (``_scan_fn`` there); its fence is a synchronize of the stream the
    launch went on;
  * there are no shapes to compile, so there is no bucket prewarming:
    the kernels are built (``kernels.build_all``) at the first batch;
    ``has_warmed()`` keeps its meaning: at least one batch completed;
  * a failed batch is retried eval by eval on the kernel only, and a
    failure that remains is raised to each waiting ``run()``: nothing
    is placed on the host instead;
  * the bucket-padding copies of a batch have every task group
    pre-failed, so each of their steps is skipped;
  * no device mesh (a later slice) and no chunked tier.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chaos.injector import fire as chaos_fire
from ..utils.lock_witness import witness_lock
from ..utils.race_witness import tracked_dict
from . import kernels
from .convert import DeviceLike, resolve_device, scan_inputs_to_torch
from .engine import EncodedEval, _round_up
from .intscore import E27_ONE as _E27_NEUTRAL

logger = logging.getLogger("nomad_tpu.tpu.batcher")


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


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
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
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
        })
        # Demand-aware gather (guarded-by: _lock): workers announce an
        # encode-in-flight destined for this batcher via expect(); the
        # gather loop keeps its window open while announced encodes are
        # still en route instead of breaking on a fixed idle gap. Armed
        # lazily on the first expect().
        self._expected = 0
        self._demand_aware = False

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
        return out

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

    def _scan(self, static_b, carry_b, xs_b):
        """The batched scan on the batcher's device: the numpy batch is
        copied over, launched, and fenced (a synchronize of the stream
        the launch went on)."""
        import torch

        if self.device.type == "cuda":
            kernels.build_all()
        st, ca, xs = scan_inputs_to_torch(static_b, carry_b, xs_b, self.device)
        _carry, ys = kernels.place_scan_batched(st, ca, xs)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return ys

    def _run_batch(self, batch: List[_Request]) -> None:
        from ..utils import metrics
        from ..utils import phases as _phases

        t_start = metrics.now()
        encs = [r.enc for r in batch]
        # shared bucketed dims; G always gets a padded slot so padded
        # steps have a pre-failed TG to point at
        n_pad = max(_round_up(e.n_real) for e in encs)
        g_pad = _pow2ceil(max(e.g for e in encs) + 1)
        # S stays ZERO when no co-batched eval has spreads; mixed
        # batches widen — same pattern as the affinity axis
        s_raw = max(e.s for e in encs)
        s_pad = _pow2ceil(s_raw) if s_raw else 0
        v_pad = _pow2ceil(max(max(e.v for e in encs), 2))
        # COARSE placement-count buckets (16/64/256/1024, pow2 beyond)
        p_raw = max(e.p for e in encs)
        p_pad = (
            16 if p_raw <= 16 else 64 if p_raw <= 64
            else 256 if p_raw <= 256 else 1024 if p_raw <= 1024
            else _pow2ceil(p_raw)
        )
        d_pad = max(e.static[0].shape[1] for e in encs)
        # absent-feature axes stay ZERO when the whole batch lacks them;
        # mixed batches widen
        k_pad = max(e.xs[1].shape[1] for e in encs)
        aff_raw = max(e.static[4].shape[0] for e in encs)
        aff_pad = g_pad if aff_raw else 0
        evd_raw = max(e.xs[3].shape[1] for e in encs)
        evd_pad = d_pad if evd_raw else 0
        fac_pad = max(e.xs[7].shape[1] for e in encs)
        dpd_pad = max(e.static[17].shape[0] for e in encs)
        dpv_pad = max(e.carry[8].shape[1] for e in encs)
        fnd_pad = max(e.xs[9].shape[1] for e in encs)
        # preemption candidate axis: zero when no co-batched eval preempts
        prec_raw = max(e.static[20].shape[1] for e in encs)
        prec_pad = _pow2ceil(prec_raw) if prec_raw else 0
        pregp_pad = (
            _pow2ceil(max(max(e.carry[11].shape[0] for e in encs), 1))
            if prec_pad else 0
        )
        dtype = encs[0].dtype  # dispatch loop groups by dtype

        with _phases.track("pad_stack"):
            static_b, carry_b, xs_b, b, b_pad = self._pad_and_stack(
                encs, n_pad, g_pad, s_pad, v_pad, p_pad, dtype, d_pad,
                k_pad, aff_pad, evd_pad, fac_pad, dpd_pad, dpv_pad, fnd_pad,
                prec_pad, pregp_pad,
            )

        t_stack = metrics.now()
        metrics.measure_since("nomad.device_batcher.pad_stack", t_start)
        with _phases.track("device"):
            chosen, scores, pulls, skipped, evict = self._scan(
                static_b, carry_b, xs_b)
            t_compute = metrics.now()
            chosen = chosen.cpu().numpy()
            scores = scores.cpu().numpy()
            pulls = pulls.cpu().numpy()
            skipped = skipped.cpu().numpy()
            evict = evict.cpu().numpy()
            t_transfer = metrics.now()
        metrics.measure_since("nomad.device_batcher.dispatch", t_stack)
        metrics.add_sample(
            "nomad.device_batcher.compute", (t_compute - t_stack) * 1000.0
        )
        metrics.add_sample(
            "nomad.device_batcher.transfer",
            (t_transfer - t_compute) * 1000.0,
        )
        d2h_bytes = (
            chosen.nbytes + scores.nbytes + pulls.nbytes + skipped.nbytes
            + evict.nbytes
        )

        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["evals"] += b
            self.stats["padded_evals"] += b_pad - b
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], b)
            self.stats["pad_stack_ms_total"] += (t_stack - t_start) * 1000.0
            self.stats["compute_ms_total"] += (t_compute - t_stack) * 1000.0
            self.stats["transfer_ms_total"] += (t_transfer - t_compute) * 1000.0
            self.stats["d2h_bytes_total"] += d2h_bytes
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
