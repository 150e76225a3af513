"""The ``tpu_binpack`` placement engine of the port.

Host code of ``nomad_tpu/tpu/engine.py`` ``TpuPlacementEngine`` around
the port's kernels. Generic (service/batch) evals: ``encode_eval`` turns
the eval into dense numpy arrays (the encoders of ``encode.py``, the
encode cache with its single-flight claim) in the eval's arm: int32 when
the scheduler is deterministic, float32 otherwise (the server's
default). ``compute_placements`` hands them to the server's
``DeviceBatcher`` (``batcher.py``: one packed copy and one
``kernels.place_scan_batched_packed`` launch for up to ``device_batch``
evals) when the scheduler's planner has one, else ``run_scan_single``
runs them the same way as a batch of one; on ``cuda`` that is the
hand-written CUDA kernel, on ``cpu`` its plain PyTorch version.
``_apply_results`` / ``_apply_results_dense`` turn the chosen nodes into
the Plan, as in the JAX engine.

System evals: ``compute_system_placements`` encodes one forced node per
placement. An eval whose forced nodes are all distinct runs the
scan-free forced-node kernel (K4, ``kernels.forced_eval_packed``); a multi-TG
eval runs the scan. Forced nodes that failed on capacity go through a
second pass with the preemption candidate tables (the scan's ``has_pre``
branch), or back to the scheduler's host per-node loop where the
reference sends them there (float arm, device asks, network asks, a
table gate).

Preemption: when the scheduler configuration enables it for the job's
type, a deterministic eval encodes the candidate tables
(``encode.build_preempt_tables``) and the scan returns each placement's
eviction set in its ``evict`` column; the apply step writes them into
``plan.node_preemptions`` and the allocs' ``preempted_allocations``.
The reference's gates stay as they are and count under
``nomad.tpu_engine.fallback`` (host placement).

The chunked throughput tier (``scheduler_algorithm =
"tpu_binpack_chunked"``): an eval that ``_chunk_eligible`` admits
(float arm, dense, fresh: no preemption tables, evictions, reschedule
penalties or forced nodes, full-height reserved) withdraws its batcher
announcement and runs ``run_chunked``: ``kernels.chunk_scan`` (K5, the
top-K chunk kernel, ``csrc/chunk_scan.cu``) places up to ``chunk_k``
instances of one task group per step, and each task group's FIFO of
picks expands back to per-placement arrays for the same apply path.
With probability ``parity_sample_rate`` the eval is run again through
the exact float scan and the per-TG divergence is tallied
(``parity_sample_stats``). Every other eval takes the exact scan as
under ``tpu_binpack``, counted as ``nomad.tpu_engine.chunk_fallback``.

Unlike the JAX engine, a failed kernel build or launch is not caught:
it raises out of the scheduler's ``process()`` (the server's worker then
nacks the eval back to the broker); nothing is placed on the host
instead. That holds for the chunk kernel and for the sampler's
reference scan too. Only a fault injected at the ``device_dispatch``
chaos point degrades the eval to the host path, as the reference
degrades any dispatch error (engine.py:1516-1526, counter
``nomad.tpu_engine.dispatch_fallback_host``). The engine knows that
fault by its type, ``utils.faults.InjectedFault`` (``ChaosFault``'s
base), and imports nothing of ``chaos/``.
"""
from __future__ import annotations

import contextlib
import logging
import random as _random
import threading
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..structs.network import NetworkIndex
from ..structs.structs import (
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
)
from ..utils.faults import InjectedFault
from ..utils.hostwork import HOST_WORK_SEM as _HOST_WORK_SEM
from ..utils.lock_witness import witness_lock
from . import kernels
from .chunk import chunk_schedule
from .convert import DeviceLike, from_device_packed, resolve_device
from .parity import tg_multiset_divergence

# Partial OCC retries below device_min_placements still ride the device
# when the batcher has already run a batch (see compute_placements) —
# but only above this floor; 1-2 placement stragglers stay on the host.
RETRY_DEVICE_FLOOR = 4
from .encode import (
    DIM_CPU,
    DIM_MBITS,
    DIM_MEM,
    MAX_PENALTY_NODES,
    TGSpec,
    UnsupportedByEngine,
    _distinct_property_arrays,
    build_node_table,
    build_tg_spec,
    job_device_dims,
)

logger = logging.getLogger("nomad_tpu_torch.tpu.engine")

# Deterministic sampler for the chunked tier's parity spot checks
# (engine.py:63-68): tests reseed it to make the sampling decision
# reproducible. The chunked tier only runs on float-mode encodes, so the
# RNG never influences a deterministic-mode plan.
_PARITY_SAMPLE_RNG = _random.Random(0xC47A)


class EncodedEval:
    """One evaluation's placement problem as dense numpy arrays, plus the
    host-side context needed to materialize results into a Plan."""

    __slots__ = (
        "n_real", "n_pad", "g", "s", "v", "p", "dtype",
        "static", "carry", "xs",
        "missing_list", "nodes", "table", "start_ns", "dense_ok", "pre_allocs",
    )

    def __init__(self, *, n_real, n_pad, g, s, v, p, dtype,
                 static, carry, xs, missing_list, nodes, table, start_ns,
                 dense_ok=False, pre_allocs=None):
        self.n_real = n_real
        self.n_pad = n_pad
        self.g = g
        self.s = s
        self.v = v
        self.p = p
        self.dtype = dtype
        self.static = static
        self.carry = carry
        self.xs = xs
        self.missing_list = missing_list
        self.nodes = nodes
        self.table = table
        self.start_ns = start_ns
        # True when every placement qualifies for the dense plan->FSM
        # path (fresh, no networks/devices/canaries): results stay as
        # arrays end to end (structs.DenseTGPlacements)
        self.dense_ok = dense_ok
        # device-side preemption: per-node candidate Allocation lists
        # parallel to the encoded candidate slots, mapping the evict
        # column back to allocs; None when the eval encodes no
        # preemption
        self.pre_allocs = pre_allocs


def _pad_preempt_arrays(pre_tables, n_pad, n_real, node_c2):
    """Pad one eval's PreemptTables (encode.build_preempt_tables) to the
    node grid and derive the Q27 eviction-free factors
    (engine.py:123-167). ``None`` tables give width-0 arrays: the scan's
    preemption branch is skipped (``has_pre`` is a shape test). Returns
    the 6 static entries followed by the 3 carry seeds."""
    if pre_tables is None:
        return (
            np.zeros((n_pad, 0, 4), np.int32), np.zeros((n_pad, 0), np.int32),
            np.zeros((n_pad, 0), bool), np.zeros((n_pad, 0), np.int32),
            np.zeros((n_pad, 0), np.int32), np.zeros((n_pad, 0, 2), np.int32),
            np.zeros((n_pad, 0), bool), np.zeros((0, 3), np.int64),
            np.zeros(0, np.int32),
        )
    from .intscore import E27_ONE, e27_np, xq_np

    c_w = pre_tables.c
    pre_res = np.zeros((n_pad, c_w, 4), np.int32)
    pre_res[:n_real] = pre_tables.res4
    pre_prio = np.zeros((n_pad, c_w), np.int32)
    pre_prio[:n_real] = pre_tables.prio
    pre_elig = np.zeros((n_pad, c_w), bool)
    pre_elig[:n_real] = pre_tables.elig
    pre_mp = np.zeros((n_pad, c_w), np.int32)
    pre_mp[:n_real] = pre_tables.mp
    pre_gid = np.zeros((n_pad, c_w), np.int32)
    pre_gid[:n_real] = pre_tables.gid
    # eviction FREES capacity: Q27 factor e27(+res/cap) per candidate on
    # cpu/mem, the destructive-update ev_factor's convention; padded
    # nodes and empty slots hold the neutral factor
    pre_evf = np.full((n_pad, c_w, 2), E27_ONE, np.int32)
    for d in (0, 1):
        pre_evf[:, :, d] = e27_np(
            xq_np(pre_res[:, :, d].astype(np.int64),
                  np.maximum(node_c2[:, d], 1)[:, None])
        ).astype(np.int32)
    pre_alive0 = np.ones((n_pad, c_w), bool)
    pre_remaining0 = np.zeros((n_pad, 3), np.int64)
    pre_remaining0[:n_real] = pre_tables.remaining3
    pre_counts0 = pre_tables.counts0.astype(np.int32)
    return (pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
            pre_alive0, pre_remaining0, pre_counts0)


def _round_up(n: int, multiple: int = 128) -> int:
    if n <= multiple:
        # small clusters: pad to next power of two
        p = 8
        while p < n:
            p *= 2
        return p
    return ((n + multiple - 1) // multiple) * multiple


class _ResourceAssigner:
    """Host-side port and device-instance assignment for scan-chosen
    placements — the discrete half of the capacity dims the device
    pre-checked. NetworkIndex/DeviceAllocator mirrors are built lazily
    per node: network- and device-free task groups (the C1M-common case)
    never pay the per-node alloc walk."""

    def __init__(self, ctx, nodes) -> None:
        self.ctx = ctx
        self.nodes = nodes
        self._net: Dict[int, NetworkIndex] = {}
        self._dev: Dict[int, object] = {}

    def net_index(self, idx: int) -> NetworkIndex:
        ni = self._net.get(idx)
        if ni is None:
            ni = NetworkIndex(deterministic=self.ctx.deterministic)
            ni.set_node(self.nodes[idx])
            ni.add_allocs(self.ctx.proposed_allocs(self.nodes[idx].id))
            self._net[idx] = ni
        return ni

    def dev_allocator(self, idx: int):
        da = self._dev.get(idx)
        if da is None:
            from ..scheduler.device import DeviceAllocator

            da = DeviceAllocator(self.ctx, self.nodes[idx])
            da.add_allocs(self.ctx.proposed_allocs(self.nodes[idx].id))
            self._dev[idx] = da
        return da

    def build(self, node_idx: int, tg):
        """(task_resources, shared_networks, ok) for placing ``tg`` on the
        node; ok=False on a port/device-instance collision the dense
        capacity model missed (rare — the plan applier would reject it)."""
        task_resources: Dict[str, AllocatedTaskResources] = {}
        shared_networks = []
        ok = True
        if tg.networks:
            ni = self.net_index(node_idx)
            offer, _err = ni.assign_network(tg.networks[0].copy())
            if offer is None:
                ok = False
            else:
                ni.add_reserved(offer)
                shared_networks = [offer]
        for task in tg.tasks:
            tr = AllocatedTaskResources(
                cpu_shares=task.resources.cpu, memory_mb=task.resources.memory_mb
            )
            if task.resources.networks:
                ni = self.net_index(node_idx)
                offer, _err = ni.assign_network(task.resources.networks[0].copy())
                if offer is None:
                    ok = False
                    break
                ni.add_reserved(offer)
                tr.networks = [offer]
            for req in task.resources.devices:
                da = self.dev_allocator(node_idx)
                offer, _aff, _err = da.assign_device(req)
                if offer is None:
                    ok = False
                    break
                da.add_reserved(offer)
                tr.devices.append(offer)
            if not ok:
                break
            task_resources[task.name] = tr
        return task_resources, shared_networks, ok


def _int_spec_gate_reason(table, tg_specs, job):
    """Magnitude gates keeping every int64 intermediate of the integer
    scoring spec exact (intscore.py module doc). None = all clear."""
    from .intscore import MAX_TOTAL_COUNT

    caps = table.totals[:, :2]
    node_c = caps - table.reserved[:, :2]
    if caps.size and (
        caps.max() > (1 << 24)
        or node_c.min() < 1
        or (table.reserved[:, :2] > 2 * node_c).any()
    ):
        return "int-spec cpu/mem magnitude gate"
    if table.totals.size and table.totals.max() > (1 << 28):
        return "int-spec capacity magnitude gate"
    if sum(g.count for g in job.task_groups) > MAX_TOTAL_COUNT:
        return "int-spec job count gate"
    if any(spec.ask.max(initial=0) > (1 << 28) for spec in tg_specs.values()):
        return "int-spec ask magnitude gate"
    return None


def _release_enc_claim(claim_cell: Dict[str, object]) -> None:
    """Release an owned single-flight encode claim: drop the claim Event
    from the enc_cache (if it is still the parked entry) and wake every
    waiter so one of them can re-claim. Idempotent — the success path
    pops "ev" when it publishes, making later calls no-ops."""
    ev = claim_cell.pop("ev", None)
    if ev is None:
        return
    cache = claim_cell.pop("cache", None)
    key = claim_cell.pop("key", None)
    if cache is not None and cache.get(key) is ev:
        cache.pop(key, None)
    ev.set()


def _evicted_allocs(enc, evict, pi: int, node_idx: int) -> List:
    """The allocs placement ``pi`` preempts, in final eviction order: the
    evict column holds each evicted slot's second-pass rank (-1 for the
    others), ascending rank being the order the host Preemptor reports.
    Empty when the eval encodes no preemption."""
    if (enc is None or enc.pre_allocs is None or evict is None
            or evict.ndim != 2 or not evict.shape[1]):
        return []
    row = evict[pi]
    ks = sorted((c for c in range(row.shape[0]) if int(row[c]) >= 0),
                key=lambda c: int(row[c]))
    cand = enc.pre_allocs[node_idx]
    return [cand[c] for c in ks]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class TorchPlacementEngine:
    """Placement engine on one torch device (CUDA unless asked for the
    CPU). ``shared(device)`` keeps one engine per device."""

    _shared: Dict[str, "TorchPlacementEngine"] = {}
    _shared_lock = threading.Lock()

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        # each calling thread's own CUDA stream for the copies and launches
        # it makes itself (never queued behind the batcher's scans)
        self._streams = threading.local()
        # the chunked tier's sampled-parity tally (engine.py:1155-1166)
        self._parity_lock = witness_lock("engine.TorchPlacementEngine._parity_lock")
        self._parity_samples = {  # guarded-by: _parity_lock
            "evals_sampled": 0,
            "placements_checked": 0,
            "placements_diverged": 0,
        }

    @classmethod
    def shared(cls, device: DeviceLike = "cuda") -> "TorchPlacementEngine":
        dev = resolve_device(device)
        key = str(dev)
        with cls._shared_lock:
            eng = cls._shared.get(key)
            if eng is None:
                eng = cls._shared[key] = cls(dev)
        return eng

    def compute_placements(self, sched, destructive: List, place: List):
        """Run the eval's whole placement list through the placement scan.

        Returns True when handled, NotImplemented when the eval is too
        small for the device or the encode takes one of the reference's
        unsupported-feature gates (the host iterator stack places the
        eval). When the
        scheduler's planner carries a ``device_batcher`` (the server's
        workers do), the encoded eval is submitted there so concurrent
        evals share ONE batched launch; otherwise it runs as a
        single-eval scan. Errors of the kernel's build or launch
        propagate (engine.py:1420-1556 without its host fallback)."""
        from ..utils import metrics as _metrics

        # Small evals don't amortize a device dispatch: the host stack
        # places them like the reference's per-placement iterators.
        # Threshold 0 = always use the device; the server sets it.
        n_min = getattr(sched, "device_min_placements", 0)
        if n_min and len(destructive) + len(place) < n_min:
            # A partial OCC retry (the tail of a plan-rejected eval) rides
            # the device when the batcher has completed a batch and the
            # retry isn't trivially small.
            batcher = getattr(sched.planner, "device_batcher", None)
            total = len(destructive) + len(place)
            if (
                batcher is None
                or total < RETRY_DEVICE_FLOOR
                or not batcher.has_warmed()
            ):
                _metrics.incr_counter("nomad.tpu_engine.small_eval_host")
                return NotImplemented
            _metrics.incr_counter("nomad.tpu_engine.small_eval_device_retry")

        from ..trace import lifecycle as _tlc
        from ..utils import phases as _phases

        wave_id = sched.eval.id
        batcher = getattr(sched.planner, "device_batcher", None)
        # Demand announcement: tell the batcher an encode destined for it
        # is in flight BEFORE the encode starts, so the gather window
        # stays open for this eval's cohort. Balanced in the finally / by
        # run(expected=True) on every path out of this function.
        expected_held = False
        if batcher is not None:
            batcher.expect()
            expected_held = True
        try:
            t0 = _metrics.now()
            with _HOST_WORK_SEM:
                t1 = _metrics.now()
                with _phases.track("encode"), _tlc.pipeline_stage("encode", wave_id):
                    enc = self.encode_eval(sched, destructive, place)
                _metrics.measure_since("nomad.tpu_engine.encode_work", t1)
            _metrics.measure_since("nomad.tpu_engine.encode", t0)
            if enc is NotImplemented:
                return NotImplemented
            if enc is True:
                return True
            self._pipeline_remember(sched, enc)
            t0 = _metrics.now()
            # tpu_binpack_chunked: chunk-eligible evals take the top-K
            # throughput scan; everything else (preempting, destructive,
            # int-mode, penalized) takes the exact scan below as under
            # tpu_binpack (engine.py:1487-1535)
            use_chunked = False
            if getattr(sched, "chunked_tier", False):
                chunk_reason = self._chunk_eligible(enc)
                use_chunked = chunk_reason is None
                if not use_chunked:
                    _metrics.incr_counter("nomad.tpu_engine.chunk_fallback")
                    logger.debug("chunked tier ineligible (%s): %s",
                                 wave_id[:8], chunk_reason)
            if use_chunked and expected_held:
                # withdraw BEFORE the chunked scan: a phantom expectation
                # would hold concurrent gathers open for it
                batcher.cancel_expected()
                expected_held = False
            try:
                with _phases.track("device_wait"), \
                        _tlc.pipeline_stage("dispatch", wave_id):
                    if use_chunked:
                        chosen, scores, pulls, skipped_steps, evict = self.run_chunked(
                            enc, chunk_k=int(getattr(sched, "chunk_k", 128)))
                    elif batcher is not None:
                        expected_held = False  # run() consumes the token
                        chosen, scores, pulls, skipped_steps, evict = batcher.run(
                            enc, expected=True)
                    else:
                        chosen, scores, pulls, skipped_steps, evict = (
                            self.run_scan_single(enc))
            except InjectedFault:
                # an injected dispatch fault: the host iterator stack
                # places the eval, as the reference does for any dispatch
                # error (engine.py:1516-1526)
                logger.warning("device dispatch failed for %s; host fallback",
                               wave_id[:8], exc_info=True)
                _metrics.incr_counter("nomad.tpu_engine.dispatch_fallback_host")
                self._pipeline_forget(sched)
                return NotImplemented
            except BaseException:
                # the launch failed: the error reaches the worker, which
                # nacks the eval; the remembered encode must not strand
                self._pipeline_forget(sched)
                raise
        finally:
            if expected_held:
                batcher.cancel_expected()
        _metrics.measure_since("nomad.tpu_engine.device_wait", t0)
        if use_chunked:
            _metrics.incr_counter("nomad.tpu_engine.chunk_dispatch")
            self._maybe_sample_parity(
                enc, chosen, float(getattr(sched, "parity_sample_rate", 0.0)))
        t0 = _metrics.now()
        with _HOST_WORK_SEM:
            t1 = _metrics.now()
            with _phases.track("apply"):
                chosen = np.asarray(chosen)
                skipped_steps = np.asarray(skipped_steps)
                evict = np.asarray(evict)
                if enc.dense_ok and (chosen >= 0).all() and not skipped_steps.any():
                    # every placement succeeded and qualifies: results stay
                    # dense (no per-alloc objects) all the way to the FSM
                    self._apply_results_dense(sched, enc, chosen, scores, pulls,
                                              evict)
                else:
                    self._apply_results(
                        sched, enc.missing_list, enc.nodes, chosen, scores,
                        pulls, skipped_steps, enc.start_ns, enc=enc, evict=evict,
                    )
            _metrics.measure_since("nomad.tpu_engine.apply_work", t1)
        _metrics.measure_since("nomad.tpu_engine.apply", t0)
        return True

    def run_scan_single(self, enc: "EncodedEval"):
        """Run one encoded eval through the placement scan on the
        engine's device, as a batch of one: the encode goes over as ONE
        packed buffer (``kernels.pack_scan_inputs``), the kernel reads it
        through offsets (``kernels.place_scan_batched_packed``) and the
        outputs come back with one copy, on the calling thread's own
        stream. Returns numpy (chosen, scores, pulls, skipped, evict)."""
        from ..utils import phases as _phases

        with self._thread_stream():
            packed = kernels.pack_scan_inputs(enc.static, enc.carry, enc.xs, self.device)
            with _phases.track("device"):
                out, out_layout = kernels.place_scan_batched_packed(packed)
                ys = from_device_packed(out, out_layout)
        return tuple(y[0] for y in ys)

    # -- chunked throughput tier ---------------------------------------

    @staticmethod
    def _chunk_eligible(enc: "EncodedEval") -> Optional[str]:
        """None when the encode may run on the chunked top-K tier; else
        the reason it must take the exact scan (engine.py:1253-1274). The
        chunk step models fresh, non-destructive, float-mode placements
        only; in particular it has no eviction scoring, so preempting
        evals are gated here and again at dispatch
        (``batcher.assert_chunk_gate``)."""
        if np.dtype(enc.dtype).kind != "f":
            return "int mode"
        if not enc.dense_ok:
            return "not dense"
        if enc.pre_allocs is not None:
            return "preemption tables"
        if enc.static[1].shape[0] != enc.n_pad:
            return "folded reserved"
        if enc.xs[1].shape[1] > 0 and bool((np.asarray(enc.xs[1]) >= 0).any()):
            return "reschedule penalties"
        if bool((np.asarray(enc.xs[2]) >= 0).any()):
            return "eviction axis"
        if enc.xs[9].ndim == 2 and enc.xs[9].shape[1] > 0:
            return "forced nodes"
        return None

    def run_chunked(self, enc: "EncodedEval", chunk_k: int = 128,
                    retry_rounds: int = 2):
        """Run one chunk-eligible eval through the top-K chunk scan
        (``kernels.chunk_scan``: on ``cuda`` the K5 kernel) and expand
        the per-chunk outputs back to per-placement arrays of the exact
        scan's result shape (chosen, scores, pulls, skipped, evict), so
        both tiers share the apply path (engine.py:1283-1356).

        The encode's static and carry arrays, the step arrays and the
        deficit go to the device as ONE packed buffer
        (``kernels.pack_chunk_inputs``: one copy from pinned host memory),
        the kernel reads them through their offsets
        (``kernels.chunk_scan_packed``: no tensor per array, so no GIL
        hand-off per array among the server's worker threads), and the
        outputs come back with one copy, all on the calling thread's own
        stream: every tensor of the launch is made, used and released in
        that stream's order, and the stream is synchronized before the
        host reads the outputs.

        Placements of one task group are interchangeable here (the gate
        rejects every per-row feature), so each TG's rows fill in order
        from its chunks' valid picks; rows left unfilled after the retry
        rounds come back as chosen = -1 (failed placements, never
        silently dropped)."""
        from ..utils import phases as _phases
        from .batcher import assert_chunk_gate

        assert_chunk_gate(enc)
        tg_idx_p = np.asarray(enc.xs[0])[: enc.p]
        # each task group's count, in order of first appearance
        tgs, first, n_of = np.unique(tg_idx_p, return_index=True, return_counts=True)
        order = np.argsort(first)
        counts_by_tg = [(int(g), int(n)) for g, n in zip(tgs[order], n_of[order])]
        chunk = int(max(1, min(chunk_k, enc.n_pad)))
        steps_tg, want = chunk_schedule(counts_by_tg, chunk, retry_rounds=retry_rounds)
        deficit = np.zeros(enc.static[2].shape[0], np.int32)
        with self._thread_stream():
            packed = kernels.pack_chunk_inputs(enc.n_pad, enc.static, enc.carry,
                                               (steps_tg, want), deficit, chunk, self.device)
            with _phases.track("device"):
                out, out_layout = kernels.chunk_scan_packed(packed)
                top_idx, top_scores, valid, _placed = from_device_packed(out, out_layout)

        # per-TG FIFO of the picked (node, score) pairs, chunk order: the
        # valid slots in (step, slot) order
        si, ki = np.nonzero(valid)
        tg_of, nodes_all, scores_all = steps_tg[si], top_idx[si, ki], top_scores[si, ki]
        p = enc.p
        chosen = np.full(p, -1, np.int32)
        scores = np.zeros(p, np.float32)
        for gi, _count in counts_by_tg:
            mine = tg_of == gi
            nodes_q, scores_q = nodes_all[mine], scores_all[mine]
            rows = np.nonzero(tg_idx_p == gi)[0]
            take = min(rows.size, nodes_q.size)
            chosen[rows[:take]] = nodes_q[:take]
            scores[rows[:take]] = scores_q[:take]
        # every chunk scores the full real node axis
        pulls = np.full(p, int(enc.n_real), np.int32)
        skipped = np.zeros(p, bool)
        evict = np.zeros((p, 0), np.int32)
        return chosen, scores, pulls, skipped, evict

    def _thread_stream(self):
        """A context that makes the calling thread's own stream current
        (created at its first launch there); a no-op on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(stream)

    def _maybe_sample_parity(self, enc: "EncodedEval", chosen, rate: float) -> None:
        """Sampled-parity spot check of the chunked tier
        (engine.py:1358-1394): with probability ``rate`` run the eval
        again through the exact float scan and tally the per-TG
        multiset divergence of the chosen nodes. Unlike the JAX engine,
        a failure of the reference scan raises (a caught launch failure
        would hide the kernel)."""
        from ..utils import metrics as _metrics

        if rate <= 0.0 or _PARITY_SAMPLE_RNG.random() >= rate:
            return
        ref_chosen = np.asarray(self.run_scan_single(enc)[0])[: enc.p]
        tg_idx = np.asarray(enc.xs[0])[: enc.p]
        diverged = tg_multiset_divergence(np.asarray(chosen)[: enc.p], ref_chosen, tg_idx)
        with self._parity_lock:
            self._parity_samples["evals_sampled"] += 1
            self._parity_samples["placements_checked"] += int(enc.p)
            self._parity_samples["placements_diverged"] += int(diverged)
        _metrics.incr_counter("nomad.tpu_engine.parity_sampled")
        if diverged:
            _metrics.incr_counter("nomad.tpu_engine.parity_diverged", float(diverged))

    def parity_sample_stats(self) -> Dict[str, float]:
        """Snapshot of the chunked tier's sampled-parity tally, with the
        derived divergence rate (engine.py:1396-1405)."""
        with self._parity_lock:
            out = dict(self._parity_samples)
        checked = out["placements_checked"]
        out["divergence_rate"] = out["placements_diverged"] / checked if checked else 0.0
        return out

    def reset_parity_samples(self) -> None:
        with self._parity_lock:
            for k in self._parity_samples:
                self._parity_samples[k] = 0

    def run_forced(self, enc: "EncodedEval"):
        """Run one all-distinct forced-node eval through the scan-free
        kernel (K4; engine.py:1209-1250): the 16 arrays it reads go over
        as ONE packed buffer (``kernels.pack_forced_inputs``), one launch
        (``kernels.forced_eval_packed``) takes the eval's P placements as
        they are (no bucket pad), and chosen and scores come back with one
        copy, on the calling thread's own stream. The scan's other outputs
        are constant for this shape (pulls 0, nothing skipped, no
        evictions) and are made here. Returns numpy (chosen, scores,
        pulls, skipped, evict)."""
        from ..utils import phases as _phases

        with self._thread_stream():
            packed = kernels.pack_forced_inputs(enc, self.device)
            with _phases.track("device"):
                out, out_layout = kernels.forced_eval_packed(packed)
                chosen, scores = from_device_packed(out, out_layout)
        p = chosen.shape[0]
        return (chosen, scores, np.zeros(p, np.int32), np.zeros(p, bool),
                np.zeros((p, 0), np.int32))

    @staticmethod
    def _pipeline_remember(sched, enc: "EncodedEval") -> None:
        """Hand this wave's encode to the pipeline's re-dispatch registry
        (pipeline/redispatch.py) before the device dispatch: on a partial
        OCC commit, the async applier re-enters the device stage from the
        remembered encode instead of re-running snapshot/encode. No-op
        outside the pipelined server."""
        pipe = getattr(sched.planner, "pipeline", None)
        if pipe is None:
            return
        try:
            pipe.remember_wave(
                sched.eval.id, enc, sched.job,
                getattr(sched.ctx.state, "node_epoch", -1),
            )
        except Exception:  # noqa: BLE001 — observability hook, never fatal
            logger.debug("pipeline remember_wave failed", exc_info=True)

    @staticmethod
    def _pipeline_forget(sched) -> None:
        """Drop a remembered encode when the wave's launch failed — the
        registry entry would otherwise strand until the eval acks."""
        pipe = getattr(sched.planner, "pipeline", None)
        if pipe is None:
            return
        try:
            pipe.registry.forget(sched.eval.id)
        except Exception:  # noqa: BLE001
            logger.debug("pipeline forget failed", exc_info=True)

    def encode_eval(self, sched, destructive: List, place: List):
        """Encode one eval's placement problem into dense numpy arrays.

        Returns an EncodedEval, True (nothing to place) or NotImplemented
        (a feature the reference's engine does not encode either — host
        placement).

        try/finally wrapper: the impl may claim a single-flight encode
        slot (an Event parked in the fleet's enc_cache). Success and the
        UnsupportedByEngine fallbacks release it themselves, but an
        UNEXPECTED exception must too — an abandoned claim stalls every
        same-key eval for the full 10s waiter grace period, each holding
        a HOST_WORK_SEM slot while it waits."""
        claim_cell: Dict[str, object] = {}
        try:
            return self._encode_eval_impl(sched, destructive, place, claim_cell)
        finally:
            # no-op when the claim was already published or released
            _release_enc_claim(claim_cell)

    def _encode_eval_impl(self, sched, destructive: List, place: List,
                          claim_cell: Dict[str, object]):
        job = sched.job
        ctx = sched.ctx
        nodes = list(sched.stack.source.nodes)  # order set by stack.set_nodes
        n_real = len(nodes)

        missing_list = list(destructive) + list(place)
        if not missing_list:
            return True

        from ..utils import metrics as _metrics

        def fallback(reason: str):
            logger.debug("tpu engine fallback: %s", reason)
            _metrics.incr_counter("nomad.tpu_engine.fallback")
            _release_enc_claim(claim_cell)
            return NotImplemented

        # Sticky-disk preferred nodes use a different two-phase select; punt.
        # Simultaneously decide dense-path eligibility: every placement
        # fresh (no previous alloc), no canaries, and its TG free of
        # network/device asks — then results stay as arrays through plan
        # submit -> plan apply -> FSM (structs.DenseTGPlacements).
        dense_ok = not sched.eval.annotate_plan
        _dense_tg_cache: Dict[str, bool] = {}
        for missing in missing_list:
            prev = missing.get_previous_allocation()
            tg = missing.get_task_group()
            if prev is not None and tg.ephemeral_disk.sticky:
                return fallback("sticky ephemeral disk")
            if dense_ok:
                if prev is not None or missing.is_canary():
                    dense_ok = False
                    continue
                tg_ok = _dense_tg_cache.get(tg.name)
                if tg_ok is None:
                    tg_ok = not tg.networks and not any(
                        t.resources.networks or t.resources.devices
                        for t in tg.tasks
                    )
                    _dense_tg_cache[tg.name] = tg_ok
                dense_ok = tg_ok

        # Build TG specs (may refuse). The per-node NetworkIndex cache is
        # shared across this eval's TGs (port-feasibility masks); the
        # fleet-static cache (encode.fleet_static) shares totals/index/
        # class-group arrays across every eval between node writes.
        from .encode import fleet_static, job_sched_signature

        fleet = fleet_static(ctx, job, nodes)

        # Device-side preemption (tpu/preempt.py): does this eval's host
        # oracle preempt? The SAME switch the host stack consults
        # (generic_sched.get_select_options), so the two paths never
        # disagree on whether the eval may evict.
        from ..scheduler.preemption import preemption_enabled

        _, _sched_cfg = ctx.state.scheduler_config()
        preempt_on = preemption_enabled(_sched_cfg, job.type)

        # Whole-eval encode cache: a burst of same-shaped fresh jobs (the
        # C1M workload) re-derives identical arrays per eval. When every
        # per-eval input is provably default — all placements fresh
        # (dense_ok), empty plan, clean shared spread/limit state, no
        # existing allocs of this job — the encoded arrays depend only on
        # (job content, fleet, usage state); reuse them wholesale,
        # swapping the per-eval ring offset and host context.
        enc_cache = None
        cache_key = None
        cur_epoch = -1
        if fleet is not None and dense_ok and not destructive and not preempt_on:
            plan = ctx.plan
            spread_state = sched.stack.spread
            if (
                not plan.node_allocation and not plan.node_update
                and not plan.node_preemptions
                and not spread_state.tg_spread_info
                and float(spread_state.sum_spread_weights) == 0.0
                and not ctx.state.job_has_live_allocs(job.id)
            ):
                enc_cache = fleet.setdefault("enc_cache", {})
                # Entries store (epoch, enc); a stale-epoch hit is PATCHED
                # (encode.epoch_usage_arrays) in place of a full re-encode.
                cache_key = (
                    job_sched_signature(job),
                    len(missing_list),
                    tuple(m.get_task_group().name for m in missing_list),
                )
                cur_epoch = getattr(ctx.state, "usage_epoch", -1)
                # SINGLE-FLIGHT: the first encoder of a key claims it with
                # an Event and builds; the rest wait for its arrays.
                while True:
                    hit = enc_cache.get(cache_key)
                    if hit is None:
                        claim = threading.Event()
                        cur = enc_cache.setdefault(cache_key, claim)
                        if cur is claim:
                            claim_cell["ev"] = claim
                            claim_cell["cache"] = enc_cache
                            claim_cell["key"] = cache_key
                            break  # we build and publish
                        hit = cur
                    if isinstance(hit, threading.Event):
                        _metrics.incr_counter(
                            "nomad.tpu_engine.encode_cache_wait")
                        if not hit.wait(timeout=10.0):
                            # owner wedged or died mid-encode: clear the
                            # stuck claim so the key heals, build our own
                            if enc_cache.get(cache_key) is hit:
                                enc_cache.pop(cache_key, None)
                            hit.set()
                            break
                        continue  # re-read the published entry
                    hit_epoch, hit = hit
                    num_dims = hit.static[0].shape[1]
                    if hit_epoch != cur_epoch:
                        if num_dims != 4:
                            # device-dim jobs carry usage on job-shaped
                            # dims; no shared patch — full re-encode
                            break
                        from .encode import epoch_usage_arrays

                        used0, e_base0 = epoch_usage_arrays(
                            ctx, fleet, hit.n_pad,
                            hit.dtype == np.int32, hit.dtype,
                        )
                        carry = list(hit.carry)
                        carry[0] = used0
                        carry[7] = e_base0
                        hit = EncodedEval(
                            n_real=hit.n_real, n_pad=hit.n_pad, g=hit.g,
                            s=hit.s, v=hit.v, p=hit.p, dtype=hit.dtype,
                            static=hit.static, carry=tuple(carry),
                            xs=hit.xs, missing_list=hit.missing_list,
                            nodes=hit.nodes, table=hit.table,
                            start_ns=hit.start_ns, dense_ok=True,
                        )
                        # re-publish at the current epoch
                        enc_cache[cache_key] = (cur_epoch, hit)
                        _metrics.incr_counter(
                            "nomad.tpu_engine.encode_cache_patch")
                    else:
                        _metrics.incr_counter(
                            "nomad.tpu_engine.encode_cache_hit")
                    _metrics.incr_counter("nomad.tpu_engine.handled")
                    offset0 = (
                        int(getattr(sched.stack.source, "offset", 0))
                        % max(n_real, 1)
                    )
                    carry = list(hit.carry)
                    carry[5] = np.int32(offset0)
                    return EncodedEval(
                        n_real=hit.n_real, n_pad=hit.n_pad, g=hit.g,
                        s=hit.s, v=hit.v, p=hit.p, dtype=hit.dtype,
                        static=hit.static, carry=tuple(carry), xs=hit.xs,
                        missing_list=missing_list, nodes=nodes,
                        table=hit.table, start_ns=_time.monotonic_ns(),
                        dense_ok=True,
                    )

        # The capacity model tracks one aggregate bandwidth dimension; the
        # host checks per NIC. Gate multi-NIC nodes to keep parity.
        for node in nodes:
            if len({net.device for net in node.node_resources.networks if net.device}) > 1:
                return fallback("multi-NIC node")
        tg_specs: Dict[str, TGSpec] = {}
        port_cache: Dict[str, object] = {}
        try:
            for missing in missing_list:
                tg = missing.get_task_group()
                if tg.name not in tg_specs:
                    tg_specs[tg.name] = build_tg_spec(
                        ctx, job, tg, nodes, sched.batch, port_cache,
                        fleet=fleet,
                    )
            table = build_node_table(ctx, job, nodes, fleet=fleet)
        except UnsupportedByEngine as e:
            return fallback(str(e))
        device_dims = job_device_dims(job)  # validated above; never raises here
        num_dims = table.totals.shape[1]    # 4 + the job's device dims
        start = _time.monotonic_ns()

        # Deterministic (parity) mode: the exact INTEGER spec of
        # intscore.py — int32 arrays, int64 score60 selection, bit-exact
        # on every backend. Non-deterministic: float32 throughput mode.
        int_mode = bool(ctx.deterministic)
        fdtype = np.int32 if int_mode else np.float32
        if int_mode:
            reason = _int_spec_gate_reason(table, tg_specs, job)
            if reason is not None:
                return fallback(reason)

        pre_tables = None
        if preempt_on:
            # a preempting host oracle may evict on ANY node, so encoding
            # this eval without the candidate tables would diverge from
            # it: every gate below sends the WHOLE eval to the host stack
            if not int_mode:
                return fallback("preemption requires deterministic int mode")
            if destructive:
                return fallback("preemption with destructive updates")
            if device_dims:
                # the host oracle runs preempt_for_device (float scoring,
                # instance-level assignment state): host only
                return fallback("preemption with device asks")
            if any(
                tg.networks or any(t.resources.networks for t in tg.tasks)
                for tg in (m.get_task_group() for m in missing_list)
            ):
                # the host oracle runs preempt_for_network first: host only
                return fallback("preemption with network asks")
            from .encode import build_preempt_tables

            pre_tables, reason = build_preempt_tables(ctx, job, nodes)
            if reason is not None:
                return fallback(reason)
        _metrics.incr_counter("nomad.tpu_engine.handled")

        n_pad = _round_up(max(n_real, 1))
        g_count = len(job.task_groups)
        specs_by_gi = {spec.index: spec for spec in tg_specs.values()}
        s_max = max((spec.spread_vids.shape[0] for spec in tg_specs.values()), default=0)
        v_max = max((spec.spread_desired.shape[1] for spec in tg_specs.values()), default=1)

        totals = np.zeros((n_pad, num_dims), fdtype)
        totals[:n_real] = table.totals
        reserved = np.zeros((n_pad, num_dims), fdtype)
        reserved[:n_real] = table.reserved
        used0 = np.zeros((n_pad, num_dims), fdtype)
        used0[:n_real] = table.used

        # Q27 incremental exponentials (int mode): e_base0 per node from
        # the encode-time chain; e_ask static ask factors per TG
        from .intscore import E27_ONE, e27_np, e27_py, pack_feat_planes, xq_np, xq_py

        node_c2 = (totals[:, :2] - reserved[:, :2]).astype(np.int64)  # [N,2]
        if int_mode:
            free0 = node_c2 - used0[:, :2] - reserved[:, :2]
            e_base0 = e27_np(xq_np(free0, node_c2)).astype(np.int32)
        else:
            e_base0 = np.zeros((0, 2), np.int32)
        tg_counts0 = np.zeros((g_count, n_pad), np.int32)
        tg_counts0[:, :n_real] = table.tg_counts
        job_counts0 = np.zeros(n_pad, np.int32)
        job_counts0[:n_real] = table.job_counts

        asks = np.zeros((g_count, num_dims), fdtype)
        feas = np.zeros((g_count, n_pad), bool)
        aff_score = np.zeros((g_count, n_pad), fdtype)
        aff_present = np.zeros((g_count, n_pad), bool)
        desired_counts = np.ones(g_count, np.int32)
        dh_job = np.zeros(g_count, bool)
        dh_tg = np.zeros(g_count, bool)
        limits = np.full(g_count, 2, np.int32)
        sv = s_max  # 0 when no TG has spreads: the [S,V,N] work vanishes
        vv = max(v_max, 2)
        spread_vids = np.full((g_count, sv, n_pad), vv - 1, np.int32)
        spread_desired = np.full((g_count, sv, vv), -1.0, fdtype)
        spread_weights = np.zeros((g_count, sv), fdtype)
        spread_has_targets = np.zeros((g_count, sv), bool)
        spread_active = np.zeros((g_count, sv), bool)
        sum_spread_weights = np.zeros(g_count, fdtype)
        spread_counts0 = np.zeros((g_count, sv, vv), fdtype)
        spread_entry0 = np.zeros((g_count, sv, vv), bool)
        if int_mode:
            e_ask = np.full((g_count, n_pad, 2), E27_ONE, np.int32)
        else:
            e_ask = np.zeros((0, 0, 2), np.int32)

        # e_ask rows depend only on (fleet capacities, the TG's cpu/mem
        # ask): cache them on the fleet entry
        e_ask_cache = None if fleet is None else fleet.setdefault("e_ask", {})
        for gi, spec in specs_by_gi.items():
            asks[gi] = spec.ask
            if int_mode:
                key = (n_pad, int(spec.ask[0]), int(spec.ask[1]))
                row = None if e_ask_cache is None else e_ask_cache.get(key)
                if row is None:
                    row = np.empty((n_pad, 2), np.int32)
                    for d in (0, 1):
                        row[:, d] = e27_np(
                            xq_np(np.full(n_pad, -int(spec.ask[d]), np.int64),
                                  node_c2[:, d])
                        ).astype(np.int32)
                    if e_ask_cache is not None and len(e_ask_cache) < 64:
                        e_ask_cache[key] = row
                e_ask[gi] = row
            feas[gi, :n_real] = spec.feasible
            aff_score[gi, :n_real] = spec.affinity_score
            aff_present[gi, :n_real] = spec.affinity_present
            desired_counts[gi] = max(spec.desired_count, 1)
            dh_job[gi] = spec.distinct_hosts_job
            dh_tg[gi] = spec.distinct_hosts_tg
            limits[gi] = min(spec.limit, 2**31 - 1)
            s = spec.spread_vids.shape[0]
            if s:
                v_spec = spec.spread_desired.shape[1]
                # remap this spec's invalid bucket onto the shared one (vv-1)
                spread_vids[gi, :s, :n_real] = np.where(
                    spec.spread_vids >= v_spec - 1, vv - 1, spec.spread_vids
                )
                spread_desired[gi, :s, :v_spec] = spec.spread_desired[:, :v_spec]
                spread_weights[gi, :s] = spec.spread_weights
                spread_has_targets[gi, :s] = spec.spread_has_targets
                spread_active[gi, :s] = True
                sum_spread_weights[gi] = spec.sum_spread_weights
                spread_counts0[gi, :s, : spec.spread_counts0.shape[1]] = spec.spread_counts0
                spread_entry0[gi, :s] = spread_counts0[gi, :s] > 0

        # per-placement inputs
        p = len(missing_list)
        tg_idx = np.zeros(p, np.int32)
        penalty_idx = np.full((p, MAX_PENALTY_NODES), -1, np.int32)
        evict_node = np.full(p, -1, np.int32)
        evict_res = np.zeros((p, num_dims), fdtype)
        evict_tg = np.full(p, -1, np.int32)
        limit_p = np.zeros(p, np.int32)
        sum_sw_p = np.zeros(p, fdtype)
        e27one = E27_ONE if int_mode else 1
        ev_factor = np.full((p, 2), e27one, np.int32)
        rev_factor = np.full((p, 2), e27one, np.int32)

        # Sticky limit widening + cross-TG spread-weight accumulation,
        # replicating the shared SpreadIterator/LimitIterator state in the
        # host stack (which inplace-update selects may have pre-seeded).
        widened = False
        running_sw = float(sched.stack.spread.sum_spread_weights)
        visited_tgs = set(sched.stack.spread.tg_spread_info.keys())

        tg_name_to_gi = {g.name: i for i, g in enumerate(job.task_groups)}
        for pi, missing in enumerate(missing_list):
            tg = missing.get_task_group()
            gi = tg_name_to_gi[tg.name]
            tg_idx[pi] = gi
            spec = specs_by_gi[gi]
            if tg.name not in visited_tgs:
                visited_tgs.add(tg.name)
                running_sw += float(spec.sum_spread_weights)
            if spec.widens:
                widened = True
            limit_p[pi] = 2**31 - 1 if widened else spec.limit
            sum_sw_p[pi] = running_sw
            prev = missing.get_previous_allocation()
            if prev is not None:
                from ..structs.structs import ALLOC_CLIENT_FAILED

                pens: Dict[str, None] = {}  # ordered de-dup (host uses a set)
                if prev.client_status == ALLOC_CLIENT_FAILED:
                    pens[prev.node_id] = None
                if prev.reschedule_tracker is not None:
                    for ev in prev.reschedule_tracker.events:
                        pens[ev.prev_node_id] = None
                for k, node_id in enumerate(list(pens)[:MAX_PENALTY_NODES]):
                    idx = table.node_index.get(node_id, -1)
                    penalty_idx[pi, k] = idx
            stop_prev, _ = missing.stop_previous_alloc()
            if stop_prev and prev is not None:
                idx = table.node_index.get(prev.node_id, -1)
                if idx >= 0:
                    evict_node[pi] = idx
                    cr = prev.comparable_resources()
                    evict_res[pi, DIM_CPU] = cr.flattened.cpu_shares
                    evict_res[pi, DIM_MEM] = cr.flattened.memory_mb
                    evict_res[pi, 2] = cr.shared.disk_mb
                    mb = 0
                    if prev.allocated_resources is not None:
                        for net in prev.allocated_resources.shared.networks:
                            mb += net.mbits
                        for tr in prev.allocated_resources.tasks.values():
                            for net in tr.networks:
                                mb += net.mbits
                        # devices the eviction frees, on the job's dims
                        if device_dims:
                            for tr in prev.allocated_resources.tasks.values():
                                for dev in tr.devices:
                                    for ask_id, dim in device_dims.items():
                                        if dev.id().matches(ask_id):
                                            evict_res[pi, dim] += len(dev.device_ids)
                                            break
                    evict_res[pi, DIM_MBITS] = mb
                    if prev.job_id == job.id:
                        evict_tg[pi] = tg_name_to_gi.get(prev.task_group, -1)
                    if int_mode:
                        # eviction/revert Q27 factors (evicted node known
                        # at encode time; spec: e27(±evict_res/cap))
                        for d in (0, 1):
                            er = int(evict_res[pi, d])
                            nc = int(node_c2[idx, d])
                            ev_factor[pi, d] = e27_py(xq_py(er, nc))
                            rev_factor[pi, d] = e27_py(xq_py(-er, nc))

        # shape specialization: absent features collapse to zero axes, so
        # the kernel and its plain version skip their work
        if not aff_present.any():
            aff_score = aff_score[:0]
            aff_present = aff_present[:0]
        # pack feasibility + affinity presence into ONE uint8 plane
        feat_packed = pack_feat_planes(feas, aff_present)
        if (penalty_idx == -1).all():
            penalty_idx = penalty_idx[:, :0]
        if (evict_node == -1).all():
            # no destructive updates: no eviction/revert work
            evict_res = evict_res[:, :0]
            ev_factor = ev_factor[:, :0]
            rev_factor = rev_factor[:, :0]
        if int_mode:
            # fold reserved into totals: the E factors above were computed
            # from the split, and the fits check is identical on the
            # netted capacities
            totals = totals - reserved
            reserved = np.zeros((0, num_dims), fdtype)

        # distinct_property encoding (zero-D when absent). Pad the node
        # axis: padded nodes keep the MISSING bucket (v-1) and are
        # infeasible anyway.
        try:
            dp_vids_r, dp_limit, dp_applies, dp_counts0 = (
                _distinct_property_arrays(ctx, job, nodes)
            )
        except UnsupportedByEngine as e:
            return fallback(str(e))
        if dp_vids_r.shape[0] and (evict_node >= 0).any():
            # in-eval evictions interact with the host PropertySet's
            # cleared-value refund quirk (propertyset.py:97-105) — the
            # scan's exact counters would diverge; host placement keeps
            # plan parity
            return fallback("distinct_property with in-eval evictions")
        if dp_vids_r.shape[0] and pre_tables is not None:
            # the same PropertySet refund quirk, via preempted allocs
            return fallback("distinct_property with preemption")
        d_dp = dp_vids_r.shape[0]
        v_dp = dp_counts0.shape[1] if d_dp else 1
        dp_vids = np.full((d_dp, n_pad), v_dp - 1, np.int32)
        if d_dp:
            dp_vids[:, :n_real] = dp_vids_r

        (pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
         pre_alive0, pre_remaining0, pre_counts0) = _pad_preempt_arrays(
            pre_tables, n_pad, n_real, node_c2 if int_mode else None)

        static = (
            totals, reserved, asks, feat_packed, aff_score,
            desired_counts, dh_job, dh_tg, limits, spread_vids, spread_desired,
            spread_weights, spread_has_targets, spread_active,
            sum_spread_weights, np.int32(n_real), e_ask,
            dp_vids, dp_limit, dp_applies,
            pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
        )
        # Ring start mirrors the host source iterator's offset as
        # set_nodes left it, so host and device walk the same ring.
        offset0 = int(getattr(sched.stack.source, "offset", 0)) % max(n_real, 1)
        init_carry = (
            used0, tg_counts0, job_counts0, spread_counts0, spread_entry0,
            np.int32(offset0), np.zeros(g_count, bool), e_base0, dp_counts0,
            pre_alive0, pre_remaining0, pre_counts0,
        )
        xs = (
            tg_idx, penalty_idx, evict_node, evict_res, evict_tg,
            limit_p, sum_sw_p, ev_factor, rev_factor,
            # forced_node rides a WIDTH axis: generic evals are unrestricted
            np.zeros((p, 0), np.int32),
        )

        enc = EncodedEval(
            n_real=n_real, n_pad=n_pad, g=g_count, s=sv, v=vv, p=p,
            dtype=fdtype, static=static, carry=init_carry, xs=xs,
            missing_list=missing_list, nodes=nodes, table=table,
            start_ns=start, dense_ok=dense_ok,
            pre_allocs=(pre_tables.allocs if pre_tables is not None else None),
        )
        if enc_cache is not None and cache_key is not None:
            # arrays are read-only downstream (the batcher pads into fresh
            # buffers, run_scan_single copies them to the device; apply
            # only reads)
            if len(enc_cache) >= 32:
                enc_cache.pop(next(iter(enc_cache)), None)
            enc_cache[cache_key] = (cur_epoch, enc)
        ev = claim_cell.pop("ev", None)
        if ev is not None:
            ev.set()
        return enc

    # ------------------------------------------------------------------
    # System scheduler path: one alloc per ELIGIBLE node. Each placement
    # names its node up front (system_sched.go:268-286), so the dense pass
    # is the scan with a per-placement forced_node restriction and no
    # spread/affinity/limit machinery (SystemStack has none, stack.go:166).
    # ------------------------------------------------------------------

    def compute_system_placements(self, sched, place: List, sched_config=None,
                                  _preempt_pass: bool = False):
        """Place a SystemScheduler eval's placements on the device
        (engine.py:2178-2470). Returns True when fully handled, a
        non-empty list of leftover placement tuples when the device
        handled everything except nodes the host per-node loop must
        preempt on (the caller runs that loop over the subset), or
        NotImplemented when the reference's own gates send the whole
        eval to the host stack. ``sched_config`` is the
        SchedulerConfiguration the caller already read. A kernel that
        fails to build or launch raises."""
        if not place:
            return True

        job = sched.job
        ctx = sched.ctx
        nodes = list(sched.nodes)
        n_real = len(nodes)

        from ..utils import metrics as _metrics

        def fallback(reason: str):
            logger.debug("tpu system engine fallback: %s", reason)
            _metrics.incr_counter("nomad.tpu_engine.fallback")
            return NotImplemented

        for node in nodes:
            if len({net.device for net in node.node_resources.networks if net.device}) > 1:
                return fallback("multi-NIC node")

        from ..trace import lifecycle as _tlc
        from ..utils import phases as _phases

        tg_specs: Dict[str, TGSpec] = {}
        port_cache: Dict[str, object] = {}
        try:
            with _phases.track("encode"), \
                    _tlc.pipeline_stage("encode", sched.eval.id):
                for tup in place:
                    tg = tup.task_group
                    if tg.name not in tg_specs:
                        tg_specs[tg.name] = build_tg_spec(
                            ctx, job, tg, nodes, False, port_cache)
                table = build_node_table(ctx, job, nodes)
        except UnsupportedByEngine as e:
            return fallback(str(e))
        int_mode = bool(ctx.deterministic)
        if int_mode:
            reason = _int_spec_gate_reason(table, tg_specs, job)
            if reason is not None:
                return fallback(reason)
        num_dims = table.totals.shape[1]
        start = _time.monotonic_ns()
        fdtype = np.int32 if int_mode else np.float32

        pre_tables = None
        if _preempt_pass:
            # second pass over capacity-failed forced nodes, WITH the
            # candidate tables. A gate hands the SUBSET to the host
            # per-node loop (list return), never the whole eval: pass 1
            # is already applied.
            if not int_mode:
                return list(place)
            if num_dims != 4:
                return list(place)  # preempt_for_device is host-only
            if any(
                tup.task_group.networks
                or any(t.resources.networks for t in tup.task_group.tasks)
                for tup in place
            ):
                return list(place)  # preempt_for_network is host-only
            from .encode import build_preempt_tables

            pre_tables, pre_reason = build_preempt_tables(ctx, job, nodes)
            if pre_reason is not None:
                logger.debug("tpu system preempt pass to host: %s", pre_reason)
                return list(place)

        n_pad = _round_up(max(n_real, 1))
        g_count = len(job.task_groups)
        specs_by_gi = {spec.index: spec for spec in tg_specs.values()}

        totals = np.zeros((n_pad, num_dims), fdtype)
        totals[:n_real] = table.totals
        reserved = np.zeros((n_pad, num_dims), fdtype)
        reserved[:n_real] = table.reserved
        used0 = np.zeros((n_pad, num_dims), fdtype)
        used0[:n_real] = table.used
        tg_counts0 = np.zeros((g_count, n_pad), np.int32)
        tg_counts0[:, :n_real] = table.tg_counts
        job_counts0 = np.zeros(n_pad, np.int32)
        job_counts0[:n_real] = table.job_counts

        from .intscore import E27_ONE, e27_np, pack_feat_planes, xq_np

        if int_mode:
            node_c2 = (totals[:, :2] - reserved[:, :2]).astype(np.int64)
            free0 = node_c2 - used0[:, :2] - reserved[:, :2]
            e_base0 = e27_np(xq_np(free0, node_c2)).astype(np.int32)
            e_ask = np.full((g_count, n_pad, 2), E27_ONE, np.int32)
        else:
            e_base0 = np.zeros((0, 2), np.int32)
            e_ask = np.zeros((0, 0, 2), np.int32)

        asks = np.zeros((g_count, num_dims), fdtype)
        feas = np.zeros((g_count, n_pad), bool)
        for gi, spec in specs_by_gi.items():
            asks[gi] = spec.ask
            feas[gi, :n_real] = spec.feasible
            if int_mode:
                for d in (0, 1):
                    e_ask[gi, :, d] = e27_np(
                        xq_np(np.full(n_pad, -int(spec.ask[d]), np.int64),
                              node_c2[:, d])
                    ).astype(np.int32)

        # SystemStack has no spread/affinity/limit/anti-affinity
        # iterators: encode them inert so those score terms vanish
        feat_packed = pack_feat_planes(feas)
        aff_score = np.zeros((0, n_pad), fdtype)
        desired_counts = np.ones(g_count, np.int32)
        dh_job = np.zeros(g_count, bool)
        dh_tg = np.zeros(g_count, bool)
        limits = np.ones(g_count, np.int32)
        spread_vids = np.full((g_count, 1, n_pad), 1, np.int32)
        spread_desired = np.full((g_count, 1, 2), -1, fdtype)
        spread_weights = np.zeros((g_count, 1), fdtype)
        spread_has_targets = np.zeros((g_count, 1), bool)
        spread_active = np.zeros((g_count, 1), bool)
        sum_spread_weights = np.zeros(g_count, fdtype)
        spread_counts0 = np.zeros((g_count, 1, 2), fdtype)
        spread_entry0 = np.zeros((g_count, 1, 2), bool)

        p = len(place)
        tg_name_to_gi = {g.name: i for i, g in enumerate(job.task_groups)}
        tg_idx = np.zeros(p, np.int32)
        forced = np.zeros(p, np.int32)
        for pi, tup in enumerate(place):
            tg_idx[pi] = tg_name_to_gi[tup.task_group.name]
            forced[pi] = table.node_index.get(tup.alloc.node_id, -1)
        if (forced < 0).any():
            return fallback("system placement on unknown node")

        from ..structs.structs import CONSTRAINT_DISTINCT_PROPERTY

        has_dp = any(
            c.operand == CONSTRAINT_DISTINCT_PROPERTY
            for c in list(job.constraints)
            + [c for tg in job.task_groups for c in tg.constraints]
        )
        if has_dp:
            # the host DistinctPropertyIterator counts DP blocks as
            # FILTERED; the dense pass can't split that per forced node
            return fallback("system distinct_property")
        dp_vids = np.zeros((0, n_pad), np.int32)
        dp_limit = np.zeros(0, np.int32)
        dp_applies = np.zeros((g_count, 0), bool)
        dp_counts0 = np.zeros((0, 1), np.int32)

        if int_mode:
            # fold reserved into totals (see encode_eval)
            totals = totals - reserved
            reserved = np.zeros((0, num_dims), fdtype)

        (pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
         pre_alive0, pre_remaining0, pre_counts0) = _pad_preempt_arrays(
            pre_tables, n_pad, n_real, node_c2 if int_mode else None)

        static = (
            totals, reserved, asks, feat_packed, aff_score,
            desired_counts, dh_job, dh_tg, limits, spread_vids, spread_desired,
            spread_weights, spread_has_targets, spread_active,
            sum_spread_weights, np.int32(n_real), e_ask,
            dp_vids, dp_limit, dp_applies,
            pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
        )
        init_carry = (
            used0, tg_counts0, job_counts0, spread_counts0, spread_entry0,
            np.int32(0), np.zeros(g_count, bool), e_base0, dp_counts0,
            pre_alive0, pre_remaining0, pre_counts0,
        )
        xs = (
            tg_idx,
            np.full((p, 0), -1, np.int32),       # no reschedule penalties
            np.full(p, -1, np.int32),            # no evictions
            np.zeros((p, 0), fdtype),
            np.full(p, -1, np.int32),
            np.ones(p, np.int32),                # limit: the single node
            np.zeros(p, fdtype),
            np.zeros((p, 0), np.int32),
            np.zeros((p, 0), np.int32),
            forced.reshape(p, 1),
        )
        enc = EncodedEval(
            n_real=n_real, n_pad=n_pad, g=g_count, s=1, v=2, p=p,
            dtype=fdtype, static=static, carry=init_carry, xs=xs,
            missing_list=list(place), nodes=nodes, table=table,
            start_ns=start,
            pre_allocs=(pre_tables.allocs if pre_tables is not None else None),
        )

        # All-distinct forced nodes (single-TG system jobs): the scan-free
        # forced-node kernel. Duplicated forced nodes (multi-TG jobs
        # placing several allocs on one node) interact through used and
        # tg_counts and keep the sequential scan; so does a preempt pass.
        batcher = getattr(sched.planner, "device_batcher", None)
        with _phases.track("device_wait"), \
                _tlc.pipeline_stage("dispatch", sched.eval.id):
            if len(set(forced.tolist())) == p and pre_tables is None:
                chosen, scores, pulls, skipped, evict = self.run_forced(enc)
                if batcher is not None:
                    # the forced kernel bypasses the gather queue; count it
                    # in the batcher's stats under the batcher's lock (the
                    # dispatcher thread updates them too)
                    with batcher._lock:
                        batcher.stats["dispatches"] = batcher.stats.get("dispatches", 0) + 1
                        batcher.stats["evals"] = batcher.stats.get("evals", 0) + 1
            elif batcher is not None:
                chosen, scores, pulls, skipped, evict = batcher.run(enc)
            else:
                chosen, scores, pulls, skipped, evict = self.run_scan_single(enc)

        # A forced node that failed on CAPACITY (feasible by constraints
        # but no fit) with preemption enabled: the device results are
        # KEPT for every other placement and the subset goes through the
        # preempt pass below, in placement order, so max_parallel penalty
        # counts accumulate as in the host loop. Constraint-filtered
        # nodes never preempt.
        preemption_on = True
        if sched_config is not None:
            preemption_on = sched_config.preemption_config.system_scheduler_enabled
        leftover: List = []
        chosen = np.asarray(chosen)
        evict = np.asarray(evict)
        if preemption_on and not _preempt_pass:
            keep: List[int] = []
            for pi, tup in enumerate(place):
                if int(chosen[pi]) < 0:
                    spec = tg_specs[tup.task_group.name]
                    idx = int(forced[pi])
                    if idx < n_real and spec.constraint_feasible[idx]:
                        leftover.append(tup)
                        continue
                keep.append(pi)
            if leftover:
                place = [place[k] for k in keep]
                kp = np.asarray(keep, np.int64)
                chosen = chosen[kp]
                scores = np.asarray(scores)[kp]
                evict = evict[kp]

        if not _preempt_pass:
            _metrics.incr_counter("nomad.tpu_engine.handled")
        self._apply_system_results(
            sched, place, nodes, table, tg_specs, chosen, scores, start,
            enc=enc, evict=evict,
        )
        if not leftover:
            return True
        # Second device pass: re-encode JUST the capacity-failed forced
        # nodes with the candidate tables; the re-encode sees pass 1's
        # proposed plan state, as the host per-node loop would. A pass-2
        # gate returns the subset for the host loop (pass 1 is applied).
        _metrics.incr_counter("nomad.tpu_engine.system_preempt_pass")
        res = self.compute_system_placements(
            sched, leftover, sched_config, _preempt_pass=True)
        if res is NotImplemented:
            return leftover
        return res

    def _apply_system_results(self, sched, place, nodes, table, tg_specs,
                              chosen, scores, start_ns, enc=None,
                              evict=None) -> None:
        """Materialize system results (engine.py:2472-2611): allocs for
        fits, queued-alloc bookkeeping for constraint-filtered nodes,
        failed metrics and per-node blocked evals for capacity failures
        (the host path's semantics). The all-clean case (every node
        placed, fresh, no network/device asks) takes the dense block
        path."""
        from ..structs.structs import AllocMetric
        from .intscore import score60_to_float

        job = sched.job
        ctx = sched.ctx

        chosen = np.asarray(chosen)
        scores = np.asarray(scores)
        if (
            not getattr(sched.eval, "annotate_plan", False)
            and len(place)
            and (chosen[: len(place)] >= 0).all()
            and all(
                (tup.alloc is None or not tup.alloc.id)
                and not tup.task_group.networks
                and not any(
                    t.resources.networks or t.resources.devices
                    for t in tup.task_group.tasks
                )
                for tup in place
            )
        ):
            self._apply_system_results_dense(
                sched, place, nodes, chosen, scores, start_ns,
                enc=enc, evict=evict,
            )
            return

        assigner = _ResourceAssigner(ctx, nodes)

        def fail(tg, node) -> None:
            if sched.failed_tg_allocs and tg.name in sched.failed_tg_allocs:
                sched.failed_tg_allocs[tg.name].coalesced_failures += 1
                return
            metrics = AllocMetric()
            metrics.nodes_evaluated = 1
            metrics.nodes_exhausted = 1
            metrics.nodes_available = sched.nodes_by_dc
            if sched.failed_tg_allocs is None:
                sched.failed_tg_allocs = {}
            sched.failed_tg_allocs[tg.name] = metrics
            sched._add_blocked(node)

        for pi, tup in enumerate(place):
            tg = tup.task_group
            node_idx = int(chosen[pi])

            if node_idx < 0:
                idx = table.node_index.get(tup.alloc.node_id, -1)
                spec = tg_specs[tg.name]
                if idx < 0 or not spec.constraint_feasible[idx]:
                    # constraint mismatch: the node is not in the job's
                    # domain, not a failure (port-OCCUPIED nodes are
                    # exhausted below, like the host's rank-phase port
                    # exhaustion)
                    sched.queued_allocs[tg.name] -= 1
                    if (
                        sched.eval.annotate_plan
                        and sched.plan.annotations is not None
                        and tg.name in sched.plan.annotations.desired_tg_updates
                    ):
                        sched.plan.annotations.desired_tg_updates[tg.name].place -= 1
                    continue
                fail(tg, nodes[idx])
                continue

            node = nodes[node_idx]
            task_resources, shared_networks, ok = assigner.build(node_idx, tg)
            if not ok:
                fail(tg, node)
                continue

            metrics = AllocMetric()
            metrics.nodes_evaluated = 1
            metrics.nodes_available = sched.nodes_by_dc
            if scores.dtype.kind == "i":
                score_f = score60_to_float(scores[pi])
            else:
                score_f = float(scores[pi])
            metrics.score_node(node, "binpack", score_f)
            metrics.score_node(node, "normalized-score", score_f)
            metrics.populate_score_meta_data()

            resources = AllocatedResources(
                tasks=task_resources,
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb, networks=shared_networks
                ),
            )
            alloc = Allocation(
                namespace=job.namespace,
                eval_id=sched.eval.id,
                name=tup.name,
                job_id=job.id,
                task_group=tg.name,
                metrics=metrics,
                node_id=node.id,
                node_name=node.name,
                allocated_resources=resources,
                desired_status=ALLOC_DESIRED_RUN,
                client_status=ALLOC_CLIENT_PENDING,
            )
            if tup.alloc is not None and tup.alloc.id:
                alloc.previous_allocation = tup.alloc.id
            stops = _evicted_allocs(enc, evict, pi, node_idx)
            if stops:
                for stop in stops:
                    sched.plan.append_preempted_alloc(stop, alloc.id)
                alloc.preempted_allocations = [a.id for a in stops]
            sched.plan.append_alloc(alloc)

        ctx.metrics.allocation_time_ns = _time.monotonic_ns() - start_ns

    def _apply_system_results_dense(self, sched, place, nodes, chosen,
                                    scores, start_ns, enc=None,
                                    evict=None) -> None:
        """System-path dense blocks (engine.py:2662-2711), grouped by
        task group. Preconditions checked by the caller: every placement
        chose its node, all fresh, no network/device asks."""
        job = sched.job
        scores_f = self._scores_to_float(scores)
        by_tg: Dict[str, List[int]] = {}
        for pi, tup in enumerate(place):
            by_tg.setdefault(tup.task_group.name, []).append(pi)
        tg_by_name = {tg.name: tg for tg in job.task_groups}
        for tg_name, idxs in by_tg.items():
            block = self._dense_block(
                job, tg_by_name[tg_name], sched.eval.id,
                [chosen[k] for k in idxs], nodes,
                names=[place[k].name for k in idxs],
                scores_f=[scores_f[k] for k in idxs],
                nodes_evaluated=[1] * len(idxs),
                nodes_available=getattr(sched, "nodes_by_dc", {}),
            )
            self._attach_preemptions(sched, block, idxs, chosen, enc, evict)
            sched.plan.dense_placements.append(block)
        sched.ctx.metrics.allocation_time_ns = _time.monotonic_ns() - start_ns

    # ------------------------------------------------------------------

    @staticmethod
    def _scores_to_float(scores) -> np.ndarray:
        """Display-float conversion (int mode carries score60s)."""
        scores = np.asarray(scores)
        if scores.dtype.kind == "i":
            from .intscore import TERM_ONE

            return np.asarray(scores, np.float64) / (60.0 * TERM_ONE)
        return np.asarray(scores, np.float64)

    @staticmethod
    def _dense_block(job, tg, eval_id, node_idxs, nodes, names, scores_f,
                     nodes_evaluated, nodes_available, deployment_id=""):
        """One DenseTGPlacements block for a task group's placements. The
        dense gate guarantees no network/device asks, so one
        AllocatedResources prototype covers every slot and ask_vec's
        mbits is 0."""
        from ..structs.structs import DenseTGPlacements, generate_uuids

        proto = AllocatedResources(
            tasks={
                t.name: AllocatedTaskResources(
                    cpu_shares=t.resources.cpu,
                    memory_mb=t.resources.memory_mb,
                )
                for t in tg.tasks
            },
            shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb),
        )
        return DenseTGPlacements(
            namespace=job.namespace,
            job_id=job.id,
            task_group=tg.name,
            eval_id=eval_id,
            deployment_id=deployment_id,
            job=job,
            resources_proto=proto,
            ask_vec=(
                float(sum(t.resources.cpu for t in tg.tasks)),
                float(sum(t.resources.memory_mb for t in tg.tasks)),
                float(tg.ephemeral_disk.size_mb),
                0.0,
            ),
            ids=generate_uuids(len(node_idxs)),
            names=names,
            node_ids=[nodes[int(j)].id for j in node_idxs],
            node_names=[nodes[int(j)].name for j in node_idxs],
            scores=[float(s) for s in scores_f],
            nodes_evaluated=list(nodes_evaluated),
            nodes_available=nodes_available,
        )

    def _apply_results_dense(self, sched, enc, chosen, scores, pulls,
                             evict=None) -> None:
        """Record scan results as DenseTGPlacements blocks — one per task
        group, parallel arrays only. Eviction sets ride each block as
        parallel id lists and go into ``plan.node_preemptions`` (the plan
        applier re-checks them, the FSM commits them). Preconditions
        (checked by the caller): enc.dense_ok, every placement chosen."""
        job = sched.job
        deployment_id = ""
        if sched.deployment is not None and sched.deployment.active():
            deployment_id = sched.deployment.id

        scores_f = self._scores_to_float(scores)
        pulls = np.asarray(pulls)
        tg_idx = enc.xs[0]  # [p] task-group index per placement
        missing_list = enc.missing_list

        for gi in np.unique(tg_idx):
            sel = np.nonzero(tg_idx == gi)[0]
            block = self._dense_block(
                job, job.task_groups[int(gi)], sched.eval.id,
                chosen[sel], enc.nodes,
                names=[missing_list[k].get_name() for k in sel],
                scores_f=scores_f[sel],
                nodes_evaluated=pulls[sel].tolist(),
                nodes_available=getattr(sched, "_nodes_by_dc", {}),
                deployment_id=deployment_id,
            )
            self._attach_preemptions(sched, block, sel, chosen, enc, evict)
            sched.plan.dense_placements.append(block)

        sched.ctx.metrics.allocation_time_ns = _time.monotonic_ns() - enc.start_ns

    @staticmethod
    def _attach_preemptions(sched, block, idxs, chosen, enc, evict) -> None:
        """Each placement's eviction set onto a dense block
        (``block.preempted``) and into ``plan.node_preemptions``."""
        pre_ids: List[List[str]] = []
        for bi, k in enumerate(idxs):
            stops = _evicted_allocs(enc, evict, int(k), int(chosen[int(k)]))
            for stop in stops:
                sched.plan.append_preempted_alloc(stop, block.ids[bi])
            pre_ids.append([a.id for a in stops])
        if any(pre_ids):
            block.preempted = pre_ids

    def _apply_results(self, sched, missing_list, nodes, chosen, scores,
                       pulls, skipped_steps, start_ns, enc=None,
                       evict=None) -> None:
        """Materialize scan results into the plan (allocs, stops, metrics)."""
        from ..structs.structs import AllocMetric
        from .intscore import score60_to_float

        job = sched.job
        ctx = sched.ctx
        deployment_id = ""
        if sched.deployment is not None and sched.deployment.active():
            deployment_id = sched.deployment.id
        now = _time.time_ns()

        # Lazy per-node NetworkIndex / DeviceAllocator mirrors for port and
        # device-instance assignment (the discrete half the capacity dims
        # pre-checked on device).
        assigner = _ResourceAssigner(ctx, nodes)

        for pi, missing in enumerate(missing_list):
            tg = missing.get_task_group()
            node_idx = int(chosen[pi])

            if skipped_steps[pi]:
                # coalesced failure (TG already failed earlier in this eval)
                if sched.failed_tg_allocs and tg.name in sched.failed_tg_allocs:
                    sched.failed_tg_allocs[tg.name].coalesced_failures += 1
                continue

            prev_allocation = missing.get_previous_allocation()
            stop_prev, stop_desc = missing.stop_previous_alloc()

            metrics = AllocMetric()
            metrics.nodes_evaluated = int(pulls[pi])
            metrics.nodes_available = getattr(sched, "_nodes_by_dc", {})

            if node_idx < 0:
                if sched.failed_tg_allocs is None:
                    sched.failed_tg_allocs = {}
                sched.failed_tg_allocs[tg.name] = metrics
                continue

            if stop_prev and prev_allocation is not None:
                sched.plan.append_stopped_alloc(prev_allocation, stop_desc, "")

            node = nodes[node_idx]

            task_resources, shared_networks, ok = assigner.build(node_idx, tg)
            if not ok:
                # Port/device-instance collision the capacity model missed:
                # extremely rare; record as failed placement (plan applier
                # would have rejected it anyway).
                if sched.failed_tg_allocs is None:
                    sched.failed_tg_allocs = {}
                sched.failed_tg_allocs[tg.name] = metrics
                if stop_prev and prev_allocation is not None:
                    sched.plan.pop_update(prev_allocation)
                continue

            if np.asarray(scores).dtype.kind == "i":
                # int-spec score60 -> display float (metrics only; never
                # used in selection comparisons)
                score_f = score60_to_float(scores[pi])
            else:
                score_f = float(scores[pi])
            metrics.score_node(node, "binpack", score_f)
            metrics.score_node(node, "normalized-score", score_f)
            metrics.populate_score_meta_data()

            resources = AllocatedResources(
                tasks=task_resources,
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb, networks=shared_networks
                ),
            )

            alloc = Allocation(
                namespace=job.namespace,
                eval_id=sched.eval.id,
                name=missing.get_name(),
                job_id=job.id,
                task_group=tg.name,
                metrics=metrics,
                node_id=node.id,
                node_name=node.name,
                deployment_id=deployment_id,
                allocated_resources=resources,
                desired_status=ALLOC_DESIRED_RUN,
                client_status=ALLOC_CLIENT_PENDING,
            )

            if prev_allocation is not None:
                alloc.previous_allocation = prev_allocation.id
                if missing.is_rescheduling():
                    from ..scheduler.generic_sched import update_reschedule_tracker

                    update_reschedule_tracker(alloc, prev_allocation, now)

            if missing.is_canary() and sched.deployment is not None:
                state = sched.deployment.task_groups.get(tg.name)
                if state is not None:
                    state.placed_canaries.append(alloc.id)
                from ..structs.structs import AllocDeploymentStatus

                alloc.deployment_status = AllocDeploymentStatus(canary=True)

            stops = _evicted_allocs(enc, evict, pi, node_idx)
            if stops:
                for stop in stops:
                    sched.plan.append_preempted_alloc(stop, alloc.id)
                alloc.preempted_allocations = [a.id for a in stops]

            sched.plan.append_alloc(alloc)

        ctx.metrics.allocation_time_ns = _time.monotonic_ns() - start_ns


# ---------------------------------------------------------------------------
# Synthetic inputs (graft entry / dryrun / microbench)
# ---------------------------------------------------------------------------


def example_scan_inputs(n_nodes: int = 64, n_tgs: int = 2, n_placements: int = 16,
                        n_spreads: int = 1, vocab: int = 4,
                        dtype=np.float32, seed: int = 0, num_dims: int = 4):
    """Build plausible dense scan inputs directly (no scheduler objects).

    Returns (n_pad, static, init_carry, xs) as numpy arrays, shaped exactly
    like compute_placements builds them. ``dtype=np.int32`` builds the
    exact-integer parity encoding (spread targets in hundredths, Q30
    affinity ints — the intscore.py spec); float dtypes build the
    throughput encoding.
    """
    dtype = np.dtype(dtype)
    int_mode = dtype.kind == "i"
    rng = np.random.default_rng(seed)
    n_pad = _round_up(n_nodes)
    # zero n_spreads = a true ZERO S axis: the spread machinery
    # (one-hot [S,V,N] lookups, boosts, count carries) compiles away
    # entirely, matching production encode for spread-free jobs
    g, s, v = n_tgs, n_spreads, vocab + 1

    totals = np.zeros((n_pad, num_dims), dtype)
    totals[:n_nodes, DIM_CPU] = rng.choice([2000, 4000, 8000], n_nodes)
    totals[:n_nodes, DIM_MEM] = rng.choice([4096, 8192, 16384], n_nodes)
    totals[:n_nodes, 2] = 100 * 1024
    totals[:n_nodes, DIM_MBITS] = 1000
    reserved = np.zeros((n_pad, num_dims), dtype)
    reserved[:n_nodes, DIM_CPU] = 100
    reserved[:n_nodes, DIM_MEM] = 256
    used0 = np.zeros((n_pad, num_dims), dtype)

    asks = np.zeros((g, num_dims), dtype)
    asks[:, DIM_CPU] = rng.choice([100, 250, 500], g)
    asks[:, DIM_MEM] = rng.choice([128, 256, 512], g)
    asks[:, 2] = 150
    asks[:, DIM_MBITS] = 10

    feas = np.zeros((g, n_pad), bool)
    feas[:, :n_nodes] = rng.random((g, n_nodes)) < 0.9
    from .intscore import pack_feat_planes

    feat_packed = pack_feat_planes(feas)
    # no affinities in the synthetic workload: zero G axis (the step
    # compiles the affinity term away — matching production encode)
    aff_score = np.zeros((0, n_pad), dtype)
    desired_counts = np.full(g, max(n_placements // g, 1), np.int32)
    dh_job = np.zeros(g, bool)
    dh_tg = np.zeros(g, bool)
    limits = np.full(g, max(2, int(np.ceil(np.log2(max(n_nodes, 2))))), np.int32)

    spread_vids = np.full((g, s, n_pad), v - 1, np.int32)
    spread_vids[:, :, :n_nodes] = rng.integers(0, vocab, (g, s, n_nodes))
    spread_desired = np.full((g, s, v), -1, dtype) if int_mode else \
        np.full((g, s, v), -1.0, dtype)
    if int_mode:
        # hundredths (d = percent * count), evenly targeted
        spread_desired[:, :, :vocab] = (100 * n_placements) // vocab
    else:
        spread_desired[:, :, :vocab] = float(n_placements) / vocab
    spread_weights = np.full((g, s), 50, dtype)
    spread_has_targets = np.ones((g, s), bool)
    spread_active = np.zeros((g, s), bool)
    spread_active[:, :n_spreads] = True
    sum_spread_weights = np.full(g, 50 * max(n_spreads, 1), dtype)
    spread_counts0 = np.zeros((g, s, v), dtype)
    spread_entry0 = np.zeros((g, s, v), bool)

    if int_mode:
        from .intscore import E27_ONE, e27_np, xq_np

        node_c2 = (totals[:, :2] - reserved[:, :2]).astype(np.int64)
        e_base0 = e27_np(xq_np(node_c2 - used0[:, :2] - reserved[:, :2],
                               node_c2)).astype(np.int32)
        e_ask = np.full((g, n_pad, 2), E27_ONE, np.int32)
        for gi in range(g):
            for d in (0, 1):
                e_ask[gi, :, d] = e27_np(
                    xq_np(np.full(n_pad, -int(asks[gi, d]), np.int64),
                          node_c2[:, d])
                ).astype(np.int32)
        # reserved folds into totals (see encode_eval)
        totals = totals - reserved
        reserved = np.zeros((0, num_dims), dtype)
    else:
        e_base0 = np.zeros((0, 2), np.int32)
        e_ask = np.zeros((0, 0, 2), np.int32)

    static = (totals, reserved, asks, feat_packed, aff_score,
              desired_counts, dh_job, dh_tg, limits, spread_vids,
              spread_desired, spread_weights, spread_has_targets,
              spread_active, sum_spread_weights, np.int32(n_nodes), e_ask,
              np.zeros((0, n_pad), np.int32),   # dp_vids: no distinct_property
              np.zeros(0, np.int32),
              np.zeros((g, 0), bool),
              # no preemption: zero-width candidate axis compiles the
              # eviction path away
              np.zeros((n_pad, 0, 4), np.int32), np.zeros((n_pad, 0), np.int32),
              np.zeros((n_pad, 0), bool), np.zeros((n_pad, 0), np.int32),
              np.zeros((n_pad, 0), np.int32), np.zeros((n_pad, 0, 2), np.int32))
    init_carry = (used0, np.zeros((g, n_pad), np.int32), np.zeros(n_pad, np.int32),
                  spread_counts0, spread_entry0, np.int32(0), np.zeros(g, bool),
                  e_base0, np.zeros((0, 1), np.int32),
                  np.zeros((n_pad, 0), bool), np.zeros((0, 3), np.int64),
                  np.zeros(0, np.int32))
    limit_val = max(2, int(np.ceil(np.log2(max(n_nodes, 2)))))
    xs = (rng.integers(0, g, n_placements).astype(np.int32),
          np.full((n_placements, 0), -1, np.int32),  # no reschedule history
          np.full(n_placements, -1, np.int32),
          # no evictions: zero-width axes compile the evict path away
          np.zeros((n_placements, 0), dtype),
          np.full(n_placements, -1, np.int32),
          np.full(n_placements, 2**31 - 1 if n_spreads else limit_val, np.int32),
          np.full(n_placements, 50 * max(n_spreads, 1), dtype),
          np.zeros((n_placements, 0), np.int32),
          np.zeros((n_placements, 0), np.int32),
          np.zeros((n_placements, 0), np.int32))  # forced_node: unrestricted
    return n_pad, static, init_carry, xs


#: specialization axes of the step that ``example_scan_variant`` can turn on
SCAN_VARIANTS = ("s0", "s1", "even", "affinity", "evict", "penalty",
                 "distinct_property", "forced", "overcommit", "all")
#: the preemption branch (int arm only): generic, and the system
#: scheduler's preempt pass
PREEMPT_VARIANTS = ("preempt", "preempt_forced")


def example_scan_variant(variant: str, n_nodes: int = 64, n_tgs: int = 2,
                         n_placements: int = 16, seed: int = 0, dtype=np.int32):
    """``example_scan_inputs`` with specialization axes of the step
    switched on, for holding the kernel and its plain version against
    the JAX scan on every branch a generic eval takes, in the int arm
    (``dtype=np.int32``, the default) or the float arm (``np.float32``):

      s0 / s1            no spread axis / one targeted spread
      even               one even spread (no targets), counts pre-seeded
      affinity           the affinity G axis and presence lane
      evict              destructive updates: evicted allocs pre-placed
                         in the carry, eviction and revert factors
      penalty            reschedule-penalty nodes per placement
      distinct_property  two property constraints with value counts
      forced             per-placement forced nodes (-1 = unrestricted)
      overcommit         asks 30x larger, with evictions: placements fail,
                         evictions revert, failed TGs skip later steps
      all                all of the above, two spreads (one even), and a
                         non-folded reserved plane

      preempt            (int arm) C = 16 candidate slots per node filled
                         with low-priority allocs that overcommit most
                         nodes (negative remaining), mixed priorities,
                         ineligible slots, max_parallel penalties from
                         pre-counted groups; asks 4x larger
      preempt_forced     (int arm) the system preempt pass: the same
                         tables, one distinct forced node per placement,
                         limit 1, no active spread

    numpy only, seeded; returns (n_pad, static, carry, xs)."""
    from .intscore import E27_ONE, TERM_ONE, e27_np, e27_py, pack_feat_planes, xq_np, xq_py

    if variant in PREEMPT_VARIANTS:
        return _example_preempt_variant(variant, n_nodes, n_tgs, n_placements, seed,
                                        np.dtype(dtype))
    if variant not in SCAN_VARIANTS:
        raise ValueError(f"unknown scan variant {variant!r}")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.int32), np.dtype(np.float32)):
        raise ValueError(f"scan variants are int32 or float32, not {dtype}")
    int_mode = dtype.kind == "i"
    if variant == "all":
        on = set(SCAN_VARIANTS[2:-2]) | {"reserved"}
    elif variant == "overcommit":
        on = {"overcommit", "evict"}
    else:
        on = {variant}
    n_spreads = 0 if variant == "s0" else (2 if variant == "all" else 1)
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes, n_tgs, n_placements, n_spreads=n_spreads, dtype=dtype,
        seed=seed)
    static, carry, xs = list(static), list(carry), list(xs)
    rng = np.random.default_rng(seed + 7919)
    g, p = n_tgs, n_placements
    tg_idx = xs[0]
    totals = static[0]
    feas = (static[3] & 1).astype(bool)

    if "overcommit" in on:
        static[2] = static[2] * 30
    if "overcommit" in on and int_mode:
        static[16] = np.empty_like(static[16])
        node_c2 = totals[:, :2].astype(np.int64)
        for gi in range(g):
            for d in (0, 1):
                static[16][gi, :, d] = e27_np(
                    xq_np(np.full(n_pad, -int(static[2][gi, d]), np.int64),
                          node_c2[:, d])).astype(np.int32)
    if "even" in on:
        # first spread of TG 0 (every TG in the "even" variant) spreads
        # evenly; pre-seeded counts give min/max/entry a history
        rows = range(g) if variant == "even" else (0,)
        vocab = static[10].shape[-1] - 1
        for gi in rows:
            static[12][gi, 0] = False
            counts = rng.integers(0, 4, vocab).astype(carry[3].dtype)
            carry[3][gi, 0, :vocab] = counts
            carry[4][gi, 0, :vocab] = (counts > 0) | (rng.random(vocab) < 0.1)
    if "affinity" in on:
        aff_present = np.zeros((g, n_pad), bool)
        aff_present[:, :n_nodes] = rng.random((g, n_nodes)) < 0.5
        if int_mode:
            choices = np.array([-TERM_ONE, -TERM_ONE // 3, TERM_ONE // 2, TERM_ONE],
                               np.int64)
        else:
            choices = np.array([-1.0, -1.0 / 3.0, 0.5, 1.0], np.float32)
        aff_score = np.where(aff_present, rng.choice(choices, (g, n_pad)), 0)
        static[4] = aff_score.astype(dtype)
        static[3] = pack_feat_planes(feas, aff_present)
    if "reserved" in on:
        # a reserved plane beside the folded totals (int arm), or in
        # place of the float arm's own
        reserved = np.zeros_like(totals)
        reserved[:n_nodes, 0] = 50
        reserved[:n_nodes, 1] = 128
        static[1] = reserved
    if "penalty" in on:
        pen = np.full((p, 6), -1, np.int32)
        for pi in range(p):
            if rng.random() < 0.4:
                k = int(rng.integers(1, 4))
                pen[pi, :k] = rng.integers(0, n_nodes, k)
        xs[1] = pen
    if "evict" in on:
        d_dims = totals.shape[1]
        evict_node = np.full(p, -1, np.int32)
        evict_res = np.zeros((p, d_dims), dtype)
        evict_tg = np.full(p, -1, np.int32)
        used, tg_counts, job_counts = carry[0], carry[1], carry[2]
        spread_vids, spread_active = static[9], static[13]
        for pi in range(p):
            if rng.random() >= 0.5:
                continue
            node = int(rng.integers(0, n_nodes))
            gi = int(tg_idx[pi])
            evict_node[pi] = node
            evict_res[pi] = static[2][gi]
            # the evicted alloc is part of the eval-start state
            used[node] += evict_res[pi]
            job_counts[node] += 1
            if rng.random() < 0.8:
                evict_tg[pi] = gi
                tg_counts[gi, node] += 1
                for s in np.nonzero(spread_active[gi])[0]:
                    vid = spread_vids[gi, s, node]
                    carry[3][gi, s, vid] += 1
                    carry[4][gi, s, vid] = True
        # the float arm carries no exponentials: its factors are inert
        # ones, as encode_eval writes them
        ev_factor = np.full((p, 2), E27_ONE if int_mode else 1, np.int32)
        rev_factor = ev_factor.copy()
        node_c2 = totals[:, :2].astype(np.int64)
        if int_mode:
            carry[7] = e27_np(xq_np(node_c2 - used[:, :2], node_c2)).astype(np.int32)
        for pi in np.nonzero(evict_node >= 0)[0] if int_mode else ():
            for d in (0, 1):
                er = int(evict_res[pi, d])
                nc = int(node_c2[evict_node[pi], d])
                ev_factor[pi, d] = e27_py(xq_py(er, nc))
                rev_factor[pi, d] = e27_py(xq_py(-er, nc))
        xs[2], xs[3], xs[4], xs[7], xs[8] = (
            evict_node, evict_res, evict_tg, ev_factor, rev_factor)
    if "distinct_property" in on:
        n_dp, v2 = 2, 5
        dp_vids = np.full((n_dp, n_pad), v2 - 1, np.int32)
        dp_vids[:, :n_nodes] = np.where(
            rng.random((n_dp, n_nodes)) < 0.1, v2 - 1,
            rng.integers(0, v2 - 1, (n_dp, n_nodes)))
        static[17] = dp_vids
        static[18] = np.array([max(2, p // 3), max(2, p // 2)], np.int32)
        static[19] = rng.random((g, n_dp)) < 0.7
        carry[8] = rng.integers(0, 3, (n_dp, v2)).astype(np.int32)
    if "forced" in on:
        forced = np.where(rng.random(p) < 0.5, rng.integers(0, n_nodes, p), -1)
        xs[9] = forced.astype(np.int32)[:, None]
    return n_pad, tuple(static), tuple(carry), tuple(xs)


def _example_preempt_variant(variant, n_nodes, n_tgs, n_placements, seed, dtype):
    """The ``preempt`` / ``preempt_forced`` variants of
    ``example_scan_variant``."""
    from .intscore import e27_np, xq_np
    from .preempt import C_MAX

    if dtype != np.dtype(np.int32):
        raise ValueError("the preemption variants exist in the int arm only")
    forced = variant == "preempt_forced"
    if forced and n_placements > n_nodes:
        raise ValueError("preempt_forced needs a distinct node per placement")
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes, n_tgs, n_placements, n_spreads=1, dtype=np.int32, seed=seed)
    static, carry, xs = list(static), list(carry), list(xs)
    rng = np.random.default_rng(seed + 104729)
    totals = static[0]                       # reserved already folded
    d_dims = totals.shape[1]
    c_w, gp = C_MAX, 8
    asks = static[2].copy()
    asks[:, :3] *= 4
    static[2] = asks

    pre_res = np.zeros((n_pad, c_w, 4), np.int32)
    pre_prio = np.zeros((n_pad, c_w), np.int32)
    pre_elig = np.zeros((n_pad, c_w), bool)
    pre_mp = np.zeros((n_pad, c_w), np.int32)
    pre_gid = np.zeros((n_pad, c_w), np.int32)
    for i in range(n_nodes):
        k = int(rng.integers(4, c_w + 1))
        # the slots fill 70-115 % of cpu and memory on most nodes, which
        # then do not fit the ask (some overcommitted: negative
        # remaining), and 20-50 % on a fifth of them, which fit outright
        lo, hi = (0.2, 0.5) if rng.random() < 0.2 else (0.7, 1.15)
        for d in (0, 1):
            share = rng.dirichlet(np.ones(k)) * rng.uniform(lo, hi)
            pre_res[i, :k, d] = np.maximum(1, share * totals[i, d]).astype(np.int32)
        pre_res[i, :k, 2] = rng.integers(50, 1500, k)
        pre_res[i, :k, 3] = rng.integers(0, 20, k)
        pre_prio[i, :k] = rng.choice([10, 20, 20, 30, 40], k)
        pre_elig[i, :k] = rng.random(k) < 0.85
        pre_mp[i, :k] = rng.choice([0, 0, 1, 2], k)
        pre_gid[i, :k] = rng.integers(0, gp, k)
    used = np.zeros_like(carry[0])
    used[:, :4] = pre_res.sum(axis=1)
    node_c2 = totals[:, :2].astype(np.int64)
    pre_evf = np.full((n_pad, c_w, 2), 1, np.int32)
    for d in (0, 1):
        pre_evf[:, :, d] = e27_np(
            xq_np(pre_res[:, :, d].astype(np.int64), np.maximum(node_c2[:, d], 1)[:, None])
        ).astype(np.int32)
    pre_remaining = np.zeros((n_pad, 3), np.int64)
    pre_remaining[:n_nodes] = (totals[:n_nodes, :3].astype(np.int64)
                               - used[:n_nodes, :3].astype(np.int64))
    carry[0] = used
    carry[7] = e27_np(xq_np(node_c2 - used[:, :2], np.maximum(node_c2, 1))).astype(np.int32)
    static[20:26] = [pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf]
    carry[9] = np.ones((n_pad, c_w), bool)
    carry[10] = pre_remaining
    carry[11] = rng.integers(0, 3, gp).astype(np.int32)
    # the Q27 ask factors against the new asks
    e_ask = np.empty_like(static[16])
    for gi in range(n_tgs):
        for d in (0, 1):
            e_ask[gi, :, d] = e27_np(
                xq_np(np.full(n_pad, -int(asks[gi, d]), np.int64),
                      np.maximum(node_c2[:, d], 1))).astype(np.int32)
    static[16] = e_ask
    if forced:
        # one distinct forced node per placement, as the system pass
        # encodes the capacity-failed nodes: limit 1, no active spread
        xs[9] = rng.permutation(n_nodes)[:n_placements].astype(np.int32)[:, None]
        xs[5] = np.ones(n_placements, np.int32)
        static[13] = np.zeros_like(static[13])
    return n_pad, tuple(static), tuple(carry), tuple(xs)


def example_forced_variant(n_nodes: int = 64, n_placements: int = 64,
                           seed: int = 0, dtype=np.int32, device_dims: int = 0):
    """Inputs of the forced-node kernel (K4) in the system encoder's
    shape: one task group, one distinct forced node per placement (the
    first ``n_placements`` of a seeded permutation), no spreads,
    affinities, penalties, evictions or candidates, limit 1, a pre-placed
    load that leaves some nodes without room and some task-group counts
    (anti-affinity), distinct_hosts off. ``device_dims`` adds capacity
    dims past the four (device counts). The placement axis is not padded
    (``run_forced`` does not pad it either). numpy only; returns (n_pad, static, carry,
    xs), which the scan (K1/K2) also takes."""
    dtype = np.dtype(dtype)
    int_mode = dtype.kind == "i"
    if n_placements > n_nodes:
        raise ValueError("one distinct forced node per placement")
    num_dims = 4 + device_dims
    n_pad, static, carry, xs = example_scan_inputs(
        n_nodes, 1, n_placements, n_spreads=1, dtype=dtype, seed=seed,
        num_dims=num_dims)
    static, carry, xs = list(static), list(carry), list(xs)
    rng = np.random.default_rng(seed + 31337)
    totals = static[0]
    used = np.zeros_like(carry[0])
    used[:n_nodes, 0] = (totals[:n_nodes, 0] * rng.uniform(0.0, 1.05, n_nodes)).astype(dtype)
    used[:n_nodes, 1] = (totals[:n_nodes, 1] * rng.uniform(0.0, 0.9, n_nodes)).astype(dtype)
    if device_dims:
        totals[:n_nodes, 4:] = rng.integers(0, 3, (n_nodes, device_dims)).astype(dtype)
        static[2][:, 4:] = 1
    carry[0] = used
    tg_counts = np.zeros_like(carry[1])
    tg_counts[0, :n_nodes] = rng.random(n_nodes) < 0.3
    carry[1] = tg_counts
    carry[2] = tg_counts[0].astype(np.int32).copy()
    static[13] = np.zeros_like(static[13])                  # no active spread
    static[5] = np.full_like(static[5], max(n_placements, 1))
    if int_mode:
        from .intscore import e27_np, xq_np

        # reserved is already folded into totals: capacities are totals
        node_c2 = totals[:, :2].astype(np.int64)
        carry[7] = e27_np(xq_np(node_c2 - used[:, :2], np.maximum(node_c2, 1))).astype(np.int32)
    xs[0] = np.zeros(n_placements, np.int32)
    xs[5] = np.ones(n_placements, np.int32)
    xs[9] = rng.permutation(n_nodes)[:n_placements].astype(np.int32)[:, None]
    return n_pad, tuple(static), tuple(carry), tuple(xs)


#: the chunked scan's input variants (``example_chunk_variant``)
CHUNK_VARIANTS = ("open", "c1m", "spread_affinity", "distinct_hosts", "tight")


def example_chunk_variant(variant: str, n_nodes: int = 64, n_tgs: int = 2,
                          seed: int = 0):
    """Float-arm inputs of the chunked scan (K5), from
    ``example_scan_inputs``, for holding the kernel and its plain
    version against the JAX ``_build_chunk_scan``:

      open             every node feasible, no affinity axis (the r2
                       crash shape of tests/test_chunk_scan.py), one
                       targeted spread
      c1m              bench.py ``c1m_inputs``: every node feasible, asks
                       of 15 MHz / 30 MB for every task group (C1M's
                       mock nodes tie exactly)
      spread_affinity  the affinity axis with scores and presence, two
                       targeted spreads, one value desired 0 (the -big
                       clamp) on the first
      distinct_hosts   job-level distinct_hosts on every task group, and
                       task-group-level on none
      tight            40 feasible nodes per task group, nodes that hold
                       three allocs, no reservation: a chunk wider than
                       40 places fewer than asked and the deficit drains
                       through later steps

    numpy only, seeded; returns (n_pad, static, carry); build the steps
    with ``chunk.chunk_schedule``."""
    from .intscore import pack_feat_planes

    if variant not in CHUNK_VARIANTS:
        raise ValueError(f"unknown chunk variant {variant!r}")
    n_spreads = 2 if variant == "spread_affinity" else 1
    n_pad, static, carry, _xs = example_scan_inputs(
        n_nodes=n_nodes, n_tgs=n_tgs, n_placements=64, n_spreads=n_spreads,
        dtype=np.float32, seed=seed)
    static, carry = list(static), list(carry)
    rng = np.random.default_rng(seed + 104729)
    g = n_tgs
    feas = np.zeros((g, n_pad), bool)
    feas[:, :n_nodes] = True
    static[3] = pack_feat_planes(feas)
    if variant == "c1m":
        asks = np.zeros_like(static[2])
        asks[:, DIM_CPU] = 15
        asks[:, DIM_MEM] = 30
        static[2] = asks
    elif variant == "spread_affinity":
        aff_present = np.zeros((g, n_pad), bool)
        aff_present[:, :n_nodes] = rng.random((g, n_nodes)) < 0.5
        choices = np.array([-1.0, -1.0 / 3.0, 0.5, 1.0], np.float32)
        static[4] = np.where(aff_present, rng.choice(choices, (g, n_pad)),
                             0).astype(np.float32)
        static[3] = pack_feat_planes(feas, aff_present)
        static[10] = static[10].copy()
        static[10][:, 0, 0] = 0.0
    elif variant == "distinct_hosts":
        static[6] = np.ones(g, bool)
    elif variant == "tight":
        feas[:] = False
        for gi in range(g):
            feas[gi, rng.choice(n_nodes, min(40, n_nodes), replace=False)] = True
        static[3] = pack_feat_planes(feas)
        totals = static[0].copy()
        totals[:n_nodes, DIM_CPU] = 300.0
        totals[:n_nodes, DIM_MEM] = 600.0
        static[0] = totals
        asks = static[2].copy()
        asks[:, DIM_CPU] = 100.0
        asks[:, DIM_MEM] = 100.0
        static[2] = asks
        static[1] = np.zeros_like(static[1])
    return n_pad, tuple(static), tuple(carry)
