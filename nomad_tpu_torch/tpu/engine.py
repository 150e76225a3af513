"""The ``tpu_binpack`` placement engine of the port.

Host code of ``nomad_tpu/tpu/engine.py`` ``TpuPlacementEngine`` needed
for generic (service/batch) evals, around the port's placement scan:
``encode_eval`` turns the eval into dense numpy arrays (the encoders of
``encode.py``, the encode cache with its single-flight claim) in the
eval's arm: int32 when the scheduler is deterministic, float32
otherwise (the server's default). ``compute_placements`` hands them to
the server's ``DeviceBatcher`` (``batcher.py``: one
``kernels.place_scan_batched`` launch for up to ``device_batch`` evals)
when the scheduler's planner has one, else ``run_scan_single`` runs
them through ``kernels.place_scan``; on ``cuda`` that is the
hand-written CUDA kernel, on ``cpu`` its plain PyTorch version.
``_apply_results`` / ``_apply_results_dense`` turn the chosen nodes into
the Plan, as in the JAX engine.

An encode this engine cannot run yet takes the same gate the JAX engine
uses for unsupported features (host placement, ``NotImplemented``) and
is counted under ``nomad.tpu_engine.unported`` with its reason:
``preemption``, a service/batch eval with preemption enabled by the
scheduler configuration (it would carry candidate tables).

Unlike the JAX engine, a failed kernel build or launch is not caught:
it raises out of the scheduler's ``process()`` (the server's worker then
nacks the eval back to the broker); nothing is placed on the host
instead. The chunked tier, the forced-node (system) kernel and parity
sampling are later slices.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, List

import numpy as np

from ..structs.network import NetworkIndex
from ..structs.structs import (
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    Allocation,
)
from ..utils.hostwork import HOST_WORK_SEM as _HOST_WORK_SEM
from . import kernels
from .convert import DeviceLike, resolve_device, scan_inputs_to_torch, to_numpy

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

logger = logging.getLogger("nomad_tpu.tpu.engine")


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
        # preemption candidate allocs (JAX engine); None here: the port
        # gates preempting evals before encode
        self.pre_allocs = pre_allocs


def _no_preempt_arrays(n_pad):
    """The zero-width candidate axis of an eval that encodes no
    preemption: the 6 static entries, then the 3 carry seeds."""
    return (
        np.zeros((n_pad, 0, 4), np.int32), np.zeros((n_pad, 0), np.int32),
        np.zeros((n_pad, 0), bool), np.zeros((n_pad, 0), np.int32),
        np.zeros((n_pad, 0), np.int32), np.zeros((n_pad, 0, 2), np.int32),
        np.zeros((n_pad, 0), bool), np.zeros((0, 3), np.int64),
        np.zeros(0, np.int32),
    )


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
        small for the device or the encode takes the unsupported/unported
        gate (the host iterator stack places the eval). When the
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
            try:
                with _phases.track("device_wait"), \
                        _tlc.pipeline_stage("dispatch", wave_id):
                    if batcher is not None:
                        expected_held = False  # run() consumes the token
                        chosen, scores, pulls, skipped_steps, _evict = batcher.run(
                            enc, expected=True)
                    else:
                        chosen, scores, pulls, skipped_steps, _evict = (
                            self.run_scan_single(enc))
            except BaseException:
                # the launch failed: the error reaches the worker, which
                # nacks the eval; the remembered encode must not strand
                self._pipeline_forget(sched)
                raise
        finally:
            if expected_held:
                batcher.cancel_expected()
        _metrics.measure_since("nomad.tpu_engine.device_wait", t0)
        t0 = _metrics.now()
        with _HOST_WORK_SEM:
            t1 = _metrics.now()
            with _phases.track("apply"):
                chosen = np.asarray(chosen)
                skipped_steps = np.asarray(skipped_steps)
                if enc.dense_ok and (chosen >= 0).all() and not skipped_steps.any():
                    # every placement succeeded and qualifies: results stay
                    # dense (no per-alloc objects) all the way to the FSM
                    self._apply_results_dense(sched, enc, chosen, scores, pulls)
                else:
                    self._apply_results(
                        sched, enc.missing_list, enc.nodes, chosen, scores,
                        pulls, skipped_steps, enc.start_ns,
                    )
            _metrics.measure_since("nomad.tpu_engine.apply_work", t1)
        _metrics.measure_since("nomad.tpu_engine.apply", t0)
        return True

    def run_scan_single(self, enc: "EncodedEval"):
        """Run one encoded eval through ``kernels.place_scan`` on the
        engine's device; returns numpy (chosen, scores, pulls, skipped,
        evict)."""
        from ..utils import phases as _phases

        static, carry, xs = scan_inputs_to_torch(enc.static, enc.carry, enc.xs,
                                                 self.device)
        with _phases.track("device"):
            _carry, ys = kernels.place_scan(enc.n_pad, static, carry, xs)
            out = to_numpy(ys)
        return out

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
        (unsupported or unported feature — host placement).

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

        def unported(reason: str):
            logger.debug("tpu engine: %s not ported yet; host placement", reason)
            _metrics.incr_counter("nomad.tpu_engine.unported")
            _metrics.incr_counter(f"nomad.tpu_engine.unported.{reason}")
            return NotImplemented

        # Gate of what the port cannot run yet (module doc), before any
        # claim or encode work. Device-side preemption: the SAME switch
        # the host stack consults
        # (generic_sched.get_select_options).
        from ..scheduler.preemption import preemption_enabled

        _, _sched_cfg = ctx.state.scheduler_config()
        if preemption_enabled(_sched_cfg, job.type):
            return unported("preemption")

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
        if fleet is not None and dense_ok and not destructive:
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
        d_dp = dp_vids_r.shape[0]
        v_dp = dp_counts0.shape[1] if d_dp else 1
        dp_vids = np.full((d_dp, n_pad), v_dp - 1, np.int32)
        if d_dp:
            dp_vids[:, :n_real] = dp_vids_r

        (pre_res, pre_prio, pre_elig, pre_mp, pre_gid, pre_evf,
         pre_alive0, pre_remaining0, pre_counts0) = _no_preempt_arrays(n_pad)

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

    def _apply_results_dense(self, sched, enc, chosen, scores, pulls) -> None:
        """Record scan results as DenseTGPlacements blocks — one per task
        group, parallel arrays only. Preconditions (checked by the
        caller): enc.dense_ok, every placement chosen."""
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
            sched.plan.dense_placements.append(block)

        sched.ctx.metrics.allocation_time_ns = _time.monotonic_ns() - enc.start_ns

    def _apply_results(self, sched, missing_list, nodes, chosen, scores,
                       pulls, skipped_steps, start_ns) -> None:
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

    numpy only, seeded; returns (n_pad, static, carry, xs)."""
    from .intscore import E27_ONE, TERM_ONE, e27_np, e27_py, pack_feat_planes, xq_np, xq_py

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
