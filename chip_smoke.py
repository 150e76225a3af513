#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card, nvcc
and PyTorch built for CUDA. Phases, each of which fails the run:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under nomad_tpu_torch/tpu/csrc/ compiled with nvcc
   for sm_90a (one nvcc per source, started together);
3. kernel vs plain, int arm: the placement scan kernel against its plain
   PyTorch version on the card, bit for bit, at 5,000 nodes and P = 512
   (1,024 before the preemption slice; cut to make room) for each
   specialization of the step, at n_pad >= 32,768, and B = 3 evals in
   one launch against three single launches;
4. kernel vs plain, float arm: the same variants in float32, held by the
   placement-multiset divergence (bound 0) and the score difference at
   equal picks (``parity.FLOAT_SCORE_TOL``); then, in both arms, B = 8
   evals in one launch (K3) against eight single launches, with times;
   and K3 at n_pad 33,024 with more evals than the card holds clusters
   of the plan's size at once (B = 80, P = 4, int arm): the clusters
   run in waves, bit for bit against single launches, with the cluster
   size and the wave count printed;
5. the forced-node kernel (K4) against its plain version, both arms, bit
   for bit, at 5,000 nodes with P = 5,000 forced nodes, and with two
   device dims and a padded placement axis; then against the scan
   kernel on the same input (the synthetic variant's node capacities);
6. the scan's preemption branch (has_pre, int arm) against its plain
   version, bit for bit, at 5,000 nodes with C = 16 candidate slots: the
   ``preempt`` variant (P = 1,024) and the ``preempt_forced`` variant
   (the system preempt pass, P = 1,250); then B = 3 evals with C = 16, 0
   and 5 in one launch against three single launches;
7. the Harness slice: four evals of the C1M job mix (bench.py
   c1m_mixed_jobs templates 0, 10, 28, and 10 re-registered with its cpu
   raised by 1) through the port's scheduler Harness on CUDA at 5,000
   nodes (int arm); the kernel's launch count must rise, no eval may
   take the unported or fallback gate, every alloc must be placed, and
   the plans must equal the port's own host binpack stack on the same
   state;
8. the server slice, twice: the port's Server at ServerConfig defaults
   (float arm) and with deterministic=True (int arm), 5,000 C1M nodes,
   16 workers, the C1M job mix cut to 60,000 placements; every placement
   committed to the FSM, no node overcommitted, nothing unported or
   fallen back, the arm's kernel launched, a mean eval batch above 1.
   The float run then registers one system job on every node: the
   forced-node kernel's float arm must launch on the default path;
9. the system slice: the port's Server with deterministic=True, 16
   workers, 5,000 nodes of BASELINE config 4's shape (1,200 MHz, 2,048
   MB, every fourth a GPU node), and in order (a) a low-priority fill of
   four service (priority 20) and four batch (40) jobs, ~9.5 allocs a
   node; (b) a system job at priority 60: K4, then the preempt pass
   through the scan's has_pre branch; (c) with service preemption
   switched on, a service job at priority 65 (the generic has_pre
   path); (d) BASELINE config 4's GPU system job, whose preempt subset
   goes to the host per-node loop (device asks), as in the reference.
   Every preemptor's allocs run, every preempted alloc is evicted in the
   FSM, no node is overcommitted, nothing is unported, fallbacks are
   printed with their reasons, K4 and has_pre launched;
10. victim for victim: evals (a)-(c) again through the port's Harness
   at 5,000 nodes, one at a time, placed by tpu_binpack on the card and
   by the host binpack stack from the same state: plans and eviction
   sets (the same victims, in the same order) must be equal;
11. the main paths' kernel inputs replayed (the Harness evals, the last
   batched launch of each server run, every K4 launch, the two has_pre
   launches of the system slice that evicted on the most steps): kernel
   vs plain (int bit for bit, float within the bound), with the kernel's
   time, the plain version's time and the kernel's bound on this card;
   every placement-scan launch of phases 3, 4, 6 and 11 runs at the
   launch plan's cluster size (printed as cs=, with the time a step) and
   again at a forced CS = 1, held bit for bit against it in both arms
   (skipped, with the reason, where the plan allows no CS = 1: n_pad
   33,024); K3's B = 8 batches also at half the plan's cluster size,
   with the clusters the card holds at once by size; the has_pre
   variants and the replays of phase 11 also print their section timing
   (``kernels.place_scan_sections``: cycles a step in each part); after
   phase 6, the K8 sweep: the scan's isqrt64 / coord_q and the spread
   term's floor division through ``kernels.k8_sweep`` against
   ``isqrt_t`` / ``coord_q_t`` / ``torch.div`` on the card, bit for bit,
   over ``kernels.k8_sweep_inputs``' edge cases;
12. the chunked tier (K5, after phase 6): the chunk kernel against its
   plain version on the card (every step's chosen set equal, integer
   outputs exact, scores within 1e-5, top_idx equal over all K slots),
   at the launch plan's cluster size and at a forced CS = 1 held bit
   for bit against it (skipped, with the reason, where the plan allows
   no CS = 1), on bench.py's full C1M chunk run (5,000 nodes, 8 task
   groups, 1,000,000 placements, bulk K = 1,024 then a tail at K = 256
   with 12 retry rounds and the deficit handed over; its threshold ties
   straddle the CTAs' slices), spread + affinity, distinct_hosts, a
   capacity-tight fleet, n_pad 33,024, K = 5,000 at 8,192 nodes and
   K = n_pad at n_pad 32,768, with torch.topk's time on a step's row at
   each K beside it, the C1M run at every cluster size, and the section
   timing (``kernels.chunk_scan_sections``) of the C1M run and of
   n_pad 33,024; then (after phase 8) the server slice at defaults but
   scheduler_algorithm = "tpu_binpack_chunked": every placement
   committed, no node overcommitted, every job's eval through the chunk
   kernel and none fallen back, each chunked eval's inputs moved with
   exactly one (packed) host-to-device copy, run_chunked's host time by
   section, the sampled-parity tally printed; every chunk launch
   replayed kernel vs plain at the plan's CS and at CS = 1, and every
   chunked eval's encode run through the exact float scan kernel to
   print the tier's divergence.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is missing or the script stands outside the repo.
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, and the
# float32 non-tensor rate standing in for integer ALU operations, for
# which the data sheet gives no rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
N_NODES = 5000
# the scan variants of the earlier slices run at half their first depth
# (P = 1,024 in PRs 1-2) to leave room in the time limit
P_SCAN_VARIANT = 512
P_VARIANT = 1024
P_PREEMPT_FORCED = 1250
SERVER_PLACEMENTS = 60_000
SERVER_WORKERS = 16
BATCH_B = 8
DEVICE = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Median device time of ``fn()`` in ms by CUDA events (one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def timed_wall(fn):
    """(result, host ms) of ``fn()`` between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def compare(kernel_out, plain_out, what: str) -> int:
    """Bit-for-bit comparison of (carry, ys) pairs; returns the largest
    absolute score difference (0 when equal) and raises on any mismatch."""
    import torch

    (kc, ky), (pc, py) = kernel_out, plain_out
    names = ("chosen", "scores", "pulls", "skipped", "evict")
    for name, a, b in zip(names, ky, py):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
            bad = (a.cpu() != b.cpu()).nonzero()[:5].flatten().tolist() if a.shape == b.shape else "shape"
            raise AssertionError(f"{what}: kernel {name} differs from plain at {bad}")
    for i, (a, b) in enumerate(zip(kc, pc)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: kernel final carry entry {i} differs from plain")
    return int((ky[1].cpu() - py[1].cpu()).abs().max()) if ky[1].numel() else 0


def run_kernel(kernels, n_pad, static, carry, xs, cs=None):
    return kernels.place_scan(n_pad, static, tuple(c.clone() for c in carry), xs, cs=cs)


def plan_cs(kernels, static, carry, xs, batched=False) -> int:
    """The cluster size the launch plan picks for these inputs."""
    if not batched:
        static, carry, xs = (tuple(t.unsqueeze(0) for t in part) for part in (static, carry, xs))
    return kernels.scan_plan(static, carry, xs).cs


def hold_cs1(launch, ref, what):
    """``launch(cs)`` at a forced CS = 1 held bit for bit (both arms)
    against ``ref``, its output at the plan's CS; returns its ms, or None
    where the plan allows no CS = 1 (the reason printed)."""
    try:
        out = launch(1)
    except ValueError as e:
        log(f"{what}: CS=1 not run: {e}")
        return None
    compare(out, ref, f"{what} at CS=1 against the plan's CS")
    return cuda_ms(lambda: launch(1), reps=1)


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.3f}"


def sections_line(kernels, sb, cb, xb) -> str:
    """Section timing of one launch at the plan's CS: thread 0's clock64
    cycles a step in each part of the step (``kernels.SECTIONS``), the
    mean over the launch's CTAs, per step that ran, with its share."""
    (_, ys), cycles = kernels.place_scan_sections(sb, tuple(t.clone() for t in cb), xb)
    steps = max(int((~ys[3]).sum(dim=1).max()), 1)
    per_cta = cycles.double().flatten(0, 1) / steps
    per = per_cta.mean(dim=0).tolist()
    lo, hi = per_cta.min(dim=0).values.tolist(), per_cta.max(dim=0).values.tolist()
    total = sum(per)
    return "cycles a step, mean [min-max over CTAs] " + " ".join(
        f"{n}={v:.0f} [{a:.0f}-{b:.0f}] ({v / total * 100:.1f}%)"
        for n, v, a, b in zip(kernels.SECTIONS, per, lo, hi))


def run_plain(step, n_pad, static, carry, xs):
    return step.place_scan(n_pad, static, carry, xs)


def plain_batched(step, static_b, carry_b, xs_b, stats_b=None):
    """The plain version of a K3 launch: each eval of the batch in turn
    (``stats_b``: a list that gains each eval's preemption work)."""
    import torch

    outs = []
    for b in range(static_b[0].shape[0]):
        stats = {}
        outs.append(step.place_scan(static_b[0].shape[1], tuple(t[b] for t in static_b),
                                    tuple(t[b] for t in carry_b), tuple(t[b] for t in xs_b),
                                    stats))
        if stats_b is not None:
            stats_b.append(stats)
    carry = tuple(torch.stack(col) for col in zip(*(o[0] for o in outs)))
    ys = tuple(torch.stack(col) for col in zip(*(o[1] for o in outs)))
    return carry, ys


def phase_variants(kernels, step, convert, engine):
    """Kernel vs plain on the card for every specialization of the step."""
    import numpy as np

    worst = 0
    cases = [(v, N_NODES, P_SCAN_VARIANT, 1) for v in engine.SCAN_VARIANTS]
    cases.append(("s1", 33000, 4, 2))  # n_pad >= PACK_COUNT_MAX
    for variant, n_nodes, p, seed in cases:
        n_pad, st, ca, xs = engine.example_scan_variant(
            variant, n_nodes=n_nodes, n_tgs=3, n_placements=p, seed=seed)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        worst = max(worst, compare(k_out, p_out, f"variant {variant} n={n_nodes}"))
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        cs1_ms = hold_cs1(lambda cs: run_kernel(kernels, n_pad, s, c, x, cs), k_out,
                          f"variant {variant} n={n_nodes}")
        placed = int((k_out[1][0] >= 0).sum())
        log(f"variant {variant:18s} n_pad={n_pad} P={p} placed={placed} equal=yes "
            f"cs={plan_cs(kernels, s, c, x)} kernel_ms={k_ms:.3f} per_step_us={k_ms * 1e3 / p:.2f} "
            f"cs1_ms={fmt_ms(cs1_ms)} plain_ms={p_ms:.1f}")

    # B = 3 evals in one launch against three single launches
    evals = [engine.example_scan_variant("all", n_nodes=N_NODES, n_tgs=3,
                                         n_placements=P_SCAN_VARIANT, seed=s)
             for s in (11, 12, 13)]
    n_pad = evals[0][0]
    singles = []
    for _, st, ca, xs in evals:
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        singles.append(run_kernel(kernels, n_pad, s, c, x))
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
    sb, cb, xb = convert.scan_inputs_to_torch(*stacked, DEVICE)
    carry_b, ys_b = kernels.place_scan_batched(sb, tuple(c.clone() for c in cb), xb)
    for b, (sc, sy) in enumerate(singles):
        worst = max(worst, compare(
            (tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b)), (sc, sy),
            f"batched eval {b}"))
    b_ms = cuda_ms(lambda: kernels.place_scan_batched(
        sb, tuple(c.clone() for c in cb), xb))
    cs1_ms = hold_cs1(lambda cs: kernels.place_scan_batched(sb, tuple(c.clone() for c in cb), xb,
                                                            cs=cs), (carry_b, ys_b), "batched B=3")
    log(f"batched B=3 n_pad={n_pad} P={P_SCAN_VARIANT} equal to 3 single launches: yes "
        f"cs={plan_cs(kernels, sb, cb, xb, True)} kernel_ms={b_ms:.3f} "
        f"per_step_us={b_ms * 1e3 / P_SCAN_VARIANT:.2f} cs1_ms={fmt_ms(cs1_ms)}")
    return worst


def phase_float_variants(kernels, step, convert, engine):
    """Float arm: kernel vs plain on the card for every specialization of
    the step (nomad_tpu_torch/tpu/parity.py ``check_float_scan``);
    returns the largest |dscore| at equal picks."""
    import numpy as np

    from nomad_tpu_torch.tpu import parity

    worst = 0.0
    for variant in engine.SCAN_VARIANTS:
        n_pad, st, ca, xs = engine.example_scan_variant(
            variant, n_nodes=N_NODES, n_tgs=3, n_placements=P_SCAN_VARIANT, seed=1,
            dtype=np.float32)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        div, diff, exact = parity.check_float_scan(p_out, k_out, x[0], f"float variant {variant}")
        worst = max(worst, diff)
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        cs1_ms = hold_cs1(lambda cs: run_kernel(kernels, n_pad, s, c, x, cs), k_out,
                          f"float variant {variant}")
        placed = int((k_out[1][0] >= 0).sum())
        log(f"float variant {variant:18s} n_pad={n_pad} P={P_SCAN_VARIANT} placed={placed} "
            f"divergence={div} max_abs_dscore={diff!r} bit_exact={'yes' if exact else 'no'} "
            f"cs={plan_cs(kernels, s, c, x)} kernel_ms={k_ms:.3f} "
            f"per_step_us={k_ms * 1e3 / P_SCAN_VARIANT:.2f} cs1_ms={fmt_ms(cs1_ms)} "
            f"plain_ms={p_ms:.1f}")
    return worst


def phase_batched(kernels, convert, engine):
    """K3: B = 8 evals in one launch against eight single launches, in
    both arms: equal outputs (int bit for bit, float within the bound),
    the batched launch's time against the single launches'."""
    import numpy as np

    from nomad_tpu_torch.tpu import parity

    for arm, dtype in (("int", np.int32), ("float", np.float32)):
        evals = [engine.example_scan_variant("all", n_nodes=N_NODES, n_tgs=3,
                                             n_placements=P_SCAN_VARIANT, seed=s, dtype=dtype)
                 for s in range(21, 21 + BATCH_B)]
        n_pad = evals[0][0]
        singles, single_ms = [], []
        for _, st, ca, xs in evals:
            s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
            singles.append(run_kernel(kernels, n_pad, s, c, x))
            single_ms.append(cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x)))
        stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
        sb, cb, xb = convert.scan_inputs_to_torch(*stacked, DEVICE)
        carry_b, ys_b = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
        worst = 0.0
        for b, (sc, sy) in enumerate(singles):
            got = (tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b))
            if arm == "int":
                compare(got, (sc, sy), f"batched {arm} eval {b}")
            else:
                worst = max(worst, parity.check_float_scan(
                    (sc, sy), got, xb[0][b], f"batched {arm} eval {b}")[1])
        b_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))

        def launch(cs):
            return kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb, cs=cs)

        cs1_ms = hold_cs1(launch, (carry_b, ys_b), f"K3 {arm} B={BATCH_B}")
        # the next cluster size down, held and timed beside the plan's
        cs = plan_cs(kernels, sb, cb, xb, True)
        half_ms = None
        if cs > 1:
            compare(launch(cs // 2), (carry_b, ys_b), f"K3 {arm} B={BATCH_B} at CS={cs // 2}")
            half_ms = cuda_ms(lambda: launch(cs // 2))
        nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, ys_b[3])
        bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S) * 1e3
        resident = {k: kernels.max_active_clusters(
            k, kernels.scan_plan(sb, cb, xb, k).smem_bytes, arm == "int") for k in (16, 8, 4)}
        log(f"K3 {arm} B={BATCH_B}: clusters resident at once by cluster size "
            f"(cudaOccupancyMaxActiveClusters) {json.dumps(resident)}")
        log(f"K3 {arm} B={BATCH_B} n_pad={n_pad} P={P_SCAN_VARIANT}: equal to {BATCH_B} single "
            f"launches (max |dscore| {worst!r}); cs={cs} batched_ms={b_ms:.3f} "
            f"per_step_us={b_ms * 1e3 / P_SCAN_VARIANT:.2f} half_cs_ms={fmt_ms(half_ms)} "
            f"cs1_ms={fmt_ms(cs1_ms)} singles_sum_ms={sum(single_ms):.3f} "
            f"singles_max_ms={max(single_ms):.3f} "
            f"ratio_to_slowest_single={b_ms / max(single_ms):.3f} bytes={nbytes} ops={ops} "
            f"bound_ms={bound_ms:.6f}")


def phase_batched_waves(kernels, convert, engine):
    """K3 at n_pad 33,024 with more evals than the card holds clusters of
    the plan's size at once (int arm, P cut to 4): the launch runs in
    waves and equals single launches of the same evals bit for bit."""
    import numpy as np

    base = [engine.example_scan_variant("all", n_nodes=33000, n_tgs=2, n_placements=4,
                                        seed=80 + i) for i in range(4)]
    n_pad = base[0][0]
    singles, inputs = [], []
    for _, st, ca, xs in base:
        inputs.append(convert.scan_inputs_to_torch(st, ca, xs, DEVICE))
        singles.append(run_kernel(kernels, n_pad, *inputs[-1]))
    B = 80
    for _ in range(2):
        evals = [base[b % len(base)] for b in range(B)]
        stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
        sb, cb, xb = convert.scan_inputs_to_torch(*stacked, DEVICE)
        plan = kernels.scan_plan(sb, cb, xb)
        resident = kernels.max_active_clusters(plan.cs, plan.smem_bytes, True)
        if B > resident:
            break
        B = resident + 1
    waves = kernels.scan_waves(plan, B, True)
    if waves < 2:
        raise AssertionError(f"K3 waves: B={B} fits the {resident} resident clusters")
    carry_b, ys_b = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
    for b in range(B):
        compare((tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b)), singles[b % len(base)],
                f"K3 waves eval {b}")
    b_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))
    single_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, *inputs[0]))
    log(f"K3 waves: B={B} n_pad={n_pad} P=4 cs={plan.cs} resident_clusters={resident} "
        f"waves={waves} equal to single launches bit for bit; batched_ms={b_ms:.3f} "
        f"single_ms={single_ms:.3f}")


def phase_forced(kernels, convert, engine, forced):
    """K4 against its plain version on the card, both arms, at N_NODES
    nodes with one forced node per node (P = N_NODES), and with two
    device dims and a padded placement axis; then against the scan
    kernel on the same input. Returns the records of the launches."""
    import numpy as np
    import torch

    recs = []
    for dtype, device_dims, pad in ((np.int32, 0, False), (np.float32, 0, False),
                                    (np.int32, 2, True), (np.float32, 2, True)):
        arm = "int" if dtype == np.int32 else "float"
        n_pad, st, ca, xs = engine.example_forced_variant(
            n_nodes=N_NODES, n_placements=N_NODES, seed=5, dtype=dtype, device_dims=device_dims)
        if pad:
            p = xs[0].shape[0]
            p_pad = engine._round_up(p + 1)
            fills = (0, -1, -1, 0, -1, 0, 0, 0, 0, -1)
            xs = tuple(np.pad(a, ((0, p_pad - p),) + ((0, 0),) * (a.ndim - 1), constant_values=f)
                       for a, f in zip(xs, fills))
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        got = kernels.forced_eval(s, c, x)
        plain, p_ms = timed_wall(lambda: forced.forced_eval(s, c, x))
        for name, a, b in zip(("chosen", "scores", "pulls", "skipped", "evict"), got, plain):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"K4 {arm} D={4 + device_dims}: kernel {name} differs from plain")
        _, scan = kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x)
        if not (torch.equal(got[0].cpu(), scan[0].cpu()) and torch.equal(got[1].cpu(), scan[1].cpu())):
            raise AssertionError(f"K4 {arm} D={4 + device_dims}: kernel differs from the scan kernel")
        k_ms = cuda_ms(lambda: kernels.forced_eval(s, c, x), reps=21)
        scan_ms = cuda_ms(lambda: kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x))
        nbytes, ops = kernels.forced_eval_work(s, c, x)
        placed = int((got[0] >= 0).sum())
        recs.append((arm, k_ms, p_ms, nbytes, ops))
        log(f"K4 {arm} D={4 + device_dims} P={x[0].shape[0]} n_pad={n_pad} placed={placed} "
            f"equal to plain and to the scan kernel: yes kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.2f} scan_kernel_ms={scan_ms:.3f} bytes={nbytes} ops={ops}")
    return recs


def phase_has_pre(kernels, step, convert, engine):
    """The scan's preemption branch (int arm) against its plain version on
    the card, bit for bit: the ``preempt`` variant (P = 1,024) and the
    ``preempt_forced`` variant (P = 1,250) at N_NODES nodes with C = 16;
    then B = 3 evals of mixed candidate widths (C = 16, 0, 5) in one launch
    against three single launches."""
    import numpy as np

    from nomad_tpu_torch.tpu.batcher import pad_encoded
    from nomad_tpu_torch.tpu.engine import EncodedEval

    for variant, p in (("preempt", P_VARIANT), ("preempt_forced", P_PREEMPT_FORCED)):
        n_pad, st, ca, xs = engine.example_scan_variant(
            variant, n_nodes=N_NODES, n_tgs=3, n_placements=p, seed=1)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        stats = {}
        p_out, p_ms = timed_wall(lambda: step.place_scan(n_pad, s, c, x, stats))
        compare(k_out, p_out, f"has_pre variant {variant}")
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        cs1_ms = hold_cs1(lambda cs: run_kernel(kernels, n_pad, s, c, x, cs), k_out,
                          f"has_pre variant {variant}")
        nbytes, ops = kernels.place_scan_work(s, c, x, k_out[1][3], stats)
        evicting = int((k_out[1][4] >= 0).any(dim=1).sum())
        log(f"has_pre variant {variant:15s} n_pad={n_pad} P={p} C={st[20].shape[1]} "
            f"placed={int((k_out[1][0] >= 0).sum())} evicting_steps={evicting} equal=yes "
            f"cs={plan_cs(kernels, s, c, x)} kernel_ms={k_ms:.3f} per_step_ms={k_ms / p:.4f} "
            f"cs1_ms={fmt_ms(cs1_ms)} plain_ms={p_ms:.1f} "
            f"greedy_rows={stats.get('greedy_rows', 0)} greedy_keys={stats.get('greedy_keys', 0)} "
            f"bytes={nbytes} ops={ops} bound_ms={max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S) * 1e3:.6f}")
        log(f"  has_pre variant {variant}: " + sections_line(
            kernels, *(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x))))

    def enc_of(variant, seed, c=None):
        n_pad, st, ca, xs = engine.example_scan_variant(
            variant, n_nodes=N_NODES, n_tgs=3, n_placements=P_VARIANT, seed=seed)
        if c is not None:
            st = st[:20] + tuple(a[:, :c] for a in st[20:])
            ca = ca[:9] + (ca[9][:, :c],) + ca[10:]
        return EncodedEval(n_real=N_NODES, n_pad=n_pad, g=3, s=st[9].shape[1],
                           v=st[10].shape[2], p=P_VARIANT, dtype=np.int32, static=st,
                           carry=ca, xs=xs, missing_list=[], nodes=[], table=None, start_ns=0)

    encs = [enc_of("preempt", 31), enc_of("s1", 32), enc_of("preempt", 33, c=5)]
    singles = [run_kernel(kernels, e.n_pad, *convert.scan_inputs_to_torch(
        e.static, e.carry, e.xs, DEVICE)) for e in encs]
    e0 = encs[0]
    # n, g, s, v, p, dtype, d, k, aff, evict dims, factors, dp, dp vocab,
    # forced, candidate slots, count groups
    pads = (e0.n_pad, 4, 1, 8, P_VARIANT, np.int32, 4, 0, 0, 0, 0, 0, 1, 0, 16, 8)
    padded = [pad_encoded(e, *pads) for e in encs]
    stacked = [tuple(np.stack(col) for col in zip(*(q[k] for q in padded))) for k in range(3)]
    sb, cb, xb = convert.scan_inputs_to_torch(*stacked, DEVICE)
    carry_b, ys_b = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
    for b, (sc, sy) in enumerate(singles):
        cw = sy[4].shape[1]
        for name, a, bb in zip(("chosen", "scores", "pulls", "skipped"), ys_b[:4], sy[:4]):
            if not torch_equal(a[b], bb):
                raise AssertionError(f"has_pre B=3 eval {b}: {name} differs from its single launch")
        if not torch_equal(ys_b[4][b][:, :cw], sy[4]) or not bool((ys_b[4][b][:, cw:] == -1).all()):
            raise AssertionError(f"has_pre B=3 eval {b}: evict differs from its single launch")
    b_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))
    cs1_ms = hold_cs1(lambda cs: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb,
                                                            cs=cs), (carry_b, ys_b), "has_pre B=3")
    log(f"has_pre B=3 (C = 16, 0, 5) n_pad={e0.n_pad} P={P_VARIANT}: equal to 3 single "
        f"launches: yes cs={plan_cs(kernels, sb, cb, xb, True)} batched_ms={b_ms:.3f} "
        f"per_step_us={b_ms * 1e3 / P_VARIANT:.2f} cs1_ms={fmt_ms(cs1_ms)}")


def phase_k8(kernels):
    """The scan's exact integer device functions (isqrt64, coord_q,
    floordiv_pos: double precision with an integer fix-up) against
    preempt.isqrt_t / coord_q_t and torch's floor division on the card,
    bit for bit, over ``kernels.k8_sweep_inputs``' edge cases."""
    import torch

    from nomad_tpu_torch.tpu import preempt

    n, needed, res, num, den = (torch.from_numpy(a).to(DEVICE)
                                for a in kernels.k8_sweep_inputs(0))
    isq, cq, fq = kernels.k8_sweep(n, needed, res, num, den)
    want_isq, want_cq = preempt.isqrt_t(n), preempt.coord_q_t(needed, res)
    want_fq = torch.div(num, den, rounding_mode="floor")
    for name, got, want in (("isqrt", isq, want_isq), ("coord_q", cq, want_cq),
                            ("floordiv", fq, want_fq)):
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"K8 {name} differs from plain at {bad}")
    clipped = int((want_cq.abs() == preempt.CQ_CAP).sum())
    log(f"K8 sweep: {n.numel()} square roots (k^2, k^2 - 1, k^2 + 2k near 0 and 2^31, "
        f"2^62 - 1, random), {needed.numel()} Q16 coordinates ({int((want_cq < 0).sum())} "
        f"negative, {clipped} clipped) and {num.numel()} floor divisions (numerators around "
        f"+-2^53 and up to 2^62) equal to isqrt_t / coord_q_t / torch.div")


C1M_PLACEMENTS = 1_000_000
C1M_TGS = 8
BULK_K, TAIL_K, TAIL_RETRY_ROUNDS = 1024, 256, 12


def c1m_chunk_schedules(chunk):
    """bench.py ``bench_c1m_chunked`` (:232-258): 1,000,000 placements
    over 8 task groups, 88 % of each in bulk chunks of K = 1,024, the rest
    in tail chunks of K = 256 with 12 retry rounds."""
    per_tg = C1M_PLACEMENTS // C1M_TGS
    bulk = int(per_tg * 0.88)
    xs_bulk = chunk.chunk_schedule([(g, bulk) for g in range(C1M_TGS)], BULK_K)
    xs_tail = chunk.chunk_schedule([(g, per_tg - bulk) for g in range(C1M_TGS)], TAIL_K,
                                   retry_rounds=TAIL_RETRY_ROUNDS)
    return xs_bulk, xs_tail


def run_chunk_phases(chunk_fn, n_pad, static, carry, phases, cs=None):
    """Run ``phases`` ([(xs, K)]) in order through ``chunk_fn`` (the
    kernel's wrapper, at the plan's cluster size or a forced ``cs``, or
    the plain version), each fed the carry and the deficit of the one
    before; returns [(carry, deficit, ys)] per phase. The given carry is
    not modified."""
    carry = tuple(t.clone() for t in carry)
    deficit, outs = None, []
    for xs, k in phases:
        kw = {} if cs is None else {"cs": cs}
        carry, deficit, ys = chunk_fn(n_pad, static, carry, xs, deficit, chunk=k, **kw)
        outs.append((carry, deficit, ys))
        carry = tuple(t.clone() for t in carry)
        deficit = deficit.clone()
    return outs


def chunk_equal(a, b) -> bool:
    """Two K5 runs' outputs, carries and deficits the same bits."""
    return all(torch_equal(x, y) for (ca, da, ya), (cb, db, yb) in zip(a, b)
               for x, y in zip((*ca[:4], da, *ya), (*cb[:4], db, *yb)))


def chunk_sections_line(kernels, n_pad, s, c, ph) -> str:
    """Section timing of a K5 run at the plan's CS: thread 0's clock64
    cycles a step in each part (``kernels.CHUNK_SECTIONS``), summed over
    the run's phases, mean over the CTAs [min-max], with the share."""
    carry, deficit, total, steps = tuple(t.clone() for t in c), None, None, 0
    for xs, k in ph:
        (carry, deficit, _), cycles = kernels.chunk_scan_sections(n_pad, s, carry, xs, deficit,
                                                                   chunk=k)
        total = cycles if total is None else total + cycles
        steps += int(xs[0].shape[0])
    per_cta = total.double() / max(steps, 1)
    per = per_cta.mean(dim=0).tolist()
    lo, hi = per_cta.min(dim=0).values.tolist(), per_cta.max(dim=0).values.tolist()
    whole = sum(per)
    return (f"cs={total.shape[0]} cycles a step, mean [min-max over CTAs] " + " ".join(
        f"{n}={v:.0f} [{a:.0f}-{b:.0f}] ({v / whole * 100:.1f}%)"
        for n, v, a, b in zip(kernels.CHUNK_SECTIONS, per, lo, hi)) + f" total={whole:.0f}")


def threshold_slices(kernels, chunk, s, c, xs, k) -> int:
    """How many of the plan's CTA slices hold a node whose key equals the
    first step's K-th largest key (the threshold's ties)."""
    import torch

    key = chunk.score_key(chunk.masked_scores(s, c, int(xs[0][0])))
    thr = torch.sort(key, descending=True).values[k - 1]
    tied = torch.nonzero(key == thr).flatten().cpu()
    plan = kernels.chunk_scan_plan(s, k)
    return len({int(i) // plan.per for i in tied})


def phase_chunk_variants(kernels, chunk, convert, engine, parity):
    """K5 against its plain version on the card (``parity.check_chunk_scan``:
    every step's chosen set equal, integer outputs and integer-valued
    carries exact, scores within 1e-5, top_idx equal over all K slots),
    at the launch plan's cluster size and again at a forced CS = 1 held
    bit for bit against it: the full C1M chunk run of bench.py (5,000
    nodes, 8 task groups, 1,000,000 placements, bulk K = 1,024 then a
    tail at K = 256 with 12 retry rounds and the bulk's deficit handed
    over; C1M's mock nodes tie exactly, so the threshold's ties straddle
    the CTAs' slices), spread + affinity, distinct_hosts, a
    capacity-tight fleet whose deficit drains through retry rounds,
    n_pad 33,024, K = 5,000 at 8,192 nodes (past the shared-memory list),
    K = n_pad at n_pad 1,024 and at n_pad 32,768 (a few steps; CS = 1 is
    held at every case but the last, whose slice one CTA cannot hold,
    and nowhere else may the plan refuse it). Prints the placed
    count, the kernel's ms at the plan's CS and at CS = 1, the plain
    version's ms, the bound, torch.topk's time on a step's row at each K
    (a yardstick for the selection alone), the C1M run at every cluster
    size, and the section timing of the C1M run and of n_pad 33,024.
    Returns (worst |dscore|, records)."""
    import torch

    xs_bulk, xs_tail = c1m_chunk_schedules(chunk)
    cases = [
        ("c1m", N_NODES, C1M_TGS, [(xs_bulk, BULK_K), (xs_tail, TAIL_K)]),
        ("spread_affinity", N_NODES, 3,
         [(chunk.chunk_schedule([(0, 3000), (1, 2000), (2, 1000)], 128, retry_rounds=2), 128)]),
        ("distinct_hosts", N_NODES, 2,
         [(chunk.chunk_schedule([(0, 2500), (1, 2500)], 256, retry_rounds=2), 256)]),
        ("tight", N_NODES, 2,
         [(chunk.chunk_schedule([(0, 100), (1, 80)], 128), 128),
          (chunk.chunk_schedule([(0, 20), (1, 20)], 64, retry_rounds=4), 64)]),
        ("open", 33000, 2,
         [(chunk.chunk_schedule([(0, 20000), (1, 15000)], 1024, retry_rounds=2), 1024)]),
        ("c1m", 8192, 2,
         [(chunk.chunk_schedule([(0, 9000), (1, 6000)], 5000, retry_rounds=1), 5000)]),
        ("spread_affinity", 1024, 2,
         [(chunk.chunk_schedule([(0, 1500), (1, 900)], 1024, retry_rounds=1), 1024)]),
        ("open", 32768, 1,
         [(chunk.chunk_schedule([(0, 40000)], 32768, retry_rounds=1), 32768)]),
    ]
    worst, recs = 0.0, []
    for variant, n_nodes, n_tgs, phases in cases:
        n_pad, st, ca = engine.example_chunk_variant(variant, n_nodes=n_nodes, n_tgs=n_tgs,
                                                     seed=0)
        s, c, _ = convert.scan_inputs_to_torch(st, ca, (), DEVICE)
        ph = [(convert.to_torch(xs, DEVICE), k) for xs, k in phases]
        what = f"K5 {variant} n_pad={n_pad} K={[k for _, k in ph]}"
        got = run_chunk_phases(kernels.chunk_scan, n_pad, s, c, ph)
        plain, p_ms = timed_wall(lambda: run_chunk_phases(chunk.chunk_scan, n_pad, s, c, ph))
        for i, (ref, out) in enumerate(zip(plain, got)):
            div, diff, all_slots, exact = parity.check_chunk_scan(ref, out, f"{what} phase {i}")
            if not all_slots:
                raise AssertionError(f"{what} phase {i}: top_idx differs from plain")
            worst = max(worst, diff)
        k_ms = cuda_ms(lambda: run_chunk_phases(kernels.chunk_scan, n_pad, s, c, ph))
        k_max = max(k for _, k in ph)
        cs = kernels.chunk_scan_plan(s, k_max).cs
        try:
            kernels.chunk_scan_plan(s, k_max, 1)
        except ValueError as e:
            # only K = n_pad past one CTA's shared memory (32,768 keys
            # and as many placed nodes) may go without the CS = 1 hold
            if k_max != n_pad or n_pad < 32768:
                raise AssertionError(f"{what}: the plan refuses CS=1: {e}") from e
            log(f"{what}: CS=1 not run (the plan refuses it: {e})")
            cs1_ms = None
        else:
            at1 = run_chunk_phases(kernels.chunk_scan, n_pad, s, c, ph, cs=1)
            if not chunk_equal(at1, got):
                raise AssertionError(f"{what}: CS=1 differs from the plan's CS={cs}")
            cs1_ms = cuda_ms(lambda: run_chunk_phases(kernels.chunk_scan, n_pad, s, c, ph, cs=1),
                             reps=1)
        steps = sum(int(xs[0].shape[0]) for xs, _ in ph)
        placed = sum(int(out[2][3].sum()) for out in got)
        nbytes = ops = 0
        for (xs, k), out in zip(ph, got):
            nb, op = kernels.chunk_scan_work(s, c, xs, k, out[2][3])
            nbytes, ops = nbytes + nb, ops + op
        b_ms, b_by = bound(nbytes, ops)
        # torch.topk over the first step's masked row at each K of the run
        row = chunk.masked_scores(s, c, int(ph[0][0][0][0]))
        topk = {k: cuda_ms(lambda: torch.topk(row, k), reps=21) for k in sorted({k for _, k in ph})}
        rec = {"variant": variant, "n_pad": n_pad, "steps": steps, "placed": placed,
               "deficit": int(got[-1][1].sum()), "kernel_ms": k_ms, "cs": cs, "cs1_ms": cs1_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "topk_ms": topk,
               "max_abs_err": worst}
        recs.append(rec)
        log(f"{what:40s} G={n_tgs} steps={steps} placed={placed} deficit_left={rec['deficit']} "
            f"equal=yes (top_idx all slots, bit_exact={'yes' if exact else 'no'}"
            f"{'' if cs1_ms is None else '; CS=1 bit for bit'}) cs={cs} kernel_ms={k_ms:.3f} per_step_ms={k_ms / max(steps, 1):.4f} "
            f"cs1_ms={fmt_ms(cs1_ms)} plain_ms={p_ms:.1f} bytes={nbytes} ops={ops} "
            f"bound_ms={b_ms:.6f} ({b_by}) torch_topk_ms (one step's row) "
            + " ".join(f"K={k}:{v:.4f}" for k, v in topk.items()))
        if variant == "c1m" and n_nodes == N_NODES:
            log(f"K5 c1m: {placed} of {C1M_PLACEMENTS} placements in {k_ms:.3f} ms of kernel "
                f"({placed / k_ms * 1000:.0f} placements/s on the card); the first step's "
                f"threshold ties span {threshold_slices(kernels, chunk, s, c, ph[0][0], BULK_K)} "
                f"of {cs} slices")
            if placed != C1M_PLACEMENTS:
                raise AssertionError(f"K5 c1m placed {placed} of {C1M_PLACEMENTS}")
            by_cs = {}
            for k_cs in (1, 2, 4, 8, 16):
                by_cs[k_cs] = cuda_ms(lambda: run_chunk_phases(kernels.chunk_scan, n_pad, s, c,
                                                               ph, cs=k_cs), reps=1)
            log("K5 c1m: ms of the run by cluster size " + json.dumps(
                {k_cs: round(v, 3) for k_cs, v in by_cs.items()}))
        if (variant == "c1m" and n_nodes == N_NODES) or n_pad == 33024:
            log(f"  {what}: {chunk_sections_line(kernels, n_pad, s, c, ph)}")
        if variant == "tight" and not (int(got[0][1].sum()) > 0
                                       and placed > int(got[0][2][3].sum())):
            raise AssertionError("K5 tight: the bulk left no deficit, or the tail placed none of it")
    return worst, recs


def packed_ms(kernels, fresh, cs=None, reps: int = 3) -> float:
    """Device ms of one ``kernels.chunk_scan_packed`` launch (the chunked
    server's own wrapper) at the plan's CS or a forced ``cs``, each on
    its own copy of the packed buffer ``fresh``, made before the timing
    (a launch updates the buffer's carry in place)."""
    import dataclasses

    bufs = [dataclasses.replace(fresh, buf=fresh.buf.clone()) for _ in range(reps + 1)]
    return cuda_ms(lambda: kernels.chunk_scan_packed(bufs.pop(), cs), reps)


def packed_results(packed, out, out_layout):
    """A packed K5 launch's outputs (top_idx, top_scores, valid, placed),
    then the carry's first four arrays and the deficit it left in its
    buffer, as numpy arrays."""
    from nomad_tpu_torch.tpu.convert import from_device_packed, to_numpy

    _s, carry, _x, deficit = packed.parts()
    return (*from_device_packed(out, out_layout), *to_numpy((*carry[:4], deficit)))


def replay_chunked(kernels, chunk, parity, spy):
    """Every chunk launch of the chunked server run. The main path's own
    results (the outputs of its ``kernels.chunk_scan_packed`` call and
    the carry and deficit that call left in its packed buffer) are held
    against the plain version on the same inputs; then the launch is
    replayed through the same wrapper on a buffer packed anew
    (``kernels.pack_chunk_inputs``) from the same inputs, at the plan's
    CS and at a forced CS = 1, each bit for bit against the main path's,
    and timed there (the kernels line's chunk_scan ms), with the first
    launch at every cluster size and its section timing; every chunked
    eval made exactly one (packed) host-to-device copy; then each
    chunked eval's encode through the exact float scan kernel, and the
    tier's per-eval divergence from it (the sampled parity at rate 1).
    Returns (per-launch (kernel ms, plain ms, bound ms, bound by), worst
    |dscore|)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.tpu.convert import scan_inputs_to_torch, to_numpy, to_torch

    def same(a, b):
        return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))

    rows, worst, cs1 = [], 0.0, []
    for i, (args, packed, out, out_layout) in enumerate(spy.chunked):
        n_pad, k = packed.n_pad, packed.dims["K"]
        main = packed_results(packed, out, out_layout)
        # the plain version on the launch's inputs: (n_pad, static, carry,
        # xs, deficit) as run_chunked packed them
        s, c, x, (d,) = (to_torch(part, DEVICE) for part in (*args[1:4], args[4:5]))
        plain, p_ms = timed_wall(lambda: chunk.chunk_scan(n_pad, s, c, x, d, chunk=k))
        div, diff, all_slots, _ = parity.check_chunk_scan(
            plain, (main[4:8], main[8], main[:4]), f"chunk launch {i}")
        if not all_slots:
            raise AssertionError(f"chunk launch {i}: top_idx differs from plain")
        worst = max(worst, diff)
        fresh = kernels.pack_chunk_inputs(*args, k, DEVICE)
        for forced in (None, 1):
            again = kernels.pack_chunk_inputs(*args, k, DEVICE)
            if not same(packed_results(again, *kernels.chunk_scan_packed(again, forced)), main):
                raise AssertionError(f"chunk launch {i}: the replay at "
                                     f"{'the plan' if forced is None else 'CS=1'} differs "
                                     f"from the main path's launch")
        k_ms = packed_ms(kernels, fresh)
        cs1.append(packed_ms(kernels, fresh, 1, reps=1))
        nbytes, ops = kernels.chunk_scan_work(s, c, x, k, torch.from_numpy(main[3]))
        b_ms, b_by = bound(nbytes, ops)
        rows.append((k_ms, p_ms, b_ms, b_by))
        if i == 0:
            by_cs = {k_cs: packed_ms(kernels, fresh, k_cs) for k_cs in (1, 2, 4, 8, 16)}
            log(f"chunked server launch 0: n_pad={n_pad} K={k} steps={x[0].shape[0]} ms by "
                f"cluster size {json.dumps({a: round(b, 4) for a, b in by_cs.items()})}")
            log(f"  chunked server launch 0: {chunk_sections_line(kernels, n_pad, s, c, [(x, k)])}")
            plan_cs = kernels.chunk_scan_plan(s, k).cs
    log(f"chunked server: {len(rows)} chunk launches: the main path's outputs, carry and "
        f"deficit equal to plain on every step, and replayed through chunk_scan_packed at the "
        f"plan's CS and at CS=1 bit for bit; cs={plan_cs} (launch 0) mean kernel_ms="
        f"{sum(r[0] for r in rows) / len(rows):.4f} mean cs1_ms={sum(cs1) / len(cs1):.4f} "
        f"mean plain_ms={sum(r[1] for r in rows) / len(rows):.2f} mean bound_ms="
        f"{sum(r[2] for r in rows) / len(rows):.6f} ({rows[0][3]}) max |dscore| {worst!r}")
    # run_chunked on the host clock, by section, with the 16 workers
    # running: the check and the one packed copy to the card, the
    # launch, the one copy back with its synchronize, the rest (the
    # schedule and the FIFO expansion)
    copies = [cp for _, _, _, cp in spy.chunk_evals]
    if any(cp != {"packed": 1, "loose": 0} for cp in copies):
        raise AssertionError(f"chunked evals' host-to-device copies: {copies}")
    log(f"chunked server: every one of {len(copies)} chunked evals made one packed "
        f"host-to-device copy and no other")
    secs = {name: sorted(rec.get(name, 0.0) for _, _, rec, _ in spy.chunk_evals)
            for name in ("total", "h2d", "launch", "d2h")}
    secs["rest"] = sorted(rec["total"] - sum(v for n, v in rec.items() if n != "total")
                          for _, _, rec, _ in spy.chunk_evals)
    log("chunked server: run_chunked host ms per eval (median / max / sum over "
        f"{len(spy.chunk_evals)} evals): " + "; ".join(
            f"{name} {v[len(v) // 2]:.2f} / {v[-1]:.2f} / {sum(v):.1f}" for name, v in secs.items()))
    divs, total = [], 0
    for enc, chosen, _rec, _cp in spy.chunk_evals:
        static, carry, xs = scan_inputs_to_torch(enc.static, enc.carry, enc.xs, DEVICE)
        _, ys = kernels.place_scan(enc.n_pad, static, carry, xs)
        ref = to_numpy(ys)[0][: enc.p]
        divs.append(parity.tg_multiset_divergence(chosen[: enc.p], ref,
                                                  np.asarray(enc.xs[0])[: enc.p]))
        total += int(enc.p)
    log(f"chunked tier vs the exact float scan kernel on every chunked eval's encode: "
        f"{len(divs)} evals, {sum(divs)} of {total} placements on other nodes "
        f"(rate {sum(divs) / max(total, 1):.4f}); per eval {json.dumps(divs)}")
    return rows, worst


def torch_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def config4_nodes(mock, n_nodes):
    """BASELINE config 4's fleet (bench.py:1074-1087): every node dc1 and
    linux with 1,200 MHz and 2,048 MB, every fourth a mock.nvidia_node()
    (one GPU device group of two instances); ids from the index."""
    nodes = []
    for i in range(n_nodes):
        n = mock.nvidia_node() if i % 4 == 0 else mock.node()
        n.id = f"0000c4c4-0000-4000-8000-{i:012d}"
        n.name = f"sys-{i}"
        n.datacenter = "dc1"
        n.attributes["kernel.name"] = "linux"
        n.node_resources.cpu_shares = 1200
        n.node_resources.memory_mb = 2048
        n.compute_class()
        nodes.append(n)
    return nodes


def preempt_jobs(mock, structs, n_nodes):
    """The system slice's jobs, in order: (a) the fill, four service jobs
    at priority 20 and four batch jobs at 40 of 100 MHz / 160 MB allocs,
    ~9.5 a node (a full node holds 11); (b) a system job at priority 60
    with no device ask (300 MHz / 256 MB); (c) a service job at priority
    65 (1,000 allocs of 200 MHz / 256 MB; the system job's allocs are
    within the priority delta of 10, so only the fill is preemptible);
    (d) BASELINE config 4's GPU system job (bench.py:1062-1071: priority
    80, 600 MHz / 256 MB, one GPU). Returns [(phase, job, kind)]."""
    def batch_or_service(kind, job_id, prio, count, cpu, mem):
        j = mock.job() if kind == "service" else mock.batch_job()
        j.id = job_id
        j.priority = prio
        tg = j.task_groups[0]
        tg.count = count
        tg.ephemeral_disk.size_mb = 50
        tg.tasks[0].resources = structs.Resources(cpu=cpu, memory_mb=mem)
        return j

    per_job = int(n_nodes * 9.5) // 8
    out = []
    for k in range(4):
        out.append(("a", batch_or_service("service", f"fill-svc-{k}", 20, per_job, 100, 160),
                    "service"))
        out.append(("a", batch_or_service("batch", f"fill-batch-{k}", 40, per_job, 100, 160),
                    "batch"))
    mid = mock.system_job()
    mid.id = "sys-mid"
    mid.priority = 60
    mid.task_groups[0].tasks[0].resources = structs.Resources(cpu=300, memory_mb=256)
    out.append(("b", mid, "system"))
    out.append(("c", batch_or_service("service", "svc-high", 65, n_nodes // 5, 200, 256),
                "service"))
    gpu = mock.system_job()
    gpu.id = "sys-gpu"
    gpu.priority = 80
    gpu.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=600, memory_mb=256, devices=[structs.RequestedDevice(name="gpu", count=1)])
    out.append(("d", gpu, "system"))
    return out


def preemption_config(structs, service: bool):
    """The SchedulerConfiguration of the slice: tpu_binpack, system
    preemption on (the default), service preemption as asked."""
    return structs.SchedulerConfiguration(
        scheduler_algorithm="tpu_binpack",
        preemption_config=structs.PreemptionConfig(
            system_scheduler_enabled=True, service_scheduler_enabled=service))


class _Spy:
    """Counters and fallback reasons of a run, and the kernel inputs its
    main path launched with (restored on exit)."""

    def __init__(self, kernels):
        import logging

        from nomad_tpu_torch.utils import metrics

        import threading

        from nomad_tpu_torch.tpu import convert, engine

        self.kernels, self.metrics, self.engine_mod = kernels, metrics, engine
        self.convert = convert
        self.engine_cls = engine.TorchPlacementEngine
        self.counted, self.reasons = [], []
        self.batched, self.forced = [], []
        # run_chunked's launches: (its pack_chunk_inputs arguments but the
        # chunk size, by reference: numpy arrays nothing writes; the
        # packed inputs, which the launch updated; the launch's output
        # buffer and its layout);
        # chunked evals: (encode, expanded chosen, host ms of run_chunked
        # by section: h2d, launch, d2h, total; the copies it made: packed
        # host-to-device copies, loose ones)
        self.chunked, self.chunk_evals = [], []
        self._tls = threading.local()
        spy = self

        class Reasons(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "fallback" in msg or "to host" in msg or "ineligible" in msg:
                    spy.reasons.append(msg)

        self.handler = Reasons(level=logging.DEBUG)
        self.logger = logging.getLogger("nomad_tpu.tpu.engine")

    def _section(self, name, t0):
        """Add the host ms since ``t0`` to section ``name`` of the
        calling thread's run_chunked, if it is inside one."""
        rec = getattr(self._tls, "rec", None)
        if rec is not None:
            rec[name] = rec.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _copy(self, kind):
        """Count one host-to-device copy of ``kind`` (packed or loose) in
        the calling thread's run_chunked, if it is inside one."""
        copies = getattr(self._tls, "copies", None)
        if copies is not None:
            copies[kind] += 1

    def __enter__(self):
        k, em = self.kernels, self.engine_mod
        self.orig = (self.metrics.incr_counter, k.place_scan_batched, k.forced_eval,
                     k.pack_chunk_inputs, k.chunk_scan_packed, self.engine_cls.run_chunked,
                     self.convert.to_device_packed, em.from_device_packed,
                     em.scan_inputs_to_torch)
        (orig_incr, orig_batched, orig_forced, orig_pack, orig_chunk, orig_run_chunked,
         orig_h2d, orig_d2h, orig_loose) = self.orig

        def count(name, value=1.0):
            self.counted.append(name)
            orig_incr(name, value)

        def batched(static_b, carry_b, xs_b, cs=None):
            inputs = tuple(tuple(t.clone() for t in part) for part in (static_b, carry_b, xs_b))
            out = orig_batched(static_b, carry_b, xs_b, cs=cs)
            # with the number of steps that evicted
            self.batched.append((inputs, int((out[1][4] >= 0).any(dim=-1).sum())))
            return out

        def forced(static, carry, xs):
            self.forced.append(tuple(tuple(t.clone() for t in part)
                                     for part in (static, carry, xs)))
            return orig_forced(static, carry, xs)

        def pack_chunk_inputs(n_pad, static, carry, xs, deficit, chunk, device="cuda"):
            # run_chunked's inputs: checked and copied to the card
            t0 = time.perf_counter()
            out = orig_pack(n_pad, static, carry, xs, deficit, chunk, device)
            self._section("h2d", t0)
            self._tls.args = (n_pad, static, carry, xs, deficit)
            return out

        def chunk_scan_packed(packed, cs=None):
            # run_chunked's launch, with its inputs and outputs kept
            t0 = time.perf_counter()
            out = orig_chunk(packed, cs)
            self._section("launch", t0)
            self.chunked.append((self._tls.args, packed, *out))
            return out

        def h2d(*args, **kwargs):
            self._copy("packed")
            return orig_h2d(*args, **kwargs)

        def loose(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_loose(*args, **kwargs)
            self._section("loose_h2d", t0)
            self._copy("loose")
            return out

        def d2h(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_d2h(*args, **kwargs)
            self._section("d2h", t0)
            return out

        def run_chunked(engine, enc, *args, **kwargs):
            rec, copies = {}, {"packed": 0, "loose": 0}
            self._tls.rec, self._tls.copies = rec, copies
            t0 = time.perf_counter()
            try:
                out = orig_run_chunked(engine, enc, *args, **kwargs)
            finally:
                self._tls.rec = self._tls.copies = None
            rec["total"] = (time.perf_counter() - t0) * 1e3
            self.chunk_evals.append((enc, out[0].copy(), rec, copies))
            return out

        self.metrics.incr_counter = count
        # kernels.place_scan launches through kernels.place_scan_batched
        (k.place_scan_batched, k.forced_eval, k.pack_chunk_inputs,
         k.chunk_scan_packed) = batched, forced, pack_chunk_inputs, chunk_scan_packed
        self.engine_cls.run_chunked = run_chunked
        self.convert.to_device_packed = h2d
        em.from_device_packed, em.scan_inputs_to_torch = d2h, loose
        self.logger.addHandler(self.handler)
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        k.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.launches = dict(self.kernels.LAUNCHES)
        k = self.kernels
        (self.metrics.incr_counter, k.place_scan_batched, k.forced_eval, k.pack_chunk_inputs,
         k.chunk_scan_packed, self.engine_cls.run_chunked, self.convert.to_device_packed,
         self.engine_mod.from_device_packed, self.engine_mod.scan_inputs_to_torch) = self.orig
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False

    def count(self, name):
        return self.counted.count(name)


def phase_system_server(kernels, seed: int):
    """The system slice through the port's Server with deterministic=True
    (int arm), 16 Workers, BASELINE config 4's fleet at N_NODES nodes and
    the jobs of ``preempt_jobs`` registered phase by phase, each phase
    waited on before the next; service preemption is switched on by a
    raft-applied SchedulerConfiguration before (c). Returns the record
    and the spy (the main path's launches and their inputs)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server.fsm import NODE_REGISTER, SCHEDULER_CONFIG
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit
    from nomad_tpu_torch.utils import phases

    server = Server(ServerConfig(num_schedulers=0, deterministic=True, device=DEVICE),
                    name="smoke-system")
    rec = {"phases": {}}
    try:
        server.start()
        server.raft_apply(SCHEDULER_CONFIG, preemption_config(structs, service=False))
        nodes = config4_nodes(mock, N_NODES)
        for n in nodes:
            server.raft_apply(NODE_REGISTER, n)
        gpu_nodes = sum(1 for n in nodes if n.node_resources.devices)
        for i in range(SERVER_WORKERS):
            w = Worker(server, i)
            server.workers.append(w)
            w.start()
        jobs = preempt_jobs(mock, structs, N_NODES)
        state = server.fsm.state

        def running(job_id):
            return sum(1 for a in state.allocs_by_job("default", job_id, True)
                       if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status())

        want = {j.id: (N_NODES if j.id == "sys-mid" else gpu_nodes if j.id == "sys-gpu"
                       else j.task_groups[0].count) for _, j, _ in jobs}
        with _Spy(kernels) as spy:
            phases.enable()
            t_all = phases.now()
            wall_all = time.perf_counter()
            for phase in ("a", "b", "c", "d"):
                if phase == "c":
                    server.raft_apply(SCHEDULER_CONFIG, preemption_config(structs, service=True))
                batch = [j for ph, j, _ in jobs if ph == phase]
                t0 = time.perf_counter()
                for job in batch:
                    server.register_job(job)
                deadline = time.monotonic() + 300
                while (any(running(j.id) < want[j.id] for j in batch)
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                got = {j.id: running(j.id) for j in batch}
                wall = time.perf_counter() - t0
                drained = server.drain_evals(120.0)
                if any(got[j.id] < want[j.id] for j in batch) or not drained:
                    raise AssertionError(f"system slice ({phase}): running {got} of {want}, "
                                         f"broker drained: {drained}")
                rec["phases"][phase] = {"wall_s": wall, "running": got,
                                        "launches": dict(kernels.LAUNCHES)}
            wall_s = time.perf_counter() - wall_all
            shares = phases.wall_shares(t_all, phases.now())
            phases.disable()
        # every preempted alloc is evicted in the FSM; no node overcommitted
        allocs = list(state.allocs())
        by_id = {a.id: a for a in allocs}
        preempted = [v for a in allocs for v in (a.preempted_allocations or [])]
        not_evicted = [v for v in preempted
                       if by_id.get(v) is None or by_id[v].desired_status != structs.ALLOC_DESIRED_EVICT]
        by_job_pre = {}
        for a in allocs:
            if a.preempted_allocations:
                by_job_pre[a.job_id] = by_job_pre.get(a.job_id, 0) + len(a.preempted_allocations)
        if not preempted or not_evicted:
            raise AssertionError(f"system slice: {len(preempted)} preemptions, "
                                 f"{len(not_evicted)} not evicted in the FSM")
        for job_id in ("sys-mid", "svc-high", "sys-gpu"):
            if not by_job_pre.get(job_id):
                raise AssertionError(f"system slice: {job_id} preempted nothing")
        by_node = {}
        for a in allocs:
            if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status():
                by_node.setdefault(a.node_id, []).append(a)
        over = [n.name for n in state.nodes() if not allocs_fit(n, by_node.get(n.id, []))[0]]
        if over:
            raise AssertionError(f"system slice: {len(over)} nodes overcommitted, e.g. {over[:3]}")
        # the fill lost exactly what was preempted of it, nothing else
        evicted_of = {}
        for v in preempted:
            evicted_of[by_id[v].job_id] = evicted_of.get(by_id[v].job_id, 0) + 1
        for _, j, _ in jobs:
            if j.id.startswith("fill-") and running(j.id) < j.task_groups[0].count - evicted_of.get(j.id, 0):
                raise AssertionError(f"system slice: {j.id} runs {running(j.id)} allocs, "
                                     f"{evicted_of.get(j.id, 0)} preempted of {j.task_groups[0].count}")
        unported = sum(1 for c in spy.counted if "unported" in c)
        fallback = spy.count("nomad.tpu_engine.fallback")
        if unported or spy.launches["forced_eval"] < 1 or spy.launches["place_scan_has_pre"] < 2:
            raise AssertionError(f"system slice: unported={unported} launches={spy.launches}")
        rec.update({
            "wall_s": wall_s, "launches": spy.launches, "unported": unported,
            "fallback": fallback, "fallback_reasons": sorted(set(spy.reasons)),
            "preempt_pass": spy.count("nomad.tpu_engine.system_preempt_pass"),
            "handled": spy.count("nomad.tpu_engine.handled"),
            "preemptions": len(preempted), "preempted_by_job": by_job_pre,
            "evicted_of_job": evicted_of, "nodes_checked": len(state.nodes()),
            "phases_s": shares, "batcher": dict(server.device_batcher.stats),
        })
        return rec, spy
    finally:
        server.stop()


def phase_preempt_harness(kernels, seed: int):
    """Victim for victim: the system slice's evals (a)-(c) through the
    port's Harness one at a time at N_NODES nodes, deterministic, each
    placed by ``tpu_binpack`` on the card and by the host ``binpack``
    stack from the same state. Plans, eviction sets (the same victim
    allocs, in the same order on each preemptor) and eval outcomes must
    be equal. Returns per-eval records."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs

    h = Harness(device=DEVICE)
    h.state.scheduler_set_config(h.next_index(), preemption_config(structs, service=False))
    for n in config4_nodes(mock, N_NODES):
        h.state.upsert_node(h.next_index(), n)

    def place(harness, job, kind):
        harness.state.upsert_job(harness.next_index(), copy.deepcopy(job))
        ev = structs.Evaluation(priority=job.priority, type=kind,
                                triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                                job_id=job.id, namespace=job.namespace)
        n_plans = len(harness.plans)
        t0 = time.perf_counter()
        harness.process(kind, ev)
        ms = (time.perf_counter() - t0) * 1000.0
        plans = harness.plans[n_plans:]
        assign = {(nid, a.name) for p in plans for nid, v in p.node_allocation.items() for a in v}
        victims = {nid: sorted(a.id for a in v) for p in plans
                   for nid, v in p.node_preemptions.items()}
        order = {(nid, a.name): list(a.preempted_allocations) for p in plans
                 for nid, v in p.node_allocation.items() for a in v if a.preempted_allocations}
        upd = harness.evals[-1]
        return {"job": job.id, "wall_ms": ms, "assign": assign, "victims": victims,
                "order": order, "status": upd.status,
                "failed_tgs": sorted(upd.failed_tg_allocs or {})}

    records = []
    with _Spy(kernels) as spy:
        for phase, job, kind in preempt_jobs(mock, structs, N_NODES):
            if phase == "d":
                break
            service_on = phase == "c"
            if service_on:
                h.state.scheduler_set_config(h.next_index(), preemption_config(structs, True))
            snap = h.state.snapshot()
            dev = place(h, job, kind)
            oracle = Harness(state=snap, device=DEVICE)
            oracle._next_index = h._next_index
            cfg = preemption_config(structs, service_on)
            cfg.scheduler_algorithm = "binpack"
            oracle.state.scheduler_set_config(oracle.next_index(), cfg)
            host = place(oracle, job, kind)
            for key in ("assign", "victims", "order", "status", "failed_tgs"):
                if dev[key] != host[key]:
                    raise AssertionError(f"harness {job.id}: {key} differs between tpu_binpack "
                                         f"and host binpack")
            records.append({"job": job.id, "phase": phase, "placed": len(dev["assign"]),
                            "preempted": sum(len(v) for v in dev["victims"].values()),
                            "device_wall_ms": dev["wall_ms"], "host_wall_ms": host["wall_ms"],
                            "service_on": service_on})
    if not any(r["preempted"] for r in records if r["phase"] == "b") or \
            not any(r["preempted"] for r in records if r["phase"] == "c"):
        raise AssertionError(f"harness: the preempting evals evicted nothing: {records}")
    return records, spy


def c1m_templates():
    """Own copy of the 40 job templates of bench.py ``c1m_mixed_jobs``
    (BASELINE config 5): 28 service (the first 10 with spread + affinity
    stanzas) and 12 batch, with heterogeneous asks and counts."""
    cpus, mems = [8, 12, 16, 20], [16, 24, 32, 48]
    counts_svc, counts_batch = [900, 950, 1000], [950, 1000]
    templates = [dict(kind="service", cpu=cpus[t % 4], mem=mems[(t // 4) % 4],
                      count=counts_svc[t % 3], stanzas=t < 10) for t in range(28)]
    templates += [dict(kind="batch", cpu=cpus[t % 4], mem=mems[t % 4],
                       count=counts_batch[t % 2], stanzas=False) for t in range(12)]
    return templates


def c1m_job(pkg_mock, structs, tpl, job_id, count):
    j = pkg_mock.job() if tpl["kind"] == "service" else pkg_mock.batch_job()
    j.id = job_id
    tg = j.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = 50
    tg.tasks[0].resources = structs.Resources(cpu=tpl["cpu"], memory_mb=tpl["mem"])
    if tpl["stanzas"]:
        tg.spreads = [structs.Spread(
            attribute="${node.datacenter}", weight=50,
            spread_target=[structs.SpreadTarget(value="dc1", percent=100)])]
        tg.affinities = [structs.Affinity(
            ltarget="${attr.kernel.name}", rtarget="linux", operand="=", weight=50)]
    return j


def c1m_mixed_jobs(pkg_mock, structs, total):
    """bench.py ``c1m_mixed_jobs``: the templates instantiated round-robin
    until the placement count is exactly ``total``."""
    templates = c1m_templates()
    jobs, placed, i = [], 0, 0
    while placed < total:
        tpl = templates[i % len(templates)]
        count = min(tpl["count"], total - placed)
        jobs.append(c1m_job(pkg_mock, structs, tpl, f"c1m-{i}", count))
        placed += count
        i += 1
    return jobs


def phase_server(kernels, deterministic: bool, seed: int, chunked: bool = False):
    """The server slice at ServerConfig defaults (deterministic=False: the
    float arm) or with deterministic=True (the int arm), or, with
    ``chunked``, at defaults but for scheduler_algorithm =
    "tpu_binpack_chunked" (the chunked tier, K5): 5,000 C1M nodes,
    num_schedulers=0 plus 16 explicit Workers (as bench.py bench_system),
    the C1M job mix cut to SERVER_PLACEMENTS. Returns the run's record
    and the spy (the main path's launches and their inputs: the batched
    launches, the forced-node launches of the float run's system job,
    the chunk launches and chunked evals)."""
    import numpy as np

    from nomad_tpu_torch.tpu.engine import TorchPlacementEngine

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit
    from nomad_tpu_torch.utils import phases

    arm = "chunked" if chunked else ("int" if deterministic else "float")
    rng = np.random.default_rng(seed)
    server = Server(ServerConfig(
        num_schedulers=0, deterministic=deterministic, device=DEVICE,
        scheduler_algorithm="tpu_binpack_chunked" if chunked else "tpu_binpack"),
        name=f"smoke-{arm}")
    engine = TorchPlacementEngine.shared(DEVICE)
    engine.reset_parity_samples()
    try:
        server.start()
        for i in range(N_NODES):
            n = mock.node()
            n.id = f"{seed:08d}-0000-4000-8000-{i:012d}"
            n.name = f"bench-{i}"
            n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
            n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
            n.compute_class()
            server.raft_apply(NODE_REGISTER, n)
        jobs = c1m_mixed_jobs(mock, structs, SERVER_PLACEMENTS)
        expected = sum(j.task_groups[0].count for j in jobs)
        for i in range(SERVER_WORKERS):
            w = Worker(server, i)
            server.workers.append(w)
            w.start()
        phases.enable()
        sys_rec = None
        with _Spy(kernels) as spy:
            t0 = phases.now()
            wall0 = time.perf_counter()
            for job in jobs:
                server.register_job(job)
            deadline = time.monotonic() + 420
            state = server.fsm.state
            while state.count_allocs_desired_run() < expected and time.monotonic() < deadline:
                time.sleep(0.02)
            wall_s = time.perf_counter() - wall0
            placed = state.count_allocs_desired_run()
            drained = server.drain_evals(60.0)
            shares = phases.wall_shares(t0, phases.now())
            if not deterministic and not chunked:
                # one system job after the mix: the forced-node kernel's
                # float arm on the default path (every C1M node is an
                # eligible dc1/linux node)
                sysjob = mock.system_job()
                sysjob.id = "sys-float"
                sysjob.task_groups[0].tasks[0].resources = structs.Resources(cpu=100, memory_mb=64)
                before = kernels.LAUNCHES["forced_eval_f32"]
                t_sys = time.perf_counter()
                server.register_job(sysjob)
                while state.count_allocs_desired_run() < expected + N_NODES and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
                sys_rec = {"wall_s": time.perf_counter() - t_sys,
                           "placed": state.count_allocs_desired_run() - expected,
                           "forced_eval_f32_launches": kernels.LAUNCHES["forced_eval_f32"] - before}
                drained = drained and server.drain_evals(60.0)
                if sys_rec["placed"] != N_NODES or sys_rec["forced_eval_f32_launches"] < 1:
                    raise AssertionError(f"server {arm}: system job {sys_rec}")
        phases.disable()
        launches, counted = spy.launches, spy.counted
        stats = dict(server.device_batcher.stats)
        profile = server.device_batcher.dispatch_profile()
        if placed != expected or not drained:
            raise AssertionError(f"server {arm}: {placed} of {expected} placements committed, "
                                 f"broker drained: {drained}")
        per_job = {j.id: 0 for j in jobs}
        by_node = {}
        for a in state.allocs():
            if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status():
                per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
                by_node.setdefault(a.node_id, []).append(a)
        short = [j.id for j in jobs if per_job[j.id] != j.task_groups[0].count]
        if short:
            raise AssertionError(f"server {arm}: jobs not fully placed in the FSM: {short[:5]}")
        over = [n.name for n in state.nodes()
                if not allocs_fit(n, by_node.get(n.id, []))[0]]
        if over:
            raise AssertionError(f"server {arm}: {len(over)} nodes overcommitted, e.g. {over[:3]}")
        unported = counted.count("nomad.tpu_engine.unported")
        fallback = counted.count("nomad.tpu_engine.fallback")
        mean_batch = stats["evals"] / max(stats["dispatches"], 1)
        rec = {"arm": arm, "placements": placed, "jobs": len(jobs), "wall_s": wall_s,
               "placements_per_s": placed / wall_s, "launches": launches,
               "evals_handled": counted.count("nomad.tpu_engine.handled"),
               "unported": unported, "fallback": fallback, "mean_eval_batch": mean_batch,
               "batcher": stats, "dispatch_profile": profile, "phases_s": shares,
               "nodes_checked": len(state.nodes()), "system_job": sys_rec}
        if chunked:
            # every C1M template is chunk-eligible in the float arm: each
            # job's eval takes the chunk kernel, one launch per eval;
            # OCC retries and the sampler take the exact float scan
            dispatch = counted.count("nomad.tpu_engine.chunk_dispatch")
            chunk_fallback = counted.count("nomad.tpu_engine.chunk_fallback")
            rec.update(chunk_dispatch=dispatch, chunk_fallback=chunk_fallback,
                       chunk_fallback_reasons=sorted({r for r in spy.reasons if "chunked" in r}),
                       parity_sample_stats=engine.parity_sample_stats())
            if (unported or fallback or chunk_fallback or dispatch < len(jobs)
                    or launches["chunk_scan"] != dispatch or launches["place_scan"]):
                raise AssertionError(
                    f"server {arm}: unported={unported} fallback={fallback} "
                    f"chunk_dispatch={dispatch} chunk_fallback={chunk_fallback} "
                    f"({rec['chunk_fallback_reasons']}) launches={launches}")
            return rec, spy
        kernel = "place_scan" if deterministic else "place_scan_f32"
        other = "place_scan_f32" if deterministic else "place_scan"
        if (unported or fallback or launches[kernel] < 1 or launches[other]
                or launches["chunk_scan"] or mean_batch <= 1.0):
            raise AssertionError(
                f"server {arm}: unported={unported} fallback={fallback} launches={launches} "
                f"mean eval batch={mean_batch}")
        return rec, spy
    finally:
        phases.disable()
        server.stop()


def c1m_jobs(pkg_mock, structs):
    """bench.py c1m_mixed_jobs templates 0 (service, spread + affinity),
    10 (service), 28 (batch), then 10 again with its cpu raised by 1."""
    templates = c1m_templates()
    t0, t10, t28 = (c1m_job(pkg_mock, structs, templates[t], f"c1m-{t}", templates[t]["count"])
                    for t in (0, 10, 28))
    t10b = copy.deepcopy(t10)
    t10b.task_groups[0].tasks[0].resources.cpu += 1
    return [(t0, "service"), (t10, "service"), (t28, "batch"), (t10b, "service")]


def phase_slice(kernels, seed: int):
    """The four C1M evals through the port's Harness on the card, each
    eval after the first also placed by the port's host binpack stack
    from the same state; returns per-eval records, the kernel inputs the
    main path launched with, and the main path's launch count."""
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.utils import metrics, phases

    rng = np.random.default_rng(seed)
    h = Harness(device=DEVICE)
    h.state.scheduler_set_config(
        h.next_index(), structs.SchedulerConfiguration(scheduler_algorithm="tpu_binpack"))
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"{seed:08d}-0000-4000-8000-{i:012d}"
        n.name = f"bench-{i}"
        n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
        n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
        n.compute_class()
        h.state.upsert_node(h.next_index(), n)
    jobs = c1m_jobs(mock, structs)

    def place(harness, job, kind):
        harness.state.upsert_job(harness.next_index(), copy.deepcopy(job))
        ev = structs.Evaluation(priority=job.priority, type=kind,
                                triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                                job_id=job.id, namespace=job.namespace)
        n_plans = len(harness.plans)
        t0 = time.perf_counter()
        harness.process(kind, ev)
        ms = (time.perf_counter() - t0) * 1000.0
        plan = harness.plans[n_plans]
        allocs = {a.name: a for v in plan.node_allocation.values() for a in v}
        upd = harness.evals[-1]
        return {"job": job.id, "type": kind, "wall_ms": ms, "allocs": allocs,
                "placed": len(allocs),
                "stopped": sum(len(v) for v in plan.node_update.values()),
                "status": upd.status, "failed_tgs": sorted(upd.failed_tg_allocs or {})}

    counted = []
    orig_incr = metrics.incr_counter
    captured = []
    orig_scan = kernels.place_scan

    def count(name, value=1.0):
        counted.append(name)
        orig_incr(name, value)

    def capture(n_pad, static, carry, xs, cs=None):
        captured.append((n_pad, tuple(t.clone() for t in static),
                         tuple(t.clone() for t in carry), tuple(t.clone() for t in xs)))
        return orig_scan(n_pad, static, carry, xs, cs=cs)

    records, snapshots = [], []
    kernels.reset_launch_counts()
    metrics.incr_counter, kernels.place_scan = count, capture
    try:
        for job, kind in jobs:
            snapshots.append(h.state.snapshot())
            phases.enable()
            t0 = phases.now()
            rec = place(h, job, kind)
            # seconds with the eval inside each phase (utils/phases)
            rec["phases_s"] = phases.wall_shares(t0, phases.now())
            phases.disable()
            records.append(rec)
    finally:
        metrics.incr_counter, kernels.place_scan = orig_incr, orig_scan
        phases.disable()
    launches = kernels.LAUNCHES["place_scan"]
    handled = counted.count("nomad.tpu_engine.handled")
    unported = counted.count("nomad.tpu_engine.unported")
    fallback = counted.count("nomad.tpu_engine.fallback")
    for (job, _), rec in zip(jobs, records):
        want = job.task_groups[0].count
        if rec["placed"] != want or rec["failed_tgs"] or rec["status"] != "complete":
            raise AssertionError(f"eval of {job.id} placed {rec['placed']} of {want}: "
                                 f"status {rec['status']} failed {rec['failed_tgs']}")
    if records[3]["stopped"] != jobs[1][0].task_groups[0].count:
        raise AssertionError(f"destructive update stopped {records[3]['stopped']} allocs")
    if launches < len(jobs) or unported or fallback or handled < len(jobs):
        raise AssertionError(f"main path: launches={launches} handled={handled} "
                             f"unported={unported} fallback={fallback}")
    log(f"slice: launches={launches} handled={handled} unported={unported} fallback={fallback}")

    # The host binpack stack places evals 2-4 from the state each saw.
    # Eval 1 (spread + affinity) is not replayed here: the host spread
    # iterator takes minutes for it at this size; tests/test_torch_engine.py
    # holds spread and affinity evals against the host and the JAX engine.
    for k in range(1, len(jobs)):
        job, kind = jobs[k]
        oracle = Harness(state=snapshots[k], device=DEVICE)
        oracle._next_index = h._next_index
        oracle.state.scheduler_set_config(
            oracle.next_index(), structs.SchedulerConfiguration(scheduler_algorithm="binpack"))
        host = place(oracle, job, kind)
        records[k]["host_wall_ms"] = host["wall_ms"]
        dev_allocs, host_allocs = records[k]["allocs"], host["allocs"]
        if set(dev_allocs) != set(host_allocs):
            raise AssertionError(f"eval {k + 1}: device and host placed different alloc names")
        order = sorted(dev_allocs, key=lambda n: int(n.rsplit("[", 1)[1][:-1]))
        diverged = [n for n in order if dev_allocs[n].node_id != host_allocs[n].node_id]
        records[k]["host_diverged"] = len(diverged)
        if diverged:
            # The JAX engine's integer spec carries each node's capacity
            # exponential as a running product, so two nodes that tie
            # exactly in the host's float64 score can differ by a few
            # Q27 units after evictions. A divergence must start at such
            # a tie: the device's node scored as high as the host's pick.
            first = diverged[0]
            ha, da = host_allocs[first], dev_allocs[first]
            metas = {m.node_id: m.norm_score for m in ha.metrics.score_meta}
            if metas.get(da.node_id) != metas.get(ha.node_id):
                raise AssertionError(
                    f"eval {k + 1}: {first} placed on {da.node_name} by the device, "
                    f"{ha.node_name} by the host, and the host does not score them equal")
            log(f"eval {k + 1}: {len(diverged)} of {len(order)} placements differ from the "
                f"host binpack stack, starting at {first}: host scores {ha.node_name} and "
                f"{da.node_name} equal ({metas[ha.node_id]!r}); the device breaks the tie")
        else:
            log(f"eval {k + 1}: all {len(order)} placements equal to the host binpack stack")
    return records, captured, launches


def bound(nbytes, ops):
    """The least time in ms for the work on this card's published peaks,
    and which of the two bounds it."""
    b_bytes, b_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")


def replay_batched(kernels, step, parity, sb, cb, xb, what, float_arm):
    """A captured K3 launch replayed: kernel vs plain (int bit for bit,
    float within the bound); returns (kernel ms, plain ms, bound ms,
    bound by, worst |dscore|)."""
    k_out = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
    stats_b = []
    p_out, p_ms = timed_wall(lambda: plain_batched(step, sb, cb, xb, stats_b))
    worst = 0
    for b in range(sb[0].shape[0]):
        got = (tuple(t[b] for t in k_out[0]), tuple(y[b] for y in k_out[1]))
        ref = (tuple(t[b] for t in p_out[0]), tuple(y[b] for y in p_out[1]))
        if float_arm:
            worst = max(worst, parity.check_float_scan(ref, got, xb[0][b], f"{what} eval {b}")[1])
        else:
            worst = max(worst, compare(got, ref, f"{what} eval {b}"))
    k_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))
    cs1_ms = hold_cs1(lambda cs: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb,
                                                            cs=cs), k_out, what)
    nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, k_out[1][3], stats_b)
    b_ms, b_by = bound(nbytes, ops)
    real = int((~k_out[1][3]).sum())
    evicting = int((k_out[1][4] >= 0).any(dim=-1).sum())
    p = xb[0].shape[1]
    log(f"{what}: B={sb[0].shape[0]} n_pad={sb[0].shape[1]} P={p} "
        f"C={sb[20].shape[2]} steps_run={real} evicting_steps={evicting} equal=yes "
        f"cs={plan_cs(kernels, sb, cb, xb, True)} kernel_ms={k_ms:.3f} "
        f"per_step_us={k_ms * 1e3 / p:.2f} cs1_ms={fmt_ms(cs1_ms)} plain_ms={p_ms:.1f} "
        f"bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
    log(f"  {what}: {sections_line(kernels, sb, cb, xb)}")
    return k_ms, p_ms, b_ms, b_by, worst


def replay_forced(kernels, forced, s, c, x, what):
    """A captured K4 launch replayed: kernel vs plain, bit for bit."""
    import torch

    got = kernels.forced_eval(s, c, x)
    plain, p_ms = timed_wall(lambda: forced.forced_eval(s, c, x))
    if not all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, plain)):
        raise AssertionError(f"{what}: kernel differs from plain")
    k_ms = cuda_ms(lambda: kernels.forced_eval(s, c, x), reps=21)
    nbytes, ops = kernels.forced_eval_work(s, c, x)
    b_ms, b_by = bound(nbytes, ops)
    log(f"{what}: P={x[0].shape[0]} n_pad={s[0].shape[0]} D={s[0].shape[1]} "
        f"placed={int((got[0] >= 0).sum())} equal=yes kernel_ms={k_ms:.4f} plain_ms={p_ms:.2f} "
        f"bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
    return k_ms, p_ms, b_ms, b_by, 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (REPO / "nomad_tpu_torch" / "tpu" / "csrc").is_dir():
        print(f"chip_smoke.py: no nomad_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from nomad_tpu_torch.tpu import chunk, convert, engine, forced, kernels, parity, step

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"gpu: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s")
    for name, info in kernels.BUILD_INFO.items():
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    def stamp(what):
        log(f"[{time.perf_counter() - t_start:.1f}s] {what}")

    worst = phase_variants(kernels, step, convert, engine)
    worst_f = phase_float_variants(kernels, step, convert, engine)
    phase_batched(kernels, convert, engine)
    phase_batched_waves(kernels, convert, engine)
    stamp("scan variants done")
    phase_forced(kernels, convert, engine, forced)
    phase_has_pre(kernels, step, convert, engine)
    phase_k8(kernels)
    stamp("K4, has_pre and K8 checks done")
    worst_k5, k5_recs = phase_chunk_variants(kernels, chunk, convert, engine, parity)
    stamp("K5 checks done")

    dev_records, captured, launches = phase_slice(kernels, args.seed)
    for rec in dev_records:
        host_ms = rec.get("host_wall_ms")
        log(f"eval {rec['job']:7s} {rec['type']:7s} placed={rec['placed']} stopped={rec['stopped']} "
            f"wall_ms={rec['wall_ms']:.1f} placements_per_s={rec['placed'] / rec['wall_ms'] * 1000:.1f} "
            f"host_binpack_wall_ms={'not run' if host_ms is None else f'{host_ms:.1f}'} "
            f"host_diverged={rec.get('host_diverged', 'not run')}")
        log(f"  phases_s {json.dumps(rec['phases_s'], sort_keys=True)}")
    total_placed = sum(r["placed"] for r in dev_records)
    total_ms = sum(r["wall_ms"] for r in dev_records)
    log(f"slice total: {total_placed} placements in {total_ms:.1f} ms "
        f"({total_placed / total_ms * 1000:.1f} placements/s) on {card}")
    stamp("Harness slice done")

    servers = {}
    for deterministic in (False, True):
        rec, spy = phase_server(kernels, deterministic, args.seed)
        servers[rec["arm"]] = (rec, [spy.batched[-1][0]], spy.forced)
        log(f"server {rec['arm']}: {rec['placements']} placements of {rec['jobs']} jobs in "
            f"{rec['wall_s'] * 1000:.1f} ms ({rec['placements_per_s']:.1f} placements/s) on {card}; "
            f"launches {json.dumps(rec['launches'], sort_keys=True)}; evals handled "
            f"{rec['evals_handled']}, unported {rec['unported']}, fallback {rec['fallback']}; "
            f"mean eval batch {rec['mean_eval_batch']:.3f}; {rec['nodes_checked']} nodes, none "
            f"overcommitted")
        if rec["system_job"]:
            log(f"  system job after the mix: {json.dumps(rec['system_job'], sort_keys=True)}")
        log(f"  batcher {json.dumps(rec['batcher'], sort_keys=True)}")
        log(f"  dispatch_profile {json.dumps(rec['dispatch_profile'], sort_keys=True)}")
        log(f"  phases_s {json.dumps(rec['phases_s'], sort_keys=True)}")
        stamp(f"server {rec['arm']} done")

    rec, chunk_spy = phase_server(kernels, False, args.seed, chunked=True)
    log(f"server chunked: {rec['placements']} placements of {rec['jobs']} jobs in "
        f"{rec['wall_s'] * 1000:.1f} ms ({rec['placements_per_s']:.1f} placements/s) on {card}; "
        f"launches {json.dumps(rec['launches'], sort_keys=True)}; chunk_dispatch "
        f"{rec['chunk_dispatch']}, chunk_fallback {rec['chunk_fallback']} "
        f"(reasons: {rec['chunk_fallback_reasons']}), evals handled {rec['evals_handled']}, "
        f"unported {rec['unported']}, fallback {rec['fallback']}; {rec['nodes_checked']} nodes, "
        f"none overcommitted")
    log(f"  parity_sample_stats {json.dumps(rec['parity_sample_stats'], sort_keys=True)}")
    log(f"  batcher {json.dumps(rec['batcher'], sort_keys=True)}")
    log(f"  phases_s {json.dumps(rec['phases_s'], sort_keys=True)}")
    stamp("server chunked done")
    k5_rows, k5_worst = replay_chunked(kernels, chunk, parity, chunk_spy)
    worst_k5 = max(worst_k5, k5_worst)
    servers["chunked"] = (rec, [], [])
    stamp("chunked replays done")

    sys_rec, sys_spy = phase_system_server(kernels, args.seed)
    log(f"system slice (deterministic): {N_NODES} config-4 nodes, wall {sys_rec['wall_s']:.3f} s "
        f"on {card}; launches {json.dumps(sys_rec['launches'], sort_keys=True)}; handled "
        f"{sys_rec['handled']}, preempt passes {sys_rec['preempt_pass']}, unported "
        f"{sys_rec['unported']}, fallback {sys_rec['fallback']} "
        f"(reasons: {sys_rec['fallback_reasons']}); {sys_rec['preemptions']} preemptions "
        f"committed and evicted in the FSM, by job {json.dumps(sys_rec['preempted_by_job'], sort_keys=True)}, "
        f"of job {json.dumps(sys_rec['evicted_of_job'], sort_keys=True)}; "
        f"{sys_rec['nodes_checked']} nodes, none overcommitted")
    for phase, prec in sys_rec["phases"].items():
        log(f"  ({phase}) wall_s={prec['wall_s']:.3f} running {json.dumps(prec['running'], sort_keys=True)} "
            f"launches so far {json.dumps(prec['launches'], sort_keys=True)}")
    log(f"  batcher {json.dumps(sys_rec['batcher'], sort_keys=True)}")
    log(f"  phases_s {json.dumps(sys_rec['phases_s'], sort_keys=True)}")
    stamp("system slice done")

    h_records, h_spy = phase_preempt_harness(kernels, args.seed)
    for r in h_records:
        log(f"harness {r['job']:12s} ({r['phase']}) placed={r['placed']} preempted={r['preempted']} "
            f"tpu_binpack_wall_ms={r['device_wall_ms']:.1f} host_binpack_wall_ms={r['host_wall_ms']:.1f} "
            f"plans and eviction sets equal: yes")
    log(f"harness launches {json.dumps(h_spy.launches, sort_keys=True)}")
    stamp("victim-for-victim Harness done")

    # the main paths' own kernel inputs, replayed: kernel vs plain, times, bound
    rows = {name: [] for name in ("place_scan", "place_scan_f32", "place_scan_has_pre",
                                  "forced_eval", "forced_eval_f32")}
    rows["chunk_scan"] = k5_rows
    for i, (n_pad, s, c, x) in enumerate(captured):
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        worst = max(worst, compare(k_out, p_out, f"main-path eval {i}"))
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        cs1_ms = hold_cs1(lambda cs: run_kernel(kernels, n_pad, s, c, x, cs), k_out,
                          f"main-path eval {i}")
        nbytes, ops = kernels.place_scan_work(s, c, x, k_out[1][3])
        b_ms, b_by = bound(nbytes, ops)
        rows["place_scan"].append((k_ms, p_ms, b_ms, b_by))
        p = x[0].shape[0]
        log(f"main-path eval {i}: n_pad={n_pad} P={p} S={s[10].shape[1]} "
            f"aff={s[4].shape[0] > 0} evict={x[3].shape[1] > 0} equal=yes "
            f"cs={plan_cs(kernels, s, c, x)} kernel_ms={k_ms:.3f} per_step_us={k_ms * 1e3 / p:.2f} "
            f"cs1_ms={fmt_ms(cs1_ms)} plain_ms={p_ms:.1f} bytes={nbytes} ops={ops} "
            f"bound_ms={b_ms:.6f} ({b_by})")
        log(f"  main-path eval {i}: " + sections_line(
            kernels, *(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x))))
    for arm, (rec, launch_inputs, forced_inputs) in servers.items():
        if arm == "chunked":
            continue  # replayed above
        kernel = "place_scan" if arm == "int" else "place_scan_f32"
        # the last batched launch only (PRs 1-2 also replayed the first)
        for which, (sb, cb, xb) in (("last", launch_inputs[-1]),):
            k_ms, p_ms, b_ms, b_by, err = replay_batched(
                kernels, step, parity, sb, cb, xb, f"server {arm} {which} launch", arm == "float")
            if arm == "int":
                worst = max(worst, err)
            else:
                worst_f = max(worst_f, err)
            rows[kernel].append((k_ms, p_ms, b_ms, b_by))
        for i, (s, c, x) in enumerate(forced_inputs):
            name = "forced_eval" if arm == "int" else "forced_eval_f32"
            rows[name].append(replay_forced(kernels, forced, s, c, x,
                                            f"server {arm} K4 launch {i}")[:4])
    # the system slice: its K4 launches, and the has_pre launches with the
    # most steps (the fill's scans are held by the int server's replays)
    for i, (s, c, x) in enumerate(sys_spy.forced):
        rows["forced_eval"].append(replay_forced(kernels, forced, s, c, x,
                                                 f"system slice K4 launch {i}")[:4])
    pre = [(launch, n) for launch, n in sys_spy.batched if launch[0][20].shape[2] > 0]
    pre.sort(key=lambda item: -item[1])
    for i, ((sb, cb, xb), _) in enumerate(pre[:2]):
        rows["place_scan_has_pre"].append(replay_batched(
            kernels, step, parity, sb, cb, xb, f"system slice has_pre launch {i}", False)[:4])
    stamp("replays done")

    mean = lambda v: sum(v) / len(v)  # noqa: E731
    main_launches = {
        "place_scan": (launches + servers["int"][0]["launches"]["place_scan"]
                       + sys_rec["launches"]["place_scan"]
                       - sys_rec["launches"]["place_scan_has_pre"]),
        "place_scan_f32": servers["float"][0]["launches"]["place_scan_f32"],
        "place_scan_has_pre": sys_rec["launches"]["place_scan_has_pre"],
        "forced_eval": sys_rec["launches"]["forced_eval"],
        "forced_eval_f32": servers["float"][0]["launches"]["forced_eval_f32"],
        "chunk_scan": servers["chunked"][0]["launches"]["chunk_scan"],
    }
    replaces = {
        "place_scan": "nomad_tpu/tpu/engine.py:213",
        "place_scan_f32": "nomad_tpu/tpu/engine.py:575",
        "place_scan_has_pre": "nomad_tpu/tpu/engine.py:383",
        "forced_eval": "nomad_tpu/tpu/engine.py:888",
        "forced_eval_f32": "nomad_tpu/tpu/engine.py:888",
        "chunk_scan": "nomad_tpu/tpu/engine.py:3033",
    }
    errs = {"place_scan": worst, "place_scan_f32": worst_f, "place_scan_has_pre": 0,
            "forced_eval": 0, "forced_eval_f32": 0, "chunk_scan": worst_k5}
    sources = {"forced_eval": "forced_eval.cu", "forced_eval_f32": "forced_eval.cu",
               "chunk_scan": "chunk_scan.cu"}
    entries = []
    for name, r in rows.items():
        if not r:
            raise AssertionError(f"no main-path launch of {name} to replay")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "nomad_tpu_torch/tpu/csrc/" + sources.get(name, "place_scan.cu"),
            "replaces": replaces[name],
            "launches": main_launches[name],
            "max_abs_err": errs[name],
            "ms": mean([x[0] for x in r]),
            "plain_ms": mean([x[1] for x in r]),
            "bound_ms": mean([x[2] for x in r]),
            "bound_by": r[0][3],
            "library_ms": None,
        })
    stamp("all phases passed")
    result = {"kernels": entries}
    log(json.dumps(result))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
