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
   PyTorch version on the card, bit for bit, at 5,000 nodes and P = 1,024
   for each specialization of the step, at n_pad >= 32,768, and B = 3
   evals in one launch against three single launches;
4. kernel vs plain, float arm: the same variants in float32, held by the
   placement-multiset divergence (bound 0) and the score difference at
   equal picks (``parity.FLOAT_SCORE_TOL``); then, in both arms, B = 8
   evals in one launch (K3) against eight single launches, with times;
5. the Harness slice: four evals of the C1M job mix (bench.py
   c1m_mixed_jobs templates 0, 10, 28, and 10 re-registered with its cpu
   raised by 1) through the port's scheduler Harness on CUDA at 5,000
   nodes (int arm); the kernel's launch count must rise, no eval may
   take the unported or fallback gate, every alloc must be placed, and
   the plans must equal the port's own host binpack stack on the same
   state;
6. the server slice, twice: the port's Server at ServerConfig defaults
   (float arm) and with deterministic=True (int arm), 5,000 C1M nodes,
   16 workers, the C1M job mix cut to 60,000 placements; every placement
   committed to the FSM, no node overcommitted, nothing unported or
   fallen back, the arm's kernel launched, a mean eval batch above 1;
7. the main paths' kernel inputs replayed (the Harness evals, and the
   first and last batched launch of each server run): kernel vs plain
   (int bit for bit, float within the bound), with the kernel's time,
   the plain version's time and the kernel's bound on this card.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is missing or the script stands outside the repo.
"""
from __future__ import annotations

import argparse
import copy
import json
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
P_VARIANT = 1024
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


def run_kernel(kernels, n_pad, static, carry, xs):
    return kernels.place_scan(n_pad, static, tuple(c.clone() for c in carry), xs)


def run_plain(step, n_pad, static, carry, xs):
    return step.place_scan(n_pad, static, carry, xs)


def plain_batched(step, static_b, carry_b, xs_b):
    """The plain version of a K3 launch: each eval of the batch in turn."""
    import torch

    outs = [step.place_scan(static_b[0].shape[1], tuple(t[b] for t in static_b),
                            tuple(t[b] for t in carry_b), tuple(t[b] for t in xs_b))
            for b in range(static_b[0].shape[0])]
    carry = tuple(torch.stack(col) for col in zip(*(o[0] for o in outs)))
    ys = tuple(torch.stack(col) for col in zip(*(o[1] for o in outs)))
    return carry, ys


def phase_variants(kernels, step, convert, engine):
    """Kernel vs plain on the card for every specialization of the step."""
    import numpy as np

    worst = 0
    cases = [(v, N_NODES, P_VARIANT, 1) for v in engine.SCAN_VARIANTS]
    cases.append(("s1", 33000, 4, 2))  # n_pad >= PACK_COUNT_MAX
    for variant, n_nodes, p, seed in cases:
        n_pad, st, ca, xs = engine.example_scan_variant(
            variant, n_nodes=n_nodes, n_tgs=3, n_placements=p, seed=seed)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        worst = max(worst, compare(k_out, p_out, f"variant {variant} n={n_nodes}"))
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        placed = int((k_out[1][0] >= 0).sum())
        log(f"variant {variant:18s} n_pad={n_pad} P={p} placed={placed} equal=yes "
            f"kernel_ms={k_ms:.3f} plain_ms={p_ms:.1f}")

    # B = 3 evals in one launch against three single launches
    evals = [engine.example_scan_variant("all", n_nodes=N_NODES, n_tgs=3,
                                         n_placements=P_VARIANT, seed=s)
             for s in (11, 12, 13)]
    n_pad = evals[0][0]
    singles = []
    for _, st, ca, xs in evals:
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        singles.append(run_kernel(kernels, n_pad, s, c, x))
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
    sb, cb, xb = convert.scan_inputs_to_torch(*stacked, DEVICE)
    carry_b, ys_b = kernels.place_scan_batched(sb, cb, xb)
    for b, (sc, sy) in enumerate(singles):
        worst = max(worst, compare(
            (tuple(t[b] for t in carry_b), tuple(y[b] for y in ys_b)), (sc, sy),
            f"batched eval {b}"))
    b_ms = cuda_ms(lambda: kernels.place_scan_batched(
        sb, tuple(c.clone() for c in cb), xb))
    log(f"batched B=3 n_pad={n_pad} P={P_VARIANT} equal to 3 single launches: yes "
        f"kernel_ms={b_ms:.3f}")
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
            variant, n_nodes=N_NODES, n_tgs=3, n_placements=P_VARIANT, seed=1,
            dtype=np.float32)
        s, c, x = convert.scan_inputs_to_torch(st, ca, xs, DEVICE)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        div, diff, exact = parity.check_float_scan(p_out, k_out, x[0], f"float variant {variant}")
        worst = max(worst, diff)
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        placed = int((k_out[1][0] >= 0).sum())
        log(f"float variant {variant:18s} n_pad={n_pad} P={P_VARIANT} placed={placed} "
            f"divergence={div} max_abs_dscore={diff!r} bit_exact={'yes' if exact else 'no'} "
            f"kernel_ms={k_ms:.3f} plain_ms={p_ms:.1f}")
    return worst


def phase_batched(kernels, convert, engine):
    """K3: B = 8 evals in one launch against eight single launches, in
    both arms: equal outputs (int bit for bit, float within the bound),
    the batched launch's time against the single launches'."""
    import numpy as np

    from nomad_tpu_torch.tpu import parity

    for arm, dtype in (("int", np.int32), ("float", np.float32)):
        evals = [engine.example_scan_variant("all", n_nodes=N_NODES, n_tgs=3,
                                             n_placements=P_VARIANT, seed=s, dtype=dtype)
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
        nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, ys_b[3])
        bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S) * 1e3
        log(f"K3 {arm} B={BATCH_B} n_pad={n_pad} P={P_VARIANT}: equal to {BATCH_B} single "
            f"launches (max |dscore| {worst!r}); batched_ms={b_ms:.3f} "
            f"singles_sum_ms={sum(single_ms):.3f} singles_max_ms={max(single_ms):.3f} "
            f"ratio_to_slowest_single={b_ms / max(single_ms):.3f} bytes={nbytes} ops={ops} "
            f"bound_ms={bound_ms:.6f}")


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


def phase_server(kernels, deterministic: bool, seed: int):
    """The server slice at ServerConfig defaults (deterministic=False: the
    float arm) or with deterministic=True (the int arm): 5,000 C1M nodes,
    num_schedulers=0 plus 16 explicit Workers (as bench.py bench_system),
    the C1M job mix cut to SERVER_PLACEMENTS. Returns the run's record
    and the inputs of its first and last batched launch."""
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit
    from nomad_tpu_torch.utils import metrics, phases

    arm = "int" if deterministic else "float"
    rng = np.random.default_rng(seed)
    server = Server(ServerConfig(num_schedulers=0, deterministic=deterministic,
                                 device=DEVICE), name=f"smoke-{arm}")
    counted = []
    orig_incr = metrics.incr_counter
    orig_batched = kernels.place_scan_batched
    launches_in = []

    def count(name, value=1.0):
        counted.append(name)
        orig_incr(name, value)

    def capture(static_b, carry_b, xs_b):
        launches_in.append(tuple(tuple(t.clone() for t in part)
                                 for part in (static_b, carry_b, xs_b)))
        if len(launches_in) > 2:
            del launches_in[1]  # keep the first and the latest
        return orig_batched(static_b, carry_b, xs_b)

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
        kernels.reset_launch_counts()
        metrics.incr_counter, kernels.place_scan_batched = count, capture
        phases.enable()
        try:
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
        finally:
            metrics.incr_counter, kernels.place_scan_batched = orig_incr, orig_batched
            phases.disable()
        launches = dict(kernels.LAUNCHES)
        stats = dict(server.device_batcher.stats)
        profile = server.device_batcher.dispatch_profile()
        if placed != expected or not drained:
            raise AssertionError(f"server {arm}: {placed} of {expected} placements committed, "
                                 f"broker drained: {drained}")
        per_job = {j.id: 0 for j in jobs}
        by_node = {}
        for a in state.allocs():
            if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status():
                per_job[a.job_id] += 1
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
        kernel = "place_scan" if deterministic else "place_scan_f32"
        other = "place_scan_f32" if deterministic else "place_scan"
        mean_batch = stats["evals"] / max(stats["dispatches"], 1)
        if unported or fallback or launches[kernel] < 1 or launches[other] or mean_batch <= 1.0:
            raise AssertionError(
                f"server {arm}: unported={unported} fallback={fallback} launches={launches} "
                f"mean eval batch={mean_batch}")
        rec = {"arm": arm, "placements": placed, "jobs": len(jobs), "wall_s": wall_s,
               "placements_per_s": placed / wall_s, "launches": launches,
               "evals_handled": counted.count("nomad.tpu_engine.handled"),
               "unported": unported, "fallback": fallback, "mean_eval_batch": mean_batch,
               "batcher": stats, "dispatch_profile": profile, "phases_s": shares,
               "nodes_checked": len(state.nodes())}
        return rec, list(launches_in)
    finally:
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

    def capture(n_pad, static, carry, xs):
        captured.append((n_pad, tuple(t.clone() for t in static),
                         tuple(t.clone() for t in carry), tuple(t.clone() for t in xs)))
        return orig_scan(n_pad, static, carry, xs)

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
    from nomad_tpu_torch.tpu import convert, engine, kernels, parity, step

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

    worst = phase_variants(kernels, step, convert, engine)
    worst_f = phase_float_variants(kernels, step, convert, engine)
    phase_batched(kernels, convert, engine)

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

    servers = {}
    for deterministic in (False, True):
        rec, launch_inputs = phase_server(kernels, deterministic, args.seed)
        servers[rec["arm"]] = (rec, launch_inputs)
        log(f"server {rec['arm']}: {rec['placements']} placements of {rec['jobs']} jobs in "
            f"{rec['wall_s'] * 1000:.1f} ms ({rec['placements_per_s']:.1f} placements/s) on {card}; "
            f"launches {json.dumps(rec['launches'], sort_keys=True)}; evals handled "
            f"{rec['evals_handled']}, unported {rec['unported']}, fallback {rec['fallback']}; "
            f"mean eval batch {rec['mean_eval_batch']:.3f}; {rec['nodes_checked']} nodes, none "
            f"overcommitted")
        log(f"  batcher {json.dumps(rec['batcher'], sort_keys=True)}")
        log(f"  dispatch_profile {json.dumps(rec['dispatch_profile'], sort_keys=True)}")
        log(f"  phases_s {json.dumps(rec['phases_s'], sort_keys=True)}")

    # the main paths' own kernel inputs, replayed: kernel vs plain, times, bound
    def bound(nbytes, ops):
        b_bytes, b_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")

    rows = {"place_scan": [], "place_scan_f32": []}
    for i, (n_pad, s, c, x) in enumerate(captured):
        k_out = run_kernel(kernels, n_pad, s, c, x)
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        worst = max(worst, compare(k_out, p_out, f"main-path eval {i}"))
        k_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        nbytes, ops = kernels.place_scan_work(s, c, x, k_out[1][3])
        b_ms, b_by = bound(nbytes, ops)
        rows["place_scan"].append((k_ms, p_ms, b_ms, b_by))
        log(f"main-path eval {i}: n_pad={n_pad} P={x[0].shape[0]} S={s[10].shape[1]} "
            f"aff={s[4].shape[0] > 0} evict={x[3].shape[1] > 0} equal=yes kernel_ms={k_ms:.3f} "
            f"plain_ms={p_ms:.1f} bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
    for arm, (rec, launch_inputs) in servers.items():
        kernel = "place_scan" if arm == "int" else "place_scan_f32"
        for which, (sb, cb, xb) in zip(("first", "last"), launch_inputs):
            k_out = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
            p_out, p_ms = timed_wall(lambda: plain_batched(step, sb, cb, xb))
            what = f"server {arm} {which} launch"
            for b in range(sb[0].shape[0]):
                got = (tuple(t[b] for t in k_out[0]), tuple(y[b] for y in k_out[1]))
                ref = (tuple(t[b] for t in p_out[0]), tuple(y[b] for y in p_out[1]))
                if arm == "int":
                    worst = max(worst, compare(got, ref, f"{what} eval {b}"))
                else:
                    worst_f = max(worst_f, parity.check_float_scan(
                        ref, got, xb[0][b], f"{what} eval {b}")[1])
            k_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))
            nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, k_out[1][3])
            b_ms, b_by = bound(nbytes, ops)
            rows[kernel].append((k_ms, p_ms, b_ms, b_by))
            real = int((~k_out[1][3]).any(dim=1).sum())
            log(f"{what}: B={sb[0].shape[0]} (evals with work {real}) n_pad={sb[0].shape[1]} "
                f"P={xb[0].shape[1]} equal=yes kernel_ms={k_ms:.3f} plain_ms={p_ms:.1f} "
                f"bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")

    mean = lambda v: sum(v) / len(v)  # noqa: E731
    main_launches = {
        "place_scan": launches + servers["int"][0]["launches"]["place_scan"],
        "place_scan_f32": servers["float"][0]["launches"]["place_scan_f32"],
    }
    entries = []
    for name, err in (("place_scan", worst), ("place_scan_f32", worst_f)):
        r = rows[name]
        b_ms = mean([x[2] for x in r])
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "nomad_tpu_torch/tpu/csrc/place_scan.cu",
            "replaces": ("nomad_tpu/tpu/engine.py:213" if name == "place_scan"
                         else "nomad_tpu/tpu/engine.py:575"),
            "launches": main_launches[name],
            "max_abs_err": err,
            "ms": mean([x[0] for x in r]),
            "plain_ms": mean([x[1] for x in r]),
            "bound_ms": b_ms,
            "bound_by": r[0][3],
            "library_ms": None,
        })
    result = {"kernels": entries}
    log(json.dumps(result))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
