#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N] [--churn-only | --wire-only | --devices-only |
                                      --client-only | --agent-only | --mesh-only |
                                      --nodes-only]

Run from the root of a checkout on a machine with one CUDA card, nvcc
and PyTorch built for CUDA. Phases, each of which fails the run:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under nomad_tpu_torch/tpu/csrc/ compiled with nvcc
   for sm_90a (one nvcc per source, started together);
3. kernel vs plain, int arm: the placement scan kernel against its plain
   PyTorch version on the card, bit for bit, at 5,000 nodes and P = 256
   (1,024 before the preemption slice, 512 before the wire phases; cut
   to make room) for each
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
   the packed entry (``kernels.pack_forced_inputs`` /
   ``forced_eval_packed``, the server's path) bit for bit against the
   tensor entry, both timed;
6. the scan's preemption branch (has_pre, int arm) against its plain
   version, bit for bit, at 5,000 nodes with C = 16 candidate slots: the
   ``preempt`` variant (P = 512; 1,024 before the wire phases, cut to
   make room) and the ``preempt_forced`` variant (the system preempt
   pass, P = 1,250); then B = 3 evals with C = 16, 0 and 5 in one launch
   against three single launches;
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
   forced-node kernel's float arm must launch on the default path.
   Each run's spy shows that every batch made one (slab) host-to-device
   copy and every ``run_forced`` eval one (packed) copy, and no other;
   every packed K3 launch of the main path is replayed through the
   tensor entry on its own inputs, bit for bit; the batcher's per-batch
   host sections (slab write, copy in, launch, copy back) and
   ``run_forced``'s host sections per system eval are printed;
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
   sets (the same victims, in the same order) must be equal (of the
   fill (a), only the first job on the host since the wire phases);
11. the main paths' own launches (the Harness evals, the last batched
   launch of each server run, every K4 launch, the evicting has_pre
   launch of the system slice with the fewest evicting steps; PRs 5-9
   replayed the two with the most):
   the outputs the
   main path's packed launch gave held against the plain version on its
   inputs (int bit for bit, float within the bound), then replayed
   through the same packed entry, equal to the main path's, with its
   time (the kernels line's ms), the plain version's time and the
   kernel's bound on this card;
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
   print the tier's divergence;
13. the churn and chaos replay (right after the build, while the
   process heap is small): the port's
   ``chaos.ChurnReplay`` on bench.py's chaos-churn-5K trace and cluster
   (seed ``--seed``, a 30 s trace over 250 nodes, three servers with two
   workers each, a leader transfer mid-run, four fault windows, one
   preemption wave, warmup jobs of 50 and 25), twice: at ServerConfig
   defaults (float) and with deterministic=True (int). Each run fails
   unless the invariants read zero lost, duplicated and orphaned allocs
   and converged, one leader kill ran, the injector is disarmed, the
   reference's SLO gate for the config passes (eval ms p99 <= 5,000,
   slowest in-flight <= 30,000 ms, >= 25 allocs/s, attribution coverage
   >= 0.9), K3 launched (float) and K1 has_pre launched (int: a launch
   with candidate tables), and every launch the spy captured equals its
   plain version (int bit for bit, float within the bound). It prints
   allocs, allocs/s, eval ms p50 / p99, the slowest in-flight eval,
   fault fires by point, degraded events, launches, fallback reasons by
   count, the top 5 of ``bottleneck_report`` with its coverage, and a
   bound on the card's busy share; a failing run prints a 5 s timeline
   and the jobs short of their count. ``--churn-only`` builds the
   kernels and runs only this phase (no kernels line, no result);
14. the wire cluster and the real-process harnesses (right after the
   churn, run as (b), (c), (a): the serve phase's 5,120 watcher threads
   while this process's heap is small): (a) three of the port's Servers in this process (ServerConfig
   defaults, the float arm, 16 workers each), each on its own WireRaft
   over TCP with a durable native log and behind its own RPCServer; the
   C1M fleet through ``raft_apply``, 5,000 placements of the job mix
   (60,000 before the devices phase, 20,000 before the client phase,
   10,000 before the agent phase and 7,500 before the nodes phase; cut to
   make room) through
   ``Job.Register`` over the wire, then the leader's raft and RPC stop
   (its Server stays up), a new leader is elected and 2,000 more
   (10,000, 5,000, then 2,500 before) go through it. It fails unless
   both leaders launched K3,
   every captured launch equals its plain version (within the float
   bound), the survivors' FSMs hold the same allocs, no node is
   overcommitted and the invariant sweep reads zero; it prints the
   fleet's registration time, placements/s before and after, raft apply
   ms p50/p99, the codec's encode ms and bytes a replicated entry and
   the time to the new leader. (b) bench.py's chaos-crash-5K, exactly:
   three ``crash_server`` processes (``--device cuda``, host binpack as
   in the reference: the card runs nothing, and the script prints which
   server processes held a CUDA context), the leader SIGKILLed, the
   reference's gate (>= 5 allocs/s, new leader <= 5,000 ms, first commit
   <= 10,000 ms, a snapshot-install rejoin, stitched coverage >= 0.9),
   invariants zero on every replica. (c) bench.py's serve-100Kwatch,
   exactly: 5,120 watchers across three processes, the reference's five
   checks and its SLO gate. ``--wire-only`` builds the kernels and runs
   only these three (no kernels line, no result).

15. the devices phase (after phase 10): GPU jobs from jobspec to the card.
   The port's cuda device plugin, served in a process of its own over
   the plugin transport, fingerprints the card (vendor nvidia, type gpu,
   the card's name, one instance per ordinal) for node 0 of a 5,000-node
   C1M-shaped fleet; every other node's DeviceManager holds a mock plugin
   with 8 such GPUs, and every fourth node also a mock xilinx/fpga group
   of 2. The port's Server (deterministic=True, 16 workers) gets, all
   parsed from HCL by the port's jobspec: ``Job.Plan`` with its diff of
   the first GPU job before it is registered (float arm, as the
   reference's plan); a system job asking one GPU on every node (K4,
   D = 5); 8 service jobs of 250 asking one GPU and 2 of 125 asking two
   (K3, D = 5; 500 and 250 before the client phase); then, alone, a job of 125 asking a GPU and an FPGA
   (D = 6); ``Job.Plan`` of the first job at 100 more. It fails unless
   every job is fully placed, no instance is assigned twice or past what
   its node holds, no node is overcommitted, the D = 6 job lands on FPGA
   nodes only, both plans place what they should and the diff shows the
   count, every captured K3 and K4 launch equals its plain version (int
   bit for bit, float within the bound), the D = 6 eval replayed by the
   host binpack stack on its snapshot gives the same plan and instance
   ids, and the plugin process reserves node 0's allocs as
   CUDA_VISIBLE_DEVICES of the card's ordinal. It prints placements/s,
   the K3 and K4 launches with their evals a launch and kernel ms by D,
   the plans submitted and the partial commits among them (each an OCC
   retry of its eval), Job.Plan's ms, and whether the plugin's
   process (and a process that only fingerprints) holds a CUDA context.
   ``--devices-only`` builds the kernels and runs only this phase (no
   kernels line, no result).

16. the client phase (after the devices phase): the client runtime. The
   port's in-process Server (int arm, every
   eval on the device path) over N_NODES C1M-shaped nodes, CLIENTS of
   them the port's ``Client``s (node class ``runner``; client 0 with the
   cuda device plugin, client 1 with its SQLite state DB), runs jobs
   parsed from HCL and limited to the runners: a raw_exec system job
   (K4) on every runner; C1M's density, CLIENT_ALLOCS raw_exec batch
   allocs a client (K3; each task writes its alloc index, its stdout
   through a logmon process); an exec service job through the port's
   nomad-executor, run and stopped; a GPU task (exec, this interpreter)
   that computes on the card the server assigned it and reports what it
   saw; the system job stopped. Every alloc reaches its status within
   CLIENT_PHASE_S, none lands off the runners or overcommits a node, the
   GPU task saw exactly the assigned card (UUID), every K3 and K4 launch
   equals its plain version, and no task, executor or logmon process is
   left. It prints job 2's placements/s and seconds to its last
   complete, allocs complete/s, job 3's register-to-running p50/p99, the
   launches with their kernel ms, the peak live task and logmon
   processes, and whether the GPU task held a CUDA context.
   ``--client-only`` builds the kernels and runs only this phase (no
   kernels line, no result).
17. the agent (after the client phase): an ``Agent`` built through the
   CLI's config path from an HCL file (server and client in one, on the
   card, 16 schedulers, 60 s of heartbeat grace); the C1M fleet
   registered over RPC and kept alive by the heartbeat pump's process;
   through ``python -m
   nomad_tpu_torch.cli`` processes: a raw_exec batch job of AGENT_BATCH
   allocs on the agent's own client (to ``complete``; a blocking query
   on /v1/jobs must wake on it), ``job status``, ``alloc logs``, ``alloc
   fs``; a raw_exec system job over every node (K4 f32); ``job run`` of
   C1M's template mix (AGENT_PLACEMENTS, float arm: K3); ``job plan``
   (K1 f32 at B = 1), ``node status``, ``operator raft list-peers``,
   ``job stop``. Every placement commits, no node is overcommitted,
   every K3 and K4 launch equals its plain version, every task's stdout
   is what it printed, no task or logmon is left. Then ``python -m
   nomad_tpu_torch.cli agent -dev`` as a process of its own: a batch job
   through the CLI to ``complete``, device dispatches above 0 and no
   host fallback in /v1/metrics, exit 0 within 30 s of SIGINT. It prints
   the fleet's registration s, the mix's placements/s, the CLI's ``job
   run`` ms, ``Job.Plan`` ms, the batch job's seconds to ``complete``,
   the blocking query's wake ms, the launches with their kernel ms, and
   the process's seconds to HTTP and to its first leader.
   ``--agent-only`` builds the kernels and runs only this phase.
18. the mesh (after phase 12's kernel checks): the eval axis of
   ``parallel.sharding``. Eight evals of the C1M mix (templates 0, 5,
   10, 15, 20, 28, 33, 38 at their own 900-1,000 placements; encoded by
   the port's Harness on the card at 5,000 C1M nodes), in the int arm and then the
   float arm, through a ``DeviceBatcher`` over a mesh made of the one
   card given twice (evals = 2; the server never arranges it so). It
   fails unless the batch runs as two K3 launches (LAUNCHES rises by
   2), one a shard of four on its own stream, the sharded results equal
   the one-launch unsharded batch of the same evals (int bit for bit,
   float by ``tpu/parity.py``), and shard 0 equals the plain version. It
   prints each shard's launch ms alone, both at once on their streams
   (host clock), the unsharded launch ms and K3's bound for the batch.
   ``--mesh-only`` builds the kernels and runs only this phase.
19. the node axis (after the mesh): the same 8 evals, int then float,
   through a ``DeviceBatcher`` over a (2, 2) mesh of the one card given
   four times: each group of 4 evals splits its 5,120 padded nodes over
   2 node shards, and every step is 3 launches a shard of the
   node-sharded kernel (``csrc/place_scan_nodes.cu``), its partials
   copied between the shards' streams between launches. It fails
   unless only that kernel ran (its LAUNCHES rise by 2 x 2 x (3 P + 1)
   and K3's do not), the results equal the one-launch unsharded K3
   batch (int bit for bit, float by ``tpu/parity.py``, whether bit for
   bit printed) and group 0 equals the plain node-sharded version
   (``tpu/node_shard.py`` on the CPU: int bit for bit, float by the
   parity bound); then the ``preempt`` variant (P = P_VARIANT, evicting)
   over a (1, 2) mesh equals the unsharded K1 has_pre launch bit for
   bit, evictions included. It prints the batch's host ms, launches a
   batch, the unsharded launch's ms, K3's bound for the batch and the
   phase's seconds. ``--nodes-only`` builds the kernels and runs only
   this phase.

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
# the scan variants of the earlier slices run at a quarter of their
# first depth (P = 1,024 in PRs 1-2, 512 in PRs 3-9) to leave room in the
# time limit, and since the wire phases the has_pre variant at half
# (P = 1,024 in PRs 3-9)
P_SCAN_VARIANT = 256
P_VARIANT = 512
P_PREEMPT_FORCED = 1250
SERVER_PLACEMENTS = 60_000
SERVER_WORKERS = 16
BATCH_B = 8
DEVICE = "cuda"
# the churn replay: bench.py bench_chaos_churn's chaos-churn-5K trace and
# cluster (bench.py:1157-1213), run twice: at defaults (float) and with
# deterministic=True (int), each for the trace's full duration
CHURN_NODES = 250
CHURN_DURATION_S = {"float": 30.0, "int": 30.0}
CHURN_TRACE = dict(n_nodes=CHURN_NODES, n_jobs=60, tg_count=50, stop_frac=0.3,
                   rollout_frac=0.25, n_drains=3, n_expiries=2, n_hipri=2,
                   n_fault_windows=4, canary_frac=0.25, n_preempt_waves=1,
                   leader_kill=True)
# the reference's own SLO gate for the config (bench.py:1208-1213)
CHURN_SLO = dict(eval_ms_p99_max=5_000.0, slowest_inflight_ms_max=30_000.0,
                 throughput_min_allocs_per_s=25.0, attribution_coverage_min=0.9)


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
    device dims and a padded placement axis (forced node -1); then
    against the scan kernel on the same input; the packed entry
    (``pack_forced_inputs`` / ``forced_eval_packed``, the server's path)
    on the same inputs bit for bit against the tensor entry, each timed.
    Returns the records of the launches."""
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
        packed = kernels.pack_forced_inputs((st, ca, xs), DEVICE)
        pk = convert.from_device_packed(*kernels.forced_eval_packed(packed))
        if not all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(pk, convert.to_numpy(got[:2]))):
            raise AssertionError(f"K4 {arm} D={4 + device_dims}: the packed entry differs from "
                                 f"the tensor entry")
        k_ms = cuda_ms(lambda: kernels.forced_eval(s, c, x), reps=21)
        pk_ms = cuda_ms(lambda: kernels.forced_eval_packed(packed), reps=21)
        scan_ms = cuda_ms(lambda: kernels.place_scan(n_pad, s, tuple(t.clone() for t in c), x))
        nbytes, ops = kernels.forced_eval_work(s, c, x)
        placed = int((got[0] >= 0).sum())
        recs.append((arm, k_ms, p_ms, nbytes, ops))
        log(f"K4 {arm} D={4 + device_dims} P={x[0].shape[0]} n_pad={n_pad} placed={placed} "
            f"equal to plain and to the scan kernel, packed entry equal to the tensor entry: "
            f"yes kernel_ms={k_ms:.4f} packed_ms={pk_ms:.4f} plain_ms={p_ms:.2f} "
            f"scan_kernel_ms={scan_ms:.3f} bytes={nbytes} ops={ops}")
    return recs


def phase_has_pre(kernels, step, convert, engine):
    """The scan's preemption branch (int arm) against its plain version on
    the card, bit for bit: the ``preempt`` variant (P = P_VARIANT) and the
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
    if any(cp != {"packed": 1, "slab": 0, "loose": 0} for cp in copies):
        raise AssertionError(f"chunked evals' host-to-device copies: {copies}")
    log(f"chunked server: every one of {len(copies)} chunked evals made one packed "
        f"host-to-device copy and no other")
    log("chunked server: run_chunked host ms per eval (median / max / sum over "
        f"{len(spy.chunk_evals)} evals): "
        + sections_text(host_sections([rec for _, _, rec, _ in spy.chunk_evals])))
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
    main path launched with and the outputs it got (restored on exit)."""

    def __init__(self, kernels):
        import logging

        from nomad_tpu_torch.utils import metrics

        import threading

        from nomad_tpu_torch.tpu import batcher, convert, engine

        self.kernels, self.metrics, self.engine_mod = kernels, metrics, engine
        self.convert = convert
        self.engine_cls = engine.TorchPlacementEngine
        self.batcher_cls = batcher.DeviceBatcher
        self.counted, self.reasons = [], []
        # the main path's K3 launches through place_scan_batched_packed
        # (the batcher's batches and run_scan_single's batches of one):
        # (its packed inputs as they were before the launch, a clone; the
        # buffer after it, carry updated; the output buffer; its layout);
        # its K4 launches through forced_eval_packed: (the packed inputs,
        # which K4 does not write; the output buffer; its layout)
        self.batched, self.forced = [], []
        # run_chunked's launches: (its pack_chunk_inputs arguments but the
        # chunk size, by reference: numpy arrays nothing writes; the
        # packed inputs, which the launch updated; the launch's output
        # buffer and its layout);
        # chunked evals: (encode, expanded chosen, host ms of run_chunked
        # by section: h2d, launch, d2h, total; the copies it made: packed
        # host-to-device copies, slab copies, loose ones)
        self.chunked, self.chunk_evals = [], []
        # the exact tier's batches: the host-to-device copies each made;
        # run_forced's evals: (host ms by section: h2d (check, pack and
        # copy), launch, d2h, total; the copies it made)
        self.batch_copies, self.forced_evals = [], []
        self._tls = threading.local()
        spy = self

        class Reasons(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "fallback" in msg or "to host" in msg or "ineligible" in msg:
                    spy.reasons.append(msg)

        self.handler = Reasons(level=logging.DEBUG)
        self.logger = logging.getLogger("nomad_tpu_torch.tpu.engine")

    def _section(self, name, t0):
        """Add the host ms since ``t0`` to section ``name`` of the
        calling thread's timed call (run_chunked, run_forced), if it is
        inside one."""
        rec = getattr(self._tls, "rec", None)
        if rec is not None:
            rec[name] = rec.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _copy(self, kind):
        """Count one host-to-device copy of ``kind`` (packed, slab or
        loose) in the calling thread's counted call, if it is inside one."""
        copies = getattr(self._tls, "copies", None)
        if copies is not None:
            copies[kind] += 1

    def _timed(self, orig, sink, keep=lambda out: out):
        """``orig`` (an engine method) with its host sections and copies
        recorded: ``sink`` gains (enc, ``keep(out)``, sections, copies)."""
        def run(engine, enc, *args, **kwargs):
            rec, copies = {}, {"packed": 0, "slab": 0, "loose": 0}
            self._tls.rec, self._tls.copies = rec, copies
            t0 = time.perf_counter()
            try:
                out = orig(engine, enc, *args, **kwargs)
            finally:
                self._tls.rec = self._tls.copies = None
            rec["total"] = (time.perf_counter() - t0) * 1e3
            sink.append((enc, keep(out), rec, copies))
            return out
        return run

    def __enter__(self):
        import dataclasses

        k, em, cv = self.kernels, self.engine_mod, self.convert
        self.orig = (self.metrics.incr_counter, k.place_scan_batched_packed, k.forced_eval_packed,
                     k.pack_forced_inputs, k.pack_chunk_inputs, k.chunk_scan_packed,
                     self.engine_cls.run_chunked, self.engine_cls.run_forced,
                     self.batcher_cls._run_batch, cv.to_device_packed, cv.HostSlab.to_device,
                     cv.scan_inputs_to_torch, em.from_device_packed)
        (orig_incr, orig_batched, orig_forced, orig_pack_forced, orig_pack, orig_chunk,
         orig_run_chunked, orig_run_forced, orig_run_batch, orig_h2d, orig_slab, orig_loose,
         orig_d2h) = self.orig

        def count(name, value=1.0):
            self.counted.append(name)
            orig_incr(name, value)

        def batched(packed, cs=None):
            fresh = dataclasses.replace(packed, buf=packed.buf.clone())
            out = orig_batched(packed, cs)
            self.batched.append((fresh, packed, *out))
            return out

        def forced(packed):
            t0 = time.perf_counter()
            out = orig_forced(packed)
            self._section("launch", t0)
            self.forced.append((packed, *out))
            return out

        def pack_forced(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_pack_forced(*args, **kwargs)
            self._section("h2d", t0)
            return out

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

        def run_batch(batcher, batch):
            copies = {"packed": 0, "slab": 0, "loose": 0}
            self._tls.copies = copies
            try:
                return orig_run_batch(batcher, batch)
            finally:
                self._tls.copies = None
                self.batch_copies.append(copies)

        def h2d(*args, **kwargs):
            self._copy("packed")
            return orig_h2d(*args, **kwargs)

        def slab(*args, **kwargs):
            self._copy("slab")
            return orig_slab(*args, **kwargs)

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

        self.metrics.incr_counter = count
        (k.place_scan_batched_packed, k.forced_eval_packed, k.pack_forced_inputs,
         k.pack_chunk_inputs, k.chunk_scan_packed) = (batched, forced, pack_forced,
                                                      pack_chunk_inputs, chunk_scan_packed)
        self.engine_cls.run_chunked = self._timed(orig_run_chunked, self.chunk_evals,
                                                  lambda out: out[0].copy())
        self.engine_cls.run_forced = self._timed(orig_run_forced, self.forced_evals)
        self.batcher_cls._run_batch = run_batch
        cv.to_device_packed, cv.HostSlab.to_device, cv.scan_inputs_to_torch = h2d, slab, loose
        em.from_device_packed = d2h
        self.logger.addHandler(self.handler)
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        k.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.launches = dict(self.kernels.LAUNCHES)
        k, em, cv = self.kernels, self.engine_mod, self.convert
        (self.metrics.incr_counter, k.place_scan_batched_packed, k.forced_eval_packed,
         k.pack_forced_inputs, k.pack_chunk_inputs, k.chunk_scan_packed,
         self.engine_cls.run_chunked, self.engine_cls.run_forced, self.batcher_cls._run_batch,
         cv.to_device_packed, cv.HostSlab.to_device, cv.scan_inputs_to_torch,
         em.from_device_packed) = self.orig
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False

    def count(self, name):
        return self.counted.count(name)

    def copies_line(self, what) -> str:
        """Check that every exact-tier batch made one slab copy and every
        run_forced eval one packed copy, and nothing else; say so."""
        want_batch = {"packed": 0, "slab": 1, "loose": 0}
        want_forced = {"packed": 1, "slab": 0, "loose": 0}
        bad = ([c for c in self.batch_copies if c != want_batch]
               + [c for *_, c in self.forced_evals if c != want_forced])
        if bad:
            raise AssertionError(f"{what}: host-to-device copies {bad[:5]}")
        return (f"{what}: every one of {len(self.batch_copies)} batches made one (slab) "
                f"host-to-device copy, every one of {len(self.forced_evals)} run_forced evals "
                f"one (packed) copy, and no other")


def host_sections(records) -> dict:
    """Host ms by section over timed calls (the spy's run_chunked or
    run_forced records): median / max / sum of each section, the rest
    (total less the sections) included."""
    names = sorted({n for rec in records for n in rec if n != "total"})
    secs = {n: sorted(rec.get(n, 0.0) for rec in records) for n in ("total", *names)}
    secs["rest"] = sorted(rec["total"] - sum(v for n, v in rec.items() if n != "total")
                          for rec in records)
    return {n: {"median": v[len(v) // 2], "max": v[-1], "sum": sum(v)} if v else {}
            for n, v in secs.items()}


def sections_text(secs) -> str:
    return "; ".join(f"{n} {v['median']:.3f} / {v['max']:.3f} / {v['sum']:.1f}"
                     for n, v in secs.items() if v)


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
            "batch_sections": server.device_batcher.section_profile(),
            "forced_sections": host_sections([r for _, _, r, _ in spy.forced_evals]),
            "copies": spy.copies_line("system slice"),
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
    be equal. Of the fill (a), only the first job is also placed on the
    host (PRs 3-9 placed all eight there: ~45 s of host binpack, cut to
    make room for the wire phases); the rest are placed on the card
    only, building the state (b) and (c) evict from. Returns per-eval
    records."""
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
    fills = 0
    with _Spy(kernels) as spy:
        for phase, job, kind in preempt_jobs(mock, structs, N_NODES):
            if phase == "d":
                break
            service_on = phase == "c"
            if service_on:
                h.state.scheduler_set_config(h.next_index(), preemption_config(structs, True))
            snap = h.state.snapshot()
            dev = place(h, job, kind)
            if phase == "a":
                fills += 1
                if fills > 1:
                    continue
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


def c1m_nodes(mock, seed: int):
    """The C1M fleet (bench.py:483-488): N_NODES mock nodes with fixed
    ids and seeded capacities."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"{seed:08d}-0000-4000-8000-{i:012d}"
        n.name = f"bench-{i}"
        n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
        n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
        n.compute_class()
        nodes.append(n)
    return nodes


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
    from nomad_tpu_torch.tpu.engine import TorchPlacementEngine

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit
    from nomad_tpu_torch.utils import phases

    arm = "chunked" if chunked else ("int" if deterministic else "float")
    server = Server(ServerConfig(
        num_schedulers=0, deterministic=deterministic, device=DEVICE,
        scheduler_algorithm="tpu_binpack_chunked" if chunked else "tpu_binpack"),
        name=f"smoke-{arm}")
    engine = TorchPlacementEngine.shared(DEVICE)
    engine.reset_parity_samples()
    try:
        server.start()
        for n in c1m_nodes(mock, seed):
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
        batch_sections = server.device_batcher.section_profile()
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
               "nodes_checked": len(state.nodes()), "system_job": sys_rec,
               "batch_sections": batch_sections,
               "forced_sections": host_sections([r for _, _, r, _ in spy.forced_evals]),
               "copies": spy.copies_line(f"server {arm}")}
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


#: the mesh phase's 8 C1M-mix evals: bench.py c1m_mixed_jobs templates
#: (0 and 5 with spread + affinity, 10-20 plain services, 28-38 batch),
#: each at its own count (900-1,000 placements)
MESH_TEMPLATES = (0, 5, 10, 15, 20, 28, 33, 38)


def mesh_encodes(kernels, engine_mod, deterministic: bool, seed: int):
    """The mesh phase's inputs: the MESH_TEMPLATES jobs placed one by one
    through the port's Harness on the card at N_NODES C1M nodes (the int
    arm when ``deterministic``), each eval's ``EncodedEval`` kept as the
    engine encoded it."""
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import structs

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
    templates = c1m_templates()
    encs = []
    cls = engine_mod.TorchPlacementEngine
    orig = cls.run_scan_single

    def keep(engine, enc):
        encs.append(enc)
        return orig(engine, enc)

    cls.run_scan_single = keep
    try:
        for t in MESH_TEMPLATES:
            tpl = templates[t]
            job = c1m_job(mock, structs, tpl, f"mesh-{t}", tpl["count"])
            h.state.upsert_job(h.next_index(), job)
            ev = structs.Evaluation(priority=job.priority, type=tpl["kind"],
                                    triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
                                    job_id=job.id, namespace=job.namespace)
            n_plans = len(h.plans)
            h.process(tpl["kind"], ev, deterministic=deterministic)
            placed = sum(len(v) for v in h.plans[n_plans].node_allocation.values())
            if placed != tpl["count"]:
                raise AssertionError(f"mesh: job mesh-{t} placed {placed} of {tpl['count']}")
    finally:
        cls.run_scan_single = orig
    if len(encs) != len(MESH_TEMPLATES):
        raise AssertionError(f"mesh: {len(encs)} device evals, want {len(MESH_TEMPLATES)}")
    return encs


def streams_ms(kernels, freshes, streams, reps: int = 3) -> float:
    """Host ms, between two synchronizes, of packed launches each on its
    own stream at once (fresh copies of their inputs made before the
    timing); the median of ``reps`` after one warm-up."""
    import dataclasses

    import torch

    times = []
    for _ in range(reps + 1):
        bufs = [dataclasses.replace(f, buf=f.buf.clone()) for f in freshes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for buf, st in zip(bufs, streams):
            with torch.cuda.stream(st):
                kernels.place_scan_batched_packed(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[1:])
    return times[len(times) // 2]


def phase_mesh(kernels, step, parity, seed: int):
    """The eval axis on the card: 8 C1M-mix evals at N_NODES through a
    ``DeviceBatcher`` over a mesh made of the one card given twice
    (evals = 2; only this phase arranges it so), in the int arm and then
    the float arm. Each of the two shards must run as its own K3 launch
    on its own stream (LAUNCHES rises by 2 for the batch), the sharded
    result must equal the one-launch unsharded batch of the same evals
    (int bit for bit, float by ``tpu/parity.py``) and shard 0 is held
    against the plain version. Returns a record per arm."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.tpu import batcher as batcher_mod
    from nomad_tpu_torch.tpu import engine as engine_mod
    from nomad_tpu_torch.tpu.convert import HostSlab, from_device_packed

    dev = torch.device("cuda", torch.cuda.current_device()) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    recs = {}
    for deterministic in (True, False):
        arm = "int" if deterministic else "float"
        kernel = "place_scan" if deterministic else "place_scan_f32"
        t_arm = time.perf_counter()
        encs = mesh_encodes(kernels, engine_mod, deterministic, seed)
        b = len(encs)
        dims = batcher_mod.batch_dims(encs)

        # the unsharded batch: one K3 launch of all 8 evals
        packed = batcher_mod.pack_batch(encs, dims, b, dev, HostSlab(pin=dev.type == "cuda"))
        whole_fresh = dataclasses.replace(packed, buf=packed.buf.clone())
        whole = from_device_packed(*kernels.place_scan_batched_packed(packed))

        # the sharded batch through the batcher's main path
        mesh = make_mesh(2, eval_parallel=2, devices=[dev, dev])
        shards, streams = [], []
        orig = kernels.place_scan_batched_packed

        def capture(pk, cs=None):
            fresh = dataclasses.replace(pk, buf=pk.buf.clone())
            out = orig(pk, cs)
            shards.append((fresh, pk, *out))
            if dev.type == "cuda":
                streams.append(torch.cuda.current_stream(dev))
            return out

        bat = batcher_mod.DeviceBatcher(max_batch=b, window_ms=60_000.0, device=dev, mesh=mesh)
        got, errors = [None] * b, [None] * b

        def submit(i):
            try:
                got[i] = bat.run(encs[i])
            except Exception as e:  # noqa: BLE001 — every error fails the phase below
                errors[i] = e

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(b)]
        kernels.reset_launch_counts()
        kernels.place_scan_batched_packed = capture
        try:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            kernels.place_scan_batched_packed = orig
            bat.stop()
        launches = dict(kernels.LAUNCHES)
        stats = bat.stats_snapshot()
        if any(e is not None for e in errors) or any(g is None for g in got):
            raise AssertionError(f"mesh {arm}: run() errors {errors}")
        if launches[kernel] != 2 or sum(launches.values()) - launches["place_scan_has_pre"] != 2:
            raise AssertionError(f"mesh {arm}: launches {launches}, want 2 of {kernel}")
        if stats["dispatches"] != 1 or stats["device_dispatches"] != {str(dev): 2}:
            raise AssertionError(f"mesh {arm}: batcher stats {stats}")
        if len(shards) != 2 or [s[0].dims["B"] for s in shards] != [b // 2, b // 2]:
            raise AssertionError(f"mesh {arm}: shard launches {[s[0].dims for s in shards]}")
        if dev.type == "cuda":
            ids = {st.cuda_stream for st in streams}
            if len(ids) != 2 or torch.cuda.default_stream(dev).cuda_stream in ids:
                raise AssertionError(f"mesh {arm}: shard streams {ids}")

        # sharded against unsharded, eval by eval
        exact, worst = True, 0.0
        for i, (enc, g) in enumerate(zip(encs, got)):
            ref = tuple(a[i, :enc.p] for a in whole)
            if deterministic:
                for name, x, y in zip(("chosen", "scores", "pulls", "skipped", "evict"), ref, g):
                    if x.dtype != y.dtype or not np.array_equal(x, y):
                        raise AssertionError(f"mesh int eval {i}: sharded {name} differs "
                                             "from the unsharded batch")
            else:
                _div, diff, ex = parity.check_float_scan(
                    ((), ref[:4]), ((), tuple(g[:4])), enc.xs[0][:enc.p],
                    f"mesh float eval {i}: sharded against unsharded")
                exact, worst = exact and ex, max(worst, diff)

        # shard 0 against the plain version (also timed alone), shard 1's
        # time alone, both at once on their streams, the unsharded launch
        k_ms, p_ms, b_ms, b_by, err = replay_batched(
            kernels, step, parity, shards[0], f"mesh {arm} shard 0", not deterministic)
        shard1_ms = packed_scan_ms(kernels, shards[1][0])
        whole_ms = packed_scan_ms(kernels, whole_fresh)
        both_ms = whole_host_ms = None
        if dev.type == "cuda":
            # the same host clock for both: two shards on two streams,
            # the unsharded batch on one
            both_ms = streams_ms(kernels, [s[0] for s in shards], streams)
            whole_host_ms = streams_ms(kernels, [whole_fresh], [torch.cuda.Stream(dev)])
        sb, cb, xb = whole_fresh.parts()
        nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, torch.from_numpy(whole[3]))
        whole_b_ms, whole_b_by = bound(nbytes, ops)
        recs[arm] = {
            "arm": arm, "kernel": kernel, "launches": launches[kernel], "evals": b,
            "n_pad": dims["n_pad"], "p_pad": dims["p_pad"], "wall_ms": wall_ms,
            "batcher_sections": bat.section_profile(), "exact": exact, "worst": worst,
            "shard_ms": [k_ms, shard1_ms], "both_ms": both_ms, "whole_ms": whole_ms,
            "whole_host_ms": whole_host_ms, "whole_cs": plan_cs(kernels, sb, cb, xb, True),
            "shard_cs": plan_cs(kernels, *shards[0][0].parts(), True),
            "bound_ms": whole_b_ms, "bound_by": whole_b_by,
            "row": (k_ms, p_ms, b_ms, b_by), "err": err,
            "phase_s": time.perf_counter() - t_arm,
        }
    return recs


def log_mesh(recs, card) -> None:
    for rec in recs.values():
        log(f"mesh {rec['arm']}: {rec['evals']} C1M-mix evals (n_pad {rec['n_pad']}, "
            f"P {rec['p_pad']}) over a (2, 1) mesh of the one card: {rec['launches']} "
            f"{rec['kernel']} launches, one a shard on its own stream, sharded equal to the "
            f"unsharded batch "
            f"{'bit for bit' if rec['exact'] else 'within the parity bound'} "
            f"(max |dscore| {rec['worst']}); shard 0 equal to plain")
        both, whole_host = ("not run" if v is None else f"{v:.3f}"
                            for v in (rec["both_ms"], rec["whole_host_ms"]))
        log(f"  shard launch ms {rec['shard_ms'][0]:.3f} / {rec['shard_ms'][1]:.3f} (B = "
            f"{rec['evals'] // 2} each, alone, CS {rec['shard_cs']}); unsharded launch ms "
            f"{rec['whole_ms']:.3f} (B = {rec['evals']}, CS {rec['whole_cs']}); host clock: "
            f"both shards at once on their two streams {both}, the unsharded launch "
            f"{whole_host}; K3 bound for the batch {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}); the batcher's run() of the batch {rec['wall_ms']:.1f} ms; "
            f"phase {rec['phase_s']:.1f} s; on {card}")
        log(f"  batch sections (host ms: median, sum) "
            f"{json.dumps(rec['batcher_sections'], sort_keys=True)}")


NODES_MESH = (2, 2)


def nodes_batch(kernels, batcher_mod, mesh, encs, dev):
    """``encs`` through a ``DeviceBatcher`` over ``mesh`` (the main path:
    one ``run()`` a thread, one batch), the launch counts set to 0 just
    before and read just after. Returns (results, launches, batcher
    stats, its sections, host ms from the first ``run()`` to the last
    return)."""
    import threading

    b = len(encs)
    bat = batcher_mod.DeviceBatcher(max_batch=b, window_ms=60_000.0, device=dev, mesh=mesh)
    got, errors = [None] * b, [None] * b

    def submit(i):
        try:
            got[i] = bat.run(encs[i])
        except Exception as e:  # noqa: BLE001 — every error fails the phase below
            errors[i] = e

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(b)]
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bat.stop()
    launches = dict(kernels.LAUNCHES)
    if any(e is not None for e in errors) or any(g is None for g in got):
        raise AssertionError(f"nodes: run() errors {errors}")
    return got, launches, bat.stats_snapshot(), bat.section_profile(), wall_ms


def phase_nodes(kernels, node_shard, parity, seed: int):
    """The node axis on the card: the mesh phase's 8 C1M-mix evals at
    N_NODES through a ``DeviceBatcher`` over a (2, 2) mesh of the one
    card given four times, in the int arm and then the float arm; each
    eval group of 4 runs over 2 node shards, 3 launches a shard a step
    (``kernels.place_scan_nodes_phase``), the partials copied between
    the shards' streams between launches. Fails unless only the
    node-sharded kernel ran (its LAUNCHES rose by 2 groups x 2 shards x
    (3 P + 1), K3's did not), the results equal the one-launch unsharded
    K3 batch (int bit for bit, float by ``tpu/parity.py``) and group 0's
    node-sharded outputs equal the plain node-sharded version (on the
    CPU, bit for bit). Then one preempting eval that evicts over a
    (1, 2) mesh, bit for bit against the unsharded K1 has_pre launch,
    evictions included. Returns a record per arm and the preempt
    record."""
    import dataclasses

    import numpy as np
    import torch

    from nomad_tpu_torch.parallel import batched_place_scan, make_mesh
    from nomad_tpu_torch.tpu import batcher as batcher_mod
    from nomad_tpu_torch.tpu import convert
    from nomad_tpu_torch.tpu import engine as engine_mod
    from nomad_tpu_torch.tpu.convert import HostSlab, from_device_packed

    dev = torch.device("cuda", torch.cuda.current_device()) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    ep, nn = NODES_MESH
    recs = {}
    for deterministic in (True, False):
        arm = "int" if deterministic else "float"
        kernel = "place_scan_nodes" if deterministic else "place_scan_nodes_f32"
        t_arm = time.perf_counter()
        encs = mesh_encodes(kernels, engine_mod, deterministic, seed)
        b = len(encs)
        dims = batcher_mod.batch_dims(encs, nn)

        # the unsharded batch: one K3 launch of all 8 evals
        packed = batcher_mod.pack_batch(encs, dims, b, dev, HostSlab(pin=dev.type == "cuda"))
        whole_fresh = dataclasses.replace(packed, buf=packed.buf.clone())
        whole = from_device_packed(*kernels.place_scan_batched_packed(packed))
        whole_ms = packed_scan_ms(kernels, whole_fresh)

        # the node-sharded batch through the batcher's main path
        mesh = make_mesh(ep * nn, eval_parallel=ep, devices=[dev] * (ep * nn))
        got, launches, stats, sections, wall_ms = nodes_batch(kernels, batcher_mod, mesh,
                                                              encs, dev)
        per_batch = ep * nn * (3 * dims["p_pad"] + 1)
        others = sum(v for k, v in launches.items() if k != kernel)
        if launches[kernel] != per_batch or others:
            raise AssertionError(f"nodes {arm}: launches {launches}, want {per_batch} of {kernel} "
                                 "and no other")
        if stats["dispatches"] != 1 or stats["device_dispatches"] != {str(dev): ep * nn}:
            raise AssertionError(f"nodes {arm}: batcher stats {stats}")

        # node-sharded against unsharded, eval by eval
        exact, worst = True, 0.0
        for i, (enc, g) in enumerate(zip(encs, got)):
            ref = tuple(a[i, :enc.p] for a in whole)
            exact = exact and all(x.dtype == y.dtype and np.array_equal(x, y)
                                  for x, y in zip(ref, g))
            if deterministic:
                if not exact:
                    raise AssertionError(f"nodes int eval {i}: node-sharded differs from the "
                                         "unsharded batch")
            else:
                _div, diff, _ex = parity.check_float_scan(
                    ((), ref[:4]), ((), tuple(g[:4])), enc.xs[0][:enc.p],
                    f"nodes float eval {i}: node-sharded against unsharded")
                worst = max(worst, diff)

        # group 0 against the plain node-sharded version, on the CPU (int
        # bit for bit; float by tpu/parity.py: the CPU's pow is not powf)
        group = encs[:b // ep]
        plain_exact, plain_worst = True, 0.0
        t0 = time.perf_counter()
        for i, enc in enumerate(group):
            padded = batcher_mod.pad_encoded(enc, **dims)
            _, ys = node_shard.place_scan_nodes(
                dims["n_pad"], *convert.scan_inputs_to_torch(*padded, "cpu"), nn)
            ys = tuple(y.numpy()[:enc.p] for y in ys)
            same = all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(got[i], ys))
            plain_exact = plain_exact and same
            if deterministic and not same:
                raise AssertionError(f"nodes int eval {i}: the kernel differs from the plain "
                                     "node-sharded version")
            if not deterministic:
                plain_worst = max(plain_worst, parity.check_float_scan(
                    ((), ys[:4]), ((), tuple(got[i][:4])), enc.xs[0][:enc.p],
                    f"nodes float eval {i}: the kernel against the plain node-sharded version")[1])
        plain_ms = (time.perf_counter() - t0) * 1e3

        # group 0 node-sharded alone: the launcher's phase loop and its
        # synchronize (host clock), median of 3, outputs held again
        launcher = batcher_mod.ShardLauncher(make_mesh(nn, eval_parallel=1, devices=[dev] * nn))
        loop_ms = []
        for _ in range(3):
            times = {}
            again = launcher(group, dims, len(group), times)
            for i, enc in enumerate(group):
                if not all(np.array_equal(x[i, :enc.p], y) for x, y in zip(again, got[i])):
                    raise AssertionError(f"nodes {arm} eval {i}: a rerun of group 0 differs")
            loop_ms.append(times["launch"])
        k_ms = sorted(loop_ms)[1]
        sb, cb, xb = whole_fresh.parts()
        skipped = torch.from_numpy(whole[3])
        nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, skipped)
        b_ms, b_by = bound(nbytes, ops)
        g0 = [tuple(a[:len(group)] for a in part) for part in (sb, cb, xb)]
        g_bytes, g_ops = kernels.place_scan_batched_work(*g0, skipped[:len(group)])
        g_ms, g_by = bound(g_bytes, g_ops)
        recs[arm] = {
            "arm": arm, "kernel": kernel, "launches": launches[kernel], "evals": b,
            "n_pad": dims["n_pad"], "p_pad": dims["p_pad"], "wall_ms": wall_ms,
            "launch_section": sections["launch"], "exact": exact, "worst": worst,
            "whole_ms": whole_ms, "bound_ms": b_ms, "bound_by": b_by,
            "group_ms": k_ms, "group_plain_ms": plain_ms, "group_bound_ms": g_ms,
            "plain_exact": plain_exact, "plain_worst": plain_worst,
            "row": (k_ms, plain_ms, g_ms, g_by), "err": max(worst, plain_worst),
            "phase_s": time.perf_counter() - t_arm,
        }

    # one preempting eval over (1, 2), against the unsharded K1 has_pre launch
    t_pre = time.perf_counter()
    n_pad, st, ca, xs = engine_mod.example_scan_variant(
        "preempt", n_nodes=N_NODES, n_tgs=3, n_placements=P_VARIANT, seed=1)
    enc = engine_mod.EncodedEval(
        n_real=N_NODES, n_pad=n_pad, g=3, s=st[9].shape[1], v=st[10].shape[2], p=P_VARIANT,
        dtype=np.int32, static=st, carry=ca, xs=xs, missing_list=[], nodes=[], table=None,
        start_ns=0)
    dims = batcher_mod.batch_dims([enc], nn)
    padded = batcher_mod.pad_encoded(enc, **dims)
    _, ref = kernels.place_scan(dims["n_pad"], *convert.scan_inputs_to_torch(*padded, dev))
    kernels.reset_launch_counts()
    out = batched_place_scan(make_mesh(nn, eval_parallel=1, devices=[dev] * nn))([enc])
    pre_launches = dict(kernels.LAUNCHES)
    want = nn * (3 * dims["p_pad"] + 1)
    if pre_launches["place_scan_nodes"] != want or pre_launches["place_scan"]:
        raise AssertionError(f"nodes preempt: launches {pre_launches}, want {want} node-sharded")
    for name, x, y in zip(("chosen", "scores", "pulls", "skipped", "evict"), out, ref):
        if not np.array_equal(x[0], y.cpu().numpy()):
            raise AssertionError(f"nodes preempt: node-sharded {name} differs from the "
                                 "unsharded K1 has_pre launch")
    evicting = int((out[4][0] >= 0).any(axis=1).sum())
    if evicting < 1:
        raise AssertionError("nodes preempt: no step evicted")
    pre = {"launches": pre_launches["place_scan_nodes"], "evicting": evicting, "p": P_VARIANT,
           "placed": int((out[0][0] >= 0).sum()), "n_pad": dims["n_pad"],
           "seconds": time.perf_counter() - t_pre}
    return recs, pre


def log_nodes(recs, pre, card) -> None:
    for rec in recs.values():
        log(f"nodes {rec['arm']}: {rec['evals']} C1M-mix evals (n_pad {rec['n_pad']}, P "
            f"{rec['p_pad']}) over a {NODES_MESH} mesh of the one card: {rec['launches']} "
            f"{rec['kernel']} launches a batch (3 a shard a step), no K3 launch; node-sharded "
            f"equal to the unsharded batch "
            f"{'bit for bit' if rec['exact'] else 'within the parity bound, not bit for bit'} "
            f"(max |dscore| {rec['worst']}); group 0 equal to the plain node-sharded version "
            f"on the CPU {'bit for bit' if rec['plain_exact'] else 'within the parity bound'} "
            f"(max |dscore| {rec['plain_worst']})")
        log(f"  batch host ms {rec['wall_ms']:.1f} (the batcher's launch section "
            f"{json.dumps(rec['launch_section'], sort_keys=True)}); the unsharded K3 launch ms "
            f"{rec['whole_ms']:.3f}; K3's bound for the batch {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}); group 0 alone: node-sharded phase loop {rec['group_ms']:.1f} "
            f"ms (host clock), plain node-sharded {rec['group_plain_ms']:.1f} ms (CPU), bound "
            f"{rec['group_bound_ms']:.6f} ms; phase {rec['phase_s']:.1f} s; on {card}")
    log(f"nodes preempt: the preempt variant (n_pad {pre['n_pad']}, P {pre['p']}) over a (1, 2) "
        f"mesh: {pre['launches']} place_scan_nodes launches, {pre['placed']} placed, "
        f"{pre['evicting']} evicting steps, equal to the unsharded K1 has_pre launch bit for bit "
        f"(evict included); {pre['seconds']:.1f} s; on {card}")


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
    import dataclasses

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
    orig_scan = kernels.place_scan_batched_packed

    def count(name, value=1.0):
        counted.append(name)
        orig_incr(name, value)

    def capture(packed, cs=None):
        # run_scan_single's batch of one: its inputs before the launch
        # (a clone), the buffer after it, the outputs and their layout
        fresh = dataclasses.replace(packed, buf=packed.buf.clone())
        out = orig_scan(packed, cs)
        captured.append((fresh, packed, *out))
        return out

    records, snapshots = [], []
    kernels.reset_launch_counts()
    metrics.incr_counter, kernels.place_scan_batched_packed = count, capture
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
        metrics.incr_counter, kernels.place_scan_batched_packed = orig_incr, orig_scan
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
        records[k]["host_diverged"] = hold_host_plan(f"eval {k + 1}", records[k]["allocs"],
                                                     host["allocs"])
    return records, captured, launches


def hold_host_plan(what, dev_allocs, host_allocs) -> int:
    """A device plan ({alloc name: alloc}) against the host binpack
    stack's on the same state: the same alloc names, on the same nodes
    unless a divergence starts at an exact host tie; returns the count of
    placements that differ."""
    if set(dev_allocs) != set(host_allocs):
        raise AssertionError(f"{what}: device and host placed different alloc names")
    order = sorted(dev_allocs, key=lambda n: int(n.rsplit("[", 1)[1][:-1]))
    diverged = [n for n in order if dev_allocs[n].node_id != host_allocs[n].node_id]
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
                f"{what}: {first} placed on {da.node_name} by the device, "
                f"{ha.node_name} by the host, and the host does not score them equal")
        log(f"{what}: {len(diverged)} of {len(order)} placements differ from the "
            f"host binpack stack, starting at {first}: host scores {ha.node_name} and "
            f"{da.node_name} equal ({metas[ha.node_id]!r}); the device breaks the tie")
    else:
        log(f"{what}: all {len(order)} placements equal to the host binpack stack")
    return len(diverged)


def bound(nbytes, ops):
    """The least time in ms for the work on this card's published peaks,
    and which of the two bounds it."""
    b_bytes, b_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")


def packed_scan_ms(kernels, fresh, cs=None, reps: int = 3) -> float:
    """Device ms of one ``kernels.place_scan_batched_packed`` launch (the
    main path's own wrapper) at the plan's CS or a forced ``cs``, each on
    its own copy of the packed buffer ``fresh``, made before the timing
    (a launch updates the buffer's carry in place)."""
    import dataclasses

    bufs = [dataclasses.replace(fresh, buf=fresh.buf.clone()) for _ in range(reps + 1)]
    return cuda_ms(lambda: kernels.place_scan_batched_packed(bufs.pop(), cs), reps)


def packed_scan_results(packed, out, out_layout):
    """A packed K3 launch's ``(carry, ys)``: the carry it left in its
    buffer (views on the card) and its outputs (host tensors)."""
    import torch

    from nomad_tpu_torch.tpu.convert import from_device_packed

    _s, carry, _x = packed.parts()
    return tuple(carry), tuple(torch.from_numpy(a) for a in from_device_packed(out, out_layout))


def evicting_steps(launch) -> int:
    """Steps of a captured K3 launch that evicted."""
    _fresh, after, out, out_layout = launch
    return int((packed_scan_results(after, out, out_layout)[1][4] >= 0).any(dim=-1).sum())


def hold_batched_launches(kernels, launches, what) -> str:
    """Every captured main-path K3 launch replayed through the tensor
    entry on its own inputs: outputs and final carry bit for bit against
    the main path's packed launch."""
    for i, (fresh, after, out, out_layout) in enumerate(launches):
        sb, cb, xb = fresh.parts()
        ref = kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
        compare(packed_scan_results(after, out, out_layout), ref,
                f"{what} launch {i}: the main path's packed launch against the tensor entry")
    return (f"{what}: all {len(launches)} packed K3 launches of the main path equal the tensor "
            f"entry on their inputs, bit for bit")


def replay_batched(kernels, step, parity, launch, what, float_arm):
    """A captured main-path K3 launch (``place_scan_batched_packed``): its
    own outputs and final carry held against the plain version on its
    inputs (int bit for bit, float within the bound), then replayed
    through the same entry on a fresh copy of its inputs at the plan's CS
    and at a forced CS = 1, each bit for bit against the main path's, and
    timed (the tensor entry's time beside it). Returns (kernel ms, plain
    ms, bound ms, bound by, worst |dscore|)."""
    import dataclasses

    fresh, after, out, out_layout = launch
    main = packed_scan_results(after, out, out_layout)
    sb, cb, xb = fresh.parts()
    stats_b = []
    p_out, p_ms = timed_wall(lambda: plain_batched(step, sb, cb, xb, stats_b))
    worst = 0
    for b in range(sb[0].shape[0]):
        got = (tuple(t[b] for t in main[0]), tuple(y[b] for y in main[1]))
        ref = (tuple(t[b] for t in p_out[0]), tuple(y[b] for y in p_out[1]))
        if float_arm:
            worst = max(worst, parity.check_float_scan(ref, got, xb[0][b], f"{what} eval {b}")[1])
        else:
            worst = max(worst, compare(got, ref, f"{what} eval {b}"))
    cs1_ms = None
    for cs in (None, 1):
        again = dataclasses.replace(fresh, buf=fresh.buf.clone())
        try:
            res = kernels.place_scan_batched_packed(again, cs)
        except ValueError as e:
            log(f"{what}: CS=1 not run: {e}")
            continue
        compare(packed_scan_results(again, *res), main,
                f"{what}: the replay at {'CS=1' if cs else 'the plan'} against the main path")
        if cs:
            cs1_ms = packed_scan_ms(kernels, fresh, 1, reps=1)
    k_ms = packed_scan_ms(kernels, fresh)
    t_ms = cuda_ms(lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb))
    nbytes, ops = kernels.place_scan_batched_work(sb, cb, xb, main[1][3], stats_b)
    b_ms, b_by = bound(nbytes, ops)
    real = int((~main[1][3]).sum())
    evicting = int((main[1][4] >= 0).any(dim=-1).sum())
    p = xb[0].shape[1]
    log(f"{what}: B={sb[0].shape[0]} n_pad={sb[0].shape[1]} P={p} "
        f"C={sb[20].shape[2]} steps_run={real} evicting_steps={evicting} the main path's "
        f"outputs equal to plain, replays equal to them: yes "
        f"cs={plan_cs(kernels, sb, cb, xb, True)} kernel_ms={k_ms:.3f} (packed entry; tensor "
        f"entry {t_ms:.3f}) per_step_us={k_ms * 1e3 / p:.2f} cs1_ms={fmt_ms(cs1_ms)} "
        f"plain_ms={p_ms:.1f} bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
    log(f"  {what}: {sections_line(kernels, sb, cb, xb)}")
    return k_ms, p_ms, b_ms, b_by, worst


def replay_forced(kernels, forced, launch, what):
    """A captured main-path K4 launch (``forced_eval_packed``): its own
    chosen and scores held against the plain version on its inputs, bit
    for bit (the plain version's pulls, skips and evictions are the
    constants the host makes), then launched again on the same buffer
    (K4 writes none of its inputs), equal, and timed."""
    import numpy as np

    from nomad_tpu_torch.tpu.convert import from_device_packed

    packed, out, out_layout = launch
    main = from_device_packed(out, out_layout)
    s, c, x = packed.parts()
    plain, p_ms = timed_wall(lambda: forced.forced_eval(s, c, x))
    ref = [t.cpu().numpy() for t in plain]
    p = x[0].shape[0]
    if not (all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(main, ref[:2]))
            and not ref[2].any() and not ref[3].any() and ref[4].shape == (p, 0)):
        raise AssertionError(f"{what}: the main path's packed launch differs from plain")
    again = from_device_packed(*kernels.forced_eval_packed(packed))
    if not all(np.array_equal(a, b) for a, b in zip(again, main)):
        raise AssertionError(f"{what}: a replay differs from the main path's launch")
    k_ms = cuda_ms(lambda: kernels.forced_eval_packed(packed), reps=21)
    nbytes, ops = kernels.forced_eval_work(s, c, x)
    b_ms, b_by = bound(nbytes, ops)
    log(f"{what}: P={p} n_pad={s[0].shape[0]} D={s[0].shape[1]} "
        f"placed={int((main[0] >= 0).sum())} the main path's outputs equal to plain: yes "
        f"kernel_ms={k_ms:.4f} (packed entry) plain_ms={p_ms:.2f} "
        f"bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
    return k_ms, p_ms, b_ms, b_by, 0


def fallback_reasons(reasons) -> dict:
    """The spy's fallback messages counted, eval and node ids elided."""
    import re
    from collections import Counter

    ids = re.compile(r"\b[0-9a-f]{8}(?:-[0-9a-f]{4}){3}-[0-9a-f]{12}\b|\b[0-9a-f]{8}\b")
    return dict(sorted(Counter(ids.sub("<id>", r) for r in reasons).items()))


def hold_churn_launches(step, parity, launches, float_arm, what):
    """Every K3 launch a churn run's spy captured (the batched launches of
    all three servers, the has_pre ones with them): the outputs and final
    carry the main path's packed launch gave, held against the plain
    version on the launch's own inputs, eval by eval (int bit for bit,
    float within ``parity``'s bound). Returns (launches held, evals held,
    worst |dscore|, plain ms in all)."""
    worst, evals, plain_ms = 0, 0, 0.0
    for i, (fresh, after, out, out_layout) in enumerate(launches):
        main = packed_scan_results(after, out, out_layout)
        sb, cb, xb = fresh.parts()
        p_out, ms = timed_wall(lambda: plain_batched(step, sb, cb, xb))
        plain_ms += ms
        for b in range(sb[0].shape[0]):
            got = (tuple(t[b] for t in main[0]), tuple(y[b] for y in main[1]))
            ref = (tuple(t[b] for t in p_out[0]), tuple(y[b] for y in p_out[1]))
            tag = f"{what} launch {i} eval {b}"
            if float_arm:
                worst = max(worst, parity.check_float_scan(ref, got, xb[0][b], tag)[1])
            else:
                worst = max(worst, compare(got, ref, tag))
            evals += 1
    return len(launches), evals, worst, plain_ms


def churn_diagnostics(replay, result) -> list:
    """Lines that say where a churn run stands: the leader's broker and
    blocked-eval tables, each server's batcher, the slowest evals, and
    every live job short of (or over) its count with its evals and its
    latest deployment (read from the stopped servers' stores)."""
    from nomad_tpu_torch.structs.structs import ALLOC_DESIRED_RUN
    from nomad_tpu_torch.trace import lifecycle

    lines = []
    leader = next((s for s in replay.servers if s.is_leader), replay.servers[0])
    lines.append(f"leader {leader.name}: broker {json.dumps(leader.eval_broker.stats(), sort_keys=True)}; "
                 f"blocked {json.dumps(leader.blocked_evals.stats(), sort_keys=True)}")
    for s in replay.servers:
        lines.append(f"{s.name}: batcher {json.dumps(s.device_batcher.stats_snapshot(), sort_keys=True)}")
    lines.append(f"slowest in flight {json.dumps(lifecycle.slowest_inflight(3), default=str)}")
    ts = result.get("trace_summary") or {}
    lines.append(f"trace summary {json.dumps(ts, sort_keys=True, default=str)[:1500]}")
    lines.append(f"errors {result.get('errors', [])[:5]}")
    state = leader.fsm.state
    short = 0
    for (ns, jid), want in sorted(replay._expected.items()):
        run = [a for a in state.allocs_by_job(ns, jid, True) if a.desired_status == ALLOC_DESIRED_RUN]
        if len(run) == want and len({a.name for a in run}) == want:
            continue
        short += 1
        if short > 8:
            continue
        evals = sorted(state.evals_by_job(ns, jid), key=lambda e: e.create_index)
        dep = state.latest_deployment_by_job_id(ns, jid)
        lines.append(
            f"job {jid}: {len(run)}/{want} run ({len({a.name for a in run})} names); evals "
            f"{[(e.status, e.triggered_by, e.status_description[:40]) for e in evals[-6:]]}; "
            f"deployment {None if dep is None else (dep.status, dep.status_description[:60])}")
        # every alloc that ever held a doubled name, oldest first
        names = [a.name for a in run]
        doubled = {n for n in names if names.count(n) > 1}
        by_eval = {e.id: e.triggered_by for e in evals}
        for a in sorted(state.allocs_by_job(ns, jid, True), key=lambda a: a.create_index):
            if a.name in doubled:
                ds = a.deployment_status
                lines.append(
                    f"  {a.name} {a.id[:8]} {a.desired_status}/{a.client_status} "
                    f"v{a.job.version if a.job else '?'} dep {a.deployment_id[:8] or '-'} "
                    f"canary {bool(ds and ds.canary)} healthy {ds.healthy if ds else None} "
                    f"create {a.create_index} modify {a.modify_index} node {a.node_id[:8]} "
                    f"eval {by_eval.get(a.eval_id, '?')} prev {a.previous_allocation[:8] or '-'} "
                    f"next {a.next_allocation[:8] or '-'} "
                    f"preempted_by {a.preempted_by_allocation[:8] or '-'} "
                    f"transition {a.desired_transition}")
    lines.append(f"{short} jobs not at their count")
    return lines


class _ChurnTimeline:
    """Every 5 s of a churn run: the leader, its broker's table, its
    pending evals, each server's batcher dispatches, and where each
    worker, batcher and applier thread of the process stands (its
    innermost frames in the port), kept to print if the run fails."""

    def __init__(self, replay, every_s: float = 5.0):
        import threading

        self.replay, self.every_s, self.rows = replay, every_s, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="churn-timeline", daemon=True)

    def __enter__(self):
        self.t0 = time.monotonic()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        return False

    def _run(self):
        import sys as _sys
        import threading
        import traceback

        while not self._stop.wait(self.every_s):
            try:
                servers = list(self.replay.servers)
                leader = next((s for s in servers if s.is_leader), None)
                row = [f"t={time.monotonic() - self.t0:.0f}s leader="
                       f"{getattr(leader, 'name', None)}"]
                if leader is not None:
                    pending = [e for e in leader.fsm.state.evals() if e.status == "pending"]
                    row.append(f"broker {json.dumps(leader.eval_broker.stats(), sort_keys=True)} "
                               f"pending_evals {len(pending)} desired_run "
                               f"{leader.fsm.state.count_allocs_desired_run()}")
                row.append("dispatches " + json.dumps(
                    {s.name: s.device_batcher.stats_snapshot()["dispatches"] for s in servers}))
                names = {t.ident: t.name for t in threading.enumerate()}
                for ident, frame in _sys._current_frames().items():
                    name = names.get(ident, "?")
                    if not name.startswith(("worker", "device-batcher", "plan-apply",
                                            "pipeline")):
                        continue
                    frames = [f for f in traceback.extract_stack(frame)
                              if "nomad_tpu_torch" in f.filename][-3:]
                    row.append(f"  {name}: " + " < ".join(
                        f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in reversed(frames)))
                self.rows.append(row)
            except Exception as e:  # noqa: BLE001 — a sample may race the shutdown
                self.rows.append([f"sample failed: {e!r}"])


def phase_churn(kernels, step, parity, deterministic: bool, seed: int):
    """The port's ChurnReplay on the card: bench.py's chaos-churn-5K trace
    (seed ``seed``) against three in-process servers (num_schedulers=2,
    heartbeat TTL 1.5-2.5 s, the leader's flight recorder spilling into a
    temporary directory), with its throwaway warmup jobs (50, 25) before
    the window, at defaults (float) or with deterministic=True (int).
    Fails unless the invariants read zero lost, duplicated and orphaned
    allocs and converged, one leader kill ran, the injector is disarmed
    afterwards, the reference's SLO gate passes, the arm's kernel
    launched (the float run: K3 f32; the int run: K1 has_pre, an int
    launch with non-empty candidate tables), and every captured launch
    equals its plain version. Returns the run's record and the spy."""
    import tempfile

    from nomad_tpu_torch import chaos
    from nomad_tpu_torch.chaos import ChurnReplay, SLOGate, SLOThresholds, generate_trace
    from nomad_tpu_torch.server.server import ServerConfig

    import gc

    arm = "int" if deterministic else "float"
    duration_s = CHURN_DURATION_S[arm]
    gc.collect()
    trace = generate_trace(seed=seed, duration_s=duration_s, **CHURN_TRACE)
    with tempfile.TemporaryDirectory(prefix="churn-flight-") as spill:
        replay = ChurnReplay(
            seed=seed, trace=trace, n_servers=3, n_nodes=CHURN_NODES,
            config=ServerConfig(
                num_schedulers=2, heartbeat_min_ttl=1.5, heartbeat_max_ttl=2.5,
                heartbeat_grace=0.0,
                eval_gc_interval=3600.0, watchdog_stall_s=10.0, flight_spill_dir=spill,
                device=DEVICE, deterministic=deterministic),
            settle_timeout_s=90.0, warmup_counts=(50, 25))
        t0 = time.perf_counter()
        with _Spy(kernels) as spy, _ChurnTimeline(replay) as timeline:
            result = replay.run()
        wall_s = time.perf_counter() - t0
        spills = sorted(p.name for p in Path(spill).iterdir())
    slo = SLOGate(SLOThresholds(**CHURN_SLO)).evaluate(result)
    inv = result["invariants"]
    launches = spy.launches
    pre = [launch for launch in spy.batched if launch[0].dims["C"] > 0]
    batchers = {s.name: s.device_batcher.stats_snapshot() for s in replay.servers}
    dispatches = {name: st["dispatches"] for name, st in batchers.items()}
    # host ms inside the batchers' copy in, launch and synchronize: an
    # upper bound on the card's busy time in the run
    device_ms = sum(st["compute_ms_total"] for st in batchers.values())
    rec = {"arm": arm, "duration_s": duration_s, "trace_events": len(trace), "wall_s": wall_s,
           "result": result, "slo": slo, "launches": launches, "captured": len(spy.batched),
           "captured_has_pre": len(pre), "dispatches": dispatches, "flight_spills": spills,
           "device_ms": device_ms,
           "fallback_reasons": fallback_reasons(spy.reasons),
           "unported": spy.count("nomad.tpu_engine.unported")}
    bad = []
    if not (inv["lost"] == inv["duplicated"] == inv["orphaned"] == 0 and inv["converged"]):
        bad.append(f"invariants {inv}")
    if result["leader_kills"] != 1:
        bad.append(f"leader_kills {result['leader_kills']}")
    if chaos.active() is not None:
        bad.append("the injector is still armed")
    if not slo["passed"]:
        bad.append(f"SLO gate {[c for c in slo['checks'] if c['passed'] is False]}")
    kernel = "place_scan" if deterministic else "place_scan_f32"
    if launches[kernel] < 1 or not spy.batched:
        bad.append(f"no {kernel} launch: {launches}")
    if deterministic and (launches["place_scan_has_pre"] < 1 or not pre):
        bad.append(f"no has_pre launch (an int launch with candidate tables): {launches}")
    if bad:
        for row in timeline.rows:
            for line in row:
                log(f"  churn {arm} timeline: {line}")
        for line in churn_diagnostics(replay, result):
            log(f"  churn {arm} diagnostics: {line}")
        raise AssertionError(f"churn {arm}: " + "; ".join(bad))
    held = hold_churn_launches(step, parity, spy.batched, not deterministic, f"churn {arm}")
    rec["held"] = dict(zip(("launches", "evals", "worst_dscore", "plain_ms"), held))
    return rec, spy


def log_churn(rec, card):
    """The churn run's lines: allocs, eval latency, faults, launches,
    fallbacks, the critical-path ledger, the card."""
    r = rec["result"]
    ts = r["trace_summary"]
    rep = r["bottleneck_report"]
    log(f"churn {rec['arm']}: {rec['trace_events']} trace events over {rec['duration_s']:.0f} s, "
        f"{CHURN_NODES} nodes, 3 servers; wall {rec['wall_s']:.1f} s; total_allocs "
        f"{r['total_allocs']} ({r['throughput_allocs_per_s']} allocs/s); eval ms p50 "
        f"{ts.get('eval_ms_p50')} p99 {ts.get('eval_ms_p99')}; slowest in-flight "
        f"{ts.get('slowest_inflight_ms')} ms; on {card}")
    log(f"  invariants {json.dumps(r['invariants'], sort_keys=True)}; leader_kills "
        f"{r['leader_kills']}; events applied {r['events_applied']}, degraded "
        f"{r['events_degraded']}; errors {r['errors'][:3]}")
    log(f"  fault fires by point {json.dumps(r['fault_fires'], sort_keys=True)}")
    log(f"  SLO gate passed={rec['slo']['passed']}: " + "; ".join(
        f"{c['name']} {c['observed']} (bound {c['bound']})" for c in rec["slo"]["checks"]))
    log(f"  launches {json.dumps(rec['launches'], sort_keys=True)}; captured K3 launches "
        f"{rec['captured']} (has_pre {rec['captured_has_pre']}); batcher dispatches by server "
        f"{json.dumps(rec['dispatches'], sort_keys=True)}; unported {rec['unported']}")
    log(f"  fallback reasons by count {json.dumps(rec['fallback_reasons'], sort_keys=True)}")
    busy = rec["device_ms"] / 1e3 / rec["wall_s"]
    log(f"  batchers' copy in + launch + synchronize {rec['device_ms']:.1f} ms of the "
        f"{rec['wall_s']:.1f} s run: the card busy at most {busy * 100:.2f}%, idle at least "
        f"{(1 - busy) * 100:.2f}%")
    log(f"  bottleneck_report top 5 (coverage {rep.get('coverage')}, ok "
        f"{rep.get('coverage_ok')}): " + "; ".join(
            f"{e['component']} {e['seconds']} s ({e['share'] * 100:.1f}%)"
            for e in (rep.get("entries") or [])[:5]))
    st = r["stitched"]
    log(f"  stitched: {st['span_count']} spans, {st['trace_count']} traces, "
        f"{st['orphan_spans']} orphans; flight spills {rec['flight_spills']}")
    h = rec["held"]
    log(f"  every one of {h['launches']} captured launches ({h['evals']} evals) equal to the "
        f"plain version on its inputs ({'float: within the bound, worst |dscore| ' + str(h['worst_dscore']) if rec['arm'] == 'float' else 'int: bit for bit'}); "
        f"plain {h['plain_ms']:.1f} ms in all")


# ---------------------------------------------------------------------------
# the wire cluster, and the real-process crash and serve harnesses
# ---------------------------------------------------------------------------

# the wire cluster: three of the port's Servers in this process, each on
# its own WireRaft over a durable data dir and behind its own RPCServer
# (tests/test_wire_raft.py:255-310's arrangement at full width). The
# election timeout sits well above a GIL stall of this process (48
# workers, the batchers, six replicator threads, plan entries of ~1,000
# allocs packed in Python), and the RPC timeout above one AppendEntries
# of up to 512 such entries; the reference's defaults are 0.5-1.0 s and
# 1.0 s, sized for one server a process
#: the wire cluster's placements before and after its failover (60,000
#: and 10,000 before the devices phase, 20,000 and 5,000 before the client
#: phase, 10,000 and 2,500 before the agent phase, 7,500 before the nodes
#: phase; cut to make room for them: every captured launch is held against
#: the plain float step, 104.5 s of the phase's 170.8 s at 20,000)
WIRE_PLACEMENTS = 5_000
WIRE_FAILOVER_PLACEMENTS = 2_000
WIRE_RAFT = dict(election_timeout_min=2.0, election_timeout_max=4.0, heartbeat_interval=0.1,
                 rpc_timeout=30.0, apply_timeout=120.0)
# bench.py's chaos-crash-5K (bench.py:1263-1356) and serve-100Kwatch
# (bench.py:1506-1600), exactly
CRASH_TRACE = dict(duration_s=25.0, n_nodes=120, n_jobs=40, tg_count=25, stop_frac=0.25,
                   rollout_frac=0.2, n_drains=2, n_expiries=2, n_hipri=2, n_fault_windows=0,
                   n_preempt_waves=1, leader_kill=True)
CRASH_SLO = dict(eval_ms_p99_max=None, slowest_inflight_ms_max=None,
                 throughput_min_allocs_per_s=5.0, failover_new_leader_ms_max=5_000.0,
                 failover_first_commit_ms_max=10_000.0, require_rejoin=True,
                 stitched_attribution_coverage_min=0.9)
CRASH_SETTLE_S = 150.0
SERVE_TRACE = dict(duration_s=22.0, n_nodes=60, n_jobs=16, tg_count=16, stop_frac=0.2,
                   rollout_frac=0.15, n_drains=1, n_expiries=1, n_hipri=1, n_fault_windows=0,
                   leader_kill=False)
SERVE_WATCHERS = 5120
SERVE_SETTLE_S = 240.0
SERVE_SLO = dict(eval_ms_p99_max=None, slowest_inflight_ms_max=None,
                 throughput_min_allocs_per_s=1.0)


def _percentiles(values):
    vals = sorted(values)
    if not vals:
        return {"n": 0}
    pick = lambda q: vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]  # noqa: E731
    return {"n": len(vals), "p50": pick(0.5), "p99": pick(0.99), "max": vals[-1],
            "mean": sum(vals) / len(vals)}


class _WireSpy:
    """Times every codec encode of a raft entry (``wire_raft.codec_encode``:
    each replica's ``_append_locked``) with its bytes, and every
    ``WireRaft.apply`` (the leader's raft apply, replication to a quorum
    included); restored on exit."""

    def __init__(self):
        from nomad_tpu_torch.server import wire_raft

        self.mod, self.encodes, self.applies = wire_raft, [], []

    def __enter__(self):
        mod, cls = self.mod, self.mod.WireRaft
        self.orig = (mod.codec_encode, cls.apply)
        orig_encode, orig_apply = self.orig

        def encode(obj):
            t0 = time.perf_counter()
            out = orig_encode(obj)
            self.encodes.append(((time.perf_counter() - t0) * 1e3, len(out)))
            return out

        def apply(raft, peer, entry_type, payload):
            t0 = time.perf_counter()
            try:
                return orig_apply(raft, peer, entry_type, payload)
            finally:
                self.applies.append((time.perf_counter() - t0) * 1e3)

        mod.codec_encode, cls.apply = encode, apply
        return self

    def __exit__(self, *exc):
        self.mod.codec_encode, self.mod.WireRaft.apply = self.orig
        return False


def phase_wire_cluster(kernels, step, parity, seed: int):
    """Three of the port's Servers (ServerConfig defaults: the float arm,
    on the card, 16 Workers each) on WireRaft over TCP with durable data
    dirs, each behind its RPCServer with the whole endpoint surface. The
    C1M fleet goes in through ``raft_apply`` on the leader and the server
    phase's job mix (WIRE_PLACEMENTS) through ``Job.Register`` over the
    wire; then the leader's WireRaft and RPCServer stop (its Server stays
    up: the in-process stand-in of a kill), a new leader is elected, and
    a second mix of WIRE_FAILOVER_PLACEMENTS goes in through it. Fails
    unless the leader and then the new leader each launched K3, every
    captured launch equals its plain version, both survivors' FSMs hold
    the same allocs, no node is overcommitted and the invariant sweep
    reads zero. Returns the record and the spy."""
    import gc
    import os
    import shutil
    import tempfile
    import threading

    from nomad_tpu_torch import chaos, mock
    from nomad_tpu_torch.rpc import RPCClient, RPCServer, bind_server
    from nomad_tpu_torch.rpc import transport
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.wire_raft import LEADER, WireRaft, WireRaftConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit

    gc.collect()
    transport.reset_rpc_stats()
    base = tempfile.mkdtemp(prefix="wire-cluster-")
    ids = [f"wire-s{i}" for i in range(3)]
    rpcs = [RPCServer(host="127.0.0.1", port=0) for _ in ids]
    addrs = {nid: rpc.addr for nid, rpc in zip(ids, rpcs)}
    rafts = [WireRaft(rpc, {o: a for o, a in addrs.items() if o != nid},
                      WireRaftConfig(node_id=nid, **WIRE_RAFT),
                      data_dir=os.path.join(base, nid))
             for nid, rpc in zip(ids, rpcs)]
    # nothing heartbeats the fleet: a new leader's restored TTL timers
    # must outlive the run, as the server phase's nodes never expire
    servers = [Server(ServerConfig(num_schedulers=0, device=DEVICE, heartbeat_min_ttl=3600.0,
                                   heartbeat_max_ttl=7200.0), raft=raft, name=nid)
               for nid, raft in zip(ids, rafts)]
    for server, rpc, raft in zip(servers, rpcs, rafts):
        bind_server(server, rpc)
        rpc.is_leader = raft.is_leader
    stop = threading.Event()

    def leader_addr_loop():
        # followers forward writes to whoever raft says leads
        while not stop.wait(0.1):
            for rpc, raft in zip(rpcs, rafts):
                lid = raft.leader_id
                rpc.leader_addr = addrs.get(lid) if lid else None

    clients, stopped_raft = [], set()
    try:
        for rpc in rpcs:
            rpc.start()
        for server in servers:
            server.start()
            for i in range(SERVER_WORKERS):
                w = Worker(server, i)
                server.workers.append(w)
                w.start()
        for raft in rafts:
            raft.start()
        threading.Thread(target=leader_addr_loop, name="wire-leader-addr", daemon=True).start()

        def find_leader(min_term=0, exclude=(), timeout=60.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                for i, raft in enumerate(rafts):
                    if i not in exclude and raft.state == LEADER and raft.current_term > min_term:
                        return i
                time.sleep(0.01)
            raise AssertionError(f"wire: no leader past term {min_term} in {timeout} s")

        lead = find_leader()
        leader = servers[lead]
        fleet = c1m_nodes(mock, seed)
        t0 = time.perf_counter()
        for n in fleet:
            leader.raft_apply(NODE_REGISTER, n)
        fleet_s = time.perf_counter() - t0

        def run_mix(jobs, at, what):
            """Register ``jobs`` over the wire at server ``at`` and wait
            until every placement is in its FSM; (seconds, placements,
            the host clock when the first registration was committed)."""
            client = RPCClient(*rpcs[at].addr, timeout=120.0)
            clients.append(client)
            expected = sum(j.task_groups[0].count for j in jobs)
            state_fn = lambda: servers[at].fsm.state  # noqa: E731
            before = state_fn().count_allocs_desired_run()
            wall0 = time.perf_counter()
            first = None
            for job in jobs:
                if not client.call("Job.Register", job):
                    raise AssertionError(f"wire {what}: Job.Register of {job.id} gave no eval")
                first = first or time.perf_counter()
            deadline = time.monotonic() + 600
            while (state_fn().count_allocs_desired_run() - before < expected
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            wall = time.perf_counter() - wall0
            placed = state_fn().count_allocs_desired_run() - before
            if placed != expected or not servers[at].drain_evals(60.0):
                raise AssertionError(f"wire {what}: {placed} of {expected} placements "
                                     f"committed")
            return wall, placed, first

        jobs1 = c1m_mixed_jobs(mock, structs, WIRE_PLACEMENTS)
        jobs2 = c1m_mixed_jobs(mock, structs, WIRE_FAILOVER_PLACEMENTS)
        for j in jobs2:
            j.id = j.id.replace("c1m-", "wire2-")
        with _Spy(kernels) as spy, _WireSpy() as wspy:
            wall1, placed1, _ = run_mix(jobs1, lead, "before the failover")
            launches1 = dict(kernels.LAUNCHES)
            dispatch1 = {s.name: s.device_batcher.stats_snapshot()["dispatches"] for s in servers}
            applies1, encodes1 = len(wspy.applies), len(wspy.encodes)
            # the failover: the leader's raft and RPC stop, its Server not
            old_term = rafts[lead].current_term
            t_kill = time.perf_counter()
            rafts[lead].close()
            rpcs[lead].stop()
            stopped_raft.add(lead)
            lead2 = find_leader(min_term=old_term, exclude=(lead,))
            new_leader_ms = (time.perf_counter() - t_kill) * 1e3
            wall2, placed2, t_first = run_mix(jobs2, lead2, "after the failover")
            first_commit_ms = (t_first - t_kill) * 1e3
            launches2 = {k: v - launches1.get(k, 0) for k, v in kernels.LAUNCHES.items()}
            dispatch2 = {s.name: s.device_batcher.stats_snapshot()["dispatches"] - dispatch1[s.name]
                         for s in servers}
        survivors = [i for i in range(3) if i != lead]
        # the survivors' FSMs: the follower catches up to the new leader's
        # applied index before the comparison
        deadline = time.monotonic() + 120
        while (len({rafts[i].last_applied for i in survivors}) > 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        views = {}
        for i in survivors:
            views[ids[i]] = sorted((a.id, a.node_id, a.desired_status, a.client_status)
                                   for a in servers[i].fsm.state.allocs())
        state = servers[lead2].fsm.state
        expected = {(j.namespace, j.id): j.task_groups[0].count for j in jobs1 + jobs2}
        inv = chaos.invariant_sweep(state, expected, set())
        by_node = {}
        for a in state.allocs():
            if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status():
                by_node.setdefault(a.node_id, []).append(a)
        over = [n.name for n in state.nodes() if not allocs_fit(n, by_node.get(n.id, []))[0]]
        rpc_table = transport.rpc_stats(wire=True)
    finally:
        stop.set()
        for c in clients:
            c.close()
        for i, server in enumerate(servers):
            server.stop()
        for i, (raft, rpc) in enumerate(zip(rafts, rpcs)):
            if i not in stopped_raft:
                raft.close()
                rpc.stop()
        shutil.rmtree(base, ignore_errors=True)
    k3 = "place_scan_f32"
    bad = []
    if launches1.get(k3, 0) < 1 or dispatch1[ids[lead]] < 1:
        bad.append(f"the leader {ids[lead]} launched no K3 ({launches1}, {dispatch1})")
    if launches2.get(k3, 0) < 1 or dispatch2[ids[lead2]] < 1:
        bad.append(f"the new leader {ids[lead2]} launched no K3 ({launches2}, {dispatch2})")
    if len({tuple(v) for v in views.values()}) != 1:
        a, b = (set(v) for v in views.values())
        bad.append(f"survivors' FSMs differ: {len(a ^ b)} allocs in one only")
    if not (inv["lost"] == inv["duplicated"] == inv["orphaned"] == 0 and inv["converged"]):
        bad.append(f"invariants {inv}")
    if over:
        bad.append(f"{len(over)} nodes overcommitted, e.g. {over[:3]}")
    unported = spy.count("nomad.tpu_engine.unported")
    fallback = spy.count("nomad.tpu_engine.fallback")
    if unported or fallback:
        bad.append(f"unported={unported} fallback={fallback}")
    if bad:
        raise AssertionError("wire cluster: " + "; ".join(bad))
    held = hold_churn_launches(step, parity, spy.batched, True, "wire cluster")
    enc_ms = [e[0] for e in wspy.encodes]
    enc_bytes = [e[1] for e in wspy.encodes]
    append = rpc_table.get("Raft.AppendEntries", {})
    rec = {"fleet_s": fleet_s, "leader": ids[lead], "new_leader": ids[lead2],
           "placed": (placed1, placed2), "wall_s": (wall1, wall2),
           "placements_per_s": (placed1 / wall1, placed2 / wall2),
           "new_leader_ms": new_leader_ms, "first_commit_ms": first_commit_ms,
           "apply_ms": _percentiles(wspy.applies),
           "apply_ms_before": _percentiles(wspy.applies[:applies1]),
           "encode_ms": _percentiles(enc_ms), "encode_bytes": _percentiles(enc_bytes),
           "encodes": (encodes1, len(wspy.encodes) - encodes1),
           "launches": (launches1, launches2), "dispatches": (dispatch1, dispatch2),
           "append_entries": {k: append.get(k) for k in ("calls", "errors", "req_bytes",
                                                          "resp_bytes", "latency_ms_p50",
                                                          "latency_ms_p99")},
           "invariants": inv, "nodes_checked": len(state.nodes()),
           "held": dict(zip(("launches", "evals", "worst_dscore", "plain_ms"), held)),
           "launches_total": spy.launches, "captured": len(spy.batched)}
    return rec, spy


def log_wire(rec, card):
    w1, w2 = rec["wall_s"]
    p1, p2 = rec["placed"]
    r1, r2 = rec["placements_per_s"]
    log(f"wire cluster: 3 servers on WireRaft over TCP (durable native logs), the C1M fleet "
        f"({N_NODES} nodes) registered through raft_apply in {rec['fleet_s']:.3f} s; "
        f"{p1} placements through {rec['leader']} in {w1:.3f} s ({r1:.1f} placements/s); "
        f"failover: new leader {rec['new_leader']} in {rec['new_leader_ms']:.1f} ms, first "
        f"commit through it (Job.Register) {rec['first_commit_ms']:.1f} ms after the stop; "
        f"{p2} placements through it in {w2:.3f} s ({r2:.1f} placements/s); on {card}")
    a, ab = rec["apply_ms"], rec["apply_ms_before"]
    log(f"  raft apply ms (leader, quorum commit + local apply): p50 {a['p50']:.3f} p99 "
        f"{a['p99']:.3f} max {a['max']:.3f} over {a['n']} applies (before the failover: p50 "
        f"{ab['p50']:.3f} p99 {ab['p99']:.3f})")
    e, b = rec["encode_ms"], rec["encode_bytes"]
    log(f"  codec encode of a replicated entry (every replica's append, wirefmt): ms p50 "
        f"{e['p50']:.3f} p99 {e['p99']:.3f} mean {e['mean']:.3f}; bytes p50 {b['p50']} p99 "
        f"{b['p99']} mean {b['mean']:.0f}; {rec['encodes'][0]} + {rec['encodes'][1]} encodes")
    log(f"  Raft.AppendEntries over the wire: {json.dumps(rec['append_entries'], sort_keys=True)}")
    l1, l2 = rec["launches"]
    log(f"  K3 launches: leader {l1.get('place_scan_f32', 0)} (dispatches "
        f"{json.dumps(rec['dispatches'][0], sort_keys=True)}), new leader "
        f"{l2.get('place_scan_f32', 0)} (dispatches "
        f"{json.dumps(rec['dispatches'][1], sort_keys=True)}); survivors' FSMs equal; "
        f"invariants {json.dumps(rec['invariants'], sort_keys=True)}; {rec['nodes_checked']} "
        f"nodes, none overcommitted")
    h = rec["held"]
    log(f"  every one of {h['launches']} captured launches ({h['evals']} evals) equal to the "
        f"plain version on its inputs (float: within the bound, worst |dscore| "
        f"{h['worst_dscore']}); plain {h['plain_ms']:.1f} ms in all")


class _ContextWatch:
    """Samples ``nvidia-smi --query-compute-apps`` every ``interval`` s
    while a real-process phase runs: the pids that hold a CUDA context, so the
    phase can say whether its server processes touched the card."""

    def __init__(self, interval: float = 2.0):
        import threading

        self.interval = interval
        self.pids, self._stop = set(), threading.Event()
        self._thread = threading.Thread(target=self._run, name="context-watch", daemon=True)

    def _run(self):
        while True:
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=30)
                self.pids |= {int(x) for x in out.stdout.split() if x.strip().isdigit()}
            except (OSError, subprocess.SubprocessError, ValueError):
                pass
            if self._stop.wait(self.interval):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=40)
        return False


def _diagnosed(cls):
    """``cls`` (CrashReplay or ServeReplay) whose result also carries, for
    every job short of (or over) its count at the end, its evals and its
    allocs by status, read from the leader before the processes stop;
    a failing phase prints them."""

    class Diagnosed(cls):
        def _extra_result(self):
            out = super()._extra_result()
            rows = []
            try:
                call = self._leader(timeout=10.0).proc.call
                for (ns, jid), want in sorted(self._expected.items()):
                    allocs = call("Job.Allocations", ns, jid, timeout=30.0)
                    run = [a for a in allocs if a.desired_status == "run"]
                    if len(run) == want and len({a.name for a in run}) == want:
                        continue
                    short = sum(1 for r in rows if r.startswith("job "))
                    if short >= 8:
                        rows.append(f"job {jid}: {len(run)}/{want} run (and more)")
                        continue
                    by = {}
                    for a in allocs:
                        k = f"{a.desired_status}/{a.client_status}"
                        by[k] = by.get(k, 0) + 1
                    evals = sorted(call("Job.Evaluations", ns, jid, timeout=30.0),
                                   key=lambda e: e.create_index)
                    rows.append(f"job {jid}: {len(run)}/{want} run; allocs {by}; evals "
                                + str([(e.id[:8], e.status, e.triggered_by,
                                        e.status_description[:40], e.create_index,
                                        e.modify_index, e.blocked_eval[:8])
                                       for e in evals[-8:]]))
                rows.append(f"leader broker {call('Eval.BrokerStats', timeout=10.0)}")
            except Exception as e:  # noqa: BLE001 — diagnostics only
                rows.append(f"diagnostics failed: {e!r}")
            out["diagnostics"] = rows
            return out

    Diagnosed.__name__ = cls.__name__
    return Diagnosed


def _log_real_process_failure(what, result):
    for row in result.get("diagnostics") or []:
        log(f"  {what} diagnostics: {row}")
    for frame in (result.get("flight_tail") or [])[-2:]:
        log(f"  {what} flight frame: {json.dumps(frame, default=str)[:2000]}")
    log(f"  {what} failover {result.get('failover')}; errors {result.get('errors')}")
    for row in result.get("heartbeat_pump") or []:
        log(f"  {what} heartbeat pump: {json.dumps(row, sort_keys=True)}")


def _run_real_process(replay):
    """``replay.run()`` while tracking its server processes' pids and the
    pids that hold a CUDA context; (result, wall s, child pids, child
    pids with a context)."""
    import threading

    children, stop = set(), threading.Event()

    def track():
        while not stop.wait(0.5):
            children.update(sp.proc.pid for sp in list(replay.procs.values())
                            if sp.proc is not None)

    tracker = threading.Thread(target=track, name="replay-pids", daemon=True)
    tracker.start()
    t0 = time.perf_counter()
    try:
        with _ContextWatch() as ctx:
            result = replay.run()
    finally:
        stop.set()
        tracker.join(timeout=5)
    return result, time.perf_counter() - t0, sorted(children), sorted(children & ctx.pids)


def phase_crash(seed: int):
    """bench.py's chaos-crash-5K, exactly: three ``crash_server``
    processes (``--device cuda``, host binpack as in the reference), the
    leader SIGKILLed mid-trace, the killed server back from its data dir
    through InstallSnapshot; the reference's gate. Returns the record."""
    import gc

    from nomad_tpu_torch.chaos import CrashReplay, SLOGate, SLOThresholds, generate_trace

    gc.collect()
    trace = generate_trace(seed=seed, **CRASH_TRACE)
    replay = _diagnosed(CrashReplay)(seed=seed, trace=trace, n_servers=3,
                                     n_nodes=CRASH_TRACE["n_nodes"],
                                     settle_timeout_s=CRASH_SETTLE_S, device=DEVICE)
    result, wall, children, with_context = _run_real_process(replay)
    slo = SLOGate(SLOThresholds(**CRASH_SLO)).evaluate(result)
    fo = result.get("failover") or {}
    inv = result["invariants"]
    counts = {k: v for k, v in (result.get("replica_run_counts") or {}).items() if v is not None}
    bad = []
    if not slo["passed"]:
        bad.append(f"SLO gate {[c for c in slo['checks'] if c['passed'] is False]}")
    if not (inv["lost"] == inv["duplicated"] == inv["orphaned"] == 0 and inv["converged"]):
        bad.append(f"invariants {inv}")
    if result["leader_kills"] != 1 or int(fo.get("snapshot_installs") or 0) < 1:
        bad.append(f"leader_kills {result['leader_kills']}, failover {fo}")
    if len(counts) != 3 or len(set(counts.values())) != 1:
        bad.append(f"replica run counts {result.get('replica_run_counts')}")
    if bad:
        _log_real_process_failure("crash", result)
        raise AssertionError("crash: " + "; ".join(bad) + f"; errors {result['errors'][:5]}")
    return {"trace_events": len(trace), "wall_s": wall, "result": result, "slo": slo,
            "children": children, "children_with_context": with_context}


def pump_totals(result) -> dict:
    """The heartbeat pump's tallies over the run, summed (the slowest
    pass as the max)."""
    out = {}
    for row in result.get("heartbeat_pump") or []:
        for k, v in row.items():
            if isinstance(v, int):
                out[k] = max(out.get(k, 0), v) if k == "slowest_pass_ms" else out.get(k, 0) + v
    return out


def _stitched_components(result):
    rep = (result.get("stitched") or {}).get("report") or {}
    return {e["component"]: e["seconds"] for e in rep.get("entries") or []}, rep.get("coverage")


def log_crash(rec, card):
    r = rec["result"]
    fo = r["failover"]
    comps, cov = _stitched_components(r)
    log(f"crash (chaos-crash-5K): {rec['trace_events']} trace events over "
        f"{CRASH_TRACE['duration_s']:.0f} s, {CRASH_TRACE['n_nodes']} nodes, 3 crash_server "
        f"processes; wall {rec['wall_s']:.1f} s; total_allocs {r['total_allocs']} "
        f"({r['throughput_allocs_per_s']} allocs/s); on {card}")
    log(f"  failover: killed {fo.get('killed')}, new leader {fo.get('new_leader')} in "
        f"{fo.get('time_to_new_leader_ms')} ms, first commit {fo.get('time_to_first_commit_ms')} "
        f"ms, snapshot_installs {fo.get('snapshot_installs')} (snapshot index "
        f"{fo.get('snapshot_index')}), rejoined {fo.get('rejoined')} in "
        f"{fo.get('restart_catchup_ms')} ms")
    log(f"  invariants {json.dumps(r['invariants'], sort_keys=True)}; replica run counts "
        f"{json.dumps(r['replica_run_counts'], sort_keys=True)}")
    log(f"  SLO gate passed={rec['slo']['passed']}: " + "; ".join(
        f"{c['name']} {c['observed']} (bound {c['bound']})" for c in rec["slo"]["checks"]))
    st = r["stitched"]
    log(f"  stitched: {st['span_count']} spans, {st['trace_count']} traces across "
        f"{st.get('processes')}, coverage {cov}, components "
        f"{json.dumps(comps, sort_keys=True)}")
    log(f"  the card runs nothing in this phase: the server processes place with host "
        f"binpack as the reference's do (crash_server's scheduler_algorithm); child pids "
        f"{rec['children']}, of them holding a CUDA context: {rec['children_with_context']}")
    log(f"  heartbeat pump: {json.dumps(pump_totals(r), sort_keys=True)}")


def phase_serve(seed: int):
    """bench.py's serve-100Kwatch, exactly: 5,120 watchers parked in
    blocking ``Eval.GetEval`` reads across three ``crash_server``
    processes, two thirds as stale reads on followers, under the churn
    trace; the reference's five checks and SLO gate. Returns the record."""
    import gc

    from nomad_tpu_torch.chaos import SLOGate, SLOThresholds, generate_trace
    from nomad_tpu_torch.watch.serve import ServeReplay

    gc.collect()
    trace = generate_trace(seed=seed, **SERVE_TRACE)
    replay = _diagnosed(ServeReplay)(seed=seed, trace=trace, n_servers=3,
                                     n_nodes=SERVE_TRACE["n_nodes"],
                                     settle_timeout_s=SERVE_SETTLE_S,
                                     n_watchers=SERVE_WATCHERS, device=DEVICE)
    result, wall, children, with_context = _run_real_process(replay)
    serve = result.get("serve") or {}
    wake = serve.get("wakeup_ms") or {}
    slo = SLOGate(SLOThresholds(**SERVE_SLO)).evaluate(result)
    checks = [
        ("concurrent_watchers", serve.get("peak_concurrent_watchers", 0), ">= 5000",
         serve.get("peak_concurrent_watchers", 0) >= 5000),
        ("lost_wakeups", serve.get("lost_wakeups", -1), "== 0", serve.get("lost_wakeups", -1) == 0),
        ("wakeup_p99_ms", wake.get("p99"), "<= 2000",
         wake.get("p99") is not None and wake.get("p99") <= 2000.0),
        ("follower_read_share", serve.get("follower_read_share", 0.0), ">= 0.5",
         serve.get("follower_read_share", 0.0) >= 0.5),
        ("stragglers", serve.get("stragglers", -1), "== 0", serve.get("stragglers", -1) == 0),
    ]
    inv = result["invariants"]
    bad = [f"{n} {obs} (bound {b})" for n, obs, b, ok in checks if not ok]
    if not slo["passed"]:
        bad.append(f"SLO gate {[c for c in slo['checks'] if c['passed'] is False]}")
    if not (inv["lost"] == inv["duplicated"] == inv["orphaned"] == 0 and inv["converged"]):
        bad.append(f"invariants {inv}")
    if bad:
        _log_real_process_failure("serve", result)
        raise AssertionError("serve: " + "; ".join(bad) + f"; errors {result['errors'][:5]}")
    return {"trace_events": len(trace), "wall_s": wall, "result": result, "slo": slo,
            "checks": checks, "children": children, "children_with_context": with_context}


def log_serve(rec, card):
    r = rec["result"]
    s = r["serve"]
    w = s["wakeup_ms"]
    log(f"serve (serve-100Kwatch): {rec['trace_events']} trace events over "
        f"{SERVE_TRACE['duration_s']:.0f} s, {SERVE_TRACE['n_nodes']} nodes, 3 crash_server "
        f"processes, {SERVE_WATCHERS} watchers; wall {rec['wall_s']:.1f} s; total_allocs "
        f"{r['total_allocs']} ({r['throughput_allocs_per_s']} allocs/s); on {card}")
    log("  checks: " + "; ".join(f"{n} {obs} ({b}) passed={ok}" for n, obs, b, ok in rec["checks"])
        + f"; SLO gate passed={rec['slo']['passed']}")
    log(f"  wakeups {s['wakeups']} (ms p50 {w['p50']} p95 {w['p95']} p99 {w['p99']} max "
        f"{w['max']}), spurious {s['spurious_wakeups']}, deadline idle {s['deadline_idle']}, "
        f"ramp {s['ramp_s']} s to {s['ramp_parked']} parked, reads {s['reads_total']} "
        f"{json.dumps(s['reads_by_role'], sort_keys=True)}, coalesce ratio "
        f"{s['coalesce_ratio']}, beacon commits {s['beacon_commits']}, watcher errors "
        f"{s['watcher_errors']}")
    log(f"  invariants {json.dumps(r['invariants'], sort_keys=True)}; the card runs nothing in "
        f"this phase (host binpack in the server processes); child pids {rec['children']}, of "
        f"them holding a CUDA context: {rec['children_with_context']}; heartbeat pump "
        f"{json.dumps(pump_totals(r), sort_keys=True)}")


# -- the devices phase: GPU jobs from jobspec to the card -------------------

#: each node but the first: GPU_INSTANCES mock GPUs named as the host's
#: card; every FPGA_EVERY-th node also FPGA_INSTANCES mock FPGAs
GPU_INSTANCES, FPGA_INSTANCES, FPGA_EVERY = 8, 2, 4
FPGA_NAME = "alveo-u250"
#: the phase's service jobs: kind -> (jobs, count, GPUs a task, FPGAs a task);
#: counts an eighth of 2,000 / 1,000 and a quarter of 500 to fit the time
#: limit (a quarter of all three before the client phase; a partial
#: commit re-runs a device job's eval, and every launch is held against
#: the plain step, ~2.8-4.8 ms a step on an H100)
GPU_JOBS = {"gpu1": (8, 250, 1, 0), "gpu2": (2, 125, 2, 0), "mixed": (1, 125, 1, 1)}


def gpu_fleet(mock, n_nodes: int, seed: int, card_plugin, gpu_name: str):
    """The devices phase's fleet: ``n_nodes`` C1M-shaped nodes, each
    fingerprinted by its own ``DeviceManager``. Node 0 holds
    ``card_plugin`` (the real CUDA plugin on the card); every other node
    a mock plugin with GPU_INSTANCES instances of vendor nvidia, type gpu,
    named ``gpu_name``; every FPGA_EVERY-th node also a mock xilinx/fpga
    group of FPGA_INSTANCES. Returns (nodes, managers)."""
    import numpy as np

    from nomad_tpu_torch.client.devicemanager import DeviceManager
    from nomad_tpu_torch.plugins.mock_device import MockDevicePlugin

    rng = np.random.default_rng(seed)
    nodes, managers = [], []
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"{seed:08d}-0000-4000-9000-{i:012d}"
        n.name = f"gpu-{i}"
        n.node_resources.cpu_shares = int(rng.choice([4000, 8000, 16000]))
        n.node_resources.memory_mb = int(rng.choice([8192, 16384, 32768]))
        plugins = [card_plugin] if i == 0 else [
            MockDevicePlugin(vendor="nvidia", model=gpu_name, count=GPU_INSTANCES)]
        if i % FPGA_EVERY == FPGA_EVERY - 1:
            plugins.append(MockDevicePlugin(vendor="xilinx", model=FPGA_NAME,
                                            count=FPGA_INSTANCES, device_type="fpga"))
        dm = DeviceManager(plugins, fingerprint_interval=0)
        dm.fingerprint_node(n)
        n.compute_class()
        nodes.append(n)
        managers.append(dm)
    return nodes, managers


def gpu_job_hcl(job_id: str, kind: str, count: int, gpu_name: str, gpus: int = 1,
                fpgas: int = 0) -> str:
    """An HCL jobspec whose task asks for ``gpus`` of the card's GPUs and
    ``fpgas`` FPGAs. The asks name vendor/type/name in full: in the
    reference a two-part name is type/name (``RequestedDevice.id``), so
    ``"nvidia/gpu"`` would ask for a device of type ``nvidia``."""
    asks = [f'device "nvidia/gpu/{gpu_name}" {{\n          count = {gpus}\n        }}']
    if fpgas:
        asks.append(f'device "xilinx/fpga/{FPGA_NAME}" {{\n          count = {fpgas}\n        }}')
    count_line = "" if kind == "system" else f"count = {count}"
    body = "\n        ".join(asks)
    return f"""job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "{kind}"
  group "train" {{
    {count_line}
    task "trainer" {{
      driver = "mock_driver"
      resources {{
        cpu    = 100
        memory = 128
        {body}
      }}
    }}
  }}
}}
"""


def gpu_jobs(gpu_name: str, jobs=None):
    """The phase's jobspecs in registration order, as (job id, HCL): the
    system job asking one GPU on every node first, then the service jobs
    of ``jobs`` (GPU_JOBS' shape), the mixed GPU + FPGA job last."""
    out = [("gpu-system", gpu_job_hcl("gpu-system", "system", 1, gpu_name))]
    for kind, (n_jobs, count, gpus, fpgas) in (jobs or GPU_JOBS).items():
        for j in range(n_jobs):
            job_id = f"{kind}-{j}"
            out.append((job_id, gpu_job_hcl(job_id, "service", count, gpu_name, gpus, fpgas)))
    return out


#: the module:factory the devices phase's plugin process serves
CARD_PLUGIN = "nomad_tpu_torch.plugins.cuda_device:plugin"
#: the count the phase's second Job.Plan adds to the first GPU job
PLAN_EXTRA = 100

_CONTEXT_PROBE = """
import ctypes, json, sys
sys.path.insert(0, {repo!r})
from nomad_tpu_torch.plugins.cuda_device import CUDADevicePlugin
groups = CUDADevicePlugin().fingerprint()
cuda = ctypes.CDLL("libcuda.so.1")
dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
rc = [cuda.cuInit(0), cuda.cuDeviceGet(ctypes.byref(dev), 0),
      cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(active))]
print(json.dumps({{"groups": len(groups), "rc": rc, "primary_context": bool(active.value)}}))
"""


def context_probe() -> dict:
    """A process that only fingerprints with the cuda plugin, then asks
    the driver whether device 0's primary context is active in it."""
    out = subprocess.run([sys.executable, "-c", _CONTEXT_PROBE.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"devices: the context probe failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def device_ids(alloc) -> list:
    """An alloc's assigned device instances: [(type, instance id)]."""
    return [(d.type, i) for t in alloc.allocated_resources.tasks.values()
            for d in t.devices for i in d.device_ids]


def phase_devices(kernels, step, forced, parity, seed: int):
    """GPU jobs from jobspec to the card: the cuda plugin in a process of
    its own fingerprints the card for node 0 of a C1M-shaped fleet of
    N_NODES (``gpu_fleet``: every other node a mock GPU plugin, every
    FPGA_EVERY-th also a mock FPGA); the port's in-process Server, int
    arm, 16 workers; ``Job.Plan`` (``plan_job``, float arm as the
    reference) of the first GPU job before it is registered; the GPU
    system job (K4, D = 5), the GPU service jobs (K3, D = 5) and the GPU
    + FPGA job (D = 6), all parsed from HCL (``gpu_jobs``); ``Job.Plan``
    of the first job at PLAN_EXTRA more. Every job fully placed, no
    instance assigned twice or past what its node holds, the D = 6 job on
    FPGA nodes only, every captured K3 and K4 launch held against its
    plain version, the D = 6 eval replayed by the host binpack stack on
    its snapshot, node 0's allocs reserved by the plugin process as
    CUDA_VISIBLE_DEVICES. Returns (record, spy)."""
    import threading

    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.plugins.device import ExternalDevicePlugin
    from nomad_tpu_torch.plugins.launch import plugin_env
    from nomad_tpu_torch.plugins.transport import spawn_plugin
    from nomad_tpu_torch.scheduler.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit

    t_phase = time.perf_counter()
    gpu_name = torch.cuda.get_device_name(0)
    ordinals = [str(i) for i in range(torch.cuda.device_count())]
    card = ExternalDevicePlugin("cuda", spawn_plugin(
        [sys.executable, "-m", "nomad_tpu_torch.plugins.launch", "device", CARD_PLUGIN],
        env=plugin_env()))
    managers, server = [], None
    rec = {"gpu_name": gpu_name}
    orig_submit = Worker.submit_plan
    try:
        # the pids holding a CUDA context, sampled through the phase
        with _ContextWatch() as contexts:
            got = [(g.vendor, g.type, g.name, [d.id for d in g.devices])
                   for g in card.fingerprint()]
            if got != [("nvidia", "gpu", gpu_name, ordinals)]:
                raise AssertionError(f"devices: the cuda plugin process fingerprinted {got}")
            rec["probe"] = context_probe()
            t0 = time.perf_counter()
            nodes, managers = gpu_fleet(mock, N_NODES, seed, card, gpu_name)
            rec["fleet_s"] = time.perf_counter() - t0
            got = [(d.vendor, d.type, d.name, [i.id for i in d.instances])
                   for d in nodes[0].node_resources.devices]
            if got != [("nvidia", "gpu", gpu_name, ordinals)]:
                raise AssertionError(f"devices: node 0's devices are {got}")
            fpga_nodes = {n.id for n in nodes if n.attributes.get(
                f"device.xilinx.fpga.{FPGA_NAME}.count")}
            server = Server(ServerConfig(num_schedulers=0, deterministic=True, device=DEVICE),
                            name="smoke-devices")
            server.start()
            for n in nodes:
                server.raft_apply(NODE_REGISTER, n)
            specs = gpu_jobs(gpu_name)
            jobs = {job_id: parse_job(hcl) for job_id, hcl in specs}
            order = [job_id for job_id, _ in specs]
            system_id, first_id, mixed_id = order[0], order[1], order[-1]
            want = {j: (N_NODES if jobs[j].type == "system" else jobs[j].task_groups[0].count)
                    for j in order}
            for i in range(SERVER_WORKERS):
                w = Worker(server, i)
                server.workers.append(w)
                w.start()
            state = server.fsm.state
            deadline = time.monotonic() + 600

            def wait_placed(total):
                while state.count_allocs_desired_run() < total and time.monotonic() < deadline:
                    time.sleep(0.02)
                if not server.drain_evals(60.0):
                    raise AssertionError("devices: the broker did not drain")

            # plans the workers submit, and the partial commits among them (a
            # refreshed state comes back: the scheduler retries the eval)
            plans, plans_lock = {"submitted": 0, "partial": 0}, threading.Lock()

            def submit(worker, plan):
                result, new_state = orig_submit(worker, plan)
                with plans_lock:
                    plans["submitted"] += 1
                    plans["partial"] += new_state is not None
                return result, new_state

            def plan(job):
                first = len(spy.batched)
                t0 = time.perf_counter()
                out = server.plan_job(job, diff=True)
                return out, (time.perf_counter() - t0) * 1000.0, spy.batched[first:]

            Worker.submit_plan = submit
            with _Spy(kernels) as spy:
                (ann, failed, _, jdiff), rec["plan_ms"], plan_launches = plan(
                    copy.deepcopy(jobs[first_id]))
                placed = ann.desired_tg_updates["train"].place if ann else None
                if placed != want[first_id] or failed or jdiff["Type"] != "Added" or \
                        not plan_launches:
                    raise AssertionError(f"devices: Job.Plan of {first_id} placed {placed}, failed "
                                         f"{failed}, diff {jdiff['Type']}, {len(plan_launches)} "
                                         f"launches")
                wall0 = time.perf_counter()
                server.register_job(jobs[system_id])
                wait_placed(want[system_id])
                rec["system_s"] = time.perf_counter() - wall0
                for job_id in order[1:-1]:
                    server.register_job(jobs[job_id])
                wait_placed(sum(want[j] for j in order[:-1]))
                snap = state.snapshot()
                t0 = time.perf_counter()
                server.register_job(jobs[mixed_id])
                wait_placed(sum(want.values()))
                rec["mixed_s"] = time.perf_counter() - t0
                rec["wall_s"] = time.perf_counter() - wall0
                bigger = state.job_by_id("default", first_id).copy()
                bigger.task_groups[0].count += PLAN_EXTRA
                (ann2, failed2, _, diff2), rec["plan2_ms"], plan2_launches = plan(bigger)
                count = [f for tg in diff2["TaskGroups"] for f in tg["Fields"]
                         if f["Name"] == "Count"]
                placed2 = ann2.desired_tg_updates["train"].place if ann2 else None
                if (placed2 != PLAN_EXTRA or failed2 or not plan2_launches
                        or diff2["Type"] != "Edited" or [(f["Old"], f["New"]) for f in count]
                        != [(str(want[first_id]), str(want[first_id] + PLAN_EXTRA))]):
                    raise AssertionError(f"devices: Job.Plan at +{PLAN_EXTRA} placed {placed2}, "
                                         f"failed {failed2}, Count diff {count}")
            Worker.submit_plan = orig_submit
            launches, counted = spy.launches, spy.counted
            rec["plans"] = dict(plans)
            rec["evals_dequeued"] = counted.count("nomad.worker.dequeue_eval")
            rec["engine_calls"] = counted.count("nomad.tpu_engine.handled")
            rec["host_small"] = counted.count("nomad.tpu_engine.small_eval_host")
            rec["placements"] = sum(want.values())
            rec["placements_per_s"] = rec["placements"] / rec["wall_s"]
            rec["launches"] = launches
            rec["plan_launches"] = len(plan_launches) + len(plan2_launches)
            rec["k3_launches"] = len(spy.batched) - rec["plan_launches"]
            rec["k4_launches"] = len(spy.forced)
            stats = dict(server.device_batcher.stats)
            rec["evals_per_launch"] = stats["evals"] / max(stats["dispatches"], 1)
            unported = counted.count("nomad.tpu_engine.unported")
            fallback = counted.count("nomad.tpu_engine.fallback")
            if unported or fallback or not rec["k3_launches"] or not rec["k4_launches"]:
                raise AssertionError(f"devices: unported={unported} fallback={fallback} "
                                     f"launches={launches} reasons {fallback_reasons(spy.reasons)}")

            # every job fully placed; no instance twice, none past its node
            live = {j: [a for a in state.allocs_by_job("default", j, True)
                        if a.desired_status == structs.ALLOC_DESIRED_RUN
                        and not a.terminal_status()]
                    for j in order}
            short = {j: len(live[j]) for j in order if len(live[j]) != want[j]}
            if short:
                raise AssertionError(f"devices: jobs short of their count: {short}")
            by_node, ids = {}, {}
            for j in order:
                for a in live[j]:
                    by_node.setdefault(a.node_id, []).append(a)
                    ids.setdefault(a.node_id, []).extend(device_ids(a))
            held = {n.id: {(d.type, i.id) for d in n.node_resources.devices for i in d.instances}
                    for n in nodes}
            for node_id, assigned in ids.items():
                if len(assigned) != len(set(assigned)) or not set(assigned) <= held[node_id]:
                    raise AssertionError(f"devices: node {node_id} assigned {sorted(assigned)} of "
                                         f"{sorted(held[node_id])}")
            over = [n.name for n in state.nodes() if not allocs_fit(n, by_node.get(n.id, []))[0]]
            if over:
                raise AssertionError(f"devices: {len(over)} nodes overcommitted, e.g. {over[:3]}")
            off = [a.node_name for a in live[mixed_id] if a.node_id not in fpga_nodes]
            if off:
                raise AssertionError(f"devices: the D = 6 job placed on nodes without FPGAs: "
                                     f"{off[:3]}")
            rec["gpus_assigned"] = sum(1 for v in ids.values() for t, _ in v if t == "gpu")
            rec["fpgas_assigned"] = sum(1 for v in ids.values() for t, _ in v if t == "fpga")

            # node 0's allocs: the plugin process reserves the card
            on_card = by_node.get(nodes[0].id, [])
            envs = [managers[0].reserve([d for t in a.allocated_resources.tasks.values()
                                         for d in t.devices]).envs for a in on_card]
            card_env = {"CUDA_VISIBLE_DEVICES": ordinals[0]}
            if not on_card or any(e != card_env for e in envs):
                raise AssertionError(f"devices: node 0's reservations {envs}")
            rec["node0"] = {"allocs": [a.job_id for a in on_card], "envs": envs}

            # the D = 6 eval on its snapshot through the host binpack stack
            ev = [e for e in state.evals_by_job("default", mixed_id)
                  if e.triggered_by == structs.EVAL_TRIGGER_JOB_REGISTER][0].copy()
            ev.status = structs.EVAL_STATUS_PENDING
            oracle = Harness(state=snap, device=DEVICE)
            oracle._next_index = state.latest_index + 1
            oracle.state.scheduler_set_config(
                oracle.next_index(), structs.SchedulerConfiguration(scheduler_algorithm="binpack"))
            oracle.state.upsert_job(oracle.next_index(),
                                    state.job_by_id("default", mixed_id).copy())
            sched = new_scheduler("service", server.logger, oracle.snapshot(), oracle)
            sched.deterministic, sched.ring_decorrelate, sched.device = True, True, DEVICE
            t0 = time.perf_counter()
            sched.process(ev)
            rec["host_ms"] = (time.perf_counter() - t0) * 1000.0
            host = {a.name: a for v in oracle.plans[-1].node_allocation.values() for a in v}
            dev = {a.name: a for a in live[mixed_id]}
            rec["host_diverged"] = hold_host_plan("devices: the D = 6 eval", dev, host)
            same_node = [n for n in dev if dev[n].node_id == host[n].node_id]
            differ = [n for n in same_node
                      if sorted(device_ids(dev[n])) != sorted(device_ids(host[n]))]
            if differ:
                raise AssertionError(f"devices: instance ids differ from the host stack's: "
                                     f"{differ[:3]}")

            # every captured launch against its plain version: (D, float arm,
            # evals that ran a step, steps run, kernel ms, plain ms, bound ms,
            # bound by, worst |dscore|)
            rec["holds"] = []
            for i, launch in enumerate(spy.batched):
                fresh, after, out, out_layout = launch
                float_arm = fresh.parts()[0][0].dtype == torch.float32
                ran = ~packed_scan_results(after, out, out_layout)[1][3]
                rec["holds"].append((fresh.dims["D"], float_arm, int(ran.any(dim=1).sum()),
                                     int(ran.sum()), *replay_batched(
                                         kernels, step, parity, launch, f"devices K3 launch {i}",
                                         float_arm)))
            rec["k4"] = [replay_forced(kernels, forced, launch, f"devices K4 launch {i}")
                         for i, launch in enumerate(spy.forced)]
            rec["phase_s"] = time.perf_counter() - t_phase
        rec["plugin_holds_context"] = card.client.process.pid in contexts.pids
        return rec, spy
    finally:
        Worker.submit_plan = orig_submit
        if server is not None:
            server.stop()
        for dm in managers[1:]:
            dm.stop()
        card.close()


def log_devices(rec, card):
    """The devices phase's lines."""
    probe = rec["probe"]
    log(f"devices: {N_NODES} nodes ({rec['gpus_assigned']} GPU and {rec['fpgas_assigned']} FPGA "
        f"instances assigned, none twice, none overcommitted), fleet fingerprinted in "
        f"{rec['fleet_s']:.3f} s; {rec['placements']} placements in {rec['wall_s']:.3f} s "
        f"({rec['placements_per_s']:.1f} placements/s; system job {rec['system_s']:.3f} s, "
        f"D = 6 job {rec['mixed_s']:.3f} s) on {card}; phase wall {rec['phase_s']:.1f} s")
    log(f"  the cuda plugin's process: held a CUDA context during the phase (nvidia-smi): "
        f"{'yes' if rec['plugin_holds_context'] else 'no'}; a process that only fingerprints: "
        f"primary context active {probe['primary_context']} (driver rc {probe['rc']})")
    log(f"  Job.Plan: {rec['plan_ms']:.1f} ms (new job, {GPU_JOBS['gpu1'][1]} placements), "
        f"{rec['plan2_ms']:.1f} ms (+{PLAN_EXTRA}); {rec['plan_launches']} launches")
    log(f"  launches {json.dumps(rec['launches'], sort_keys=True)}: K3 {rec['k3_launches']} "
        f"(mean {rec['evals_per_launch']:.3f} evals a launch), K4 {rec['k4_launches']}; "
        f"{rec['evals_dequeued']} evals dequeued, {rec['plans']['submitted']} plans submitted, "
        f"{rec['plans']['partial']} partial commits (OCC retries of the eval), "
        f"{rec['engine_calls']} engine calls, {rec['host_small']} retries below "
        f"device_min_placements on the host")
    for d in sorted({h[0] for h in rec["holds"]}):
        for arm in (False, True):
            rows = [h for h in rec["holds"] if h[0] == d and h[1] == arm]
            if rows:
                log(f"  K3 D={d} {'f32' if arm else 'int'}: {len(rows)} launches, "
                    f"{sum(h[2] for h in rows)} evals, {sum(h[3] for h in rows)} steps; "
                    f"kernel ms {' '.join(f'{h[4]:.3f}' for h in rows)}; plain ms "
                    f"{sum(h[5] for h in rows):.1f} in all; bound ms "
                    f"{' '.join(f'{h[6]:.6f}' for h in rows)} ({rows[0][7]}); all equal to "
                    f"plain (worst |dscore| {max(h[8] for h in rows)})")
    for i, k in enumerate(rec["k4"]):
        log(f"  K4 launch {i}: kernel_ms={k[0]:.4f} plain_ms={k[1]:.2f} bound_ms={k[2]:.6f}")
    log(f"  node 0 ({rec['gpu_name']}): allocs {rec['node0']['allocs']} reserved as "
        f"{rec['node0']['envs']}; the D = 6 eval against the host binpack stack on its "
        f"snapshot: {rec['host_diverged']} placements differ (host {rec['host_ms']:.1f} ms)")


#: the client phase: real clients among the fleet, and job 2's allocs on each
CLIENTS = 4
CLIENT_ALLOCS = 200
#: the svc-exec service job's count
CLIENT_SVC_COUNT = 40
#: the client phase's own time limit, holds included
CLIENT_PHASE_S = 120.0
#: seconds the GPU task holds its CUDA context after it writes its
#: result, so that the phase's context watch sees its pid
GPU_TASK_HOLD_S = 3.0

#: the GPU task: a fixed integer computation on the card it was given, and
#: what it saw, into $NOMAD_TASK_DIR/gpu.json
GPU_TASK_SCRIPT = """
import ctypes, json, os, time
import torch
n = 1 << 20
total = int(torch.arange(n, device="cuda", dtype=torch.int64).sum().item())
props = torch.cuda.get_device_properties(0)
cuda = ctypes.CDLL("libcuda.so.1")
dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
rc = [cuda.cuDeviceGet(ctypes.byref(dev), 0),
      cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(active))]
out = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
       "device_count": torch.cuda.device_count(), "name": props.name,
       "uuid": str(getattr(props, "uuid", "")), "sum": total, "expected": n * (n - 1) // 2,
       "pid": os.getpid(), "primary_context": bool(active.value), "driver_rc": rc}
path = os.path.join(os.environ["NOMAD_TASK_DIR"], "gpu.json")
with open(path + ".tmp", "w") as f:
    json.dump(out, f)
os.replace(path + ".tmp", path)
time.sleep(float(os.environ.get("GPU_TASK_HOLD_S", "0")))
"""


def client_job_hcl(job_id: str, kind: str, driver: str, command: str, args, count=None,
                   cpu: int = 20, memory: int = 10, extra_task: str = "",
                   extra_group: str = "", extra_resources: str = "") -> str:
    """A jobspec of the client phase: one task limited to runner nodes,
    failing fast (no restart, no reschedule) where a task may fail."""
    count_line = "" if count is None else f"count = {count}"
    policy = ("" if kind == "system" else
              'restart {\n      attempts = 0\n      mode = "fail"\n    }\n'
              '    reschedule {\n      attempts = 0\n      unlimited = false\n    }')
    return f"""job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "{kind}"
  constraint {{
    attribute = "${{node.class}}"
    value     = "runner"
  }}
  group "run" {{
    {count_line}
    {policy}
    {extra_group}
    task "main" {{
      driver = "{driver}"
      config {{
        command = {json.dumps(command)}
        args    = {json.dumps(list(args))}
      }}
      {extra_task}
      resources {{
        cpu    = {cpu}
        memory = {memory}
        {extra_resources}
      }}
    }}
  }}
}}
"""


def _hcl_env(env) -> str:
    """A task's ``env`` block for these variables ("" for none)."""
    if not env:
        return ""
    return "env {\n        " + "\n        ".join(
        f"{k} = {json.dumps(v)}" for k, v in sorted(env.items())) + "\n      }"


def client_jobs(gpu_name: str, python: str, env=None):
    """The client phase's jobspecs: (job id, HCL) for the system job, the
    C1M density batch job (spread over the runners, each task writing its
    alloc index), the exec service job and the GPU task. ``env`` goes to
    the exec tasks, which get no variable of the client's own."""
    spread = 'spread {\n      attribute = "${node.unique.id}"\n    }'
    gpu_device = f'device "nvidia/gpu/{gpu_name}" {{\n          count = 1\n        }}'
    return [
        ("node-agent", client_job_hcl("node-agent", "system", "raw_exec", "/bin/sleep",
                                      ["3600"])),
        ("c1m-density", client_job_hcl(
            "c1m-density", "batch", "raw_exec", "/bin/sh",
            ["-c", "echo $NOMAD_ALLOC_INDEX > $NOMAD_TASK_DIR/index; echo $NOMAD_ALLOC_INDEX"],
            count=CLIENTS * CLIENT_ALLOCS, extra_group=spread)),
        ("svc-exec", client_job_hcl("svc-exec", "service", "exec", "/bin/sleep", ["3600"],
                                    count=CLIENT_SVC_COUNT, cpu=10, memory=10,
                                    extra_task=_hcl_env(env))),
        ("gpu-task", client_job_hcl("gpu-task", "batch", "exec", python,
                                    ["-c", GPU_TASK_SCRIPT], count=1, cpu=100, memory=256,
                                    extra_task=_hcl_env(dict(
                                        env or {}, GPU_TASK_HOLD_S=str(GPU_TASK_HOLD_S))),
                                    extra_resources=gpu_device)),
    ]


class _ProcWatch:
    """Samples this process's descendants every ``interval`` s: the pids
    of task, executor and logmon processes seen, and the peak number
    alive at once of tasks and of logmons."""

    def __init__(self, interval: float = 0.2):
        import os
        import threading

        self.root, self.interval = os.getpid(), interval
        self.seen = {"task": set(), "executor": set(), "logmon": set()}
        self.peak = {"task": 0, "executor": 0, "logmon": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="proc-watch", daemon=True)

    @staticmethod
    def _stat(pid: int):
        """(parent pid, state) of a pid, or None once it is gone."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
            return int(rest[1]), rest[0]
        except (OSError, IndexError, ValueError):
            return None

    @staticmethod
    def _kind(pid: int):
        """executor, logmon or task; None for the phase's own helpers
        (``_ContextWatch``'s nvidia-smi)."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            return None
        if argv[0].endswith(b"nvidia-smi"):
            return None
        if argv[0].endswith(b"nomad-executor"):
            return "executor"
        if any(a.endswith(b"logmon.py") for a in argv[:4]):
            return "logmon"
        return "task"

    def sample(self) -> None:
        import os

        parents = {}
        for name in os.listdir("/proc"):
            if name.isdigit():
                st = self._stat(int(name))
                if st is not None and st[1] != "Z":
                    parents[int(name)] = st[0]
        kids, frontier = set(), {self.root}
        while frontier:
            frontier = {p for p, pp in parents.items() if pp in frontier and p not in kids}
            kids |= frontier
        alive = {"task": 0, "executor": 0, "logmon": 0}
        for pid in kids:
            kind = self._kind(pid)
            if kind is not None:
                self.seen[kind].add(pid)
                alive[kind] += 1
        for kind, n in alive.items():
            self.peak[kind] = max(self.peak[kind], n)

    def _run(self):
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(self.interval)

    def alive(self) -> dict:
        """The pids seen that are still alive (not gone, not a zombie)."""
        out = {}
        for kind, pids in self.seen.items():
            live = []
            for pid in pids:
                st = self._stat(pid)
                if st is not None and st[1] != "Z":
                    live.append(pid)
            out[kind] = sorted(live)
        return out

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        return False


def _live_allocs(state, job_id):
    """A job's allocs, read under the store's lock (the FSM writes while
    the phase polls)."""
    return state.read_with_index(lambda s: s.allocs_by_job("default", job_id, True))[0]


def phase_client(kernels, step, forced, parity, seed: int):
    """The client runtime on the card: the port's in-process Server (int
    arm, SERVER_WORKERS workers, every eval on the device path) over
    N_NODES C1M-shaped nodes, CLIENTS of them the port's real ``Client``s
    (node class ``runner``, fingerprinted by ``fingerprint_node``; client
    0 runs the cuda device plugin, client 1 a SQLite state DB) over
    ``ServerProxy``, the rest registered through raft. Every job parsed
    from HCL (``client_jobs``) and limited to the runners: a system job
    (raw_exec, K4) on all four; C1M's density, CLIENT_ALLOCS raw_exec
    batch allocs a client, each writing its alloc index, its stdout
    through a logmon process; an exec service job through the native
    executor, run and then stopped; a GPU task (exec, this interpreter by
    absolute path) on the card the server assigned; the system job
    stopped. Holds every captured K3 and K4 launch against its plain
    version, and checks that no task, executor or logmon process is left.
    Returns (record, spy)."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import Client, ClientConfig, ServerProxy
    from nomad_tpu_torch.client.logmon import read_logs
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.server.fsm import NODE_REGISTER
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit

    t_phase = time.perf_counter()
    deadline = time.monotonic() + CLIENT_PHASE_S
    gpu_name = torch.cuda.get_device_name(0)
    rec = {"gpu_name": gpu_name}
    root = tempfile.mkdtemp(prefix="smoke-clients-")
    server, clients = None, []

    def wait(cond, what):
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"client: {what} not reached within the phase's "
                                     f"{CLIENT_PHASE_S:.0f} s")
            time.sleep(0.02)

    try:
        with _ProcWatch() as procs, _ContextWatch(interval=0.5) as contexts:
            server = Server(ServerConfig(num_schedulers=SERVER_WORKERS, deterministic=True,
                                         device=DEVICE, device_min_placements=0),
                            name="smoke-client")
            server.start()
            fleet = c1m_nodes(mock, seed)[:N_NODES - CLIENTS]
            for n in fleet:
                server.raft_apply(NODE_REGISTER, n)
            for i in range(CLIENTS):
                cfg = ClientConfig(state_dir=os.path.join(root, f"client-{i}"),
                                   node_class="runner", persist_state=(i == 1),
                                   gc_interval=3600.0, gc_max_allocs=10 * CLIENT_ALLOCS,
                                   device_plugins={"cuda": {}} if i == 0 else {})
                c = Client(ServerProxy(server), cfg)
                c.node.name = f"runner-{i}"
                clients.append(c)
                c.start()
            state = server.fsm.state
            wait(lambda: all(state.node_by_id(c.node.id) is not None for c in clients),
                 "the clients' registration")
            rec["nodes"] = state.read_with_index(lambda s: len(s.nodes()))[0]
            if rec["nodes"] != N_NODES:
                raise AssertionError(f"client: {rec['nodes']} nodes registered, not {N_NODES}")
            runner_ids = {c.node.id: i for i, c in enumerate(clients)}
            card_node = state.node_by_id(clients[0].node.id)
            got = [(d.vendor, d.type, d.name) for d in card_node.node_resources.devices]
            if got != [("nvidia", "gpu", gpu_name)]:
                raise AssertionError(f"client: client 0's node advertises {got}")
            for c in clients:
                bad = [d for d in ("raw_exec", "exec") if not c.node.drivers[d].healthy]
                if bad:
                    raise AssertionError(f"client: {c.node.name}'s drivers {bad} unhealthy")

            env = {k: os.environ[k] for k in ("LD_LIBRARY_PATH",) if os.environ.get(k)}
            specs = dict(client_jobs(gpu_name, sys.executable, env))
            jobs = {k: parse_job(v) for k, v in specs.items()}
            with _Spy(kernels) as spy:
                # 1. the system job: one alloc a runner, through K4
                t0 = time.perf_counter()
                server.register_job(jobs["node-agent"])
                wait(lambda: sorted(a.client_status for a in _live_allocs(state, "node-agent"))
                     == ["running"] * CLIENTS, "node-agent running on every runner")
                rec["system_s"] = time.perf_counter() - t0

                # 2. C1M's density: CLIENT_ALLOCS batch allocs a client
                want = CLIENTS * CLIENT_ALLOCS
                done_at = {}

                def density_done():
                    now = time.perf_counter()
                    allocs = _live_allocs(state, "c1m-density")
                    for a in allocs:
                        if a.client_status == structs.ALLOC_CLIENT_COMPLETE:
                            done_at.setdefault(a.id, now)
                    bad = [a.name for a in allocs if a.client_status == "failed"]
                    if bad:
                        raise AssertionError(f"client: c1m-density allocs failed: {bad[:3]}")
                    return len(done_at) == want

                t0 = time.perf_counter()
                server.register_job(jobs["c1m-density"])
                wait(lambda: len(_live_allocs(state, "c1m-density")) == want,
                     "c1m-density placed")
                rec["density_place_s"] = time.perf_counter() - t0
                wait(density_done, "c1m-density complete")
                t_done = time.perf_counter()
                rec["density_s"] = t_done - t0
                rec["density_placements_per_s"] = want / rec["density_place_s"]
                first = min(done_at.values())
                rec["allocs_complete_per_s"] = want / max(t_done - first, 1e-9)

                # 3. the exec service job: running, then stopped
                t_reg = time.time_ns()
                server.register_job(jobs["svc-exec"])
                wait(lambda: [a.client_status for a in _live_allocs(state, "svc-exec")]
                     == ["running"] * CLIENT_SVC_COUNT, "svc-exec running")
                starts = sorted((min(ts.started_at_ns for ts in a.task_states.values())
                                 - t_reg) / 1e6 for a in _live_allocs(state, "svc-exec"))
                pct = _percentiles(starts)
                rec["svc_p50_ms"], rec["svc_p99_ms"] = pct["p50"], pct["p99"]
                exec_pids = []
                for c in clients:
                    for ar in list(c.allocrunners.values()):
                        if ar.alloc.job_id == "svc-exec":
                            for tr in ar.task_runners.values():
                                ds = tr.handle.driver_state
                                exec_pids.append(ds["pid"])
                                with open(ds["pid_file"]) as f:
                                    exec_pids.append(int(f.read().strip()))
                server.deregister_job("default", "svc-exec")
                wait(lambda: all(a.client_status == structs.ALLOC_CLIENT_COMPLETE
                                 for a in _live_allocs(state, "svc-exec")), "svc-exec stopped")
                wait(lambda: not [p for p in exec_pids if _ProcWatch._stat(p) is not None
                                  and _ProcWatch._stat(p)[1] != "Z"],
                     "svc-exec's executors and tasks gone")
                rec["svc_pids"] = len(exec_pids)

                # 4. the GPU task, on the card the server assigned
                server.register_job(jobs["gpu-task"])
                wait(lambda: [a.client_status for a in _live_allocs(state, "gpu-task")]
                     == ["complete"], "gpu-task complete")
                (gpu_alloc,) = _live_allocs(state, "gpu-task")

                # 5. the system job stopped
                server.deregister_job("default", "node-agent")
                wait(lambda: all(a.client_status == structs.ALLOC_CLIENT_COMPLETE
                                 for a in _live_allocs(state, "node-agent")),
                     "node-agent stopped")
                if not server.drain_evals(max(deadline - time.monotonic(), 1.0)):
                    raise AssertionError("client: the broker did not drain")
            launches, counted = spy.launches, spy.counted
            rec["launches"] = launches
            rec["k3_launches"] = len(spy.batched)
            rec["k4_launches"] = len(spy.forced)
            stats = dict(server.device_batcher.stats)
            rec["evals_per_launch"] = stats["evals"] / max(stats["dispatches"], 1)
            unported = counted.count("nomad.tpu_engine.unported")
            fallback = counted.count("nomad.tpu_engine.fallback")
            host_small = counted.count("nomad.tpu_engine.small_eval_host")
            if unported or fallback or host_small or not rec["k3_launches"] \
                    or not rec["k4_launches"]:
                raise AssertionError(f"client: unported={unported} fallback={fallback} "
                                     f"host_small={host_small} launches={launches} "
                                     f"reasons {fallback_reasons(spy.reasons)}")

            # placements: runners only, 200 a client, none overcommitted
            by_node = {}
            for job_id in specs:
                for a in _live_allocs(state, job_id):
                    if a.node_id not in runner_ids:
                        raise AssertionError(f"client: {a.name} placed on {a.node_name}, "
                                             f"not a runner")
                    by_node.setdefault(a.node_id, []).append(a)
            nodes = state.read_with_index(lambda s: list(s.nodes()))[0]
            over = [n.name for n in nodes if not allocs_fit(n, by_node.get(n.id, []))[0]]
            if over:
                raise AssertionError(f"client: nodes overcommitted: {over[:3]}")
            density = [sum(a.job_id == "c1m-density" for a in by_node.get(c.node.id, []))
                       for c in clients]
            rec["density_per_client"] = density
            if density != [CLIENT_ALLOCS] * CLIENTS:
                raise AssertionError(f"client: c1m-density allocs per client {density}")

            # job 2's files: each its alloc's index, its stdout in logmon's file
            bad = []
            for a in _live_allocs(state, "c1m-density"):
                c = clients[runner_ids[a.node_id]]
                task_dir = os.path.join(c.alloc_dir_base, a.id, "main")
                with open(os.path.join(task_dir, "local", "index")) as f:
                    if f.read().strip() != str(a.index()):
                        bad.append(a.name)
                log_dir = os.path.join(c.alloc_dir_base, a.id, "alloc", "logs")
                out, _ = read_logs(log_dir, "main", "stdout")
                if out.decode().strip() != str(a.index()) or \
                        not os.path.exists(os.path.join(log_dir, "main.stdout.0")):
                    bad.append(a.name + " (log)")
            if bad:
                raise AssertionError(f"client: {len(bad)} of job 2's files wrong: {bad[:3]}")

            # the GPU task: one device, the card the server assigned
            (dev,) = [d for t in gpu_alloc.allocated_resources.tasks.values() for d in t.devices]
            (ordinal,) = dev.device_ids
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            entry = visible.split(",")[int(ordinal)].strip() if visible else ordinal
            want_uuid = str(torch.cuda.get_device_properties(int(ordinal)).uuid)
            c0 = clients[runner_ids[gpu_alloc.node_id]]
            with open(os.path.join(c0.alloc_dir_base, gpu_alloc.id, "main", "local",
                                   "gpu.json")) as f:
                gpu = json.load(f)
            rec["gpu"] = dict(gpu, assigned=ordinal, want_uuid=want_uuid,
                              held_context_smi=gpu["pid"] in contexts.pids,
                              smi_pids=len(contexts.pids),
                              smi_sees_self=os.getpid() in contexts.pids)
            if (gpu["device_count"] != 1 or gpu["CUDA_VISIBLE_DEVICES"] != entry
                    or gpu["uuid"] != want_uuid or gpu["sum"] != gpu["expected"]
                    or gpu["name"] != gpu_name or not gpu["primary_context"]):
                raise AssertionError(f"client: the GPU task saw {gpu}; the server assigned "
                                     f"ordinal {ordinal} ({entry}, uuid {want_uuid})")

            # every captured launch against its plain version (int arm)
            rec["holds"] = []
            for i, launch in enumerate(spy.batched):
                fresh, after, out, out_layout = launch
                if fresh.parts()[0][0].dtype == torch.float32:
                    raise AssertionError(f"client: K3 launch {i} ran the float arm")
                ran = ~packed_scan_results(after, out, out_layout)[1][3]
                rec["holds"].append((fresh.dims["D"], False, int(ran.any(dim=1).sum()),
                                     int(ran.sum()), *replay_batched(
                                         kernels, step, parity, launch, f"client K3 launch {i}",
                                         False)))
            rec["k4"] = [replay_forced(kernels, forced, launch, f"client K4 launch {i}")
                         for i, launch in enumerate(spy.forced)]

            for c in clients:
                c.shutdown()
            procs.sample()
            rec["peak"] = dict(procs.peak)
            rec["seen"] = {k: len(v) for k, v in procs.seen.items()}
            wait(lambda: not any(procs.alive().values()), "every task, executor and logmon gone")
            rec["phase_s"] = time.perf_counter() - t_phase
            if rec["phase_s"] > CLIENT_PHASE_S:
                raise AssertionError(f"client: the phase took {rec['phase_s']:.1f} s")
        return rec, spy
    finally:
        for c in clients:
            c.shutdown()
        if server is not None:
            server.stop()
        shutil.rmtree(root, ignore_errors=True)


def log_client(rec, card):
    """The client phase's lines."""
    gpu = rec["gpu"]
    log(f"client: {rec['nodes']} nodes, {CLIENTS} of them the port's Clients; system job "
        f"running on every runner in {rec['system_s']:.3f} s; c1m-density: "
        f"{CLIENTS * CLIENT_ALLOCS} raw_exec allocs ({rec['density_per_client']} a client) "
        f"placed in {rec['density_place_s']:.3f} s ({rec['density_placements_per_s']:.1f} "
        f"placements/s), registration to the last complete {rec['density_s']:.3f} s, "
        f"{rec['allocs_complete_per_s']:.1f} allocs complete/s, every index file and logmon "
        f"stdout file right; on {card}; phase wall {rec['phase_s']:.1f} s")
    log(f"  svc-exec: {CLIENT_SVC_COUNT} exec allocs, register to running p50 "
        f"{rec['svc_p50_ms']:.1f} ms p99 {rec['svc_p99_ms']:.1f} ms; stopped, its "
        f"{rec['svc_pids']} executor and task pids gone")
    log(f"  processes: peak live tasks {rec['peak']['task']}, executors "
        f"{rec['peak']['executor']}, logmons {rec['peak']['logmon']} (seen "
        f"{json.dumps(rec['seen'], sort_keys=True)}); none left at the end")
    log(f"  gpu-task: assigned ordinal {gpu['assigned']} (uuid {gpu['want_uuid']}); the task "
        f"saw CUDA_VISIBLE_DEVICES={gpu['CUDA_VISIBLE_DEVICES']}, {gpu['device_count']} "
        f"device, {gpu['name']} uuid {gpu['uuid']}, sum {gpu['sum']} (right); its pid "
        f"{gpu['pid']} held a CUDA context: primary context active in the task "
        f"{gpu['primary_context']}, in nvidia-smi's compute apps "
        f"{'yes' if gpu['held_context_smi'] else 'no'} (nvidia-smi listed {gpu['smi_pids']} "
        f"pids in the phase, this process among them: {'yes' if gpu['smi_sees_self'] else 'no'})")
    log(f"  launches {json.dumps(rec['launches'], sort_keys=True)}: K3 {rec['k3_launches']} "
        f"(mean {rec['evals_per_launch']:.3f} evals a launch), K4 {rec['k4_launches']}")
    for d in sorted({h[0] for h in rec["holds"]}):
        rows = [h for h in rec["holds"] if h[0] == d]
        log(f"  K3 D={d} int: {len(rows)} launches, {sum(h[2] for h in rows)} evals, "
            f"{sum(h[3] for h in rows)} steps; kernel ms "
            f"{' '.join(f'{h[4]:.3f}' for h in rows)}; plain ms {sum(h[5] for h in rows):.1f} "
            f"in all; bound ms {' '.join(f'{h[6]:.6f}' for h in rows)} ({rows[0][7]}); all "
            f"equal to plain")
    for i, k in enumerate(rec["k4"]):
        log(f"  K4 launch {i}: kernel_ms={k[0]:.4f} plain_ms={k[1]:.2f} bound_ms={k[2]:.6f}")


#: the agent phase: the template mix's placements over the fleet (10,000
#: before the nodes phase; cut to make room for it: every K3 launch is held
#: against the plain float step), the batch job's allocs on the agent's own
#: client, the heartbeat pump's rest between passes, the server's heartbeat
#: grace (a node expires AGENT_GRACE_S plus its 10-30 s TTL after its last
#: heartbeat; at 10 s, a pump pass over the 5,000 nodes that outlasted
#: 15 s on a loaded host let the shortest TTLs expire, and the system job
#: then missed nodes), the phase's own time limit (holds included) and the
#: real agent process's time to serve, place and stop
AGENT_PLACEMENTS = 5_000
AGENT_BATCH = 50
AGENT_PUMP_S = 5.0
AGENT_GRACE_S = 60
AGENT_PHASE_S = 240.0
AGENT_PROC_S = 90.0
#: the datacenter of the agent's own client node (the fleet is in dc1)
AGENT_DC = "smoke"


def agent_config_hcl(root: str, device: str) -> str:
    """The phase's agent config file: server and client in one agent on
    the given device, SERVER_WORKERS schedulers, ephemeral ports."""
    return f"""name       = "smoke-agent"
datacenter = "{AGENT_DC}"
data_dir   = {json.dumps(root)}
bind_addr  = "127.0.0.1"
device     = "{device}"

ports {{
  http = 0
  rpc  = 0
  serf = 0
}}

server {{
  enabled         = true
  num_schedulers  = {SERVER_WORKERS}
  heartbeat_grace = "{AGENT_GRACE_S}s"
}}

client {{
  enabled    = true
  node_class = "smoke-runner"
}}
"""


def c1m_job_hcl(tpl, job_id: str, count: int) -> str:
    """A C1M template (``c1m_templates``) as a jobspec over the dc1 fleet:
    the ask, the count, 50 MB of ephemeral disk, the spread and affinity
    stanzas of the first ten, one exec task."""
    stanzas = ""
    if tpl["stanzas"]:
        stanzas = """spread {
      attribute = "${node.datacenter}"
      weight    = 50
      target "dc1" {
        percent = 100
      }
    }
    affinity {
      attribute = "${attr.kernel.name}"
      value     = "linux"
      weight    = 50
    }"""
    return f"""job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "{tpl['kind']}"
  group "web" {{
    count = {count}
    ephemeral_disk {{
      size = 50
    }}
    {stanzas}
    task "web" {{
      driver = "exec"
      config {{
        command = "/bin/date"
      }}
      resources {{
        cpu    = {tpl['cpu']}
        memory = {tpl['mem']}
      }}
    }}
  }}
}}
"""


def c1m_mix_hcl(total: int, prefix: str = "c1m"):
    """``c1m_mixed_jobs`` as jobspecs: (job id, count, HCL), the templates
    round-robin until the placement count is exactly ``total``."""
    templates = c1m_templates()
    out, placed, i = [], 0, 0
    while placed < total:
        tpl = templates[i % len(templates)]
        count = min(tpl["count"], total - placed)
        out.append((f"{prefix}-{i}", count, c1m_job_hcl(tpl, f"{prefix}-{i}", count)))
        placed += count
        i += 1
    return out


def agent_jobs():
    """The agent phase's other jobspecs: (job id, HCL) of the raw_exec
    batch job on the agent's own client (each task prints its alloc
    index) and the raw_exec system job over every node."""
    batch = f"""job "smoke-batch" {{
  datacenters = ["{AGENT_DC}"]
  type        = "batch"
  group "run" {{
    count = {AGENT_BATCH}
    restart {{
      attempts = 0
      mode     = "fail"
    }}
    task "main" {{
      driver = "raw_exec"
      config {{
        command = "/bin/sh"
        args    = ["-c", "echo $NOMAD_ALLOC_INDEX"]
      }}
      resources {{
        cpu    = 20
        memory = 10
      }}
    }}
  }}
}}
"""
    system = f"""job "smoke-system" {{
  datacenters = ["dc1", "{AGENT_DC}"]
  type        = "system"
  group "agent" {{
    task "collect" {{
      driver = "raw_exec"
      config {{
        command = "/bin/sleep"
        args    = ["3600"]
      }}
      resources {{
        cpu    = 10
        memory = 10
      }}
    }}
  }}
}}
"""
    return [("smoke-batch", batch), ("smoke-system", system)]


def cli_start(args, addr=None):
    """``python -m nomad_tpu_torch.cli [-address=<addr>] <args>`` from the
    repo root, output piped."""
    import os

    argv = ([f"-address={addr}"] if addr else []) + list(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-m", "nomad_tpu_torch.cli", *argv],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def cli_run(args, addr=None, ok=(0,), timeout=120.0):
    """Run the port's CLI to its end: (output, wall ms); fails unless its
    exit code is in ``ok``."""
    t0 = time.perf_counter()
    proc = cli_start(args, addr)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"agent: `{' '.join(args)}` did not end in {timeout:.0f} s: "
                             f"{out[-1500:]}")
    if proc.returncode not in ok:
        raise AssertionError(f"agent: `{' '.join(args)}` exited {proc.returncode}: "
                             f"{out[-1500:]}")
    return out, (time.perf_counter() - t0) * 1e3


def http_json(url, timeout=30.0):
    """(decoded JSON, the X-Nomad-Index header) of a GET."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read() or b"null"), int(r.headers.get("X-Nomad-Index") or 0)


def _free_local_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def metrics_view(addr):
    """(gauges, counters) of the agent's /v1/metrics by name."""
    m, _ = http_json(addr + "/v1/metrics")
    return ({g["Name"]: g["Value"] for g in m.get("Gauges") or []},
            {c["Name"]: c["Count"] for c in m.get("Counters") or []})


def phase_agent_process(root: str) -> dict:
    """The real entry point: ``python -m nomad_tpu_torch.cli agent -dev``
    as a process of its own (the card by default), a raw_exec batch job of
    AGENT_BATCH allocs through the CLI to ``complete``, the engine's device
    dispatches read from /v1/metrics (above 0, and no host fallback), then
    SIGINT: the agent must exit 0 within 30 s. Returns its times."""
    import os
    import signal

    deadline = time.monotonic() + AGENT_PROC_S
    http_port, rpc_port = _free_local_port(), _free_local_port()
    addr = f"http://127.0.0.1:{http_port}"
    argv = ["agent", "-dev", "-http-port", str(http_port), "-rpc-port", str(rpc_port),
            "-data-dir", os.path.join(root, "dev-agent")]
    if DEVICE != "cuda":
        argv += ["-device", DEVICE]
    rec = {}
    t0 = time.perf_counter()
    proc = cli_start(argv)
    lines = []

    def wait(cond, what):
        while not cond():
            if proc.poll() is not None:
                raise AssertionError(f"agent process: exited {proc.returncode} before {what}")
            if time.monotonic() > deadline:
                raise AssertionError(f"agent process: {what} not reached in {AGENT_PROC_S:.0f} s")
            time.sleep(0.05)

    def leader():
        try:
            out, _ = http_json(addr + "/v1/status/leader", timeout=2.0)
        except OSError:
            return None
        rec.setdefault("http_ready_s", time.perf_counter() - t0)
        return out or None

    try:
        wait(leader, "a leader over HTTP")
        rec["leader_s"] = time.perf_counter() - t0
        wait(lambda: any(n["Status"] == "ready" for n in http_json(addr + "/v1/nodes")[0] or []),
             "its client node ready")
        job = os.path.join(root, "dev-batch.hcl")
        with open(job, "w") as f:
            f.write(dict(agent_jobs())["smoke-batch"].replace(
                f'datacenters = ["{AGENT_DC}"]', 'datacenters = ["dc1"]').replace(
                '"smoke-batch"', '"dev-batch"'))
        seen_fallback = []

        def complete():
            allocs, _ = http_json(addr + "/v1/job/dev-batch/allocations")
            seen_fallback.append(metrics_view(addr)[1].get(
                "nomad.tpu_engine.dispatch_fallback_host", 0))
            if any(a["ClientStatus"] == "failed" for a in allocs or []):
                raise AssertionError(f"agent process: dev-batch allocs failed")
            return len(allocs or []) == AGENT_BATCH and all(
                a["ClientStatus"] == "complete" for a in allocs)

        t_run = time.perf_counter()
        _, rec["job_run_ms"] = cli_run(["job", "run", job], addr)
        wait(complete, f"dev-batch's {AGENT_BATCH} allocs complete")
        rec["complete_s"] = time.perf_counter() - t_run
        # the device batcher's gauges ride the leader's 10 s stats sweep
        wait(lambda: metrics_view(addr)[0].get("nomad.device_batcher.dispatches", 0) > 0,
             "nomad.device_batcher.dispatches above 0 in /v1/metrics")
        gauges, counters = metrics_view(addr)
        rec["dispatches"] = gauges["nomad.device_batcher.dispatches"]
        rec["fallback_host"] = max(seen_fallback + [counters.get(
            "nomad.tpu_engine.dispatch_fallback_host", 0)])
        if rec["fallback_host"]:
            raise AssertionError(f"agent process: {rec['fallback_host']} host fallbacks")
    finally:
        t_sig = time.perf_counter()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            raise AssertionError(f"agent process: not stopped 30 s after SIGINT: {out[-1500:]}")
        lines = out.splitlines()
    rec["stop_s"] = time.perf_counter() - t_sig
    if proc.returncode != 0:
        raise AssertionError(f"agent process: exited {proc.returncode} after SIGINT: "
                             f"{' | '.join(lines[-8:])}")
    return rec


def phase_agent(kernels, step, forced, parity, seed: int):
    """The operator surface on the card. (a) In this process: an ``Agent``
    built through the CLI's own config path (``load_config_sources`` and
    ``apply_file_config`` on an HCL file: server and client, ``device``
    the card, SERVER_WORKERS schedulers); the C1M fleet registered over
    RPC (``Node.Register`` through ``RemoteServerProxy``, four threads)
    and kept alive by the heartbeat pump's process; then, through ``python
    -m nomad_tpu_torch.cli`` processes against the agent's HTTP address: a
    raw_exec batch job of AGENT_BATCH allocs on the agent's own client
    (run to ``complete``; a blocking query on /v1/jobs parked before it
    must wake on it), ``job status``, ``alloc logs`` and ``alloc fs`` of
    one of them; a raw_exec system job over every node (K4 f32; before the
    mix, which packs some nodes full); ``job run`` of C1M's template mix
    (AGENT_PLACEMENTS; K3, the float arm); ``job plan`` of one more
    template (K1 f32 at B = 1; also timed through the SDK), ``node
    status``, ``operator raft list-peers`` and ``job stop`` of the system
    job. Fails unless every placement commits, no node is overcommitted,
    nothing takes the unported or fallback gate, every K3 and K4 launch
    equals its plain version, the batch tasks' stdout read through the
    logs API is what they printed, and no task or logmon process is left.
    (b) The real entry point (``phase_agent_process``). Returns (record,
    spy)."""
    import os
    import shutil
    import tempfile
    import threading
    from collections import Counter

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.agent.config_file import apply_file_config, load_config_sources
    from nomad_tpu_torch.api import Client as APIClient
    from nomad_tpu_torch.api import Config as APIConfig
    from nomad_tpu_torch.chaos.pump import HeartbeatPump
    from nomad_tpu_torch.rpc.endpoints import RemoteServerProxy
    from nomad_tpu_torch.structs import structs
    from nomad_tpu_torch.structs.funcs import allocs_fit

    t_phase = time.perf_counter()
    deadline = time.monotonic() + AGENT_PHASE_S
    rec = {}
    root = tempfile.mkdtemp(prefix="smoke-agent-")
    agent = pump = None

    def wait(cond, what):
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"agent: {what} not reached within the phase's "
                                     f"{AGENT_PHASE_S:.0f} s")
            time.sleep(0.02)

    def write(name, text):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    try:
        with _ProcWatch() as procs:
            cfg_path = write("agent.hcl", agent_config_hcl(os.path.join(root, "data"), DEVICE))
            cfg = apply_file_config(AgentConfig(), load_config_sources([cfg_path]))
            if (cfg.device, cfg.server_enabled, cfg.client_enabled) != (DEVICE, True, True):
                raise AssertionError(f"agent: the config file gave {cfg}")
            agent = Agent(cfg).start()
            addr = agent.http_addr
            api = APIClient(APIConfig(address=addr))
            server, state = agent.server, agent.server.fsm.state
            wait(lambda: server.is_leader, "leadership")
            wait(lambda: state.node_by_id(agent.client.node.id) is not None,
                 "the agent's client registered")
            local_id = agent.client.node.id
            # the agent's client re-registers its node when its devices
            # change (client.Client.start); counted, with the time of each
            registers = []
            client_register = agent.client.proxy.register_node

            def counted_register(node):
                registers.append(time.monotonic())
                return client_register(node)

            agent.client.proxy.register_node = counted_register

            # the fleet over RPC, four connections at once; raw_exec too,
            # for the system job
            fleet = c1m_nodes(mock, seed)
            for n in fleet:
                n.attributes["driver.raw_exec"] = "1"
                n.drivers["raw_exec"] = structs.DriverInfo(detected=True, healthy=True)
            errors = []

            def register(part):
                proxy = RemoteServerProxy(*agent.rpc.addr)
                try:
                    for n in part:
                        proxy.register_node(n)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))
                finally:
                    proxy.close()

            t0 = time.perf_counter()
            threads = [threading.Thread(target=register, args=(fleet[i::4],)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rec["fleet_s"] = time.perf_counter() - t0
            if errors:
                raise AssertionError(f"agent: Node.Register failed: {errors[:3]}")
            rec["nodes"] = state.read_with_index(lambda s: len(s.nodes()))[0]
            if rec["nodes"] != N_NODES + 1:
                raise AssertionError(f"agent: {rec['nodes']} nodes, not {N_NODES + 1}")
            pump = HeartbeatPump(interval=AGENT_PUMP_S, call_timeout=10.0,
                                 log_path=os.path.join(root, "pump.log"))
            pump.start()
            pump.update([n.id for n in fleet], [], [], agent.rpc.addr)

            mix = c1m_mix_hcl(AGENT_PLACEMENTS)
            mix_paths = [write(f"{job_id}.hcl", hcl) for job_id, _, hcl in mix]
            specs = dict(agent_jobs())
            plan_tpl = c1m_templates()[len(mix) % len(c1m_templates())]
            plan_hcl = c1m_job_hcl(plan_tpl, "c1m-plan", plan_tpl["count"])
            with _Spy(kernels) as spy:
                # 1. the batch job on the agent's own client; a blocking
                # query on /v1/jobs parked first
                _, index = http_json(addr + "/v1/jobs")
                woke = {}

                def blocked():
                    try:
                        jobs, idx = http_json(f"{addr}/v1/jobs?index={index}&wait=60s", 90.0)
                        woke.update(at_ns=time.time_ns(), index=idx, jobs=len(jobs))
                    except Exception as e:  # noqa: BLE001 — reported below
                        woke["error"] = repr(e)

                waiter = threading.Thread(target=blocked, name="blocking-jobs")
                waiter.start()
                time.sleep(0.2)  # parked before the write
                # the write's start: the HTTP route's call into the server
                register = server.register_job
                writes = []

                def timed_register(job, *args, **kwargs):
                    writes.append(time.time_ns())
                    return register(job, *args, **kwargs)

                server.register_job = timed_register
                t0 = time.perf_counter()
                _, rec["batch_run_ms"] = cli_run(["job", "run", write("batch.hcl",
                                                                      specs["smoke-batch"])],
                                                 addr)

                def batch_done():
                    allocs = _live_allocs(state, "smoke-batch")
                    if any(a.client_status == "failed" for a in allocs):
                        raise AssertionError("agent: smoke-batch allocs failed")
                    return len(allocs) == AGENT_BATCH and all(
                        a.client_status == structs.ALLOC_CLIENT_COMPLETE for a in allocs)

                wait(batch_done, f"smoke-batch's {AGENT_BATCH} allocs complete")
                rec["batch_s"] = time.perf_counter() - t0
                waiter.join(timeout=30)
                del server.register_job
                if "at_ns" not in woke or woke["index"] <= index or len(writes) != 1:
                    raise AssertionError(f"agent: the blocking query on /v1/jobs gave {woke} "
                                         f"({len(writes)} registrations)")
                rec["wake_ms"] = (woke["at_ns"] - writes[0]) / 1e6
                batch = _live_allocs(state, "smoke-batch")
                if any(a.node_id != local_id for a in batch):
                    raise AssertionError("agent: smoke-batch placed off the agent's client")
                bad = []
                for a in batch:
                    text = api.alloc_fs.logs(a.id, "main", "stdout").decode()
                    if text.strip() != str(a.index()):
                        bad.append((a.name, text[:40]))
                if bad:
                    raise AssertionError(f"agent: {len(bad)} tasks' stdout wrong: {bad[:3]}")
                one = batch[0]
                status, _ = cli_run(["job", "status", "smoke-batch"], addr)
                logs, _ = cli_run(["alloc", "logs", one.id, "main"], addr)
                listing, _ = cli_run(["alloc", "fs", one.id, "alloc/logs"], addr)
                if ("smoke-batch" not in status or logs.strip() != str(one.index())
                        or "main.stdout.0" not in listing):
                    raise AssertionError(f"agent: CLI views of {one.name}: {status[-400:]!r} "
                                         f"{logs!r} {listing!r}")

                # 2. the system job over every node (K4), before the mix
                # packs nodes full
                t0 = time.perf_counter()
                t0_mono = time.monotonic()
                cli_run(["job", "run", "-detach", write("system.hcl", specs["smoke-system"])],
                        addr)
                try:
                    wait(lambda: len(_live_allocs(state, "smoke-system")) == N_NODES + 1,
                         "smoke-system on every node")
                except AssertionError as e:
                    nodes = state.read_with_index(lambda s: list(s.nodes()))[0]
                    evals = state.read_with_index(
                        lambda s: s.evals_by_job("default", "smoke-system"))[0]
                    have = {a.node_id for a in _live_allocs(state, "smoke-system")}
                    missing = [
                        (n.id, "local" if n.id == local_id else "fleet", n.status, n.datacenter,
                         n.create_index, n.modify_index,
                         [(k, d.detected, d.healthy) for k, d in sorted(n.drivers.items())])
                        for n in nodes if n.id not in have]
                    raise AssertionError(
                        f"{e}: {len(_live_allocs(state, 'smoke-system'))} allocs; nodes by "
                        f"status {Counter(n.status for n in nodes)}; evals "
                        f"{[(ev.status, ev.triggered_by, ev.modify_index, getattr(ev, 'snapshot_index', None), sorted(ev.failed_tg_allocs or {})) for ev in evals]}; "
                        f"nodes without an alloc {missing[:5]}; the agent's client "
                        f"re-registered at {[round(t - t0_mono, 3) for t in registers]} s of "
                        "the system job's run") from None
                rec["system_s"] = time.perf_counter() - t0
                rec["client_registers"] = len(registers)
                wait(lambda: [a.client_status for a in _live_allocs(state, "smoke-system")
                              if a.node_id == local_id] == ["running"],
                     "smoke-system running on the agent's client")

                # 3. the template mix, every `job run` at once
                before = state.count_allocs_desired_run()
                t0 = time.perf_counter()
                runs = [(cli_start(["job", "run", "-detach", p], addr), time.perf_counter())
                        for p in mix_paths]
                run_ms = []
                for proc, t_start in runs:
                    out, _ = proc.communicate(timeout=120)
                    if proc.returncode != 0:
                        raise AssertionError(f"agent: job run exited {proc.returncode}: "
                                             f"{out[-1500:]}")
                    run_ms.append((time.perf_counter() - t_start) * 1e3)
                wait(lambda: state.count_allocs_desired_run() - before == AGENT_PLACEMENTS,
                     f"the mix's {AGENT_PLACEMENTS} placements")
                rec["mix_s"] = time.perf_counter() - t0
                rec["mix_placements_per_s"] = AGENT_PLACEMENTS / rec["mix_s"]
                rec["job_run_ms"] = _percentiles(run_ms)
                rec["mix_jobs"] = len(mix)

                # 4. `job plan` of one more template (K1 f32, B = 1)
                plan_out, rec["plan_cli_ms"] = cli_run(
                    ["job", "plan", write("plan.hcl", plan_hcl)], addr, ok=(0, 1))
                parsed = api.jobs.parse_hcl(plan_hcl)
                t0 = time.perf_counter()
                plan = api.jobs.plan(parsed, diff=True)
                rec["plan_ms"] = (time.perf_counter() - t0) * 1e3
                plan = plan[0] if isinstance(plan, tuple) else plan
                placed = plan["Annotations"]["DesiredTGUpdates"]["web"]["Place"]
                if placed != plan_tpl["count"] or plan.get("FailedTGAllocs"):
                    raise AssertionError(f"agent: Job.Plan gave {plan.get('Annotations')}")

                # 5. node status, raft peers, the system job stopped
                nodes_out, _ = cli_run(["node", "status"], addr)
                peers, _ = cli_run(["operator", "raft", "list-peers"], addr)
                if len(nodes_out.strip().splitlines()) != N_NODES + 2 or "smoke-agent" not in peers:
                    raise AssertionError(f"agent: node status / list-peers: {peers!r}")
                cli_run(["job", "stop", "-detach", "smoke-system"], addr)
                wait(lambda: all(a.client_status == structs.ALLOC_CLIENT_COMPLETE
                                 for a in _live_allocs(state, "smoke-system")
                                 if a.node_id == local_id), "smoke-system stopped")
                if not server.drain_evals(max(deadline - time.monotonic(), 1.0)):
                    raise AssertionError("agent: the broker did not drain")
            rec["launches"] = spy.launches
            rec["k3_launches"], rec["k4_launches"] = len(spy.batched), len(spy.forced)
            unported = spy.count("nomad.tpu_engine.unported")
            fallback = spy.count("nomad.tpu_engine.fallback")
            host = spy.count("nomad.tpu_engine.dispatch_fallback_host")
            if unported or fallback or host or not rec["k3_launches"] or not rec["k4_launches"]:
                raise AssertionError(f"agent: unported={unported} fallback={fallback} "
                                     f"host={host} launches={spy.launches} reasons "
                                     f"{fallback_reasons(spy.reasons)}")

            # every placement committed, none overcommits a node
            counts = {job_id: count for job_id, count, _ in mix}
            counts.update({"smoke-batch": AGENT_BATCH})
            short = {j: len(_live_allocs(state, j)) for j, c in counts.items()
                     if len(_live_allocs(state, j)) != c}
            if short:
                raise AssertionError(f"agent: jobs short of their count: {short}")
            by_node = {}
            for a in state.read_with_index(lambda s: list(s.allocs()))[0]:
                if a.desired_status == structs.ALLOC_DESIRED_RUN and not a.terminal_status():
                    by_node.setdefault(a.node_id, []).append(a)
            nodes = state.read_with_index(lambda s: list(s.nodes()))[0]
            over = [n.name for n in nodes if not allocs_fit(n, by_node.get(n.id, []))[0]]
            if over:
                raise AssertionError(f"agent: nodes overcommitted: {over[:3]}")
            rec["nodes_checked"] = len(nodes)
            rec["pump"] = pump_totals({"heartbeat_pump": pump.report()})

            agent.shutdown()
            agent = None
            pump.stop()
            pump = None
            procs.sample()
            rec["peak"] = dict(procs.peak)
            wait(lambda: not any(procs.alive().values()), "every task and logmon gone")

        # every captured launch against its plain version (float arm)
        rec["held"] = hold_churn_launches(step, parity, spy.batched, True, "agent")
        rec["k3_ms"] = [(fresh.parts()[0][0].shape[0], fresh.parts()[2][0].shape[1],
                         packed_scan_ms(kernels, fresh)) for fresh, *_ in spy.batched]
        rec["k3_row"] = replay_batched(kernels, step, parity, spy.batched[-1],
                                       "agent last K3 launch", True)
        rec["k4"] = [replay_forced(kernels, forced, launch, f"agent K4 launch {i}")
                     for i, launch in enumerate(spy.forced)]
        rec["in_process_s"] = time.perf_counter() - t_phase
        rec["process"] = phase_agent_process(root)
        rec["phase_s"] = time.perf_counter() - t_phase
        if rec["phase_s"] > AGENT_PHASE_S:
            raise AssertionError(f"agent: the phase took {rec['phase_s']:.1f} s")
        return rec, spy
    finally:
        if agent is not None:
            agent.shutdown()
        if pump is not None:
            pump.stop()
        shutil.rmtree(root, ignore_errors=True)


def log_agent(rec, card):
    """The agent phase's lines."""
    p, proc = rec["job_run_ms"], rec["process"]
    log(f"agent: {rec['nodes']} nodes (the fleet registered over RPC in {rec['fleet_s']:.3f} s, "
        f"the agent's own client among them); `job run` of {rec['mix_jobs']} C1M templates, "
        f"{AGENT_PLACEMENTS} placements in {rec['mix_s']:.3f} s "
        f"({rec['mix_placements_per_s']:.1f} placements/s from the first `job run`); CLI "
        f"`job run` wall ms p50 {p['p50']:.1f} p99 {p['p99']:.1f}; on {card}")
    log(f"  smoke-batch: {AGENT_BATCH} raw_exec allocs on the agent's client, `job run` "
        f"{rec['batch_run_ms']:.1f} ms, all complete {rec['batch_s']:.3f} s after it, every "
        f"stdout right; a blocking query on /v1/jobs woke {rec['wake_ms']:.1f} ms after the "
        f"route called Server.register_job")
    log(f"  smoke-system on {N_NODES + 1} nodes in {rec['system_s']:.3f} s (the agent's client "
        f"re-registered {rec['client_registers']} times before it); Job.Plan over "
        f"HTTP {rec['plan_ms']:.1f} ms (CLI `job plan` {rec['plan_cli_ms']:.1f} ms); "
        f"{rec['nodes_checked']} nodes, none overcommitted; peak live tasks "
        f"{rec['peak']['task']}, logmons {rec['peak']['logmon']}, none left; heartbeat pump "
        f"{json.dumps(rec['pump'], sort_keys=True)}")
    held = rec["held"]
    log(f"  launches {json.dumps(rec['launches'], sort_keys=True)}: K3 {rec['k3_launches']}, "
        f"K4 {rec['k4_launches']}; every K3 launch held against plain ({held[0]} launches, "
        f"{held[1]} evals, worst |dscore| {held[2]}, plain {held[3]:.1f} ms in all); kernel ms "
        f"(B, P, ms) {' '.join(f'{b}/{pp}/{ms:.3f}' for b, pp, ms in rec['k3_ms'])}")
    for i, k in enumerate(rec["k4"]):
        log(f"  K4 launch {i}: kernel_ms={k[0]:.4f} plain_ms={k[1]:.2f} bound_ms={k[2]:.6f}")
    log(f"agent process (`python -m nomad_tpu_torch.cli agent -dev`): HTTP ready "
        f"{proc['http_ready_s']:.3f} s, first leader {proc['leader_s']:.3f} s after its start; "
        f"`job run` {proc['job_run_ms']:.1f} ms, {AGENT_BATCH} allocs complete in "
        f"{proc['complete_s']:.3f} s; /v1/metrics device dispatches {proc['dispatches']}, "
        f"host fallbacks {proc['fallback_host']}; exit 0 {proc['stop_s']:.3f} s after SIGINT; "
        f"phase wall {rec['phase_s']:.1f} s (in process {rec['in_process_s']:.1f} s)")


def memory_line() -> str:
    """This process's resident set and the host's available memory."""
    def field(path, key):
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) / (1 << 20)
        return float("nan")

    return (f"rss {field('/proc/self/status', 'VmRSS:'):.2f} GiB, host available "
            f"{field('/proc/meminfo', 'MemAvailable:'):.2f} GiB")


def release_heap() -> None:
    """Collect, then hand the freed heap back to the host (glibc)."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def wire_phases(kernels, step, parity, seed, card, stamp):
    """The crash and the serve harnesses (their harness threads and 5,120
    watchers while this process's heap is small), then the wire cluster
    (three 70,000-alloc FSMs in this process)."""
    crash = phase_crash(seed)
    log_crash(crash, card)
    stamp(f"crash done; {memory_line()}")
    serve = phase_serve(seed)
    log_serve(serve, card)
    release_heap()
    stamp(f"serve done; {memory_line()}")
    rec, spy = phase_wire_cluster(kernels, step, parity, seed)
    log_wire(rec, card)
    del spy
    release_heap()
    stamp(f"wire cluster done; {memory_line()}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--churn-only", action="store_true",
                    help="build the kernels and run the two churn replays only (prints no "
                         "kernels line and no result)")
    ap.add_argument("--wire-only", action="store_true",
                    help="build the kernels and run the wire cluster, crash and serve phases "
                         "only (prints no kernels line and no result)")
    ap.add_argument("--devices-only", action="store_true",
                    help="build the kernels and run the devices phase only (prints no kernels "
                         "line and no result)")
    ap.add_argument("--client-only", action="store_true",
                    help="build the kernels and run the client phase only (prints no kernels "
                         "line and no result)")
    ap.add_argument("--agent-only", action="store_true",
                    help="build the kernels and run the agent phase only (prints no kernels "
                         "line and no result)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run the mesh phase only (prints no kernels "
                         "line and no result)")
    ap.add_argument("--nodes-only", action="store_true",
                    help="build the kernels and run the nodes phase only (prints no kernels "
                         "line and no result)")
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
    from nomad_tpu_torch.tpu import (chunk, convert, engine, forced, kernels, node_shard, parity,
                                     step)

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

    def churn_phases():
        recs = {}
        for deterministic in (False, True):
            rec, _spy = phase_churn(kernels, step, parity, deterministic, args.seed)
            log_churn(rec, card)
            recs[rec["arm"]] = rec
            stamp(f"churn {rec['arm']} done")
        return recs

    # the churn replay first, while the process heap is small: run after
    # the other phases (5,000-node fleets, 60,000 allocs a server left
    # behind) its float arm's eval p99 read 1,262 and 5,333 ms on an H100
    # against 507-877 ms run first, past the 5,000 ms gate once (the
    # collector's pauses under that heap are the likely cause, unmeasured)
    if args.wire_only:
        wire_phases(kernels, step, parity, args.seed, card, stamp)
        log(f"card: {card}")
        return 0
    if args.devices_only:
        dev_rec, _spy = phase_devices(kernels, step, forced, parity, args.seed)
        log_devices(dev_rec, card)
        log(f"card: {card}")
        return 0
    if args.client_only:
        client_rec, _spy = phase_client(kernels, step, forced, parity, args.seed)
        log_client(client_rec, card)
        log(f"card: {card}")
        return 0
    if args.agent_only:
        agent_rec, _spy = phase_agent(kernels, step, forced, parity, args.seed)
        log_agent(agent_rec, card)
        log(f"card: {card}")
        return 0
    if args.mesh_only:
        log_mesh(phase_mesh(kernels, step, parity, args.seed), card)
        log(f"card: {card}")
        return 0
    if args.nodes_only:
        log_nodes(*phase_nodes(kernels, node_shard, parity, args.seed), card)
        log(f"card: {card}")
        return 0
    churn = churn_phases()
    if args.churn_only:
        log(f"card: {card}")
        return 0
    # the wire phases next, before the big kernel and server phases leave
    # their heap behind (the churn gate's lesson, PR 9 run 10)
    wire = wire_phases(kernels, step, parity, args.seed, card, stamp)

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
    mesh = phase_mesh(kernels, step, parity, args.seed)
    log_mesh(mesh, card)
    stamp("mesh done")
    nodes, nodes_pre = phase_nodes(kernels, node_shard, parity, args.seed)
    log_nodes(nodes, nodes_pre, card)
    stamp("nodes done")

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
        servers[rec["arm"]] = (rec, [spy.batched[-1]], spy.forced)
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
        log(f"  batch sections (host ms: median, sum) "
            f"{json.dumps(rec['batch_sections'], sort_keys=True)}")
        if rec["forced_sections"]:
            log(f"  run_forced host ms per system eval (median / max / sum): "
                f"{sections_text(rec['forced_sections'])}")
        log(f"  {rec['copies']}")
        log("  " + hold_batched_launches(kernels, spy.batched, f"server {rec['arm']}"))
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
    log(f"  {rec['copies']}")
    log("  " + hold_batched_launches(kernels, chunk_spy.batched, "server chunked"))
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
    log(f"  batch sections (host ms: median, sum) "
        f"{json.dumps(sys_rec['batch_sections'], sort_keys=True)}")
    log(f"  run_forced host ms per system eval (median / max / sum): "
        f"{sections_text(sys_rec['forced_sections'])}")
    log(f"  {sys_rec['copies']}")
    log("  " + hold_batched_launches(kernels, sys_spy.batched, "system slice"))
    log(f"  phases_s {json.dumps(sys_rec['phases_s'], sort_keys=True)}")
    stamp("system slice done")

    h_records, h_spy = phase_preempt_harness(kernels, args.seed)
    for r in h_records:
        log(f"harness {r['job']:12s} ({r['phase']}) placed={r['placed']} preempted={r['preempted']} "
            f"tpu_binpack_wall_ms={r['device_wall_ms']:.1f} host_binpack_wall_ms={r['host_wall_ms']:.1f} "
            f"plans and eviction sets equal: yes")
    log(f"harness launches {json.dumps(h_spy.launches, sort_keys=True)}")
    stamp("victim-for-victim Harness done")

    dev_rec, _dev_spy = phase_devices(kernels, step, forced, parity, args.seed)
    log_devices(dev_rec, card)
    stamp("devices done")
    del _dev_spy
    release_heap()
    client_rec, _client_spy = phase_client(kernels, step, forced, parity, args.seed)
    log_client(client_rec, card)
    del _client_spy
    stamp(f"client done; {memory_line()}")
    release_heap()
    agent_rec, _agent_spy = phase_agent(kernels, step, forced, parity, args.seed)
    log_agent(agent_rec, card)
    del _agent_spy
    stamp(f"agent done; {memory_line()}")

    # the main paths' own kernel inputs, replayed: kernel vs plain, times, bound
    rows = {name: [] for name in ("place_scan", "place_scan_f32", "place_scan_has_pre",
                                  "forced_eval", "forced_eval_f32")}
    # the nodes phase's group 0 in each arm: the node-sharded scan held
    # against its plain version in the phase
    rows["place_scan_nodes"] = [nodes["int"]["row"]]
    rows["place_scan_nodes_f32"] = [nodes["float"]["row"]]
    rows["chunk_scan"] = k5_rows
    for i, (fresh, after, out, out_layout) in enumerate(captured):
        # run_scan_single's batch of one: the eval's own arrays
        s, c, x = (tuple(t[0] for t in part) for part in fresh.parts())
        n_pad = s[0].shape[0]
        main_c, main_y = packed_scan_results(after, out, out_layout)
        k_out = run_kernel(kernels, n_pad, s, c, x)
        compare(k_out, (tuple(t[0] for t in main_c), tuple(y[0] for y in main_y)),
                f"main-path eval {i}: the tensor entry against the main path's packed launch")
        p_out, p_ms = timed_wall(lambda: run_plain(step, n_pad, s, c, x))
        worst = max(worst, compare(k_out, p_out, f"main-path eval {i}"))
        k_ms = packed_scan_ms(kernels, fresh)
        t_ms = cuda_ms(lambda: run_kernel(kernels, n_pad, s, c, x))
        cs1_ms = hold_cs1(lambda cs: run_kernel(kernels, n_pad, s, c, x, cs), k_out,
                          f"main-path eval {i}")
        nbytes, ops = kernels.place_scan_work(s, c, x, k_out[1][3])
        b_ms, b_by = bound(nbytes, ops)
        rows["place_scan"].append((k_ms, p_ms, b_ms, b_by))
        p = x[0].shape[0]
        log(f"main-path eval {i}: n_pad={n_pad} P={p} S={s[10].shape[1]} "
            f"aff={s[4].shape[0] > 0} evict={x[3].shape[1] > 0} equal=yes "
            f"cs={plan_cs(kernels, s, c, x)} kernel_ms={k_ms:.3f} (packed entry; tensor entry "
            f"{t_ms:.3f}) per_step_us={k_ms * 1e3 / p:.2f} cs1_ms={fmt_ms(cs1_ms)} "
            f"plain_ms={p_ms:.1f} bytes={nbytes} ops={ops} bound_ms={b_ms:.6f} ({b_by})")
        log(f"  main-path eval {i}: " + sections_line(
            kernels, *(tuple(t.unsqueeze(0) for t in part) for part in (s, c, x))))
    for arm, (rec, launch_inputs, forced_inputs) in servers.items():
        if arm == "chunked":
            continue  # replayed above
        kernel = "place_scan" if arm == "int" else "place_scan_f32"
        # the last batched launch only (PRs 1-2 also replayed the first)
        for which, launch in (("last", launch_inputs[-1]),):
            k_ms, p_ms, b_ms, b_by, err = replay_batched(
                kernels, step, parity, launch, f"server {arm} {which} launch", arm == "float")
            if arm == "int":
                worst = max(worst, err)
            else:
                worst_f = max(worst_f, err)
            rows[kernel].append((k_ms, p_ms, b_ms, b_by))
        for i, launch in enumerate(forced_inputs):
            name = "forced_eval" if arm == "int" else "forced_eval_f32"
            rows[name].append(replay_forced(kernels, forced, launch,
                                            f"server {arm} K4 launch {i}")[:4])
    # the system slice: its K4 launches, and the has_pre launches with the
    # most steps (the fill's scans are held by the int server's replays)
    for i, launch in enumerate(sys_spy.forced):
        rows["forced_eval"].append(replay_forced(kernels, forced, launch,
                                                 f"system slice K4 launch {i}")[:4])
    # the evicting launch with the fewest evicting steps (PRs 5-9
    # replayed the two with the most, ~60 s of the plain has_pre step;
    # cut to make room for the wire phases)
    pre = [launch for launch in sys_spy.batched
           if launch[0].dims["C"] > 0 and evicting_steps(launch) > 0]
    pre.sort(key=evicting_steps)
    for i, launch in enumerate(pre[:1]):
        rows["place_scan_has_pre"].append(replay_batched(
            kernels, step, parity, launch, f"system slice has_pre launch {i}", False)[:4])
    # the devices phase's launches, each held against plain in the phase
    for h in dev_rec["holds"]:
        rows["place_scan_f32" if h[1] else "place_scan"].append(h[4:8])
        if h[1]:
            worst_f = max(worst_f, h[8])
        else:
            worst = max(worst, h[8])
    rows["forced_eval"] += [k[:4] for k in dev_rec["k4"]]
    # the client phase's launches (int arm), each held against plain in the phase
    for h in client_rec["holds"]:
        rows["place_scan"].append(h[4:8])
        worst = max(worst, h[8])
    rows["forced_eval"] += [k[:4] for k in client_rec["k4"]]
    # the agent phase's (float arm): every launch held against plain in the
    # phase, its last K3 launch replayed and timed, each K4 launch
    rows["place_scan_f32"].append(agent_rec["k3_row"][:4])
    worst_f = max(worst_f, agent_rec["held"][2], agent_rec["k3_row"][4])
    rows["forced_eval_f32"] += [k[:4] for k in agent_rec["k4"]]
    # the mesh phase's shard 0 in each arm, held against plain in the phase
    rows["place_scan"].append(mesh["int"]["row"])
    rows["place_scan_f32"].append(mesh["float"]["row"])
    worst = max(worst, mesh["int"]["err"])
    worst_f = max(worst_f, mesh["float"]["err"])
    stamp("replays done")

    mean = lambda v: sum(v) / len(v)  # noqa: E731
    churn_f, churn_i = churn["float"]["launches"], churn["int"]["launches"]
    main_launches = {
        "place_scan": (launches + servers["int"][0]["launches"]["place_scan"]
                       + sys_rec["launches"]["place_scan"]
                       - sys_rec["launches"]["place_scan_has_pre"]
                       + churn_i["place_scan"] - churn_i["place_scan_has_pre"]
                       + dev_rec["launches"]["place_scan"]
                       + client_rec["launches"]["place_scan"]
                       + mesh["int"]["launches"]),
        "place_scan_f32": (servers["float"][0]["launches"]["place_scan_f32"]
                           + churn_f["place_scan_f32"]
                           + wire["launches_total"]["place_scan_f32"]
                           + dev_rec["launches"]["place_scan_f32"]
                           + agent_rec["launches"]["place_scan_f32"]
                           + mesh["float"]["launches"]),
        "place_scan_has_pre": (sys_rec["launches"]["place_scan_has_pre"]
                               + churn_i["place_scan_has_pre"]),
        "forced_eval": (sys_rec["launches"]["forced_eval"] + dev_rec["launches"]["forced_eval"]
                        + client_rec["launches"]["forced_eval"]),
        "forced_eval_f32": (servers["float"][0]["launches"]["forced_eval_f32"]
                            + agent_rec["launches"]["forced_eval_f32"]),
        "chunk_scan": servers["chunked"][0]["launches"]["chunk_scan"],
        "place_scan_nodes": nodes["int"]["launches"],
        "place_scan_nodes_f32": nodes["float"]["launches"],
    }
    replaces = {
        "place_scan": "nomad_tpu/tpu/engine.py:213",
        "place_scan_f32": "nomad_tpu/tpu/engine.py:575",
        "place_scan_has_pre": "nomad_tpu/tpu/engine.py:383",
        "forced_eval": "nomad_tpu/tpu/engine.py:888",
        "forced_eval_f32": "nomad_tpu/tpu/engine.py:888",
        "chunk_scan": "nomad_tpu/tpu/engine.py:3033",
        "place_scan_nodes": "nomad_tpu/tpu/engine.py:1000",
        "place_scan_nodes_f32": "nomad_tpu/tpu/engine.py:1000",
    }
    errs = {"place_scan": worst, "place_scan_f32": worst_f, "place_scan_has_pre": 0,
            "forced_eval": 0, "forced_eval_f32": 0, "chunk_scan": worst_k5,
            "place_scan_nodes": nodes["int"]["err"], "place_scan_nodes_f32": nodes["float"]["err"]}
    sources = {"forced_eval": "forced_eval.cu", "forced_eval_f32": "forced_eval.cu",
               "chunk_scan": "chunk_scan.cu", "place_scan_nodes": "place_scan_nodes.cu",
               "place_scan_nodes_f32": "place_scan_nodes.cu"}
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
