#!/usr/bin/env python3
"""Time the placement scan kernel, the chunk kernel, the forced-node
kernel or the server slices of several checkouts on one card.

    python3 scan_ab.py TREE [TREE ...] [--reps N] [--kernel scan|chunk|forced|server]

Each TREE is the root of a checkout of this repository (``.`` for this
one; another one unpacked with ``git archive`` into a directory that git
ignores). The trees run one after another, each in a subprocess that
imports that tree's ``nomad_tpu_torch``, builds its kernels and launches
its scan on the same seeded inputs: the placement-scan variants at
5,000 nodes and P = 512 in both arms, the preemption variants (P = 1,024
and 1,250, C = 16) and B = 8 batches in both arms; with ``--kernel
chunk``, the chunk kernel (K5) on bench.py's C1M chunk run (5,000 nodes,
1,000,000 placements, 1,432 steps), a chunked server eval's shape
(spread + affinity, K = 128) and n_pad 33,024 at K = 1,024; with
``--kernel forced``, the forced-node kernel (K4) at 5,000 nodes with
P = 5,000 forced nodes (and P = 4,999 with two device dims) in both
arms: the tensor entry ``kernels.forced_eval`` and, where the tree has
it, the packed entry ``kernels.forced_eval_packed`` (CUDA events), and
a whole ``TorchPlacementEngine.run_forced`` of the same eval on the host
clock; with ``--kernel server``, the tree's own ``chip_smoke.py`` server
slices (the float run with its system job, the int run, the system
slice), printing each run's window, placements/s, the ``pad_stack``,
``device`` and ``device_wait`` seconds, the batcher's ms per dispatch and,
where the tree records them, its per-batch sections and ``run_forced``'s.
A tree given twice runs twice: ``parent change change parent`` measures
both versions and the spread between runs in one call. Per case it
prints the median of ``--reps`` timed launches (CUDA events, after a
warm-up) for every run, and fails unless every run's outputs (chosen
nodes, scores, pulls, skips, evictions and the final carry; for K5 the
chosen indices, scores, valid flags, placed counts, carry and deficit;
for K4 chosen and scores) are the same bits; the server slices check
themselves (every placement committed, no node overcommitted). Last
line: one JSON object with the card and every time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N_NODES = 5000
CASES = [  # (name, variant, P, int arm, batch)
    ("s0 int", "s0", 512, True, 1), ("s1 int", "s1", 512, True, 1),
    ("all int", "all", 512, True, 1), ("s1 float", "s1", 512, False, 1),
    ("all float", "all", 512, False, 1), ("preempt", "preempt", 1024, True, 1),
    ("preempt_forced", "preempt_forced", 1250, True, 1),
    ("B=8 all int", "all", 512, True, 8), ("B=8 all float", "all", 512, False, 8),
]

CHUNK_CASES = [  # (name, variant, nodes, [(per-TG counts, K, retry rounds)])
    ("K5 c1m run", "c1m", N_NODES, "c1m"),
    ("K5 server eval K=128", "spread_affinity", N_NODES, [([1500, 1000, 500], 128, 2)]),
    ("K5 n_pad 33024 K=1024", "open", 33000, [([20000, 15000], 1024, 2)]),
]

CHUNK_CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from nomad_tpu_torch.tpu import chunk, convert, engine, kernels
reps = int(sys.argv[2])
cases = json.loads(sys.argv[3])
kernels.build_all(["chunk_scan"])
out = {}
for name, variant, n_nodes, phases in cases:
    if phases == "c1m":  # bench.py bench_c1m_chunked: 88 % bulk at K = 1,024, the tail at 256
        per_tg = 1000000 // 8
        bulk = int(per_tg * 0.88)
        phases = [([bulk] * 8, 1024, 0), ([per_tg - bulk] * 8, 256, 12)]
    n_pad, st, ca = engine.example_chunk_variant(variant, n_nodes=n_nodes,
                                                 n_tgs=len(phases[0][0]), seed=0)
    s, c, _ = convert.scan_inputs_to_torch(st, ca, (), "cuda")
    ph = [(convert.to_torch(chunk.chunk_schedule(list(enumerate(counts)), k, retry_rounds=rr),
                            "cuda"), k) for counts, k, rr in phases]

    def run():
        carry, deficit, outs = tuple(t.clone() for t in c), None, []
        for xs, k in ph:
            carry, deficit, ys = kernels.chunk_scan(n_pad, s, carry, xs, deficit, chunk=k)
            outs.extend(ys)
        return (*outs, *carry[:4], deficit)

    res = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); run(); b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    h = hashlib.sha256()
    for t in res:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    out[name] = {"ms": sorted(times)[len(times) // 2], "digest": h.hexdigest()[:16]}
print(json.dumps(out))
"""

CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from nomad_tpu_torch.tpu import convert, engine, kernels
reps = int(sys.argv[2])
cases = json.loads(sys.argv[3])
kernels.build_all(["place_scan"])

def digest(carry, ys):
    h = hashlib.sha256()
    for t in (*ys, *carry):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]

out = {}
for name, variant, p, int_arm, batch in cases:
    dtype = np.int32 if int_arm else np.float32
    evals = [engine.example_scan_variant(variant, n_nodes=%(n)d, n_tgs=3, n_placements=p,
                                         seed=(1 if batch == 1 else 21 + q), dtype=dtype)
             for q in range(batch)]
    stacked = [tuple(np.stack(col) for col in zip(*(e[k] for e in evals))) for k in (1, 2, 3)]
    sb, cb, xb = convert.scan_inputs_to_torch(*stacked, "cuda")
    run = lambda: kernels.place_scan_batched(sb, tuple(t.clone() for t in cb), xb)
    carry, ys = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); run(); b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    out[name] = {"ms": sorted(times)[len(times) // 2], "digest": digest(carry, ys)}
print(json.dumps(out))
""" % {"n": N_NODES}


FORCED_CASES = [  # (name, int arm, device dims, P)
    ("K4 int", True, 0, N_NODES), ("K4 float", False, 0, N_NODES),
    ("K4 int D=6", True, 2, N_NODES - 1), ("K4 float D=6", False, 2, N_NODES - 1),
]

FORCED_CHILD = r"""
import hashlib, json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from nomad_tpu_torch.tpu import convert, engine, kernels
reps = int(sys.argv[2])
cases = json.loads(sys.argv[3])
kernels.build_all(["forced_eval"])
eng = engine.TorchPlacementEngine("cuda")

def med(v):
    return sorted(v)[len(v) // 2]

def event_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return med(times)

out = {}
for name, int_arm, device_dims, p in cases:
    dtype = np.int32 if int_arm else np.float32
    n_pad, st, ca, xs = engine.example_forced_variant(
        n_nodes=%(n)d, n_placements=p, seed=5, dtype=dtype, device_dims=device_dims)
    enc = engine.EncodedEval(
        n_real=%(n)d, n_pad=n_pad, g=1, s=st[9].shape[1], v=st[10].shape[2], p=p, dtype=dtype,
        static=st, carry=ca, xs=xs, missing_list=[], nodes=[], table=None, start_ns=0)
    s, c, x = convert.scan_inputs_to_torch(st, ca, xs, "cuda")
    res = {"tensor_ms": event_ms(lambda: kernels.forced_eval(s, c, x))}
    if hasattr(kernels, "forced_eval_packed"):
        packed = kernels.pack_forced_inputs((st, ca, xs), "cuda")
        res["packed_ms"] = event_ms(lambda: kernels.forced_eval_packed(packed))
    got = eng.run_forced(enc)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_forced(enc)
        host.append((time.perf_counter() - t0) * 1e3)
    res["run_forced_ms"] = med(host)
    h = hashlib.sha256()
    for a in got[:2]:
        h.update(np.ascontiguousarray(a).tobytes())
    res["digest"] = h.hexdigest()[:16]
    out[name] = res
print(json.dumps(out))
""" % {"n": N_NODES}

SERVER_CASES = [("server float",), ("server int",), ("system slice",)]

SERVER_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from nomad_tpu_torch.tpu import kernels
kernels.build_all()

def summary(rec):
    ph = rec.get("phases_s", {})
    out = {k: ph.get(k) for k in ("window", "encode", "pad_stack", "device", "device_wait",
                                  "apply", "plan_evaluate", "raft_fsm")}
    out["wall_s"] = rec["wall_s"]
    if "placements_per_s" in rec:
        out["placements_per_s"] = rec["placements_per_s"]
    st = rec.get("batcher", {})
    n = max(st.get("dispatches", 0), 1)
    out["batcher"] = {"dispatches": st.get("dispatches"), "evals": st.get("evals"),
                      "pad_stack_ms_per_dispatch": st.get("pad_stack_ms_total", 0.0) / n,
                      "compute_ms_per_dispatch": st.get("compute_ms_total", 0.0) / n,
                      "transfer_ms_per_dispatch": st.get("transfer_ms_total", 0.0) / n}
    for key in ("batch_sections", "forced_sections"):
        if key in rec:
            out[key] = rec[key]
    if rec.get("system_job"):
        out["system_job"] = rec["system_job"]
    return out

out = {}
for det, name in ((False, "server float"), (True, "server int")):
    rec, _spy = chip_smoke.phase_server(kernels, det, 0)
    out[name] = summary(rec)
rec, _spy = chip_smoke.phase_system_server(kernels, 0)
out["system slice"] = summary(rec)
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernel", choices=("scan", "chunk", "forced", "server"), default="scan")
    args = ap.parse_args()
    child, cases, source = {
        "scan": (CHILD, CASES, "place_scan.cu"),
        "chunk": (CHUNK_CHILD, CHUNK_CASES, "chunk_scan.cu"),
        "forced": (FORCED_CHILD, FORCED_CASES, "forced_eval.cu"),
        "server": (SERVER_CHILD, SERVER_CASES, "place_scan.cu"),
    }[args.kernel]
    import torch

    if not torch.cuda.is_available():
        print("scan_ab.py: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for tree in args.trees:
        root = Path(tree).resolve()
        if not (root / "nomad_tpu_torch" / "tpu" / "csrc" / source).is_file():
            print(f"scan_ab.py: no {source} under {root}", file=sys.stderr)
            return 2
        res = subprocess.run([sys.executable, "-c", child, str(root), str(args.reps),
                              json.dumps(cases)], capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append((tree, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"ran {tree}", flush=True)
    if args.kernel == "server":
        for name, in cases:
            for tree, r in runs:
                print(f"{name} {tree}: {json.dumps(r[name], sort_keys=True)}")
        print(f"card: {card}")
        print(json.dumps({"card": card, "trees": args.trees,
                          "runs": {name: [r[name] for _, r in runs] for name, in cases}}))
        return 0
    bad = []
    times = {}
    for name, *_ in cases:
        keys = ([k for k in ("tensor_ms", "packed_ms", "run_forced_ms")
                 if any(k in r[name] for _, r in runs)] if args.kernel == "forced" else ["ms"])
        for key in keys:
            line = " ".join(f"{tree}={r[name][key]:.4f}" if key in r[name] else f"{tree}=n/a"
                            for tree, r in runs)
            print(f"{name:16s} {key}: {line}")
            times[f"{name} {key}" if key != "ms" else name] = [r[name].get(key) for _, r in runs]
        if len({r[name]["digest"] for _, r in runs}) != 1:
            bad.append(name)
    if bad:
        print(f"scan_ab.py: outputs differ between trees in {bad}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"card": card, "trees": args.trees, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
