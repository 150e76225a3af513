#!/usr/bin/env python3
"""Time the placement scan kernel, or the chunk kernel, of several
checkouts on one card.

    python3 scan_ab.py TREE [TREE ...] [--reps N] [--kernel scan|chunk]

Each TREE is the root of a checkout of this repository (``.`` for this
one; another one unpacked with ``git archive`` into a directory that git
ignores). The trees run one after another, each in a subprocess that
imports that tree's ``nomad_tpu_torch``, builds its kernels and launches
its scan on the same seeded inputs: the placement-scan variants at
5,000 nodes and P = 512 in both arms, the preemption variants (P = 1,024
and 1,250, C = 16) and B = 8 batches in both arms; with ``--kernel
chunk``, the chunk kernel (K5) on bench.py's C1M chunk run (5,000 nodes,
1,000,000 placements, 1,432 steps), a chunked server eval's shape
(spread + affinity, K = 128) and n_pad 33,024 at K = 1,024. A tree given twice
runs twice: ``parent change change parent`` measures both versions and
the spread between runs in one call. Per case it prints the median of
``--reps`` timed launches (CUDA events, after a warm-up) for every run,
and fails unless every run's outputs (chosen nodes, scores, pulls,
skips, evictions and the final carry; for K5 the chosen indices, scores,
valid flags, placed counts, carry and deficit) are the same bits. Last
line: one JSON object with the card and every time.
"""
from __future__ import annotations

import argparse
import hashlib
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernel", choices=("scan", "chunk"), default="scan")
    args = ap.parse_args()
    child, cases, source = ((CHILD, CASES, "place_scan.cu") if args.kernel == "scan"
                            else (CHUNK_CHILD, CHUNK_CASES, "chunk_scan.cu"))
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
    bad = []
    for name, *_ in cases:
        line = " ".join(f"{tree}={r[name]['ms']:.3f}" for tree, r in runs)
        print(f"{name:16s} ms: {line}")
        if len({r[name]["digest"] for _, r in runs}) != 1:
            bad.append(name)
    if bad:
        print(f"scan_ab.py: outputs differ between trees in {bad}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"card": card, "trees": args.trees,
                      "ms": {name: [r[name]["ms"] for _, r in runs] for name, *_ in cases}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
