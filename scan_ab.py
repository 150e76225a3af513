#!/usr/bin/env python3
"""Time the placement scan kernel of several checkouts on one card.

    python3 scan_ab.py TREE [TREE ...] [--reps N]

Each TREE is the root of a checkout of this repository (``.`` for this
one; another one unpacked with ``git archive`` into a directory that git
ignores). The trees run one after another, each in a subprocess that
imports that tree's ``nomad_tpu_torch``, builds its kernels and launches
its scan on the same seeded inputs: the placement-scan variants at
5,000 nodes and P = 512 in both arms, the preemption variants (P = 1,024
and 1,250, C = 16) and B = 8 batches in both arms. A tree given twice
runs twice: ``parent change change parent`` measures both versions and
the spread between runs in one call. Per case it prints the median of
``--reps`` timed launches (CUDA events, after a warm-up) for every run,
and fails unless every run's outputs (chosen nodes, scores, pulls,
skips, evictions and the final carry) are the same bits. Last line: one
JSON object with the card and every time.
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
    args = ap.parse_args()
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
        if not (root / "nomad_tpu_torch" / "tpu" / "csrc" / "place_scan.cu").is_file():
            print(f"scan_ab.py: no scan kernel under {root}", file=sys.stderr)
            return 2
        res = subprocess.run([sys.executable, "-c", CHILD, str(root), str(args.reps),
                              json.dumps(CASES)], capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append((tree, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"ran {tree}", flush=True)
    bad = []
    for name, *_ in CASES:
        line = " ".join(f"{tree}={r[name]['ms']:.3f}" for tree, r in runs)
        print(f"{name:16s} ms: {line}")
        if len({r[name]["digest"] for _, r in runs}) != 1:
            bad.append(name)
    if bad:
        print(f"scan_ab.py: outputs differ between trees in {bad}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"card": card, "trees": args.trees,
                      "ms": {name: [r[name]["ms"] for _, r in runs] for name, *_ in CASES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
