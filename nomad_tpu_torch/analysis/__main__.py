"""CLI: ``python -m nomad_tpu_torch.analysis [paths...]``.

Exit 0 when every finding is baselined or suppressed AND no baseline
entry is stale; 1 on new findings or stale baseline entries (the
ratchet is enforced both ways — a fixed finding must be pruned, not
left as a silent credit new regressions could spend); 2 on bad usage.

``--write-baseline`` records the current findings as the new baseline.
``--prune`` rewrites the baseline in place with only the stale entries
removed (the surgical version: it never ADDS entries, so it cannot
launder a new finding into the baseline). ``--rule`` restricts the run
to a comma-separated set of rules — baseline matching is restricted to
the same rules so unrelated entries are not reported stale.
``--changed-only`` scopes REPORTING (and baseline matching) to the
given files for fast pre-commit runs, while the collect pass still sees
the whole tree so cross-module rules keep their whole-program facts.

``--json`` emits a machine-readable object:

    {
      "findings":       [{rule, file, line, message, rendered}, ...],
      "counts":         {rule: int, ...},
      "stale_baseline": [{rule, file, message}, ...],
      "rule_wall_ms":   {rule: float, ...,    # per-rule wall time
                         "call-graph": float} # shared interprocedural
                                              # build (lock-order /
                                              # condition-discipline /
                                              # shared-state-discipline)
    }

Copied from ``nomad_tpu/analysis/__main__.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .core import (
    apply_baseline,
    load_baseline,
    run_paths,
    write_baseline,
)

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.analysis",
        description="nomad-lint: AST invariant checks "
                    "(jit-purity, dtype-discipline, lock-order, "
                    "condition-discipline, shared-state-discipline, "
                    "fsm-determinism, ...)",
    )
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to lint (default: nomad_tpu_torch)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON (default: the shipped "
                             "nomad_tpu_torch/analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, baselined or not")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record current findings as the new baseline")
    parser.add_argument("--prune", action="store_true",
                        help="rewrite the baseline with stale (fixed) "
                             "entries removed; never adds entries")
    parser.add_argument("--rule", action="append", default=None,
                        help="only run/report these rules (repeatable or "
                             "comma-separated); baseline matching is "
                             "restricted to the same rules")
    parser.add_argument("--changed-only", action="append", default=None,
                        metavar="PATH",
                        help="only report findings in these files "
                             "(repeatable or comma-separated); the whole "
                             "tree is still collected so cross-module "
                             "rules stay whole-program. Baseline matching "
                             "is restricted to the same files.")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit a JSON object: rendered findings, "
                             "per-rule counts, stale baseline entries, "
                             "per-rule wall time (rule_wall_ms)")
    args = parser.parse_args(argv)

    paths = args.paths or ["nomad_tpu_torch"]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    rules = None
    if args.rule:
        rules = {r.strip() for part in args.rule for r in part.split(",")
                 if r.strip()}
        if not rules:
            print("error: --rule given but empty", file=sys.stderr)
            return 2

    only_rel = None
    if args.changed_only:
        changed = [c.strip() for part in args.changed_only
                   for c in part.split(",") if c.strip()]
        if not changed:
            print("error: --changed-only given but empty", file=sys.stderr)
            return 2
        # deleted files are legitimate "changed" inputs: they simply
        # cannot have findings, so they scope to nothing
        only_rel = {
            os.path.relpath(os.path.abspath(c), os.getcwd())
            .replace(os.sep, "/")
            for c in changed
        }

    timings: dict = {}
    findings = run_paths(paths, rel_to=os.getcwd(), only_rel=only_rel,
                         timings=timings)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]

    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    stale = []
    if not args.no_baseline and os.path.exists(baseline_path):
        baseline = load_baseline(baseline_path)
        if rules is not None:
            baseline = [e for e in baseline if e.get("rule") in rules]
        if only_rel is not None:
            baseline = [e for e in baseline if e.get("file") in only_rel]
        findings, stale = apply_baseline(findings, baseline)

    if args.prune:
        if args.no_baseline or not os.path.exists(baseline_path):
            print("error: --prune needs an existing baseline", file=sys.stderr)
            return 2
        full = load_baseline(args.baseline or DEFAULT_BASELINE)
        budget = {}
        for ent in stale:
            key = (ent.get("rule", ""), ent.get("file", ""),
                   ent.get("message", ""))
            budget[key] = budget.get(key, 0) + 1
        kept = []
        for ent in full:
            key = (ent.get("rule", ""), ent.get("file", ""),
                   ent.get("message", ""))
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                continue
            kept.append(ent)
        with open(baseline_path, "w", encoding="utf-8") as fh:
            json.dump(kept, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"pruned {len(stale)} stale entr"
              f"{'y' if len(stale) == 1 else 'ies'}; "
              f"{len(kept)} kept in {baseline_path}")
        stale = []

    counts = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1

    if args.as_json:
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "file": f.file, "line": f.line,
                 "message": f.message, "rendered": f.render()}
                for f in findings
            ],
            "counts": counts,
            "stale_baseline": stale,
            "rule_wall_ms": {
                rule: round(sec * 1000.0, 3)
                for rule, sec in sorted(timings.items())
            },
        }, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        if stale:
            print(f"note: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (fixed findings) — "
                  "re-run with --prune to drop them", file=sys.stderr)
    if findings:
        print(f"{len(findings)} new finding(s)", file=sys.stderr)
        return 1
    if stale:
        print("stale baseline entries fail the run: the ratchet only "
              "tightens", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
