"""Evaluation monitor: follow an eval to completion, printing placements and
failures (reference command/monitor.go).

Copied from ``nomad_tpu/cli/monitor.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from __future__ import annotations

import time
from typing import Callable

from ..api import APIError, Client
from .fmt import short_id


def monitor_eval(client: Client, eval_id: str, out: Callable[[str], None],
                 timeout: float = 60.0, verbose: bool = False) -> int:
    """Poll until the eval reaches a terminal state. Returns exit code."""
    ident = eval_id if verbose else short_id(eval_id)
    out(f"==> Monitoring evaluation \"{ident}\"")
    seen_allocs = set()
    deadline = time.time() + timeout
    last_status = ""
    while time.time() < deadline:
        try:
            ev, _ = client.evaluations.info(eval_id)
        except APIError as e:
            out(f"==> Error reading evaluation: {e}")
            return 1
        status = ev.get("Status", "")
        if status != last_status:
            out(f"    Evaluation triggered by job \"{ev.get('JobID', '')}\"")
            last_status = status
        try:
            allocs, _ = client.evaluations.allocations(eval_id)
        except APIError:
            allocs = []
        for alloc in allocs or []:
            if alloc["ID"] in seen_allocs:
                continue
            seen_allocs.add(alloc["ID"])
            out(
                f"    Allocation \"{short_id(alloc['ID'])}\" created: "
                f"node \"{short_id(alloc.get('NodeID', ''))}\", "
                f"group \"{alloc.get('TaskGroup', '')}\""
            )
        if status in ("complete", "failed", "canceled"):
            out(f"==> Evaluation \"{ident}\" finished with status \"{status}\"")
            failures = ev.get("FailedTGAllocs") or {}
            if failures:
                out("==> Failed placements:")
                for tg, metric in failures.items():
                    out(f"    Task Group \"{tg}\" (failed to place)")
                    for klass, why in (metric.get("ClassFiltered") or {}).items():
                        out(f"      * Class {klass} filtered: {why}")
                    for dim, n in (metric.get("DimensionExhausted") or {}).items():
                        out(f"      * Dimension {dim!r} exhausted on {n} nodes")
                if ev.get("BlockedEval"):
                    out(
                        f"    Evaluation \"{short_id(ev['BlockedEval'])}\" "
                        "waiting for additional capacity to place remainder"
                    )
            return 0 if status == "complete" else 2
        time.sleep(0.2)
    out(f"==> Timed out monitoring evaluation \"{ident}\"")
    return 1
