"""CLI output helpers (reference command/helpers.go formatList/formatKV via
ryanuber/columnize).

Copied from ``nomad_tpu/cli/fmt.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Sequence


def columns(rows: Sequence[Sequence[object]], header: bool = True) -> str:
    """Align columns two-spaces apart, like columnize's default."""
    if not rows:
        return ""
    cells = [[("" if c is None else str(c)) for c in row] for row in rows]
    ncols = max(len(r) for r in cells)
    widths = [0] * ncols
    for row in cells:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    out = []
    for row in cells:
        line = "  ".join(
            c.ljust(widths[i]) if i < len(row) - 1 else c for i, c in enumerate(row)
        )
        out.append(line.rstrip())
    return "\n".join(out)


def kv(pairs: Iterable[Sequence[object]]) -> str:
    """'Key = Value' blocks (reference formatKV)."""
    items = [(str(k), "" if v is None else str(v)) for k, v in pairs]
    if not items:
        return ""
    w = max(len(k) for k, _ in items)
    return "\n".join(f"{k.ljust(w)} = {v}" for k, v in items)


def short_id(full: str, length: int = 8) -> str:
    return (full or "")[:length]


def ago(ns: int) -> str:
    """Nanosecond timestamp -> '3m5s ago' (reference prettyTimeDiff)."""
    if not ns:
        return "<none>"
    secs = int(time.time() - ns / 1e9)
    if secs < 0:
        secs = 0
    return f"{duration(secs)} ago"


def duration(secs: int) -> str:
    if secs < 60:
        return f"{secs}s"
    if secs < 3600:
        return f"{secs // 60}m{secs % 60}s"
    if secs < 86400:
        return f"{secs // 3600}h{(secs % 3600) // 60}m"
    return f"{secs // 86400}d{(secs % 86400) // 3600}h"
