"""Bounded stage-handoff queues for the eval-lifecycle pipeline.

Stage threads in ``nomad_tpu/pipeline`` may ONLY exchange work through
these queues (enforced by the ``pipeline-stage-discipline`` lint rule):
a bounded queue makes backpressure explicit — when the commit stage
falls behind, the dispatch stage blocks on a full queue instead of
growing an unbounded backlog that hides the stall until memory dies.
Depth is readable without locking the producer (``qsize`` is advisory,
which is all a gauge needs).

Copied from ``nomad_tpu/pipeline/queues.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import queue
from typing import Any, Optional


class BoundedStageQueue:
    """A bounded FIFO between two pipeline stages, with a depth gauge.

    Thin wrapper over ``queue.Queue`` on purpose: the value is the
    CONTRACT (bounded, depth-observable, the only legal stage handoff),
    not the mechanism.
    """

    def __init__(self, maxsize: int, name: str = "") -> None:
        if maxsize <= 0:
            raise ValueError("stage queues must be bounded (maxsize > 0)")
        self.name = name
        self.maxsize = maxsize
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        self._q.put(item, timeout=timeout)

    def put_nowait(self, item: Any) -> None:
        self._q.put_nowait(item)

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)

    def get_nowait(self) -> Any:
        return self._q.get_nowait()

    def depth(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()
