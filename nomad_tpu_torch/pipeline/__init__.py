"""nomad-pipeline: the asynchronous eval-lifecycle pipeline.

The leader's placement path decomposes into explicit stages so
DIFFERENT eval waves occupy different stages at once — wave N+1's
encode overlaps wave N's device dispatch and wave N-1's raft commit,
instead of each eval traversing the whole chain serially on one worker
thread (the host-side convoy that capped r5's C1M run at ~514
placements/s around a ~94K/s device kernel):

    broker ──► worker: snapshot/encode ──► device dispatch ─┐
      ▲          (HOST_WORK_SEM,             (DeviceBatcher  │
      │           encode cache)               gather queue)  │
      │                                                      ▼
      │                              worker builds dense Plan│
      │                                 AsyncApplier.try_submit
      │                                          │
      │                              plan queue (bounded batch)
      │                                          │
      │                              Planner: evaluate (vectorized
      │                                numpy re-check) + batched
      │                                raft commit
      │                                          │
      │                              completion queue (bounded)
      │                                          │
      │            full commit: wait_min_index + ack
      └──────────┤
                   partial commit: re-dispatch from the wave's
                   remembered encode (row-subset + usage-epoch patch,
                   warm compile buckets) — else nack

Stages communicate ONLY through bounded queues (the broker's unack
table, the device batcher's gather queue, the plan queue's batch cap,
and this package's completion queue); the ``pipeline-stage-discipline``
lint rule keeps raft applies and state-store writes out of the
dispatch-stage thread. Per-stage spans (``encode`` / ``dispatch`` /
``evaluate`` / ``commit``, keyed by wave = eval id) land in
trace/lifecycle and surface as ``nomad.trace.pipeline.*`` gauges.

ServerConfig knobs: ``pipeline_async`` (master switch),
``pipeline_inflight`` (async waves in flight before workers fall back
to synchronous submit), ``pipeline_redispatch_max`` (device re-entries
per wave before nacking), ``pipeline_ack_timeout_s`` (watchdog bound on
an unacked accepted wave).

Copied from ``nomad_tpu/pipeline/__init__.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from .applier import AsyncApplier
from .queues import BoundedStageQueue
from .redispatch import Redispatcher, WaveEncodeRegistry

__all__ = [
    "AsyncApplier",
    "BoundedStageQueue",
    "Redispatcher",
    "WaveEncodeRegistry",
]
