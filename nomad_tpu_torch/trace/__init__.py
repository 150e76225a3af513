"""nomad-trace, trimmed to what the placement and server slices record.

``context`` carries the cross-process TraceContext that ``Evaluation``
payloads hold, ``lifecycle`` the per-eval spans the schedulers, workers
and pipeline stamp, ``capacity`` the blocked-eval storm ledger,
``flight`` the leader's flight recorder and ``watchdog`` its liveness
watchdog. The attribution and stitching layers of ``nomad_tpu/trace/``
read these across processes and are not ported yet.

Trimmed copy of ``nomad_tpu/trace/__init__.py``.
"""
from . import capacity, context, lifecycle
from .context import TraceContext
from .flight import FlightRecorder, install_server_probes
from .watchdog import LivenessWatchdog

__all__ = [
    "capacity",
    "context",
    "lifecycle",
    "TraceContext",
    "FlightRecorder",
    "install_server_probes",
    "LivenessWatchdog",
]
