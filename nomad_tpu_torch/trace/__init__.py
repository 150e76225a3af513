"""nomad-trace, trimmed to what the port's server and churn replay record
and read.

``context`` carries the cross-process TraceContext that ``Evaluation``
payloads hold, ``lifecycle`` the per-eval spans the schedulers, workers
and pipeline stamp, ``capacity`` the blocked-eval storm ledger,
``flight`` the leader's flight recorder and ``watchdog`` its liveness
watchdog. ``attribution`` joins lifecycle and pipeline spans into the
ranked critical-path ledger (``bottleneck_report``) and its stitched
cross-process form; ``stitch`` merges span rings into per-trace trees;
``failover`` records the crash harness's recovery episodes (imported
from its module, as in the reference).

Trimmed copy of ``nomad_tpu/trace/__init__.py``.
"""
from . import attribution, capacity, context, lifecycle, stitch
from .context import TraceContext
from .flight import FlightRecorder, install_server_probes
from .watchdog import LivenessWatchdog

__all__ = [
    "attribution",
    "capacity",
    "context",
    "lifecycle",
    "stitch",
    "TraceContext",
    "FlightRecorder",
    "install_server_probes",
    "LivenessWatchdog",
]
