"""Bridge between the schedulers and the port's placement engine.

``compute_placements_with_engine`` returns True when the engine handled
the eval's whole placement batch, or NotImplemented when the encode took
one of the reference's unsupported-feature gates and the host iterator
stack places the eval. ``compute_system_placements_with_engine`` returns
True, NotImplemented, or the list of placements the system scheduler's
host per-node loop must still place (nodes needing a preemption the
device does not run, as in the reference). The engine runs on the
scheduler's ``device`` (CUDA unless the caller asked for the CPU); a
missing GPU, or a kernel that fails to build or launch, raises instead
of placing on the host.

Port of ``nomad_tpu/tpu/integration.py``, without its
``except ImportError: return NotImplemented``. Both entry points run
under the ``engine_gate`` phase, as there.
"""
from __future__ import annotations

from ..utils import phases as _phases
from .engine import TorchPlacementEngine


def compute_placements_with_engine(sched, destructive, place):
    with _phases.track("engine_gate"):
        engine = TorchPlacementEngine.shared(getattr(sched, "device", "cuda"))
        return engine.compute_placements(sched, destructive, place)


def compute_system_placements_with_engine(sched, place, sched_config=None):
    with _phases.track("engine_gate"):
        engine = TorchPlacementEngine.shared(getattr(sched, "device", "cuda"))
        return engine.compute_system_placements(sched, place, sched_config)
