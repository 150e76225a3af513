"""nomad-chaos: churn/chaos trace-replay harness with fault injection.

Three pieces (see each module's docstring for the contract):

- :mod:`.injector` — seeded fault-injection registry. Production modules
  call ``fire(point)`` at named injection points; strict no-ops unless a
  :class:`ChaosInjector` armed the point.
- :mod:`.trace` — deterministic churn schedules (``generate_trace(seed)``):
  registrations, stops, rollouts, drains, heartbeat expiries, fault
  windows, a mid-run leader kill.
- :mod:`.replay` + :mod:`.slo` — :class:`ChurnReplay` plays a trace
  against a live in-proc cluster of the port's servers; :class:`SLOGate`
  turns the run's trace gauges, throughput, and state-store invariant
  sweep into pass/fail.

- :mod:`.crash` — :class:`CrashReplay` plays the same trace against
  real server processes (:mod:`.crash_server`, one
  :class:`ServerProcess` each) over the wire, where the leader kill is a
  SIGKILL -9.

Copy of ``nomad_tpu/chaos/__init__.py``.
"""
from .injector import MODES, POINTS, ChaosFault, ChaosInjector, active, fire

# Production modules import ``..chaos.injector`` for the fire() hook, and
# replay imports the server back — so everything past the injector loads
# lazily (PEP 562) to keep that edge acyclic and the hook import cheap.
_LAZY = {
    "ChurnReplay": ("replay", "ChurnReplay"),
    "CrashReplay": ("crash", "CrashReplay"),
    "ServerProcess": ("crash", "ServerProcess"),
    "invariant_sweep": ("replay", "invariant_sweep"),
    "invariant_sweep_allocs": ("replay", "invariant_sweep_allocs"),
    "SLOGate": ("slo", "SLOGate"),
    "SLOThresholds": ("slo", "SLOThresholds"),
    "ChaosEvent": ("trace", "ChaosEvent"),
    "generate_trace": ("trace", "generate_trace"),
    "trace_kind_counts": ("trace", "trace_kind_counts"),
    "trace_to_jsonable": ("trace", "trace_to_jsonable"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    value = getattr(mod, attr)
    globals()[name] = value
    return value


__all__ = [
    "POINTS",
    "MODES",
    "ChaosFault",
    "ChaosInjector",
    "active",
    "fire",
    "ChaosEvent",
    "generate_trace",
    "trace_kind_counts",
    "trace_to_jsonable",
    "ChurnReplay",
    "CrashReplay",
    "ServerProcess",
    "invariant_sweep",
    "invariant_sweep_allocs",
    "SLOGate",
    "SLOThresholds",
]
