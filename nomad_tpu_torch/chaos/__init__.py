"""nomad-chaos, trimmed to the fault injector the server's hook points
call (``fire``); with no injector armed every hook is a no-op. The
churn/crash replay harnesses of ``nomad_tpu/chaos/`` drive the JAX
package's agents and are not ported.

Trimmed copy of ``nomad_tpu/chaos/__init__.py``.
"""
from .injector import MODES, POINTS, ChaosFault, ChaosInjector, active, fire

__all__ = [
    "POINTS",
    "MODES",
    "ChaosFault",
    "ChaosInjector",
    "active",
    "fire",
]
