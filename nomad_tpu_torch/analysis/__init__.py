"""nomad-lint, trimmed to the three concurrency rules the churn replay's
witness gates read back.

  - ``lock-order``        whole-program lock acquisition-order cycles
  - ``condition-discipline`` waits re-check predicates, notifies hold locks
  - ``shared-state-discipline`` writes to attributes inferred shared across
                          thread roots are proven lock-guarded
                          (``# guarded-by:`` declarations stay
                          authoritative; ``# race-ok: <reason>`` suppresses
                          with a ratchet on stale claims)

``lock_order.build_static_graph()`` and
``shared_state.build_static_shared()`` read the port's own tree (their
default root is ``nomad_tpu_torch``), so a witness-armed
:class:`~nomad_tpu_torch.chaos.replay.ChurnReplay` cross-checks what it
witnessed against the port's static graphs. The other ten rule modules
and the ``python -m`` entry point (``__main__``) are not ported yet.

Trimmed copy of ``nomad_tpu/analysis/__init__.py``.
"""
from .core import (  # noqa: F401
    Finding,
    apply_baseline,
    default_checkers,
    load_baseline,
    run_paths,
    run_source,
    write_baseline,
)

__all__ = [
    "Finding",
    "apply_baseline",
    "default_checkers",
    "load_baseline",
    "run_paths",
    "run_source",
    "write_baseline",
]
