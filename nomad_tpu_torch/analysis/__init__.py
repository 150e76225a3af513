"""nomad-lint: AST invariant checkers for the repo's load-bearing rules.

Headline rules (full table in ``nomad_tpu_torch/analysis/README.md``):

  - ``jit-purity``        jax.jit-compiled functions (and their transitive
                          same-module callees) stay host-effect free
  - ``dtype-discipline``  no float64 creep in the integer parity encode path
  - ``fsm-determinism``   FSM apply handlers never read wall clock or RNG
  - ``lock-order``        whole-program lock acquisition-order cycles
  - ``condition-discipline`` waits re-check predicates, notifies hold locks
  - ``shared-state-discipline`` writes to attributes inferred shared across
                          thread roots are proven lock-guarded
                          (``# guarded-by:`` declarations stay
                          authoritative; ``# race-ok: <reason>`` suppresses
                          with a ratchet on stale claims)

Run: ``python -m nomad_tpu_torch.analysis [paths...]`` — exits non-zero on any
finding not recorded in ``nomad_tpu_torch/analysis/baseline.json`` and not
suppressed by an inline ``# nomad-lint: disable=<rule>`` comment.
The tier-1 suite runs the same pass in
``tests/test_torch_isolation.py`` and ``tests/test_torch_static_analysis.py``.

``lock_order.build_static_graph()`` and
``shared_state.build_static_shared()`` read the port's own tree (their
default root is ``nomad_tpu_torch``), so a witness-armed
:class:`~nomad_tpu_torch.chaos.replay.ChurnReplay` cross-checks what it
witnessed against the port's static graphs.

Copied from ``nomad_tpu/analysis/__init__.py``.
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
