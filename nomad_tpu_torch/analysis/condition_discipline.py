"""condition-discipline: Condition waits loop on their predicate and
notifies hold the lock.

Two classic condition-variable bugs this rule pins down statically:

- **Bare wait.** ``cond.wait()`` returns on notify, timeout, OR a
  spurious wakeup; code that waits once and proceeds acts on a
  predicate that may not hold. Every ``wait()`` on an inventoried
  Condition must sit lexically inside a ``while``-predicate loop in the
  same function (``wait_for`` carries its own loop and is exempt).

- **Unheld notify.** ``notify()``/``notify_all()`` without the
  condition's lock held raises ``RuntimeError`` at runtime — but only
  on the path that executes it. The checker proves the lock statically:
  the call is lexically inside a ``with`` of the condition (or the lock
  it wraps), the enclosing function follows the repo's ``*_locked``
  caller-holds naming convention, or every resolved call site of the
  enclosing function (transitively, depth-bounded — the same
  conservative name-based call graph the lock-order pass builds) sits
  under the lock.

Shares :class:`~nomad_tpu_torch.analysis.lock_order.WholeProgramLockAnalysis`
with the lock-order rule; conditions are recognized from the same
inventory (``threading.Condition(...)`` / ``witness_condition(...)``
assignments), so an ``Event.wait`` or a subprocess ``wait()`` never
trips it.

Copied from ``nomad_tpu/analysis/condition_discipline.py`` into the
PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

from typing import List, Optional

from .core import Finding, ParsedModule
from .lock_order import WholeProgramLockAnalysis

RULE = "condition-discipline"


class ConditionDisciplineChecker:
    rule = RULE

    def __init__(self, analysis: Optional[WholeProgramLockAnalysis] = None
                 ) -> None:
        self.analysis = analysis or WholeProgramLockAnalysis()
        self._findings: Optional[List[Finding]] = None

    def collect(self, module: ParsedModule) -> None:
        self.analysis.add_module(module)

    def _compute(self) -> List[Finding]:
        if self._findings is not None:
            return self._findings
        self.analysis.analyze()
        findings: List[Finding] = []
        for unit in self.analysis._units:
            rel = unit.mod.pm.rel
            fn = unit.qual
            for _key, lineno, in_while, is_wait_for in unit.waits:
                if is_wait_for or in_while:
                    continue
                findings.append(Finding(
                    RULE, rel, lineno,
                    f"Condition.wait() outside a while-predicate loop in "
                    f"{fn} — spurious wakeups and timeouts return with "
                    f"the predicate unchecked (use `while not pred: "
                    f"cond.wait(...)` or wait_for)",
                ))
            for lock_key, meth, lineno, lex_held in unit.notifies:
                if self.analysis.notify_held(unit, lock_key, lex_held):
                    continue
                findings.append(Finding(
                    RULE, rel, lineno,
                    f"{meth}() on condition guarding '{lock_key}' in {fn} "
                    f"is not provably issued with the lock held (no "
                    f"enclosing 'with', no *_locked caller convention, "
                    f"and not every call site holds it)",
                ))
        self._findings = findings
        return findings

    def check(self, module: ParsedModule) -> List[Finding]:
        return [f for f in self._compute() if f.file == module.rel]
