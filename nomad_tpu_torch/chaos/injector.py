"""Seeded fault-injection registry: named points, strict no-ops unless armed.

Production modules carry exactly one chaos hook shape — a call to this
module's ``fire(point)`` at the site where a fault would enter the real
system (the ``fault-injection-discipline`` lint rule rejects any other
chaos conditioning in production code). When nothing is armed, ``fire``
is a single global read and a return: the production cost of having the
hooks compiled in is one dict-free branch per call site.

The points mirror the failure surfaces the churn harness shakes:

==================  ========================================================
``device_dispatch``  ``tpu/batcher.DeviceBatcher.run`` — a raised fault
                     forces the engine's host-iterator fallback for that
                     eval; a delay models a slow/hung device round trip.
``plan_apply``       ``server/plan_apply.Planner.evaluate_plan`` — the
                     per-payload isolation in ``_evaluate_and_fold`` turns
                     the fault into that plan's future error (async waves
                     nack through the applier's ``apply_error`` path).
``broker_ack``       ``server/eval_broker.EvalBroker.ack`` — a lost ack:
                     the delivery stays unacked until the nack timer
                     redelivers it.
``raft_apply``       ``server/server.Server.raft_apply`` — a failed log
                     append, same blast radius as losing leadership
                     mid-write; every caller already survives it.
``heartbeat``        ``server/heartbeat.HeartbeatTimers.reset_heartbeat_timer``
                     — a dropped heartbeat; enough of them in a row and
                     the TTL expires, marking the node down.
``unblock_enqueue``  ``server/blocked_evals.BlockedEvals._flush_pending_locked``
                     — a fault on the coalesced unblock-storm re-enqueue:
                     the staged batch parks and retries on a bounded
                     backoff timer instead of reaching the broker.
``watch_notify``     ``watch/hub.WatchHub.notify`` — a dropped/delayed
                     post-apply watch notification: parked blocking
                     queries lose at most one flush window of wakeups and
                     degrade to their ``max_query_time`` deadline
                     re-query; the apply path that notified is untouched.
==================  ========================================================

Determinism: each armed point draws from its own ``random.Random`` seeded
from ``(seed, point)``, so a fixed seed yields a fixed fire/skip DECISION
SEQUENCE per point. (Cross-thread arrival order is the caller's problem;
the replayable artifact of a chaos run is the event trace, not the
per-fire interleaving.)

Arming discipline (also lint-enforced): every ``arm`` in consumer code
must have a matching ``disarm``/``disarm_all`` in a ``finally`` — an
injector that outlives its test run poisons everything after it.

Copied from ``nomad_tpu/chaos/injector.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import threading
import time
from random import Random
from typing import Dict, Optional
from ..utils.faults import InjectedFault
from ..utils.lock_witness import witness_lock

POINTS = (
    "device_dispatch",
    "plan_apply",
    "broker_ack",
    "raft_apply",
    "heartbeat",
    "unblock_enqueue",
    "watch_notify",
)

MODES = ("fail", "delay")


class ChaosFault(InjectedFault):
    """A deliberately injected fault (never raised unless a point is armed)."""


class _PointSpec:
    __slots__ = ("mode", "prob", "rng", "max_fires", "delay_s",
                 "fires", "skips")

    def __init__(self, mode: str, prob: float, rng: Random,
                 max_fires: Optional[int], delay_s: float) -> None:
        self.mode = mode
        self.prob = prob
        self.rng = rng
        self.max_fires = max_fires
        self.delay_s = delay_s
        self.fires = 0
        self.skips = 0


class ChaosInjector:
    """One armed registry at a time (module-global ``_ACTIVE``); points
    arm/disarm independently. All spec state is guarded by ``_lock``;
    delays sleep outside it so a slow point never serializes the rest."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self._lock = witness_lock("injector.ChaosInjector._lock")
        self._specs: Dict[str, _PointSpec] = {}

    # -- arming ----------------------------------------------------------

    def arm(self, point: str, mode: str = "fail", prob: float = 1.0,
            max_fires: Optional[int] = None, delay_s: float = 0.0) -> None:
        """Arm ``point``: each subsequent ``fire(point)`` draws against
        ``prob``; a hit raises ChaosFault (mode="fail") or sleeps
        ``delay_s`` (mode="delay"), at most ``max_fires`` times."""
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"known: {', '.join(POINTS)}")
        if mode not in MODES:
            raise ValueError(f"unknown chaos mode {mode!r}; known: "
                             f"{', '.join(MODES)}")
        rng = Random(f"{self.seed}:{point}")
        with self._lock:
            self._specs[point] = _PointSpec(
                mode, float(prob), rng,
                None if max_fires is None else int(max_fires),
                float(delay_s),
            )
        _set_active(self)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._specs.pop(point, None)
            empty = not self._specs
        if empty:
            _clear_active(self)

    def disarm_all(self) -> None:
        with self._lock:
            self._specs.clear()
        _clear_active(self)

    def armed_points(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._specs))

    # -- firing ----------------------------------------------------------

    def _fire(self, point: str, ctx: dict) -> None:
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return
            if spec.max_fires is not None and spec.fires >= spec.max_fires:
                spec.skips += 1
                return
            if spec.prob < 1.0 and spec.rng.random() >= spec.prob:
                spec.skips += 1
                return
            spec.fires += 1
            mode, delay_s = spec.mode, spec.delay_s
        if mode == "delay":
            time.sleep(delay_s)
            return
        raise ChaosFault(f"injected fault at {point}"
                         + (f" ({ctx})" if ctx else ""))

    # -- observability ---------------------------------------------------

    def fires(self, point: str) -> int:
        with self._lock:
            spec = self._specs.get(point)
            return spec.fires if spec is not None else 0

    def stats(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {
                point: {
                    "mode": spec.mode,
                    "prob": spec.prob,
                    "fires": spec.fires,
                    "skips": spec.skips,
                }
                for point, spec in sorted(self._specs.items())
            }


# -- the production-facing hook ---------------------------------------------
#
# _ACTIVE is None almost always; production call sites pay one global read.
# Exactly one injector can be active — a second injector arming while
# another holds the slot is a harness bug and raises immediately.

_ACTIVE: Optional[ChaosInjector] = None
_active_lock = threading.Lock()


def _set_active(inj: ChaosInjector) -> None:
    global _ACTIVE
    with _active_lock:
        if _ACTIVE is not None and _ACTIVE is not inj:
            raise RuntimeError(
                "another ChaosInjector is already armed; disarm it first"
            )
        _ACTIVE = inj


def _clear_active(inj: ChaosInjector) -> None:
    global _ACTIVE
    with _active_lock:
        if _ACTIVE is inj:
            _ACTIVE = None


def active() -> Optional[ChaosInjector]:
    return _ACTIVE


def fire(point: str, **ctx) -> None:
    """The ONE hook production modules call. Strict no-op unless an
    injector armed this point; may raise ChaosFault or sleep when it did."""
    inj = _ACTIVE
    if inj is None:
        return
    inj._fire(point, ctx)
