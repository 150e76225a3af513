"""Periodic job dispatcher: cron-launches child jobs.

Fills the role of reference ``nomad/periodic.go`` (:22 PeriodicDispatch —
heap of next launch times, leader-only) plus the cron evaluation the
reference delegates to the vendored gorhill/cronexpr; here a small 5-field
cron engine (minute hour day-of-month month day-of-week, with ``*``, lists,
ranges, and ``*/step``) is implemented directly.

At each launch time the dispatcher derives a child job named
``<parent>/periodic-<unixtime>`` (reference periodic.go deriveJob) and
registers it through the normal Job.Register path, which creates the eval.
``prohibit_overlap`` skips a launch while a previous child is live
(periodic.go:ForceRun / shouldRun overlap check). Launches are recorded in
the state store (periodic_launch table, schema.go:31-49) so a new leader
resumes from the last launch instead of re-firing old ones.

Copied from ``nomad_tpu/server/periodic.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from __future__ import annotations

import calendar
import logging
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Tuple

from ..structs.structs import Job
from ..utils.lock_witness import witness_lock

# ---------------------------------------------------------------------------
# cron engine
# ---------------------------------------------------------------------------

_FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))


def _parse_field(spec: str, lo: int, hi: int) -> frozenset:
    """One cron field -> set of matching values. day-of-week: 0=Sunday,
    7 normalized to 0."""
    out = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"cron step must be positive: {spec!r}")
        if part == "*" or part == "":
            lo_p, hi_p = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo_p, hi_p = int(a), int(b)
        else:
            lo_p = hi_p = int(part)
            if "/" in spec and step > 1:
                hi_p = hi  # "N/step" means starting at N
        for v in range(lo_p, hi_p + 1, step):
            if lo == 0 and hi == 6:  # day-of-week: 7 == Sunday == 0
                v = 0 if v == 7 else v
            if not (lo <= v <= hi):
                raise ValueError(f"cron value {v} out of range in {spec!r}")
            out.add(v)
    return frozenset(out)


class CronExpr:
    """A parsed 5-field cron expression."""

    def __init__(self, spec: str) -> None:
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields, got {spec!r}")
        self.minutes, self.hours, self.doms, self.months, self.dows = (
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _FIELD_RANGES)
        )
        self.dom_restricted = fields[2] != "*"
        self.dow_restricted = fields[4] != "*"

    def _day_matches(self, dt: datetime) -> bool:
        dom_ok = dt.day in self.doms
        dow_ok = (dt.weekday() + 1) % 7 in self.dows  # python Mon=0 -> cron Sun=0
        # vixie-cron: if both dom and dow are restricted, either matches
        if self.dom_restricted and self.dow_restricted:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next_after(self, after: datetime) -> Optional[datetime]:
        """Earliest instant strictly after ``after`` matching the spec."""
        dt = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        limit = after + timedelta(days=366 * 4 + 1)  # cover leap-day specs
        while dt <= limit:
            if dt.month not in self.months or not self._day_matches(dt):
                dt = (dt + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if dt.hour not in self.hours:
                dt = (dt + timedelta(hours=1)).replace(minute=0)
                continue
            if dt.minute not in self.minutes:
                dt += timedelta(minutes=1)
                continue
            return dt
        return None


def _tzinfo(name: str):
    if not name or name.upper() == "UTC":
        return timezone.utc
    from zoneinfo import ZoneInfo

    return ZoneInfo(name)


def next_launch_ns(job: Job, after_ns: int) -> Optional[int]:
    """Next launch time (ns) for a periodic job, strictly after ``after_ns``.
    The cron spec is evaluated on the wall clock of the job's configured
    timezone (reference periodic.go Next + GetTimeZone)."""
    p = job.periodic
    if p is None or not p.enabled:
        return None
    if p.spec_type != "cron":
        raise ValueError(f"unsupported periodic spec_type {p.spec_type!r}")
    tz = _tzinfo(p.timezone)
    after = datetime.fromtimestamp(after_ns / 1e9, tz=tz)
    nxt = CronExpr(p.spec).next_after(after)
    if nxt is None:
        return None
    return int(nxt.timestamp() * 1e9)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


class PeriodicDispatch:
    """Leader-only launcher of periodic jobs' children."""

    def __init__(self, server) -> None:
        self.server = server
        self.logger = logging.getLogger("nomad_tpu_torch.periodic")
        self._lock = witness_lock("periodic.PeriodicDispatch._lock")
        self._cond = threading.Condition(self._lock)
        self.enabled = False
        self._generation = 0
        # (namespace, job id) -> (job, next launch ns)
        self.tracked: Dict[Tuple[str, str], Tuple[Job, Optional[int]]] = {}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            if enabled == self.enabled:
                return
            self.enabled = enabled
            self._generation += 1
            gen = self._generation
            if not enabled:
                self.tracked.clear()
                self._cond.notify_all()
                return
        self._restore()
        t = threading.Thread(target=self._run, args=(gen,), name="periodic", daemon=True)
        t.start()

    def _restore(self) -> None:
        """Track every periodic job, resuming from its recorded last launch;
        a launch missed while no leader was running fires immediately
        (reference leader.go:376 restorePeriodicDispatcher force-runs
        missed launches)."""
        state = self.server.fsm.state
        now = time.time_ns()
        for job in state.jobs():
            if not (job.is_periodic() and not job.stopped()):
                continue
            last = state.periodic_launch_by_id(job.namespace, job.id)
            if last:
                try:
                    missed = next_launch_ns(job, last)
                except ValueError:
                    continue
                if missed is not None and missed <= now:
                    try:
                        self.force_launch(job.namespace, job.id, missed)
                    except Exception:  # noqa: BLE001
                        self.logger.exception("catch-up launch of %s failed", job.id)
                        self._track(job, now)
                    continue
            self._track(job, max(last, now) if last else now)

    def add(self, job: Job) -> None:
        """Track (or update/untrack) a periodic job on registration
        (periodic.go:Add)."""
        with self._lock:
            if not self.enabled:
                return
        if not job.is_periodic() or job.stopped():
            self.remove(job.namespace, job.id)
            return
        self._track(job, time.time_ns())

    def _track(self, job: Job, after_ns: int) -> None:
        try:
            nxt = next_launch_ns(job, after_ns)
        except ValueError:
            self.logger.exception("invalid periodic spec for %s", job.id)
            return
        with self._lock:
            self.tracked[(job.namespace, job.id)] = (job, nxt)
            self._cond.notify_all()

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            if self.tracked.pop((namespace, job_id), None) is not None:
                self._cond.notify_all()

    # ------------------------------------------------------------------

    def _run(self, gen: int) -> None:
        while True:
            with self._lock:
                if not self.enabled or self._generation != gen:
                    return
                now = time.time_ns()
                due = [
                    (key, job, nxt)
                    for key, (job, nxt) in self.tracked.items()
                    if nxt is not None and nxt <= now
                ]
                if not due:
                    nexts = [n for _, n in self.tracked.values() if n is not None]
                    wait_s = min(1.0, (min(nexts) - now) / 1e9) if nexts else 1.0
                    self._cond.wait(timeout=max(0.01, wait_s))
                    continue
            for key, job, launch_ns in due:
                try:
                    self.force_launch(job.namespace, job.id, launch_ns)
                except KeyError:
                    # job deregistered or no longer periodic: stop tracking
                    self.remove(*key)
                except Exception:  # noqa: BLE001
                    self.logger.exception("periodic launch of %s failed", job.id)
                    # advance (never resurrect a removed entry) so a bad job
                    # can't hot-loop the dispatcher
                    with self._lock:
                        if key in self.tracked:
                            still_job, _ = self.tracked[key]
                        else:
                            continue
                    self._track(still_job, launch_ns)

    def _children(self, namespace: str, parent_id: str) -> List[Job]:
        return self.server.fsm.state.jobs_by_parent(namespace, parent_id)

    def _child_live(self, child: Job) -> bool:
        """A child is live while it has a non-terminal alloc or an eval still
        in flight (the reference checks Job.Status == dead, which its state
        store recomputes from the same alloc/eval facts)."""
        state = self.server.fsm.state
        if child.stopped():
            return False
        if any(
            not a.terminal_status()
            for a in state.allocs_by_job(child.namespace, child.id, False)
        ):
            return True
        return any(
            not e.terminal_status()
            for e in state.evals_by_job(child.namespace, child.id)
        )

    def derive_job(self, parent: Job, launch_ns: int) -> Job:
        """Child job named <parent>/periodic-<unixtime> (periodic.go deriveJob)."""
        return parent.derive_child(f"{parent.id}/periodic-{launch_ns // 10**9}")

    def force_launch(
        self, namespace: str, job_id: str, launch_ns: Optional[int] = None
    ) -> Optional[str]:
        """Launch one child now (Periodic.Force RPC / scheduled launch).
        Returns the child job id, or None when skipped for overlap."""
        state = self.server.fsm.state
        job = state.job_by_id(namespace, job_id)
        if job is None or not job.is_periodic():
            raise KeyError(f"{job_id} is not a periodic job")
        launch_ns = launch_ns or time.time_ns()
        self._track(job, launch_ns)  # schedule the following launch

        if job.periodic.prohibit_overlap and any(
            self._child_live(c) for c in self._children(namespace, job_id)
        ):
            self.logger.info("skipping launch of %s: previous child live", job_id)
            return None
        child = self.derive_job(job, launch_ns)
        # register first: a failed registration must leave the slot
        # unconsumed so the launch retries rather than silently vanishing
        # (a dup after a crash between the two applies is caught by the
        # overlap check / child id equality)
        self.server.register_job(child)
        self.server.raft_apply("periodic-launch", (namespace, job_id, launch_ns))
        return child.id
