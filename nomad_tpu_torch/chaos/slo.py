"""SLO gate: pass/fail evaluation of a chaos-replay run.

The gate reads the same surfaces production observability exposes — the
nomad-trace lifecycle summary (``nomad.trace.eval_ms.p99``,
``slowest_inflight_ms``), the replay driver's measured placement
throughput, and the post-run state-store invariant sweep — and reduces
them to a list of named checks plus a single ``passed`` bit. A chaos
run without a gate is an anecdote; with one it is a regression test.

Copied from ``nomad_tpu/chaos/slo.py`` into the PyTorch port, which imports nothing
of ``nomad_tpu``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class SLOThresholds:
    """Bounds a chaos run must stay inside to pass.

    ``None`` disables a check (it reports as skipped, not passed —
    the artifact still shows the observed value).
    """
    eval_ms_p99_max: Optional[float] = 2000.0
    slowest_inflight_ms_max: Optional[float] = 10_000.0
    throughput_min_allocs_per_s: Optional[float] = 10.0
    require_zero_lost: bool = True
    require_zero_duplicated: bool = True
    require_converged: bool = True
    # failover MTTR bounds (crash-recovery runs; the result's "failover"
    # block comes from nomad_tpu_torch.trace.failover via CrashReplay)
    failover_new_leader_ms_max: Optional[float] = None
    failover_first_commit_ms_max: Optional[float] = None
    require_rejoin: bool = False
    # minimum critical-path attribution coverage (the result's
    # "bottleneck_report" block from nomad_tpu_torch.trace.attribution): below
    # this the instrumentation lost track of where the wall went and the
    # run's bottleneck claim is untrustworthy
    attribution_coverage_min: Optional[float] = None
    # same floor for the STITCHED cross-process ledger (the result's
    # "stitched" block from nomad_tpu_torch.trace.stitch + attribution via
    # the crash harness's Trace.Export collector)
    stitched_attribution_coverage_min: Optional[float] = None
    # capacity-pressure bounds (the result's "capacity" block from
    # nomad_tpu_torch.trace.capacity via ChurnReplay): the saturated-regime
    # gates — evals must actually have parked (peak_min), placement must
    # follow capacity fast (p99), the storm must not convoy the pipeline
    # (flatline), the blocked depth must drain by trace end, and the
    # unblock path must demonstrably batch (mean batch size)
    blocked_peak_min: Optional[int] = None
    unblock_to_place_p99_ms_max: Optional[float] = None
    storm_flatline_s_max: Optional[float] = None
    blocked_drain_frac_max: Optional[float] = None
    unblock_batch_mean_min: Optional[float] = None

    def to_dict(self) -> Dict[str, object]:
        return {
            "eval_ms_p99_max": self.eval_ms_p99_max,
            "slowest_inflight_ms_max": self.slowest_inflight_ms_max,
            "throughput_min_allocs_per_s": self.throughput_min_allocs_per_s,
            "require_zero_lost": self.require_zero_lost,
            "require_zero_duplicated": self.require_zero_duplicated,
            "require_converged": self.require_converged,
            "failover_new_leader_ms_max": self.failover_new_leader_ms_max,
            "failover_first_commit_ms_max": self.failover_first_commit_ms_max,
            "require_rejoin": self.require_rejoin,
            "attribution_coverage_min": self.attribution_coverage_min,
            "stitched_attribution_coverage_min":
                self.stitched_attribution_coverage_min,
            "blocked_peak_min": self.blocked_peak_min,
            "unblock_to_place_p99_ms_max": self.unblock_to_place_p99_ms_max,
            "storm_flatline_s_max": self.storm_flatline_s_max,
            "blocked_drain_frac_max": self.blocked_drain_frac_max,
            "unblock_batch_mean_min": self.unblock_batch_mean_min,
        }


class SLOGate:
    """Evaluate a replay result dict against thresholds.

    Expects the shape ``ChurnReplay.run`` produces:

    - ``trace_summary``: lifecycle ``summary()`` dict (``eval_ms_p99``,
      ``slowest_inflight_ms``, ...)
    - ``throughput_allocs_per_s``: allocs ever created / replay seconds
    - ``invariants``: the sweep dict (``lost``, ``duplicated``,
      ``orphaned``, ``converged``, ``violations`` list)
    """

    def __init__(self, thresholds: Optional[SLOThresholds] = None) -> None:
        self.thresholds = thresholds or SLOThresholds()

    def evaluate(self, result: Dict[str, object]) -> Dict[str, object]:
        th = self.thresholds
        summary = result.get("trace_summary") or {}
        inv = result.get("invariants") or {}
        checks: List[Dict[str, object]] = []

        def check(name: str, observed, bound, ok: Optional[bool]) -> None:
            checks.append({
                "name": name,
                "observed": observed,
                "bound": bound,
                "passed": ok,      # None == skipped (no bound configured)
            })

        p99 = summary.get("eval_ms_p99")
        if th.eval_ms_p99_max is None:
            check("eval_ms_p99", p99, None, None)
        else:
            check("eval_ms_p99", p99, th.eval_ms_p99_max,
                  p99 is not None and p99 <= th.eval_ms_p99_max)

        slowest = summary.get("slowest_inflight_ms")
        if th.slowest_inflight_ms_max is None:
            check("slowest_inflight_ms", slowest, None, None)
        else:
            # no in-flight work at read time reads as 0/None: that passes
            check("slowest_inflight_ms", slowest, th.slowest_inflight_ms_max,
                  slowest is None or slowest <= th.slowest_inflight_ms_max)

        tput = result.get("throughput_allocs_per_s")
        if th.throughput_min_allocs_per_s is None:
            check("placement_throughput", tput, None, None)
        else:
            check("placement_throughput", tput, th.throughput_min_allocs_per_s,
                  tput is not None and tput >= th.throughput_min_allocs_per_s)

        if th.require_zero_lost:
            lost = inv.get("lost")
            check("zero_lost_allocations", lost, 0, lost == 0)
        if th.require_zero_duplicated:
            dup = inv.get("duplicated")
            check("zero_duplicated_allocations", dup, 0, dup == 0)
        if th.require_converged:
            conv = inv.get("converged")
            check("converged", conv, True, bool(conv))

        fo = result.get("failover") or {}
        if th.failover_new_leader_ms_max is not None:
            v = fo.get("time_to_new_leader_ms")
            check("failover_time_to_new_leader_ms", v,
                  th.failover_new_leader_ms_max,
                  v is not None and v <= th.failover_new_leader_ms_max)
        if th.failover_first_commit_ms_max is not None:
            v = fo.get("time_to_first_commit_ms")
            check("failover_time_to_first_commit_ms", v,
                  th.failover_first_commit_ms_max,
                  v is not None and v <= th.failover_first_commit_ms_max)
        if th.require_rejoin:
            rejoined = fo.get("rejoined")
            check("killed_server_rejoined", rejoined, True, bool(rejoined))

        if th.attribution_coverage_min is not None:
            rep = result.get("bottleneck_report") or {}
            cov = rep.get("coverage")
            check("attribution_coverage", cov, th.attribution_coverage_min,
                  cov is not None and cov >= th.attribution_coverage_min)
        if th.stitched_attribution_coverage_min is not None:
            rep = (result.get("stitched") or {}).get("report") or {}
            cov = rep.get("coverage")
            check("stitched_attribution_coverage", cov,
                  th.stitched_attribution_coverage_min,
                  cov is not None
                  and cov >= th.stitched_attribution_coverage_min)

        cap = result.get("capacity") or {}
        if th.blocked_peak_min is not None:
            v = cap.get("peak_blocked")
            check("blocked_peak", v, th.blocked_peak_min,
                  v is not None and v >= th.blocked_peak_min)
        if th.unblock_to_place_p99_ms_max is not None:
            v = cap.get("unblock_to_place_ms_p99")
            check("unblock_to_place_ms_p99", v, th.unblock_to_place_p99_ms_max,
                  v is not None and v <= th.unblock_to_place_p99_ms_max)
        if th.storm_flatline_s_max is not None:
            v = cap.get("max_flatline_s_while_blocked")
            check("storm_flatline_s", v, th.storm_flatline_s_max,
                  v is not None and v <= th.storm_flatline_s_max)
        if th.blocked_drain_frac_max is not None:
            # final blocked depth as a fraction of peak; None peak means
            # the run never saturated, which blocked_peak_min calls out —
            # an unsaturated run trivially drained
            v = cap.get("blocked_drain_frac")
            check("blocked_drain_frac", v, th.blocked_drain_frac_max,
                  v is None or v <= th.blocked_drain_frac_max)
        if th.unblock_batch_mean_min is not None:
            v = cap.get("unblock_batch_size_mean")
            check("unblock_batch_size_mean", v, th.unblock_batch_mean_min,
                  v is not None and v >= th.unblock_batch_mean_min)

        passed = all(c["passed"] is not False for c in checks)
        return {
            "passed": passed,
            "checks": checks,
            "thresholds": th.to_dict(),
        }
