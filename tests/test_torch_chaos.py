"""The port's churn and chaos layers against the JAX package's, on the
same seeded inputs: the chaos trace generator, the SLO gate, the
critical-path attribution and the span stitcher, the invariant sweep,
the static lock-order / shared-state graphs the witness gates read, the
RPC codec, ``DeviceBatcher.wait_warm``; then the port's ChurnReplay on
the CPU (a leader kill mid-replay, and the lock and race witnesses
armed). Every comparison is exact: none of these functions has a
floating-point divergence between the packages.

Every replay test tears down through the ``replays`` fixture: the injector
and both witnesses disarmed, the lifecycle / capacity / xtrace rings and
the RPC table reset, every server of the replay stopped, on failure too.
"""
import logging
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu import mock as jmock
from nomad_tpu.analysis import lock_order as jlock
from nomad_tpu.analysis import shared_state as jshared
from nomad_tpu.analysis.core import run_source as j_run_source
from nomad_tpu.chaos import slo as jslo
from nomad_tpu.chaos import trace as jtrace
from nomad_tpu.chaos.replay import invariant_sweep_allocs as j_sweep
from nomad_tpu.rpc import codec as jcodec
from nomad_tpu.structs import structs as jstructs
from nomad_tpu.trace import attribution as jattr
from nomad_tpu.trace import stitch as jstitch
from nomad_tpu_torch import chaos as tchaos
from nomad_tpu_torch.analysis import lock_order as tlock
from nomad_tpu_torch.analysis import shared_state as tshared
from nomad_tpu_torch.analysis.core import run_source as t_run_source
from nomad_tpu_torch.chaos import slo as tslo
from nomad_tpu_torch.chaos import trace as ttrace
from nomad_tpu_torch.chaos.replay import ChurnReplay
from nomad_tpu_torch.chaos.replay import invariant_sweep_allocs as t_sweep
from nomad_tpu_torch.rpc import codec as tcodec
from nomad_tpu_torch.rpc import transport as ttransport
from nomad_tpu_torch.server import ServerConfig
from nomad_tpu_torch.structs import structs as tstructs
from nomad_tpu_torch.trace import attribution as tattr
from nomad_tpu_torch.trace import capacity as tcapacity
from nomad_tpu_torch.trace import context as txtrace
from nomad_tpu_torch.trace import lifecycle as tlifecycle
from nomad_tpu_torch.trace import stitch as tstitch
from nomad_tpu_torch.utils import lock_witness as tlw
from nomad_tpu_torch.utils import race_witness as trw

# ---------------------------------------------------------------------------
# the chaos trace: both packages replay the same events
# ---------------------------------------------------------------------------

TRACE_KWARGS = {
    # bench.py:1171 chaos-churn-5K
    "churn5k": dict(duration_s=30.0, n_nodes=250, n_jobs=60, tg_count=50, stop_frac=0.3,
                    rollout_frac=0.25, n_drains=3, n_expiries=2, n_hipri=2,
                    n_fault_windows=4, canary_frac=0.25, n_preempt_waves=1,
                    leader_kill=True),
    # tests/test_chaos.py: determinism, leader kill, witness replays
    "test_default": dict(duration_s=20.0, n_nodes=50, n_jobs=12),
    "test_leader_kill": dict(duration_s=6.0, n_nodes=16, n_jobs=5, tg_count=4, stop_frac=0.2,
                             rollout_frac=0.2, n_drains=1, n_expiries=1, n_hipri=1,
                             n_fault_windows=2, leader_kill=True),
    "test_witness": dict(duration_s=3.0, n_nodes=12, n_jobs=3, tg_count=3, stop_frac=0.2,
                         rollout_frac=0.2, n_drains=1, n_expiries=1, n_hipri=1,
                         n_fault_windows=2),
    # tests/test_chaos.py saturation waves, bench.py:1392 capacity storm
    "saturate": dict(duration_s=20.0, n_nodes=50, n_jobs=12, leader_kill=False,
                     n_saturate_waves=2, saturate_jobs=5, release_nodes=9),
    "capacity": dict(duration_s=30.0, n_nodes=60, n_jobs=35, tg_count=40, stop_frac=0.2,
                     rollout_frac=0.15, n_drains=2, n_expiries=2, n_hipri=1,
                     n_fault_windows=0, leader_kill=True, cpu=250, memory_mb=128,
                     n_saturate_waves=2, saturate_jobs=15, release_nodes=30),
}


@pytest.mark.parametrize("seed", [0, 5, 11, 42])
@pytest.mark.parametrize("kw", sorted(TRACE_KWARGS))
def test_generate_trace_equals_reference(kw, seed):
    t = ttrace.generate_trace(seed=seed, **TRACE_KWARGS[kw])
    j = jtrace.generate_trace(seed=seed, **TRACE_KWARGS[kw])
    assert t, "empty trace"
    assert ttrace.trace_to_jsonable(t) == jtrace.trace_to_jsonable(j)
    assert ttrace.trace_kind_counts(t) == jtrace.trace_kind_counts(j)


def test_chaos_package_lazy_exports():
    """The reference's lazy exports, the crash harness's included."""
    from nomad_tpu import chaos as jchaos
    from nomad_tpu_torch.chaos import crash as tcrash

    assert tchaos.generate_trace is ttrace.generate_trace
    assert tchaos.ChurnReplay is ChurnReplay
    assert tchaos.SLOGate is tslo.SLOGate
    assert tchaos.invariant_sweep_allocs is t_sweep
    assert tchaos.CrashReplay is tcrash.CrashReplay
    assert tchaos.ServerProcess is tcrash.ServerProcess
    assert issubclass(tchaos.CrashReplay, ChurnReplay)
    for name in ("ChaosEvent", "trace_kind_counts", "trace_to_jsonable", "invariant_sweep",
                 "SLOThresholds"):
        assert getattr(tchaos, name) is not None
    assert sorted(tchaos.__all__) == sorted(jchaos.__all__)
    with pytest.raises(AttributeError):
        tchaos.NoSuchExport  # noqa: B018


# ---------------------------------------------------------------------------
# the SLO gate
# ---------------------------------------------------------------------------

_THRESHOLDS = {
    "defaults": {},
    "churn5k": dict(eval_ms_p99_max=5_000.0, slowest_inflight_ms_max=30_000.0,
                    throughput_min_allocs_per_s=25.0, attribution_coverage_min=0.9),
    "all": dict(eval_ms_p99_max=100.0, slowest_inflight_ms_max=1_000.0,
                throughput_min_allocs_per_s=50.0, failover_new_leader_ms_max=500.0,
                failover_first_commit_ms_max=900.0, require_rejoin=True,
                attribution_coverage_min=0.9, stitched_attribution_coverage_min=0.8,
                blocked_peak_min=5, unblock_to_place_p99_ms_max=300.0,
                storm_flatline_s_max=2.0, blocked_drain_frac_max=0.1,
                unblock_batch_mean_min=2.0),
    "skipped": dict(eval_ms_p99_max=None, slowest_inflight_ms_max=None,
                    throughput_min_allocs_per_s=None, require_zero_lost=False,
                    require_zero_duplicated=False, require_converged=False),
}


def _slo_result(good: bool):
    """A ChurnReplay-shaped result whose every gated value sits on the
    passing (``good``) or failing side of the ``all`` thresholds."""
    pick = (lambda ok, bad: ok) if good else (lambda ok, bad: bad)
    return {
        "trace_summary": {"eval_ms_p99": pick(40.0, 6_000.0),
                          "slowest_inflight_ms": pick(None, 40_000.0)},
        "throughput_allocs_per_s": pick(120.5, 3.0),
        "invariants": {"lost": pick(0, 2), "duplicated": pick(0, 1), "orphaned": 0,
                       "converged": pick(True, False), "violations": []},
        "failover": {"time_to_new_leader_ms": pick(120.0, 800.0),
                     "time_to_first_commit_ms": pick(300.0, 1500.0),
                     "rejoined": pick(True, False)},
        "bottleneck_report": {"coverage": pick(0.97, 0.5)},
        "stitched": {"report": {"coverage": pick(0.95, 0.2)}},
        "capacity": {"peak_blocked": pick(12, 1), "unblock_to_place_ms_p99": pick(40.0, 900.0),
                     "max_flatline_s_while_blocked": pick(0.5, 9.0),
                     "blocked_drain_frac": pick(0.0, 0.5),
                     "unblock_batch_size_mean": pick(3.5, 1.0)},
    }


@pytest.mark.parametrize("result", ["good", "bad", "empty"])
@pytest.mark.parametrize("th", sorted(_THRESHOLDS))
def test_slo_gate_equals_reference(th, result):
    res = {"good": _slo_result(True), "bad": _slo_result(False), "empty": {}}[result]
    t = tslo.SLOGate(tslo.SLOThresholds(**_THRESHOLDS[th])).evaluate(res)
    j = jslo.SLOGate(jslo.SLOThresholds(**_THRESHOLDS[th])).evaluate(res)
    assert t == j
    if th == "all" and result != "empty":
        # every check of the gate runs, and reads the planted side
        assert len(t["checks"]) == 16
        assert {c["passed"] for c in t["checks"]} == {result == "good"}


# ---------------------------------------------------------------------------
# critical-path attribution (tests/test_flight.py's synthetic span sets)
# ---------------------------------------------------------------------------


def _rec(eval_id="e1", **stamps):
    base = {
        "eval_id": eval_id, "type": "service", "attempt": 1,
        "path": "device", "outcome": stamps.pop("outcome", "ack"),
        "enqueue_t": None, "dequeue_t": None, "invoke_start_t": None,
        "invoke_end_t": None, "submit_t": None, "apply_t": None,
        "end_t": None,
    }
    base.update(stamps)
    return base


_SYNTH_RECORDS = [
    _rec("e1", enqueue_t=0.0, dequeue_t=1.0, invoke_start_t=1.0,
         invoke_end_t=6.0, submit_t=6.0, apply_t=8.0, end_t=8.5),
    _rec("e2", enqueue_t=8.5, dequeue_t=9.0, invoke_start_t=9.0,
         invoke_end_t=10.0, submit_t=10.0, apply_t=10.0, end_t=10.0),
    _rec("e3", enqueue_t=9.0, dequeue_t=9.2, invoke_start_t=9.2,
         invoke_end_t=9.4, end_t=9.4, outcome="nack"),
]
_SYNTH_SPANS = [
    ("encode", "w1", 1.0, 2.0),
    ("dispatch", "w1", 2.0, 5.0),
    ("wait_min_index", "e1", 6.5, 7.5),
]
_TWO_WAVES = [
    _rec("a", enqueue_t=0.0, dequeue_t=0.5, invoke_start_t=0.5, invoke_end_t=1.0, end_t=1.0),
    _rec("b", enqueue_t=9.0, dequeue_t=9.5, invoke_start_t=9.5, invoke_end_t=10.0, end_t=10.0),
]
_HOLE = [_rec("gap", enqueue_t=0.0, dequeue_t=0.1, invoke_start_t=0.2, invoke_end_t=0.5,
              submit_t=9.5, apply_t=9.8, end_t=10.0)]

ATTRIBUTION_CASES = {
    "synthetic": (_SYNTH_RECORDS, _SYNTH_SPANS, 10.0),
    "synthetic_reversed": (list(reversed(_SYNTH_RECORDS)), list(reversed(_SYNTH_SPANS)), 10.0),
    "tie": ([_rec("t", enqueue_t=0.0, dequeue_t=1.0, invoke_start_t=1.0, invoke_end_t=2.0,
                  end_t=2.0)], [], 2.0),
    "coverage_hole": (_HOLE, [], 10.0),
    "broker_idle": (_TWO_WAVES, [], 10.0),
    "idle_span": (_TWO_WAVES, [("idle", "worker-0", 1.0, 5.0)], 10.0),
    "idle_in_hole": (_HOLE, [("idle", "worker-0", 0.5, 1.5)], 10.0),
    "empty": ([], [], 0.0),
    "inflight": ([_rec("open", enqueue_t=0.0, dequeue_t=1.0, invoke_start_t=1.0)], [], 4.0),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_attribution_equals_reference(case):
    recs, spans, now = ATTRIBUTION_CASES[case]
    assert tattr.critical_path(recs, spans, now=now) == jattr.critical_path(recs, spans, now=now)
    t = tattr.bottleneck_report(recs, spans, now=now)
    assert t == jattr.bottleneck_report(recs, spans, now=now)
    for top_n in (1, 2, 5):
        assert tattr.format_report(t, top_n=top_n) == jattr.format_report(t, top_n=top_n)
    if case == "synthetic":
        assert t["top"] == "dispatch: 30% of makespan" and t["coverage_ok"]


# ---------------------------------------------------------------------------
# stitching (tests/test_xtrace.py's three-process spans, a planted skew)
# ---------------------------------------------------------------------------


def _mk(name, proc, sid, parent, a, b, kind="internal", trace="t1", attrs=None):
    return {"trace_id": trace, "span_id": sid, "parent_id": parent,
            "name": name, "kind": kind, "process": proc,
            "start": a, "end": b, "attrs": attrs or {}}


def _three_process_spans(skew=0.0):
    """driver -> s0 (forward) -> s1, with s1's clock shifted by skew."""
    return [
        _mk("event.submit", "driver", "d1", None, 0.0, 1.0),
        _mk("rpc.client.Job.Register", "driver", "c1", "d1", 0.1, 0.9, kind="client"),
        _mk("rpc.server.Job.Register", "s0", "s1span", "c1", 0.15, 0.85, kind="server"),
        _mk("rpc.client.Job.Register", "s0", "c2", "s1span", 0.2, 0.8, kind="client"),
        _mk("rpc.server.Job.Register", "s1", "s2span", "c2", 0.3 + skew, 0.7 + skew,
            kind="server"),
    ]


@pytest.mark.parametrize("skew", [0.0, 5.0, -2.5])
def test_stitch_equals_reference(skew):
    spans = _three_process_spans(skew)
    shuffled = list(spans)
    random.Random(7).shuffle(shuffled)
    for sets in ([spans, shuffled], [shuffled, spans]):
        assert tstitch.merge_spans(sets) == jstitch.merge_spans(sets)
    t, j = tstitch.stitch([spans]), jstitch.stitch([spans])
    assert t == j
    assert abs(t["clock_offsets_ms"]["s1"] - skew * 1000.0) < 1.0
    for tr in t["traces"]:
        assert tstitch.format_tree(tr) == jstitch.format_tree(tr)
    # the middle process lost: an orphan, a partial tree
    survivors = [s for s in spans if s["process"] != "s0"]
    t, j = tstitch.stitch([survivors]), jstitch.stitch([survivors])
    assert t == j and t["traces"][0]["orphans"] == 1
    assert tstitch.format_tree(t["traces"][0]) == jstitch.format_tree(j["traces"][0])
    # a parent-pointer cycle degrades, never raises
    cyc = [_mk("a", "p", "x", "y", 0.0, 1.0), _mk("b", "p", "y", "x", 0.0, 1.0)]
    assert tstitch.build_trees(cyc) == jstitch.build_trees(cyc)
    assert tstitch.build_trees(spans) == jstitch.build_trees(spans)


STITCHED_CASES = {
    "wire": _three_process_spans() + [
        _mk("eval.queue_wait", "s1", "q1", None, 1.0, 2.0),
        _mk("eval.wait_min_index", "s1", "w1", None, 2.0, 2.5, attrs={"role": "follower"}),
        _mk("eval.invoke", "s1", "i1", None, 2.5, 4.0),
    ],
    "unmatched_client": [_mk("rpc.client.Node.Heartbeat", "driver", "c1", None, 0.0, 1.0,
                             kind="client")],
    "empty": [],
    "hole": [_mk("eval.invoke", "p", "a", None, 0.0, 1.0),
             _mk("eval.invoke", "p", "b", None, 99.0, 100.0)],
}


@pytest.mark.parametrize("case", sorted(STITCHED_CASES))
def test_stitched_report_equals_reference(case):
    spans = STITCHED_CASES[case]
    t = tattr.stitched_report(spans)
    assert t == jattr.stitched_report(spans)
    assert tattr.format_report(t) == jattr.format_report(t)


# ---------------------------------------------------------------------------
# the invariant sweep
# ---------------------------------------------------------------------------


def _alloc_lists(seed: int):
    """The same alloc list in both packages, with the expected counts and
    stopped set: lost slots, duplicated ids and slots, orphans."""
    rng = np.random.default_rng(seed)
    jobs = [f"job-{i}" for i in range(6)]
    rows = []
    for _ in range(int(rng.integers(20, 60))):
        job = jobs[int(rng.integers(len(jobs)))]
        rows.append(dict(id=f"a-{int(rng.integers(0, 80))}", namespace="default", job_id=job,
                         name=f"{job}.web[{int(rng.integers(0, 5))}]",
                         desired_status=("run", "stop", "evict")[int(rng.integers(3))]))
    expected = {("default", j): int(rng.integers(0, 6)) for j in jobs[:4]}
    stopped = {("default", j) for j in jobs[4:]}
    return ([tstructs.Allocation(**r) for r in rows], [jstructs.Allocation(**r) for r in rows],
            expected, stopped)


@pytest.mark.parametrize("seed", range(6))
def test_invariant_sweep_allocs_equals_reference(seed):
    t_allocs, j_allocs, expected, stopped = _alloc_lists(seed)
    t = t_sweep(t_allocs, expected, stopped)
    assert t == j_sweep(j_allocs, expected, stopped)
    assert t["lost"] + t["duplicated"] + t["orphaned"] > 0, "the case plants no violation"


def test_invariant_sweep_clean_equals_reference():
    rows = [dict(id=f"a{i}", job_id="j", name=f"j.web[{i}]") for i in range(3)]
    expected, stopped = {("default", "j"): 3}, {("default", "gone")}
    t = t_sweep([tstructs.Allocation(**r) for r in rows], expected, stopped)
    assert t == j_sweep([jstructs.Allocation(**r) for r in rows], expected, stopped)
    assert t["converged"] and not t["violations"]


# ---------------------------------------------------------------------------
# the static lock-order and shared-state graphs
# ---------------------------------------------------------------------------

_SYNTH_PKG = {
    "__init__.py": "",
    "utils/__init__.py": "",
    "utils/lock_witness.py": '''
import threading


def witness_lock(name):
    return threading.Lock()
''',
    "store.py": '''
import threading


class Store:
    def __init__(self):
        self._mu = threading.Lock()
        self.items = []
        self.hits = 0

    def put(self, v):
        with self._mu:
            self.items.append(v)

    def touch(self):
        self.hits += 1
''',
    "broker.py": '''
import threading

from .store import Store
from .utils.lock_witness import witness_lock


class Broker:
    def __init__(self):
        self._lock = witness_lock("broker.Broker._lock")
        self._cond = threading.Condition(self._lock)
        self.store = Store()
        self.ready = {}
        self.count = 0
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        with self._lock:
            self.store.put(1)
            self.ready["x"] = 1
        self.store.touch()

    def enqueue(self, k):
        with self._lock:
            self.ready[k] = 1
            self._cond.notify_all()
        self.count += 1
''',
    "pool.py": '''
import threading

from PKG.broker import Broker
from PKG.store import Store

_glock = threading.Lock()


def worker(b):
    with _glock:
        b.enqueue("y")
    b.store.touch()


def reverse(s: Store, b: Broker):
    with s._mu:
        with _glock:
            b.count = 2


def start(b):
    for _ in range(3):
        threading.Thread(target=worker, args=(b,)).start()
    threading.Thread(target=reverse, args=(b.store, b)).start()
''',
}


def _write_pkg(root, name):
    for rel, src in _SYNTH_PKG.items():
        path = root / name / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src.replace("PKG", name))
    return str(root / name)


def test_static_graphs_equal_reference_on_a_synthetic_package(tmp_path):
    """The same package written once as ``nomad_tpu`` and once as
    ``nomad_tpu_torch``: each analyser keys modules on its own package,
    so the two edge sets and shared sets are equal."""
    jroot, troot = _write_pkg(tmp_path, "nomad_tpu"), _write_pkg(tmp_path, "nomad_tpu_torch")
    t_edges, j_edges = tlock.build_static_graph(troot), jlock.build_static_graph(jroot)
    assert t_edges == j_edges
    assert ("store.Store._mu", "pool._glock") in t_edges, t_edges
    t_shared, j_shared = tshared.build_static_shared(troot), jshared.build_static_shared(jroot)
    assert t_shared == j_shared
    assert "broker.Broker.ready" in t_shared, t_shared


def test_static_graphs_default_to_the_port():
    """With no root, the port's analysers read the port's own tree."""
    port_root = str(Path(tlock.__file__).resolve().parent.parent)
    assert Path(port_root).name == "nomad_tpu_torch"
    edges, shared = tlock.build_static_graph(), tshared.build_static_shared()
    assert edges and shared
    assert tlock._STATIC_CACHE[port_root] is edges
    assert tshared._STATIC_CACHE[port_root] is shared
    assert any(a == "blocked_evals.BlockedEvals._lock" for a, _ in edges), sorted(edges)[:20]


_LINT_SOURCES = {
    "lock_cycle": '''
import threading


class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._b:
            with self._a:
                pass
''',
    "bare_wait": '''
import threading


class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.items = []

    def get(self):
        with self._cond:
            if not self.items:
                self._cond.wait()
            return self.items.pop()

    def put(self, x):
        self.items.append(x)
        self._cond.notify()
''',
    "unguarded_shared": '''
import threading


class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
        self.seen = 0  # guarded-by: _lock

    def start(self):
        for _ in range(2):
            threading.Thread(target=self.bump).start()

    def bump(self):
        self.n += 1
        self.seen += 1
''',
}


@pytest.mark.parametrize("case", sorted(_LINT_SOURCES))
def test_concurrency_rules_equal_reference(case):
    """The three ported rules give the reference's findings on the same
    source (the reference runs only its three concurrency rules too)."""
    from nomad_tpu.analysis.condition_discipline import ConditionDisciplineChecker as JCond
    from nomad_tpu.analysis.lock_order import LockOrderChecker as JLock
    from nomad_tpu.analysis.shared_state import SharedStateDisciplineChecker as JShared
    from nomad_tpu_torch.analysis.core import default_checkers

    analysis = jlock.WholeProgramLockAnalysis()
    j_checkers = [JLock(analysis=analysis), JCond(analysis=analysis),
                  JShared(analysis=analysis)]
    src = _LINT_SOURCES[case]
    t = t_run_source(src, "pkg/mod.py", checkers=default_checkers())
    j = j_run_source(src, "pkg/mod.py", checkers=j_checkers)
    assert [f.render() for f in t] == [f.render() for f in j]
    assert t, "the case plants no finding"


# ---------------------------------------------------------------------------
# the RPC codec, wait_warm
# ---------------------------------------------------------------------------


def _codec_payloads():
    node, job, ev = jmock.node(), jmock.job(), jmock.eval()
    alloc = jmock.alloc()
    return {
        "node": node, "job": job, "eval": ev, "alloc": alloc,
        "envelope": {"seq": 3, "method": "Node.Register", "body": (node,),
                     "trace": {"trace_id": "t", "span_id": "s"}},
        "containers": {("default", "j1"): {1, 2}, "tuple": (1, "a", None), "list": [ev]},
    }


@pytest.mark.parametrize("what", sorted(_codec_payloads()))
def test_codec_round_trips_equal_to_reference(what):
    obj = _codec_payloads()[what]
    wire = jcodec.encode(obj)
    ported = tcodec.decode(wire)
    assert tcodec.encode(ported) == wire
    assert jcodec.decode(tcodec.encode(ported)) == obj
    if what in ("node", "job", "eval", "alloc"):
        assert type(ported).__module__ == "nomad_tpu_torch.structs.structs"


def test_wait_warm_returns_at_once():
    from nomad_tpu_torch.tpu.batcher import DeviceBatcher

    b = DeviceBatcher(device="cpu")
    before = threading.active_count()
    t0 = time.perf_counter()
    assert b.wait_warm() is None
    assert b.wait_warm(timeout=120) is None
    assert time.perf_counter() - t0 < 0.05
    assert threading.active_count() == before and b._thread is None


# ---------------------------------------------------------------------------
# the port's ChurnReplay on the CPU
# ---------------------------------------------------------------------------


def _nothing_armed() -> bool:
    return tchaos.active() is None and tlw.active() is None and trw.active() is None


@pytest.fixture
def replays():
    """Replays a test starts; afterwards (on failure too) every server is
    stopped, the injector and both witnesses disarmed, and the process
    rings and the RPC table reset, so nothing leaks into the next file
    on the worker."""
    made = []
    try:
        yield made
    finally:
        for r in made:
            for s in r.servers:
                try:
                    s.stop()
                except Exception:  # noqa: BLE001 — stopped already
                    pass
        inj = tchaos.active()
        if inj is not None:
            inj.disarm_all()
        trw.disarm()
        tlw.disarm()
        tlifecycle.reset()
        tcapacity.reset()
        txtrace.reset()
        ttransport.reset_rpc_stats()
    assert _nothing_armed()


def _config(**kw):
    # the reference tests' cluster (tests/test_chaos.py), on the CPU, with
    # every eval through the batcher (device_min_placements=0)
    return ServerConfig(device="cpu", num_schedulers=2, heartbeat_min_ttl=1.2,
                        heartbeat_max_ttl=2.0, heartbeat_grace=0.0, eval_gc_interval=3600.0,
                        device_min_placements=0, **kw)


def _assert_invariants(result):
    inv = result["invariants"]
    assert inv["lost"] == 0, inv["violations"]
    assert inv["duplicated"] == 0, inv["violations"]
    assert inv["orphaned"] == 0, inv["violations"]
    assert inv["converged"], inv["violations"]


def test_leader_kill_mid_replay_zero_lost_allocs(replays):
    """tests/test_chaos.py's leader-kill replay (seed 5, 16 nodes, three
    servers) against the port's servers on the CPU, every eval through
    a batcher."""
    trace = ttrace.generate_trace(seed=5, **TRACE_KWARGS["test_leader_kill"])
    replay = ChurnReplay(seed=5, trace=trace, n_servers=3, n_nodes=16, config=_config(),
                         settle_timeout_s=25.0)
    replays.append(replay)
    result = replay.run()
    assert _nothing_armed(), "replay must disarm its injector"
    assert result["leader_kills"] == 1
    _assert_invariants(result)
    dispatches = {s.name: s.device_batcher.stats_snapshot()["dispatches"] for s in replay.servers}
    assert max(dispatches.values()) > 0, dispatches
    verdict = tslo.SLOGate(tslo.SLOThresholds(
        eval_ms_p99_max=None, slowest_inflight_ms_max=None,
        throughput_min_allocs_per_s=None)).evaluate(result)
    assert verdict["passed"], verdict["checks"]
    rep = result["bottleneck_report"]
    assert rep["entries"] and rep["makespan_s"] > 0, rep
    assert result["stitched"]["processes"] == ["chaos-driver"]
    assert result["rpc"] == {"cluster": {}, "replicas": {}}


def test_witness_armed_churn_replay_sound_and_inversion_free(replays):
    """The lock witness armed for a whole replay: no order violation, and
    every witnessed edge in the port's static graph."""
    trace = ttrace.generate_trace(seed=11, **TRACE_KWARGS["test_witness"])
    replay = ChurnReplay(seed=11, trace=trace, n_servers=2, n_nodes=12, config=_config(),
                         settle_timeout_s=25.0, lock_witness=True)
    replays.append(replay)
    result = replay.run()
    assert tlw.active() is None, "replay must disarm its witness"
    lw = result["lock_witness"]
    assert lw["armed"] == 1
    assert lw["violations"] == 0
    assert lw["edges"] > 0, lw
    assert lw["missing_from_static"] == [], lw["missing_from_static"]
    inv = result["invariants"]
    assert inv["lost"] == 0, inv["violations"]
    assert inv["converged"], inv["violations"]


def test_race_witness_armed_churn_replay_race_free_and_sound(replays):
    """The Eraser lockset witness armed for a whole replay: no tracked
    field's candidate lockset empties (the server's stats sweep reads
    the batcher's table through ``stats_snapshot``, under its lock), and
    every field seen shared is in the port's static shared set."""
    trace = ttrace.generate_trace(seed=13, **TRACE_KWARGS["test_witness"])
    replay = ChurnReplay(seed=13, trace=trace, n_servers=2, n_nodes=12, config=_config(),
                         settle_timeout_s=25.0, race_witness=True)
    replays.append(replay)
    result = replay.run()
    assert trw.active() is None and tlw.active() is None
    rw = result["race_witness"]
    assert rw["armed"] == 1
    assert rw["violations"] == 0
    assert rw["shared_fields"] > 0, rw
    assert rw["missing_from_static"] == [], rw["missing_from_static"]
    _assert_invariants(result)


def test_replay_that_fails_halfway_leaves_nothing_armed(replays, monkeypatch):
    """An event that raises past the retries (a harness fault, not chaos)
    ends the run; its ``finally`` still disarms the injector and the
    witness and stops every server."""
    trace = ttrace.generate_trace(seed=3, **TRACE_KWARGS["test_witness"])
    replay = ChurnReplay(seed=3, trace=trace, n_servers=2, n_nodes=6, config=_config(),
                         settle_timeout_s=5.0, lock_witness=True)
    replays.append(replay)
    calls = []

    def boom(ev):
        calls.append(ev.kind)
        if ev.kind == "arm_fault":
            orig(ev)
            raise ZeroDivisionError("harness fault")
        return orig(ev)

    orig = replay._apply_event
    monkeypatch.setattr(replay, "_apply_event", boom)
    with pytest.raises(ZeroDivisionError):
        replay.run()
    assert "arm_fault" in calls
    assert _nothing_armed()
    assert not any(t.name == "chaos-heartbeat-pump" and t.is_alive()
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# what the churn needed from the server: TTLs without a thread a heartbeat,
# followers' planners that wait instead of spinning
# ---------------------------------------------------------------------------


def _ttl_run(server_cls, config_cls, mock_mod):
    srv = server_cls(config_cls(**_TTL_CONFIG), name="ttl")
    srv.start()
    try:
        beating, silent = mock_mod.node(), mock_mod.node()
        srv.register_node(beating)
        srv.register_node(silent)
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            srv.heartbeat(beating.id)
            time.sleep(0.05)
        status = {name: srv.fsm.state.node_by_id(n.id).status
                  for name, n in (("beating", beating), ("silent", silent))}
        reapers = [t for t in threading.enumerate() if t.name == "heartbeat-reaper"]
        return status, srv.heartbeaters.num_active(), reapers
    finally:
        srv.stop()


_TTL_CONFIG = dict(num_schedulers=0, heartbeat_min_ttl=0.3, heartbeat_max_ttl=0.4,
                   eval_gc_interval=3600.0)


def test_heartbeat_ttls_expire_as_the_reference_does():
    """A node that heartbeats stays ready and a silent one goes down, in
    the port (one reaper thread over a deadline table) as in the JAX
    server (a timer thread per heartbeat)."""
    from nomad_tpu.server import Server as JServer
    from nomad_tpu.server import ServerConfig as JServerConfig
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.server import Server as TServer

    # the reference's timing: no grace past the TTL (the port's default
    # is Nomad's 10 s; tests/test_torch_crash.py holds it)
    t_status, t_active, reapers = _ttl_run(
        TServer, lambda **kw: ServerConfig(device="cpu", heartbeat_grace=0.0, **kw), tmock)
    j_status, j_active, _ = _ttl_run(JServer, JServerConfig, jmock)
    assert t_status == j_status == {"beating": "ready", "silent": "down"}
    assert t_active == j_active == 1
    assert len(reapers) == 1
    time.sleep(0.1)
    assert not any(t.name == "heartbeat-reaper" and t.is_alive()
                   for t in threading.enumerate()), "the reaper outlived its server"


def test_disabled_plan_queue_waits_out_its_timeout():
    """A follower's plan queue (disabled) holds its planner for the
    poll's timeout instead of returning at once, and enabling it wakes
    a waiting dequeue."""
    from nomad_tpu_torch.server.plan_apply import PlanQueue

    q = PlanQueue()
    t0 = time.monotonic()
    assert q.dequeue(timeout=0.2) is None
    assert time.monotonic() - t0 >= 0.15
    assert q.dequeue() is None   # no timeout: returns at once, as before
    got = []
    waiter = threading.Thread(target=lambda: got.append(q.dequeue(timeout=5.0)))
    waiter.start()
    time.sleep(0.05)
    q.set_enabled(True)
    pending = q.enqueue(tstructs.Plan(eval_id="e1", priority=50))
    waiter.join(timeout=2.0)
    assert not waiter.is_alive() and got == [pending]


def _promoted_canary_case(pkg_mock, structs, reconcile_mod, old_indexes):
    """A job of 4 whose canaried rollout (2 canaries, web[0] and web[1])
    was promoted, with the old version's allocs at ``old_indexes``: the
    reconciler's results as the names the group would end with."""
    from nomad_tpu_torch.scheduler.reconcile_util import alloc_name

    job = pkg_mock.job()
    job.id = "canaried"
    tg = job.task_groups[0]
    tg.count = 4
    tg.update = structs.UpdateStrategy(canary=2, max_parallel=4)
    job.version = 1
    old_job = pkg_mock.job()
    old_job.id, old_job.version = job.id, 0
    d = reconcile_mod.new_deployment(job)
    d.id = "d1"

    def alloc(idx, version_job, aid):
        a = pkg_mock.alloc()
        a.id, a.job, a.job_id, a.node_id = aid, version_job, job.id, f"n{aid}"
        a.name, a.task_group = alloc_name(job.id, tg.name, idx), tg.name
        return a

    canaries = [alloc(i, job, f"c{i}") for i in (0, 1)]
    for a in canaries:
        a.deployment_id = d.id
        a.deployment_status = structs.AllocDeploymentStatus(healthy=True, canary=False)
    d.task_groups[tg.name] = structs.DeploymentState(
        promoted=True, desired_canaries=2, desired_total=4, placed_canaries=["c0", "c1"],
        placed_allocs=2, healthy_allocs=2)
    old = [alloc(i, old_job, f"o{i}") for i in old_indexes]

    def update_fn(existing, new_job, new_tg):
        if existing.job.version == new_job.version:
            return True, False, None
        return False, True, None

    r = reconcile_mod.AllocReconciler(
        logging.getLogger("nomad_tpu_torch.test"), update_fn, False, job.id, job, d,
        canaries + old, {}, "eval-1").compute()
    stopped = {s.alloc.id for s in r.stop}
    replaced = {u.stop_alloc.id for u in r.destructive_update}
    names = [a.name for a in canaries + old if a.id not in stopped | replaced]
    names += [u.place_name for u in r.destructive_update] + [p.name for p in r.place]
    return sorted(names), sorted(stopped)


@pytest.mark.parametrize("old_indexes", [(0, 1, 2, 3), (0, 1, 3)], ids=["all_old", "one_preempted"])
def test_promoted_canaries_replace_every_old_alloc_of_their_names(old_indexes):
    """After promotion every old alloc that shares a canary's name is
    stopped and the group ends with each name once. With all old allocs
    present the port's results equal the JAX reconciler's; with one old
    alloc preempted before promotion the reference stops only one of the
    two name-sharing old allocs, and its destructive update re-places the
    other's name beside the canary (a doubled slot, the churn replay's
    `duplicated` violation)."""
    from nomad_tpu.scheduler import reconcile as jreconcile
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.scheduler import reconcile as treconcile

    t_names, t_stopped = _promoted_canary_case(tmock, tstructs, treconcile, old_indexes)
    j_names, j_stopped = _promoted_canary_case(jmock, jstructs, jreconcile, old_indexes)
    want = sorted(f"canaried.web[{i}]" for i in range(4))
    assert t_names == want
    assert t_stopped == ["o0", "o1"]
    if old_indexes == (0, 1, 2, 3):
        assert (t_names, t_stopped) == (j_names, j_stopped)
    else:
        assert len(j_names) == 4 and len(set(j_names)) == 3, j_names
