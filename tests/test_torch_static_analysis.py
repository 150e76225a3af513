"""nomad-lint of the PyTorch port (nomad_tpu_torch/analysis): the port's
invariants, enforced in tier-1.

The port of ``tests/test_static_analysis.py``'s lint cases (its engine
single-flight cases test the JAX engine, not the lint, and stay there),
with every path under ``nomad_tpu_torch/``:

  1. The whole-tree gate: the port's tool, ``python -m
     nomad_tpu_torch.analysis``, run once over ``nomad_tpu_torch/``,
     reports zero findings beyond the shipped (empty) baseline.
  2. Fixture units per checker: a positive (the bug-shaped pattern) and a
     negative (the fixed shape) per rule, plus suppression/baseline
     mechanics.
  3. One case per rule: a corpus of snippets (every fixture the reference
     tests lint) through the reference's ``run_source`` (paths under
     ``nomad_tpu_torch/``) and the port's (paths under ``nomad_tpu_torch/``)
     gives the same findings, as (rule, line, message).
"""
import json
import os
import textwrap
import threading
import time

import pytest

from nomad_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    load_baseline,
    run_paths,
    run_source,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO_ROOT, "nomad_tpu_torch")
BASELINE = os.path.join(PKG, "analysis", "baseline.json")


def dedent(s: str) -> str:
    return textwrap.dedent(s).lstrip("\n")


# ---------------------------------------------------------------------------
# 1. the tree gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree_run():
    """The port's tool over the port, run once for the module:
    ``python -m nomad_tpu_torch.analysis nomad_tpu_torch --json``."""
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.analysis", "nomad_tpu_torch", "--json"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
    )


def test_tree_is_clean_modulo_baseline(tree_run):
    """`python -m nomad_tpu_torch.analysis nomad_tpu_torch/` semantics:
    zero non-baselined findings across the whole package, every rule
    run."""
    from nomad_tpu_torch.analysis import default_checkers

    out = json.loads(tree_run.stdout)
    assert out["findings"] == [], "\n".join(f["rendered"] for f in out["findings"])
    assert out["stale_baseline"] == []
    assert {c.rule for c in default_checkers()} <= set(out["rule_wall_ms"])


def test_cli_module_exits_zero(tree_run):
    assert tree_run.returncode == 0, tree_run.stdout + tree_run.stderr


# ---------------------------------------------------------------------------
# 2. fixture units — dtype-discipline
# ---------------------------------------------------------------------------


def test_dtype_flags_uncast_int64_subtraction():
    # the exact epoch_usage_arrays bug shape (reverting the encode.py
    # satellite fix re-creates this finding)
    src = dedent("""
        import numpy as np
        def epoch_usage_arrays(fleet, n_pad, n_real, fdtype):
            totals4 = fleet["totals4"]
            reserved4 = fleet["reserved4"]
            node_c2 = np.zeros((n_pad, 2), np.int64)
            node_c2[:n_real] = (totals4[:, :2] - reserved4[:, :2]).astype(np.int64)
            return node_c2
    """)
    fs = run_source(src, "tpu/encode.py")
    assert [f.rule for f in fs] == ["dtype-discipline"]
    assert "int64 cast of a subtraction" in fs[0].message


def test_dtype_accepts_percast_operands():
    # the fixed shape: each operand cast to the eval dtype first
    src = dedent("""
        import numpy as np
        def epoch_usage_arrays(fleet, n_pad, n_real, fdtype):
            totals4 = fleet["totals4"]
            reserved4 = fleet["reserved4"]
            node_c2 = np.zeros((n_pad, 2), np.int64)
            node_c2[:n_real] = (
                totals4[:, :2].astype(fdtype) - reserved4[:, :2].astype(fdtype)
            ).astype(np.int64)
            return node_c2
    """)
    assert run_source(src, "tpu/encode.py") == []


def test_dtype_flags_float64_allocation_arithmetic():
    src = dedent("""
        import numpy as np
        def f(x):
            buf = np.zeros((4, 4), dtype=np.float64)
            return buf - x
    """)
    fs = run_source(src, "tpu/intscore.py")
    assert [f.rule for f in fs] == ["dtype-discipline"]
    assert "float64 operand" in fs[0].message


def test_packed_lane_flags_raw_bit_unpack():
    # hand-rolled unpack of a packed plane in a consumer module (the
    # scan step) must go through the blessed intscore helpers
    src = dedent("""
        import jax.numpy as jnp
        def step(static):
            feat_packed = static[3]
            feas = (feat_packed >> 0) & 1
            return feas
    """)
    fs = run_source(src, "tpu/engine.py")
    assert [f.rule for f in fs] == ["dtype-discipline"]
    assert "raw bit unpack" in fs[0].message
    assert "feat_packed" in fs[0].message


def test_packed_lane_accepts_blessed_helpers():
    # the helpers themselves are the sanctioned bit surgery — both their
    # definitions and calls through them are clean
    src = dedent("""
        import jax.numpy as jnp
        def unpack_feat_lane(packed, bit):
            return ((packed >> bit) & 1).astype(bool)
        def step(static):
            feat_packed = static[3]
            return unpack_feat_lane(feat_packed, 0)
    """)
    assert run_source(src, "tpu/engine.py") == []


def test_packed_lane_flags_float_promotion():
    src = dedent("""
        import numpy as np
        def bad_cast(feat_packed):
            return feat_packed.astype(np.float32)
        def bad_arith(count_packed):
            return count_packed * 0.5
    """)
    fs = run_source(src, "tpu/batcher.py")
    assert [f.rule for f in fs] == ["dtype-discipline"] * 2
    assert "float promotion" in fs[0].message
    assert "float promotion" in fs[1].message


def test_packed_lane_scoped_to_kernel_modules():
    # packed-named arrays elsewhere (host code, tests) are not the
    # kernel's lane layout; no findings outside the packed target list
    src = dedent("""
        def f(msg_packed):
            return (msg_packed >> 8) & 0xFF
    """)
    assert run_source(src, "server/worker.py") == []


def test_dtype_scoped_to_parity_modules():
    # the same pattern outside encode/intscore is host-path float64 by
    # design and not flagged
    src = dedent("""
        import numpy as np
        def f(a, b):
            return (a - b).astype(np.int64)
    """)
    assert run_source(src, "server/worker.py") == []


# ---------------------------------------------------------------------------
# fixture units — shared-state-discipline (guarded-by path)
# ---------------------------------------------------------------------------

BATCHER_DECL = dedent("""
    import threading
    class DeviceBatcher:
        def __init__(self):
            self._lock = threading.Lock()
            self.stats = {"dispatches": 0}  # guarded-by: _lock
""")


def test_lock_flags_unguarded_cross_module_write():
    # the exact run_forced bug shape (reverting the engine.py satellite
    # fix re-creates this finding)
    src = dedent("""
        def compute_system_placements(batcher):
            batcher.stats["dispatches"] = batcher.stats.get("dispatches", 0) + 1
    """)
    fs = run_source(src, "tpu/engine.py",
                    extra_modules=[(BATCHER_DECL, "tpu/batcher.py")])
    assert [f.rule for f in fs] == ["shared-state-discipline"]
    assert "batcher.stats" in fs[0].message


def test_lock_accepts_with_lock_write():
    src = dedent("""
        def compute_system_placements(batcher):
            with batcher._lock:
                batcher.stats["dispatches"] = batcher.stats.get("dispatches", 0) + 1
    """)
    assert run_source(src, "tpu/engine.py",
                      extra_modules=[(BATCHER_DECL, "tpu/batcher.py")]) == []


def test_lock_flags_self_write_in_declaring_class():
    # the annotated declaration itself is exempt
    assert run_source(BATCHER_DECL, "tpu/batcher.py") == []

    src2 = dedent("""
        import threading
        class DeviceBatcher:
            def __init__(self):
                self._lock = threading.Lock()
                self.stats = {"d": 0}  # guarded-by: _lock
            def _run_batch(self):
                self.stats["d"] += 1
            def _run_batch_locked(self):
                with self._lock:
                    self.stats["d"] += 1
    """)
    fs = run_source(src2, "tpu/batcher.py")
    assert len(fs) == 1 and fs[0].rule == "shared-state-discipline"
    assert fs[0].line == 7


def test_lock_ignores_unannotated_same_name_attr():
    # worker.py has its own self.stats with no annotation: self-writes in
    # a NON-declaring class are not flagged
    src = dedent("""
        class Worker:
            def __init__(self):
                self.stats = {"evals_processed": 0}
            def run(self):
                self.stats["evals_processed"] += 1
    """)
    fs = run_source(src, "server/worker.py",
                    extra_modules=[(BATCHER_DECL, "tpu/batcher.py")])
    assert fs == []


# ---------------------------------------------------------------------------
# fixture units — shared-state-discipline (inferred-sharing path)
# ---------------------------------------------------------------------------


def test_shared_state_flags_unguarded_write_from_two_roots():
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = {}
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _pump(self):
                self.pending["a"] = 1

            def _drain(self):
                self.pending.pop("a", None)
    """)
    fs = run_source(src, "server/brokerfix.py")
    hits = [f for f in fs if f.rule == "shared-state-discipline"]
    assert hits, fs
    assert any("Broker.pending" in f.message
               and "concurrent roots" in f.message for f in hits)


def test_shared_state_accepts_lexically_held_writes():
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = {}
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _pump(self):
                with self._lock:
                    self.pending["a"] = 1

            def _drain(self):
                with self._lock:
                    self.pending.pop("a", None)
    """)
    assert run_source(src, "server/brokerfix.py") == []


def test_shared_state_all_call_sites_held_proof():
    # _bump never takes the lock itself; every call site does, which the
    # interprocedural proof accepts
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = {}
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _pump(self):
                with self._lock:
                    self._bump()

            def _drain(self):
                with self._lock:
                    self._bump()

            def _bump(self):
                self.pending["n"] = 1
    """)
    assert run_source(src, "server/brokerfix.py") == []


def test_shared_state_race_ok_suppresses_with_reason():
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = []
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _pump(self):
                self.hits.append(1)  # race-ok: GIL-atomic append, read at join

            def _drain(self):
                self.hits.append(2)  # race-ok: GIL-atomic append, read at join
    """)
    assert run_source(src, "server/brokerfix.py") == []


def test_shared_state_race_ok_requires_reason():
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = []
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _pump(self):
                self.hits.append(1)  # race-ok:

            def _drain(self):
                self.hits.append(2)  # race-ok: GIL-atomic append
    """)
    fs = run_source(src, "server/brokerfix.py")
    assert len(fs) == 1
    assert "needs a reason" in fs[0].message


def test_shared_state_stale_race_ok_fails():
    # a race-ok that suppresses nothing is itself a finding: the ratchet
    # only tightens
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = []  # race-ok: nothing here needs suppressing

            def _pump(self):
                with self._lock:
                    self.hits.append(1)
    """)
    fs = run_source(src, "server/brokerfix.py")
    assert len(fs) == 1
    assert "stale '# race-ok'" in fs[0].message


def test_shared_state_immutable_after_init_is_clean():
    # construction-path writes (__init__ and helpers called only from
    # it) happen-before publication
    src = dedent("""
        import threading

        class Broker:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = {}
                self._load()
                threading.Thread(target=self._pump, daemon=True).start()
                threading.Thread(target=self._drain, daemon=True).start()

            def _load(self):
                self.pending["seed"] = 0

            def _pump(self):
                with self._lock:
                    self.pending["a"] = 1

            def _drain(self):
                with self._lock:
                    self.pending.pop("a", None)
    """)
    assert run_source(src, "server/brokerfix.py") == []


# ---------------------------------------------------------------------------
# fixture units — jit-purity
# ---------------------------------------------------------------------------


def test_jit_flags_impure_call_in_decorated_fn():
    src = dedent("""
        import jax, time
        @jax.jit
        def f(x):
            t = time.time()
            return x
    """)
    fs = run_source(src, "tpu/kernels.py")
    assert [f.rule for f in fs] == ["jit-purity"]
    assert "time.time" in fs[0].message


def test_jit_flags_transitive_callee_and_jit_call_form():
    # the engine's builder pattern: jax.jit(fn) on a closure that calls a
    # same-module helper
    src = dedent("""
        import jax
        import numpy as np
        def _make_step():
            def helper(c):
                print("debug", c)
                return c
            def step(c, x):
                return helper(c), x
            return step
        def build():
            step = _make_step()
            return jax.jit(step)
    """)
    fs = run_source(src, "tpu/kernels.py")
    assert [f.rule for f in fs] == ["jit-purity"]
    assert "print" in fs[0].message


def test_jit_flags_partial_jit_and_global_mutation():
    src = dedent("""
        import jax
        from functools import partial
        COUNTER = 0
        @partial(jax.jit, static_argnames=("n",))
        def f(n, x):
            global COUNTER
            COUNTER += 1
            return x
    """)
    fs = run_source(src, "tpu/kernels.py")
    assert [f.rule for f in fs] == ["jit-purity"]
    assert "global" in fs[0].message


def test_jit_clean_scan_passes():
    src = dedent("""
        import jax
        @jax.jit
        def f(x):
            import jax.numpy as jnp
            return jnp.where(x > 0, x, -x)
    """)
    assert run_source(src, "tpu/kernels.py") == []


def test_jit_alias_resolution():
    src = dedent("""
        import jax
        import time as _time
        def body(c):
            return c + _time.monotonic_ns()
        def build():
            return jax.jit(body)
    """)
    fs = run_source(src, "tpu/kernels.py")
    assert len(fs) == 1 and "time.monotonic_ns" in fs[0].message


# ---------------------------------------------------------------------------
# fixture units — fsm-determinism
# ---------------------------------------------------------------------------


def test_fsm_flags_wall_clock_in_handler():
    src = dedent("""
        import time
        class NomadFSM:
            def _apply_eval_update(self, index, payload):
                stamp = time.time_ns()
                self.state.upsert(index, payload, stamp)
        _DISPATCH = {"eval-update": NomadFSM._apply_eval_update}
    """)
    fs = run_source(src, "server/fsm.py")
    assert [f.rule for f in fs] == ["fsm-determinism"]
    assert "time.time_ns" in fs[0].message


def test_fsm_flags_transitive_self_call():
    src = dedent("""
        import random
        class NomadFSM:
            def _apply_plan(self, index, payload):
                self._helper(payload)
            def _helper(self, payload):
                return random.random()
        _DISPATCH = {"plan": NomadFSM._apply_plan}
    """)
    fs = run_source(src, "server/fsm.py")
    assert len(fs) == 1 and "random.random" in fs[0].message


def test_fsm_clean_handlers_and_unreachable_impurity():
    # impure code NOT reachable from the dispatch table is out of scope
    src = dedent("""
        import time
        class NomadFSM:
            def _apply_x(self, index, payload):
                self.state.upsert(index, payload)
            def leader_only_tick(self):
                return time.time()
        _DISPATCH = {"x": NomadFSM._apply_x}
    """)
    assert run_source(src, "server/fsm.py") == []


def test_fsm_real_module_is_deterministic():
    fsm_path = os.path.join(PKG, "server", "fsm.py")
    from nomad_tpu_torch.analysis.fsm_determinism import FsmDeterminismChecker
    from nomad_tpu_torch.analysis.core import parse_file

    module, err = parse_file(fsm_path, "nomad_tpu_torch/server/fsm.py")
    assert err is None
    # the real dispatch table is found (non-trivially exercised: 30 handlers)
    checker = FsmDeterminismChecker()
    assert checker.check(module) == []


# ---------------------------------------------------------------------------
# fixture units — trace-span-discipline
# ---------------------------------------------------------------------------


def test_trace_span_flags_bare_track_call():
    # discarding the context manager: the span never opens (or worse,
    # opens in __init__-style factories and never closes)
    src = dedent("""
        from nomad_tpu_torch.utils import phases
        def process(ev):
            phases.track("rank")
            return rank(ev)
    """)
    fs = run_source(src, "server/worker.py")
    assert [f.rule for f in fs] == ["trace-span-discipline"]
    assert "phases.track" in fs[0].message


def test_trace_span_flags_manual_enter_dance():
    # storing the manager for a manual __enter__/__exit__ pair: an
    # exception between the two leaves the span open forever
    src = dedent("""
        from ..utils import phases as _phases
        def process(ev):
            cm = _phases.track("rank")
            cm.__enter__()
            work(ev)
            cm.__exit__(None, None, None)
    """)
    fs = run_source(src, "server/worker.py")
    assert [f.rule for f in fs] == ["trace-span-discipline"]
    assert "_phases.track" in fs[0].message


def test_trace_span_flags_bare_worker_span():
    src = dedent("""
        class Worker:
            def _process(self, ev):
                self._span("invoke_scheduler", ev.id)
                self.sched.process(ev)
    """)
    fs = run_source(src, "server/worker.py")
    assert [f.rule for f in fs] == ["trace-span-discipline"]
    assert "._span" in fs[0].message


def test_trace_span_accepts_with_and_enter_context():
    src = dedent("""
        from contextlib import ExitStack
        from nomad_tpu_torch.utils import phases
        class Worker:
            def _process(self, ev):
                with phases.track("worker_busy"):
                    with self._span("invoke_scheduler", ev.id):
                        work(ev)
                with ExitStack() as st:
                    st.enter_context(phases.track("rank"))
                    work(ev)
    """)
    assert run_source(src, "server/worker.py") == []


# ---------------------------------------------------------------------------
# fixture units — pipeline-stage-discipline
# ---------------------------------------------------------------------------


def test_pipeline_flags_raft_apply_from_pipeline_code():
    # the bug shape the rule exists to forbid: the dispatch-stage thread
    # committing around the plan queue
    src = dedent("""
        class Applier:
            def commit(self, entry_type, payload):
                return self.server.raft_apply(entry_type, payload)
    """)
    fs = run_source(src, "nomad_tpu_torch/pipeline/applier.py")
    assert [f.rule for f in fs] == ["pipeline-stage-discipline"]
    assert "raft apply" in fs[0].message


def test_pipeline_flags_raft_dot_apply_chain():
    src = dedent("""
        class Applier:
            def commit(self, entry_type, payload):
                return self.server.raft.apply(self.server.peer, entry_type, payload)
    """)
    fs = run_source(src, "nomad_tpu_torch/pipeline/redispatch.py")
    assert [f.rule for f in fs] == ["pipeline-stage-discipline"]
    assert "raft apply" in fs[0].message


def test_pipeline_flags_state_store_write():
    src = dedent("""
        class Applier:
            def commit(self, index, allocs):
                self.server.fsm.state.upsert_allocs(index, allocs)
    """)
    fs = run_source(src, "nomad_tpu_torch/pipeline/applier.py")
    assert [f.rule for f in fs] == ["pipeline-stage-discipline"]
    assert "state-store write" in fs[0].message


def test_pipeline_flags_unbounded_handoff_queue():
    src = dedent("""
        import queue
        class Stage:
            def __init__(self):
                self.out = queue.Queue()
    """)
    fs = run_source(src, "nomad_tpu_torch/pipeline/queues.py")
    assert [f.rule for f in fs] == ["pipeline-stage-discipline"]
    assert "unbounded stage queue" in fs[0].message


def test_pipeline_accepts_bounded_handoff_and_plan_queue():
    # the fixed shape: commits via plan_queue.enqueue, handoff via a
    # bounded queue; state READS (snapshot) are fine
    src = dedent("""
        import queue
        class Applier:
            def __init__(self, maxsize):
                self.out = queue.Queue(maxsize=maxsize)
            def submit(self, plan):
                snap = self.server.fsm.state.snapshot()
                pending = self.server.plan_queue.enqueue(plan)
                self.out.put(pending)
    """)
    assert run_source(src, "nomad_tpu_torch/pipeline/applier.py") == []


def test_pipeline_rule_scoped_to_pipeline_package():
    # raft applies outside nomad_tpu_torch/pipeline/ are the normal commit path
    src = dedent("""
        class Planner:
            def commit(self, entry_type, payload):
                return self.server.raft_apply(entry_type, payload)
    """)
    assert run_source(src, "server/plan_apply.py") == []


def test_pipeline_real_package_is_clean():
    from nomad_tpu_torch.analysis.core import parse_file
    from nomad_tpu_torch.analysis.pipeline_stage_discipline import (
        PipelineStageDisciplineChecker,
    )

    checker = PipelineStageDisciplineChecker()
    pkg = os.path.join(PKG, "pipeline")
    for fn in sorted(os.listdir(pkg)):
        if not fn.endswith(".py"):
            continue
        module, err = parse_file(
            os.path.join(pkg, fn), f"nomad_tpu_torch/pipeline/{fn}")
        assert err is None
        assert checker.check(module) == [], fn


# ---------------------------------------------------------------------------
# suppression + baseline mechanics
# ---------------------------------------------------------------------------


def test_inline_suppression():
    src = dedent("""
        import jax, time
        @jax.jit
        def f(x):
            t = time.time()  # nomad-lint: disable=jit-purity
            return x
    """)
    assert run_source(src, "tpu/kernels.py") == []


def test_suppression_is_rule_scoped():
    src = dedent("""
        import jax, time
        @jax.jit
        def f(x):
            t = time.time()  # nomad-lint: disable=dtype-discipline
            return x
    """)
    assert len(run_source(src, "tpu/kernels.py")) == 1


def test_baseline_subtracts_and_reports_stale():
    f1 = Finding("jit-purity", "a.py", 3, "impure call 'time.time' in f")
    f2 = Finding("jit-purity", "a.py", 9, "impure call 'print' in g")
    base = [
        {"rule": "jit-purity", "file": "a.py",
         "message": "impure call 'time.time' in f"},
        {"rule": "dtype-discipline", "file": "b.py", "message": "gone"},
    ]
    new, stale = apply_baseline([f1, f2], base)
    assert new == [f2]
    assert stale == [{"rule": "dtype-discipline", "file": "b.py",
                      "message": "gone"}]


def test_shipped_baseline_is_valid_json_list():
    with open(BASELINE) as fh:
        data = json.load(fh)
    assert isinstance(data, list)
    for ent in data:
        assert set(ent) == {"rule", "file", "message"}


# ---------------------------------------------------------------------------
# fault-injection-discipline
# ---------------------------------------------------------------------------


def test_fault_injection_blessed_fire_hook_is_clean():
    # the ONE production shape the chaos harness allows
    src = dedent("""
        from ..chaos.injector import fire as chaos_fire

        class EvalBroker:
            def ack(self, eval_id, token):
                chaos_fire("broker_ack", eval_id=eval_id)
                return self._ack_locked(eval_id, token)
    """)
    assert run_source(src, "nomad_tpu_torch/server/eval_broker.py") == []


def test_fault_injection_flags_adhoc_chaos_flag():
    # the bug shape rule 1 forbids: a second, registry-invisible fault path
    src = dedent("""
        CHAOS_ENABLED = False

        class Batcher:
            def run(self, enc):
                if CHAOS_ENABLED:
                    raise RuntimeError("injected")
                return self._dispatch(enc)
    """)
    fs = run_source(src, "nomad_tpu_torch/tpu/batcher.py")
    assert fs and all(f.rule == "fault-injection-discipline" for f in fs)
    assert any("ad-hoc chaos" in f.message for f in fs)


def test_fault_injection_flags_env_gated_chaos():
    src = dedent("""
        import os

        class Planner:
            def evaluate_plan(self, snapshot, plan):
                if os.getenv("NOMAD_CHAOS_PLAN"):
                    raise RuntimeError("injected")
    """)
    fs = run_source(src, "nomad_tpu_torch/server/plan_apply.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "environment-gated" in fs[0].message


def test_fault_injection_flags_production_injector_import():
    # production may import the fire hook only, never the arming surface
    src = dedent("""
        from ..chaos.injector import ChaosInjector

        class Server:
            pass
    """)
    fs = run_source(src, "nomad_tpu_torch/server/server.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "only the 'fire' hook" in fs[0].message


def test_fault_injection_flags_unknown_fire_point():
    src = dedent("""
        from ..chaos.injector import fire as chaos_fire

        def apply(entry):
            chaos_fire("raft_aply")
    """)
    fs = run_source(src, "nomad_tpu_torch/server/server.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "unknown injection point" in fs[0].message


def test_fault_injection_arm_with_finally_disarm_is_clean():
    src = dedent("""
        from nomad_tpu_torch.chaos import ChaosInjector

        def test_device_fault():
            inj = ChaosInjector(seed=1)
            inj.arm("device_dispatch", prob=1.0)
            try:
                run_replay()
            finally:
                inj.disarm_all()
    """)
    assert run_source(src, "tests/test_chaos.py") == []


def test_fault_injection_flags_arm_without_finally():
    # the leak shape rule 2 forbids: an armed injector outliving its test
    src = dedent("""
        from nomad_tpu_torch.chaos import ChaosInjector

        def test_device_fault():
            inj = ChaosInjector(seed=1)
            inj.arm("device_dispatch", prob=1.0)
            run_replay()
            inj.disarm_all()
    """)
    fs = run_source(src, "tests/test_chaos.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "finally" in fs[0].message


def test_fault_injection_flags_module_scope_arm():
    src = dedent("""
        from nomad_tpu_torch.chaos import ChaosInjector

        INJ = ChaosInjector(seed=1)
        INJ.arm("heartbeat", prob=0.5)
    """)
    fs = run_source(src, "tests/test_chaos.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "module scope" in fs[0].message


def test_fault_injection_unblock_enqueue_point_is_known():
    # the storm-flush fire point: a production
    # fire on it is clean, a near-miss typo is flagged
    src = dedent("""
        from ..chaos.injector import fire as chaos_fire

        class BlockedEvals:
            def _flush_pending_locked(self):
                chaos_fire("unblock_enqueue", batch=len(self._pending))
                self.eval_broker.enqueue_all(dict(self._pending))
    """)
    assert run_source(src, "nomad_tpu_torch/server/blocked_evals.py") == []
    typo = src.replace("unblock_enqueue", "unblock_enqueu")
    fs = run_source(typo, "nomad_tpu_torch/server/blocked_evals.py")
    assert [f.rule for f in fs] == ["fault-injection-discipline"]
    assert "unknown injection point" in fs[0].message


def test_fault_injection_known_points_match_injector_registry():
    """The lint's _KNOWN_POINTS copy is maintained by hand (the rule
    must not import production code); this pins it to the injector's
    POINTS so a new fire point can't silently lint as unknown."""
    from nomad_tpu_torch.analysis.fault_injection_discipline import _KNOWN_POINTS
    from nomad_tpu_torch.chaos.injector import POINTS

    assert set(_KNOWN_POINTS) == set(POINTS)


# ---------------------------------------------------------------------------
# subprocess-discipline


def test_subprocess_flags_run_without_timeout():
    src = dedent("""
        import subprocess

        def launch():
            subprocess.run(["server", "--once"], check=True)
    """)
    fs = run_source(src, "tests/test_crash.py")
    assert [f.rule for f in fs] == ["subprocess-discipline"]
    assert "timeout" in fs[0].message


def test_subprocess_accepts_bounded_run():
    src = dedent("""
        import subprocess

        def launch():
            subprocess.run(["server", "--once"], check=True, timeout=30)
    """)
    assert run_source(src, "tests/test_crash.py") == []


def test_subprocess_flags_unbounded_proc_wait():
    src = dedent("""
        def reap(proc):
            proc.kill()
            proc.wait()
    """)
    fs = run_source(src, "nomad_tpu_torch/chaos/crash.py")
    assert [f.rule for f in fs] == ["subprocess-discipline"]
    assert ".wait()" in fs[0].message


def test_subprocess_accepts_bounded_wait_and_lock_wait():
    # a condition-variable wait() is not a process reap: no finding
    src = dedent("""
        def reap(proc, cond):
            proc.kill()
            proc.wait(timeout=10)
            with cond:
                cond.wait()
    """)
    assert run_source(src, "nomad_tpu_torch/chaos/crash.py") == []


def test_subprocess_flags_unowned_popen():
    # local Popen, no finally reap, not a self-attribute: leaks on the
    # first exception between spawn and reap
    src = dedent("""
        import subprocess

        def boot():
            proc = subprocess.Popen(["server"])
            wait_ready(proc)
            return proc
    """)
    fs = run_source(src, "tests/test_crash.py")
    assert [f.rule for f in fs] == ["subprocess-discipline"]
    assert "Popen" in fs[0].message


def test_subprocess_accepts_finally_reaped_popen():
    src = dedent("""
        import subprocess

        def boot():
            proc = subprocess.Popen(["server"])
            try:
                wait_ready(proc)
            finally:
                proc.kill()
                proc.wait(timeout=10)
    """)
    assert run_source(src, "tests/test_crash.py") == []


def test_subprocess_accepts_class_owned_popen():
    # the ServerProcess pattern: Popen held as a self-attribute of a
    # class that defines a reap method
    src = dedent("""
        import subprocess

        class Proc:
            def spawn(self):
                self.proc = subprocess.Popen(["server"])

            def terminate(self):
                self.proc.terminate()
                self.proc.wait(timeout=10)
    """)
    assert run_source(src, "nomad_tpu_torch/chaos/crash.py") == []


def test_subprocess_scoped_to_harness_code():
    # production client drivers manage their own lifecycles: out of scope
    src = dedent("""
        import subprocess

        def start_task():
            p = subprocess.Popen(["workload"])
            return p
    """)
    assert run_source(src, "nomad_tpu_torch/client/drivers/exec_driver.py") == []


# ---------------------------------------------------------------------------
# fixture units — metrics-discipline
# ---------------------------------------------------------------------------

REGISTRY_DECL = dedent("""
    FAMILIES = {
        "nomad.broker": "eval broker",
        "nomad.trace": "lifecycle spans",
    }
""")


def test_metrics_flags_fstring_name_in_loop():
    # the exact failover.py bug shape: per-key metric names minted inside
    # a loop (reverting the publish_family fix re-creates this finding)
    src = dedent("""
        from ..utils import metrics

        def publish(fields):
            for k, v in fields.items():
                metrics.set_gauge(f"nomad.chaos.failover.{k}", float(v))
    """)
    fs = run_source(src, "nomad_tpu_torch/trace/failover.py")
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "inside a loop" in fs[0].message
    assert "publish_family" in fs[0].message


def test_metrics_flags_non_nomad_literal():
    src = dedent("""
        from nomad_tpu_torch.utils import metrics

        def tick():
            metrics.incr_counter("broker_enqueues")
    """)
    fs = run_source(src, "nomad_tpu_torch/server/eval_broker.py")
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "not a dotted" in fs[0].message


def test_metrics_flags_fully_dynamic_name():
    src = dedent("""
        from nomad_tpu_torch.utils import metrics

        def tick(eval_id):
            metrics.add_sample("nomad.sched." + eval_id, 1.0)
    """)
    fs = run_source(src, "nomad_tpu_torch/server/worker.py")
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "dynamic" in fs[0].message


def test_metrics_flags_headless_fstring():
    # an f-string whose literal head isn't 'nomad.<family>.' hides the
    # family from grep even outside loops
    src = dedent("""
        from nomad_tpu_torch.utils import metrics

        def tick(prefix):
            metrics.set_gauge(f"{prefix}.depth", 1.0)
    """)
    fs = run_source(src, "nomad_tpu_torch/server/worker.py")
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "literal head" in fs[0].message


def test_metrics_flags_unregistered_family_with_registry():
    # family enforcement arms only when the registry module is in the
    # collect set (full-tree runs; fixtures opt in via extra_modules)
    src = dedent("""
        from nomad_tpu_torch.utils import metrics

        def tick():
            metrics.incr_counter("nomad.mystery.count")
    """)
    fs = run_source(
        src, "nomad_tpu_torch/server/worker.py",
        extra_modules=[(REGISTRY_DECL, "nomad_tpu_torch/utils/metric_names.py")])
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "nomad.mystery" in fs[0].message and "FAMILIES" in fs[0].message


def test_metrics_accepts_literal_constant_and_bounded_fstring():
    src = dedent("""
        from nomad_tpu_torch.utils import metrics

        STALL_GAUGE = "nomad.watchdog.stalled_s"

        def tick(eval_type):
            metrics.incr_counter("nomad.broker.enqueues")
            metrics.set_gauge(STALL_GAUGE, 2.0)
            # bounded enum suffix outside a loop: family stays greppable
            metrics.add_sample(f"nomad.trace.eval_ms.{eval_type}", 5.0)
    """)
    assert run_source(
        src, "nomad_tpu_torch/server/worker.py",
        extra_modules=[(REGISTRY_DECL, "nomad_tpu_torch/utils/metric_names.py")]) \
        == []


def test_metrics_accepts_publish_family_door_in_loop():
    # the blessed dynamic-name door: a literal registered prefix, dict
    # fan-out handled inside metric_names (which is itself exempt)
    src = dedent("""
        from ..utils import metric_names

        def publish(snapshots):
            for snap in snapshots:
                metric_names.publish_family("nomad.broker", snap)
    """)
    assert run_source(
        src, "nomad_tpu_torch/server/eval_broker.py",
        extra_modules=[(REGISTRY_DECL, "nomad_tpu_torch/utils/metric_names.py")]) \
        == []


def test_metrics_flags_dynamic_publish_family_prefix():
    src = dedent("""
        from ..utils import metric_names

        def publish(prefix, fields):
            metric_names.publish_family(prefix, fields)
    """)
    fs = run_source(src, "nomad_tpu_torch/server/server.py")
    assert [f.rule for f in fs] == ["metrics-discipline"]
    assert "prefix" in fs[0].message


def test_metrics_exempts_sink_plumbing():
    # the sink's own fan-out and the registry door are the two modules
    # allowed to touch dynamic names
    src = dedent("""
        from . import metrics

        def publish_family(prefix, mapping):
            for key, value in mapping.items():
                metrics.set_gauge(f"{prefix}.{key}", float(value))
    """)
    assert run_source(src, "nomad_tpu_torch/utils/metric_names.py") == []


# ---------------------------------------------------------------------------
# fixture units — lock-order
# ---------------------------------------------------------------------------


def test_lock_order_flags_lexical_inversion():
    # the planted A->B / B->A shape: two methods of one class take the
    # same pair of locks in opposite orders
    src = dedent("""
        import threading

        class A:
            def __init__(self):
                self._lk1 = threading.Lock()
                self._lk2 = threading.Lock()

            def fwd(self):
                with self._lk1:
                    with self._lk2:
                        pass

            def rev(self):
                with self._lk2:
                    with self._lk1:
                        pass
    """)
    fs = run_source(src, "server/locky.py")
    assert [f.rule for f in fs] == ["lock-order"]
    assert "potential deadlock" in fs[0].message
    assert "locky.A._lk1" in fs[0].message
    assert "locky.A._lk2" in fs[0].message


def test_lock_order_accepts_consistent_order():
    src = dedent("""
        import threading

        class A:
            def __init__(self):
                self._lk1 = threading.Lock()
                self._lk2 = threading.Lock()

            def fwd(self):
                with self._lk1:
                    with self._lk2:
                        pass

            def also_fwd(self):
                with self._lk1:
                    with self._lk2:
                        pass
    """)
    assert run_source(src, "server/locky.py") == []


def test_lock_order_walks_through_calls():
    # neither inversion is lexical: each second lock is taken in a
    # callee while the first is held in the caller — only the
    # interprocedural walk sees the cycle
    src = dedent("""
        import threading

        class B:
            def __init__(self):
                self._x = threading.Lock()
                self._y = threading.Lock()

            def top(self):
                with self._x:
                    self._grab_y()

            def _grab_y(self):
                with self._y:
                    pass

            def other(self):
                with self._y:
                    self._grab_x()

            def _grab_x(self):
                with self._x:
                    pass
    """)
    fs = run_source(src, "server/calls.py")
    assert [f.rule for f in fs] == ["lock-order"]
    assert "calls.B._x" in fs[0].message
    assert " via " in fs[0].message  # the call chain is named in the edge


def test_lock_order_through_call_consistent_is_clean():
    src = dedent("""
        import threading

        class B:
            def __init__(self):
                self._x = threading.Lock()
                self._y = threading.Lock()

            def top(self):
                with self._x:
                    self._grab_y()

            def _grab_y(self):
                with self._y:
                    pass
    """)
    assert run_source(src, "server/calls.py") == []


def test_lock_order_uses_witness_factory_literal_keys():
    # witness-created locks carry their static key as a literal: the
    # finding names the LITERAL keys, proving the static side and the
    # runtime witness share one namespace by construction
    src = dedent("""
        from nomad_tpu_torch.utils.lock_witness import witness_lock

        class Broker:
            def __init__(self):
                self._lock = witness_lock("eval_broker.Broker._lock")
                self._q = witness_lock("eval_broker.Broker._q")

            def fwd(self):
                with self._lock:
                    with self._q:
                        pass

            def rev(self):
                with self._q:
                    with self._lock:
                        pass
    """)
    fs = run_source(src, "server/eval_broker.py")
    assert [f.rule for f in fs] == ["lock-order"]
    assert "eval_broker.Broker._lock" in fs[0].message
    assert "eval_broker.Broker._q" in fs[0].message


def test_lock_order_same_name_nesting_is_reentrant():
    # lock-class semantics: a snapshot's lock shares the live store's
    # key, so same-key nesting must not self-edge into a "cycle"
    src = dedent("""
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.RLock()

            def snapshot(self):
                with self._lock:
                    other = Store()
                    with other._lock:
                        pass
    """)
    assert run_source(src, "state/state_store.py") == []


# ---------------------------------------------------------------------------
# fixture units — r06 worker-pool shapes (lock-order, trace-span-discipline)
# ---------------------------------------------------------------------------
# The parallel-lifecycle round added two concurrency-sensitive shapes:
# the batcher's demand-aware expect/cancel counter (engine threads touch
# batcher._lock while the dispatcher thread holds it around stats), and
# the worker's coalesced idle-span recording. These fixtures pin that
# the SHIPPED shapes are clean AND that the bug-shaped variants a
# refactor could reintroduce still trip the rules.


def test_worker_pool_demand_counter_shape_is_clean():
    # engine-side expect()/cancel_expected() + dispatcher-side stats
    # bump, each under the single batcher lock: no ordering edge exists
    src = dedent("""
        import threading

        class DeviceBatcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._expected = 0
                self.stats = {"gathers": 0}  # guarded-by: _lock

            def expect(self, n=1):
                with self._lock:
                    self._expected += n

            def cancel_expected(self):
                with self._lock:
                    self._expected = max(0, self._expected - 1)

            def _dispatch_loop(self):
                with self._lock:
                    self.stats["gathers"] += 1
    """)
    assert run_source(src, "tpu/batcher.py") == []


def test_worker_pool_lock_order_inversion_still_trips():
    # the regression a "hold the pool lock while announcing demand"
    # refactor would create: worker pool lock -> batcher lock in one
    # path, batcher lock -> pool lock in the drain path
    src = dedent("""
        import threading

        class WorkerPool:
            def __init__(self):
                self._pool_lock = threading.Lock()
                self._batcher_lock = threading.Lock()

            def announce(self):
                with self._pool_lock:
                    with self._batcher_lock:
                        pass

            def drain(self):
                with self._batcher_lock:
                    with self._pool_lock:
                        pass
    """)
    fs = run_source(src, "server/worker.py")
    assert [f.rule for f in fs] == ["lock-order"]
    assert "potential deadlock" in fs[0].message


def test_worker_idle_span_recording_shape_is_clean():
    # the shipped worker idle pattern: pipeline_record is a plain
    # timestamped event (not a span context manager), so recording a
    # coalesced idle interval on the next successful dequeue is NOT a
    # bare-span violation — while real span entries stay `with`-guarded
    src = dedent("""
        from nomad_tpu_torch.trace import lifecycle as _lifecycle
        from nomad_tpu_torch.utils import phases

        class Worker:
            def _run(self):
                idle_t0 = None
                while True:
                    poll_t0 = _lifecycle.pipeline_now()
                    ev = self.dequeue()
                    if ev is None:
                        if idle_t0 is None:
                            idle_t0 = poll_t0
                        continue
                    if idle_t0 is not None:
                        _lifecycle.pipeline_record(
                            _lifecycle.IDLE_STAGE, "worker-0",
                            idle_t0, _lifecycle.pipeline_now())
                        idle_t0 = None
                    with phases.track("worker_busy"):
                        self._process(ev)
    """)
    assert run_source(src, "server/worker.py") == []


def test_worker_idle_as_bare_span_still_trips():
    # the tempting-but-wrong variant: opening a phases.track("idle")
    # manager at idle start and parking it in a local — a worker that
    # dies idle leaves the span open forever
    src = dedent("""
        from nomad_tpu_torch.utils import phases

        class Worker:
            def _run(self):
                cm = phases.track("idle")
                cm.__enter__()
                ev = self.dequeue()
                cm.__exit__(None, None, None)
    """)
    fs = run_source(src, "server/worker.py")
    assert [f.rule for f in fs] == ["trace-span-discipline"]
    assert "phases.track" in fs[0].message


# ---------------------------------------------------------------------------
# fixture units — condition-discipline
# ---------------------------------------------------------------------------


def test_condition_flags_bare_wait():
    src = dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def take(self):
                with self._cv:
                    self._cv.wait()
                    return self._items.pop()
    """)
    fs = run_source(src, "server/condy.py")
    assert [f.rule for f in fs] == ["condition-discipline"]
    assert "while-predicate loop" in fs[0].message


def test_condition_accepts_while_loop_and_wait_for():
    src = dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def take(self):
                with self._cv:
                    while not self._items:
                        self._cv.wait(timeout=1.0)
                    return self._items.pop()

            def take2(self):
                with self._cv:
                    self._cv.wait_for(lambda: self._items, timeout=1.0)
                    return self._items.pop()
    """)
    assert run_source(src, "server/condy.py") == []


def test_condition_flags_unheld_notify():
    src = dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def put(self, x):
                self._items.append(x)
                self._cv.notify()
    """)
    fs = run_source(src, "server/condy.py")
    assert [f.rule for f in fs] == ["condition-discipline"]
    assert "not provably issued with the lock held" in fs[0].message


def test_condition_accepts_provably_held_notify():
    # three proofs: lexical with, the *_locked naming convention, and
    # every-call-site-holds-it
    src = dedent("""
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def put(self, x):
                with self._cv:
                    self._items.append(x)
                    self._cv.notify()

            def _wake_locked(self):
                self._cv.notify_all()

            def _wake(self):
                self._cv.notify()

            def put2(self, x):
                with self._lock:
                    self._items.append(x)
                    self._wake()
    """)
    assert run_source(src, "server/condy.py") == []


def test_condition_ignores_non_condition_waits():
    # Event.wait / subprocess wait are not inventoried Conditions
    src = dedent("""
        import threading

        def reap(ev, proc):
            ev.wait(timeout=5)
            proc.wait(timeout=5)
    """)
    assert run_source(src, "server/condy.py") == []


# ---------------------------------------------------------------------------
# CLI satellites: --json / --rule / stale-baseline exit / --prune
# ---------------------------------------------------------------------------

CYCLE_SRC = dedent("""
    import threading

    class A:
        def __init__(self):
            self._lk1 = threading.Lock()
            self._lk2 = threading.Lock()

        def fwd(self):
            with self._lk1:
                with self._lk2:
                    pass

        def rev(self):
            with self._lk2:
                with self._lk1:
                    pass
""")


def _cli(argv):
    from nomad_tpu_torch.analysis.__main__ import main
    return main(argv)


def test_cli_json_output_shape(tmp_path, capsys):
    mod = tmp_path / "locky.py"
    mod.write_text(CYCLE_SRC)
    rc = _cli(["--json", "--no-baseline", str(mod)])
    out = capsys.readouterr().out
    assert rc == 1
    data = json.loads(out)
    assert set(data) == {"findings", "counts", "stale_baseline",
                        "rule_wall_ms"}
    assert data["counts"] == {"lock-order": 1}
    # per-rule wall time: every reporting rule appears, plus the shared
    # interprocedural build on its own line
    assert "lock-order" in data["rule_wall_ms"]
    assert "shared-state-discipline" in data["rule_wall_ms"]
    assert "call-graph" in data["rule_wall_ms"]
    assert all(isinstance(v, (int, float)) and v >= 0
               for v in data["rule_wall_ms"].values())
    (f,) = data["findings"]
    assert set(f) == {"rule", "file", "line", "message", "rendered"}
    assert f["rule"] == "lock-order"
    assert "potential deadlock" in f["message"]
    assert f["rendered"].startswith(f["file"])
    assert data["stale_baseline"] == []


def test_cli_rule_filter(tmp_path, capsys):
    mod = tmp_path / "locky.py"
    mod.write_text(CYCLE_SRC)
    # filtered to an unrelated rule, the cycle is out of scope
    rc = _cli(["--rule", "condition-discipline", "--no-baseline", str(mod)])
    capsys.readouterr()
    assert rc == 0
    # comma-separated form includes it again
    rc = _cli(["--rule", "condition-discipline,lock-order", "--no-baseline",
               str(mod)])
    capsys.readouterr()
    assert rc == 1


def test_cli_changed_only_scopes_reporting(tmp_path, capsys):
    dirty = tmp_path / "locky.py"
    dirty.write_text(CYCLE_SRC)
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")

    # scoped to the clean file, the cycle in the other file is not
    # reported (though the collect pass still saw the whole tree)
    rc = _cli(["--changed-only", str(clean), "--no-baseline",
               str(tmp_path)])
    capsys.readouterr()
    assert rc == 0

    rc = _cli(["--changed-only", str(dirty), "--no-baseline",
               str(tmp_path)])
    capsys.readouterr()
    assert rc == 1

    # comma-separated form; a deleted file scopes to nothing
    rc = _cli(["--changed-only",
               f"{clean},{tmp_path / 'deleted.py'}",
               "--no-baseline", str(tmp_path)])
    capsys.readouterr()
    assert rc == 0


def test_cli_changed_only_restricts_baseline_matching(tmp_path, capsys):
    dirty = tmp_path / "locky.py"
    dirty.write_text(CYCLE_SRC)
    base = tmp_path / "baseline.json"
    # a baseline entry for a file OUTSIDE the scope must not be
    # reported stale by a scoped run
    base.write_text(json.dumps([
        {"rule": "lock-order", "file": "elsewhere.py",
         "message": "potential deadlock: out of scope"},
    ]))
    rc = _cli(["--changed-only", str(dirty), "--baseline", str(base),
               str(tmp_path)])
    capsys.readouterr()
    assert rc == 1  # the in-scope cycle still fails...
    rc = _cli(["--changed-only", str(tmp_path / "other.py"),
               "--baseline", str(base), str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 0  # ...but the out-of-scope stale entry does not
    assert "stale" not in err


def test_cli_stale_baseline_fails_and_prune_heals(tmp_path, capsys):
    mod = tmp_path / "clean.py"
    mod.write_text("x = 1\n")
    base = tmp_path / "baseline.json"
    stale_entry = {"rule": "lock-order", "file": "gone.py",
                   "message": "potential deadlock: long since fixed"}
    base.write_text(json.dumps([stale_entry]))

    # stale entries are a FAILURE, not a warning: the ratchet only tightens
    rc = _cli(["--baseline", str(base), str(mod)])
    err = capsys.readouterr().err
    assert rc == 1
    assert "stale baseline" in err

    # --prune removes exactly the stale entries and the run goes green
    rc = _cli(["--baseline", str(base), "--prune", str(mod)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "pruned 1 stale entry" in out
    assert json.loads(base.read_text()) == []

    rc = _cli(["--baseline", str(base), str(mod)])
    capsys.readouterr()
    assert rc == 0


def test_cli_prune_never_adds_entries(tmp_path, capsys):
    # a tree with a NEW finding and a stale baseline: prune drops the
    # stale entry but must not launder the new finding in
    mod = tmp_path / "locky.py"
    mod.write_text(CYCLE_SRC)
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps([
        {"rule": "lock-order", "file": "gone.py", "message": "fixed ages ago"},
    ]))
    rc = _cli(["--baseline", str(base), "--prune", str(mod)])
    capsys.readouterr()
    assert rc == 1  # the new finding still fails the run
    assert json.loads(base.read_text()) == []


def test_cli_write_baseline_then_green(tmp_path, capsys):
    mod = tmp_path / "locky.py"
    mod.write_text(CYCLE_SRC)
    base = tmp_path / "baseline.json"
    rc = _cli(["--baseline", str(base), "--write-baseline", str(mod)])
    capsys.readouterr()
    assert rc == 0
    rc = _cli(["--baseline", str(base), str(mod)])
    capsys.readouterr()
    assert rc == 0


# ---------------------------------------------------------------------------
# rpc-telemetry-discipline: RPC traffic must go through the instrumented
# choke points (register / RPCClient.call), or it is invisible to the
# per-method stats table and the cross-process trace
# ---------------------------------------------------------------------------


def test_rpc_telemetry_flags_raw_handler_insert():
    src = dedent("""
        def wire(rpc):
            rpc.handlers["Sneaky.call"] = lambda: 1
    """)
    fs = run_source(src, "server/extra.py")
    assert any(f.rule == "rpc-telemetry-discipline"
               and "register" in f.message for f in fs)


def test_rpc_telemetry_flags_private_frame_import_and_call():
    src = dedent("""
        from nomad_tpu_torch.rpc.transport import _send_frame

        def leak(sock, payload):
            _send_frame(sock, payload)
    """)
    fs = run_source(src, "server/extra.py")
    assert any("side channel" in f.message for f in fs)

    src2 = dedent("""
        from nomad_tpu_torch.rpc import transport

        def leak(sock):
            return transport._recv_frame(sock)
    """)
    fs2 = run_source(src2, "server/extra.py")
    assert any(f.rule == "rpc-telemetry-discipline"
               and "instrumented RPC path" in f.message for f in fs2)


def test_rpc_telemetry_flags_handbuilt_envelope():
    src = dedent("""
        def craft(seq):
            return {"seq": seq, "method": "Node.Register", "body": ()}
    """)
    fs = run_source(src, "server/extra.py")
    assert any(f.rule == "rpc-telemetry-discipline"
               and "TraceContext" in f.message for f in fs)


def test_rpc_telemetry_accepts_register_and_local_helpers():
    # the blessed shapes: register(), RPCClient.call, and a module's OWN
    # _read_exact helper (the websocket framer) stay clean
    src = dedent("""
        def wire(rpc, client):
            rpc.register("Status.ping", lambda: "pong")
            return client.call("Status.ping")

        def _read_exact(rfile, n):
            return rfile.read(n)

        def use(rfile):
            return _read_exact(rfile, 4)
    """)
    assert run_source(src, "server/extra.py") == []


def test_rpc_telemetry_exempts_transport_itself():
    src = dedent("""
        def handler_loop(self, method, fn):
            self.handlers[method] = fn
            return {"seq": 1, "method": method}
    """)
    assert run_source(src, "rpc/transport.py") == []
    assert run_source(src, "plugins/transport.py") == []


# ---------------------------------------------------------------------------
# blocking-read-discipline
# ---------------------------------------------------------------------------


def test_blocking_read_flags_unrouted_read_endpoint():
    # a read-shaped endpoint that answers straight from the store: no
    # QueryMeta, no min_query_index — the bug shape the funnel removed
    src = dedent("""
        def bind(rpc, server):
            rpc.register("Job.List", lambda: server.fsm.state.jobs())
            rpc.register("Eval.GetEval", lambda i: server.fsm.state.eval_by_id(i))
    """)
    fs = run_source(src, "rpc/endpoints.py")
    flagged = [f for f in fs if f.rule == "blocking-read-discipline"]
    assert len(flagged) == 2
    assert any("Job.List" in f.message for f in flagged)
    assert any("Eval.GetEval" in f.message for f in flagged)


def test_blocking_read_accepts_funnel_and_waiver():
    src = dedent("""
        def bind(rpc, server):
            def serve_read(table, run, query_opts, key=None):
                return run(server.fsm.state)

            rpc.register(
                "Job.List",
                lambda query_opts=None: serve_read(
                    "jobs", lambda s: s.jobs(), query_opts),
            )

            def get_client_allocs(node_id, min_index, timeout):
                return server.fsm.state.allocs_by_node(node_id)

            # blocking-read-waiver: pre-watch long-poll with its own
            # min_index protocol
            rpc.register("Node.GetClientAllocs", get_client_allocs)

            # write endpoints are out of scope for the funnel entirely
            rpc.register("Job.Register", server.register_job)
    """)
    assert [f for f in run_source(src, "rpc/endpoints.py")
            if f.rule == "blocking-read-discipline"] == []


def test_blocking_read_scopes_endpoint_rule_to_endpoint_modules():
    # the same unrouted register outside an endpoints.py module is some
    # other registry's business (test harnesses, plugin tables)
    src = dedent("""
        def wire(rpc, server):
            rpc.register("Job.List", lambda: server.fsm.state.jobs())
    """)
    assert [f for f in run_source(src, "server/harness.py")
            if f.rule == "blocking-read-discipline"] == []


def test_blocking_read_flags_state_writing_hub_callback():
    src = dedent("""
        def wire(hub, server):
            hub.add_callback(
                lambda tables, index: server.fsm.state.upsert_evals(index, []))
    """)
    fs = run_source(src, "server/wiring.py")
    assert any(f.rule == "blocking-read-discipline"
               and "upsert_evals" in f.message for f in fs)


def test_blocking_read_flags_lock_taking_hub_callback():
    src = dedent("""
        def wire(watch_hub, store):
            def observer(tables, index):
                with store._lock:
                    return len(store.evals)

            watch_hub.add_callback(observer)
    """)
    fs = run_source(src, "server/wiring.py")
    assert any(f.rule == "blocking-read-discipline"
               and "store._lock" in f.message for f in fs)


def test_blocking_read_accepts_observer_callback():
    # pure observation — counters, appends — is the blessed callback
    # shape; non-hub add_callback receivers are out of scope entirely
    src = dedent("""
        def wire(hub, rec, metrics, seen, server):
            hub.add_callback(lambda tables, index: seen.append(index))

            def observer(tables, index):
                metrics.incr_counter("nomad.watch.observed", len(tables))

            hub.add_callback(observer)
            rec.add_callback(lambda: server.fsm.state.upsert_evals(0, []))
    """)
    assert [f for f in run_source(src, "server/wiring.py")
            if f.rule == "blocking-read-discipline"] == []


# ---------------------------------------------------------------------------
# the port's three findings, fixed in the port: the old shapes still flag
# ---------------------------------------------------------------------------


def _lint_port_file(rel, rule, src=None):
    """One port file (or ``src`` in its place) through the port's
    ``rule`` alone: the whole-program rules need the whole tree."""
    from nomad_tpu_torch.analysis import default_checkers

    if src is None:
        with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as fh:
            src = fh.read()
    return src, run_source(src, rel, checkers=[
        c for c in default_checkers() if c.rule == rule])


FI, RT = "fault-injection-discipline", "rpc-telemetry-discipline"


def test_engine_knows_an_injected_fault_without_importing_chaos():
    """``tpu/engine.py`` catches ``utils.faults.InjectedFault``; the shape
    it had (importing and catching ``chaos.ChaosFault``) flags twice."""
    src, fs = _lint_port_file("nomad_tpu_torch/tpu/engine.py", FI)
    assert fs == []
    assert "from ..utils.faults import InjectedFault\n" in src
    assert src.count("except InjectedFault:") == 1
    old = src.replace("from ..utils.faults import InjectedFault\n",
                      "from ..chaos import ChaosFault\n")
    old = old.replace("except InjectedFault:", "except ChaosFault:")
    _, fs = _lint_port_file("nomad_tpu_torch/tpu/engine.py", FI, old)
    assert [f.rule for f in fs] == ["fault-injection-discipline"] * 2
    assert "production import of 'ChaosFault'" in fs[0].message
    assert "ad-hoc chaos conditioning 'ChaosFault'" in fs[1].message


def test_injected_fault_is_the_chaos_fault_base():
    from nomad_tpu_torch.chaos import ChaosFault, ChaosInjector, fire
    from nomad_tpu_torch.utils.faults import InjectedFault

    assert issubclass(ChaosFault, InjectedFault)
    inj = ChaosInjector(seed=1)
    inj.arm("device_dispatch", mode="fail", prob=1.0)
    try:
        with pytest.raises(InjectedFault):
            fire("device_dispatch")
    finally:
        inj.disarm_all()


def test_serve_army_builds_its_envelope_through_the_transport():
    """``watch/serve.py``'s non-blocking watchers frame each blocking read
    with ``rpc.transport.request_frame``; the hand-built envelope it had
    flags."""
    src, fs = _lint_port_file("nomad_tpu_torch/watch/serve.py", RT)
    assert fs == []
    new = '''        w.out = bytearray(request_frame(
            w.seq, "Eval.GetEval", w.key,
            QueryOptions(min_query_index=w.last_index,
                         max_query_time=self.watch_query_time,
                         allow_stale=w.stale),
            stale=w.stale))
'''
    old = '''        req = {"seq": w.seq, "method": "Eval.GetEval",
               "body": (w.key, QueryOptions(min_query_index=w.last_index,
                                            max_query_time=self.watch_query_time,
                                            allow_stale=w.stale))}
        if w.stale:
            req["stale"] = True
        payload = encode(req)
        w.out = bytearray(_FRAME_LEN.pack(len(payload)) + payload)
'''
    assert new in src
    _, fs = _lint_port_file("nomad_tpu_torch/watch/serve.py", RT, src.replace(new, old))
    assert [f.rule for f in fs] == ["rpc-telemetry-discipline"]
    assert "hand-built RPC envelope" in fs[0].message


def test_request_frame_carries_the_trace_context():
    """``request_frame`` is ``RPCClient.call``'s envelope: seq, method,
    body, the stale flag, and the caller's trace context when a span is
    open."""
    import struct

    from nomad_tpu_torch.rpc.codec import TRACE_KEY, decode
    from nomad_tpu_torch.rpc.transport import request_envelope, request_frame
    from nomad_tpu_torch.trace import context as xtrace

    frame = request_frame(7, "Eval.GetEval", "k", stale=True)
    (n,) = struct.unpack(">I", frame[:4])
    req = decode(frame[4:4 + n])
    assert len(frame) == 4 + n
    assert req["seq"] == 7 and req["method"] == "Eval.GetEval" and req["stale"] is True
    assert list(req["body"]) == ["k"]
    assert TRACE_KEY not in req
    with xtrace.span("army.read", kind="client"):
        req = request_envelope(8, "Eval.GetEval", ("k",))
        assert req[TRACE_KEY] == xtrace.inject()
        assert req[TRACE_KEY] is not None


# ---------------------------------------------------------------------------
# 3. one case per rule: the reference's run_source and the port's agree
# ---------------------------------------------------------------------------


def _reference_fixtures():
    """Every ``run_source(<dedent literal>, "<rel>"[, extra_modules=...])``
    call of ``tests/test_static_analysis.py``, each with the snippet last
    bound to its name before the call: (test, source, rel, extra)."""
    import ast

    with open(os.path.join(REPO_ROOT, "tests", "test_static_analysis.py"),
              encoding="utf-8") as fh:
        tree = ast.parse(fh.read())

    def literal(node):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dedent" \
                and node.args and isinstance(node.args[0], ast.Constant):
            return dedent(node.args[0].value)
        return None

    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        events = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) and literal(node.value):
                events.append((node.lineno, 0, node.targets[0].id, literal(node.value)))
            elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "run_source":
                events.append((node.lineno, 1, None, node))
        bound = {}
        for _line, kind, name, val in sorted(events, key=lambda e: (e[0], e[1])):
            if kind == 0:
                bound[name] = val
                continue
            a = val.args
            if len(a) != 2 or not isinstance(a[0], ast.Name) or a[0].id not in bound \
                    or not isinstance(a[1], ast.Constant):
                continue
            extra, ok = [], True
            for kw in val.keywords:
                if kw.arg != "extra_modules" or not isinstance(kw.value, ast.List):
                    ok = False
                    continue
                for elt in kw.value.elts:
                    if isinstance(elt, ast.Tuple) and isinstance(elt.elts[0], ast.Name) \
                            and elt.elts[0].id in bound and isinstance(elt.elts[1], ast.Constant):
                        extra.append((bound[elt.elts[0].id], elt.elts[1].value))
                    else:
                        ok = False
            if ok:
                out.append((fn.name, bound[a[0].id], a[1].value, extra))
    return out


def _under(pkg, rel):
    """``rel`` as a path under ``pkg``: a package path moves over, a test
    file stays where it is."""
    for prefix in ("nomad_tpu_torch/", "nomad_tpu/"):
        if rel.startswith(prefix):
            return pkg + "/" + rel[len(prefix):]
    if rel.startswith("tests/"):
        return rel
    return pkg + "/" + rel


@pytest.fixture(scope="module")
def corpus_findings():
    """The corpus through both packages' ``run_source``, every rule on:
    (test, rel, reference findings, port findings)."""
    from nomad_tpu.analysis import run_source as ref_run_source

    out = []
    for test, src, rel, extra in _reference_fixtures():
        ref = ref_run_source(src, _under("nomad_tpu", rel),
                             extra_modules=[(s, _under("nomad_tpu", r)) for s, r in extra])
        got = run_source(src, _under("nomad_tpu_torch", rel),
                         extra_modules=[(s, _under("nomad_tpu_torch", r)) for s, r in extra])
        out.append((test, rel, ref, got))
    return out


RULES = ["jit-purity", "dtype-discipline", "fsm-determinism", "trace-span-discipline",
         "pipeline-stage-discipline", "fault-injection-discipline",
         "subprocess-discipline", "metrics-discipline", "lock-order",
         "condition-discipline", "shared-state-discipline",
         "rpc-telemetry-discipline", "blocking-read-discipline"]


def test_rules_are_the_reference_rules_in_its_order():
    from nomad_tpu.analysis import default_checkers as ref_checkers

    from nomad_tpu_torch.analysis import default_checkers

    assert [c.rule for c in default_checkers()] == [c.rule for c in ref_checkers()] == RULES


@pytest.mark.parametrize("rule", RULES)
def test_corpus_findings_equal_the_reference(rule, corpus_findings):
    """The reference's fixture snippets, each linted at its path under
    ``nomad_tpu/`` by the reference and under ``nomad_tpu_torch/`` by the
    port: the same ``rule`` findings, as (rule, line, message), and at
    least one of them (the case is not vacuous). A message that names a
    file names it under the package linted, so the port's
    ``nomad_tpu_torch/`` reads as ``nomad_tpu/`` there."""
    assert len(corpus_findings) >= 80
    hits = 0
    for test, rel, ref, got in corpus_findings:
        want = [(f.rule, f.line, f.message) for f in ref if f.rule == rule]
        # a message that names the finding's file names it under its
        # package: the port's path is the reference's moved over
        have = [(f.rule, f.line, f.message.replace("nomad_tpu_torch/", "nomad_tpu/"))
                for f in got if f.rule == rule]
        assert have == want, (test, rel)
        hits += len(want)
    assert hits > 0, f"no snippet of the corpus triggers {rule}"
