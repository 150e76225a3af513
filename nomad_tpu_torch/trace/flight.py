"""Flight recorder: continuous low-rate sampling of the whole system.

Round 5's headline DNF took guesswork to diagnose because nothing
recorded the system's state over time: the device was busy 101.8s of a
600s window and the other 500s were invisible. The flight recorder is
the black box for that post-mortem — a leader-owned daemon thread that
every ``interval_s`` (~0.25s) snapshots the metrics surface plus a set
of DIRECT probes (broker depth and dequeue waiters, pipeline stage
depths and applier inflight slots, plan-queue depth, device-batcher
queue depth and dispatch-profile deltas, state-store min-index waiters,
encode-cache counters, per-replica raft/broker stats in multi-process
runs) into a timestamped frame. Frames live in a bounded ring and
optionally spill to JSONL, so a crashed or timed-out run still carries
its own telemetry tail in the bench artifact.

Disarmed, the recorder is a strict no-op: no thread, no probe calls,
no allocations beyond the constructor. The sampling thread measures its
own tick cost; ``overhead()`` reports the duty cycle so the stress gate
can assert the recorder stays under 1% of wall clock.

Copied from ``nomad_tpu/trace/flight.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``. The
port has no wire RPC layer, so ``install_server_probes`` has no
``rpc`` probe.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import lock_witness, metrics, race_witness
from . import context, lifecycle
from ..utils.lock_witness import witness_lock

_clock = time.monotonic

#: publish the (comparatively expensive) gauge sweep every Nth tick so a
#: 250ms sampling cadence doesn't pay pipeline-summary sorting 4x/s
_PUBLISH_EVERY_S = 2.0


class FlightRecorder:
    def __init__(self, interval_s: float = 0.25, retain: int = 1024,
                 spill_path: Optional[str] = None) -> None:
        self.interval_s = float(interval_s)
        self.retain = int(retain)
        self.spill_path = spill_path or None
        self._frames: "deque[Dict[str, object]]" = deque(maxlen=max(1, self.retain))
        self._probes: Dict[str, Callable[[], object]] = {}
        self._publishers: List[Callable[[], None]] = []
        self._lock = witness_lock("flight.FlightRecorder._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._spill_fh = None
        self._seq = 0
        self._ticks = 0
        self._tick_total_s = 0.0
        self._tick_max_s = 0.0
        self._armed_t: Optional[float] = None
        self._armed_elapsed_s = 0.0  # accumulated across arm/disarm cycles
        self._last_publish_t: Optional[float] = None

    # -- wiring ----------------------------------------------------------

    def add_probe(self, name: str, fn: Callable[[], object]) -> None:
        """Register a per-tick probe. Probes must be cheap and may raise;
        a raising probe records ``{"error": ...}`` for that tick instead
        of killing the sampler."""
        with self._lock:
            self._probes[name] = fn

    def remove_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def add_publisher(self, fn: Callable[[], None]) -> None:
        """Register a gauge publisher driven from the sampling thread
        (so /v1/metrics stays fresh without the server's 10s sweep —
        bench and chaos harnesses have no agent at all)."""
        with self._lock:
            self._publishers.append(fn)

    # -- lifecycle -------------------------------------------------------

    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def arm(self) -> None:
        if self.interval_s <= 0 or self.armed:
            return
        self._stop.clear()
        with self._lock:
            self._armed_t = _clock()
            if self.spill_path and self._spill_fh is None:
                try:
                    self._spill_fh = open(self.spill_path, "a",
                                          encoding="utf-8")
                except OSError:
                    self._spill_fh = None
        self._thread = threading.Thread(
            target=self._run, name="flight-recorder", daemon=True
        )
        self._thread.start()

    def disarm(self) -> None:
        t = self._thread
        self._stop.set()
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        with self._lock:
            if self._armed_t is not None:
                self._armed_elapsed_s += _clock() - self._armed_t
                self._armed_t = None
            fh, self._spill_fh = self._spill_fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry never kills itself
                pass

    # -- sampling --------------------------------------------------------

    def tick(self) -> Dict[str, object]:
        """Take one sample (the thread's body; also callable directly —
        tests and the bench tail-flush use it synchronously)."""
        t0 = _clock()
        with self._lock:
            probes = list(self._probes.items())
            publishers = list(self._publishers)
        if publishers and (self._last_publish_t is None
                           or t0 - self._last_publish_t >= _PUBLISH_EVERY_S):
            self._last_publish_t = t0
            for pub in publishers:
                try:
                    pub()
                except Exception:  # noqa: BLE001
                    pass
        frame: Dict[str, object] = {
            "seq": self._seq,
            "t": round(t0, 4),
            "wall": round(time.time(), 3),
            "probes": {},
            "gauges": {},
            "counters": {},
        }
        for name, fn in probes:
            try:
                frame["probes"][name] = fn()
            except Exception as e:  # noqa: BLE001
                frame["probes"][name] = {"error": str(e) or type(e).__name__}
        sink = metrics.global_sink()
        try:
            frame["gauges"] = sink.gauges()
            frame["counters"] = sink.counter_sums()
        except Exception:  # noqa: BLE001
            pass
        dt = _clock() - t0
        frame["tick_ms"] = round(dt * 1000.0, 3)
        with self._lock:
            self._seq += 1
            self._ticks += 1
            self._tick_total_s += dt
            self._tick_max_s = max(self._tick_max_s, dt)
            self._frames.append(frame)
            fh = self._spill_fh
        if fh is not None:
            try:
                fh.write(json.dumps(frame, sort_keys=True, default=str) + "\n")
                fh.flush()
            except (OSError, ValueError):
                pass
        metrics.add_sample("nomad.flight.tick_ms", dt * 1000.0)
        return frame

    # -- read side -------------------------------------------------------

    def frames(self, recent: Optional[int] = None) -> List[Dict[str, object]]:
        with self._lock:
            out = list(self._frames)
        if recent is not None and recent >= 0:
            out = out[-recent:] if recent else []
        return out

    def overhead(self) -> Dict[str, object]:
        """Self-measured cost: ticks, mean/max tick time and the duty
        cycle (tick time / armed wall time) the stress gate asserts."""
        with self._lock:
            ticks = self._ticks
            total = self._tick_total_s
            mx = self._tick_max_s
            elapsed = self._armed_elapsed_s
            if self._armed_t is not None:
                elapsed += _clock() - self._armed_t
        return {
            "ticks": ticks,
            "tick_ms_avg": round(total * 1000.0 / ticks, 3) if ticks else 0.0,
            "tick_ms_max": round(mx * 1000.0, 3),
            "duty_cycle": round(total / elapsed, 5) if elapsed > 0 else 0.0,
        }

    def snapshot(self, recent: int = 64) -> Dict[str, object]:
        """The /v1/flight payload."""
        return {
            "armed": self.armed,
            "interval_s": self.interval_s,
            "retain": self.retain,
            "spill_path": self.spill_path,
            "overhead": self.overhead(),
            "frames": self.frames(recent),
        }

    def write_spill(self, path: str, recent: Optional[int] = None) -> int:
        """Dump the ring (tail-flush for bench artifacts); returns the
        number of frames written."""
        frames = self.frames(recent)
        with open(path, "w", encoding="utf-8") as fh:
            for frame in frames:
                fh.write(json.dumps(frame, sort_keys=True, default=str) + "\n")
        return len(frames)


# ---------------------------------------------------------------------------
# standard probe set for a Server
# ---------------------------------------------------------------------------


def _batcher_probe(batcher) -> Callable[[], Dict[str, object]]:
    """Queue depth plus dispatch-profile DELTAS: the profile's running
    totals tell you nothing per-frame; the tick-over-tick delta is the
    instantaneous dispatch rate."""
    last = {"dispatches": 0, "evals": 0}

    def probe() -> Dict[str, object]:
        prof = batcher.dispatch_profile()
        cur_d = int(prof.get("dispatches", 0) or 0)
        cur_e = int(prof.get("evals", 0) or 0)
        out = {
            "queue_depth": batcher.queue_depth(),
            "dispatches": cur_d,
            "dispatches_delta": cur_d - last["dispatches"],
            "evals_delta": cur_e - last["evals"],
            "compute_ms_avg": prof.get("compute_ms_avg"),
            "pad_stack_ms_avg": prof.get("pad_stack_ms_avg"),
        }
        last["dispatches"], last["evals"] = cur_d, cur_e
        return out

    return probe


def _encode_cache_probe() -> Callable[[], Dict[str, float]]:
    def probe() -> Dict[str, float]:
        sums = metrics.global_sink().counter_sums()
        prefix = "nomad.tpu_engine.encode_cache_"
        return {
            k[len(prefix):]: v for k, v in sums.items() if k.startswith(prefix)
        }

    return probe


def install_server_probes(rec: FlightRecorder, server) -> None:
    """Wire the standard probe set for one in-process Server."""
    rec.add_probe("broker", server.eval_broker.stats)
    rec.add_probe(
        "plan_queue",
        lambda: {"depth": server.plan_queue.stats().get("depth", 0)},
    )
    rec.add_probe("trace", lifecycle.quick_stats)
    # blocked-eval depth + storm counters (unblock batches, coalesced
    # dups, deferrals) so bottleneck_report-adjacent frames can attribute
    # blocked-wait time during capacity pressure
    rec.add_probe("blocked_evals", server.blocked_evals.stats)
    rec.add_probe("autoscaler", server.autoscaler.stats)
    if server.pipeline is not None:
        rec.add_probe("pipeline", server.pipeline.stats)
    if server.device_batcher is not None:
        rec.add_probe("batcher", _batcher_probe(server.device_batcher))
    rec.add_probe(
        "state",
        lambda: {
            "latest_index": server.fsm.state.latest_index,
            "min_index_waiters": server.fsm.state.min_index_waiters(),
        },
    )
    rec.add_probe("encode_cache", _encode_cache_probe())
    # nomad-watch: parked-watcher depth, wakeup/coalesce counters
    rec.add_probe("watch", server.watch_hub.stats)
    # nomad-lockdep: {"armed": 0} when disarmed; lock/edge/violation
    # counters when a witness is live (probes run OUTSIDE rec._lock, so
    # this adds no flight->witness order edge)
    rec.add_probe("lock_witness", lock_witness.stats)
    # nomad-race: same shape — {"armed": 0} or field/access/violation
    # counters when the Eraser lockset witness is live
    rec.add_probe("race_witness", race_witness.stats)
    # distributed-trace ring counters
    rec.add_probe("xtrace", context.stats)
