"""Build, bind and launch the port's hand-written CUDA kernels.

``place_scan`` is the placement scan (``csrc/place_scan.cu``): it
replaces the JAX package's ``_make_step`` / ``_build_place_scan`` /
``_build_batched_scan`` (``nomad_tpu/tpu/engine.py:213``, ``:869``,
``:1000``), one thread-block cluster per eval whose CTAs split the node
axis; ``launch_plan`` picks the cluster size and lays out each CTA's
shared memory. The dtype of ``totals`` picks the arm: int32 launches the
exact-integer kernel (counted as ``place_scan``), float32 the float
kernel (counted as ``place_scan_f32``). An int32 eval with a candidate
axis (C > 0) runs the scan's preemption branch (K1 ``has_pre``, with the
greedy sweep, the second pass and isqrt/coord_q of
``nomad_tpu/tpu/preempt.py`` as device functions); a float32 one raises.
``forced_eval`` is the forced-node system kernel (``csrc/forced_eval.cu``,
K4, ``engine.py:888``), counted as ``forced_eval`` / ``forced_eval_f32``.
``chunk_scan`` is the chunked throughput tier's top-K scan
(``csrc/chunk_scan.cu``, K5, ``engine.py:3033``, float arm only),
counted as ``chunk_scan``: one thread-block cluster whose CTAs split the
eval's node axis, laid out by ``chunk_plan``.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (``_build/``,
keyed by a hash of the source and every ``csrc/`` header it includes)
and loaded with ``ctypes``; every pointer and the stream go across as
``c_void_p``.

The wrappers dispatch on the device of the tensors they are given: on
the CPU they run the kernel's plain PyTorch version (``step.py``,
``forced.py``, ``chunk.py``), on CUDA they launch the kernel on the current stream or
raise. Nothing falls back from CUDA to the CPU. ``LAUNCHES`` counts
kernel launches, one per launch and nowhere else, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chunk as _chunk
from . import convert
from . import forced as _forced
from . import step as _step
from .preempt import C_MAX, GP_MAX

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"place_scan": CSRC / "place_scan.cu", "forced_eval": CSRC / "forced_eval.cu",
           "chunk_scan": CSRC / "chunk_scan.cu"}
#: kernel name -> (source library, C entry point)
KERNELS = {
    "place_scan": ("place_scan", "place_scan_launch"),
    "place_scan_f32": ("place_scan", "place_scan_f32_launch"),
    "forced_eval": ("forced_eval", "forced_eval_launch"),
    "forced_eval_f32": ("forced_eval", "forced_eval_f32_launch"),
    "chunk_scan": ("chunk_scan", "chunk_scan_launch"),
}

#: kernel launches since the last reset, by kernel name; the int scan's
#: launches that carry a candidate axis are also counted on their own,
#: as ``place_scan_has_pre``
LAUNCHES: Dict[str, int] = {name: 0 for name in (*KERNELS, "place_scan_has_pre")}
#: per kernel: build seconds and the compiler's register/shared-memory
#: report (``-Xptxas -v``), filled when a build runs in this process
BUILD_INFO: Dict[str, Dict[str, object]] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _compiled_files(source: Path) -> List[Path]:
    """The source and every local header it includes, transitively."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _lib_path(name: str) -> Path:
    """The library's path, keyed by the bytes of every file it compiles:
    an edit to a shared header rebuilds each library that includes it."""
    h = hashlib.sha256()
    for path in _compiled_files(SOURCES[name]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together; load and return the libraries.
    Raises with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
        for name in names:
            if name in _libs:
                continue
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append((name, out, tmp, proc, time.monotonic()))
        errors = []
        for name, out, tmp, proc, t0 in procs:
            log, _ = proc.communicate()
            BUILD_INFO[name] = {"seconds": time.monotonic() - t0, "log": log}
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[name].name}:\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return {name: _libs[name] for name in names}


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


# -- place_scan: the launch plan ---------------------------------------------

#: SMs of an H100; the largest cluster; the shared memory a CTA can use;
#: the part of it held back for the kernel's static shared memory (the
#: launch refuses a kernel that needs more); the bytes of one spread's
#: statistics; the least nodes a CTA gets when the plan picks the cluster
#: size (``csrc/place_scan.cu`` has the same numbers)
SMS = 132
MAX_CLUSTER = 16
SMEM_PER_CTA = 232_448
STATIC_SMEM_RESERVE = 8_192
STAT_BYTES = 32
MIN_NODES_PER_CTA = 128
#: the regions of a CTA's dynamic shared memory, in ``Region`` order:
#: per CTA (shared memory only: the step's scores and flags of the
#: slice, the per-spread statistics, the greedy's row list, the failed
#: flags, each task group's Q45 reciprocal of its desired count, the
#: greedy's round per slot of each row, kept for the commit),
#: replicas of the small state every node reads (shared memory or a
#: per-CTA global arena), then staged copies (shared memory, or the tensor
#: itself where there is no room): the task groups' inputs, and the slice
#: of each per-node array, carried first
PER_CTA = ("score", "flags", "stat", "rows", "failed", "q_d", "sel_ord")
REPLICAS = ("spread_counts", "spread_entry", "dp_counts")
STAGED = ("asks", "desired", "dh_job", "dh_tg", "spread_weights", "spread_active",
          "spread_has_targets", "spread_desired", "dp_applies", "dp_limit",
          "used", "job_counts", "tg_counts", "e_base", "totals", "reserved", "feat",
          "e_ask", "spread_vids", "dp_vids", "aff_score")
REGIONS = PER_CTA + REPLICAS + STAGED


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclass(frozen=True)
class ScanPlan:
    """How one launch of the scan splits each eval's node axis: ``cs``
    CTAs (a cluster) per eval, CTA r owning nodes ``slices[r]`` (``per``
    a CTA), and where each region of a CTA lives: ``shared`` maps a
    region to its byte offset in dynamic shared memory (``smem_bytes`` in
    all), ``arena`` a replica to its offset in the per-CTA global arena
    (``arena_bytes`` a CTA); a staged region in neither is read and
    written in its tensor."""

    cs: int
    per: int
    slices: Tuple[Tuple[int, int], ...]
    smem_bytes: int
    arena_bytes: int
    region_bytes: Dict[str, int]
    shared: Dict[str, int]
    arena: Dict[str, int]

    @property
    def in_global(self) -> Tuple[str, ...]:
        """The regions that did not fit in shared memory."""
        return tuple(r for r in REGIONS if r not in self.shared)

    def soff(self) -> List[int]:
        """The kernel's ``soff``: an offset in shared memory, else -1 - the
        arena offset of a replica, else -1 (the tensor itself)."""
        return [self.shared[r] if r in self.shared
                else -1 - self.arena[r] if r in self.arena else -1 for r in REGIONS]


def launch_plan(B: int, N: int, D: int, G: int, S: int, V: int, DP: int, V2: int,
                C: int = 0, int_arm: bool = True, has_reserved: bool = False,
                has_aff: bool = False, cs: Optional[int] = None,
                max_cs: int = MAX_CLUSTER) -> ScanPlan:
    """The launch plan of a scan of B evals over N nodes. Without ``cs``,
    the largest power of two up to ``max_cs`` with B x CS <= 132 SMs and
    at least ``MIN_NODES_PER_CTA`` nodes a CTA, raised where a CTA's
    scores, flags and greedy rows would not fit its shared memory; a given
    ``cs`` (tests, chip_smoke.py) is taken as it is. Each CTA owns the
    contiguous slice ``[r * per, (r + 1) * per)`` cut at N (empty past
    it). Regions are laid out in ``REGIONS`` order, each 16-byte aligned:
    the per-CTA ones must fit (else ValueError), a replica that does not
    goes to the global arena, a staged array stays in its tensor. The
    outputs of the scan do not depend on the plan."""
    budget = SMEM_PER_CTA - STATIC_SMEM_RESERVE
    es = 4
    ceil = lambda a, b: -(-a // b)  # noqa: E731

    def sizes(per: int) -> Dict[str, int]:
        return {
            "score": per * (8 if int_arm else 4), "flags": per, "stat": S * STAT_BYTES,
            "rows": per * 4 if C else 0, "failed": G, "q_d": G * 8,
            "sel_ord": per * 16 if C else 0,
            "spread_counts": G * S * V * es, "spread_entry": G * S * V, "dp_counts": DP * V2 * 4,
            "asks": G * D * es, "desired": G * 4, "dh_job": G, "dh_tg": G,
            "spread_weights": G * S * es, "spread_active": G * S, "spread_has_targets": G * S,
            "spread_desired": G * S * V * es, "dp_applies": G * DP, "dp_limit": DP * 4,
            "used": per * D * es, "job_counts": per * 4, "tg_counts": G * per * 4,
            "e_base": per * 8 if int_arm else 0, "totals": per * D * es,
            "reserved": per * D * es if has_reserved else 0, "feat": G * per,
            "e_ask": G * per * 8 if int_arm else 0, "spread_vids": G * S * per * 4,
            "dp_vids": DP * per * 4, "aff_score": G * per * es if has_aff else 0,
        }

    def per_cta(cs_: int) -> int:
        sz = sizes(ceil(N, cs_))
        return sum(_align16(sz[r]) for r in PER_CTA)

    if cs is None:
        cs = 1
        while (cs * 2 <= max_cs and B * cs * 2 <= SMS
               and ceil(N, cs * 2) >= MIN_NODES_PER_CTA):
            cs *= 2
        while cs < max_cs and per_cta(cs) > budget:
            cs *= 2
    elif cs not in (1, 2, 4, 8, 16) or cs > max_cs:
        raise ValueError(f"place_scan: cluster size {cs} is not a power of two up to {max_cs}")
    per = ceil(N, cs)
    sz = sizes(per)
    shared: Dict[str, int] = {}
    arena: Dict[str, int] = {}
    cursor = arena_cursor = 0
    for r in PER_CTA:
        shared[r] = cursor
        cursor += _align16(sz[r])
    if cursor > budget:
        raise ValueError(
            f"place_scan: at CS={cs} a CTA's {per} nodes need {cursor} bytes of shared memory "
            f"for their scores, flags and greedy rows (the plan has {budget}); take a larger CS")
    for r in REPLICAS + STAGED:
        if cursor + _align16(sz[r]) <= budget:
            shared[r] = cursor
            cursor += _align16(sz[r])
        elif r in REPLICAS:
            arena[r] = arena_cursor
            arena_cursor += _align16(sz[r])
    slices = tuple((min(r * per, N), min(r * per + per, N)) for r in range(cs))
    return ScanPlan(cs=cs, per=per, slices=slices, smem_bytes=cursor, arena_bytes=arena_cursor,
                    region_bytes=sz, shared=shared, arena=arena)


# -- chunk_scan (K5): the launch plan ----------------------------------------

#: the regions of a K5 CTA's dynamic shared memory, in ``ChunkPlan``
#: order: per CTA (shared memory only: the slice's keys, its placed nodes
#: of a step (at most min(per, K)), the histogram exchange's slots
#: [2][CS], the deficit
#: replica), then where there is room the winners' list (else a global
#: scratch row) and staged copies of the task groups' inputs and of the
#: slice of each per-node array (else the tensor itself)
CHUNK_PER_CTA = ("keys", "chosen", "hist", "deficit")
CHUNK_STAGED = ("list", "asks", "desired", "dh_job", "dh_tg", "spread_weights",
                "spread_active", "sum_sw", "spread_desired", "used", "job_counts",
                "tg_counts", "totals", "reserved", "feat", "spread_vids", "aff_score")
CHUNK_REGIONS = CHUNK_PER_CTA + CHUNK_STAGED
#: one CTA's radix histogram on the wire: 256 bins, the +NaN and valid
#: key counts, two spare words (``kHistWords`` in chunk_scan.cu)
CHUNK_HIST_BYTES = 260 * 4
#: the most entries the winners' list keeps in shared memory (8 bytes
#: each); past it, a global scratch row of K entries; and the least room
#: the list gets below it: the radix passes end as soon as the keys at or
#: above a pass's bin fit the list (``chunk_list_cap``)
MAX_SMEM_PAIRS = 4096
CHUNK_LIST_MIN = 1024
#: the least nodes a K5 CTA gets when the plan picks the cluster size
CHUNK_MIN_NODES_PER_CTA = 256


@dataclass(frozen=True)
class ChunkPlan:
    """How a K5 launch splits the eval's node axis: ``cs`` CTAs (one
    cluster), CTA r owning nodes ``slices[r]`` (``per`` a CTA), and the
    byte offset in dynamic shared memory of each region that has one
    (``shared``; ``smem_bytes`` in all)."""

    cs: int
    per: int
    slices: Tuple[Tuple[int, int], ...]
    smem_bytes: int
    region_bytes: Dict[str, int]
    shared: Dict[str, int]

    @property
    def list_in_smem(self) -> bool:
        return "list" in self.shared

    @property
    def in_global(self) -> Tuple[str, ...]:
        """The regions that did not fit in shared memory."""
        return tuple(r for r in CHUNK_REGIONS if r not in self.shared)

    def soff(self) -> List[int]:
        """The kernel's ``soff``: the offset in shared memory, or -1."""
        return [self.shared.get(r, -1) for r in CHUNK_REGIONS]


def chunk_list_cap(K: int) -> int:
    """The winners' list's room at chunk size K: at least
    ``CHUNK_LIST_MIN`` entries up to ``MAX_SMEM_PAIRS`` (shared memory),
    K past it (a global row)."""
    return K if K > MAX_SMEM_PAIRS else min(max(K, CHUNK_LIST_MIN), MAX_SMEM_PAIRS)


def chunk_plan(N: int, D: int, G: int, S: int, V: int, K: int, has_aff: bool = False,
               cs: Optional[int] = None) -> ChunkPlan:
    """The launch plan of a K5 launch over N nodes at chunk size K.
    Without ``cs``, the largest power of two up to 16 with at least
    ``CHUNK_MIN_NODES_PER_CTA`` nodes a CTA, raised while a CTA's keys,
    its placed-node list and the exchange slots would not fit its shared
    memory; a given ``cs`` is taken as it is. Each CTA owns the
    contiguous slice ``[r * per, (r + 1) * per)`` cut at N. The per-CTA
    regions must fit (else ValueError); the winners' list goes to shared
    memory when K <= ``MAX_SMEM_PAIRS`` and it fits, then each staged
    array that fits, in ``CHUNK_REGIONS`` order. The outputs do not
    depend on the plan."""
    budget = SMEM_PER_CTA - STATIC_SMEM_RESERVE
    ceil = lambda a, b: -(-a // b)  # noqa: E731

    def sizes(per: int, cs_: int) -> Dict[str, int]:
        return {
            "keys": per * 4, "chosen": min(per, K) * 4, "hist": 2 * cs_ * CHUNK_HIST_BYTES,
            "deficit": G * 4, "list": chunk_list_cap(K) * 8 if K <= MAX_SMEM_PAIRS else 0,
            "asks": G * D * 4, "desired": G * 4, "dh_job": G, "dh_tg": G,
            "spread_weights": G * S * 4, "spread_active": G * S, "sum_sw": G * 4,
            "spread_desired": G * S * V * 4, "used": per * D * 4, "job_counts": per * 4,
            "tg_counts": G * per * 4, "totals": per * D * 4, "reserved": per * D * 4,
            "feat": G * per, "spread_vids": G * S * per * 4,
            "aff_score": G * per * 4 if has_aff else 0,
        }

    def per_cta(cs_: int) -> int:
        sz = sizes(ceil(N, cs_), cs_)
        return sum(_align16(sz[r]) for r in CHUNK_PER_CTA)

    if cs is None:
        cs = 1
        while cs * 2 <= MAX_CLUSTER and ceil(N, cs * 2) >= CHUNK_MIN_NODES_PER_CTA:
            cs *= 2
        while cs < MAX_CLUSTER and per_cta(cs) > budget:
            cs *= 2
    elif cs not in (1, 2, 4, 8, 16):
        raise ValueError(f"chunk_scan: cluster size {cs} is not a power of two up to "
                         f"{MAX_CLUSTER}")
    per = ceil(N, cs)
    sz = sizes(per, cs)
    shared: Dict[str, int] = {}
    cursor = 0
    for r in CHUNK_PER_CTA:
        shared[r] = cursor
        cursor += _align16(sz[r])
    if cursor > budget:
        raise ValueError(
            f"chunk_scan: at CS={cs} a CTA's {per} keys and exchange slots need {cursor} bytes "
            f"of shared memory (the plan has {budget}); take a larger CS")
    for r in CHUNK_STAGED:
        if r == "list" and K > MAX_SMEM_PAIRS:
            continue
        if cursor + _align16(sz[r]) <= budget:
            shared[r] = cursor
            cursor += _align16(sz[r])
    slices = tuple((min(r * per, N), min(r * per + per, N)) for r in range(cs))
    return ChunkPlan(cs=cs, per=per, slices=slices, smem_bytes=cursor, region_bytes=sz,
                     shared=shared)


#: cudaOccupancyMaxActiveClusters by (kernel, cluster size, shared bytes, card)
_max_clusters_seen: Dict[Tuple[str, int, int, int], int] = {}
_occupancy_lock = threading.Lock()


def _plan(m: Dict[str, int], int_arm: bool, cs: Optional[int], dev: torch.device) -> ScanPlan:
    """``launch_plan`` of a checked launch. On the card, where
    ``cudaOccupancyMaxActiveClusters`` reads fewer than the batch's B
    clusters (0 for a cluster of 16 the card cannot co-schedule at all),
    the plan drops to the next cluster size down, but never below the
    smallest one whose per-CTA regions fit: there the hardware runs the
    B clusters in waves (each eval's cluster is independent; nothing
    waits on another cluster). A size the card cannot co-schedule even
    once is always dropped; a forced ``cs`` raises only there."""
    dims = dict(B=m["B"], N=m["N"], D=m["D"], G=m["G"], S=m["S"], V=m["V"], DP=m["DP"],
                V2=m["V2"], C=m["C"], int_arm=int_arm, has_reserved=bool(m["has_reserved"]),
                has_aff=bool(m["has_aff"]))
    plan = launch_plan(**dims, cs=cs)
    if dev.type != "cuda":
        return plan
    if cs is not None:
        if max_active_clusters(plan.cs, plan.smem_bytes, int_arm, dev) < 1:
            raise RuntimeError(f"place_scan: the card cannot co-schedule a cluster of {cs} "
                               f"CTAs with {plan.smem_bytes} bytes of shared memory each")
        return plan
    while plan.cs > 1:
        resident = max_active_clusters(plan.cs, plan.smem_bytes, int_arm, dev)
        if resident >= m["B"]:
            break
        try:
            smaller = launch_plan(**dims, max_cs=plan.cs // 2)
        except ValueError:
            smaller = None  # a smaller cluster's slices do not fit a CTA
        if smaller is None:
            if resident < 1:
                raise RuntimeError(
                    f"place_scan: the card cannot co-schedule a cluster of {plan.cs} CTAs "
                    f"with {plan.smem_bytes} bytes of shared memory each, and no smaller "
                    f"cluster holds the slice")
            break  # the clusters run in waves
        plan = smaller
    return plan


def scan_waves(plan: ScanPlan, B: int, int_arm: bool, device=None) -> int:
    """How many waves B clusters of ``plan`` take on the card: B over
    the clusters ``cudaOccupancyMaxActiveClusters`` holds at once."""
    resident = max_active_clusters(plan.cs, plan.smem_bytes, int_arm, device)
    return -(-B // max(resident, 1))


def scan_plan(static_b, carry_b, xs_b, cs: Optional[int] = None) -> ScanPlan:
    """The plan ``place_scan_batched`` launches these arrays with."""
    m = _check_batched(static_b, carry_b, xs_b)
    return _plan(m, static_b[0].dtype == I32, cs, static_b[0].device)


# -- place_scan: arguments and launch -----------------------------------------

_INT_FIELDS = ("B", "N", "D", "G", "S", "V", "K", "DP", "V2", "P",
               "has_reserved", "has_aff", "has_evict", "has_forced",
               "has_pre", "C", "GP", "CS", "per", "smem_bytes", "arena_bytes")
_PTR_FIELDS = (
    "totals", "reserved", "asks", "feat", "aff_score", "desired", "dh_job",
    "dh_tg", "spread_vids", "spread_desired", "spread_weights",
    "spread_has_targets", "spread_active", "n_real", "e_ask", "dp_vids",
    "dp_limit", "dp_applies",
    "used", "tg_counts", "job_counts", "spread_counts", "spread_entry",
    "offset", "failed", "e_base", "dp_counts",
    "tg_idx", "penalty_idx", "evict_node", "evict_res", "evict_tg",
    "limit_p", "sum_sw_p", "ev_factor", "rev_factor", "forced_node",
    "chosen", "scores", "pulls", "skipped",
    "pre_res", "pre_prio", "pre_elig", "pre_mp", "pre_gid", "pre_evf",
    "pre_alive", "pre_remaining", "pre_counts", "evict_out", "arena", "sections",
)
#: the parts of a step that ``place_scan_sections`` times (``kSections``):
#: the step's head (its skip or its eviction), the per-spread statistics,
#: pass 1 (with the greedy), the counts' block scan, the cluster exchange
#: of the counts with the totals, pass 2 with its block reduction, the
#: cluster exchange of the selection with the winner, the commit
SECTIONS = ("head", "stats", "pass1", "scan", "exchange1", "pass2", "exchange2", "commit")


class ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in place_scan.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in _INT_FIELDS]
                + [("soff", ctypes.c_int * len(REGIONS))]
                + [(f, ctypes.c_void_p) for f in _PTR_FIELDS])


_FORCED_INT_FIELDS = ("P", "N", "D", "G", "has_reserved")
_FORCED_PTR_FIELDS = (
    "totals", "reserved", "asks", "feat", "desired", "dh_job", "dh_tg",
    "n_real", "e_ask", "used", "tg_counts", "job_counts", "failed", "e_base",
    "tg_idx", "forced_node", "chosen", "scores",
)


class ForcedArgs(ctypes.Structure):
    """Mirror of ``struct ForcedArgs`` in forced_eval.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in _FORCED_INT_FIELDS]
                + [(f, ctypes.c_void_p) for f in _FORCED_PTR_FIELDS])


_CHUNK_INT_FIELDS = ("N", "D", "G", "S", "V", "T", "K", "has_aff", "CS", "per", "smem_bytes",
                     "list_cap")
_CHUNK_PTR_FIELDS = (
    "totals", "reserved", "asks", "feat", "aff_score", "desired", "dh_job", "dh_tg",
    "spread_vids", "spread_desired", "spread_weights", "spread_active",
    "sum_spread_weights", "n_real", "used", "tg_counts", "job_counts", "spread_counts",
    "deficit", "tg_idx", "want", "top_idx", "top_scores", "valid", "placed", "pairs",
    "sections",
)


class ChunkArgs(ctypes.Structure):
    """Mirror of ``struct ChunkArgs`` in chunk_scan.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in _CHUNK_INT_FIELDS]
                + [("soff", ctypes.c_int * len(CHUNK_REGIONS))]
                + [(f, ctypes.c_void_p) for f in _CHUNK_PTR_FIELDS])


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    args_t = {"place_scan": ScanArgs, "forced_eval": ForcedArgs, "chunk_scan": ChunkArgs}[name]
    for source, entry in KERNELS.values():
        if source == name:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.POINTER(args_t), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    if name == "chunk_scan":
        lib.chunk_scan_max_clusters.argtypes = [ctypes.c_int] * 2
        lib.chunk_scan_max_clusters.restype = ctypes.c_int
    if name == "place_scan":
        lib.place_scan_max_clusters.argtypes = [ctypes.c_int] * 3
        lib.place_scan_max_clusters.restype = ctypes.c_int
        lib.k8_sweep_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                                        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.k8_sweep_launch.restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    size = getattr(lib, f"{name}_args_size")
    size.argtypes = []
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(args_t):
        raise RuntimeError(f"{args_t.__name__} layout differs between kernels.py and "
                           f"{SOURCES[name].name}")
    return lib


I32, I64, U8, BOOL, F32 = torch.int32, torch.int64, torch.uint8, torch.bool, torch.float32
# per-spread statistics live in a CTA's shared memory, 32 bytes each
_MAX_SPREADS = 1024


def _dtype(t) -> torch.dtype:
    """A tensor's dtype, or the tensor dtype a numpy array becomes."""
    return convert._TORCH_OF.get(t.dtype, t.dtype) if isinstance(t, np.ndarray) else t.dtype


def _shape_check(name, t, dtype, shape, who: str = "place_scan") -> None:
    """Check a tensor's dtype, shape and layout; a numpy array (which is
    copied into a packed buffer, so need not be contiguous) by the
    tensor dtype it becomes."""
    if _dtype(t) != dtype:
        raise TypeError(f"{who}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not isinstance(t, np.ndarray) and not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _scan_dims(static_b, carry_b, xs_b) -> Dict[str, int]:
    totals, asks, spread_desired = static_b[0], static_b[2], static_b[10]
    b, n, d = totals.shape
    return {
        "B": b, "N": n, "D": d, "G": asks.shape[1], "S": spread_desired.shape[2],
        "V": spread_desired.shape[3], "K": xs_b[1].shape[2],
        "DP": static_b[17].shape[1], "V2": carry_b[8].shape[2], "P": xs_b[0].shape[1],
    }


def _check_batched(static_b, carry_b, xs_b) -> Dict[str, int]:
    """Validate every array of a batched scan against the shapes and
    dtypes the kernel reads; return the sizes and specialization flags."""
    if len(static_b) != 26 or len(carry_b) != 12 or len(xs_b) != 10:
        raise ValueError("place_scan: expected 26 static, 12 carry and 10 xs arrays")
    T = static_b[0].dtype
    if T not in (I32, F32):
        raise NotImplementedError(
            f"place_scan: the kernel has an int32 and a float32 arm (totals dtype {T})")
    m = _scan_dims(static_b, carry_b, xs_b)
    B, N, D, G, S, V, K, DP, V2, P = (m[k] for k in _INT_FIELDS[:10])
    C = static_b[20].shape[2]
    GP = carry_b[11].shape[1]
    if C and T != I32:
        raise ValueError("place_scan: preemption (C > 0) runs in the int arm only")
    if C > C_MAX or GP > GP_MAX or (C and GP < 1):
        raise ValueError(f"place_scan: candidate axis C={C} / count groups GP={GP} outside "
                         f"the encode gates (C <= {C_MAX}, 1 <= GP <= {GP_MAX})")
    RN = N if C else 0
    R = static_b[1].shape[1]
    GA = static_b[4].shape[1]
    DE = xs_b[3].shape[2]
    F = xs_b[9].shape[2]
    if R not in (0, N) or GA not in (0, G) or DE not in (0, D) or F not in (0, 1):
        raise ValueError("place_scan: reserved/affinity/evict/forced axes malformed")
    EV = 2 if DE else 0
    # the float arm carries no exponentials: zero-sized e_ask / e_base
    GE, NE = (G, N) if T == I32 else (0, 0)
    specs = [
        # static
        ("totals", static_b[0], T, (B, N, D)), ("reserved", static_b[1], T, (B, R, D)),
        ("asks", static_b[2], T, (B, G, D)), ("feat_packed", static_b[3], U8, (B, G, N)),
        ("aff_score", static_b[4], T, (B, GA, N)), ("desired_counts", static_b[5], I32, (B, G)),
        ("dh_job", static_b[6], BOOL, (B, G)), ("dh_tg", static_b[7], BOOL, (B, G)),
        ("spread_vids", static_b[9], I32, (B, G, S, N)),
        ("spread_desired", static_b[10], T, (B, G, S, V)),
        ("spread_weights", static_b[11], T, (B, G, S)),
        ("spread_has_targets", static_b[12], BOOL, (B, G, S)),
        ("spread_active", static_b[13], BOOL, (B, G, S)),
        ("n_real", static_b[15], I32, (B,)), ("e_ask", static_b[16], I32, (B, GE, NE, 2)),
        ("dp_vids", static_b[17], I32, (B, DP, N)), ("dp_limit", static_b[18], I32, (B, DP)),
        ("dp_applies", static_b[19], BOOL, (B, G, DP)),
        # carry
        ("used", carry_b[0], T, (B, N, D)), ("tg_counts", carry_b[1], I32, (B, G, N)),
        ("job_counts", carry_b[2], I32, (B, N)),
        ("spread_counts", carry_b[3], T, (B, G, S, V)),
        ("spread_entry", carry_b[4], BOOL, (B, G, S, V)), ("offset", carry_b[5], I32, (B,)),
        ("failed", carry_b[6], BOOL, (B, G)), ("e_base", carry_b[7], I32, (B, NE, 2)),
        ("dp_counts", carry_b[8], I32, (B, DP, V2)),
        # per placement
        ("tg_idx", xs_b[0], I32, (B, P)), ("penalty_idx", xs_b[1], I32, (B, P, K)),
        ("evict_node", xs_b[2], I32, (B, P)), ("evict_res", xs_b[3], T, (B, P, DE)),
        ("evict_tg", xs_b[4], I32, (B, P)), ("limit_p", xs_b[5], I32, (B, P)),
        ("sum_sw_p", xs_b[6], T, (B, P)), ("ev_factor", xs_b[7], I32, (B, P, EV)),
        ("rev_factor", xs_b[8], I32, (B, P, EV)), ("forced_node", xs_b[9], I32, (B, P, F)),
        # preemption: candidate tables, their carries
        ("pre_res", static_b[20], I32, (B, N, C, 4)), ("pre_prio", static_b[21], I32, (B, N, C)),
        ("pre_elig", static_b[22], BOOL, (B, N, C)), ("pre_mp", static_b[23], I32, (B, N, C)),
        ("pre_gid", static_b[24], I32, (B, N, C)), ("pre_evf", static_b[25], I32, (B, N, C, 2)),
        ("pre_alive", carry_b[9], BOOL, (B, N, C)),
        ("pre_remaining", carry_b[10], I64, (B, RN, 3)),
        ("pre_counts", carry_b[11], I32, (B, GP)),
    ]
    dev = static_b[0].device
    for name, t, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"place_scan: {name} is on {t.device}, totals on {dev}")
        _shape_check(name, t, dtype, shape)
    if V < 1 or (DP and V2 < 1):
        raise ValueError("place_scan: empty value vocabulary")
    if S > _MAX_SPREADS:
        raise ValueError(f"place_scan: {S} spreads exceed the kernel's {_MAX_SPREADS}")
    m.update(has_reserved=int(R > 0), has_aff=int(GA > 0),
             has_evict=int(DE > 0), has_forced=int(F > 0),
             has_pre=int(C > 0), C=C, GP=GP)
    return m


def _launch_place_scan(static_b, carry_b, xs_b, cs: Optional[int] = None, sections=None):
    m = _check_batched(static_b, carry_b, xs_b)
    dev = static_b[0].device
    B, P = m["B"], m["P"]
    float_arm = static_b[0].dtype == F32
    plan = _plan(m, not float_arm, cs, dev)
    score_t = F32 if float_arm else I64
    chosen = torch.empty((B, P), dtype=I32, device=dev)
    scores = torch.empty((B, P), dtype=score_t, device=dev)
    pulls = torch.empty((B, P), dtype=I32, device=dev)
    skipped = torch.empty((B, P), dtype=BOOL, device=dev)
    # the kernel writes the rank of each evicted slot and nothing else
    evict = torch.full((B, P, m["C"]), -1, dtype=I32, device=dev)
    arena = torch.empty(B * plan.cs * plan.arena_bytes, dtype=U8, device=dev)
    pre_res = static_b[20]
    if pre_res.data_ptr() % 16:
        pre_res = pre_res.clone()  # the kernel loads a slot's four dims as one int4
    tensors = {
        "totals": static_b[0], "reserved": static_b[1], "asks": static_b[2],
        "feat": static_b[3], "aff_score": static_b[4], "desired": static_b[5],
        "dh_job": static_b[6], "dh_tg": static_b[7], "spread_vids": static_b[9],
        "spread_desired": static_b[10], "spread_weights": static_b[11],
        "spread_has_targets": static_b[12], "spread_active": static_b[13],
        "n_real": static_b[15], "e_ask": static_b[16], "dp_vids": static_b[17],
        "dp_limit": static_b[18], "dp_applies": static_b[19],
        "used": carry_b[0], "tg_counts": carry_b[1], "job_counts": carry_b[2],
        "spread_counts": carry_b[3], "spread_entry": carry_b[4], "offset": carry_b[5],
        "failed": carry_b[6], "e_base": carry_b[7], "dp_counts": carry_b[8],
        "tg_idx": xs_b[0], "penalty_idx": xs_b[1], "evict_node": xs_b[2],
        "evict_res": xs_b[3], "evict_tg": xs_b[4], "limit_p": xs_b[5],
        "sum_sw_p": xs_b[6], "ev_factor": xs_b[7], "rev_factor": xs_b[8],
        "forced_node": xs_b[9],
        "chosen": chosen, "scores": scores, "pulls": pulls, "skipped": skipped,
        "pre_res": pre_res, "pre_prio": static_b[21], "pre_elig": static_b[22],
        "pre_mp": static_b[23], "pre_gid": static_b[24], "pre_evf": static_b[25],
        "pre_alive": carry_b[9], "pre_remaining": carry_b[10], "pre_counts": carry_b[11],
        "evict_out": evict, "arena": arena,
    }
    ptrs = {k: tensors[k].data_ptr() for k in tensors}
    ptrs["sections"] = 0 if sections is None else sections.data_ptr()
    m.update(CS=plan.cs, per=plan.per, smem_bytes=plan.smem_bytes, arena_bytes=plan.arena_bytes)
    args = ScanArgs(**{k: m[k] for k in _INT_FIELDS},
                    soff=(ctypes.c_int * len(REGIONS))(*plan.soff()),
                    **{k: ptrs[k] for k in _PTR_FIELDS})
    name = "place_scan_f32" if float_arm else "place_scan"
    source, entry = KERNELS[name]
    lib = _lib(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.place_scan_error_string(err).decode()}")
    with _count_lock:
        LAUNCHES[name] += 1
        if m["C"]:
            LAUNCHES["place_scan_has_pre"] += 1
    return carry_b, (chosen, scores, pulls, skipped, evict)


def _device_of(arrays) -> torch.device:
    devs = {t.device for t in arrays}
    if len(devs) != 1:
        raise ValueError(f"place_scan: tensors on several devices {devs}")
    return devs.pop()


def place_scan_batched(static_b, carry_b, xs_b, cs: Optional[int] = None):
    """K3: B evals of equal padded shapes in one launch, every array with
    a leading batch axis. The carry tensors are updated in place and
    returned with the stacked outputs ``(chosen, scores, pulls, skipped,
    evict)``, each ``[B, P, ...]``. ``cs`` forces the launch plan's
    cluster size (tests, chip_smoke.py); the outputs do not depend on it.
    On the CPU each eval runs through the plain version in turn and its
    final carry is written back (a given ``cs`` is checked by the plan)."""
    dev = _device_of((*static_b, *carry_b, *xs_b))
    if dev.type == "cuda":
        return _launch_place_scan(static_b, carry_b, xs_b, cs)
    if dev.type != "cpu":
        raise ValueError(f"place_scan: unsupported device {dev}")
    if cs is not None:
        scan_plan(static_b, carry_b, xs_b, cs)
    outs = []
    for b in range(static_b[0].shape[0]):
        new_carry, ys = _step.place_scan(
            static_b[0].shape[1], tuple(t[b] for t in static_b),
            tuple(t[b] for t in carry_b), tuple(t[b] for t in xs_b))
        for dst, src in zip(carry_b, new_carry):
            dst[b].copy_(src)
        outs.append(ys)
    return carry_b, tuple(torch.stack(col) for col in zip(*outs))


def place_scan(n_pad: int, static, carry, xs, cs: Optional[int] = None):
    """K1+K2: one eval's scan, the JAX ``place_scan`` contract
    ``(n_pad, static, carry, xs) -> (carry, (chosen, scores, pulls,
    skipped, evict))``. The carry tensors are updated in place and
    returned (on the CPU as on CUDA); ``cs`` as in
    ``place_scan_batched``."""
    if static[0].shape[0] != n_pad:
        raise ValueError(f"place_scan: n_pad {n_pad} != node axis {static[0].shape[0]}")
    batched = (tuple(t.unsqueeze(0) for t in static), tuple(t.unsqueeze(0) for t in carry),
               tuple(t.unsqueeze(0) for t in xs))
    if cs is None:
        _, ys = place_scan_batched(*batched)
    else:
        _, ys = place_scan_batched(*batched, cs=cs)
    return carry, tuple(y[0] for y in ys)


def place_scan_sections(static_b, carry_b, xs_b, cs: Optional[int] = None):
    """A ``place_scan_batched`` launch on the card with section timing:
    returns its ``(carry, ys)`` and the clock64 cycles thread 0 of each
    CTA spent in each part of the steps (``SECTIONS``), ``[B, CS,
    len(SECTIONS)]`` int64. A diagnostic: the launch is counted like any
    other."""
    dev = _device_of((*static_b, *carry_b, *xs_b))
    if dev.type != "cuda":
        raise ValueError("place_scan_sections: times the kernel on the card only")
    plan = scan_plan(static_b, carry_b, xs_b, cs)
    cycles = torch.zeros((static_b[0].shape[0], plan.cs, len(SECTIONS)), dtype=I64, device=dev)
    return _launch_place_scan(static_b, carry_b, xs_b, plan.cs, cycles), cycles


def _max_clusters(kernel: str, cs: int, smem_bytes: int, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of ``kernel`` (``place_scan``,
    ``place_scan_f32`` or ``chunk_scan``) at this cluster size and
    dynamic shared memory on the card (0: none), asked once a card."""
    dev = torch.device("cuda" if device is None else device)
    key = (kernel, cs, smem_bytes, dev.index or 0)
    with _occupancy_lock:
        n = _max_clusters_seen.get(key)
    if n is None:
        with torch.cuda.device(dev):
            if kernel == "chunk_scan":
                n = _lib("chunk_scan").chunk_scan_max_clusters(cs, smem_bytes)
            else:
                n = _lib("place_scan").place_scan_max_clusters(cs, smem_bytes,
                                                               int(kernel == "place_scan_f32"))
        with _occupancy_lock:
            _max_clusters_seen[key] = n
    return n


def max_active_clusters(cs: int, smem_bytes: int, int_arm: bool, device=None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the scan kernel's arm at this
    cluster size and dynamic shared memory on the card (0: none)."""
    return _max_clusters("place_scan" if int_arm else "place_scan_f32", cs, smem_bytes, device)


def chunk_max_active_clusters(cs: int, smem_bytes: int, device=None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the chunk kernel (K5) at this
    cluster size and dynamic shared memory on the card (0: none)."""
    return _max_clusters("chunk_scan", cs, smem_bytes, device)


def k8_sweep_inputs(seed: int = 0, n_random: int = 1 << 20):
    """Int64 numpy inputs for ``k8_sweep``: square roots at k**2, k**2 - 1
    and k**2 + 2k for k near 0 and near 2**31 and at random k, 2**62 - 1
    and random values below 2**62; Q16 coordinates with needed <= 0,
    exact quotients, negative numerators (res above needed), numerators
    clipped at -2**30 and at +2**30 (res below 0), and random pairs inside
    the magnitude gate (|needed|, |res| <= 2**28); floor divisions by a
    positive divisor with numerators of both signs around +-2**53 (the
    double quotient's edge), exact and inexact quotients, and random
    pairs up to 2**62. Returns (n, needed, res, num, den)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    top = 1 << 31
    ks = np.concatenate([np.arange(0, 4096), np.arange(top - 4096, top),
                         rng.integers(1, top, n_random // 8)]).astype(np.int64)
    sq = ks * ks
    n = np.concatenate([sq, sq[ks > 0] - 1, sq + 2 * ks,
                        np.array([(1 << 62) - 1, (1 << 62) - 2, 0, 1, 2, 3], dtype=np.int64),
                        (1 << 62) - np.arange(1, 4096, dtype=np.int64),
                        rng.integers(0, 1 << 62, n_random, dtype=np.int64)])
    n = n[(n >= 0) & (n < (1 << 62))]
    cap = 1 << 28
    small = np.array([1, 2, 3, 7, 1000, cap - 1, cap], dtype=np.int64)
    needed = [np.array([0, -5, -cap], dtype=np.int64).repeat(3), np.repeat(small, 6)]
    res = [np.tile(np.array([0, 5, cap], dtype=np.int64), 3),
           np.concatenate([np.array([0, 1, v - 1, v, v + 1, cap]) for v in small])]
    # exact quotients (needed divides the numerator), then random pairs
    # with numerators of both signs, clipped ones among them
    q = rng.integers(1, 1 << 12, n_random // 8)
    res.append(q * 16)
    needed.append(q * 16 + q * rng.integers(1, 16, q.size))
    needed.append(rng.integers(1, cap + 1, n_random, dtype=np.int64))
    res.append(rng.integers(-cap, cap + 1, n_random, dtype=np.int64))
    needed.append(rng.integers(1, 64, n_random // 8, dtype=np.int64))
    res.append(rng.integers(-cap, cap + 1, n_random // 8, dtype=np.int64))
    # floor division: numerators around the 2**53 edge and random ones,
    # divisors from 1 up, some of them dividing exactly
    edge = 1 << 53
    near = np.concatenate([np.arange(edge - 64, edge + 64), np.arange(-edge - 64, -edge + 64)])
    den = [np.tile(np.array([1, 2, 3, 7, 100, (1 << 40) + 1], dtype=np.int64), near.size)]
    num = [np.repeat(near.astype(np.int64), 6)]
    d = rng.integers(1, 1 << 40, n_random, dtype=np.int64)
    den += [d, d]
    num += [rng.integers(-(1 << 62), 1 << 62, n_random, dtype=np.int64),
            d * rng.integers(-(1 << 20), 1 << 20, n_random, dtype=np.int64)]
    d = rng.integers(1, 1 << 20, n_random, dtype=np.int64)
    den.append(d)
    num.append(rng.integers(-(1 << 52), 1 << 52, n_random, dtype=np.int64))
    return (n, np.concatenate(needed), np.concatenate(res), np.concatenate(num),
            np.concatenate(den))


def k8_sweep(n: torch.Tensor, needed: torch.Tensor, res: torch.Tensor, num: torch.Tensor,
             den: torch.Tensor):
    """The scan's exact integer device functions (``csrc/common.cuh``
    ``isqrt64``, ``coord_q``, ``floordiv_pos``) elementwise on the card:
    ``(isqrt(n), coord_q(needed, res), floor(num / den))`` of int64 CUDA
    tensors (den > 0), for holding them against ``preempt.isqrt_t`` /
    ``coord_q_t`` and ``torch.div(..., rounding_mode="floor")``. A test
    entry, not a kernel of the scan's path: it is not counted in
    ``LAUNCHES``."""
    tensors = (n, needed, res, num, den)
    if any(t.device.type != "cuda" or t.dtype != I64 or not t.is_contiguous() for t in tensors):
        raise ValueError("k8_sweep: takes contiguous int64 CUDA tensors")
    if needed.shape != res.shape or num.shape != den.shape:
        raise ValueError("k8_sweep: paired inputs differ in shape")
    isq, cq, fq = torch.empty_like(n), torch.empty_like(needed), torch.empty_like(num)
    lib = _lib("place_scan")
    with torch.cuda.device(n.device):
        stream = torch.cuda.current_stream(n.device).cuda_stream
        err = lib.k8_sweep_launch(n.data_ptr(), isq.data_ptr(), n.numel(), needed.data_ptr(),
                                  res.data_ptr(), cq.data_ptr(), needed.numel(), num.data_ptr(),
                                  den.data_ptr(), fq.data_ptr(), num.numel(),
                                  ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"k8_sweep launch failed: {lib.place_scan_error_string(err).decode()}")
    return isq, cq, fq


# -- forced_eval (K4) ---------------------------------------------------------


def _launch_forced_eval(static, carry, xs):
    totals, reserved, asks = static[0], static[1], static[2]
    T = totals.dtype
    n, d = totals.shape
    g = asks.shape[0]
    p = xs[0].shape[0]
    R = reserved.shape[0]
    if R not in (0, n):
        raise ValueError("forced_eval: reserved axis malformed")
    GE, NE = (g, n) if T == I32 else (0, 0)
    specs = [
        ("totals", totals, T, (n, d)), ("reserved", reserved, T, (R, d)),
        ("asks", asks, T, (g, d)), ("feat_packed", static[3], U8, (g, n)),
        ("desired_counts", static[5], I32, (g,)), ("dh_job", static[6], BOOL, (g,)),
        ("dh_tg", static[7], BOOL, (g,)), ("n_real", static[15], I32, ()),
        ("e_ask", static[16], I32, (GE, NE, 2)),
        ("used", carry[0], T, (n, d)), ("tg_counts", carry[1], I32, (g, n)),
        ("job_counts", carry[2], I32, (n,)), ("failed", carry[6], BOOL, (g,)),
        ("e_base", carry[7], I32, (NE, 2)),
        ("tg_idx", xs[0], I32, (p,)), ("forced_node", xs[9], I32, (p, 1)),
    ]
    for name, t, dtype, shape in specs:
        _shape_check(name, t, dtype, shape, "forced_eval")
    dev = totals.device
    float_arm = T == F32
    chosen = torch.empty(p, dtype=I32, device=dev)
    scores = torch.empty(p, dtype=F32 if float_arm else I64, device=dev)
    tensors = {
        "totals": totals, "reserved": reserved, "asks": asks, "feat": static[3],
        "desired": static[5], "dh_job": static[6], "dh_tg": static[7],
        "n_real": static[15], "e_ask": static[16], "used": carry[0],
        "tg_counts": carry[1], "job_counts": carry[2], "failed": carry[6],
        "e_base": carry[7], "tg_idx": xs[0], "forced_node": xs[9],
        "chosen": chosen, "scores": scores,
    }
    args = ForcedArgs(P=p, N=n, D=d, G=g, has_reserved=int(R > 0),
                      **{k: tensors[k].data_ptr() for k in _FORCED_PTR_FIELDS})
    name = "forced_eval_f32" if float_arm else "forced_eval"
    source, entry = KERNELS[name]
    lib = _lib(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.forced_eval_error_string(err).decode()}")
    with _count_lock:
        LAUNCHES[name] += 1
    return (chosen, scores, torch.zeros(p, dtype=I32, device=dev),
            torch.zeros(p, dtype=BOOL, device=dev),
            torch.zeros((p, 0), dtype=I32, device=dev))


def forced_eval(static, carry, xs):
    """K4: one all-distinct forced-node eval (the system encoder's shape)
    in one launch, the JAX ``forced_eval`` contract ``(static, carry,
    xs) -> (chosen, scores, pulls, skipped, evict)``. The inputs are not
    modified. On the CPU the plain version (``forced.py``) runs. The
    kernel takes no candidate axis and exactly one forced node per
    placement; anything else raises."""
    dev = _device_of((*static, *carry, *xs))
    if static[0].dtype not in (I32, F32):
        raise NotImplementedError(
            f"forced_eval: the kernel has an int32 and a float32 arm (totals dtype "
            f"{static[0].dtype})")
    if static[20].shape[1] or xs[9].ndim != 2 or xs[9].shape[1] != 1:
        raise ValueError("forced_eval: takes one forced node per placement and no "
                         "candidate axis")
    if dev.type == "cuda":
        return _launch_forced_eval(static, carry, xs)
    if dev.type != "cpu":
        raise ValueError(f"forced_eval: unsupported device {dev}")
    return _forced.forced_eval(static, carry, xs)


def forced_eval_work(static, carry, xs) -> Tuple[int, int]:
    """(bytes, operations) of one K4 launch. Bytes: each placement's task
    group and node ids, chosen and score; each forced node's rows
    (capacity, reservation, usage, the feature byte, job and task-group
    counts, in the int arm its Q27 factor rows), once per node; the task
    groups' asks and flags once. Operations: about 40 per placement plus
    3 per capacity dim, and in the float arm 40 more for its two
    ``powf``."""
    totals = static[0]
    p = xs[0].shape[0]
    g, d = static[2].shape
    es = totals.element_size()
    int_arm = totals.dtype == I32
    per_placement = 4 + 4 + 4 + (8 if int_arm else 4)
    per_node = d * es * (2 + (1 if static[1].shape[0] else 0)) + 1 + 4 + 4
    if int_arm:
        per_node += 8 + 8                      # e_base and e_ask rows
    per_tg = d * es + 4 + 2 + 1                # ask, desired, dh flags, failed
    ops = p * (40 + 3 * d + (0 if int_arm else 40))
    return p * (per_placement + per_node) + g * per_tg, ops


#: operations per greedy key (three Q16 coordinates with a division
#: each, the 31-round isqrt, the penalty add and compare), per greedy row
#: set up (penalty and alive bit of each slot) and per second-pass slot
#: (its distance, its rank among C, the prefix walk)
PRE_KEY_OPS = 140
PRE_ROW_OPS_PER_SLOT = 10
PRE_SECOND_OPS_PER_SLOT = 150


def place_scan_work(static, carry, xs, skipped=None, pre_stats=None) -> Tuple[int, int]:
    """(bytes, operations) one eval's scan needs at these inputs: every
    input read once and every output (final carry, per-step outputs)
    written once; operations counted per node and step from the
    kernel's pass 1 and pass 2 (about 60 fixed, 3 per capacity dim, 25
    per active spread, 8 per distinct_property constraint, 1 per penalty
    slot, and in the float arm 40 more for its two ``powf``), times N,
    over the steps that ran: a step the scan's output marks ``skipped``
    (a failed task group, or a batch's padding) does no node work.
    With a candidate axis, the preemption work this run's data needed,
    as the plain version counted it (``step.place_scan(..., stats)``):
    the greedy keys computed on the rows where the greedy can decide
    the result, those rows' set-up, and the chosen rows' second pass.
    Feeds the ``bound_ms`` of chip_smoke.py."""
    nbytes = sum(t.numel() * t.element_size() for t in (*static, *carry, *xs))
    nbytes += sum(t.numel() * t.element_size() for t in carry)
    p = xs[0].shape[0]
    c = static[20].shape[1]
    nbytes += p * (4 + static[0].element_size() * (2 if static[0].dtype == I32 else 1) + 4 + 1
                   + 4 * c)
    run = torch.ones(p, dtype=torch.bool) if skipped is None else ~skipped.cpu().bool()
    n, d = static[0].shape
    tg_run = xs[0].cpu().to(torch.int64)[run]
    active_per_g = static[13].cpu().to(torch.int64).sum(dim=-1)  # [G]
    spreads = int(active_per_g[tg_run].sum()) if tg_run.numel() else 0
    dp = static[17].shape[0]
    k = xs[1].shape[-1]
    per_step = 60 + 3 * d + 8 * dp + k + (40 if static[0].dtype == F32 else 0)
    ops = n * (int(tg_run.numel()) * per_step + 25 * spreads)
    if c:
        if pre_stats is None:
            raise ValueError("place_scan_work: a candidate axis needs the plain "
                             "version's preemption stats")
        ops += (PRE_KEY_OPS * pre_stats.get("greedy_keys", 0)
                + PRE_ROW_OPS_PER_SLOT * c * pre_stats.get("greedy_rows", 0)
                + PRE_SECOND_OPS_PER_SLOT * c * pre_stats.get("second_pass_rows", 0))
    return nbytes, ops


def place_scan_batched_work(static_b, carry_b, xs_b, skipped_b=None,
                            pre_stats_b=None) -> Tuple[int, int]:
    """``place_scan_work`` of a K3 launch: summed over the batch's evals
    (``pre_stats_b``: one stats dict per eval, where the batch has a
    candidate axis)."""
    nbytes = ops = 0
    for b in range(static_b[0].shape[0]):
        nb, op = place_scan_work(
            tuple(t[b] for t in static_b), tuple(t[b] for t in carry_b),
            tuple(t[b] for t in xs_b), None if skipped_b is None else skipped_b[b],
            None if pre_stats_b is None else pre_stats_b[b])
        nbytes += nb
        ops += op
    return nbytes, ops


# -- chunk_scan (K5) ----------------------------------------------------------

#: the parts of a step that ``chunk_scan_sections`` times: the score pass
#: (with the first radix pass's histogram), the cluster-wide radix select,
#: the winners' exchange with the ties and the order (outputs written),
#: the carry update with the step's closing barrier
CHUNK_SECTIONS = ("score", "select", "order", "carry")


def _check_chunk(n_pad, static, carry, xs, deficit, chunk) -> Dict[str, int]:
    """Validate the arrays the chunk kernel reads and writes; return its
    sizes."""
    totals, reserved, asks = static[0], static[1], static[2]
    if _dtype(totals) != F32:
        raise NotImplementedError(
            f"chunk_scan: the chunked tier runs in the float arm only (totals dtype "
            f"{totals.dtype})")
    n, d = totals.shape
    if n != n_pad:
        raise ValueError(f"chunk_scan: n_pad {n_pad} != node axis {n}")
    if not 1 <= chunk <= n:
        raise ValueError(f"chunk_scan: chunk size {chunk} outside [1, n_pad={n}]")
    if d < 2:
        raise ValueError("chunk_scan: needs the cpu and memory dims")
    g = asks.shape[0]
    s, v = static[10].shape[1], static[10].shape[2]
    ga = static[4].shape[0]
    if ga not in (0, g) or v < 1:
        raise ValueError("chunk_scan: affinity axis or value vocabulary malformed")
    t = xs[0].shape[0]
    specs = [
        ("totals", totals, F32, (n, d)), ("reserved", reserved, F32, (n, d)),
        ("asks", asks, F32, (g, d)), ("feat_packed", static[3], U8, (g, n)),
        ("aff_score", static[4], F32, (ga, n)), ("desired_counts", static[5], I32, (g,)),
        ("dh_job", static[6], BOOL, (g,)), ("dh_tg", static[7], BOOL, (g,)),
        ("spread_vids", static[9], I32, (g, s, n)),
        ("spread_desired", static[10], F32, (g, s, v)),
        ("spread_weights", static[11], F32, (g, s)),
        ("spread_active", static[13], BOOL, (g, s)),
        ("sum_spread_weights", static[14], F32, (g,)), ("n_real", static[15], I32, ()),
        ("used", carry[0], F32, (n, d)), ("tg_counts", carry[1], I32, (g, n)),
        ("job_counts", carry[2], I32, (n,)), ("spread_counts", carry[3], F32, (g, s, v)),
        ("tg_idx", xs[0], I32, (t,)), ("want", xs[1], I32, (t,)),
    ]
    if deficit is not None:
        specs.append(("deficit", deficit, I32, (g,)))
    for name, tensor, dtype, shape in specs:
        _shape_check(name, tensor, dtype, shape, "chunk_scan")
    return {"N": n, "D": d, "G": g, "S": s, "V": v, "T": t, "K": chunk,
            "has_aff": int(ga > 0)}


def _chunk_launch_plan(m: Dict[str, int], cs: Optional[int], dev: torch.device) -> ChunkPlan:
    """``chunk_plan`` of a checked launch. On the card, where
    ``cudaOccupancyMaxActiveClusters`` reads 0 for the plan's cluster
    (the card cannot co-schedule that many CTAs at that shared memory),
    the plan drops to the next cluster size down, as the scan's ``_plan``
    does; it raises where a smaller cluster's slice does not fit a CTA,
    and for a forced ``cs`` at once."""
    dims = (m["N"], m["D"], m["G"], m["S"], m["V"], m["K"])
    plan = chunk_plan(*dims, has_aff=bool(m["has_aff"]), cs=cs)
    if dev.type != "cuda":
        return plan
    while chunk_max_active_clusters(plan.cs, plan.smem_bytes, dev) < 1:
        why = (f"chunk_scan: the card cannot co-schedule a cluster of {plan.cs} CTAs with "
               f"{plan.smem_bytes} bytes of shared memory each")
        if cs is not None or plan.cs == 1:
            raise RuntimeError(why)
        try:
            plan = chunk_plan(*dims, has_aff=bool(m["has_aff"]), cs=plan.cs // 2)
        except ValueError as e:
            raise RuntimeError(f"{why}, and no smaller cluster holds the slice") from e
    return plan


def chunk_scan_plan(static, chunk: int, cs: Optional[int] = None) -> ChunkPlan:
    """The plan ``chunk_scan`` launches an eval of these static arrays
    with at chunk size ``chunk`` (on the card, after the occupancy
    check of ``_chunk_launch_plan``)."""
    n, d = static[0].shape
    m = {"N": n, "D": d, "G": static[2].shape[0], "S": static[10].shape[1],
         "V": static[10].shape[2], "K": chunk, "has_aff": int(static[4].shape[0] > 0)}
    dev = static[0].device if isinstance(static[0], torch.Tensor) else torch.device("cpu")
    return _chunk_launch_plan(m, cs, dev)


def _chunk_out_layout(T: int, K: int, plan: ChunkPlan):
    """The byte layout of a K5 launch's output buffer: top_idx,
    top_scores, valid, placed, then (where the plan keeps the winners'
    list out of shared memory) the list's scratch row. Returns the
    outputs' layout (``convert.Layout``), the scratch offset (or None)
    and the buffer's size."""
    layout, off = [], 0
    for dt, shape in ((np.int32, (T, K)), (np.float32, (T, K)), (np.bool_, (T, K)),
                      (np.int32, (T,))):
        off = -(-off // 16) * 16
        layout.append((off, np.dtype(dt), shape))
        off += T * (K if len(shape) == 2 else 1) * np.dtype(dt).itemsize
    pairs = None
    if not plan.list_in_smem:
        pairs = -(-off // 16) * 16
        off = pairs + chunk_list_cap(K) * 8
    return layout, pairs, off


def _launch_chunk(ptrs: Dict[str, int], m: Dict[str, int], dev: torch.device,
                  plan: ChunkPlan) -> None:
    """Launch K5 on the current stream with these pointers (``ptrs``
    holds every field of ``_CHUNK_PTR_FIELDS``) and count it."""
    m = dict(m, CS=plan.cs, per=plan.per, smem_bytes=plan.smem_bytes,
             list_cap=chunk_list_cap(m["K"]))
    args = ChunkArgs(**{k: m[k] for k in _CHUNK_INT_FIELDS},
                     soff=(ctypes.c_int * len(CHUNK_REGIONS))(*plan.soff()),
                     **{k: ptrs[k] for k in _CHUNK_PTR_FIELDS})
    source, entry = KERNELS["chunk_scan"]
    lib = _lib(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"chunk_scan launch failed: {lib.chunk_scan_error_string(err).decode()}")
    with _count_lock:
        LAUNCHES["chunk_scan"] += 1


#: the kernel's input arrays by name -> (part, index) of (static, carry, xs)
_CHUNK_INPUTS = {
    "totals": (0, 0), "reserved": (0, 1), "asks": (0, 2), "feat": (0, 3),
    "aff_score": (0, 4), "desired": (0, 5), "dh_job": (0, 6), "dh_tg": (0, 7),
    "spread_vids": (0, 9), "spread_desired": (0, 10), "spread_weights": (0, 11),
    "spread_active": (0, 13), "sum_spread_weights": (0, 14), "n_real": (0, 15),
    "used": (1, 0), "tg_counts": (1, 1), "job_counts": (1, 2), "spread_counts": (1, 3),
    "tg_idx": (2, 0), "want": (2, 1),
}


def _launch_chunk_scan(static, carry, xs, deficit, m, cs=None, sections=None):
    dev = static[0].device
    T, K = m["T"], m["K"]
    top_idx = torch.empty((T, K), dtype=I32, device=dev)
    top_scores = torch.empty((T, K), dtype=F32, device=dev)
    valid = torch.empty((T, K), dtype=BOOL, device=dev)
    placed = torch.empty(T, dtype=I32, device=dev)
    if T == 0:
        return top_idx, top_scores, valid, placed
    plan = chunk_scan_plan(static, K, cs)
    # the winners' list past shared memory: a global scratch row
    pairs = None if plan.list_in_smem else torch.empty(chunk_list_cap(K), dtype=I64, device=dev)
    parts = (static, carry, xs)
    ptrs = {k: parts[a][i].data_ptr() for k, (a, i) in _CHUNK_INPUTS.items()}
    ptrs.update(deficit=deficit.data_ptr(), top_idx=top_idx.data_ptr(),
                top_scores=top_scores.data_ptr(), valid=valid.data_ptr(),
                placed=placed.data_ptr(), pairs=0 if pairs is None else pairs.data_ptr(),
                sections=0 if sections is None else sections.data_ptr())
    _launch_chunk(ptrs, m, dev, plan)
    return top_idx, top_scores, valid, placed


#: where one eval's K5 inputs lie among the arrays of a packed buffer
#: (``pack_chunk_inputs``): the float arm's 26 static arrays, its 12 carry
#: arrays, the steps' ``tg_idx`` and ``want``, and the deficit
CHUNK_STATIC, CHUNK_CARRY, CHUNK_XS, CHUNK_DEFICIT = slice(0, 26), slice(26, 38), slice(38, 40), 40


@dataclass(frozen=True)
class PackedChunk:
    """One eval's K5 inputs in one buffer (``pack_chunk_inputs``):
    ``buf`` (uint8, on the device), the ``layout`` of its arrays
    (``convert.Layout``, in ``CHUNK_*`` order) and the sizes
    ``_check_chunk`` found (``dims``, chunk size ``K`` included)."""

    n_pad: int
    buf: torch.Tensor
    layout: convert.Layout
    dims: Dict[str, int]

    def parts(self):
        """``(static, carry, xs, deficit)`` as tensor views into ``buf``:
        a launch updates the carry and the deficit in place."""
        v = convert.unpack(self.buf, self.layout)
        return v[CHUNK_STATIC], v[CHUNK_CARRY], v[CHUNK_XS], v[CHUNK_DEFICIT]


def pack_chunk_inputs(n_pad: int, static, carry, xs, deficit, chunk: int,
                      device: convert.DeviceLike = "cuda") -> PackedChunk:
    """Check one eval's numpy K5 inputs (the float arm's ``static`` and
    ``carry``, ``xs = (tg_idx, want)``, the int32 ``deficit``) at chunk
    size ``chunk`` and move them to ``device`` as one packed buffer
    (``convert.to_device_packed``: on CUDA one copy from pinned host
    memory, on the current stream)."""
    if (len(static), len(carry), len(xs)) != (26, 12, 2):
        raise ValueError(f"chunk_scan: expected 26 static, 12 carry and 2 step arrays, got "
                         f"{len(static)}, {len(carry)} and {len(xs)}")
    arrays = tuple(np.asarray(a) for a in (*static, *carry, *xs, deficit))
    m = _check_chunk(n_pad, arrays[CHUNK_STATIC], arrays[CHUNK_CARRY], arrays[CHUNK_XS],
                     arrays[CHUNK_DEFICIT], chunk)
    buf, layout = convert.to_device_packed(arrays, device)
    return PackedChunk(n_pad, buf, layout, m)


def chunk_scan_packed(packed: PackedChunk, cs: Optional[int] = None):
    """K5 on a packed buffer (``pack_chunk_inputs``). The kernel reads the
    inputs and updates the carry and deficit in place through their
    offsets, with no tensor made per array (each tensor operation lets
    go of the GIL, which the server's worker threads contend for).
    Returns ``(out, out_layout)``: one buffer on the same device holding
    ``top_idx``, ``top_scores``, ``valid`` and ``placed``
    (``convert.from_device_packed`` brings them back with one copy). On
    the CPU the plain version runs on views of the buffer."""
    dev, m = packed.buf.device, packed.dims
    if dev.type == "cpu":
        static, carry, xs, deficit = packed.parts()
        _c, _d, ys = chunk_scan(packed.n_pad, static, carry, xs, deficit, chunk=m["K"], cs=cs)
        return convert.pack([y.numpy() for y in ys])
    if dev.type != "cuda":
        raise ValueError(f"chunk_scan_packed: unsupported device {dev}")
    plan = _chunk_launch_plan(m, cs, dev)
    out_layout, pairs, nbytes = _chunk_out_layout(m["T"], m["K"], plan)
    out = torch.empty(max(nbytes, 1), dtype=U8, device=dev)
    if m["T"] == 0:
        return out, out_layout
    base, obase, layout = packed.buf.data_ptr(), out.data_ptr(), packed.layout
    first = (CHUNK_STATIC.start, CHUNK_CARRY.start, CHUNK_XS.start)
    ptrs = {k: base + layout[first[a] + i][0] for k, (a, i) in _CHUNK_INPUTS.items()}
    ptrs.update(deficit=base + layout[CHUNK_DEFICIT][0],
                **{k: obase + o for k, (o, _dt, _s) in
                   zip(("top_idx", "top_scores", "valid", "placed"), out_layout)},
                pairs=0 if pairs is None else obase + pairs, sections=0)
    _launch_chunk(ptrs, m, dev, plan)
    return out, out_layout


def chunk_scan(n_pad: int, static, carry, xs, deficit=None, chunk: int = _chunk.CHUNK_K,
               cs: Optional[int] = None):
    """K5: one eval's chunked top-K scan, the JAX ``chunk_scan`` contract
    ``(n_pad, static, carry, xs, deficit=None) -> (carry, deficit,
    (top_idx, top_scores, valid, placed))`` with ``xs = (tg_idx, want)``
    and chunk size ``chunk`` (K, ``1 <= K <= n_pad``). The carry tensors
    and ``deficit`` (zeros when None) are updated in place and returned,
    on the CPU as on CUDA; ``static`` is the float arm's. ``cs`` forces
    the plan's cluster size (``chunk_plan``; tests, chip_smoke.py): the
    outputs do not depend on it, and on the CPU it is only checked. With
    no steps nothing is launched."""
    extra = () if deficit is None else (deficit,)
    dev = _device_of((*static, *carry, *xs, *extra))
    m = _check_chunk(n_pad, static, carry, xs, deficit, chunk)
    if deficit is None:
        deficit = torch.zeros(m["G"], dtype=I32, device=dev)
    if dev.type == "cuda":
        return carry, deficit, _launch_chunk_scan(static, carry, xs, deficit, m, cs)
    if dev.type != "cpu":
        raise ValueError(f"chunk_scan: unsupported device {dev}")
    if cs is not None:
        chunk_scan_plan(static, chunk, cs)
    new_carry, new_deficit, ys = _chunk.chunk_scan(n_pad, static, carry, xs, deficit, chunk)
    for dst, src in zip(carry, new_carry):
        dst.copy_(src)
    deficit.copy_(new_deficit)
    return carry, deficit, ys


def chunk_scan_sections(n_pad: int, static, carry, xs, deficit=None,
                        chunk: int = _chunk.CHUNK_K, cs: Optional[int] = None):
    """A ``chunk_scan`` launch on the card with section timing: returns
    its ``(carry, deficit, ys)`` and the clock64 cycles thread 0 of each
    CTA spent in each part of the steps (``CHUNK_SECTIONS``), ``[CS,
    len(CHUNK_SECTIONS)]`` int64. A diagnostic: the launch is counted
    like any other."""
    extra = () if deficit is None else (deficit,)
    dev = _device_of((*static, *carry, *xs, *extra))
    if dev.type != "cuda":
        raise ValueError("chunk_scan_sections: times the kernel on the card only")
    m = _check_chunk(n_pad, static, carry, xs, deficit, chunk)
    if deficit is None:
        deficit = torch.zeros(m["G"], dtype=I32, device=dev)
    plan = chunk_scan_plan(static, chunk, cs)
    cycles = torch.zeros((plan.cs, len(CHUNK_SECTIONS)), dtype=I64, device=dev)
    ys = _launch_chunk_scan(static, carry, xs, deficit, m, plan.cs, cycles)
    return (carry, deficit, ys), cycles


#: operations per node and step of the chunk kernel's score pass (fit,
#: distinct_hosts, binpack with its two powf, anti-affinity, affinity, the
#: key), per capacity dim, and per active spread of the task group
CHUNK_NODE_OPS = 90
CHUNK_DIM_OPS = 3
CHUNK_SPREAD_OPS = 12


def chunk_scan_work(static, carry, xs, chunk: int, placed=None) -> Tuple[int, int]:
    """(bytes, operations) one chunked scan needs at these inputs. Bytes:
    every array the kernel reads once (static, carry, deficit, the
    steps) and every output written once (final carry and deficit,
    ``[T, K]`` indices, scores and flags, ``[T]`` placed). Operations per
    step: each node scored once (``CHUNK_NODE_OPS`` + ``CHUNK_DIM_OPS``
    per dim + ``CHUNK_SPREAD_OPS`` per active spread), one compare per
    node against the K-th largest score, K log2 K to order the winners,
    and per node placed (``placed``, the run's output; none when None)
    its carry adds. Feeds the ``bound_ms`` of chip_smoke.py."""
    read = [*static[:8], static[9], static[10], static[11], static[13], static[14],
            static[15], *carry[:4], *xs]
    nbytes = sum(t.numel() * t.element_size() for t in read)
    g = static[2].shape[0]
    nbytes += 2 * 4 * g                                    # deficit in and out
    nbytes += sum(t.numel() * t.element_size() for t in carry[:4])
    t = xs[0].shape[0]
    nbytes += t * chunk * (4 + 4 + 1) + t * 4
    n, d = static[0].shape
    tg = xs[0].cpu().to(torch.int64)
    active = static[13].cpu().to(torch.int64).sum(dim=-1)  # [G]
    spreads = int(active[tg].sum()) if t else 0
    log2k = max(1, (chunk - 1).bit_length())
    ops = n * (t * (CHUNK_NODE_OPS + CHUNK_DIM_OPS * d + 1) + CHUNK_SPREAD_OPS * spreads)
    ops += t * chunk * log2k
    if placed is not None:
        ops += int(placed.sum()) * (d + 2 + static[9].shape[1])
    return nbytes, ops
