"""Build, bind and launch the port's hand-written CUDA kernels.

``place_scan`` is the placement scan (``csrc/place_scan.cu``): it
replaces the JAX package's ``_make_step`` / ``_build_place_scan`` /
``_build_batched_scan`` (``nomad_tpu/tpu/engine.py:213``, ``:869``,
``:1000``). The dtype of ``totals`` picks the arm: int32 launches the
exact-integer kernel (counted as ``place_scan``), float32 the float
kernel (counted as ``place_scan_f32``). Each source under ``csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(``_build/``, keyed by the source's hash) and loaded with ``ctypes``;
every pointer and the stream go across as ``c_void_p``.

The wrappers dispatch on the device of the tensors they are given: on
the CPU they run the kernel's plain PyTorch version (``step.py``), on
CUDA they launch the kernel on the current stream or raise. Nothing
falls back from CUDA to the CPU. ``LAUNCHES`` counts kernel launches,
one per launch and nowhere else, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import step as _step

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"place_scan": CSRC / "place_scan.cu"}
#: kernel name -> (source library, C entry point)
KERNELS = {
    "place_scan": ("place_scan", "place_scan_launch"),
    "place_scan_f32": ("place_scan", "place_scan_f32_launch"),
}

#: kernel launches since the last reset, by kernel name
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


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


# -- place_scan ---------------------------------------------------------------

_INT_FIELDS = ("B", "N", "D", "G", "S", "V", "K", "DP", "V2", "P",
               "has_reserved", "has_aff", "has_evict", "has_forced")
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
    "scr_final", "scr_flags",
)


class ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in place_scan.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in _INT_FIELDS]
                + [(f, ctypes.c_void_p) for f in _PTR_FIELDS])


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    if name == "place_scan":
        for fn in (lib.place_scan_launch, lib.place_scan_f32_launch):
            fn.argtypes = [ctypes.POINTER(ScanArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.place_scan_error_string.argtypes = [ctypes.c_int]
        lib.place_scan_error_string.restype = ctypes.c_char_p
        lib.place_scan_args_size.argtypes = []
        lib.place_scan_args_size.restype = ctypes.c_int
        if lib.place_scan_args_size() != ctypes.sizeof(ScanArgs):
            raise RuntimeError("ScanArgs layout differs between kernels.py and place_scan.cu")
    return lib


I32, I64, U8, BOOL, F32 = torch.int32, torch.int64, torch.uint8, torch.bool, torch.float32
# per-spread statistics live in dynamic shared memory, 32 bytes each,
# within the 48 KB a launch gets without an opt-in attribute
_MAX_SPREADS = 1024


def _shape_check(name, t, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"place_scan: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"place_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"place_scan: {name} is not contiguous")


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
    pre_c = static_b[20].shape[2]
    if pre_c:
        raise NotImplementedError("place_scan: preemption (C > 0) is not ported")
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
             has_evict=int(DE > 0), has_forced=int(F > 0))
    return m


def _launch_place_scan(static_b, carry_b, xs_b):
    m = _check_batched(static_b, carry_b, xs_b)
    dev = static_b[0].device
    B, N, P = m["B"], m["N"], m["P"]
    float_arm = static_b[0].dtype == F32
    score_t = F32 if float_arm else I64
    chosen = torch.empty((B, P), dtype=I32, device=dev)
    scores = torch.empty((B, P), dtype=score_t, device=dev)
    pulls = torch.empty((B, P), dtype=I32, device=dev)
    skipped = torch.empty((B, P), dtype=BOOL, device=dev)
    scr_final = torch.empty((B, N), dtype=score_t, device=dev)
    scr_flags = torch.empty((B, N), dtype=U8, device=dev)
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
        "scr_final": scr_final, "scr_flags": scr_flags,
    }
    args = ScanArgs(**{k: m[k] for k in _INT_FIELDS},
                    **{k: tensors[k].data_ptr() for k in _PTR_FIELDS})
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
    evict = torch.zeros((B, P, 0), dtype=I32, device=dev)
    return carry_b, (chosen, scores, pulls, skipped, evict)


def _device_of(arrays) -> torch.device:
    devs = {t.device for t in arrays}
    if len(devs) != 1:
        raise ValueError(f"place_scan: tensors on several devices {devs}")
    return devs.pop()


def place_scan_batched(static_b, carry_b, xs_b):
    """K3: B evals of equal padded shapes in one launch, every array with
    a leading batch axis. The carry tensors are updated in place and
    returned with the stacked outputs ``(chosen, scores, pulls, skipped,
    evict)``, each ``[B, P, ...]``. On the CPU each eval runs through the
    plain version in turn and its final carry is written back."""
    dev = _device_of((*static_b, *carry_b, *xs_b))
    if dev.type == "cuda":
        return _launch_place_scan(static_b, carry_b, xs_b)
    if dev.type != "cpu":
        raise ValueError(f"place_scan: unsupported device {dev}")
    outs = []
    for b in range(static_b[0].shape[0]):
        new_carry, ys = _step.place_scan(
            static_b[0].shape[1], tuple(t[b] for t in static_b),
            tuple(t[b] for t in carry_b), tuple(t[b] for t in xs_b))
        for dst, src in zip(carry_b, new_carry):
            dst[b].copy_(src)
        outs.append(ys)
    return carry_b, tuple(torch.stack(col) for col in zip(*outs))


def place_scan(n_pad: int, static, carry, xs):
    """K1+K2: one eval's scan, the JAX ``place_scan`` contract
    ``(n_pad, static, carry, xs) -> (carry, (chosen, scores, pulls,
    skipped, evict))``. The carry tensors are updated in place and
    returned (on the CPU as on CUDA)."""
    if static[0].shape[0] != n_pad:
        raise ValueError(f"place_scan: n_pad {n_pad} != node axis {static[0].shape[0]}")
    _, ys = place_scan_batched(
        tuple(t.unsqueeze(0) for t in static), tuple(t.unsqueeze(0) for t in carry),
        tuple(t.unsqueeze(0) for t in xs))
    return carry, tuple(y[0] for y in ys)


def place_scan_work(static, carry, xs, skipped=None) -> Tuple[int, int]:
    """(bytes, operations) one eval's scan needs at these inputs: every
    input read once and every output (final carry, per-step outputs)
    written once; operations counted per node and step from the
    kernel's pass 1 and pass 2 (about 60 fixed, 3 per capacity dim, 25
    per active spread, 8 per distinct_property constraint, 1 per penalty
    slot, and in the float arm 40 more for its two ``powf``), times N,
    over the steps that ran: a step the scan's output marks ``skipped``
    (a failed task group, or a batch's padding) does no node work.
    Feeds the ``bound_ms`` of chip_smoke.py."""
    nbytes = sum(t.numel() * t.element_size() for t in (*static, *carry, *xs))
    nbytes += sum(t.numel() * t.element_size() for t in carry)
    p = xs[0].shape[0]
    nbytes += p * (4 + static[0].element_size() * (2 if static[0].dtype == I32 else 1) + 4 + 1)
    run = torch.ones(p, dtype=torch.bool) if skipped is None else ~skipped.cpu().bool()
    n, d = static[0].shape
    tg_run = xs[0].cpu().to(torch.int64)[run]
    active_per_g = static[13].cpu().to(torch.int64).sum(dim=-1)  # [G]
    spreads = int(active_per_g[tg_run].sum()) if tg_run.numel() else 0
    dp = static[17].shape[0]
    k = xs[1].shape[-1]
    per_step = 60 + 3 * d + 8 * dp + k + (40 if static[0].dtype == F32 else 0)
    ops = n * (int(tg_run.numel()) * per_step + 25 * spreads)
    return nbytes, ops


def place_scan_batched_work(static_b, carry_b, xs_b, skipped_b=None) -> Tuple[int, int]:
    """``place_scan_work`` of a K3 launch: summed over the batch's evals."""
    nbytes = ops = 0
    for b in range(static_b[0].shape[0]):
        nb, op = place_scan_work(
            tuple(t[b] for t in static_b), tuple(t[b] for t in carry_b),
            tuple(t[b] for t in xs_b), None if skipped_b is None else skipped_b[b])
        nbytes += nb
        ops += op
    return nbytes, ops
