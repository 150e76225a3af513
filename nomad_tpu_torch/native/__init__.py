"""Native (C++) runtime substrate bindings.

The reference leans on vendored native-grade infrastructure — raft-boltdb
for the log (nomad/server.go:1079), libcontainer for task isolation
(drivers/shared/executor/executor_linux.go:50). Here those are
first-party C++ (``native/`` at the top of the repo): the log library,
bound over ctypes, and the task executor, a program the exec driver
runs; ``ensure_built`` compiles them on demand with the host toolchain
and caches the artifacts.

Copied from ``nomad_tpu/native/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: the artifacts are built into
the port's own ``nomad_tpu_torch/native/_build/`` (git-ignored) from the
unedited top-level sources, by calling ``$CXX`` (default ``g++``) with the
Makefile's flags directly (``-O2 -std=c++17 -Wall``, plus ``-shared
-fPIC`` for the library), so a host without ``make`` still builds; the
check and the build run under a cross-process lock (``fcntl.flock`` on
``_build/.lock``) as well as a thread lock, because several server
processes start at once on a fresh tree; the compiler writes a temporary
file that is renamed into place, so a reader never loads or runs a
half-written artifact.
"""
from __future__ import annotations

import fcntl
import os
import shlex
import subprocess
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = {
    "libnomadlog.so": os.path.join(NATIVE_DIR, "nomadlog", "nomadlog.cpp"),
    "nomad-executor": os.path.join(NATIVE_DIR, "executor", "nomad_executor.cpp"),
}
CXXFLAGS = ("-O2", "-std=c++17", "-Wall")
# the Makefile's per-target additions
TARGET_FLAGS = {"libnomadlog.so": ("-shared", "-fPIC"), "nomad-executor": ()}
_BUILD_TIMEOUT_S = 300.0
_build_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def ensure_built(target: str) -> str:
    """Build (once) and return the path of a native artifact
    (``libnomadlog.so`` or ``nomad-executor``)."""
    src = SOURCES.get(target)
    if src is None:
        raise NativeBuildError(f"unknown native target {target!r}")
    path = os.path.join(BUILD_DIR, target)
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(src):
                    return path
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = [*shlex.split(os.environ.get("CXX", "g++")), *CXXFLAGS,
                       *TARGET_FLAGS[target], src, "-o", tmp]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True,
                                          timeout=_BUILD_TIMEOUT_S)
                except (OSError, subprocess.TimeoutExpired) as e:
                    raise NativeBuildError(f"native build of {target} failed: {e!r}") from e
                if proc.returncode != 0:
                    raise NativeBuildError(
                        f"native build of {target} failed ({' '.join(cmd)}):\n"
                        f"{proc.stdout}\n{proc.stderr}"
                    )
                os.replace(tmp, path)
                return path
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
