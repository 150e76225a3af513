"""Logmon: out-of-process task log capture with rotation.

Fills the role of reference ``client/logmon`` (logmon.go + the go-plugin
subprocess launched per task via the main.go:16 init hack): the task's
stdout/stderr are FIFOs; a detached logmon process drains them into
size-rotated files ``<task>.stdout.0``, ``.1``, … in the alloc's shared
log dir, so log capture survives a client-agent restart exactly like the
task itself does (both are re-attached on recovery, not restarted).

Rotation matches the reference's logging/rotator: a file rolls when it
reaches ``max_file_size_mb``; the newest file has the highest index and
at most ``max_files`` are kept (structs.go LogConfig defaults 10 × 10MB).

Copied from ``nomad_tpu/client/logmon.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change: the module stays
standard-library only at module level, since ``spawn_logmon`` runs this
file as a bare script under ``python -S -E``.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import threading
from typing import List, Optional, Tuple


class RotatingWriter:
    """Append-only writer over ``<dir>/<base>.<index>`` with size caps."""

    def __init__(self, directory: str, base: str, max_files: int = 10,
                 max_bytes: int = 10 << 20) -> None:
        self.directory = directory
        self.base = base
        self.max_files = max(1, max_files)
        self.max_bytes = max(1, max_bytes)
        os.makedirs(directory, exist_ok=True)
        self.index = self._newest_index()
        self._fh = open(self._path(self.index), "ab")

    def _path(self, index: int) -> str:
        return os.path.join(self.directory, f"{self.base}.{index}")

    def _indexes(self) -> List[int]:
        pat = re.compile(re.escape(self.base) + r"\.(\d+)$")
        out = []
        try:
            for name in os.listdir(self.directory):
                m = pat.match(name)
                if m:
                    out.append(int(m.group(1)))
        except OSError:
            pass
        return sorted(out)

    def _newest_index(self) -> int:
        idxs = self._indexes()
        return idxs[-1] if idxs else 0

    def write(self, data: bytes) -> None:
        while data:
            room = self.max_bytes - self._fh.tell()
            if room <= 0:
                self._rotate()
                continue
            chunk, data = data[:room], data[room:]
            self._fh.write(chunk)
        self._fh.flush()

    def _rotate(self) -> None:
        self._fh.close()
        self.index += 1
        self._fh = open(self._path(self.index), "ab")
        for old in self._indexes():
            if old <= self.index - self.max_files:
                try:
                    os.unlink(self._path(old))
                except OSError:
                    pass

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


def _drain(fifo_path: str, writer: RotatingWriter) -> None:
    """Block until the task opens the FIFO, then copy until EOF."""
    try:
        # unbuffered: BufferedReader.read(n) would block until n bytes or
        # EOF, sitting on partial lines forever; raw reads return whatever
        # the pipe has
        with open(fifo_path, "rb", buffering=0) as f:
            while True:
                data = f.read(65536)
                if not data:
                    return
                writer.write(data)
    except OSError:
        pass
    finally:
        writer.close()


def run_logmon(log_dir: str, task_name: str, stdout_fifo: str, stderr_fifo: str,
               max_files: int, max_bytes: int) -> None:
    """Logmon process body: one drain thread per stream; exits when both
    streams hit EOF (task exited and closed its ends)."""
    threads = []
    for fifo, kind in ((stdout_fifo, "stdout"), (stderr_fifo, "stderr")):
        w = RotatingWriter(log_dir, f"{task_name}.{kind}", max_files, max_bytes)
        t = threading.Thread(target=_drain, args=(fifo, w), daemon=False)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    for fifo in (stdout_fifo, stderr_fifo):
        try:
            os.unlink(fifo)
        except OSError:
            pass


def spawn_logmon(
    log_dir: str,
    task_name: str,
    max_files: int = 10,
    max_bytes: int = 10 << 20,
) -> Tuple[str, str, subprocess.Popen]:
    """Create the task's stdout/stderr FIFOs and launch a detached logmon
    process draining them (go-plugin logmon launch, logmon_hook.go).
    Returns (stdout_fifo, stderr_fifo, process)."""
    os.makedirs(log_dir, exist_ok=True)
    # unique per-attempt FIFO names: an exiting logmon unlinks its own
    # FIFOs, which must never collide with a restart's fresh ones
    attempt = os.urandom(4).hex()
    stdout_fifo = os.path.join(log_dir, f".{task_name}.stdout.{attempt}.fifo")
    stderr_fifo = os.path.join(log_dir, f".{task_name}.stderr.{attempt}.fifo")
    for fifo in (stdout_fifo, stderr_fifo):
        os.mkfifo(fifo)
    # run THIS FILE as a bare script under -S -E: the module body is
    # stdlib-only, and skipping site processing + the package import
    # cuts interpreter startup from ~2s to ~30ms on a loaded box — a
    # burst of task starts must not exhaust the FIFO-attach deadline
    # queueing on interpreter startups (the reference's logmon is a
    # compiled go-plugin binary with no such cost)
    proc = subprocess.Popen(
        [
            sys.executable, "-S", "-E", os.path.abspath(__file__),
            log_dir, task_name, stdout_fifo, stderr_fifo,
            str(max_files), str(max_bytes),
        ],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        stdin=subprocess.DEVNULL,
        start_new_session=True,  # survive client restarts, like the task
    )
    return stdout_fifo, stderr_fifo, proc


def find_log_files(log_dir: str, task_name: str, kind: str) -> List[str]:
    """Sorted rotated files for one stream, oldest first."""
    pat = re.compile(re.escape(task_name) + r"\." + kind + r"\.(\d+)$")
    out = []
    try:
        for name in os.listdir(log_dir):
            m = pat.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(log_dir, name)))
    except OSError:
        return []
    return [p for _, p in sorted(out)]


def read_logs(log_dir: str, task_name: str, kind: str,
              offset: int = 0, limit: int = 1 << 20,
              origin: str = "start") -> Tuple[bytes, int]:
    """Read across the rotated file sequence as one logical stream
    (fs_endpoint.go logs semantics, simplified to non-follow).
    Returns (data, next_offset). ``origin="end"`` counts offset back from
    the stream end."""
    files = find_log_files(log_dir, task_name, kind)
    sizes = []
    total = 0
    for path in files:
        try:
            n = os.path.getsize(path)
        except OSError:
            n = 0
        sizes.append(n)
        total += n
    if origin == "end":
        offset = max(0, total - offset)
    offset = min(offset, total)
    out = bytearray()
    pos = 0
    for path, n in zip(files, sizes):
        if len(out) >= limit:
            break
        file_start = pos
        pos += n
        if pos <= offset:
            continue
        skip = max(0, offset - file_start)
        try:
            with open(path, "rb") as f:
                f.seek(skip)
                out.extend(f.read(min(limit - len(out), n - skip)))
        except OSError:
            continue
    return bytes(out), offset + len(out)


if __name__ == "__main__":
    a = sys.argv[1:]
    run_logmon(a[0], a[1], a[2], a[3], int(a[4]), int(a[5]))
