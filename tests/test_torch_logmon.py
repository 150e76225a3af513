"""The port's logmon (``nomad_tpu_torch/client/logmon.py``): task log
capture through FIFOs into size-rotated files, in a detached process.

1. Ports of ``tests/test_logmon_fs.py``'s ``TestRotatingWriter`` and
   ``TestLogmonProcess`` (the fs, stats and lifecycle cases need the
   Agent, which the port has not copied).
2. Against the JAX package's logmon: the same seeded byte stream, written
   in the same seeded chunks, leaves the same rotated files (names and
   bytes), through the writer and through the logmon process.
3. The module stays runnable as a bare script under ``python -S -E``: no
   import at module level outside the standard library.
"""
import ast
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu.client import logmon as jlogmon

from nomad_tpu_torch.client import logmon
from nomad_tpu_torch.client.logmon import RotatingWriter, read_logs, spawn_logmon


def wait_until(fn, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# -- 1. tests/test_logmon_fs.py's logmon cases on the port --------------------


class TestRotatingWriter:
    def test_rotation_and_pruning(self, tmp_path):
        w = RotatingWriter(str(tmp_path), "t.stdout", max_files=3, max_bytes=10)
        for i in range(10):
            w.write(b"0123456789")  # exactly one file each
        w.close()
        names = sorted(os.listdir(tmp_path))
        # newest index 9; only 3 files kept
        assert names == ["t.stdout.7", "t.stdout.8", "t.stdout.9"]

    def test_resumes_at_newest_index(self, tmp_path):
        w = RotatingWriter(str(tmp_path), "t.stdout", max_files=5, max_bytes=100)
        w.write(b"first")
        w.close()
        w2 = RotatingWriter(str(tmp_path), "t.stdout", max_files=5, max_bytes=100)
        w2.write(b"|second")
        w2.close()
        assert open(tmp_path / "t.stdout.0", "rb").read() == b"first|second"

    def test_read_logs_spans_rotated_files(self, tmp_path):
        w = RotatingWriter(str(tmp_path), "t.stdout", max_files=10, max_bytes=4)
        w.write(b"abcdefghij")
        w.close()
        data, next_off = read_logs(str(tmp_path), "t", "stdout")
        assert data == b"abcdefghij" and next_off == 10
        data, _ = read_logs(str(tmp_path), "t", "stdout", offset=6)
        assert data == b"ghij"
        data, _ = read_logs(str(tmp_path), "t", "stdout", offset=3, origin="end")
        assert data == b"hij"


class TestLogmonProcess:
    def test_capture_through_fifos(self, tmp_path):
        log_dir = str(tmp_path)
        out_fifo, err_fifo, proc = spawn_logmon(log_dir, "web", max_files=2,
                                                max_bytes=1 << 20)
        with open(out_fifo, "wb") as out, open(err_fifo, "wb") as err:
            out.write(b"hello stdout\n")
            err.write(b"hello stderr\n")
        proc.wait(timeout=10)
        wait_until(lambda: os.path.exists(os.path.join(log_dir, "web.stdout.0")))
        assert open(os.path.join(log_dir, "web.stdout.0"), "rb").read() == b"hello stdout\n"
        assert open(os.path.join(log_dir, "web.stderr.0"), "rb").read() == b"hello stderr\n"
        # fifos removed after exit
        assert not os.path.exists(out_fifo)


# -- 2. the same byte stream through both packages' logmon ---------------------


def _stream(seed, n_chunks=60):
    """Seeded chunks of seeded bytes (numpy), lengths 0-700."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(0, 700)), dtype=np.uint8).tobytes()
            for _ in range(n_chunks)]


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir()) if p.is_file()}


@pytest.mark.parametrize("seed,max_files,max_bytes", [(0, 3, 512), (1, 10, 97), (2, 1, 4096)])
def test_rotated_files_equal_the_jax_writer(tmp_path, seed, max_files, max_bytes):
    chunks = _stream(seed)
    out = {}
    for name, mod in (("port", logmon), ("jax", jlogmon)):
        d = tmp_path / name
        w = mod.RotatingWriter(str(d), "task.stdout", max_files=max_files, max_bytes=max_bytes)
        for c in chunks:
            w.write(c)
        w.close()
        out[name] = _files(d)
    assert out["port"] == out["jax"]
    assert 1 <= len(out["port"]) <= max_files
    # the kept files, oldest first, hold the stream's tail
    kept = b"".join(v for _, v in sorted(out["port"].items(),
                                         key=lambda kv: int(kv[0].rsplit(".", 1)[1])))
    assert b"".join(chunks).endswith(kept)


def test_logmon_process_files_equal_the_jax_logmon(tmp_path):
    """The same stdout and stderr streams through both packages' logmon
    processes leave the same rotated files."""
    out_chunks, err_chunks = _stream(3, 40), _stream(4, 25)
    out = {}
    for name, mod in (("port", logmon), ("jax", jlogmon)):
        d = tmp_path / name
        out_fifo, err_fifo, proc = mod.spawn_logmon(str(d), "web", max_files=4,
                                                    max_bytes=2000)
        with open(out_fifo, "wb", buffering=0) as o, open(err_fifo, "wb", buffering=0) as e:
            for c in out_chunks:
                o.write(c)
            for c in err_chunks:
                e.write(c)
        assert proc.wait(timeout=10) == 0
        out[name] = {k: v for k, v in _files(d).items() if not k.startswith(".")}
    assert out["port"] == out["jax"]
    assert out["port"] and all(len(v) <= 2000 for v in out["port"].values())
    assert sum(1 for k in out["port"] if k.startswith("web.stdout.")) <= 4


# -- 3. a bare script ----------------------------------------------------------


def test_logmon_module_imports_only_the_standard_library():
    """``spawn_logmon`` runs this file as ``python -S -E logmon.py``: its
    module-level imports are standard library modules, none of the port
    and not torch."""
    tree = ast.parse(Path(logmon.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import at module level"
            names.append((node.module or "").split(".")[0])
    assert set(names) <= set(sys.stdlib_module_names) | {"__future__"}, names
