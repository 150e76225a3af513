"""Artifact fetching — the go-getter core the reference's artifact hook
uses (client/allocrunner/taskrunner/artifact_hook.go:1-60; jobspec
``artifact`` stanza).

Supported sources: ``http://``, ``https://`` and ``file://``. Supported
options: ``checksum`` ("sha256:<hex>", "sha512:<hex>", "md5:<hex>" or a
bare hex digest, length-detected — go-getter's checksum query/option),
``archive`` ("false" disables auto-unpack). Archives (.zip, .tar,
.tar.gz/.tgz, .tar.bz2) unpack into the destination directory, matching
go-getter's decompressor behavior. Destinations resolve inside the task
directory and path escapes are rejected (the reference validates the
same way).

Copied from ``nomad_tpu/client/artifacts.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.request
import zipfile
from typing import Callable, Dict, Optional


class ArtifactError(Exception):
    """Fetch/verify failure — fails the task per its restart policy, like
    the reference's artifact hook error."""


_HASHES = {"md5": hashlib.md5, "sha1": hashlib.sha1,
           "sha256": hashlib.sha256, "sha512": hashlib.sha512}
_HEX_LEN_TO_ALGO = {32: "md5", 40: "sha1", 64: "sha256", 128: "sha512"}

_ARCHIVE_SUFFIXES = (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2")


def _checksum_spec(options: Dict[str, str]):
    spec = (options or {}).get("checksum", "")
    if not spec:
        return None
    if ":" in spec:
        algo, _, want = spec.partition(":")
        algo = algo.strip().lower()
    else:
        want = spec
        algo = _HEX_LEN_TO_ALGO.get(len(spec.strip()), "")
    want = want.strip().lower()
    if algo not in _HASHES:
        raise ArtifactError(f"unsupported checksum type in {spec!r}")
    return algo, want


def _verify(path: str, algo: str, want: str) -> None:
    h = _HASHES[algo]()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    got = h.hexdigest()
    if got != want:
        raise ArtifactError(
            f"checksum mismatch: got {algo}:{got}, want {algo}:{want}"
        )


def _is_archive(name: str) -> bool:
    low = name.lower()
    return any(low.endswith(s) for s in _ARCHIVE_SUFFIXES)


def _safe_join(root: str, *parts: str) -> str:
    dest = os.path.realpath(os.path.join(root, *parts))
    root_real = os.path.realpath(root)
    if dest != root_real and not dest.startswith(root_real + os.sep):
        raise ArtifactError(f"artifact destination escapes task dir: {parts}")
    return dest


def _unpack(archive: str, dest_dir: str) -> None:
    low = archive.lower()
    if low.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            for member in z.namelist():
                _safe_join(dest_dir, member)  # zip-slip guard
            z.extractall(dest_dir)
        return
    mode = "r"
    if low.endswith((".tar.gz", ".tgz")):
        mode = "r:gz"
    elif low.endswith((".tar.bz2", ".tbz2")):
        mode = "r:bz2"
    with tarfile.open(archive, mode) as t:
        for member in t.getmembers():
            _safe_join(dest_dir, member.name)
        # filter="data" (3.12+) also blocks symlink-escape members the
        # name check can't see; no insecure fallback
        t.extractall(dest_dir, filter="data")


def fetch_artifact(art: Dict, task_root: str,
                   interp: Optional[Callable[[str], str]] = None,
                   timeout: float = 30.0) -> str:
    """Fetch one ``artifact`` stanza into the task directory; returns the
    destination path. ``interp`` applies env interpolation to the source
    and destination strings (taskenv, like the reference)."""
    interp = interp or (lambda s: s)
    source = interp(str(art.get("source", "")))
    if not source:
        raise ArtifactError("artifact has no source")
    options = {k: interp(str(v)) for k, v in (art.get("options") or {}).items()}
    dest_rel = interp(str(art.get("destination", "") or "local"))
    dest_dir = _safe_join(task_root, dest_rel)
    os.makedirs(dest_dir, exist_ok=True)

    checksum = _checksum_spec(options)

    if source.startswith("file://"):
        src_path = source[len("file://"):]
        if not os.path.exists(src_path):
            raise ArtifactError(f"artifact source not found: {src_path}")
        fname = os.path.basename(src_path)
        local_path = os.path.join(dest_dir, fname)
        shutil.copy(src_path, local_path)
    elif source.startswith(("http://", "https://")):
        fname = os.path.basename(source.split("?", 1)[0]) or "artifact"
        local_path = os.path.join(dest_dir, fname)
        try:
            req = urllib.request.Request(source, headers={"User-Agent": "nomad-tpu"})
            with urllib.request.urlopen(req, timeout=timeout) as resp, \
                    open(local_path, "wb") as out:
                shutil.copyfileobj(resp, out)
        except ArtifactError:
            raise
        except Exception as e:  # noqa: BLE001 — network errors fail the fetch
            raise ArtifactError(f"artifact download failed: {e}") from e
    else:
        raise ArtifactError(f"unsupported artifact source scheme: {source!r}")

    if checksum is not None:
        _verify(local_path, *checksum)

    if _is_archive(fname) and options.get("archive", "").lower() != "false":
        _unpack(local_path, dest_dir)
        os.unlink(local_path)

    return dest_dir
