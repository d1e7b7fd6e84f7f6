"""Build the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes``.

Each library is built once per source hash into ``_build/`` beside this
file (gitignored) and published atomically, so concurrent builders of the
same source never load a half-written file, and builders of different
sources can run side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

from repro_torch.utils.spans import span

__all__ = ["CSRC_DIR", "nvcc_path", "source_digest", "build_library", "load"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc`` (its ``bin/`` also holds ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def source_digest(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """The hash a build of ``<csrc_dir>/<source>`` (or ``source``, where
    it is an absolute path) is keyed by: the first 16 hex digits of the
    SHA-256 of the file's bytes."""
    with open(os.path.join(csrc_dir, source), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def build_library(source: str, build_dir: str = _BUILD_DIR) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` (or ``source``, where it is an absolute
    path) once per source hash into ``build_dir`` and load it.  Returns
    the library and ptxas' resource report.  A failed build raises
    ``RuntimeError``.  Timed as the span ``kernels.load``."""
    with span("kernels.load", os.path.basename(source), timed=True):
        return _build_library(source, build_dir)


_LOADED: dict[str, tuple[ctypes.CDLL, str]] = {}
_LOAD_LOCKS: dict[str, threading.Lock] = {}


def load(source: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]) -> tuple[ctypes.CDLL, str]:
    """``csrc/<source>`` built (:func:`build_library`) and declared by
    ``bind``, once per process: every later call returns the same library
    and ptxas' resource report.  Thread-safe; different sources load side
    by side.  A failed build raises, and the next call tries again."""
    if source not in _LOADED:  # a published entry never changes: read it unlocked
        with _LOAD_LOCKS.setdefault(source, threading.Lock()):
            if source not in _LOADED:
                lib, log = build_library(source)
                _LOADED[source] = (bind(lib), log)
    return _LOADED[source]


def _build_library(source: str, build_dir: str) -> tuple[ctypes.CDLL, str]:
    path = os.path.join(CSRC_DIR, source)
    digest = source_digest(path)
    os.makedirs(build_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(build_dir, f"lib{stem}_{digest}.so")
    log = so + ".ptxas.txt"
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", tmp, path],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
            with open(log, "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, so)  # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    with open(log) as f:
        return ctypes.CDLL(so), f.read()
