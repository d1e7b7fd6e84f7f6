"""Atomic, async checkpointing in the JAX package's format (the twin of
``repro/checkpoint/checkpointer.py``).

Layout, as the reference writes it:
    <dir>/step_<N>.tmp-<pid>/   (staging)
        manifest.json           step, time, leaf keys, metadata
        arrays.npz              leaf arrays named by the JAX key path
    <dir>/step_<N>/             (atomic rename publish)
        ... + COMMIT            marker written after the rename

Each ``arrays.npz`` member holds the bytes the reference writes for the
same tree: a bf16 leaf is the reference's 2-byte ``'<V2'`` record (what
numpy writes for JAX's bfloat16), every other leaf its numpy array.  The
port reads a ``'<V2'`` member back as ``torch.bfloat16`` through an
``int16`` view, so it restores bf16 checkpoints of either package (the
reference's own restore cannot cast ``'<V2'`` back to bfloat16, a gap
ROADMAP.md lists).

``save`` copies every leaf to the host at once (consistent with the
step, and safe from the optimizer's in-place updates that follow), then
writes on a worker thread, so training resumes at once.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_paths

__all__ = ["Checkpointer", "latest_step"]

#: numpy's descr of JAX's bfloat16 (a 2-byte void record)
_BF16_DESCR = "<V2"


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            full = os.path.join(directory, name)
            if os.path.exists(os.path.join(full, "COMMIT")):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
    return max(steps) if steps else None


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf copied to the host, as ``(array, npy descr)``."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16_DESCR
    arr = t.numpy()
    return arr, np.lib.format.dtype_to_descr(arr.dtype)


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``, npy format
    1.0), each member with the descr given beside its array."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, descr) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
                f.write(arr.tobytes())


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 records
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        self.wait()
        # snapshot to host NOW (consistency), write later (async)
        arrays = {path: _host(leaf) for path, leaf in tree_paths(tree)}
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": list(arrays.keys()),
            "metadata": metadata or {},
        }
        if self.async_save:
            self._pending = self._pool.submit(self._write, step, arrays, manifest)
        else:
            self._write(step, arrays, manifest)

    def _write(self, step: int, arrays: dict, manifest: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        staging = f"{final}.tmp-{os.getpid()}"
        os.makedirs(staging, exist_ok=True)
        _write_npz(os.path.join(staging, "arrays.npz"), arrays)
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(staging, final)  # atomic publish
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write(str(manifest["time"]))
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and "tmp" not in n
        )
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None) -> tuple[Any, dict]:
        """Write checkpoint ``step`` (the latest by default) into the
        tensors of ``template``, a tree of the saved structure whose
        leaves give each value's shape, type and device; returns
        ``(template, metadata)``."""
        self.wait()
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for key, leaf in tree_paths(template):
                if key not in z.files:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = z[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} != expected {tuple(leaf.shape)}")
                with torch.no_grad():
                    leaf.copy_(_as_tensor(arr))
        return template, manifest["metadata"]
