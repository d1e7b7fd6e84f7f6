"""Crash-safe tuning-session snapshots.

A tuning session holds state the journal cannot reconstruct: the G-BFS
frontier, a genetic population, N-A2C's network weights and optimizer
moments, every tuner's RNG stream, the search clock, and the budget
already spent.  :class:`TuneCheckpointer` snapshots that state at tuner
*round boundaries* — each tuner calls ``TuningContext.checkpoint(self)``
at the top of its proposal loop — with an atomic publish (staging dir →
``os.replace`` → ``COMMIT`` marker → GC), one snapshot directory per
``(workload, tuner)``.

The division of labor on resume: **the journal replays measurements,
the snapshot restores the search.**  Rounds executed after the last
snapshot but before the kill re-run deterministically because their
measurements are journal cache hits (same costs) and the tuner RNG was
restored to the same cut — so an interrupted-and-resumed run reaches
the bit-identical best state an uninterrupted run finds.

SIGTERM/SIGINT handling is cooperative: the handler only sets a flag;
the next ``checkpoint()`` call flushes a final snapshot and raises
:class:`TuneInterrupted`, which ``launch/tune.py`` turns into exit code
130.  A second signal falls back to ``KeyboardInterrupt`` so a stuck
session can still be killed interactively.

Everything here is JSON, in the JAX package's snapshot schema:
:func:`tree_to_jsonable` / :func:`tree_from_jsonable` round-trip nested
dict/list/tuple trees of numpy-array or ``torch.Tensor`` leaves exactly
(float32 values survive the float repr round trip bit-identically).  A
tensor leaf, on any device, is copied to the host first and encoded as
the numpy array it holds, so a numpy tree and the same tree of tensors
give the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = [
    "TuneCheckpointer",
    "TuneInterrupted",
    "tree_to_jsonable",
    "tree_from_jsonable",
]


class TuneInterrupted(Exception):
    """A SIGTERM/SIGINT was honoured at a round boundary; the final
    snapshot is already on disk.  Carries the workload key."""


# -- tree <-> JSON -------------------------------------------------------------

def tree_to_jsonable(tree: Any) -> Any:
    """Encode a nested dict/list/tuple tree with array leaves (numpy
    arrays, scalars, or tensors on any device) as plain JSON-serializable
    data."""
    if isinstance(tree, dict):
        return {"t": "d", "v": {k: tree_to_jsonable(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {
            "t": "l" if isinstance(tree, list) else "u",
            "v": [tree_to_jsonable(x) for x in tree],
        }
    if isinstance(tree, torch.Tensor):
        # np.asarray of a CUDA tensor raises: copy to the host first
        tree = tree.detach().cpu().numpy()
    a = np.asarray(tree)
    return {
        "t": "a",
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "v": a.ravel().tolist(),
    }


def tree_from_jsonable(data: Any, leaf: Optional[Callable] = None) -> Any:
    """Inverse of :func:`tree_to_jsonable`.  ``leaf`` converts each
    reconstructed numpy array (e.g. to a tensor on the tuner's device)."""
    t = data["t"]
    if t == "d":
        return {k: tree_from_jsonable(v, leaf) for k, v in data["v"].items()}
    if t in ("l", "u"):
        out = [tree_from_jsonable(x, leaf) for x in data["v"]]
        return out if t == "l" else tuple(out)
    a = np.asarray(data["v"], dtype=data["dtype"]).reshape(data["shape"])
    return a if leaf is None else leaf(a)


# -- the snapshot store ----------------------------------------------------------

class TuneCheckpointer:
    """Atomic per-``(workload, tuner)`` snapshot store with cooperative
    interrupt handling.

    ``every_rounds`` is the periodic cadence (snapshot when
    ``round % every_rounds == 0``); an interrupt request always flushes
    regardless of cadence.  ``keep_n`` committed snapshots are retained
    per workload (older ones GC'd) — the ``done`` snapshot written on
    workload completion is always the latest."""

    def __init__(self, directory: str, every_rounds: int = 1, keep_n: int = 2):
        self.directory = directory
        self.every_rounds = max(1, int(every_rounds))
        self.keep_n = max(1, int(keep_n))
        self._interrupted = False

    # -- interrupts ----------------------------------------------------------
    @property
    def interrupted(self) -> bool:
        return self._interrupted

    def request_interrupt(self) -> None:
        """Signal-safe: flag only; honoured at the next round boundary."""
        self._interrupted = True

    def install_signal_handlers(self) -> None:
        def handler(signum, frame):
            if self._interrupted:
                # second signal: the user means it — stop cooperating
                raise KeyboardInterrupt
            self.request_interrupt()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, handler)

    # -- layout --------------------------------------------------------------
    def _wdir(self, workload_key: str, tuner_name: str) -> str:
        ident = f"{workload_key}__{tuner_name}"
        slug = re.sub(r"[^A-Za-z0-9._=-]+", "_", ident)[:80]
        h = hashlib.blake2b(ident.encode("utf-8"), digest_size=6).hexdigest()
        return os.path.join(self.directory, f"{slug}-{h}")

    def clear(self, workload_key: str, tuner_name: str) -> None:
        """Drop all snapshots for one ``(workload, tuner)`` — a fresh
        (non-resume) run must not leave a stale ``done`` marker behind
        for a later ``--resume`` to trip over."""
        shutil.rmtree(self._wdir(workload_key, tuner_name), ignore_errors=True)

    # -- save ----------------------------------------------------------------
    def save(
        self, workload_key: str, tuner_name: str, payload: dict, step: int
    ) -> str:
        """Publish one snapshot atomically; returns the committed path."""
        d = self._wdir(workload_key, tuner_name)
        final = os.path.join(d, f"step_{step:08d}")
        staging = f"{final}.tmp-{os.getpid()}"
        os.makedirs(staging, exist_ok=True)
        with open(os.path.join(staging, "state.json"), "w") as f:
            json.dump(payload, f, separators=(",", ":"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(staging, final)  # atomic publish
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok\n")
        self._gc(d)
        return final

    def _committed_steps(self, d: str) -> list[int]:
        steps = []
        for name in os.listdir(d):
            if name.startswith("step_") and "tmp" not in name:
                if os.path.exists(os.path.join(d, name, "COMMIT")):
                    try:
                        steps.append(int(name.split("_")[1]))
                    except ValueError:
                        continue
        return sorted(steps)

    def _gc(self, d: str) -> None:
        for s in self._committed_steps(d)[: -self.keep_n]:
            shutil.rmtree(os.path.join(d, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def latest_step(self, workload_key: str, tuner_name: str) -> Optional[int]:
        d = self._wdir(workload_key, tuner_name)
        if not os.path.isdir(d):
            return None
        steps = self._committed_steps(d)
        return steps[-1] if steps else None

    def load(self, workload_key: str, tuner_name: str) -> Optional[dict]:
        """The latest committed snapshot payload, or None (no snapshot:
        resume degenerates to a fresh run, which the journal makes
        equivalent anyway)."""
        step = self.latest_step(workload_key, tuner_name)
        if step is None:
            return None
        d = self._wdir(workload_key, tuner_name)
        with open(os.path.join(d, f"step_{step:08d}", "state.json")) as f:
            return json.load(f)
