"""The system under test: the port's serving engine, built from a
configuration's file, and the tuning of the GEMM shapes it serves.

This module is the benchmark's only door into the program
(``repro_torch``); the plain reference never passes through it.  What the
benchmark takes from the program: the engine, its ``stats`` and counters
(``kernels.ops.dispatch_stats``, ``launch_counts``), and the kernel names
its trace shows; the planted faults patch it through :func:`patched`.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from unittest import mock

import torch

__all__ = ["arch_config", "patched", "build_kernels", "make_engine", "release_engine",
           "served_gemm_dims", "tune_records", "load_records", "dispatch_stats",
           "reset_dispatch_stats", "use_kernels_on_card", "free_cuda_state"]


def arch_config(config: dict, architecture):
    """The port's ``ArchConfig`` for a configuration file, as its
    architecture module maps it (``architectures/<name>.py``)."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**architecture.arch_fields(config))


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    """The port's ``repro_torch.<module>.<attr>`` (``attr`` may be dotted:
    ``ServeEngine.generate``) replaced by ``make(real)`` for the ``with``
    block, then restored: how a planted fault reaches the program."""
    owner = importlib.import_module(f"repro_torch.{module}")
    *outer, name = attr.split(".")
    for a in outer:
        owner = getattr(owner, a)
    with mock.patch.object(owner, name, make(getattr(owner, name))):
        yield


def use_kernels_on_card() -> None:
    """Dispatch under the records timed on the card."""
    from repro_torch.kernels import ops

    ops.set_kernel_policy(ops.KernelPolicy(cost_backend="hopper_timed"))


def build_kernels() -> None:
    """Build (or load from the checkout's build cache) both kernels."""
    from repro_torch.kernels import flash_attention, gemm

    gemm.build_kernel()
    flash_attention.build_kernel()


def make_engine(cfg, params: dict, batch: int, bucket: int, gen: int, device):
    """The engine with the cell's one prompt bucket and one gen bucket,
    its decode graph captured."""
    from repro_torch.launch.serve import ServeEngine

    return ServeEngine(cfg, params, max_batch=batch, max_len=bucket + gen,
                       prompt_buckets=[bucket], gen_buckets=[gen], device=device)


def release_engine(engine) -> None:
    """Drop the engine's decode graphs and hand their memory pool back.

    The engine has no public way to do this, and needs one twice: a graph
    pool it keeps would hold the card's memory while the reference runs,
    and the engine cannot re-capture its graph after a records change (the
    new capture goes into the pool of the graph it drops and fails), so a
    new engine is built under new records instead.  This reaches into the
    engine's private ``_programs``; a public release on the engine should
    replace it."""
    engine._programs.clear()
    free_cuda_state()


def served_gemm_dims() -> list[tuple[int, int, int]]:
    """Every ``(M, K, N)`` the GEMM kernel has launched in this process."""
    from repro_torch.kernels.ops import launch_counts

    return sorted(d for (kind, d), n in launch_counts().items() if kind == "gemm" and n)


def load_records(path: str) -> int:
    """Serve the records at ``path``; returns how many there are."""
    from repro_torch.core.records import TuningRecords, set_global_records

    rec = TuningRecords(path)
    set_global_records(rec)
    return len(rec)


def tune_records(dims: list, path: str, trials: int, device) -> dict:
    """G-BFS on each ``(M, K, N)`` in bf16, timed on the card (the tune
    command's default cost), from the kernel's heuristic state, ``trials``
    trials each.  The records are written beside ``path`` and published
    to ``path`` whole, so a run that dies here leaves no partial store.
    Returns per dims the heuristic's and the best's time in seconds."""
    from repro_torch.core import Budget, HopperTimedCost, TrialJournal, TuningRecords
    from repro_torch.core import TuningSession, Workload
    from repro_torch.kernels.gemm import default_config, state_from_config

    tmp = path + ".partial"
    if os.path.exists(tmp):
        os.unlink(tmp)
    records = TuningRecords(tmp)
    out = {}
    with TrialJournal(path + ".journal.jsonl") as journal:
        session = TuningSession(
            records, journal=journal, verbose=False, device=device,
            cost_factory=lambda space, dtype: HopperTimedCost(space, dtype=dtype, device=device))
        for m, k, n in dims:
            wl = Workload("gemm", (m, k, n), dtype="bfloat16", label=f"{m}x{k}x{n}")
            s0 = state_from_config(default_config(m, k, n), m, k, n)
            t0 = time.perf_counter()
            res = session.tune_workload(wl, "g-bfs", Budget(max_trials=trials),
                                        tuner_kwargs={"s0": s0})
            out[(m, k, n)] = (res.trials[0].cost, res.best_cost, res.n_trials,
                              time.perf_counter() - t0)
    if len(records) != len(dims):
        raise RuntimeError(f"tuning wrote {len(records)} records for {len(dims)} shapes")
    os.replace(tmp, path)
    return out


def dispatch_stats() -> dict:
    from repro_torch.kernels.ops import dispatch_stats as stats

    return stats()


def reset_dispatch_stats() -> None:
    from repro_torch.kernels.ops import reset_dispatch_stats as reset

    reset()


def free_cuda_state() -> None:
    """Hand the caching allocator's free blocks back to the card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
