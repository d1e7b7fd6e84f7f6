"""Offline GEMM autotuning on the card — the paper's technique as a
command.

Extracts every distinct GEMM workload the arch executes at the given
shape (qkv / attn-out / ffn / lm-head, see ``ArchConfig.gemm_workloads``),
tunes them through one shared measurement engine and trial budget
(``TuningSession.tune_arch``), and writes the best configs to a
TuningRecords JSON that ``kernels/ops.py`` serves at dispatch time::

  python -m repro_torch.launch.tune --arch yi-6b --shape train_4k \\
      --tuner g-bfs --max-trials 40 --records records/yi-6b.json --warm-start

``--cost hopper`` (the default) times each candidate's kernel on the
card with CUDA events; ``--cost analytical`` uses the deterministic H100
model instead.  Candidates run on ``--device`` (default ``cuda``); the
command refuses to run where there is no card unless ``--device cpu``
is given, which only the analytical model accepts.  ``--warm-start``
seeds each search from this workload's previous best record (or the
nearest previously-tuned shape, transplanted).  Every measurement is
journaled next to the records file, so re-runs are served from cache.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json

import torch

from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.core import (
    AnalyticalHopperCost,
    Budget,
    HopperTimedCost,
    TrialJournal,
    TuningRecords,
    TuningSession,
    Workload,
)
from repro_torch.core.tuners import TUNERS
from repro_torch.kernels.gemm import LAUNCHES


def _pad_dim(x: int) -> int:
    """Round a workload dim up so its odd part is small.  The paper's
    action space only moves powers of two between loop factors, so a
    large odd part (e.g. 29568 = 2^7·231) pins a >=231-way grid split on
    that dim; the kernel pads instead.  Multiples of 2048 keep the odd
    part <= 15 for every assigned arch while wasting < 7% FLOPs."""
    if x >= 2048:
        return ((x + 2047) // 2048) * 2048
    if x >= 128:
        return ((x + 127) // 128) * 128
    return x


def workloads_for_arch(arch_name: str, shape_name: str,
                       max_tokens: int = 8192) -> list[Workload]:
    """Per-arch GEMM list.  Token count is clamped: tiling choices
    saturate well below the full 1M-token batch and the search space for
    the M dimension explodes otherwise (the records are keyed by shape,
    so serving different M re-tunes or falls back to the heuristic)."""
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    tokens = min(shape.global_batch * shape.seq_len, max_tokens)
    out = []
    for (m, k, n, tag) in cfg.gemm_workloads(1, tokens):
        m = _pad_dim(min(m, max_tokens))
        out.append(
            Workload(
                "gemm", (m, _pad_dim(k), _pad_dim(n)),
                dtype=cfg.compute_dtype, label=f"{arch_name}/{tag}",
            )
        )
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture whose GEMMs to tune")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--tuner", default="g-bfs", choices=sorted(TUNERS))
    ap.add_argument("--fraction", type=float, default=0.001)
    ap.add_argument("--max-trials", type=int, default=None,
                    help="TOTAL trial pool shared across the workloads")
    ap.add_argument("--records", default="records/tuning.json")
    ap.add_argument("--journal", default=None,
                    help="trial-journal path (default: <records>.journal.jsonl; "
                         "'none' disables the persistent cache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-start", action="store_true",
                    help="seed each search from the nearest tuned shape")
    ap.add_argument("--analyze", default="off", choices=["off", "warn", "prune"],
                    help="static schedule pre-filter (repro_torch.core.analysis): "
                         "'warn' counts advisory flags, 'prune' rejects "
                         "provably-bad candidates before they are measured")
    ap.add_argument("--cost", default="hopper", choices=["hopper", "analytical"],
                    help="cost oracle: the kernel timed on the card, or the "
                         "deterministic H100 model")
    ap.add_argument("--device", default="cuda",
                    help="where candidates run (cpu only with --cost analytical)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card is present; pass --device cpu --cost analytical "
                 "to tune against the model on the CPU")
    if args.cost == "hopper" and device.type != "cuda":
        ap.error("--cost hopper times the kernel on the card: it needs --device cuda")

    workloads = workloads_for_arch(args.arch, args.shape)
    journal_path = args.journal
    if journal_path is None:
        journal_path = args.records + ".journal.jsonl"
    journal = None if journal_path == "none" else TrialJournal(journal_path)

    if args.cost == "hopper":
        def cost_factory(space):
            return HopperTimedCost(space, n_repeats=3, seed=args.seed, device=device)
    else:
        def cost_factory(space):
            return AnalyticalHopperCost(space, n_repeats=1)

    records = TuningRecords(args.records)
    session = TuningSession(
        records, cost_factory=cost_factory, seed=args.seed, journal=journal
    )
    budget = Budget(max_fraction=args.fraction, max_trials=args.max_trials)
    launches0 = collections.Counter(LAUNCHES)
    with journal if journal is not None else contextlib.nullcontext():
        report = session.tune_arch(
            workloads=workloads,
            tuner_name=args.tuner,
            budget=budget,
            warm_start=args.warm_start,
            analyze=args.analyze,
        )
    print(
        f"[tune] wrote {len(records)} records to {args.records} "
        f"(cost={args.cost} device={device} "
        f"cache_hit={report.stats.cache_hit_rate():.2f} "
        f"trials_avoided={report.stats.trials_avoided} "
        f"lane_failures={report.stats.n_failures})"
    )
    launches = {"x".join(map(str, dims)): n - launches0[dims]
                for dims, n in sorted(LAUNCHES.items()) if n > launches0[dims]}
    print(f"[tune] kernel_launches={json.dumps(launches)}")


if __name__ == "__main__":
    main()
