"""Offline kernel autotuning on the card — the paper's technique as a
command.

``--op gemm`` (the default) extracts every distinct GEMM workload the
arch executes at the given shape (qkv / attn-out / ffn / lm-head, see
``ArchConfig.gemm_workloads``); ``--op flash`` tunes the arch's causal
self-attention ``(seq, seq, head_dim)``.  Workloads are tuned through
one shared measurement engine and trial budget
(``TuningSession.tune_arch``), and the best schedules are written to a
TuningRecords JSON that ``kernels/ops.py`` serves at dispatch time::

  python -m repro_torch.launch.tune --arch yi-6b --shape train_4k \\
      --tuner g-bfs --max-trials 40 --records records/yi-6b.json --warm-start
  python -m repro_torch.launch.tune --op flash --arch yi-6b \\
      --max-trials 20 --records records/yi-6b.json --warm-start

``--tuner`` picks one of the eight searches of ``core.tuners.TUNERS``
(the paper's ``g-bfs`` and ``n-a2c``, its baselines ``xgboost-like``
and ``rnn-controller``, and ``random``, ``grid``, ``sim-anneal``,
``genetic``).  ``--cost hopper`` (the default) times each candidate's
kernel on the card with CUDA events; ``--cost analytical`` uses the
deterministic H100 model instead.  Candidates, and the networks of
``n-a2c`` and ``rnn-controller``, run on ``--device`` (default
``cuda``); the command refuses to run where there is no card unless
``--device cpu`` is given, which only the analytical model accepts.
``--warm-start`` seeds each search from this workload's previous best
record (or the nearest previously-tuned shape, transplanted, or the
kernel's heuristic state).  Every measurement is journaled next to the
records file, so re-runs are served from cache.

Each search is snapshotted at its tuner's round boundaries under
``--checkpoint-dir`` (default ``<records>.tunestate``).  SIGTERM or
SIGINT flushes a final snapshot at the next boundary and exits with
code 130; ``--resume`` continues every workload from its snapshot
(finished ones are served from their done marker), and reaches the same
records an uninterrupted run writes::

  python -m repro_torch.launch.tune --arch yi-6b --tuner n-a2c \\
      --device cpu --cost analytical --max-trials 60 --records /tmp/r.json
  python -m repro_torch.launch.tune ... --resume   # after a SIGTERM
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
from typing import Optional

import torch

from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.core import (
    Budget,
    HopperTimedCost,
    SleepingCost,
    TrialJournal,
    TuneCheckpointer,
    TuneInterrupted,
    TuningRecords,
    TuningSession,
    Workload,
    get_op,
)
from repro_torch.core.tuners import TUNERS
from repro_torch.kernels import flash_attention, gemm


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


def flash_workloads_for_arch(arch_name: Optional[str], shape_name: str,
                             max_seq: int = 8192) -> list[Workload]:
    """Flash-attention workload list: the arch's causal self-attention
    shape ``(seq, seq, head_dim)`` at the given shape, timed on one
    sequence of the arch's query and kv heads, or a default 4k/128 shape
    on one head when no arch is named."""
    shape = get_shape(shape_name)
    seq = _pad_dim(min(shape.seq_len, max_seq))
    if arch_name is None:
        head_dim, dtype, label, heads = 128, "bfloat16", f"flash/s{seq}", {}
    else:
        cfg = get_arch(arch_name)
        head_dim = cfg.resolved_head_dim
        dtype = cfg.compute_dtype
        label = f"{arch_name}/flash_s{seq}"
        heads = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads or cfg.n_heads}
    return [Workload("flash", (seq, seq, head_dim), dtype=dtype, label=label,
                     space_kwargs=heads)]


def _launch_counts(counter: collections.Counter, before: collections.Counter) -> dict:
    return {"x".join(map(str, dims)): n - before[dims]
            for dims, n in sorted(counter.items()) if n > before[dims]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="gemm", choices=["gemm", "flash"],
                    help="which kernel's schedules to tune")
    ap.add_argument("--arch", default=None,
                    help="architecture whose workloads to tune "
                         "(required for --op gemm)")
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
                    help="where candidates and the learned tuners' networks run "
                         "(cpu only with --cost analytical)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="crash-safe session snapshot directory (default: "
                         "<records>.tunestate; 'none' disables snapshots)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="snapshot the search every N tuner rounds")
    ap.add_argument("--resume", action="store_true",
                    help="restore each workload's search from its latest "
                         "snapshot (finished workloads are served from "
                         "their done marker); measurements replay from "
                         "the journal, so the resumed search reaches the "
                         "same best state as an uninterrupted run")
    ap.add_argument("--measure-delay", type=float, default=0.0,
                    help="seconds of real lane occupancy added per "
                         "measurement (SleepingCost wrapper) — gives "
                         "interrupt tests a window to land in")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card is present; pass --device cpu --cost analytical "
                 "to tune against the model on the CPU")
    if args.cost == "hopper" and device.type != "cuda":
        ap.error("--cost hopper times the kernel on the card: it needs --device cuda")

    if args.op == "gemm":
        if args.arch is None:
            ap.error("--op gemm needs --arch (whose GEMMs to tune)")
        workloads = workloads_for_arch(args.arch, args.shape)
    else:
        workloads = flash_workloads_for_arch(args.arch, args.shape)
    journal_path = args.journal
    if journal_path is None:
        journal_path = args.records + ".journal.jsonl"
    journal = None if journal_path == "none" else TrialJournal(journal_path)

    if args.cost == "hopper":
        def cost_factory(space, dtype):
            return HopperTimedCost(space, n_repeats=3, dtype=dtype, seed=args.seed,
                                   device=device)
    else:
        def cost_factory(space, dtype):
            return get_op(space.op).analytical_cost(space, n_repeats=1, dtype=dtype)

    if args.measure_delay > 0:
        inner_factory = cost_factory

        def cost_factory(space, dtype, _inner=inner_factory):
            # real lane occupancy per measurement: the window that
            # interrupt/resume tests land a SIGTERM inside
            return SleepingCost(_inner(space, dtype), delay_s=args.measure_delay)

    checkpoint_dir = args.checkpoint_dir
    if checkpoint_dir is None:
        checkpoint_dir = args.records + ".tunestate"
    checkpointer = (
        None
        if checkpoint_dir == "none"
        else TuneCheckpointer(checkpoint_dir, every_rounds=args.checkpoint_every)
    )
    if checkpointer is not None:
        checkpointer.install_signal_handlers()

    records = TuningRecords(args.records)
    session = TuningSession(
        records, cost_factory=cost_factory, seed=args.seed, journal=journal,
        device=device,
    )
    budget = Budget(max_fraction=args.fraction, max_trials=args.max_trials)
    gemm0 = collections.Counter(gemm.LAUNCHES)
    flash0 = collections.Counter(flash_attention.LAUNCHES)
    try:
        with journal if journal is not None else contextlib.nullcontext():
            report = session.tune_arch(
                workloads=workloads,
                tuner_name=args.tuner,
                budget=budget,
                warm_start=args.warm_start,
                analyze=args.analyze,
                checkpointer=checkpointer,
                resume=args.resume,
            )
    except TuneInterrupted as e:
        print(
            f"[tune] interrupted at a round boundary ({e}); snapshot flushed "
            f"to {checkpoint_dir} — rerun with --resume to continue"
        )
        sys.exit(130)
    print(
        f"[tune] wrote {len(records)} records to {args.records} "
        f"(cost={args.cost} device={device} "
        f"cache_hit={report.stats.cache_hit_rate():.2f} "
        f"trials_avoided={report.stats.trials_avoided} "
        f"lane_failures={report.stats.n_failures})"
    )
    print(f"[tune] kernel_launches={json.dumps(_launch_counts(gemm.LAUNCHES, gemm0))}")
    print(f"[tune] flash_launches="
          f"{json.dumps(_launch_counts(flash_attention.LAUNCHES, flash0))}")


if __name__ == "__main__":
    main()
