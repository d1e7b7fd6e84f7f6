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

At scale: ``--workers N --executor process`` measures N candidates at a
time in worker processes that share the card through one timing lock
(``--retries`` re-queues a lane that crashed, hung or returned a corrupt
value); ``--shard I/N`` makes this process shard I of N processes that
share one ``--journal``; ``--learned-filter on`` measures only the part
of each wave a model trained on the journal ranks best
(``python -m repro_torch.launch.learn``).  ``python -m
repro_torch.launch.analyze`` audits what a run wrote.
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
    RetryPolicy,
    SleepingCost,
    TrialJournal,
    TuneCheckpointer,
    TuneInterrupted,
    TuningRecords,
    TuningSession,
    Workload,
    get_op,
)
from repro_torch.core.executor import EXECUTORS, stop_worker_servers
from repro_torch.core.shard import parse_shard
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
    ap.add_argument("--noise", type=float, default=0.05,
                    help="lognormal sigma of the analytical model's seeded "
                         "measurement noise (--cost analytical only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel measurement lanes per engine")
    ap.add_argument("--executor", default="sim", choices=sorted(EXECUTORS),
                    help="how lanes run: simulated clock (bit-identical), "
                         "threads, or crash-isolated worker processes that "
                         "each open the card and share its timing lock")
    ap.add_argument("--warm-start", action="store_true",
                    help="seed each search from the nearest tuned shape")
    ap.add_argument("--reload-every", type=int, default=0,
                    help="merge sibling engines' journal rows every N "
                         "measurement waves (mid-search cache sharing "
                         "between concurrent runs; 0 disables)")
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
    ap.add_argument("--learned-filter", default="off", choices=["off", "on"],
                    help="learned proposal filter (repro_torch.core.learn): "
                         "score each wave's candidates with a journal-trained "
                         "rank model and measure only the predicted-best "
                         "fraction; skipped candidates are journaled as "
                         "{'c': null, 'pred': score} provenance rows")
    ap.add_argument("--filter-keep", type=float, default=0.5,
                    help="fraction of each wave's candidates the learned "
                         "filter really measures (at least 1 per wave)")
    ap.add_argument("--filter-retrain-every", type=int, default=8,
                    help="retrain the filter's model from fresh journal "
                         "rows every N measurement waves")
    ap.add_argument("--filter-min-rows", type=int, default=32,
                    help="journal rows (same op/dtype/fingerprint) required "
                         "before the filter starts dropping candidates")
    ap.add_argument("--retries", type=int, default=1,
                    help="max measurement attempts per candidate: transient "
                         "lane failures (crash/timeout/spawn/corrupt) are "
                         "re-queued into later waves with exponential "
                         "backoff (1 = no retry)")
    ap.add_argument("--retry-backoff", type=float, default=0.25,
                    help="base backoff seconds between retry attempts "
                         "(doubled per attempt, deterministic jitter)")
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
    ap.add_argument("--shard", default="0/1",
                    help="run as shard I/N of an N-way sharded search: N "
                         "processes sharing one --journal each measure only "
                         "the candidates they own, defer the rest to their "
                         "siblings, and elect the merged best into the "
                         "records when done (default 0/1: unsharded)")
    ap.add_argument("--shard-wait", type=float, default=60.0,
                    help="seconds to wait for sibling shards' done markers "
                         "before electing over whatever reported")
    ap.add_argument("--measure-delay", type=float, default=0.0,
                    help="seconds of real lane occupancy added per "
                         "measurement (SleepingCost wrapper) — gives "
                         "interrupt tests a window to land in")
    args = ap.parse_args(argv)

    try:
        shard = parse_shard(args.shard)
    except ValueError as e:
        ap.error(str(e))
    if shard.enabled and args.journal == "none":
        ap.error("--shard needs a shared --journal (it is the shards' "
                 "only communication channel)")

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
            return get_op(space.op).analytical_cost(
                space, n_repeats=1, dtype=dtype, noise_sigma=args.noise, seed=args.seed
            )

    if args.measure_delay > 0:
        inner_factory = cost_factory

        def cost_factory(space, dtype, _inner=inner_factory):
            # real lane occupancy per measurement: the window that
            # interrupt/resume tests land a SIGTERM inside
            return SleepingCost(_inner(space, dtype), delay_s=args.measure_delay)

    retry = (
        RetryPolicy(max_attempts=args.retries, backoff_s=args.retry_backoff,
                    seed=args.seed)
        if args.retries > 1
        else None
    )
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
                n_workers=args.workers,
                warm_start=args.warm_start,
                executor=args.executor,
                reload_every=args.reload_every,
                analyze=args.analyze,
                retry=retry,
                checkpointer=checkpointer,
                resume=args.resume,
                learned_filter=args.learned_filter,
                filter_keep=args.filter_keep,
                filter_retrain_every=args.filter_retrain_every,
                filter_min_rows=args.filter_min_rows,
                shard=shard,
                shard_wait_s=args.shard_wait,
            )
    except TuneInterrupted as e:
        print(
            f"[tune] interrupted at a round boundary ({e}); snapshot flushed "
            f"to {checkpoint_dir} — rerun with --resume to continue"
        )
        sys.exit(130)
    finally:
        if args.executor == "process":
            stop_worker_servers()  # no lane's server outlives the CLI
    print(
        f"[tune] wrote {len(records)} records to {args.records} "
        f"(op={args.op} cost={args.cost} device={device} "
        f"workers={report.n_workers} executor={args.executor} "
        f"cache_hit={report.stats.cache_hit_rate():.2f} "
        f"trials_avoided={report.stats.trials_avoided} "
        f"trials_avoided_learned={report.stats.trials_avoided_learned} "
        f"learned_retrains={report.stats.n_learned_retrains} "
        f"deferred_to_sibling={report.stats.n_deferred_to_sibling} "
        f"served_by_sibling={report.stats.n_served_by_sibling} "
        f"lane_failures={report.stats.n_failures} "
        f"retries={report.stats.n_retries} "
        f"recovered={report.stats.n_transient_recovered} "
        f"respawns={report.stats.n_respawns})"
    )
    print(f"[tune] kernel_launches={json.dumps(_launch_counts(gemm.LAUNCHES, gemm0))}")
    print(f"[tune] flash_launches="
          f"{json.dumps(_launch_counts(flash_attention.LAUNCHES, flash0))}")


if __name__ == "__main__":
    main()
