"""One run of one benchmark cell.

    python3 -m perfbench.run --workload qwen2-72b.long-prompt --seed 7 \\
        --seconds 30 --trace 0

Set-up (counted in ``setup_s``, from process start to the window's
start): the kernels built or loaded from the checkout's build cache, the
weights drawn on the card from ``--seed``, the tuned GEMM records of the
cell loaded, the engine built with the cell's buckets (its decode graph
captured), and the mix's warm-up batches served.  A checkout's first run
of a cell finds no records: it serves the warm-up, tunes every GEMM shape
the warm-up launched (G-BFS timed on the card, the cell's trial budget),
publishes the records under ``perfbench/_state/``, loads them, builds a
new engine under them and serves the warm-up again.

The window is a closed loop of whole batches, one ``generate`` each, and
ends with the first batch that ends after ``--seconds``.  ``--trace 1``
serves the mix's first ``trace_batches`` batches under the profiler and
reports the per-layer metrics instead of the end-to-end ones; the
profiler's stop, which gathers its trace, is left out of the window's
time, and the trace is read after the window: device time by kernel and
the idle gaps (:mod:`perfbench.trace`), and device time by program span
(:mod:`perfbench.spans`), both handed to the metric readers.

After the window: the import guard, the memory peak, the engine freed,
and the check (:mod:`perfbench.judge`) of a sample of the served tokens
against the plain reference.  The last line of standard output is the
result, as JSON, with ``first_run`` (this run built the kernels and
tuned: its ``setup_s`` holds nvcc and the tuning, and is not a warm
set-up); the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.  A run exits
with a code other than 0, and prints no result, where there is no card
or too few for the cell, or where a forbidden module is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports: they are set-up

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from . import specs  # noqa: E402

sys.path.insert(0, os.path.join(specs.ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import guard, judge, spans, system, trace, weights  # noqa: E402
from .context import BatchRecord, RunContext  # noqa: E402
from .traffic import WARMUP, Mix  # noqa: E402

__all__ = ["set_up", "run_cell", "main", "STATE_DIR", "Served"]

STATE_DIR = os.path.join(specs.BENCH_DIR, "_state")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _serve(engine, batch) -> np.ndarray:
    # a copy: on the CPU the engine hands back a view of its token buffer
    return np.array(engine.generate(batch.prompts, batch.gen, prompt_lens=batch.lens))


def _failed(b: BatchRecord, vocab: int) -> int:
    """Requests of a batch served no tokens of the right shape, or a token
    outside the vocabulary."""
    if b.tokens.shape != (len(b.lens), b.gen):
        return len(b.lens)
    return int(((b.tokens < 0) | (b.tokens >= vocab)).any(axis=1).sum())


@dataclasses.dataclass
class Served:
    """A cell's set-up: the engine and what it was built from."""

    engine: object
    config: dict
    arch: object  # the port's ArchConfig the engine was built from
    mix: Mix
    params: dict
    buffers: dict
    leaves: list  # the architecture's layout of params
    reference: object
    coupled: bool
    first_run: bool


def set_up(cell: specs.Cell, seed: int, device="cuda", state_dir: str = STATE_DIR) -> Served:
    """Build or load the kernels, draw the weights, load (or, on a
    checkout's first run, tune and publish) the cell's GEMM records, build
    the engine and serve the warm-up batches."""
    config, mix = cell.config, Mix.from_file(cell.traffic)
    on_card = torch.device(device).type == "cuda"
    reference = specs.load_reference(config["reference"])
    if on_card:
        system.build_kernels()
    system.use_kernels_on_card()
    arch = system.arch_config(config, cell.architecture)
    leaves = cell.architecture.layout(config, arch.padded_vocab)
    params, bufs = weights.make_params(leaves, seed, device)
    records = os.path.join(state_dir, "records", f"{cell.name}.json")
    tuned = os.path.exists(records)
    first_run = on_card and not tuned  # builds and tunes (the CPU tunes nothing)
    if tuned:
        log(f"[setup] {system.load_records(records)} tuned records loaded from {records}")
    engine = system.make_engine(arch, params, mix.batch, mix.bucket, mix.gen, device)
    vocab = config["vocab_size"]

    def warm_up():
        for i in range(mix.warmup_batches):
            _serve(engine, mix.draw(seed, i, vocab, stream=WARMUP))

    warm_up()
    if first_run:
        dims = system.served_gemm_dims()
        t0 = time.perf_counter()
        os.makedirs(os.path.dirname(records), exist_ok=True)
        timings = system.tune_records(dims, records, int(cell.check["tune_trials"]), device)
        for d, (c0, best, n, s) in timings.items():
            log(f"[tune] {d}: heuristic {c0 * 1e3:.4f} ms -> best {best * 1e3:.4f} ms "
                f"in {n} trials, {s:.1f} s")
        log(f"[tune] {len(dims)} shapes in {time.perf_counter() - t0:.1f} s")
        system.load_records(records)
        system.release_engine(engine)  # a new engine captures under the records
        engine = system.make_engine(arch, params, mix.batch, mix.bucket, mix.gen, device)
        warm_up()
    _sync(device)
    return Served(engine, config, arch, mix, params, bufs, leaves, reference,
                  reference.couples_batch(config), first_run)


def run_cell(cell: specs.Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float = T_START, state_dir: str = STATE_DIR):
    """Set up, serve the window and check it.  Returns ``(result, ctx)``:
    the result line's dict and what the metric readers read."""
    sv = set_up(cell, seed, device, state_dir)
    engine, config, mix, params = sv.engine, sv.config, sv.mix, sv.params
    on_card = torch.device(device).type == "cuda"
    vocab = config["vocab_size"]
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s ({'first run: built and tuned' if sv.first_run else 'warm'}); "
        f"captures={engine.captures}")

    # -- the window -----------------------------------------------------------------
    system.reset_dispatch_stats()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n0 = len(engine.stats["prefill_s"])
    batches, prof = [], None
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = stack.enter_context(profile(activities=acts))
            rng_cm = stack.enter_context(contextlib.ExitStack())
            rng_cm.enter_context(torch.profiler.record_function(trace.TRACED_RANGE))
        w0 = time.perf_counter()
        i, stopping = 0, 0.0
        while True:
            batch = mix.draw(seed, i, vocab)
            tokens = _serve(engine, batch)
            batches.append(BatchRecord(batch.prompts, batch.lens, batch.gen, tokens,
                                       engine.stats["prefill_s"][n0 + i],
                                       engine.stats["decode_s"][n0 + i],
                                       traced and i < mix.trace_batches))
            i += 1
            if traced and i == mix.trace_batches:
                # the profiler's stop gathers its trace: not the window's time
                t0 = time.perf_counter()
                rng_cm.close()
                stack.pop_all().close()
                stopping = time.perf_counter() - t0
            if time.perf_counter() - w0 - stopping >= seconds and (
                    not traced or i >= mix.trace_batches):
                break
        window_s = time.perf_counter() - w0 - stopping
    for i, b in enumerate(batches):
        log(f"[window] batch {i}: prefill {b.prefill_s:.4f} s, decode {b.decode_s:.4f} s, "
            f"{int(b.lens.sum())} prompt tokens")
    found = guard.forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    dispatch = system.dispatch_stats()
    summary = by_span = None
    if prof is not None:
        summary = trace.summarize(trace.kineto_events(prof))
        by_span = spans.attribute(spans.kineto_ops(prof))
    del prof
    system.release_engine(engine)
    del engine, sv.engine
    gc.collect()
    system.free_cuda_state()

    # -- the check ----------------------------------------------------------------------
    attempted = sum(len(b.lens) for b in batches)
    failed = sum(_failed(b, vocab) for b in batches)
    picked = judge.sample(batches, int(cell.check["check_requests"]), sv.coupled, seed)
    gaps = judge.reference_gaps(sv.reference, config, params, batches, picked, sv.coupled,
                                device)
    log(f"[check] reference over {gaps['tokens']} served tokens of "
        f"{sum(len(r) for _, r in picked)} requests in {gaps['seconds']:.1f} s")
    checks = judge.checks(gaps["gap"], cell.check["limits"])
    correct = judge.passes(checks, failed)

    ctx = RunContext(config=config, architecture=cell.architecture, mix=mix, setup_s=setup_s,
                     window_s=window_s, batches=batches, dispatch=dispatch, trace=summary,
                     spans=by_span)
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        value = specs.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, "first_run": sv.first_run}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.gaps}
    result["checks"] = checks
    return result, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the window's length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specs.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    card = power_limit()
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    result["device"]["power_limit"] = card
    log(f"[card] {card}")
    for name, m in result["metrics"].items():
        log(f"[metric] {name} = {m['value']!r} {m['unit']}")
    if "busy_s" in result["device"]:
        log(f"[trace] busy_s {result['device']['busy_s']!r} of window_s "
            f"{result['device']['window_s']!r}")
    log(f"[result] correct={result['correct']} attempted={result['attempted']} "
        f"failed={result['failed']} memory_peak_bytes={result['device']['memory_peak_bytes']} "
        f"first_run={result['first_run']}")
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
