"""The readings the check's limits are set from, at a cell's own size on
the card, in one process (the set-up is paid once; each seed draws its
weights into the same tensors and its own batches):

* the program's numbers over many seeds (``--seeds``);
* the control's over a few (``--control-seeds``, among ``--seeds``): the
  reference put in the program's place in fp8 (``references/decoder.py``);
* the program with a fault planted (``--faults``, :mod:`perfbench.faults`
  and the cell's architecture's own), served by an engine built under it,
  on the first seed.

    python3 -m perfbench.control --workload qwen2-72b.long-prompt \\
        --seeds 11,12,13 --control-seeds 11,12,13 --batches 2 \\
        --faults stale_state,half_batch

For each it serves ``--batches`` batches of the cell's mix, draws the
check's sample from them as a run does (:func:`perfbench.judge.sample`)
and prints one JSON line: every number :data:`perfbench.judge.NUMBERS`
reads of the gaps, and ``correct`` as a run decides it
(:func:`perfbench.judge.checks`, :func:`perfbench.judge.passes`, against
the cell's limits); for a control seed the same again, prefixed
``control_``.  Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import faults, judge, specs, system, weights
from .context import BatchRecord
from .run import STATE_DIR, _failed, _serve, log, set_up

__all__ = ["numbers", "readings", "main"]


def numbers(gaps: np.ndarray) -> dict:
    """Every number that may be read of one sample's gaps."""
    return {name: read(gaps) for name, read in judge.NUMBERS.items()}


def _judged(cell, sv, engine, seed: int, n_batches: int, device, control: bool) -> dict:
    """Serve ``n_batches`` of ``seed``'s mix and judge them as a run does."""
    vocab = sv.config["vocab_size"]
    batches = []
    for i in range(n_batches):
        b = sv.mix.draw(seed, i, vocab)
        tokens = _serve(engine, b)
        batches.append(BatchRecord(b.prompts, b.lens, b.gen, tokens, 0.0, 0.0, False))
    failed = sum(_failed(b, vocab) for b in batches)
    picked = judge.sample(batches, int(cell.check["check_requests"]), sv.coupled, seed)
    t0 = time.perf_counter()
    gaps = judge.reference_gaps(sv.reference, sv.config, sv.params, batches, picked,
                                sv.coupled, device, control=control)
    limits = cell.check["limits"]
    row = {"tokens": gaps["tokens"], "reference_s": time.perf_counter() - t0,
           "failed": failed, **numbers(gaps["gap"]),
           "correct": judge.passes(judge.checks(gaps["gap"], limits), failed)}
    if control:
        row.update({f"control_{k}": v for k, v in numbers(gaps["control_gap"]).items()})
        row["control_correct"] = judge.passes(judge.checks(gaps["control_gap"], limits))
    return row


def readings(cell: specs.Cell, seeds: list, control_seeds: set, n_batches: int,
             fault_names: tuple = (), device="cuda", state_dir: str = STATE_DIR):
    """Yield one dict of readings per seed, then one per fault."""
    sv = set_up(cell, seeds[0], device, state_dir)
    for seed in seeds:
        weights.refill(sv.leaves, sv.params, sv.buffers, seed)
        yield {"cell": cell.name, "seed": seed, "run": "program",
               **_judged(cell, sv, sv.engine, seed, n_batches, device, seed in control_seeds)}
    if not fault_names:
        return
    seed = seeds[0]
    weights.refill(sv.leaves, sv.params, sv.buffers, seed)
    arch, mix = sv.arch, sv.mix
    system.release_engine(sv.engine)
    sv.engine = None
    for name in fault_names:
        gc.collect()
        with faults.planted(name, cell.architecture):
            engine = system.make_engine(arch, sv.params, mix.batch, mix.bucket, mix.gen, device)
            row = _judged(cell, sv, engine, seed, n_batches, device, False)
        system.release_engine(engine)
        del engine
        yield {"cell": cell.name, "seed": seed, "run": f"fault:{name}", **row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's readings over seeds")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated, among --seeds")
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--faults", default="",
                    help=f"comma-separated, of {', '.join(faults.FAULTS)} and the cell's "
                         "architecture's own (decoder: stale_state)")
    args = ap.parse_args(argv)
    cell = specs.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("the readings are taken on the card; none is present")
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    names = tuple(s for s in args.faults.split(",") if s)
    for row in readings(cell, seeds, ctrl, args.batches, names):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
