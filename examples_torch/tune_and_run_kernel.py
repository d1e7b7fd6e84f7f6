"""End-to-end kernel flow through the operator registry: tune a workload
per op on the analytical H100 model, persist the records, and run both
hand-written kernels (the tiled GEMM and flash attention) on the card
under the tuned schedules, each held against its plain version.

The op registry (``repro_torch.core.ops``) is the only place that knows
what a "gemm" or a "flash" is — the tuner invocation below is identical
for both, and a new op plugs in the same way (space + cost + kernel, one
``register_op`` call).

  PYTHONPATH=src python examples_torch/tune_and_run_kernel.py [--device cpu]

On the card (the default) the kernels launch; ``--device cpu`` runs their
plain versions, and without a card the default raises.  The CLI
equivalent of the flash half:

  PYTHONPATH=src python -m repro_torch.launch.tune --op flash --cost analytical \
      --fraction 1.0 --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import Budget, TuningRecords, Workload, get_op, set_global_records
from repro_torch.core.tuners import GBFSTuner
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.gemm import gemm_plain, kernel_config_from_state
from repro_torch.kernels.ledger import launches, reset_launches

#: kernel against its plain version in float32 (the JAX package's kernel tests)
GEMM_TOL = dict(rtol=1e-4, atol=8e-4)
FLASH_TOL = dict(rtol=2e-5, atol=8e-5)
BACKEND = "analytical_h100"


def tune(wl: Workload, fraction: float = 0.01):
    """One registry-driven tuning run — identical for every op.  The
    search starts from the kernel's heuristic schedule: the paper's
    untiled start and its neighbours launch nothing on the card."""
    spec = get_op(wl.op)
    space = wl.space()
    cost = spec.analytical_cost(space, dtype=wl.dtype)
    s0 = spec.default_state(space, wl.dtype)
    res = GBFSTuner(space, cost, seed=0, s0=s0).tune(Budget(max_fraction=fraction))
    print(f"[{wl.op}] tuned {wl.dims}: {res.best_state} "
          f"(model cost {res.best_cost*1e6:.2f} us, {res.n_trials} trials)")
    return space, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu runs their plain versions)")
    args = ap.parse_args()
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernels run on the card and none is present; "
                           "pass --device cpu")
    records = TuningRecords(os.path.join(tempfile.mkdtemp(), "example.json"))

    # ---- gemm: tune, record, dispatch the kernel under the record --------------
    m = k = n = 256
    gemm_wl = Workload("gemm", (m, k, n), dtype="float32")
    space, res = tune(gemm_wl)
    records.update(gemm_wl.key(BACKEND), res.best_state, res.best_cost, "g-bfs",
                   res.n_trials)
    set_global_records(records)
    kernel_ops.set_kernel_policy(kernel_ops.KernelPolicy(cost_backend=BACKEND))
    a, b = get_op("gemm").operands(space, "float32", seed=0, device=dev)
    reset_launches()
    kernel_ops.reset_dispatch_stats()
    out = kernel_ops.gemm(a, b, device=dev)  # dispatches the tuned config
    ref = gemm_plain(a, b, kernel_config_from_state(res.best_state))
    torch.testing.assert_close(out, ref, **GEMM_TOL)
    print(f"gemm kernel vs plain max abs err: {(out - ref).abs().max().item():.2e} "
          f"(dispatch {kernel_ops.dispatch_stats()['gemm']['records']} from the record, "
          f"{launches().total()} kernel launches)")

    # ---- flash: same registry, same tuner, different op --------------------
    seq, hd = 256, 64
    flash_wl = Workload("flash", (seq, seq, hd), dtype="float32")
    # the 256-token flash space is tiny: afford a full sweep
    fspace, fres = tune(flash_wl, fraction=1.0)
    records.update(flash_wl.key(BACKEND), fres.best_state, fres.best_cost, "g-bfs",
                   fres.n_trials)
    flash = get_op("flash")
    q, kk, v = flash.operands(fspace, "float32", seed=0, device=dev)
    reset_launches()
    tuned_out = flash.kernel_run(fspace, fres.best_state, (q, kk, v))
    bq, bkv = fres.best_state.block_q, fres.best_state.block_kv
    ref = flash_attention_plain(q, kk, v, bq, bkv)
    torch.testing.assert_close(tuned_out, ref, **FLASH_TOL)
    print(f"flash kernel vs plain max abs err: {(tuned_out - ref).abs().max().item():.2e} "
          f"(block_q={bq}, block_kv={bkv}, {launches().total()} kernel launches)")
    print(f"OK: both tuned kernels match their plain versions on {dev}")


if __name__ == "__main__":
    main()
