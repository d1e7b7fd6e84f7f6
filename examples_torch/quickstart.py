"""Quickstart: tune a GEMM with the paper's two methods and compare with
the baselines it compares against, on the analytical H100 model — a few
minutes on the CPU.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Each search warm-starts from the kernel's heuristic state, as the tune
CLI's ``--warm-start`` does: the paper's untiled start and its
neighbours launch nothing on the card, so a cold search finds nothing
at 0.1 %.  N-A2C's networks run on ``--device`` (the card unless
``cpu`` is asked for); every cost comes from the analytical model, so
nothing is launched.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import AnalyticalHopperCost, Budget, GemmConfigSpace, TuningRecords
from repro_torch.core import TuningSession, Workload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where N-A2C's networks run (cuda needs a card)")
    args = ap.parse_args()

    # the paper's headline workload: C = A @ B at 1024^3, d = (4, 2, 4), on
    # the float32 kernel (the comparison chip_smoke.py runs on the card)
    space = GemmConfigSpace(1024, 1024, 1024)
    print(f"search space: {space.size():,} tiling configurations")
    print(f"initial (untiled) state: {space.initial_state()}")

    def noisy(space, dtype):  # the reference quickstart's noisy model
        return AnalyticalHopperCost(space, n_repeats=3, dtype=dtype, noise_sigma=0.1, seed=0)

    budget = Budget(max_fraction=0.001)  # the paper's 0.1% operating point
    for name in ["g-bfs", "n-a2c", "xgboost-like", "random"]:
        session = TuningSession(TuningRecords(), cost_factory=noisy, verbose=False,
                                device=args.device)
        wl = Workload("gemm", (1024, 1024, 1024), dtype="float32")
        res = session.tune_workload(wl, name, budget, seed=0, warm_start=True)
        # score the chosen config noise-free for a fair comparison
        final = AnalyticalHopperCost(space, dtype="float32").cost(res.best_state)
        print(
            f"{name:14s} best={final*1e6:9.2f} us  trials={res.n_trials}  "
            f"explored={res.fraction*100:.2f}%  config={res.best_state}"
        )


if __name__ == "__main__":
    main()
