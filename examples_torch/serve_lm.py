"""Serving example: batched prefill + greedy decode through the unified
Model API (KV cache / recurrent state per family) and ``ServeEngine``,
whose decode loop replays one CUDA graph per gen bucket on the card.

  PYTHONPATH=src python examples_torch/serve_lm.py [--arch mamba2-130m] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.api import Model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cpu runs the kernels' plain versions)")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card is present; pass --device cpu")

    cfg = get_arch(args.arch).reduced()
    model = Model(cfg, device=args.device)
    params = model.init_params(seed=0)
    engine = ServeEngine(cfg, params, args.requests, args.prompt_len + args.gen,
                         gen_buckets=[args.gen], device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    out = engine.generate(prompts, args.gen)
    print(f"arch={args.arch} family={cfg.family} device={args.device} "
          f"{engine.cache_report()}")
    for i in range(min(2, args.requests)):
        print(f"  request {i}: prompt tail {prompts[i, -4:].tolist()} -> generated {out[i].tolist()}")
    print("OK")


if __name__ == "__main__":
    main()
