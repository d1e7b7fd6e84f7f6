"""End-to-end training example: a small LM of the chosen family trained
for a few hundred steps through the port's stack (data pipeline, AdamW,
checkpoints) on one device, reporting the loss curve.

  PYTHONPATH=src python examples_torch/train_lm.py [--arch yi-6b] [--steps 300] [--device cpu]

The reference's example also wraps the run in a straggler watchdog and a
restart loop, whose module the JAX package does not have; a rerun with
the same ``--ckpt-dir`` resumes from the latest checkpoint instead.  At
``--steps 300`` on the CPU it takes a few minutes, and the loss drops
well below uniform entropy.
"""

import argparse
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataPipeline, SyntheticLM
from repro_torch.train.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cpu runs the kernels' plain versions)")
    args = ap.parse_args()

    # a small variant of the chosen family (trainable on the CPU)
    cfg = get_arch(args.arch).reduced(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=2048,
    )
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, args.seq, seed=0), args.batch)
    trainer = Trainer(cfg, pipe, args.ckpt_dir, lr=1e-3, warmup_steps=20,
                      total_steps=args.steps, ckpt_every=100, device=args.device)
    log = trainer.train(args.steps, resume=True)
    losses = [r["loss"] for r in log]
    print(f"step   1: loss={losses[0]:.4f}")
    print(f"step {log[-1]['step']:3d}: loss={losses[-1]:.4f}")
    uniform = math.log(cfg.vocab_size)
    print(f"uniform entropy: {uniform:.4f} -> learned: {losses[-1]:.4f}")
    if losses[-1] >= uniform - 1.0:
        raise SystemExit("model failed to learn")
    print("OK")


if __name__ == "__main__":
    main()
