"""Training launcher (the twin of ``repro/launch/train.py``): the
Trainer on one device, on the card unless ``--device cpu`` is given.

  python -m repro_torch.launch.train --arch yi-6b --reduced --device cpu \\
      --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

A rerun with the same ``--ckpt-dir`` resumes from its latest checkpoint.
The reference's ``--mesh``, ``--data-axis``, ``--model-axis`` and
``--max-restarts`` need modules the JAX package does not have
(ROADMAP.md, reference gaps); the port has none of them.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataPipeline, SyntheticLM
from repro_torch.train.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, args.seq, seed=args.seed), args.batch)
    trainer = Trainer(
        cfg, pipe, args.ckpt_dir, lr=args.lr, total_steps=args.steps,
        grad_accum=args.grad_accum, ckpt_every=args.ckpt_every, log_path=args.log,
        seed=args.seed, device=args.device,
    )
    log = trainer.train(args.steps, resume=True)
    if log:
        print(
            f"[train] {args.arch} done: step={log[-1]['step']} "
            f"loss={log[-1]['loss']:.4f} "
            f"first_loss={log[0]['loss']:.4f}"
        )


if __name__ == "__main__":
    main()
