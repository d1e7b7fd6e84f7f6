"""Serving launcher: bucketed batched prefill + greedy decode, on the card.

  python -m repro_torch.launch.serve --arch yi-6b --reduced --device cpu \\
      --requests 4 --prompt-len 100 --gen 8 --buckets 128

* **Shape buckets** — prompts are right-padded into the smallest
  configured prompt-length bucket that holds them, so request-length
  jitter maps onto a small, enumerable set of shapes.
* **Record-aware dispatch** — prefill goes through
  ``models/common.attention_dispatch`` and ``kernels/ops.gemm``, so the
  schedules ``launch/tune.py`` recorded (flash blocks, GEMM tiles) drive
  the hand-written kernels; ``kernels.ops.dispatch_stats()`` counts
  which source drove each call.
* **Single host transfer** — decoded tokens accumulate on the device and
  are copied to the host once per ``generate`` call.

Correctness under padding: each sequence's seed logits come from its own
last real position (``Model.prefill(last_idx=...)``), pad K/V rows are
masked out of every decode step, and each sequence's decode positions
continue from its own true length (``cache["valid_len"]`` /
``cache["prefill_len"]``, see ``models/common.decode_attention``), so a
bucket-padded generation gives the tokens of the exact-shape run.

The JAX package resolves each bucket's program through a persistent AOT
executable cache; PyTorch runs eagerly, so there is none here.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models.api import Model

__all__ = ["ServeEngine"]


def _bucket_for(n: int, buckets: Optional[Sequence[int]]) -> int:
    """Smallest configured bucket that fits ``n``; ``n`` itself when no
    bucket does (an exact-shape prefill, counted as a bucket miss)."""
    if buckets:
        for b in buckets:
            if b >= n:
                return b
    return n


class ServeEngine:
    """Bucketed batched engine: fixed max batch, greedy sampling."""

    def __init__(
        self,
        cfg,
        params: dict,
        max_batch: int,
        max_len: int,
        prompt_buckets: Optional[Sequence[int]] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.model = Model(cfg, device=str(device))
        self.device = torch.device(device)
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_buckets = sorted(prompt_buckets) if prompt_buckets else None
        if self.prompt_buckets and self.prompt_buckets[-1] > max_len:
            raise ValueError(
                f"prompt bucket {self.prompt_buckets[-1]} exceeds max_len={max_len}"
            )
        self.stats = {
            "prefill_s": [],        # per generate() call
            "decode_s": [],         # per generate() call
            "prefill_buckets": {},  # bucket -> call count
            "bucket_misses": 0,     # prompts no configured bucket could hold
        }
        self.last_timing: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(
        self,
        prompts: np.ndarray,
        gen_tokens: int,
        prompt_lens: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """prompts: (B, P) int; returns (B, gen_tokens) greedy tokens.

        ``prompt_lens`` (B,) marks each row's true length when rows are
        already padded (ragged requests); defaults to full-width prompts."""
        prompts = np.asarray(prompts, np.int64)
        b, p = prompts.shape
        if b > self.max_batch:
            raise ValueError(f"{b} prompts exceed max_batch={self.max_batch}")
        lens = (np.full((b,), p, np.int64) if prompt_lens is None
                else np.asarray(prompt_lens, np.int64))
        bucket = _bucket_for(p, self.prompt_buckets)
        if self.prompt_buckets and bucket not in self.prompt_buckets:
            self.stats["bucket_misses"] += 1
        if bucket + gen_tokens > self.max_len:
            raise ValueError(f"bucket {bucket} + {gen_tokens} tokens exceed "
                             f"max_len={self.max_len}: the KV cache cannot hold them")

        toks = np.zeros((self.max_batch, bucket), np.int64)
        toks[:b, :p] = prompts
        true_len = np.full((self.max_batch,), bucket, np.int64)
        true_len[:b] = lens
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        last_idx = torch.from_numpy(true_len - 1).to(self.device)

        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(self.params, batch, self.max_len,
                                               last_idx=last_idx)
            self._sync()
            prefill_s = time.perf_counter() - t0
            cache["valid_len"] = torch.from_numpy(true_len).to(self.device)
            cache["prefill_len"] = bucket

            t0 = time.perf_counter()
            v = self.cfg.vocab_size
            tok = logits[:, -1, :v].argmax(-1)[:, None]
            out = [tok]
            # the last token needs no decode step after it
            for _ in range(gen_tokens - 1):
                logits, cache = self.model.decode_step(self.params, cache, tok)
                tok = logits[:, -1, :v].argmax(-1)[:, None]
                out.append(tok)
            tokens = torch.cat(out, dim=1).cpu().numpy()  # the one host transfer
            decode_s = time.perf_counter() - t0

        self.stats["prefill_s"].append(prefill_s)
        self.stats["decode_s"].append(decode_s)
        self.stats["prefill_buckets"][bucket] = self.stats["prefill_buckets"].get(bucket, 0) + 1
        self.last_timing = {"prefill_s": prefill_s, "decode_s": decode_s,
                            "prompt_bucket": bucket}
        return tokens[:b, :gen_tokens]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated prompt-length buckets")
    ap.add_argument("--records", default=None,
                    help="tuning records to serve schedules from: those timed "
                         "on the card (hopper_timed) on cuda, those of the "
                         "analytical model (analytical_h100) on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card is present; pass --device cpu to serve on the CPU")

    from repro_torch.core.records import TuningRecords, set_global_records
    from repro_torch.kernels import ops

    if args.records:
        set_global_records(TuningRecords(args.records))
    ops.set_kernel_policy(ops.KernelPolicy(
        cost_backend="hopper_timed" if device.type == "cuda" else "analytical_h100"))
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=str(device))
    params = model.init_params(seed=args.seed)
    buckets = [int(x) for x in args.buckets.split(",")] if args.buckets else None
    engine = ServeEngine(
        cfg, params, max_batch=args.requests,
        max_len=max([args.prompt_len] + (buckets or [])) + args.gen,
        prompt_buckets=buckets, device=device,
    )
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    ops.reset_dispatch_stats()
    out = engine.generate(prompts, args.gen)
    t = engine.last_timing
    total_new = args.requests * args.gen
    print(
        f"[serve] {args.arch}: {args.requests} requests x {args.gen} tokens "
        f"(bucket {t['prompt_bucket']}) on {device}: prefill {t['prefill_s']:.3f}s "
        f"decode {t['decode_s']:.3f}s = "
        f"{total_new / (t['prefill_s'] + t['decode_s']):.1f} tok/s (greedy); "
        f"sample: {out[0][:8].tolist()}"
    )
    print(f"[serve] dispatch_stats={ops.dispatch_stats()}")


if __name__ == "__main__":
    main()
