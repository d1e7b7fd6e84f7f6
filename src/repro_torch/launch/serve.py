"""Serving launcher: bucketed batched prefill + greedy decode, with the
decode loop replayed from one CUDA graph per gen-length bucket.

  python -m repro_torch.launch.serve --arch mamba2-130m --reduced --device cpu \\
      --requests 4 --prompt-len 32 --gen 8
  python -m repro_torch.launch.serve --arch yi-6b --reduced --device cpu \\
      --requests 4 --prompt-len 100 --gen 8 --buckets 128

* **Shape buckets** — prompts of every family are right-padded into the
  smallest configured prompt-length bucket that holds them (SSM and
  hybrid state stops at each row's real length, taking in no pad token).
  Generation lengths round up to a gen-length bucket.
* **Graphed decode** — the whole greedy loop of a gen bucket ``g`` (the
  argmax of the prefill logits, then ``g - 1`` decode steps, each writing
  its argmax into a static ``(max_batch, g)`` token buffer) is captured
  once as a ``torch.cuda.CUDAGraph`` and replayed by every ``generate``
  in that bucket: one replay and one host copy per call.  This is the
  counterpart of the JAX package's per-bucket AOT decode executable (its
  ``lax.scan`` runs a g-th step whose token it drops; the graph does not
  run it).  The graph reads everything that varies from one request to
  the next from device tensors the engine owns — the KV cache or
  recurrent state, its ``len``, each sequence's real length
  (``valid_len``) and the bucket width (``prefill_len``), the prefill
  logits — and prefill writes into those same tensors, so prompt-length
  jitter never re-captures.  Capture warms the loop up once on a side
  stream first (each kernel's one-time shared-memory opt-in, the dispatch
  memo), then records it; a failed capture raises, and nothing falls back
  to an eager loop.  On the CPU (``device="cpu"``) the engine runs the
  same loop function eagerly over the same static buffers.
* **Program keys** — decode programs are keyed by the JAX package's
  fingerprint (the arch config, the kernel policy and the tuned records'
  states) and the gen bucket.  The fingerprint is taken at every call, so
  a records or policy change re-captures: a graph that dispatched under
  stale schedules is never replayed.  ``cache_report()`` gives
  ``captures`` (programs built: CUDA graphs on the card; on the CPU the
  eager loop bound to the buffers), ``replays``, ``prewarm_s`` and
  ``bucket_misses``.
* **Record-aware dispatch** — prefill (eager) goes through
  ``models/common.attention_dispatch`` and ``kernels/ops.gemm``, so the
  schedules ``launch/tune.py`` recorded (flash blocks, GEMM tiles) drive
  the hand-written kernels; ``kernels.ops.dispatch_stats()`` counts which
  source drove each call (at capture, for the graphed decode: a replay
  counts nothing, as a replayed executable counts nothing in the JAX
  package).
* **Launch accounting** — the kernels' host counters
  (``kernels.ops.launch_counts()``) tick when a wrapper is called: at a
  capture, which records a launch and runs nothing, and never at a
  replay, which runs what was recorded.  ``launch_report()`` keeps, per
  ``(kernel, dims)``, the warm-up's launches, what the captures
  recorded, and what the replays launched (each graph's record once per
  replay), so the launches a run made are the counters', less
  ``captured``, plus ``replayed``.
* **Spans** (``utils/spans.py``) — construction is timed as
  ``engine.build`` and ``engine.capture`` (``prewarm_s``); each
  ``generate`` as ``serve.generate`` over ``serve.request``,
  ``serve.program``, ``serve.prefill`` and ``serve.decode``, each carrying
  the engine's call index, and ``stats``' per-call seconds are those
  spans' own.  The prefill and decode spans end in a host sync.
* **Eager reference** — ``eager_reference`` gives the greedy tokens of
  the same requests from the same prefill inputs by the eager loop
  through the ``Model`` API on a fresh cache, with none of the engine's
  static buffers: what the graphed decode must equal.

Correctness under padding: each sequence's seed logits come from its own
last real position (``Model.prefill(last_idx=...)``), where its recurrent
state (SSM, hybrid) also stops, pad K/V rows are masked out of every
decode step, and each sequence's decode positions continue from its own
true length, so a bucket-padded generation gives the tokens of the
exact-shape run (MoE: near-identical, since pad tokens contend for expert
capacity in prefill, as in the JAX package).

The JAX package also persists its executables on disk (``cache_dir``,
``cache_capacity``) so a warm restart compiles nothing; a CUDA graph
cannot be saved, so each engine captures its buckets anew.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.records import global_records
from repro_torch.kernels.ops import kernel_policy, launch_counts
from repro_torch.models.api import Model
from repro_torch.utils.spans import span

__all__ = ["ServeEngine"]


def _bucket_for(n: int, buckets: Optional[Sequence[int]]) -> int:
    """Smallest configured bucket that fits ``n``; ``n`` itself when no
    bucket does (an exact-shape run, counted as a bucket miss)."""
    if buckets:
        for b in buckets:
            if b >= n:
                return b
    return n


class ServeEngine:
    """Bucketed batched engine: fixed max batch, greedy sampling, the
    decode loop replayed from one CUDA graph per gen bucket (see the
    module docstring)."""

    def __init__(
        self,
        cfg,
        params: dict,
        max_batch: int,
        max_len: int,
        prompt_buckets: Optional[Sequence[int]] = None,
        gen_buckets: Optional[Sequence[int]] = None,
        prewarm: Optional[bool] = None,
        device="cuda",
    ):
        with span("engine.build", timed=True):
            self.cfg = cfg
            self.model = Model(cfg, device=str(device))
            self.device = torch.device(device)
            self.params = params
            self.max_batch = max_batch
            self.max_len = max_len
            self.prompt_buckets = sorted(prompt_buckets) if prompt_buckets else None
            self.gen_buckets = sorted(gen_buckets) if gen_buckets else None
            if self.prompt_buckets:
                need = self.prompt_buckets[-1] + (self.gen_buckets[-1] if self.gen_buckets
                                                  else 0)
                if need > max_len:
                    raise ValueError(
                        f"largest prompt bucket + largest gen bucket = {need} exceeds "
                        f"max_len={max_len}; the KV cache cannot hold a full-bucket request")
            # the state every decode program reads and writes, made once: a
            # captured graph holds these addresses, and prefill writes into them
            with torch.inference_mode():
                self._cache = self.model.init_cache(max_batch, max_len)
                self._cache["valid_len"] = torch.zeros(max_batch, dtype=torch.long,
                                                       device=self.device)
                self._cache["prefill_len"] = torch.zeros((), dtype=torch.long,
                                                         device=self.device)
                self._logits = torch.zeros((max_batch, 1, cfg.padded_vocab),
                                           dtype=torch.float32, device=self.device)
            #: (fingerprint, gen bucket) -> (CUDA graph, or None on the CPU; token
            #: buffer; the launches the graph recorded)
            self._programs: dict = {}
            self._pool = None  # one memory pool for every graph (never run at once)
            self.captures = 0
            self.replays = 0
            self.prewarm_s = 0.0
            self.launches = {part: collections.Counter()
                             for part in ("warmup", "captured", "replayed")}
            self.stats = {
                "prefill_s": [],        # per generate() call
                "decode_s": [],         # per generate() call
                "prefill_buckets": {},  # bucket -> call count
                "bucket_misses": 0,     # prompts no configured bucket could hold
            }
            self.last_timing: dict = {}
        if prewarm is None:
            prewarm = bool(self.prompt_buckets or self.gen_buckets)
        if prewarm:
            self.prewarm()

    # -- decode programs ---------------------------------------------------------
    def _fingerprint(self) -> str:
        """Everything that decides what a captured decode launches besides
        the shapes: the arch config, the kernel policy, and the tuned
        records dispatch consults."""
        rec = global_records()
        raw = json.dumps(
            {
                "cfg": dataclasses.asdict(self.cfg),
                "policy": dataclasses.asdict(kernel_policy()),
                "records": {k: rec.lookup(k).get("state") for k in sorted(rec.keys())},
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha256(raw.encode()).hexdigest()[:20]

    def _reset_static(self) -> None:
        """Lengths to 0, so a warm-up run writes the cache in bounds."""
        for key in ("len", "valid_len", "prefill_len"):
            if key in self._cache:
                self._cache[key].zero_()

    def _decode_loop(self, g: int, tokens: torch.Tensor) -> None:
        """The greedy loop over the static buffers: the argmax of the
        prefill logits, then ``g - 1`` decode steps, each argmax written
        into ``tokens[:, i]``.  No host sync, so it can be captured."""
        v = self.cfg.vocab_size
        tok = self._logits[:, -1, :v].argmax(-1, keepdim=True)
        tokens[:, :1].copy_(tok)
        for i in range(1, g):
            logits, _ = self.model.decode_step(self.params, self._cache, tok)
            tok = logits[:, -1, :v].argmax(-1, keepdim=True)
            tokens[:, i:i + 1].copy_(tok)

    def _capture(self, g: int, tokens: torch.Tensor):
        """Warm the loop up once on a side stream (first launches: kernel
        builds and shared-memory opt-ins, the dispatch memo), then capture
        it.  Overwrites the static state, so it runs before a prefill.
        Returns the graph and the kernel launches it recorded."""
        before = launch_counts()
        self._reset_static()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_loop(g, tokens)
        torch.cuda.current_stream(self.device).wait_stream(side)
        warmed = launch_counts()
        self._reset_static()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._decode_loop(g, tokens)
        if self._pool is None:
            self._pool = graph.pool()
        recorded = launch_counts() - warmed
        self.launches["warmup"].update(warmed - before)
        self.launches["captured"].update(recorded)
        return graph, recorded

    def _decode_program(self, g: int):
        """The decode program of gen bucket ``g`` under the current
        fingerprint, built (captured on the card) when missing.  Programs
        of another fingerprint dispatched under stale schedules and are
        dropped."""
        fp = self._fingerprint()
        prog = self._programs.get((fp, g))
        if prog is not None:
            return prog
        self._programs = {k: v for k, v in self._programs.items() if k[0] == fp}
        with torch.inference_mode():
            tokens = torch.zeros((self.max_batch, g), dtype=torch.long, device=self.device)
            graph, recorded = (self._capture(g, tokens) if self.device.type == "cuda"
                               else (None, collections.Counter()))
        prog = self._programs[(fp, g)] = (graph, tokens, recorded)
        self.captures += 1
        return prog

    # -- warm path -----------------------------------------------------------------
    def prewarm(self) -> None:
        """Build (on the card, capture) every configured gen bucket's
        decode program now (the span ``engine.capture``, whose seconds are
        ``prewarm_s``).  Prefill runs eagerly and has no program."""
        with span("engine.capture", timed=True) as capture:
            for g in self.gen_buckets or ():
                self._decode_program(g)
        self.prewarm_s = capture.seconds

    def cache_report(self) -> dict:
        return {
            "captures": self.captures,
            "replays": self.replays,
            "prewarm_s": self.prewarm_s,
            "bucket_misses": self.stats["bucket_misses"],
        }

    def launch_report(self) -> dict:
        """Per ``(kernel, dims)``: ``warmup`` (launched while warming a
        loop up), ``captured`` (recorded into graphs, not launched) and
        ``replayed`` (launched by replays) — see the module docstring."""
        return {part: collections.Counter(c) for part, c in self.launches.items()}

    # -- serving ---------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _request(self, prompts, gen_tokens, prompt_lens, frontend_embeds) -> dict:
        """The prefill inputs of one ``generate`` call, padded to
        ``max_batch`` rows: ``batch``, ``bucket`` (the prompt width
        served), ``g`` (the gen bucket), ``b`` (the real rows), ``true_len``
        (each row's real length, frontend included) and ``width``
        (frontend plus bucket)."""
        prompts = np.asarray(prompts, np.int64)
        b, p = prompts.shape
        if b > self.max_batch:
            raise ValueError(f"{b} prompts exceed max_batch={self.max_batch}")
        lens = (np.full((b,), p, np.int64) if prompt_lens is None
                else np.asarray(prompt_lens, np.int64))
        bucket = _bucket_for(p, self.prompt_buckets)
        if frontend_embeds is not None and self.cfg.frontend != "vision_patches":
            raise ValueError(f"{self.cfg.name} takes no frontend embeddings")
        n_front = 0 if frontend_embeds is None else frontend_embeds.shape[1]
        g = _bucket_for(gen_tokens, self.gen_buckets)
        if n_front + bucket + g > self.max_len:
            raise ValueError(f"{n_front} frontend + bucket {bucket} + gen bucket {g} exceed "
                             f"max_len={self.max_len}: the KV cache cannot hold them")

        req = {"bucket": bucket, "g": g, "b": b,
               "missed": bool(self.prompt_buckets and bucket not in self.prompt_buckets)}
        toks = np.zeros((self.max_batch, bucket), np.int64)
        toks[:b, :p] = prompts
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        dt = getattr(torch, self.cfg.compute_dtype)
        if self.cfg.family == "encdec":  # the audio frontend is a stub: zeros, as in the JAX package
            batch["enc_frames"] = torch.zeros(
                (self.max_batch, self.cfg.encoder_len, self.cfg.d_model), dtype=dt,
                device=self.device)
        if n_front:
            fe = torch.zeros((self.max_batch, n_front, self.cfg.d_model), dtype=dt,
                             device=self.device)
            fe[:b] = frontend_embeds
            batch["frontend_embeds"] = fe
        req["batch"] = batch
        true_len = np.full((self.max_batch,), bucket, np.int64)
        true_len[:b] = lens
        req["true_len"] = torch.from_numpy(true_len + n_front).to(self.device)
        req["width"] = n_front + bucket
        return req

    def _prefill(self, req: dict, cache=None):
        """Prefill ``req`` into ``cache`` (a fresh cache when None):
        ``(logits, cache)``, the cache's lengths set for decode."""
        logits, cache = self.model.prefill(self.params, req["batch"], self.max_len,
                                           cache=cache, last_idx=req["true_len"] - 1)
        if "valid_len" in cache:
            cache["valid_len"].copy_(req["true_len"])
            cache["prefill_len"].fill_(req["width"])
        else:
            cache["valid_len"] = req["true_len"].clone()
            cache["prefill_len"] = torch.tensor(req["width"], device=self.device)
        return logits, cache

    def generate(
        self,
        prompts: np.ndarray,
        gen_tokens: int,
        prompt_lens: Optional[np.ndarray] = None,
        frontend_embeds: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """prompts: (B, P) int; returns (B, gen_tokens) greedy tokens.

        ``prompt_lens`` (B,) marks each row's true length when rows are
        already padded (ragged requests); defaults to full-width prompts.
        ``frontend_embeds`` (B, F, d), for a VLM: precomputed patch
        embeddings prepended to each prompt (the JAX package's engine
        serves text only, as this one does without them)."""
        call = len(self.stats["prefill_s"])  # the batch's identifier in a trace
        with span("serve.generate", call, timed=True):
            with span("serve.request", call, timed=True):
                req = self._request(prompts, gen_tokens, prompt_lens, frontend_embeds)
            bucket, g, b = req["bucket"], req["g"], req["b"]
            self.stats["bucket_misses"] += req["missed"]
            # before prefill: a capture overwrites the state
            with span("serve.program", call, timed=True):
                graph, tokens, recorded = self._decode_program(g)

            with torch.inference_mode(), span("serve.prefill", call, timed=True) as prefill:
                logits, _ = self._prefill(req, cache=self._cache)
                self._logits.copy_(logits)
                self._sync()

            with torch.inference_mode(), span("serve.decode", call, timed=True) as decode:
                if graph is not None:
                    graph.replay()
                else:
                    self._decode_loop(g, tokens)
                out = tokens.cpu().numpy()  # the one host transfer
        prefill_s, decode_s = prefill.seconds, decode.seconds
        self.replays += 1
        self.launches["replayed"].update(recorded)

        self.stats["prefill_s"].append(prefill_s)
        self.stats["decode_s"].append(decode_s)
        self.stats["prefill_buckets"][bucket] = self.stats["prefill_buckets"].get(bucket, 0) + 1
        self.last_timing = {"prefill_s": prefill_s, "decode_s": decode_s,
                            "prompt_bucket": bucket, "gen_bucket": g}
        return out[:b, :gen_tokens]

    def eager_reference(
        self,
        prompts: np.ndarray,
        gen_tokens: int,
        prompt_lens: Optional[np.ndarray] = None,
        frontend_embeds: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """The tokens ``generate`` must give for the same arguments, by
        the greedy loop run eagerly through the ``Model`` API from the
        same prefill inputs, on a fresh cache: no static buffer, no
        graph, and nothing counted in ``cache_report()``."""
        req = self._request(prompts, gen_tokens, prompt_lens, frontend_embeds)
        v = self.cfg.vocab_size
        with torch.inference_mode():
            logits, cache = self._prefill(req)
            tok = logits[:, -1, :v].argmax(-1, keepdim=True)
            out = [tok]
            for _ in range(1, req["g"]):
                logits, cache = self.model.decode_step(self.params, cache, tok)
                tok = logits[:, -1, :v].argmax(-1, keepdim=True)
                out.append(tok)
            tokens = torch.cat(out, 1).cpu().numpy()
        return tokens[:req["b"], :gen_tokens]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated prompt-length buckets to pre-warm (with "
                         "--gen as the one gen bucket)")
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
        prompt_buckets=buckets, gen_buckets=[args.gen] if buckets else None, device=device,
    )
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    ops.reset_dispatch_stats()
    out = engine.generate(prompts, args.gen)
    t = engine.last_timing
    rep = engine.cache_report()
    total_new = args.requests * args.gen
    print(
        f"[serve] {args.arch}: {args.requests} requests x {args.gen} tokens "
        f"(bucket {t['prompt_bucket']}) on {device}: prefill {t['prefill_s']:.3f}s "
        f"decode {t['decode_s']:.3f}s = "
        f"{total_new / (t['prefill_s'] + t['decode_s']):.1f} tok/s (greedy); "
        f"captures={rep['captures']} replays={rep['replays']} "
        f"prewarm={rep['prewarm_s']:.2f}s; sample: {out[0][:8].tolist()}"
    )
    print(f"[serve] dispatch_stats={ops.dispatch_stats()}")


if __name__ == "__main__":
    main()
