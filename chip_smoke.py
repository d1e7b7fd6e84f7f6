"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: tune -> record ->
dispatch for yi-6b's five GEMMs and its prefill attention at full width,
through the hand-written GEMM and flash-attention kernels, yi-6b served
at full width on the tuned records with its decode replayed from a CUDA
graph, the paper's tuners (N-A2C and its baselines) compared on the GEMM
kernel, the tuner at scale (worker processes sharing the card, planted
faults, sharded search, the learned filter and the audit), one model of
every other family of the zoo served at full width, yi-6b trained at
its published widths with the GEMM kernel in the backward pass (under
remat ``full``, and under ``dots``, which saves every product), the
paper's tuners head to head through ``TuningSession.compare``, and the
single-card dry run: every (arch x shape) cell's roofline from a trace on
the meta device, and yi-6b's steps counted on the card against it.

    python3 chip_smoke.py
    python3 chip_smoke.py --search-only [path/to/src]   # phases 11(b), 16(d) alone

Phases (each prints its wall time):

  1. build both kernels (``src/repro_torch/kernels/csrc/*.cu``) and
     variants of each with a planted fault (its source with one line
     changed, built in a temporary directory), one nvcc per source, all
     started together; count the tensor-core instructions (``HGMMA``,
     ``HMMA``) of each bf16 instantiation of both kernels in
     ``cuobjdump -sass`` of the built library (fails on a count of 0), and
     print ptxas' registers, spills and injected ``warpgroup.arrive``s for
     them (the GEMM's ``wgmma`` instantiations must have neither spills
     nor injected arrives; phase 9 prints the served flash instantiation's);
     a ``[sass]`` line for each of the 16 f32 SIMT instantiations
     (FFMA, LDS.128, LDGSTS.128 and LDG.E.128 counts, registers, spills),
     failing on a spill, on no 16-byte cp.async, or on no LDS.128 where
     reg_m or reg_n is 4 or more;
  2. hold the GEMM kernels against their plain PyTorch version on small
     products: every compiled instantiation's launch limit against the
     analyzer's, the f32 ring (stages and shared-memory bytes the
     kernel launches a tile with) against ``analysis.gemm_stages`` /
     ``gemm_smem_bytes``, the f32 SIMT kernel under several configs and
     every register tile under one stage and under a ring of 4 over 4 or
     more slabs (``kernels.gemm.simt_ring_configs``), every bf16
     ``wgmma`` instantiation with one and two warpgroups, the bf16
     bandwidth kernel at M = 8 and 16, and the autograd backward; then see
     the limits refuse the three planted GEMM faults (the f32 one at
     1024^3);
  3. tune the five yi-6b bf16 GEMMs (8192 tokens) and one decode product,
     (8, 4096, 11008), with G-BFS on times measured on the card, each
     seeded from the kernel's heuristic state;
  4. rerun the tune CLI with ``--warm-start`` on the same records;
  5. reload the records and serve every tuned shape through ``gemm()``,
     checked against an f32 ``torch.matmul``;
  6. hold the GEMM kernel against the plain version at full width and time
     the kernel, the plain version and ``torch.matmul``: each tuned shape
     under its record, and the shapes yi-6b's serve runs (prefill at
     M = 32768, decode at M = 8) under the config dispatch gives them; see
     the bf16 limit refuse both planted faults at full width;
  7. check the flash kernel: each instantiation's launch limit equals the
     analyzer's, kernel vs plain on small shapes (the blocks of each
     dtype's list, f32 and bf16, causal and full, G in {1, 4, 8}, every
     head_dim, and the bf16 block_kv of 48, 80, 96 and 112 on sequences
     they divide), the wrapper refuses indivisible blocks, and the bf16
     limit refuses both planted faults; then the f32 kernel (CUDA cores,
     on no served path) timed at one shape it checks against SDPA in
     f32, its own ``kernels`` row (``flash_f32[...]``);
  8. tune yi-6b's prefill attention (4096, 4096, 128) bf16 with G-BFS on
     times measured on the card, seeded from the kernel's heuristic
     blocks, then rerun ``tune --op flash --warm-start`` on the same
     records;
  9. serve yi-6b at full width (32 layers, random bf16 weights from a
     seeded generator on the card) on the records of phases 3-4 and 8,
     through ``ServeEngine``'s prewarm (which captures the gen-16 decode
     loop as one CUDA graph) and graphed decode: 8 requests of ragged
     prompts in [2049, 4096], padded to the bucket 4096, 16 greedy tokens
     each; the tokens must equal the eager loop's on the same prefill,
     and a second request of other lengths in the bucket must capture
     nothing and replay once more; then trace one more ``generate`` with
     ``torch.profiler`` (its prefill, and one replay of the graph) for the
     device time of each kernel kind and the idle share of each range;
     then hold the GEMM kernel, under the config dispatch chose, against
     an f32 ``torch.matmul`` at every shape the serve launched it on;
 10. hold the flash kernel under the served blocks against the plain
     version on one layer's q/k/v (and see the limit refuse both planted
     faults there), time the kernel, the plain version and
     ``scaled_dot_product_attention`` (the yardstick, used nowhere in the
     port), and hold the reduced yi-6b served on the card against the
     same model on the CPU (plain versions);
 11. the paper's tuners on the card: (a) N-A2C through the tune CLI
     (``--tuner n-a2c --cost hopper --device cuda --warm-start``, a
     snapshot every round) over yi-6b's five bf16 GEMMs, and through the
     session on the decode product (8, 4096, 11008), which the CLI's
     workload list does not hold, warm-started (the warm start skips the
     tuned shapes' tiles M = 8 cannot launch), onto the same fresh records
     and journal; each workload's trials, launchable share, ``c_ref`` and
     best time, then the decode product served through ``gemm()`` from
     the records and held against its plain version at the bf16 limit;
     (b) Fig. 7's operating point: every tuner of ``TUNERS`` once, seed 0,
     on 1024^3 float32 (the SIMT kernel), 0.1 % of the space (899 trials)
     on times measured on the card, ``analyze="prune"``, each through
     ``TuningSession.tune_workload(warm_start=True)``; a ``[paper]`` line
     per tuner with its best state re-timed (20 launches, L2 flushed, card
     spun) and held against the plain version, the headline ratios, and
     two yardsticks: ``torch.matmul`` in float32 without TF32 and the
     bound 2·1024^3 over the FP32 CUDA-core peak (66.9 TFLOP/s, H100 SXM
     data sheet); (c) N-A2C twice with its networks on the card, on the
     float32 H100 model at 256^3: the two trial sequences must be equal;
 12. the tuner at scale, at yi-6b's full width: (a) G-BFS over the five
     bf16 GEMMs, the decode product and the prefill attention through
     ``ProcessExecutor`` worker processes, each with its own CUDA context,
     timing the kernels through the card's one timing gate, on a measured
     backend wrapped in a seeded ``FaultPlan`` (crash, hang past the lane
     timeout, corrupt value; fires once each) with retries: once with one
     lane and once with four; every transient recovered, respawns at least
     the planted crashes, no timed region overlapping another (the gate's
     own count), each best state within the bf16 limit of its plain
     version and served by dispatch from the records; (b) two concurrent
     ``tune --shard 0/2`` / ``1/2`` processes over one journal: disjoint
     measured sets, one elected record a workload, the lowest cost of the
     union; (c) ``learn train`` and ``eval`` on the journals of 11(a) and
     12(a), the analytical H100 model's rank correlation with the measured
     times, and one ``tune --learned-filter on`` rerun, which must skip
     candidates; (d) ``analyze --strict`` over every store of (a)-(c):
     exit 0 and ``permanent_for_legal=0``;
 13. serve one arch of each family the port added, through ``ServeEngine``
     with the graphed decode, each freed before the next (random bf16
     weights from a seeded generator, 16 tokens): whisper-tiny (encdec, 8 x
     bucket 128, 1500 zero encoder frames), mamba2-130m (ssm) and
     zamba2-1.2b (hybrid) at 8 x 4096 exact, qwen3-moe-235b-a22b (moe) at
     its published widths and 8 of its 94 layers (470 GB in bf16 whole),
     8 x bucket 4096, and llava-next-34b (vlm) at 2 x (576 patch
     embeddings + bucket 3520); per arch prefill and decode seconds,
     tokens/s, peak memory, the GEMM dispatch split and both kernels'
     launches; the tokens must lie in [0, vocab) and equal the eager
     loop's, the GEMM kernel must launch in every prefill and every decode
     graph (a batch under 8 on zero-padded rows), and flash on every
     prompt above 2048 tokens without a softcap; then one more generate
     of each, traced as in phase 9; then, the model freed, hold the GEMM
     kernel under the config dispatch chose against an f32
     ``torch.matmul`` at every shape the serve launched it on, and the
     flash kernel under the blocks dispatch chose against its plain
     version at every served attention shape (qwen3-moe's 16 query heads
     a KV head, llava's 7, zamba2's head_dim 64);
 14. train yi-6b at its published widths with 16 of its 32 layers (AdamW
     with f32 master weights for all 32 would take 97 GB), bf16, remat
     ``full``, on ``SyntheticLM`` batches of 2 x 4096 tokens, through
     ``Trainer``: (a) three steps (loss, grad_norm, step seconds; then
     tokens/s, peak memory and the model-flops share, 6·N·tokens plus the
     causal attention over 989 TFLOP/s), the dispatch split and the GEMM
     launches by shape and part of the step (forward, remat recompute, dA,
     dB); flash must launch nowhere (it has no backward: attention runs
     chunked); (b) one more step traced with ``torch.profiler``: device
     busy and idle share, the GEMM kernels' time, split by part from the
     step's launch counts and each shape's time, chunked attention and the
     optimizer timed alone; (c) the model freed, the GEMM kernel under the
     config dispatch chose against an f32 ``torch.matmul`` within
     ``gemm_tol(k)``, and timed against ``torch.matmul`` and its bound, at
     every shape the steps launched it on (dB with K = 8192, the head's
     per-chunk products); (d) yi-6b at published widths with 2 layers on
     1 x 256 tokens: bf16 gradients on the card against the same weights'
     f32 gradients on the CPU, each leaf's relative L2 error within
     ``GRAD_REL_LIMIT``, which refuses a planted fault (dB computed from
     A's buffer read as if transposed); (e) the reduced yi-6b on the card
     with deterministic algorithms on: a step-2 checkpoint restored byte
     for byte, and the resumed step 3's loss equal to a straight run's;
     (a)'s ``[train]`` lines also give the share under
     ``utils/roofline.model_flops`` (6 x n_active_params x tokens, the
     embedding in, no attention term);
 15. the dry run on the card: (a) ``python -m repro_torch.launch.dryrun
     --all`` (started after phase 12 in a process of its own: it needs
     no card and minutes of one CPU core, and phases 11-12 time the
     host) traces the 40 cells on meta; its
     roofline table (the reference's ``roofline_report`` columns) and
     wall time, failing on any ``error`` record; (b) yi-6b at published
     widths and 1 and 2 of its 32 layers on train_4k (2 x 4096),
     prefill_32k (1 x 32768, flash at S = 32768) and decode_32k (128 x a
     32768-deep cache, 8.6 GB of K/V a layer), each step counted once on
     the card and traced on meta through the same entry points
     (``make_train_step``, ``Model.prefill``, ``Model.decode_step``):
     FLOPs and bytes, by kind, equal; the GEMM kernel's counted FLOPs
     equal 2·M·K·N over ``gemm.LAUNCHES`` and flash's its launches times
     ``flash_work``; the train step's GEMM in all four roles, flash in
     prefill only; the meta trace's live peak within ``PEAK_RTOL`` of
     ``max_memory_allocated`` over the step; a counter planted to drop
     the dB products refused; (c) each probe's mean step time against
     its roofline bound (the larger of ``compute_s`` and ``memory_s``),
     their ratio and the model-flops share, beside the card's name and
     power limit, and a ``[dryrun-record]`` JSON line with the cuts in
     ``reduced``;
 16. remat ``dots`` and the head-to-head (run after phase 14, beside the
     dry run's ``--all``, before phase 15 waits for it): (a) phase 14's
     yi-6b (16 of 32 layers, its seed and data) three steps under remat
     ``dots``, whose checkpoint keeps the GEMM operator's outputs
     (``repro_torch::gemm``) that the backward reads and hands them back
     in the recompute, which recomputes the rest: step 1's
     loss equal to phase 14's within rtol 1e-5, every block keeping the
     JAX package's six products (wq, wk, wv, wo, gate, up; not the MLP's
     down product, whose output feeds only the residual add), their bytes
     printed, no GEMM launch in the
     blocks' recompute (the loss head's chunks, checkpointed under every
     remat as in the JAX package, recompute as under ``full``), the
     ``forward``/``dA``/``dB`` launches phase 14's shape by shape, step
     seconds, tokens/s and peak beside phase 14's, one step traced, and
     the three steps timed again under selective checkpointing
     (``create_selective_checkpoint_contexts``, ``MUST_SAVE`` the
     operator, ``mm`` and ``addmm``), which keeps the same products
     (and the down product) through a dispatch mode that runs Python on
     every op; (b) phase
     14(d)'s gradient check under ``dots``, the planted dB fault refused;
     (c) mamba2-130m and zamba2-1.2b at published widths, one step of 2 x
     2048 tokens each under ``full`` and ``dots``: the same loss and
     gradients within ``GRAD_REL_LIMIT``, no launch in the blocks'
     recompute under ``dots``; (d) ``TuningSession.compare`` of the
     paper's four tuners (g-bfs, n-a2c, xgboost-like, rnn-controller)
     at 512^3 float32 on the card, two seeds, 0.1 % of the space (484
     trials) each, phase 11's protocol, every best re-timed beside the
     state ``AnalyticalHopperCost(...).optimum()`` picks (a brute force
     over the 484,000 states on the host): each result finite, launched
     and within its budget; (e) qwen3-moe-235b-a22b at published widths,
     2 of 94 layers, 1 x 512 tokens, capacity factor E / k (nothing
     drops), one forward and backward under ``full`` and under ``dots``
     with no optimizer: under ``dots`` each block keeps attention's four
     products and the router's f32 logits, the router's ``mm`` runs in the
     forward only (counted by launch role in a second pass), no GEMM
     launches in the blocks' recompute, gradients per leaf within
     ``GRAD_REL_LIMIT`` of ``full``'s; the peak and seconds of each.

Launch counts of each path are zeroed just before it and read just after:
the GEMM tuning path is phases 3-5, the flash tuning path phase 8, the
serve phase 9, N-A2C's tuning and serve 11(a) (added to the yi-6b rows'
``launches_tune``), the paper's comparison 11(b) (its own row,
``gemm[paper/1024^3-f32]``; the CLIs' launches, made in their own
processes, are added from their output), phase 12 (the launch counts
of its measurement workers alive at its end, read through
``ProcessExecutor.worker_call``, its dispatch's, and its CLIs'), and
phase 13 (each family's engine through its first ``generate``), and
phase 14 (yi-6b's three training steps, ``launches_train``, with its
parts by launch role in ``launches_train_parts``; GEMM rows are added
for the backward's shapes; the flash row says it is not on the
training path), phase 15 (the probes' counted steps,
``launches_dryrun``; GEMM rows are added for the decode probe's
shapes, and a flash row for the prefill probe's S = 32768, which
carries that probe's flash launches), phase 16(a) (the three ``dots``
steps, ``launches_dots``, by role in ``launches_dots_parts``) and phase
16(d) (the head-to-head's search, its own row,
``gemm[compare/512^3-f32]``).  A
serve path's counts are zeroed before its engine's prewarm, which runs
the decode loop once (the warm-up) and then captures it.  Host counts
tick when a wrapper is called, so a capture counts the launches it
records (none run) and a replay counts nothing; the engine's
``launch_report()`` keeps per kernel and shape what the warm-up
launched, what the captures recorded and what the replays launched, and
a path's launches are the counts less the recorded, plus the replayed:
the prefill's, the warm-up's, and each graph's once per replay.  Each
kernel row gives ``launches_tune``, ``launches_serve`` (phase 9) and
``launches_families`` (phase 13, at the row's shape; the flash row at
every shape) and their sum as ``launches``.  The ``flash_f32[...]`` row
counts the float32 flash kernel's launches on the same paths, read
from ``flash_attention.DTYPE_LAUNCHES`` (keyed by dtype; ``LAUNCHES``
is keyed by shape alone, and the other flash rows count every dtype).  GEMM rows give each
time twice: ``ms``/``library_ms`` timed as earlier slices timed them
(the event span holds the host's enqueue of the call), and
``ms_spin``/``library_ms_spin`` with the card kept busy while the host
enqueues (the device's time alone).  Tolerances, kernel against its plain version: GEMM
float32 rtol 1e-4 / atol 8e-4 (the JAX package's GEMM kernel tests),
bfloat16 rtol 1.6e-2 / atol 2e-3 * max(1, K / 4096) * max(1, K /
11008)^0.5 (kernel and plain version sum the same products in f32 in
another order and round the output to bf16 once, so they differ by a
rounding step, 2^-8 to 2^-7 relative; wgmma adds each k16 step to its
accumulator with less than f32's precision, an absolute error that grows
about as K^1.5: ``gemm_tol``; the ``[time]`` and ``[train-gemm]`` lines
print the atol each full-width check needs); flash float32 rtol 2e-5 / atol 8e-5 (its flash
kernel tests), bfloat16 rtol 1.6e-2 / atol 2e-3 (two bf16 rounding
steps: kernel and plain version do the same f32 arithmetic in another
order and round P and the output at the same places).  GEMM against an
f32 ``torch.matmul`` (phases 2, 5 and 9): the JAX package's bf16 GEMM
tolerance, rtol 0.05 / atol 0.4.  The reduced model's logits rtol/atol
2e-4 (its port tests).  Exits non-zero on any failure; prints the
kernels JSON line, then the device line last.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: prctl option that makes a process the reaper of its descendants' orphans
PR_SET_CHILD_SUBREAPER = 36
#: GEMM kernel against its plain version at K <= 4096 (see gemm_tol)
TOL = {torch.float32: (1e-4, 8e-4), torch.bfloat16: (1.6e-2, 2e-3)}
#: GEMM against an f32 torch.matmul: the JAX package's GEMM tolerances
MATMUL_TOL = {torch.float32: (1e-4, 8e-4), torch.bfloat16: (0.05, 0.4)}
GEMM_CU = os.path.join(SRC, "repro_torch", "kernels", "csrc", "gemm.cu")
#: planted faults the GEMM limits must refuse, each in the kernel it
#: breaks: one line of the source, and what a variant built beside it has
GEMM_FAULTS = {
    # the wgmma kernel's warpgroups read the ring slot after slab i's
    "wrong_ring_slot": ("const int slot = i % stages;", "const int slot = (i + 1) % stages;"),
    # the f32 SIMT kernel multiplies the ring slot after slab i's
    "simt_wrong_slot": ("const int cur = i % stages;", "const int cur = (i + 1) % stages;"),
    # the bandwidth kernel's reduction leaves out the last warp's partial sums
    "split_k_drop": (
        "for (int w = 0; w < kStreamWarps; ++w) s += red[w * bm * BN + e];",
        "for (int w = 0; w < kStreamWarps - 1; ++w) s += red[w * bm * BN + e];",
    ),
}
#: the decode product phase 3 tunes beside the reference's five workloads
DECODE_TUNED = (8, 4096, 11008)
DECODE_TRIALS = 60
#: the products yi-6b's serve runs at full width: prefill (8 x 4096 tokens)
#: and decode (8 tokens) — q/o, k/v, gate/up, down, and the lm head
SERVED_SHAPES = ((32768, 4096, 4096), (32768, 4096, 512), (32768, 4096, 11008),
                 (32768, 11008, 4096), (8, 4096, 4096), (8, 4096, 512), (8, 4096, 11008),
                 (8, 11008, 4096), (8, 4096, 65536))
# kernel and plain version round P and the output to bf16 at the same
# places, from f32 values that differ only in the order of f32 sums, so
# outputs differ by about a rounding step (2^-7 relative, 0.0039 below 1);
# the limit is two steps, far below a typical output at S = 4096 (about 0.02)
FLASH_TOL = {torch.float32: (2e-5, 8e-5), torch.bfloat16: (1.6e-2, 2e-3)}
FLASH_CU = os.path.join(SRC, "repro_torch", "kernels", "csrc", "flash_attention.cu")
#: planted faults the bf16 flash limit must refuse: one line of the
#: kernel's source, and what a variant built beside it has instead
FAULTS = {
    # the running accumulator is not rescaled when the row max grows
    "no_rescale": ("o[4 * j + t] *= corr[t >> 1];", "o[4 * j + t] *= 1.0f;"),
    # the last q block (the latest rows) stops one kv block short
    "last_q_block_short": (
        "const int n_visit = causal ? min(n_kv, ((iq + 1) * bq + bkv - 1) / bkv) : n_kv;",
        "const int n_visit = (causal ? min(n_kv, ((iq + 1) * bq + bkv - 1) / bkv) : n_kv)"
        " - (iq == gridDim.x - 1);",
    ),
}
#: (block_q, block_kv) pairs phase 7 checks, per dtype: every bf16 pair G-BFS
#: can serve at 4096 (block_q 64 or 128, block_kv 16 to 128), and f32 pairs
#: from 16 x 16 up, several with block_kv != block_q
FLASH_BLOCKS = {
    torch.bfloat16: tuple((bq, bkv) for bq in (64, 128) for bkv in (16, 32, 64, 128)),
    torch.float32: ((16, 16), (32, 64), (64, 32), (64, 128), (128, 16)),
}
#: the other bf16 block_kv instantiations, checked at block_q 128
FLASH_ODD_BKV = (48, 80, 96, 112)
TUNE_TRIALS = 250  # total G-BFS pool over the five workloads (phase 3)
# total pool of the warm-started CLI rerun (phase 4), which starts from
# phase 3's records and serves every state phase 3 measured from the journal
CLI_TRIALS = 100
FLASH_TRIALS = 30  # G-BFS pool of the flash workload (phase 8)
FLASH_CLI_TRIALS = 12
SERVE_REQUESTS, SERVE_BUCKET, SERVE_TOKENS = 8, 4096, 16
#: phase 13: (arch, layers served or None for all, requests, prompt bucket,
#: frontend tokens).  qwen3-moe's 94 layers are 470 GB in bf16; 8 fit the
#: card with its 4096-token prefill
FAMILIES = (
    ("whisper-tiny", None, 8, 128, 0),
    ("mamba2-130m", None, 8, 4096, 0),
    ("zamba2-1.2b", None, 8, 4096, 0),
    ("qwen3-moe-235b-a22b", 8, 8, 4096, 0),
    ("llava-next-34b", None, 2, 3520, 576),
)
#: phase 11: N-A2C's pool over the CLI's five GEMMs and its decode-product
#: budget (about 120 trials over six GEMMs), the paper's product, the
#: FP32 CUDA-core peak its bound uses (H100 SXM data sheet), and the
#: determinism runs' budget
NA2C_CLI_TRIALS, NA2C_DECODE_TRIALS = 100, 20
PAPER_DIMS = (1024, 1024, 1024)
FP32_PEAK = 66.9e12
NA2C_REPEAT_TRIALS = 200
#: phase 12: G-BFS's trials per workload in each lane run (seven workloads:
#: yi-6b's five GEMMs, the decode product and the prefill attention), the
#: lanes' kill timeout, and the planted faults (a hang sleeps past the
#: timeout; the plan's seed is the first that plants a crash, a hang and a
#: corrupt value on the searches' warm-start states, so each kind fires)
SCALE_TRIALS = 10
SCALE_LANES = 4
SCALE_LANE_TIMEOUT_S = 4.0
SCALE_PLAN = dict(p_crash=0.03, p_hang=0.01, p_corrupt=0.04, hang_s=10.0, fires=1)
#: each CLI shard's pool over the five GEMMs, and the filtered rerun's pool
SHARD_TRIALS = 30
FILTER_TRIALS = 40
#: phase 14: yi-6b trained at its published widths with 16 of its 32 layers
#: (AdamW with f32 master weights takes 16 bytes a parameter, 97 GB for all
#: 32 layers' 6.06 B: more than the card's 80 GB), 2 x 4096 tokens a step
#: (M = 8192, the M phase 3 tunes train_4k's products at), three steps
#: through Trainer, then one more traced
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 2, 4096, 3
#: (d): yi-6b at published widths with 2 layers on 1 x 256 tokens, its bf16
#: gradients on the card against the same weights' f32 gradients on the CPU
GRAD_LAYERS, GRAD_SEQ = 2, 256
#: the limit on any leaf's relative L2 error, card (bf16) against CPU (f32)
GRAD_REL_LIMIT = 0.05
#: (e): the reduced yi-6b trained 3 steps straight, and 2 + resume + 1
RESUME_BATCH, RESUME_SEQ = 4, 128
#: prefixes of the port's ``record_function`` ranges, which a trace also
#: shows as device-side annotations (not kernels)
RANGES = ("train.", "remat.", "attn.")
#: phase 15: yi-6b probed at published widths and 1 and 2 of its 32 layers
#: on the reference's train_4k, prefill_32k and decode_32k, each batch cut
#: to fit one card: (shape, tokens a sequence, batch, kind)
DRY_PROBES = (("train_4k", 4096, 2, "train"), ("prefill_32k", 32768, 1, "prefill"),
              ("decode_32k", 32768, 128, "decode"))
DRY_DEPTHS = (1, 2)
#: timed steps of each probe, after the counted one
DRY_TIMED = {"train": 3, "prefill": 3, "decode": 10}
#: the meta trace's live peak against the card's ``max_memory_allocated``
#: over the same step (both less what was allocated before it): the
#: caching allocator rounds each block up to 512 bytes (3044 bytes apart
#: at most on the H100), and a reference cycle that held a tensor past
#: its step would show here
PEAK_RTOL = 0.02
#: the dry run of the 40 cells, on meta in its own process, must end by
#: then (it starts after phase 12 and runs beside phases 13, 14 and 16)
DRY_ALL_TIMEOUT_S = 900
#: phase 16: remat ``dots`` on phase 14's yi-6b (its layers, seed and
#: data), and one step of mamba2-130m and zamba2-1.2b at published widths
#: under ``full`` and ``dots``; step 1's loss against phase 14's within
#: the training loss limit (ROADMAP.md)
DOTS_LAYERS = TRAIN_LAYERS
DOTS_SSM, DOTS_SSM_BATCH, DOTS_SSM_SEQ = ("mamba2-130m", "zamba2-1.2b"), 2, 2048
DOTS_LOSS_RTOL = 1e-5
#: phase 16(e): qwen3-moe at published widths, 2 of its 94 layers, 1 x 512
#: tokens, capacity factor E / k (nothing drops), one forward and backward
#: under full and dots, no optimizer
DOTS_MOE, DOTS_MOE_LAYERS, DOTS_MOE_BATCH, DOTS_MOE_SEQ = "qwen3-moe-235b-a22b", 2, 1, 512
#: phase 16(d): ``TuningSession.compare`` of the paper's four tuners at
#: 512^3 float32, two seeds, 0.1 % of the space (484 trials) each
COMPARE_DIMS = (512, 512, 512)
COMPARE_TUNERS = ("g-bfs", "n-a2c", "xgboost-like", "rnn-controller")
COMPARE_SEEDS = 2
COMPARE_FRACTION = 0.001


#: phase 2: the product every f32 register tile is checked on under one
#: stage and under a full ring (``kernels.gemm.simt_ring_configs``)
SIMT_RING_DIMS = (256, 2048, 256)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s", flush=True)


#: device clock cycles the card spins before a timed run with ``spin``
#: (about 0.5 ms), so the host has enqueued the timed call before its
#: start event fires
SPIN_CYCLES = 1_000_000


def timed_ms(fn, repeats: int, flush: torch.Tensor, spin: bool = False) -> float:
    """Mean CUDA-event time of ``fn`` over ``repeats`` runs after one
    warm-up run, with the L2 flushed before each timed run.  Without
    ``spin`` (how every earlier row was timed) the span holds the host's
    time to enqueue ``fn``; with it, the card is kept busy while the
    host enqueues, so the span is the device's alone (a microsecond
    kernel is otherwise timed with the host's launch overhead)."""
    fn()
    total = 0.0
    for _ in range(repeats):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / repeats


def gemm_tol(k: int) -> dict:
    """The GEMM kernel's limit against its plain version (or an f32
    ``torch.matmul``) for a K-deep product: TOL, with the bf16 atol grown
    in proportion to K above 4096, and with K^1.5 above 11008.  wgmma
    adds each k16 step to its accumulator with less than f32's precision,
    an error that grows with the number of steps and the accumulator's
    size: about as K^1.5 (on an H100, random normal operands, the atol
    needed against an f32 matmul was 5.8e-4 at K = 4096, 1.5e-3 at 8192,
    2.3e-3 at 11008 and 3.8e-2 at 65536: phase 14's ``[train-gemm]``
    lines).  The linear part is the limit fitted up to K = 11008, the
    forward's deepest product; the K^1.5 part covers the backward's dA of
    the lm head (K = the padded vocabulary, 65536 for yi-6b).  The
    ``[time]`` and ``[train-gemm]`` lines print the atol each full-width
    check needs."""
    rtol, atol = TOL[torch.bfloat16]
    scale = max(1.0, k / 4096) * max(1.0, k / 11008) ** 0.5
    return {**TOL, torch.bfloat16: (rtol, atol * scale)}


def atol_needed(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """The least atol under which ``got`` is within ``rtol`` of ``ref``."""
    return ((got.float() - ref.float()).abs() - rtol * ref.float().abs()).max().item()


def within(got: torch.Tensor, ref: torch.Tensor, dtype, tol=TOL) -> tuple[float, bool]:
    """``(max abs error, whether got is finite, of ref's shape and within
    the limit)``."""
    rtol, atol = tol[dtype]
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        return float("inf"), False
    return (got - ref).abs().max().item(), torch.allclose(got, ref, rtol=rtol, atol=atol)


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor, dtype, tol=TOL) -> float:
    err, ok = within(got, ref, dtype, tol)
    if not ok:
        raise SystemExit(f"{what}: max abs err {err} (shape {tuple(got.shape)}) outside "
                         f"rtol={tol[dtype][0]} atol={tol[dtype][1]}")
    return err


def fault_variant(source: str, faults: dict, name: str, out_dir: str):
    """Build the kernel source ``source`` with the planted fault ``name``
    of ``faults`` into ``out_dir``; returns ``(library, ptxas report)``."""
    from repro_torch.kernels.build import build_library

    old, new = faults[name]
    with open(source) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"the line of fault {name} is not in the source once")
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(out_dir, f"{stem}_{name}.cu")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    return build_library(path, build_dir=out_dir)


def sass_counts(lib, pattern: re.Pattern, ops: str = r"\b(HGMMA|HMMA)\.") -> dict:
    """Instructions matching ``ops`` (by default the tensor-core ones:
    ``HGMMA`` for wgmma, ``HMMA`` for mma.sync) per kernel whose name
    ``pattern`` matches, keyed by the pattern's groups, from ``cuobjdump
    -sass`` of the built library."""
    from repro_torch.kernels.build import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = pattern.search(line)
            key = tuple(map(int, m.groups())) if m else None
            if key:
                counts[key] = collections.Counter()
        elif key:
            counts[key].update(re.findall(ops, line))
    return counts


def ptxas_report(ptxas_log: str, pattern: re.Pattern):
    """ptxas' register and spill lines, and its injected
    ``warpgroup.arrive``s, per kernel whose name ``pattern`` matches."""
    lines, arrives, key = collections.defaultdict(list), collections.Counter(), None
    for line in ptxas_log.splitlines():
        if "entry function" in line:
            m = pattern.search(line)
            key = tuple(map(int, m.groups())) if m else None
        elif "warpgroup.arrive is injected" in line and pattern.search(line):
            arrives[tuple(map(int, pattern.search(line).groups()))] += 1
        elif key and ("spill" in line or "Used" in line):
            lines[key].append(line.replace("ptxas info    :", "").strip())
    return lines, arrives


def _regs(lines: list) -> str:
    m = re.search(r"Used (\d+) registers", " ".join(lines))
    return m.group(1) if m else "?"


def _spills(lines: list) -> int:
    return sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", " ".join(lines)))


def gemm_tensor_core_report(lib, ptxas_log: str) -> None:
    """HGMMA count, registers, spills and injected arrives of every bf16
    ``wgmma`` instantiation of the GEMM (slab depth, m64 instructions per
    warpgroup, instruction N) and the HMMA count, registers and spills of
    every bandwidth-kernel instantiation (columns); exits on a count of
    0, a missing instantiation, a spill or an injected arrive in a
    ``wgmma`` instantiation."""
    from repro_torch.core.analysis import GEMM_BW_BN, GEMM_WG_INSTANCES

    wg = re.compile(r"gemm_tiled_wgmmaILi(\d+)ELi(\d+)ELi(\d+)E")
    st = re.compile(r"gemm_tiled_streamILi(\d+)E")
    wg_counts, st_counts = sass_counts(lib, wg), sass_counts(lib, st)
    wg_ptxas, wg_arrives = ptxas_report(ptxas_log, wg)
    st_ptxas, _ = ptxas_report(ptxas_log, st)
    for bk in sorted({k[0] for k in wg_counts}):
        keys = sorted(k for k in wg_counts if k[0] == bk)
        print(f"[sass] gemm_tiled_wgmma<{bk}, MT, SN>: HGMMA "
              + " ".join(f"{k[1]}x{k[2]}:{wg_counts[k]['HGMMA']}" for k in keys)
              + "; registers " + " ".join(f"{k[1]}x{k[2]}:{_regs(wg_ptxas[k])}" for k in keys)
              + f"; spill stores {sum(_spills(wg_ptxas[k]) for k in keys)} B; "
              f"warpgroup.arrive injected {sum(wg_arrives[k] for k in keys)}", flush=True)
    keys = sorted(st_counts)
    print("[sass] gemm_tiled_stream<BN>: HMMA "
          + " ".join(f"{k[0]}:{st_counts[k]['HMMA']}" for k in keys)
          + "; registers " + " ".join(f"{k[0]}:{_regs(st_ptxas[k])}" for k in keys)
          + f"; spill stores {sum(_spills(st_ptxas[k]) for k in keys)} B", flush=True)
    want_wg = {(bk, sm // 64, sn) for bk, sm, sn in GEMM_WG_INSTANCES}
    if set(wg_counts) != want_wg or not all(c["HGMMA"] for c in wg_counts.values()):
        raise SystemExit(f"bf16 GEMM wgmma instantiations without HGMMA: {wg_counts}")
    if set(st_counts) != {(bn,) for bn in GEMM_BW_BN} or not all(
            c["HMMA"] for c in st_counts.values()):
        raise SystemExit(f"bf16 GEMM bandwidth instantiations without HMMA: {st_counts}")
    bad = {k: (_spills(wg_ptxas[k]), wg_arrives[k]) for k in want_wg
           if _spills(wg_ptxas[k]) or wg_arrives[k]}
    if bad:
        raise SystemExit(f"wgmma GEMM instantiations with spills or injected arrives "
                         f"(spill bytes, arrives): {bad}")


#: the SIMT kernel's opcodes the ``[sass]`` lines count: its FMAs, its
#: 128-bit shared loads, and its 128-bit global loads (cp.async's LDGSTS,
#: or a plain LDG)
SIMT_OPS = r"\b(FFMA|LDS(?:\.U)?\.128|LDGSTS\.[\w.]*\.128|LDG\.E(?:\.\w+)*\.128)\b"


def simt_report(lib, ptxas_log: str) -> None:
    """One ``[sass]`` line for each float32 SIMT instantiation
    ``gemm_tiled<float, RM, RN>``: its FFMA, LDS.128, LDGSTS.128 and
    LDG.E.128 counts, registers and spill stores; exits on a missing
    instantiation, a spill, no 128-bit copy (cp.async of B's rows), or
    no 128-bit shared load where reg_m or reg_n is 4 or more."""
    pattern = re.compile(r"gemm_tiledIfLi(\d+)ELi(\d+)E")
    counts = sass_counts(lib, pattern, SIMT_OPS)
    ptxas, _ = ptxas_report(ptxas_log, pattern)
    bad = []
    for rm, rn in sorted(counts):
        by_kind = collections.Counter()
        for op, n in counts[rm, rn].items():
            by_kind[op.split(".")[0] + (".128" if op.endswith(".128") else "")] += n
        spills = _spills(ptxas[rm, rn])
        print(f"[sass] gemm_tiled<float, {rm}, {rn}>: FFMA {by_kind['FFMA']} LDS.128 "
              f"{by_kind['LDS.128']} LDGSTS.128 {by_kind['LDGSTS.128']} LDG.E.128 "
              f"{by_kind['LDG.128']}; registers {_regs(ptxas[rm, rn])}; spill stores "
              f"{spills} B", flush=True)
        if (spills or not by_kind["FFMA"] or not by_kind["LDGSTS.128"]
                or (max(rm, rn) >= 4 and not by_kind["LDS.128"])):
            bad.append((rm, rn))
    if len(counts) != 16 or bad:
        raise SystemExit(f"f32 SIMT instantiations missing ({16 - len(counts)}) or with a spill "
                         f"or without 128-bit loads: {bad}")


def tensor_core_report(lib, ptxas_log: str) -> dict:
    """Count the tensor-core instructions (``HGMMA`` for wgmma, ``HMMA`` for
    mma.sync) of each bf16 flash instantiation (one per head_dim and
    block_kv) in ``cuobjdump -sass`` of the built library, and print them
    with ptxas' registers, spills and injected ``warpgroup.arrive``s per
    head_dim; exits if one has no tensor-core instruction.  Returns ptxas'
    report lines per ``(head_dim, block_kv)``."""
    name = re.compile(r"flash_fwd_bf16ILi(\d+)ELi(\d+)E")
    counts = sass_counts(lib, name)
    ptxas, arrives = ptxas_report(ptxas_log, name)
    for hd in sorted({k[0] for k in counts}):
        keys = sorted(k for k in counts if k[0] == hd)
        print(f"[sass] flash_fwd_bf16<{hd}, block_kv>: tensor-core instructions (HGMMA+HMMA) "
              + " ".join(f"{k[1]}:{sum(counts[k].values())}" for k in keys)
              + "; registers " + " ".join(f"{k[1]}:{_regs(ptxas[k])}" for k in keys)
              + f"; spill stores {sum(_spills(ptxas[k]) for k in keys)} B; warpgroup.arrive "
              f"injected {sum(arrives[k] for k in keys)}", flush=True)
    if ({k[0] for k in counts} != {16, 32, 64, 128} or len(counts) != 32
            or not all(sum(c.values()) for c in counts.values())):
        raise SystemExit(f"bf16 flash instantiations without tensor-core instructions: {counts}")
    return ptxas


def refuse_gemm_fault(what: str, name: str, lib, a, b, cfg, ref) -> float:
    """Launch the planted-fault variant ``name`` on the operands the
    correct kernel was checked on; the operands' limit must refuse it.
    Returns its max abs error."""
    from repro_torch.kernels.gemm import launch_with

    err, ok = within(launch_with(lib, a, b, cfg), ref, a.dtype, gemm_tol(a.shape[1]))
    print(f"[fault] gemm {a.dtype} {what} {cfg}: {name} max abs err {err} -> "
          f"{'within the limit' if ok else 'refused'}", flush=True)
    if ok:
        raise SystemExit(f"the {a.dtype} GEMM limit let the planted fault {name} pass ({what})")
    return err


def refuse_faults(what: str, fault_libs: dict, q, k, v, blocks, ref) -> None:
    """Launch each planted-fault variant on the operands the correct
    kernel was checked on; the bf16 limit must refuse every one."""
    from repro_torch.kernels.flash_attention import launch_with

    for name, lib in fault_libs.items():
        err, ok = within(launch_with(lib, q, k, v, *blocks), ref, torch.bfloat16, FLASH_TOL)
        print(f"[fault] {what} blocks {blocks}: {name} max abs err {err} -> "
              f"{'within the limit' if ok else 'refused'}", flush=True)
        if ok:
            raise SystemExit(f"the bf16 flash limit let the planted fault {name} pass ({what})")


def run_cli(args: list[str]) -> str:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         env=env, cwd=HERE, timeout=600)
    print(cli.stdout, end="")
    if cli.returncode != 0:
        raise SystemExit(f"{args[0]} failed ({cli.returncode}):\n{cli.stderr}")
    return cli.stdout


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, SRC)

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import Budget, TrialJournal, TuningRecords, TuningSession
    from repro_torch.core.analysis import (
        GEMM_BW_BN, GEMM_WG_INSTANCES, flash_max_threads, gemm_bf16_max_threads,
        gemm_kernel_kind, gemm_smem_bytes, gemm_stages, max_threads_for_reg_tile,
    )
    from repro_torch.core.records import set_global_records
    from repro_torch.core.session import Workload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import (
        LAUNCHES, KernelConfig, build_kernel, default_config, gemm_plain,
        gemm_tiled, kernel_config_from_state, kernel_f32_ring, kernel_max_threads,
        kernel_max_threads_bf16, simt_ring_configs, state_from_config,
    )
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.tune import flash_workloads_for_arch, workloads_for_arch
    from repro_torch.models.api import Model
    from repro_torch.utils.roofline import H100

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    # cuBLAS (the decode attention's batched products) picks its reduction by
    # workspace; one fixed workspace per stream makes the graph's capture
    # stream and the eager loop's stream compute the same sums
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    device_name = torch.cuda.get_device_name(0)
    # dense bf16 peak (ops/s) and memory rate (bytes/s) of the card, from
    # NVIDIA's data sheets (the roofline's figures, one place for both)
    hw = H100.for_device(device_name)
    peak_ops, peak_bytes = hw.peak_flops, hw.hbm_bw
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(100 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 1. build both kernels and the planted faults, side by side ------------
    t0 = time.perf_counter()
    fault_dir = tempfile.TemporaryDirectory()
    builds: dict[str, tuple] = {}

    def build(label, fn):
        t = time.perf_counter()
        try:
            builds[label] = (fn(), time.perf_counter() - t)
        except Exception as e:  # reported, and fatal, below
            builds[label] = (e, time.perf_counter() - t)

    jobs = [("gemm", build_kernel), ("flash", fa.build_kernel)] + [
        (f"fault {name}", lambda name=name: fault_variant(FLASH_CU, FAULTS, name, fault_dir.name))
        for name in FAULTS] + [
        (f"fault {name}", lambda name=name: fault_variant(GEMM_CU, GEMM_FAULTS, name,
                                                          fault_dir.name))
        for name in GEMM_FAULTS]
    threads = [threading.Thread(target=build, args=a) for a in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for label, (built, secs) in builds.items():
        if isinstance(built, Exception):
            raise SystemExit(f"[build] {label} kernel failed: {built}")
        spills = [l.strip() for l in built[1].splitlines()
                  if "spill" in l and " 0 bytes spill stores" not in l]
        print(f"[build] {label} kernel built in {secs:.1f}s; "
              f"instantiations with spills: {len(spills)}")
    fault_libs = {name: fa.bind(builds[f"fault {name}"][0][0]) for name in FAULTS}
    gemm_fault_libs = {name: gemm_mod.bind(builds[f"fault {name}"][0][0])
                       for name in GEMM_FAULTS}
    flash_ptxas = tensor_core_report(*builds["flash"][0])
    gemm_tensor_core_report(*builds["gemm"][0])
    simt_report(*builds["gemm"][0])
    phase("1 build", t0)

    # -- 2. kernel vs plain on small products ----------------------------------
    t0 = time.perf_counter()
    for rm in (1, 2, 4, 8):
        for rn in (1, 2, 4, 8):
            got = kernel_max_threads(torch.float32, rm, rn)
            if got != max_threads_for_reg_tile(rm, rn):
                raise SystemExit(f"launch limit {got} for float32 {rm}x{rn} "
                                 f"disagrees with the analyzer")
    bf16_instances = [KernelConfig(sm, bk, sn, sm, sn) for bk, sm, sn in GEMM_WG_INSTANCES] + [
        KernelConfig(8, 16, bn, 8, bn) for bn in GEMM_BW_BN]
    for cfg in bf16_instances:
        got, want = kernel_max_threads_bf16(cfg), gemm_bf16_max_threads(cfg.block_m)
        if got != want:
            raise SystemExit(f"launch limit {got} of the bf16 instantiation for {cfg} "
                             f"disagrees with the analyzer ({want})")
    print(f"[check] launch limits of 16 f32 and {len(bf16_instances)} bf16 GEMM "
          f"instantiations equal the analyzer's")
    ring_configs = simt_ring_configs()
    ring_tiles = {(c.block_m, c.block_k, c.block_n) for c in ring_configs} | {
        (128, 64, 128), (64, 512, 32), (8, 1024, 8), (12, 8, 16), (10, 8, 16), (16, 1024, 40),
        (512, 128, 512)}
    for tile in sorted(ring_tiles):
        got = kernel_f32_ring(*tile)
        want = (gemm_stages(*tile, 4), gemm_smem_bytes(*tile, 4) if gemm_stages(*tile, 4) else 0)
        if got != want:
            raise SystemExit(f"the f32 ring of {tile}: the kernel launches {got} (stages, "
                             f"bytes), the analyzer says {want}")
    print(f"[check] the f32 SIMT ring (stages, shared-memory bytes) of {len(ring_tiles)} tiles "
          f"equals the analyzer's: " + " ".join(
              f"{bm}x{bk}x{bn}:{gemm_stages(bm, bk, bn, 4)}" for bm, bk, bn in sorted(ring_tiles)))
    simt_configs = [
        KernelConfig(128, 32, 128, 32, 64, 8, 8),
        KernelConfig(64, 16, 64, 32, 32, 4, 4),
        KernelConfig(64, 128, 64, 32, 32, 2, 2),
        KernelConfig(128, 8, 64, 64, 16, 8, 2),
        KernelConfig(32, 64, 32, 0, 0, 1, 1),
        KernelConfig(8, 128, 8, 0, 0, 1, 1),
        # N = 2 (mod 4): B's rows by 4-byte copies; bk = 12: A in runs of 4 k
        KernelConfig(32, 8, 10, 32, 10, 1, 2),
        KernelConfig(32, 12, 10, 16, 10, 2, 1),
    ] + ring_configs
    # every wgmma instantiation with one warpgroup and with two (along m and
    # along n); the bandwidth kernel at 8 and 16 rows, every column count
    wgmma_configs = [KernelConfig(bm, bk, bn, sm, sn) for bk, sm, sn in GEMM_WG_INSTANCES
                     for bm, bn in ((sm, sn), (2 * sm, sn), (sm, 2 * sn))]
    stream_configs = [KernelConfig(bm, bk, bn, bm, bn) for bm in (8, 16) for bn in GEMM_BW_BN
                      for bk in (16, 48, 256, 512)]
    small = {
        torch.float32: (((1024, 1024, 1024), (512, 256, 768), (256, 1024, 128), (64, 96, 1010),
                         SIMT_RING_DIMS), simt_configs),
        torch.bfloat16: (((256, 512, 512), (128, 1024, 256), (64, 512, 512), (8, 4096, 1024),
                          (16, 1024, 512), (8, 11008, 256)), wgmma_configs + stream_configs),
    }
    n_checked, worst = collections.Counter(), collections.defaultdict(float)
    simt_rings = collections.defaultdict(set)  # (reg_m, reg_n) -> one stage / a ring checked
    for dtype, (shapes, configs) in small.items():
        for m, k, n in shapes:
            a, b = rand((m, k), dtype), rand((k, n), dtype)
            for cfg in configs:
                try:
                    cfg.validate(m, k, n, dtype.itemsize)
                except ValueError:
                    continue
                kind = gemm_kernel_kind(cfg.block_m, dtype.itemsize)
                out = gemm_tiled(a, b, cfg)
                err = check_close(f"{dtype} {(m, k, n)} {cfg}", out, gemm_plain(a, b, cfg), dtype,
                                  gemm_tol(k))
                n_checked[kind] += 1
                worst[kind] = max(worst[kind], err)
                if kind == "simt" and k >= 4 * cfg.block_k:
                    simt_rings[cfg.reg_m, cfg.reg_n].add(
                        min(gemm_stages(cfg.block_m, cfg.block_k, cfg.block_n, 4), 2))
        a = rand((256, 512), dtype).requires_grad_()
        b = rand((512, 384), dtype).requires_grad_()
        g = rand((256, 384), dtype)
        (ops.gemm(a, b) * g).sum().backward()
        check_close(f"{dtype} dA", a.grad, g.float() @ b.detach().float().T, dtype, MATMUL_TOL)
        check_close(f"{dtype} dB", b.grad, a.detach().float().T @ g.float(), dtype, MATMUL_TOL)
    if not (n_checked["wgmma"] >= len(GEMM_WG_INSTANCES) and n_checked["stream"]
            and n_checked["simt"]):
        raise SystemExit(f"too few kernel/plain cases: {dict(n_checked)}")
    if len(simt_rings) != 16 or any(v != {1, 2} for v in simt_rings.values()):
        raise SystemExit(f"f32 register tiles not checked under one stage and a ring over "
                         f"4 or more slabs: {dict(simt_rings)}")
    torch.cuda.synchronize()
    print(f"[check] kernel/plain products agree: {dict(n_checked)}; max abs err "
          f"{dict(worst)}; and 2 backward passes")
    for (m, k, n), dtype, fault in (((1024, 1024, 1024), torch.bfloat16, "wrong_ring_slot"),
                                    ((8, 4096, 4096), torch.bfloat16, "split_k_drop"),
                                    ((1024, 1024, 1024), torch.float32, "simt_wrong_slot")):
        a, b = rand((m, k), dtype), rand((k, n), dtype)
        cfg = default_config(m, k, n, dtype.itemsize)
        refuse_gemm_fault(f"{(m, k, n)}", fault, gemm_fault_libs[fault], a, b, cfg,
                          gemm_plain(a, b, cfg))
    phase("2 kernel vs plain", t0)

    workloads = workloads_for_arch("yi-6b", "train_4k")
    with tempfile.TemporaryDirectory() as tmp:
        records_path = os.path.join(tmp, "yi-6b.json")
        # -- GEMM main path: counts zeroed here, read after phase 5 ------------
        LAUNCHES.clear()
        ops.reset_dispatch_stats()

        # -- 3. tune ---------------------------------------------------------------
        t0 = time.perf_counter()
        records = TuningRecords(records_path)
        with TrialJournal(records_path + ".journal.jsonl") as journal:
            session = TuningSession(records, journal=journal, verbose=True)
            per_wl = TUNE_TRIALS // len(workloads)
            tuned = {}
            for wl in workloads:
                m, k, n = wl.dims
                s0 = state_from_config(default_config(m, k, n), m, k, n)
                res = session.tune_workload(
                    wl, "g-bfs", Budget(max_trials=per_wl), tuner_kwargs={"s0": s0}
                )
                if res.best_state is None:
                    raise SystemExit(f"{wl.label}: no finite trial")
                a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
                lib_ms = timed_ms(lambda: torch.matmul(a, b), 5, flush)
                del a, b
                bound_ms = 1e3 * max(2 * m * k * n / peak_ops,
                                     2 * (m * k + k * n + m * n) / peak_bytes)
                tuned[wl.label] = (wl.dims, res.best_state)
                print(f"[tuned] {wl.label} {wl.dims}: best={res.best_state.as_lists()} "
                      f"kernel_ms={res.best_cost * 1e3:.4f} "
                      f"seed_ms={res.trials[0].cost * 1e3:.4f} "
                      f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                      f"trials={res.n_trials}", flush=True)
            # one decode product, on the bandwidth kernel's reading of the state
            wl = Workload("gemm", DECODE_TUNED, dtype="bfloat16", label="yi-6b/decode_ffn_in")
            m, k, n = wl.dims
            s0 = state_from_config(default_config(m, k, n), m, k, n)
            res = session.tune_workload(wl, "g-bfs", Budget(max_trials=DECODE_TRIALS),
                                        tuner_kwargs={"s0": s0})
            if res.best_state is None:
                raise SystemExit(f"{wl.label}: no finite trial")
            tuned[wl.label] = (wl.dims, res.best_state)
            n_finite = sum(math.isfinite(t.cost) for t in res.trials)
            print(f"[tuned] {wl.label} {wl.dims}: seed={s0.as_lists()} "
                  f"({kernel_config_from_state(s0)}) seed_ms={res.trials[0].cost * 1e3:.4f} "
                  f"best={res.best_state.as_lists()} ({kernel_config_from_state(res.best_state)}) "
                  f"kernel_ms={res.best_cost * 1e3:.4f} trials={res.n_trials} "
                  f"launchable={n_finite}", flush=True)
        torch.cuda.empty_cache()
        phase("3 tune", t0)

        # -- 4. the tune CLI, warm-started from the same records -------------------
        t0 = time.perf_counter()
        out = run_cli(["repro_torch.launch.tune", "--arch", "yi-6b", "--shape", "train_4k",
                       "--tuner", "g-bfs", "--warm-start", "--max-trials", str(CLI_TRIALS),
                       "--records", records_path])
        cli_launches = json.loads(re.search(r"kernel_launches=(.*)", out).group(1))
        phase("4 tune CLI", t0)

        # -- 5. serve every tuned shape through gemm() from the records ------------
        t0 = time.perf_counter()
        set_global_records(TuningRecords(records_path))
        served = {}
        for label, ((m, k, n), _) in tuned.items():
            a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
            out = ops.gemm(a, b)
            err = check_close(f"gemm() {label}", out, torch.matmul(a.float(), b.float()),
                              torch.bfloat16, MATMUL_TOL)
            st = ops.lookup_tuned_state("gemm", (m, k, n), "bfloat16")
            served[label] = st
            print(f"[serve] {label}: config={kernel_config_from_state(st)} max_abs_err={err}")
            del a, b, out
        torch.cuda.synchronize()
        stats = ops.dispatch_stats()["gemm"]
        print(f"[serve] dispatch_stats={stats}")
        if stats["records"] < len(tuned):
            raise SystemExit(f"only {stats['records']} dispatches came from records")
        launches = collections.Counter(LAUNCHES)
        for shape, count in cli_launches.items():
            dims = tuple(int(d) for d in shape.split("x"))
            launches[dims] = launches.get(dims, 0) + count
        phase("5 serve", t0)
        set_global_records(TuningRecords())

        print(f"[launches] GEMM path: {sum(launches.values())} kernel launches "
              f"({sum(cli_launches.values())} in the CLI process)")
        for label, (dims, _) in tuned.items():
            if launches.get(dims, 0) == 0:
                raise SystemExit(f"{label}: the kernel never launched on the main path")

        # -- 6. full-width kernel vs plain, and times ----------------------------------
        t0 = time.perf_counter()
        rows = [(label, dims, kernel_config_from_state(served[label]))
                for label, (dims, _) in tuned.items()]
        set_global_records(TuningRecords(records_path))  # the configs the serve takes
        tuned_dims = {dims for dims, _ in tuned.values()}
        for dims in SERVED_SHAPES:
            if dims not in tuned_dims:
                cfg, src = ops.kernel_config(*dims, torch.bfloat16)
                rows.append((f"served {'prefill' if dims[0] > 8 else 'decode'} {src} "
                             f"{'x'.join(map(str, dims))}", dims, cfg))
        set_global_records(TuningRecords())
        full_width_faults = {(32768, 4096, 4096): "wrong_ring_slot", DECODE_TUNED: "split_k_drop"}
        kernels, gemm_rows = [], {}
        for label, (m, k, n), cfg in rows:
            a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
            ref = gemm_plain(a, b, cfg)
            out = gemm_tiled(a, b, cfg)
            err = check_close(f"full-width {label} {(m, k, n)}", out, ref, torch.bfloat16,
                              gemm_tol(k))
            need = atol_needed(out, ref, TOL[torch.bfloat16][0])
            del out
            if (m, k, n) in full_width_faults:
                fault = full_width_faults[(m, k, n)]
                refuse_gemm_fault(f"{(m, k, n)}", fault, gemm_fault_libs[fault], a, b, cfg, ref)
            del ref
            # timed as every earlier row was (ms, library_ms, plain_ms), and
            # with the card spun while the host enqueues (the *_spin fields);
            # each pair back to back, the long plain version last
            ms = timed_ms(lambda: gemm_tiled(a, b, cfg), 3, flush)
            ms_spin = timed_ms(lambda: gemm_tiled(a, b, cfg), 3, flush, spin=True)
            lib_ms = timed_ms(lambda: torch.matmul(a, b), 5, flush)
            lib_ms_spin = timed_ms(lambda: torch.matmul(a, b), 5, flush, spin=True)
            plain_ms = timed_ms(lambda: gemm_plain(a, b, cfg), 1, flush)
            flops, nbytes = 2 * m * k * n, 2 * (m * k + k * n + m * n)
            bound_ms = 1e3 * max(flops / peak_ops, nbytes / peak_bytes)
            row = {
                "name": f"gemm[{label}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/gemm.cu",
                "replaces": "src/repro/kernels/gemm.py:96",
                "shape": [m, k, n], "launches_tune": launches.get((m, k, n), 0),
                "launches_serve": 0, "launches": launches.get((m, k, n), 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if flops / peak_ops >= nbytes / peak_bytes else "bytes",
                "library_ms": lib_ms, "ms_spin": ms_spin, "library_ms_spin": lib_ms_spin,
            }
            kernels.append(row)
            gemm_rows[(m, k, n)] = row
            print(f"[time] {label} {(m, k, n)} {cfg}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"roofline={bound_ms / ms:.4f} tflops={flops / ms / 1e9:.2f} "
                  f"gb_s={nbytes / ms / 1e6:.1f} vs_library={ms / lib_ms:.2f}x "
                  f"spun: kernel_ms={ms_spin:.4f} library_ms={lib_ms_spin:.4f} "
                  f"vs_library={ms_spin / lib_ms_spin:.2f}x "
                  f"max_abs_err={err} atol_needed={need:.3g} "
                  f"atol={gemm_tol(k)[torch.bfloat16][1]:.3g}", flush=True)
            del a, b
            torch.cuda.empty_cache()
        phase("6 full-width check and times", t0)

        # -- 7. the flash kernel: launch limits, kernel vs plain, refusals -------------
        t0 = time.perf_counter()
        for dtype in (torch.float32, torch.bfloat16):
            for hd in (16, 32, 64, 128):
                got = fa.kernel_max_threads(dtype, hd)
                want = flash_max_threads(hd, dtype.itemsize)
                if got != want:
                    raise SystemExit(f"flash launch limit {got} for {dtype} hd={hd} "
                                     f"disagrees with the analyzer ({want})")
        n_checked, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            for hd in (16, 32, 64, 128):
                for g in (1, 4, 8):
                    q = rand((2, 256, 2 * g, hd), dtype)
                    k, v = rand((2, 256, 2, hd), dtype), rand((2, 256, 2, hd), dtype)
                    for causal in (True, False):
                        for bq, bkv in FLASH_BLOCKS[dtype]:
                            if fa.flash_launch_error(bq, bkv, hd, q.element_size()) is not None:
                                continue
                            out = fa.flash_attention(q, k, v, bq, bkv, causal)
                            ref = fa.flash_attention_plain(q, k, v, bq, bkv, causal)
                            err = check_close(f"flash {dtype} hd={hd} G={g} causal={causal} "
                                              f"blocks=({bq},{bkv})", out, ref, dtype, FLASH_TOL)
                            worst[dtype] = max(worst[dtype], err)
                            n_checked += 1
        # the bf16 block_kv instantiations that no power-of-two sequence
        # takes, each on a sequence it divides
        for hd in (16, 32, 64, 128):
            for bkv in FLASH_ODD_BKV:
                seq = math.lcm(bkv, 128)
                q = rand((1, seq, 4, hd), torch.bfloat16)
                k, v = rand((1, seq, 2, hd), torch.bfloat16), rand((1, seq, 2, hd), torch.bfloat16)
                for causal in (True, False):
                    out = fa.flash_attention(q, k, v, 128, bkv, causal)
                    ref = fa.flash_attention_plain(q, k, v, 128, bkv, causal)
                    err = check_close(f"flash bf16 hd={hd} S={seq} causal={causal} "
                                      f"blocks=(128,{bkv})", out, ref, torch.bfloat16, FLASH_TOL)
                    worst[torch.bfloat16] = max(worst[torch.bfloat16], err)
                    n_checked += 1
        q = rand((1, 100, 4, 64), torch.bfloat16)
        k = rand((1, 100, 2, 64), torch.bfloat16)
        before = sum(fa.LAUNCHES.values())
        try:
            fa.flash_attention(q, k, k, 64, 64)
        except ValueError as e:
            print(f"[check] indivisible blocks refused: {e}")
        else:
            raise SystemExit("the flash wrapper took blocks that do not divide the sequence")
        if sum(fa.LAUNCHES.values()) != before:
            raise SystemExit("a refused flash call launched the kernel")
        torch.cuda.synchronize()
        print(f"[check] {n_checked} flash kernel/plain cases agree; max abs err "
              f"f32={worst[torch.float32]} bf16={worst[torch.bfloat16]}")
        q = rand((2, 256, 16, 128), torch.bfloat16)
        k, v = rand((2, 256, 2, 128), torch.bfloat16), rand((2, 256, 2, 128), torch.bfloat16)
        refuse_faults("q (2, 256, 16, 128)", fault_libs, q, k, v, (64, 32),
                      fa.flash_attention_plain(q, k, v, 64, 32))
        f32_flash = flash_f32_row(rand, flush, peak_bytes)
        kernels.append(f32_flash)
        phase("7 flash kernel vs plain", t0)

        # -- flash tuning path: counts zeroed here, read after phase 8 ---------------
        fa.LAUNCHES.clear()
        fa.DTYPE_LAUNCHES.clear()

        # -- 8. tune the prefill attention, then the CLI on the same records ----------
        t0 = time.perf_counter()
        (fwl,) = flash_workloads_for_arch("yi-6b", "train_4k")
        sq, skv, hd = fwl.dims
        fspace = fwl.space()
        records = TuningRecords(records_path)
        with TrialJournal(records_path + ".journal.jsonl") as journal:
            session = TuningSession(records, journal=journal, verbose=True)
            s0 = fa.state_from_blocks(*fa.default_blocks(sq, skv, hd), sq, skv)
            res = session.tune_workload(fwl, "g-bfs", Budget(max_trials=FLASH_TRIALS),
                                        tuner_kwargs={"s0": s0})
        if res.best_state is None:
            raise SystemExit(f"{fwl.label}: no finite trial")
        print(f"[tuned] {fwl.label} {fwl.dims}: best={res.best_state.as_lists()} "
              f"(blocks {res.best_state.block_q}x{res.best_state.block_kv}) "
              f"kernel_ms={res.best_cost * 1e3:.4f} seed_ms={res.trials[0].cost * 1e3:.4f} "
              f"trials={res.n_trials} (timed on q (1, {sq}, {fspace.heads}, {hd}), "
              f"k/v (1, {skv}, {fspace.kv_heads}, {hd}))", flush=True)
        out = run_cli(["repro_torch.launch.tune", "--op", "flash", "--arch", "yi-6b",
                       "--tuner", "g-bfs", "--warm-start", "--fraction", "1.0",
                       "--max-trials", str(FLASH_CLI_TRIALS), "--records", records_path])
        flash_cli = json.loads(re.search(r"flash_launches=(.*)", out).group(1))
        flash_tune_launches = sum(fa.LAUNCHES.values()) + sum(flash_cli.values())
        cli_dtype = json.loads(re.search(r"flash_dtype_launches=(.*)", out).group(1))
        f32_flash["launches_tune"] = fa.DTYPE_LAUNCHES["float32"] + cli_dtype.get("float32", 0)
        print(f"[launches] flash tuning path: {flash_tune_launches} kernel launches "
              f"({sum(flash_cli.values())} in the CLI process), float32 "
              f"{f32_flash['launches_tune']}")
        phase("8 tune flash", t0)

        # -- 9. serve yi-6b at full width on the records -------------------------------
        t0 = time.perf_counter()
        cfg = get_arch("yi-6b")
        model = Model(cfg, device="cuda")
        params = model.init_params(generator=torch.Generator(device=dev).manual_seed(0))
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        set_global_records(TuningRecords(records_path))
        blocks = ops.flash_schedule(sq, skv, hd, "bfloat16")
        print(f"[serve] yi-6b weights: {n_bytes / 1e9:.2f} GB bf16; served flash blocks "
              f"{blocks}", flush=True)
        print(f"[ptxas] served instantiation flash_fwd_bf16<{hd}, {blocks[1]}>: "
              f"{'; '.join(flash_ptxas[(hd, blocks[1])])}", flush=True)
        rng = np.random.default_rng(0)
        prompts, lens = ragged_prompts(rng, cfg, SERVE_REQUESTS, SERVE_BUCKET)
        # -- the serve path: counts zeroed here, before the prewarm (which runs
        # the decode loop once and then captures it), read just after the
        # first generate
        ops.reset_dispatch_stats()
        LAUNCHES.clear()
        fa.LAUNCHES.clear()
        fa.DTYPE_LAUNCHES.clear()
        engine = ServeEngine(cfg, params, max_batch=SERVE_REQUESTS,
                             max_len=SERVE_BUCKET + SERVE_TOKENS, prompt_buckets=[SERVE_BUCKET],
                             gen_buckets=[SERVE_TOKENS], device="cuda")
        tokens = engine.generate(prompts, SERVE_TOKENS, prompt_lens=lens)
        timing, rep = engine.last_timing, engine.cache_report()
        stats = ops.dispatch_stats()
        launched, parts = serve_launches(ops.launch_counts(), engine.launch_report())
        serve_flash = sum(n for (kind, _), n in launched.items() if kind == "flash")
        f32_flash["launches_serve"] = fa.DTYPE_LAUNCHES["float32"]
        f32_flash["launches"] = f32_flash["launches_tune"] + f32_flash["launches_serve"]
        serve_gemm = {d: n for (kind, d), n in launched.items() if kind == "gemm"}
        served_gemms = sorted(serve_gemm)
        missing = sorted(set(SERVED_SHAPES) - set(served_gemms))
        if missing:
            raise SystemExit(f"the serve never launched the GEMM kernel at {missing}")
        for dims, row in gemm_rows.items():  # the serve is a main path too
            row["launches_serve"] = serve_gemm.get(dims, 0)
            row["launches"] = row["launches_tune"] + row["launches_serve"]
        print(f"[serve] {SERVE_REQUESTS} requests, prompt lengths {lens.tolist()} -> bucket "
              f"{timing['prompt_bucket']}, {SERVE_TOKENS} tokens each: "
              f"prefill_s={timing['prefill_s']:.4f} decode_s={timing['decode_s']:.4f} "
              f"tok_s={SERVE_REQUESTS * SERVE_TOKENS / (timing['prefill_s'] + timing['decode_s']):.2f}")
        print(f"[serve] decode graph: captures={rep['captures']} replays={rep['replays']} "
              f"prewarm_s={rep['prewarm_s']:.4f}; the gen-{SERVE_TOKENS} graph records "
              f"{parts['gemm']['captured']} GEMM launches ({SERVE_TOKENS - 1} steps), which "
              f"every replay launches; GEMM launches = prefill {parts['gemm']['prefill']} + "
              f"warm-up {parts['gemm']['warmup']} + replayed {parts['gemm']['replayed']} "
              f"(= recorded x {rep['replays']} replay)")
        print(f"[serve] dispatch_stats={stats}")
        print(f"[serve] GEMM dispatch split: records={stats['gemm']['records']} "
              f"heuristic={stats['gemm']['heuristic']} matmul={stats['gemm']['matmul']}; "
              f"GEMM kernel launches={sum(serve_gemm.values())}; "
              f"flash kernel launches={serve_flash} (float32 {f32_flash['launches_serve']})")
        print(f"[serve] sample tokens: {tokens[0][:8].tolist()}")
        if stats["flash"]["records"] != cfg.n_layers or stats["flash"]["heuristic"] != 0:
            raise SystemExit(f"flash dispatch {stats['flash']}: expected {cfg.n_layers} "
                             f"records per prefill call and no heuristic")
        if serve_flash < cfg.n_layers:
            raise SystemExit(f"the flash kernel launched {serve_flash} times in the serve")
        check_tokens("yi-6b", tokens, cfg, SERVE_REQUESTS)
        want = engine.eager_reference(prompts, SERVE_TOKENS, prompt_lens=lens)
        if not np.array_equal(tokens, want):
            raise SystemExit(f"yi-6b: the graphed decode's tokens differ from the eager loop's:\n"
                             f"{tokens}\n{want}")
        print("[serve] the graphed decode's tokens equal the eager loop's on the same prefill")
        # prompt jitter inside the bucket: nothing captured, one more replay
        prompts2, lens2 = ragged_prompts(rng, cfg, SERVE_REQUESTS, SERVE_BUCKET)
        engine.generate(prompts2, SERVE_TOKENS, prompt_lens=lens2)
        rep2, t2 = engine.cache_report(), engine.last_timing
        print(f"[serve] jitter: prompt lengths {lens2.tolist()} -> bucket {t2['prompt_bucket']}: "
              f"prefill_s={t2['prefill_s']:.4f} decode_s={t2['decode_s']:.4f} "
              f"captures={rep2['captures']} replays={rep2['replays']}")
        if (rep2["captures"], rep2["replays"]) != (rep["captures"], rep["replays"] + 1):
            raise SystemExit(f"prompt jitter re-captured: {rep} -> {rep2}")
        # where the time goes: one more generate, traced (its prefill, and one
        # replay of the gen-16 graph)
        _, split = profile_generate("yi-6b", lambda: engine.generate(
            prompts, SERVE_TOKENS, prompt_lens=lens))
        print(f"[profile] GEMM device time per decode step: "
              f"{split['decode']['gemm'] / (SERVE_TOKENS - 1):.4f} ms")
        del engine, params, model
        torch.cuda.empty_cache()
        # every product the serve launched, under the config dispatch chose
        for m, k_, n in served_gemms:
            gcfg, src = ops.kernel_config(m, k_, n, torch.bfloat16)
            a, b_ = rand((m, k_), torch.bfloat16), rand((k_, n), torch.bfloat16)
            err = check_close(f"served gemm {(m, k_, n)} {gcfg}", gemm_tiled(a, b_, gcfg),
                              torch.matmul(a.float(), b_.float()), torch.bfloat16, MATMUL_TOL)
            print(f"[check] served gemm {(m, k_, n)} ({src}) {gcfg}: max abs err {err}")
            del a, b_
            torch.cuda.empty_cache()
        phase("9 serve yi-6b", t0)

        # -- 10. full-width flash vs plain, times, and the reduced model vs CPU --------
        t0 = time.perf_counter()
        b, h, kvh = SERVE_REQUESTS, cfg.n_heads, cfg.n_kv_heads
        q = rand((b, sq, h, hd), torch.bfloat16)
        k, v = rand((b, skv, kvh, hd), torch.bfloat16), rand((b, skv, kvh, hd), torch.bfloat16)
        ref = fa.flash_attention_plain(q, k, v, *blocks)
        err = check_close(f"full-width flash {blocks}", fa.flash_attention(q, k, v, *blocks),
                          ref, torch.bfloat16, FLASH_TOL)
        refuse_faults(f"q {tuple(q.shape)}", fault_libs, q, k, v, blocks, ref)
        del ref
        ms = timed_ms(lambda: fa.flash_attention(q, k, v, *blocks), 3, flush)
        plain_ms = timed_ms(lambda: fa.flash_attention_plain(q, k, v, *blocks), 1, flush)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5, flush)
        flops = 4 * b * h * hd * sq * (sq + 1) // 2  # the causal triangle's products
        nbytes = 2 * b * sq * (2 * h + 2 * kvh) * hd  # q, k, v read and o written once
        bound_ms = 1e3 * max(flops / peak_ops, nbytes / peak_bytes)
        kernels.append({
            "name": f"flash_attention[{fwl.label}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:34",
            "launches_tune": flash_tune_launches, "launches_serve": serve_flash,
            "launches": flash_tune_launches + serve_flash, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / peak_ops >= nbytes / peak_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"[time] flash q {tuple(q.shape)} k/v {tuple(k.shape)} blocks {blocks}: "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bound_ms:.4f} roofline={bound_ms / ms:.4f} "
              f"tflops={flops / ms / 1e9:.2f} max_abs_err={err}", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        set_global_records(TuningRecords())
        check_reduced_model_against_cpu(Model, get_arch, np)
        phase("10 full-width flash check, times, reduced model vs CPU", t0)
    fault_dir.cleanup()

    work = tempfile.TemporaryDirectory()  # the stores phases 11 and 12 write
    t0 = time.perf_counter()
    na2c_journal = paper_tuners(kernels, gemm_rows, rand, flush, peak_bytes, work.name)
    phase("11 N-A2C and the paper's baselines on the card", t0)

    t0 = time.perf_counter()
    tuning_at_scale(kernels, gemm_rows, rand, work.name, na2c_journal)
    phase("12 the tuner at scale: process lanes, faults, shards, learned filter, audit", t0)
    work.cleanup()
    # phase 15(a) needs no card and minutes of one CPU core: start it beside
    # phases 13, 14 and 16, whose times are the card's, after the host-timed 11-12
    dry_dir = tempfile.TemporaryDirectory()
    dry = BackgroundDryRun(dry_dir.name)

    t0 = time.perf_counter()
    serve_families(kernels)
    for row in kernels:
        row["launches"] += row["launches_families"]
    phase("13 every family served", t0)

    t0 = time.perf_counter()
    phase14 = train_yi6b(kernels, rand, flush, peak_ops, peak_bytes)
    phase("14 train yi-6b", t0)

    # phase 16 runs beside the dry run's --all too, before phase 15 waits for it
    t0 = time.perf_counter()
    remat_dots(kernels, phase14)
    head_to_head(kernels, rand, flush, peak_bytes)
    phase("16 remat dots and the head-to-head", t0)

    t0 = time.perf_counter()
    dry_run_on_card(kernels, dry, rand, flush, hw, smi)
    dry_dir.cleanup()
    phase("15 the dry run on the card", t0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


def journal_summary(path: str) -> dict:
    """Per workload key (the part before the measurement fingerprint) of
    a fresh journal: ``(trials, launchable, best seconds, first cost)`` —
    the first row is the first state measured, whose cost sets the learned
    tuners' reward scale ``c_ref`` (1.0 where it is ``inf``)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            key = row["w"].split("?")[0]
            c = math.inf if row.get("c") is None else float(row["c"])
            n, fin, best, first = out.get(key, (0, 0, math.inf, c))
            out[key] = (n + 1, fin + math.isfinite(c), min(best, c), first)
    return out


def paper_tuners(kernels: list, gemm_rows: dict, rand, flush, peak_bytes: float,
                 workdir: str) -> str:
    """Phase 11: N-A2C on the served path, the paper's comparison at
    Fig. 7's operating point, and N-A2C's determinism on the card.
    Returns the journal of (a), which phase 12 learns from."""
    from repro_torch.core import (
        AnalyticalHopperCost, Budget, GemmConfigSpace, TrialJournal, TuneCheckpointer,
        TuningRecords, TuningSession, get_op,
    )
    from repro_torch.core.records import set_global_records
    from repro_torch.core.session import Workload
    from repro_torch.core.tuners import NA2CTuner
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import LAUNCHES, gemm_plain, kernel_config_from_state

    # -- (a) N-A2C on the served path: counts zeroed here, read after the serve
    rec = os.path.join(workdir, "na2c.json")
    LAUNCHES.clear()
    ops.reset_dispatch_stats()
    out = run_cli(["repro_torch.launch.tune", "--arch", "yi-6b", "--shape", "train_4k",
                   "--tuner", "n-a2c", "--cost", "hopper", "--device", "cuda",
                   "--warm-start", "--max-trials", str(NA2C_CLI_TRIALS),
                   "--checkpoint-every", "1", "--records", rec])
    cli_launches = json.loads(re.search(r"kernel_launches=(.*)", out).group(1))
    records = TuningRecords(rec)
    with TrialJournal(rec + ".journal.jsonl") as journal:
        session = TuningSession(records, journal=journal, verbose=True, device="cuda")
        wl = Workload("gemm", DECODE_TUNED, dtype="bfloat16", label="yi-6b/decode_ffn_in")
        # warm-started like the CLI's workloads: the session skips the
        # tuned shapes' wgmma tiles, which M = 8 cannot launch
        m, k, n = DECODE_TUNED
        res = session.tune_workload(
            wl, "n-a2c", Budget(max_trials=NA2C_DECODE_TRIALS), warm_start=True,
            checkpointer=TuneCheckpointer(rec + ".tunestate", every_rounds=1))
        s0 = res.trials[0].state
        if not math.isfinite(res.trials[0].cost):
            raise SystemExit(f"the warm start of {DECODE_TUNED} seeded {s0.as_lists()}, "
                             f"which the kernel cannot launch")
        print(f"[na2c] warm-started {DECODE_TUNED} from {s0.as_lists()} "
              f"({kernel_config_from_state(s0)}), seed_ms={res.trials[0].cost * 1e3:.4f}",
              flush=True)
    if res.best_state is None:
        raise SystemExit("N-A2C found no launchable state of the decode product")
    set_global_records(TuningRecords(rec))
    a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
    cfg, src = ops.kernel_config(m, k, n, torch.bfloat16)
    got = ops.gemm(a, b)
    torch.cuda.synchronize()
    launches = collections.Counter(LAUNCHES)
    if src != "records" or ops.dispatch_stats()["gemm"]["records"] < 1:
        raise SystemExit(f"the decode product was not served from N-A2C's record ({src})")
    err = check_close(f"N-A2C-tuned decode {DECODE_TUNED} {cfg}", got, gemm_plain(a, b, cfg),
                      torch.bfloat16, gemm_tol(k))
    print(f"[na2c] served {DECODE_TUNED} through gemm() from its record: {cfg} "
          f"max_abs_err={err}", flush=True)
    set_global_records(TuningRecords())
    for shape, count in cli_launches.items():
        launches[tuple(int(d) for d in shape.split("x"))] += count
    n_snap = len(os.listdir(rec + ".tunestate"))
    for key, (n_tr, fin, best, first) in journal_summary(rec + ".journal.jsonl").items():
        print(f"[na2c] {key}: trials={n_tr} launchable={fin} ({fin / n_tr:.3f}) "
              f"best_ms={best * 1e3:.4f} c_ref={first if math.isfinite(first) else 1.0}",
              flush=True)
    print(f"[na2c] snapshot directories: {n_snap}; kernel launches on the path: "
          f"{sum(launches.values())} ({sum(cli_launches.values())} in the CLI process)")
    for dims, count in launches.items():
        if dims in gemm_rows:
            gemm_rows[dims]["launches_tune"] += count
            gemm_rows[dims]["launches"] += count
    if launches.get(DECODE_TUNED, 0) == 0 or not cli_launches:
        raise SystemExit("N-A2C's path never launched the GEMM kernel")
    del a, b, got
    na2c_journal = rec + ".journal.jsonl"

    # -- (b) the paper's comparison at Fig. 7's operating point --------------------
    paper_comparison(kernels, rand, flush, peak_bytes)

    # -- (c) N-A2C twice on the card: one seed, one trial sequence -------------------
    space = GemmConfigSpace(256, 256, 256)
    cost = AnalyticalHopperCost(space, dtype="float32")
    s0 = get_op("gemm").default_state(space, "float32")
    runs = [NA2CTuner(space, cost, seed=0, s0=s0, device="cuda").tune(
        Budget(max_trials=NA2C_REPEAT_TRIALS)) for _ in range(2)]
    seqs = [[(t.state.key(), t.cost) for t in r.trials] for r in runs]
    print(f"[na2c] two runs on the card (256^3 float32 model, seed 0): trials="
          f"{len(seqs[0])} identical={seqs[0] == seqs[1]} best={runs[0].best_cost:.4e}s",
          flush=True)
    if seqs[0] != seqs[1] or len(seqs[0]) != NA2C_REPEAT_TRIALS:
        raise SystemExit("N-A2C on the card gave two different trial sequences")
    return na2c_journal


def draw_counter(rnn_controller):
    """The RNN controller's draw counts by seed (``DRAWS``), zeroed; None
    for a package from before they were counted (``--search-only`` on an
    older tree)."""
    draws = getattr(rnn_controller, "DRAWS", None)
    if draws is not None:
        draws.clear()
    return draws


def draws_note(draws, seed: int, wall_s: float) -> str:
    """The RNN controller's draws in a search under ``seed`` and its wall
    time per draw (the measurements included), for its ``[paper]`` and
    ``[compare]`` lines; empty where the draws are not counted."""
    if draws is None:
        return ""
    n = draws[seed]
    return f" draws={n} wall_us_per_draw={1e6 * wall_s / max(n, 1):.2f}"


def paper_comparison(kernels: list, rand, flush, peak_bytes: float) -> None:
    """Phase 11(b): Fig. 7's operating point on the card, every tuner of
    ``TUNERS`` once on 1024^3 float32 (the SIMT kernel); adds the
    ``gemm[paper/1024^3-f32]`` row."""
    from repro_torch.core import Budget, GemmConfigSpace, TuningRecords, TuningSession
    from repro_torch.core.session import Workload
    from repro_torch.core.tuners import TUNERS, rnn_controller
    from repro_torch.core.analysis import HopperSpec, _gemm_state_launch_error
    from repro_torch.kernels.gemm import LAUNCHES, gemm_plain, gemm_tiled, kernel_config_from_state

    # how much of the space each dtype's kernels can launch at all
    paper_space, spec = GemmConfigSpace(*PAPER_DIMS), HopperSpec()
    n_launch = collections.Counter()
    for st in paper_space.enumerate():
        for in_bytes in (2, 4):
            n_launch[in_bytes] += _gemm_state_launch_error(paper_space, st, in_bytes, spec) is None
    print(f"[paper] launchable states of GemmConfigSpace{PAPER_DIMS} (default HopperSpec): "
          f"bfloat16 {n_launch[2]}, float32 {n_launch[4]} of {paper_space.size()}", flush=True)
    LAUNCHES.clear()
    draws = draw_counter(rnn_controller)
    results = {}
    for name in TUNERS:
        session = TuningSession(TuningRecords(), verbose=False, device="cuda")
        wl = Workload("gemm", PAPER_DIMS, dtype="float32", label="paper/1024^3-f32")
        results[name] = session.tune_workload(wl, name, Budget(max_fraction=0.001), seed=0,
                                              warm_start=True, analyze="prune")
        torch.cuda.empty_cache()
    paper_launches = sum(LAUNCHES.values())  # read before the checks' launches
    m, k, n = PAPER_DIMS
    a, b = rand((m, k), torch.float32), rand((k, n), torch.float32)
    best_ms, worst_err = {}, 0.0
    for name, res in results.items():
        n_fin = sum(math.isfinite(t.cost) for t in res.trials)
        if res.best_state is None:  # grid's first states in enumeration order cannot launch
            print(f"[paper] tuner={name} trials={res.n_trials} launchable=0 (0.000) "
                  f"best_ms=inf wall_s={res.wall_s:.2f} clock_s={res.clock_s:.2f}", flush=True)
            continue
        cfg = kernel_config_from_state(res.best_state)
        err = check_close(f"[paper] {name} best {cfg}", gemm_tiled(a, b, cfg),
                          gemm_plain(a, b, cfg), torch.float32)
        worst_err = max(worst_err, err)
        best_ms[name] = timed_ms(lambda: gemm_tiled(a, b, cfg), 20, flush, spin=True)
        found = next(i for i, t in enumerate(res.trials) if t.cost == res.best_cost) + 1
        # the learned tuners' reward scale: the first state's cost, 1.0 if inf
        c0 = res.trials[0].cost
        c_ref = (f" c_ref={c0 if math.isfinite(c0) else 1.0}"
                 if name in ("n-a2c", "rnn-controller") else "")
        if name == "rnn-controller":  # its draws, most of them already measured
            c_ref += draws_note(draws, 0, res.wall_s)
        print(f"[paper] tuner={name} trials={res.n_trials} launchable={n_fin} "
              f"({n_fin / res.n_trials:.3f}) best_ms={best_ms[name]:.4f} "
              f"measured_ms={res.best_cost * 1e3:.4f} found_at={found} "
              f"wall_s={res.wall_s:.2f} clock_s={res.clock_s:.2f} "
              f"first={res.trials[0].state.key()}{c_ref} config={cfg} max_abs_err={err}",
              flush=True)
    lib_ms = timed_ms(lambda: torch.matmul(a, b), 20, flush, spin=True)
    lib_unspun = timed_ms(lambda: torch.matmul(a, b), 20, flush)
    missing = {"g-bfs", "n-a2c", "xgboost-like", "rnn-controller"} - set(best_ms)
    if missing:
        raise SystemExit(f"no launchable state from the paper's tuners {sorted(missing)}")
    fastest = min(best_ms, key=best_ms.get)
    cfg = kernel_config_from_state(results[fastest].best_state)
    ms_unspun = timed_ms(lambda: gemm_tiled(a, b, cfg), 20, flush)
    plain_ms = timed_ms(lambda: gemm_plain(a, b, cfg), 1, flush)
    flops, nbytes = 2 * m * k * n, 4 * (m * k + k * n + m * n)
    bound_ms = 1e3 * max(flops / FP32_PEAK, nbytes / peak_bytes)

    def ratio(slow: str, fast: str) -> str:
        r = best_ms[slow] / best_ms[fast]
        return f"{fast}_vs_{slow}={r:.4f} ({(1 - 1 / r) * 100:+.1f}% time saved)"

    print(f"[paper] headline at 0.1%: {ratio('xgboost-like', 'g-bfs')} "
          f"{ratio('rnn-controller', 'g-bfs')} {ratio('xgboost-like', 'n-a2c')} "
          f"{ratio('rnn-controller', 'n-a2c')}; torch.matmul f32 (no TF32) "
          f"library_ms={lib_ms:.4f}, bound_ms={bound_ms:.4f} (fp32 peak 66.9 TFLOP/s); "
          f"fastest {fastest} {best_ms[fastest]:.4f} ms = {best_ms[fastest] / lib_ms:.2f}x "
          f"torch.matmul, {bound_ms / best_ms[fastest]:.3f} of the bound", flush=True)
    kernels.append({
        "name": "gemm[paper/1024^3-f32]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:96", "shape": list(PAPER_DIMS),
        "launches_tune": paper_launches, "launches_serve": 0, "launches": paper_launches,
        "max_abs_err": worst_err, "ms": ms_unspun, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / FP32_PEAK >= nbytes / peak_bytes else "bytes",
        "library_ms": lib_unspun, "ms_spin": best_ms[fastest], "library_ms_spin": lib_ms,
    })
    del a, b


def tuning_at_scale(kernels: list, gemm_rows: dict, rand, workdir: str,
                    na2c_journal: str) -> None:
    """Phase 12: the tune path at scale on the card, at yi-6b's full width.
    (a) G-BFS on yi-6b's five bf16 GEMMs, the decode product and the
    prefill attention through worker processes that each open the card
    and time the kernels through its one timing gate, over a measured
    backend with planted crashes, hangs and corrupt values, retried; once
    with one lane and once with ``SCALE_LANES``; (b) two concurrent
    ``tune --shard i/2`` processes over one journal; (c) ``learn train``
    and ``eval`` on the journals of phase 11 and (a), the analytical
    model's rank order against the measured times, and a ``tune
    --learned-filter on`` rerun; (d) ``analyze --strict`` over every store
    of (a)-(c)."""
    import numpy as np

    from repro_torch.core import (
        AnalyticalHopperCost, Budget, FaultInjectionCost, FaultPlan, HopperTimedCost,
        ProcessExecutor, RetryPolicy, TrialJournal, TuningRecords, TuningSession, get_op,
        parse_workload_key_generic, state_from_lists,
    )
    from repro_torch.core.cost.measured import TimingGate, timing_lock_path
    from repro_torch.core.learn import spearman_rank_corr
    from repro_torch.core.records import iter_journal_rows, set_global_records
    from repro_torch.core.session import Workload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import LAUNCHES, gemm_plain, gemm_tiled, kernel_config_from_state
    from repro_torch.launch.tune import flash_workloads_for_arch, workloads_for_arch

    workloads = (workloads_for_arch("yi-6b", "train_4k")
                 + [Workload("gemm", DECODE_TUNED, dtype="bfloat16", label="yi-6b/decode_ffn_in")]
                 + flash_workloads_for_arch("yi-6b", "train_4k"))
    seeds = [get_op(wl.op).default_state(wl.space(), wl.dtype).key() for wl in workloads]
    plan = next(p for p in (FaultPlan(seed=i, **SCALE_PLAN) for i in range(10_000))
                if {"crash", "hang", "corrupt"} <= {p.fault_for(k) for k in seeds})
    gate = TimingGate(timing_lock_path("cuda"))
    gate0 = gate.stats()
    LAUNCHES.clear()
    fa.LAUNCHES.clear()
    ops.reset_dispatch_stats()

    # -- (a) process lanes sharing the card, planted faults, retries ----------------
    launches, flash_launches, flash_f32, runs = collections.Counter(), 0, 0, {}
    for n_lanes in (1, SCALE_LANES):
        root = os.path.join(workdir, f"lanes{n_lanes}")
        rec = os.path.join(root, "yi-6b.json")

        def factory(space, dtype="bfloat16", _dir=os.path.join(root, "faults")):
            return FaultInjectionCost(HopperTimedCost(space, dtype=dtype), plan, fault_dir=_dir)

        t = time.perf_counter()
        # a budget no slot exhausts: a degraded slot would measure in this
        # process, where a planted crash would end the script
        with ProcessExecutor(timeout_s=SCALE_LANE_TIMEOUT_S, max_respawns=1000) as ex, \
                TrialJournal(rec + ".journal.jsonl") as journal:
            session = TuningSession(TuningRecords(rec), cost_factory=factory, journal=journal,
                                    verbose=False, device="cuda")
            t_spawn = time.perf_counter()
            ex.warm_up(n_lanes)  # the workers' start, before any backend exists
            spawn_s = time.perf_counter() - t_spawn
            report = session.tune_arch(
                workloads=workloads, tuner_name="g-bfs", n_workers=n_lanes, warm_start=True,
                budget=Budget(max_trials=SCALE_TRIALS * len(workloads)), executor=ex,
                retry=RetryPolicy(max_attempts=3, backoff_s=0.05, seed=0))
            workers = ex.worker_call("repro_torch.core.cost.measured:worker_stats")
            fstats = ex.fault_stats()
        wall = time.perf_counter() - t
        fates = collections.Counter(plan.fault_for(t.state.key())
                                    for r in report.distinct_results() for t in r.trials)
        st = report.stats
        search_s = sum(r.wall_s for r in report.distinct_results())
        print(f"[scale] lanes={n_lanes} wall_s={wall:.2f} (workers' start {spawn_s:.2f}, "
              f"searches {search_s:.2f}, the rest the backends' builds and prewarm) "
              f"trials={report.total_trials} "
              f"clock_s={report.total_clock_s:.2f} planted_on_measured="
              f"crash:{fates['crash']},hang:{fates['hang']},corrupt:{fates['corrupt']} "
              f"retries={st.n_retries} recovered={st.n_transient_recovered} "
              f"failed_transient={st.n_failed_transient} stragglers={st.n_stragglers} "
              f"fault_stats={fstats}", flush=True)
        print(f"[scale] lanes={n_lanes} search wall by workload: " + ", ".join(
            f"{label} {r.wall_s:.2f} s" for label, r in report.results.items()), flush=True)
        for w in workers:
            print(f"[scale] lanes={n_lanes} worker {w['pid']}: peak_allocated="
                  f"{w['peak_allocated'] / 1e9:.3f} GB peak_reserved="
                  f"{w['peak_reserved'] / 1e9:.3f} GB", flush=True)
        planted = fates["crash"] + fates["hang"] + fates["corrupt"]
        if st.n_failed_transient or st.n_transient_recovered < planted:
            raise SystemExit(f"lanes={n_lanes}: {st.n_failed_transient} transients not "
                             f"recovered ({st.n_transient_recovered} of {planted} planted)")
        if fstats["n_respawns"] < fates["crash"] or fstats["n_degraded_lanes"]:
            raise SystemExit(f"lanes={n_lanes}: {fstats} for {fates['crash']} planted crashes")
        if min(fates["crash"], fates["hang"], fates["corrupt"]) < 1:
            raise SystemExit(f"lanes={n_lanes}: a planted fault kind never fired: {fates}")
        for w in workers:  # the launches of the workers alive at the end
            for shape, count in w["gemm_launches"].items():
                launches[tuple(int(d) for d in shape.split("x"))] += count
            flash_launches += sum(w["flash_launches"].values())
            flash_f32 += w["flash_dtype_launches"].get("float32", 0)
        runs[n_lanes] = (report, rec, wall)
    gate1 = gate.stats()
    overlaps = gate1["overlaps"] - gate0["overlaps"]
    print(f"[scale] timing gate {gate.lock_path}: {gate1['entries'] - gate0['entries']} "
          f"timed regions, {overlaps} found another holder inside", flush=True)
    if overlaps or gate1["entries"] == gate0["entries"]:
        raise SystemExit(f"timed regions overlapped on the card: {gate0} -> {gate1}")
    report, rec4, wall4 = runs[SCALE_LANES]
    print(f"[scale] 1 lane {runs[1][2]:.2f} s vs {SCALE_LANES} lanes {wall4:.2f} s "
          f"({runs[1][2] / wall4:.2f}x) for {report.total_trials} trials each", flush=True)
    # the records, filed under the measured backend's name (the planted-fault
    # wrapper names its own), served by dispatch as phase 5 serves them
    serve_rec = os.path.join(workdir, "served.json")
    with open(rec4) as f:
        tuned = {k.replace("/faulty(hopper_timed)", "/hopper_timed"): v
                 for k, v in json.load(f).items()}
    with open(serve_rec, "w") as f:
        json.dump(tuned, f, indent=1, sort_keys=True)
    set_global_records(TuningRecords(serve_rec))
    bests = {}
    for wl in workloads:
        res = report.results[wl.label]
        if res.best_state is None or not math.isfinite(res.best_cost):
            raise SystemExit(f"{wl.label}: no launchable state in the lane run")
        bests[wl.label] = res.best_state
        if wl.op == "gemm":
            m, k, n = wl.dims
            cfg, src = ops.kernel_config(m, k, n, torch.bfloat16)
            a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
            err = check_close(f"[scale] gemm() {wl.label}", ops.gemm(a, b),
                              torch.matmul(a.float(), b.float()), torch.bfloat16, MATMUL_TOL)
            if src != "records" or cfg != kernel_config_from_state(res.best_state):
                raise SystemExit(f"{wl.label}: dispatch took {cfg} ({src}), not the record")
            print(f"[scale] served {wl.label} from its record: {cfg} max_abs_err={err}",
                  flush=True)
            del a, b
        else:
            sq, skv, hd = wl.dims
            blocks = ops.flash_schedule(sq, skv, hd, "bfloat16", grid_y=wl.space().heads)
            if blocks != (res.best_state.block_q, res.best_state.block_kv):
                raise SystemExit(f"{wl.label}: dispatch took blocks {blocks}, not the record")
            print(f"[scale] served {wl.label} from its record: blocks {blocks}", flush=True)
    stats = ops.dispatch_stats()["gemm"]
    if stats.get("records", 0) < len(workloads) - 1:
        raise SystemExit(f"[scale] dispatch {stats}: the tuned products were not served")
    launches.update(LAUNCHES)  # dispatch's launches; the checks below are not counted
    set_global_records(TuningRecords())
    for wl in workloads:  # every best state launches within the bf16 limit
        st, best_cost = bests[wl.label], report.results[wl.label].best_cost
        if wl.op == "gemm":
            m, k, n = wl.dims
            cfg = kernel_config_from_state(st)
            a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
            err = check_close(f"[scale] best {wl.label} {cfg}", gemm_tiled(a, b, cfg),
                              gemm_plain(a, b, cfg), torch.bfloat16, gemm_tol(k))
            del a, b
        else:
            sp = wl.space()
            q = rand((1, sp.seq_q, sp.heads, sp.head_dim), torch.bfloat16)
            k_ = rand((1, sp.seq_kv, sp.kv_heads, sp.head_dim), torch.bfloat16)
            v = rand((1, sp.seq_kv, sp.kv_heads, sp.head_dim), torch.bfloat16)
            blocks = (st.block_q, st.block_kv)
            err = check_close(f"[scale] best {wl.label} {blocks}",
                              fa.flash_attention(q, k_, v, *blocks),
                              fa.flash_attention_plain(q, k_, v, *blocks), torch.bfloat16,
                              FLASH_TOL)
            del q, k_, v
        print(f"[scale] best {wl.label}: {st.as_lists()} {best_cost * 1e3:.4f} ms "
              f"max_abs_err={err}", flush=True)
        torch.cuda.empty_cache()

    # -- (b) two shards of one search, concurrent, over one journal ---------------------
    root = os.path.join(workdir, "shards")
    os.makedirs(root)
    shard_rec, shard_jnl = os.path.join(root, "yi-6b.json"), os.path.join(root, "shared.jsonl")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.tune", "--arch", "yi-6b", "--tuner", "g-bfs",
         "--cost", "hopper", "--warm-start", "--max-trials", str(SHARD_TRIALS),
         "--records", shard_rec, "--journal", shard_jnl, "--shard", f"{i}/2",
         "--shard-wait", "300", "--checkpoint-dir", "none"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE)
        for i in range(2)]
    outs = []
    for i, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=600)
        print(out, end="")
        if proc.returncode != 0:
            raise SystemExit(f"shard {i}/2 failed ({proc.returncode})")
        outs.append(out)
    rows = list(iter_journal_rows(shard_jnl))
    measured = [{(r["w"], r["k"]) for r in rows if r.get("shard", [None])[0] == i}
                for i in range(2)]
    with open(shard_rec) as f:
        shard_records = json.load(f)
    if not measured[0] or not measured[1] or measured[0] & measured[1]:
        raise SystemExit(f"shards measured {len(measured[0])} and {len(measured[1])} states, "
                         f"{len(measured[0] & measured[1])} of them both")
    if len(shard_records) != 5:
        raise SystemExit(f"{len(shard_records)} records for yi-6b's five GEMMs")
    for key, r in shard_records.items():
        union = [row["c"] for row in rows if row["w"].split("?")[0] == key
                 and row.get("c") is not None]
        if r["cost"] != min(union) or r.get("n_shards") != 2:
            raise SystemExit(f"{key}: elected {r['cost']} of {r.get('n_shards')} shards, "
                             f"lowest in the union {min(union)}")
    for out in outs:
        for shape, count in json.loads(re.search(r"kernel_launches=(.*)", out).group(1)).items():
            launches[tuple(int(d) for d in shape.split("x"))] += count
    print(f"[scale] shards 0/2 and 1/2: {time.perf_counter() - t:.2f} s, measured "
          f"{len(measured[0])} + {len(measured[1])} disjoint states, one elected record for "
          f"each of {len(shard_records)} workloads, each the lowest cost of the union",
          flush=True)

    # -- (c) the learned filter: train and evaluate, then one filtered run --------------
    journals = [na2c_journal, rec4 + ".journal.jsonl", runs[1][1] + ".journal.jsonl"]
    args = [a for j in journals for a in ("--journal", j)] + ["--op", "gemm",
                                                              "--dtype", "bfloat16"]
    run_cli(["repro_torch.launch.learn", "train", *args])
    out = run_cli(["repro_torch.launch.learn", "eval", *args])
    corr = re.search(r"held_out_rank_corr=(\S+)", out).group(1)
    # the analytical H100 model's rank order against the same measured times
    y, pred, groups, names = [], [], [], {}
    for j in journals:
        for row in iter_journal_rows(j):
            parsed = parse_workload_key_generic(row["w"].split("?")[0])
            if row.get("c") is None or "pred" in row or parsed is None or parsed[0] != "gemm":
                continue
            op, dims, dtype, _ = parsed
            model = AnalyticalHopperCost(get_op(op).make_space(dims), dtype=dtype)
            c = model.cost(state_from_lists(op, row["s"]))
            if math.isfinite(c):
                y.append(row["c"])
                pred.append(c)
                groups.append(names.setdefault(row["w"].split("?")[0], len(names)))
    model_corr = spearman_rank_corr(np.asarray(y), np.asarray(pred), np.asarray(groups))
    print(f"[scale] learned model held-out rank correlation {corr}; analytical H100 model "
          f"vs measured times: spearman={model_corr:.4f} over {len(y)} rows in "
          f"{len(names)} workloads", flush=True)
    out = run_cli(["repro_torch.launch.tune", "--arch", "yi-6b", "--tuner", "g-bfs",
                   "--cost", "hopper", "--warm-start", "--max-trials", str(FILTER_TRIALS),
                   "--records", serve_rec, "--journal", rec4 + ".journal.jsonl",
                   "--workers", "4", "--learned-filter", "on", "--filter-min-rows", "8",
                   "--checkpoint-dir", "none"])
    avoided = int(re.search(r"trials_avoided_learned=(\d+)", out).group(1))
    for shape, count in json.loads(re.search(r"kernel_launches=(.*)", out).group(1)).items():
        launches[tuple(int(d) for d in shape.split("x"))] += count
    print(f"[scale] --learned-filter on: {avoided} candidates skipped on the model's say-so",
          flush=True)
    if avoided < 1:
        raise SystemExit("the learned filter skipped no candidate")

    # -- (d) the audit, on the Hopper kernels' rules, of every store above ---------------
    stores = {runs[1][1]: runs[1][1] + ".journal.jsonl", rec4: rec4 + ".journal.jsonl",
              serve_rec: None, shard_rec: shard_jnl}
    out = run_cli(["repro_torch.launch.analyze", "--strict"]
                  + [a for r in stores for a in ("--records", r)]
                  + [a for j in stores.values() if j for a in ("--journal", j)])
    if "permanent_for_legal=0" not in out:
        raise SystemExit("the audit found permanent failures cached for legal schedules")

    for dims, count in launches.items():
        if dims in gemm_rows:
            gemm_rows[dims]["launches_tune"] += count
            gemm_rows[dims]["launches"] += count
    for row in kernels:
        if row["name"].startswith("flash_attention["):
            row["launches_tune"] += flash_launches
            row["launches"] += flash_launches
        elif row["name"].startswith("flash_f32["):
            row["launches_tune"] += flash_f32
            row["launches"] += flash_f32
    print(f"[launches] phase 12: GEMM {sum(launches.values())} (workers alive at the end, "
          f"dispatch and the CLIs), flash {flash_launches} (float32 {flash_f32})", flush=True)
    if not all(launches.get(wl.dims, 0) for wl in workloads if wl.op == "gemm") \
            or not flash_launches:
        raise SystemExit(f"phase 12 never launched a kernel on {dict(launches)}")


def profile_generate(label: str, fn):
    """Run ``fn`` (one ``ServeEngine.generate``) once under
    ``torch.profiler`` and split the device time of its two ranges,
    ``serve.prefill`` and ``serve.decode`` (the graph's replay), by kernel
    kind (the GEMM kernel, the flash kernel, the rest).  Each range ends in
    a host sync, so the kernels that start inside it are its own; its
    idle share is the part of the range in which no kernel ran.  Prints the
    call's host wall time and, per range, its span and kernel count.
    Returns ``(fn(), {"prefill": split, "decode": split})``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    ranges = {ev.name: ev.time_range for ev in events
              if ev.name in ("serve.prefill", "serve.decode")
              and ev.device_type == torch.autograd.DeviceType.CPU}
    kernels = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.name.startswith("serve.")]
    print(f"[profile] {label}: one generate traced, wall_ms={wall_ms:.2f}", flush=True)
    splits = {}
    for name in ("prefill", "decode"):
        r = ranges[f"serve.{name}"]
        inside = [ev for ev in kernels if r.start <= ev.time_range.start < r.end]
        split = {"gemm": 0.0, "flash": 0.0, "other": 0.0}
        for ev in inside:
            kind = ("gemm" if "gemm_tiled" in ev.name else
                    "flash" if "flash_fwd" in ev.name else "other")
            split[kind] += ev.time_range.elapsed_us() / 1e3
        span_ms = (r.end - r.start) / 1e3
        busy = sum(split.values())
        shares = " ".join(f"{k}_ms={v:.2f} ({v / max(busy, 1e-9):.1%} of busy)"
                          for k, v in split.items())
        print(f"[profile] {label} {name}: range_ms={span_ms:.2f} device_busy_ms={busy:.2f} "
              f"idle_share={1 - busy / span_ms:.4f} kernels_traced={len(inside)} {shares}",
              flush=True)
        splits[name] = split
    return out, splits


def ragged_prompts(rng, cfg, n: int, bucket: int):
    """``n`` prompts of lengths in ``(bucket / 2, bucket]``, the first a
    whole bucket, right-padded to the longest: ``(prompts, lengths)``."""
    lens = rng.integers(bucket // 2 + 1, bucket + 1, n)
    lens[0] = bucket
    prompts = np.zeros((n, bucket), np.int64)
    for i, m in enumerate(lens):
        prompts[i, :m] = rng.integers(0, cfg.vocab_size, m)
    return prompts, lens


def check_tokens(label: str, tokens, cfg, n: int) -> None:
    if tokens.shape != (n, SERVE_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise SystemExit(f"{label}: served tokens of shape {tokens.shape} outside [0, vocab)")


def serve_launches(counts, report):
    """The launches one serve path made, from the kernels' host counts
    zeroed before its engine (``ops.launch_counts()``) and the engine's
    ``launch_report()``: the counts, less what the captures recorded (run
    at no capture), plus what the replays launched.  Returns that
    ``Counter`` by ``(kernel, dims)`` and, per kernel, the totals of its
    parts: ``prefill``, ``warmup``, ``captured`` (one replay's) and
    ``replayed``."""
    launched = counts - report["captured"] + report["replayed"]
    parts = {}
    for kernel in ("gemm", "flash"):
        def total(c):
            return sum(n for (kind, _), n in c.items() if kind == kernel)
        part = {name: total(report[name]) for name in ("warmup", "captured", "replayed")}
        part["prefill"] = total(counts) - part["warmup"] - part["captured"]
        parts[kernel] = part
    return launched, parts


def serve_families(kernels: list) -> None:
    """Phase 13: one arch of each family this port serves beside dense,
    through ``ServeEngine`` with the graphed decode (random bf16 weights
    from a seeded generator, 16 tokens), each freed before the next.  Each
    path's counts are zeroed before its engine (whose prewarm runs the
    decode loop once, then captures it) and read after its first
    generate; they are added to ``kernels``' rows as
    ``launches_families``.  Checks the tokens lie in [0, vocab) and equal
    the eager loop's on the same prefill, that the GEMM kernel launched,
    and that flash launched where the prompt exceeds the threshold (no
    softcap); traces one more generate (``[profile]`` lines); then, the
    model freed, holds each kernel against its reference at every shape
    the path launched it on (``[check]`` lines; the ``[family]`` line
    gives the worst errors)."""
    import dataclasses
    import gc

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import LAUNCHES, gemm_tiled
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.api import Model

    for row in kernels:
        row["launches_families"] = 0
    for name, layers, reqs, bucket, n_front in FAMILIES:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        depth = f"{cfg.n_layers} layers"
        if layers:
            depth = f"{layers} of {cfg.n_layers} layers"
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = Model(cfg, device="cuda")
        params = model.init_params(generator=gen)
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        paddable = cfg.family not in ("ssm", "hybrid")
        rng = np.random.default_rng(13)
        if paddable:
            prompts, lens = ragged_prompts(rng, cfg, reqs, bucket)
        else:
            lens = np.full(reqs, bucket)
            prompts = rng.integers(0, cfg.vocab_size, (reqs, bucket))
        fe = None
        if n_front:
            fe = (torch.randn((reqs, n_front, cfg.d_model), generator=gen, device="cuda")
                  * cfg.d_model ** -0.5).to(getattr(torch, cfg.compute_dtype))
        max_len = n_front + bucket + SERVE_TOKENS
        t_init = time.perf_counter() - t0
        # -- this family's serve path: counts zeroed here, read after its first generate
        ops.reset_dispatch_stats()
        LAUNCHES.clear()
        fa.LAUNCHES.clear()
        fa.DTYPE_LAUNCHES.clear()
        engine = ServeEngine(cfg, params, max_batch=reqs, max_len=max_len,
                             prompt_buckets=[bucket] if paddable else None,
                             gen_buckets=[SERVE_TOKENS], device="cuda")
        tokens = engine.generate(prompts, SERVE_TOKENS, prompt_lens=lens, frontend_embeds=fe)
        timing, rep, stats = engine.last_timing, engine.cache_report(), ops.dispatch_stats()
        launched, parts = serve_launches(ops.launch_counts(), engine.launch_report())
        flash_f32 = fa.DTYPE_LAUNCHES["float32"]
        peak = torch.cuda.max_memory_allocated()
        check_tokens(name, tokens, cfg, reqs)
        want = engine.eager_reference(prompts, SERVE_TOKENS, prompt_lens=lens,
                                      frontend_embeds=fe)
        if not np.array_equal(tokens, want):
            raise SystemExit(f"{name}: the graphed decode's tokens differ from the eager "
                             f"loop's:\n{tokens}\n{want}")
        # where the time goes: one more generate, traced
        profile_generate(name, lambda: engine.generate(prompts, SERVE_TOKENS, prompt_lens=lens,
                                                       frontend_embeds=fe))
        del engine, params, model, fe
        gc.collect()
        torch.cuda.empty_cache()
        seq = n_front + bucket
        if not (parts["gemm"]["prefill"] and parts["gemm"]["replayed"]):
            raise SystemExit(f"{name}: the GEMM kernel did not launch in both its prefill and "
                             f"its decode graph: {parts['gemm']}")
        if (seq > cfg.attn_chunk_threshold and cfg.family != "ssm"
                and cfg.attn_softcap == 0 and parts["flash"]["prefill"] == 0):
            raise SystemExit(f"{name}: the flash kernel never launched on a {seq}-token prefill")
        for row in kernels:
            if row["name"].startswith("flash_attention"):
                row["launches_families"] += sum(
                    n for (kind, _), n in launched.items() if kind == "flash")
            elif row["name"].startswith("flash_f32["):
                row["launches_families"] += flash_f32
            elif row.get("shape"):
                row["launches_families"] += launched.get(("gemm", tuple(row["shape"])), 0)
        gemm_err, flash_err = check_served_kernels(
            name, launched, reqs, cfg.n_heads, cfg.n_kv_heads, gen, ops, fa, gemm_tiled)
        g = stats.get("gemm", {})
        print(f"[family] {name} ({cfg.family}, {depth}, weights {n_bytes / 1e9:.2f} GB bf16, "
              f"init {t_init:.1f}s): {reqs} requests x {seq} tokens"
              f"{f' ({n_front} frontend + bucket {bucket})' if n_front else ''}, "
              f"{SERVE_TOKENS} tokens each: prefill_s={timing['prefill_s']:.4f} "
              f"decode_s={timing['decode_s']:.4f} "
              f"tok_s={reqs * SERVE_TOKENS / (timing['prefill_s'] + timing['decode_s']):.2f} "
              f"peak_gb={peak / 1e9:.2f}; captures={rep['captures']} replays={rep['replays']} "
              f"prewarm_s={rep['prewarm_s']:.4f}; GEMM dispatch records={g.get('records', 0)} "
              f"heuristic={g.get('heuristic', 0)} matmul={g.get('matmul', 0)}; GEMM launches "
              f"prefill {parts['gemm']['prefill']} + warm-up {parts['gemm']['warmup']} + "
              f"replayed {parts['gemm']['replayed']} (the graph records "
              f"{parts['gemm']['captured']}, x {rep['replays']} replay); flash dispatch "
              f"{stats.get('flash', {})}, launches {parts['flash']['prefill']}; tokens equal "
              f"the eager loop's; worst error at the served shapes: GEMM {gemm_err} "
              f"flash {flash_err}; sample {tokens[0][:6].tolist()}", flush=True)
        del tokens
        phase(f"13 {name}", t0)


def train_yi6b(kernels: list, rand, flush, peak_ops: float, peak_bytes: float) -> dict:
    """Phase 14: train yi-6b (16 of 32 layers, published widths, bf16,
    AdamW, remat full) on 2 x 4096 tokens a step through ``Trainer``.
    (a) three steps, the training path's counts zeroed before and read
    after them; (b) one more step traced; (c) the model freed, the GEMM
    kernel held against an f32 ``torch.matmul`` and timed at every shape
    the steps launched it on; (d) 2-layer bf16 gradients on the card
    against f32 gradients on the CPU, and a planted dB fault refused; (e)
    a reduced yi-6b resumed on the card from a step-2 checkpoint.  Adds
    ``launches_train`` to the kernel rows (GEMM rows for the backward
    shapes too).  Returns what phase 16 holds its ``dots`` steps against:
    the losses, the GEMM launches by role and shape, the mean step, the
    peak, the traced step's busy and GEMM ms, each shape's kernel ms."""
    import dataclasses
    import gc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataPipeline, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.roofline import model_flops as roofline_model_flops
    from repro_torch.utils.tree import tree_map

    bf16 = torch.bfloat16
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=TRAIN_LAYERS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    hd = cfg.resolved_head_dim

    # -- (a) the training path: counts zeroed here, read after the third step
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    gemm_mod.reset_launches()
    fa.LAUNCHES.clear()
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0), TRAIN_BATCH)
    trainer = Trainer(cfg, pipe, None, lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 1,
                      device="cuda")
    trainer.initialize(resume=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log = trainer.train(TRAIN_STEPS)
    roles = collections.Counter(gemm_mod.ROLE_LAUNCHES)
    stats = ops.dispatch_stats()
    flash_launched = sum(fa.LAUNCHES.values())
    peak = torch.cuda.max_memory_allocated()
    for rec in log:
        print(f"[train] step {rec['step']}: loss={rec['loss']:.6f} grad_norm={rec['grad_norm']:.6f} "
              f"step_s={rec['step_time_s']:.4f}", flush=True)
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise SystemExit(f"train step {rec['step']}: loss or grad_norm not finite: {rec}")
    step_s = sum(r["step_time_s"] for r in log[1:]) / (len(log) - 1)
    n_params = cfg.n_params()
    n_mm = n_params - cfg.padded_vocab * cfg.d_model  # the embedding is a lookup
    attn_flops = (3 * 4 * TRAIN_BATCH * cfg.n_heads * hd * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
                  * TRAIN_LAYERS)
    model_flops = 6 * n_mm * tokens + attn_flops
    print(f"[train] yi-6b ({TRAIN_LAYERS} of 32 layers, {n_params / 1e9:.4f} B params, bf16, "
          f"{cfg.optimizer}, remat {cfg.remat}), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
          f"step_s={step_s:.4f} (mean of steps 2-{TRAIN_STEPS}) tok_s={tokens / step_s:.1f} "
          f"peak_gb={peak / 1e9:.2f} init_s={init_s:.1f}", flush=True)
    print(f"[train] model flops a step = 6*N*tokens + attention = 6 x {n_mm} x {tokens} + "
          f"{attn_flops} = {model_flops:.4e} (N: the params less the embedding table, a lookup; "
          f"attention: 3 x 4*B*H*hd*S*(S+1)/2 a layer, forward and backward of the causal "
          f"triangle); model_flops_share={model_flops / step_s / peak_ops:.4f} of "
          f"{peak_ops / 1e12:.0f} TFLOP/s", flush=True)
    roofline_flops = roofline_model_flops(cfg, ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH,
                                                         "train"))
    print(f"[train] roofline.model_flops (the reference's: 6 x n_active_params x tokens, the "
          f"embedding in, no attention term) = {roofline_flops:.4e}; "
          f"roofline_model_flops_share={roofline_flops / step_s / peak_ops:.4f} of "
          f"{peak_ops / 1e12:.0f} TFLOP/s", flush=True)
    if peak > 76e9:
        print(f"[train] peak {peak / 1e9:.2f} GB is above 76 GB", flush=True)
    g = stats.get("gemm", {})
    print(f"[train] dispatch_stats={stats}; GEMM records={g.get('records', 0)} "
          f"heuristic={g.get('heuristic', 0)} matmul={g.get('matmul', 0)}; flash kernel "
          f"launches={flash_launched}", flush=True)
    if flash_launched or stats.get("flash", {}).get("plain") != 2 * TRAIN_LAYERS * TRAIN_STEPS:
        raise SystemExit(f"training attention: flash launched {flash_launched}, dispatch "
                         f"{stats.get('flash')}; expected chunked attention in every forward "
                         f"and recompute")
    by_role = collections.Counter()
    for (role, _), n in roles.items():
        by_role[role] += n
    if sorted(by_role) != ["dA", "dB", "forward", "recompute"]:
        raise SystemExit(f"the GEMM kernel did not launch in every part of the step: {by_role}")
    shapes = sorted({dims for _, dims in roles})
    print(f"[train] GEMM launches over {TRAIN_STEPS} steps: {dict(by_role)}", flush=True)
    for dims in shapes:
        print(f"[train] GEMM launches at {dims}: "
              f"{ {r: roles[(r, dims)] for r in by_role if roles[(r, dims)]} }", flush=True)

    # -- (b) one more step, traced
    step_roles, busy, gemm_ms = trace_train_step(trainer, TRAIN_STEPS + 1, step_s)
    # the optimizer alone (clip and update), timed with CUDA events on the
    # trainer's own state, which the model's end makes free to change
    grads = tree_map(torch.zeros_like, trainer.params)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    clipped, _ = clip_by_global_norm(grads, 1.0)
    trainer.optimizer.update(clipped, trainer.opt_state, trainer.params)
    end.record()
    end.synchronize()
    opt_ms = start.elapsed_time(end)
    del trainer, pipe, grads, clipped
    gc.collect()
    torch.cuda.empty_cache()

    # chunked attention at the step's shape, alone: a layer's forward, and
    # its recompute with the backward
    q = rand((TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, hd), bf16).requires_grad_()
    k = rand((TRAIN_BATCH, TRAIN_SEQ, cfg.n_kv_heads, hd), bf16).requires_grad_()
    v = rand((TRAIN_BATCH, TRAIN_SEQ, cfg.n_kv_heads, hd), bf16).requires_grad_()
    go = rand((TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, hd), bf16)
    fwd_ms = timed_ms(lambda: cm.chunked_causal_attention(q, k, v), 3, flush, spin=True)
    both_ms = timed_ms(lambda: torch.autograd.grad(cm.chunked_causal_attention(q, k, v),
                                                   [q, k, v], go), 3, flush, spin=True)
    attn_ms = TRAIN_LAYERS * (fwd_ms + both_ms)
    del q, k, v, go
    torch.cuda.empty_cache()

    # -- (c) every shape the steps launched the GEMM kernel on: kernel
    # against an f32 torch.matmul, under the config dispatch chose, and times
    rows = {tuple(r["shape"]): r for r in kernels if r.get("shape")}
    kernel_ms = {}
    for dims in shapes:
        m, k_, n = dims
        gcfg, src = ops.kernel_config(m, k_, n, bf16)
        a, b = rand((m, k_), bf16), rand((k_, n), bf16)
        out = gemm_mod.gemm_tiled(a, b, gcfg)
        ref = torch.matmul(a.float(), b.float())
        need = atol_needed(out, ref, TOL[bf16][0])
        print(f"[train-gemm] {dims}: atol needed against an f32 matmul {need:.4g} "
              f"(gemm_tol atol {gemm_tol(k_)[bf16][1]:.4g})", flush=True)
        err = check_close(f"train gemm {dims} {gcfg}", out, ref, bf16, gemm_tol(k_))
        del out, ref
        ms_spin = timed_ms(lambda: gemm_mod.gemm_tiled(a, b, gcfg), 3, flush, spin=True)
        lib_spin = timed_ms(lambda: torch.matmul(a, b), 3, flush, spin=True)
        flops, nbytes = 2 * m * k_ * n, 2 * (m * k_ + k_ * n + m * n)
        bound_ms = 1e3 * max(flops / peak_ops, nbytes / peak_bytes)
        kernel_ms[dims] = ms_spin
        parts = {r: roles[(r, dims)] for r in ("forward", "recompute", "dA", "dB")}
        row = rows.get(dims)
        if row is None:
            ms = timed_ms(lambda: gemm_mod.gemm_tiled(a, b, gcfg), 3, flush)
            lib_ms = timed_ms(lambda: torch.matmul(a, b), 3, flush)
            plain_ms = timed_ms(lambda: gemm_mod.gemm_plain(a, b, gcfg), 1, flush)
            row = {
                "name": f"gemm[train {'/'.join(r for r, c in parts.items() if c)} "
                        f"{'x'.join(map(str, dims))}]",
                "route": "cuda", "source": "src/repro_torch/kernels/csrc/gemm.cu",
                "replaces": "src/repro/kernels/gemm.py:96", "shape": list(dims),
                "launches_tune": 0, "launches_serve": 0, "launches_families": 0,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if flops / peak_ops >= nbytes / peak_bytes else "bytes",
                "library_ms": lib_ms, "ms_spin": ms_spin, "library_ms_spin": lib_spin,
            }
            kernels.append(row)
            rows[dims] = row
        row["launches_train"] = sum(parts.values())
        row["launches_train_parts"] = parts
        row["launches"] += row["launches_train"]
        print(f"[train-gemm] {dims} ({src}) {gcfg} launches {parts}: kernel_ms={ms_spin:.4f} "
              f"library_ms={lib_spin:.4f} bound_ms={bound_ms:.4f} roofline={bound_ms / ms_spin:.4f} "
              f"tflops={flops / ms_spin / 1e9:.2f} vs_library={ms_spin / lib_spin:.2f}x (spun); "
              f"max abs err vs f32 matmul {err} atol_needed={need:.3g} "
              f"atol={gemm_tol(k_)[bf16][1]:.3g}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    for row in kernels:
        if row["name"].startswith(("flash_attention", "flash_f32[")):
            row["launches_train"] = 0
            row["train"] = "not on the training path: the kernel has no backward"
        else:
            row.setdefault("launches_train", 0)
    est = {role: sum(step_roles[(role, d)] * kernel_ms[d] for d in shapes)
           for role in ("forward", "recompute", "dA", "dB")}
    rest = busy - gemm_ms - attn_ms - opt_ms
    print(f"[profile] where step {TRAIN_STEPS + 1}'s {busy:.2f} ms of device time goes: GEMM kernel "
          f"{gemm_ms:.2f} (traced; from one step's launch counts x each shape's spun time: "
          f"{ {r: round(t, 2) for r, t in est.items()} }, sum {sum(est.values()):.2f}); chunked "
          f"attention ~{attn_ms:.2f} ({TRAIN_LAYERS} x (forward {fwd_ms:.2f} + recompute and "
          f"backward {both_ms:.2f}), timed alone); optimizer {opt_ms:.2f} (clip + AdamW update, "
          f"timed alone); the rest ~{rest:.2f}", flush=True)

    # -- (d) gradients end to end: bf16 on the card against f32 on the CPU
    t0 = time.perf_counter()
    grad_rel, fault_rel = gradients_card_vs_cpu(get_arch("yi-6b"))
    print(f"[grad] yi-6b ({GRAD_LAYERS} layers, published widths) on 1 x {GRAD_SEQ} tokens: "
          f"worst per-leaf relative L2 error, card bf16 vs CPU f32: {worst(grad_rel):.4g} "
          f"(limit {GRAD_REL_LIMIT}); with dB computed from a transposed operand: "
          f"{max(fault_rel.values()):.4g} ({time.perf_counter() - t0:.1f}s)", flush=True)
    for path in sorted(grad_rel, key=grad_rel.get, reverse=True)[:6]:
        print(f"[grad] {path}: {grad_rel[path]:.4g} (fault {fault_rel[path]:.4g})")
    if worst(grad_rel) > GRAD_REL_LIMIT:
        raise SystemExit(f"card and CPU gradients differ beyond {GRAD_REL_LIMIT}: {grad_rel}")
    if max(fault_rel.values()) <= GRAD_REL_LIMIT:
        raise SystemExit("the gradient limit did not refuse the planted dB fault")

    # -- (e) resume on the card
    resume_on_card(get_arch("yi-6b").reduced())
    return {"losses": [r["loss"] for r in log], "roles": roles, "step_s": step_s,
            "peak": peak, "busy": busy, "gemm_ms": gemm_ms, "kernel_ms": kernel_ms}


def trace_train_step(trainer, step: int, step_s: float) -> tuple:
    """Take training step ``step`` under ``torch.profiler`` and print its
    device time: busy and idle share, the GEMM kernels', and the kernels'
    inside the device annotations of the port's ranges.  Returns the
    step's GEMM launches by role and shape, its busy and its GEMM ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import gemm as gemm_mod

    before = collections.Counter(gemm_mod.ROLE_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(step)
    step_roles = collections.Counter(gemm_mod.ROLE_LAUNCHES) - before
    events = prof.events()
    span = [ev.time_range for ev in events
            if ev.name == "train.step" and ev.device_type == torch.autograd.DeviceType.CPU][-1]
    device = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    ran = [ev for ev in device if not ev.name.startswith(RANGES)
           and span.start <= ev.time_range.start < span.end]
    busy = sum(ev.time_range.elapsed_us() for ev in ran) / 1e3
    gemm_ms = sum(ev.time_range.elapsed_us() for ev in ran if "gemm_tiled" in ev.name) / 1e3
    span_ms = (span.end - span.start) / 1e3

    def annotated(name):
        """Device time of the kernels inside the device-side annotations of
        one range, or None where the trace has none."""
        marks = [ev.time_range for ev in device if ev.name == name]
        if not marks:
            return None
        return sum(ev.time_range.elapsed_us() for ev in ran
                   if any(m.start <= ev.time_range.start < m.end for m in marks)) / 1e3

    trace_parts = {name: annotated(name) for name in ("attn.chunked", "train.update",
                                                      "train.clip", "remat.recompute")}
    # the trace slows the host (it records every op), so the traced range
    # is longer than an untraced step; idle is also given against the
    # untraced steps' mean
    print(f"[profile] train step {step}: range_ms={span_ms:.2f} "
          f"device_busy_ms={busy:.2f} idle_share={1 - busy / span_ms:.4f} (against the "
          f"untraced steps' {step_s * 1e3:.2f} ms: {1 - busy / (step_s * 1e3):.4f}) "
          f"kernels_traced={len(ran)} gemm_ms={gemm_ms:.2f} ({gemm_ms / busy:.1%} of busy); "
          f"inside the device annotations of the port's ranges: "
          f"{ {k: (round(v, 2) if v is not None else 'not measured') for k, v in trace_parts.items()} }",
          flush=True)
    return step_roles, busy, gemm_ms


def remat_dots(kernels: list, phase14: dict) -> None:
    """Phase 16(a)-(c): remat ``dots`` on the card.  (a) phase 14's yi-6b
    (its layers, seed and data) three steps under ``dots`` through
    ``Trainer``, the counts zeroed before and read after them: step 1's
    loss against phase 14's, no GEMM launch in the blocks' recompute (the
    loss head's chunks are checkpointed under every remat, as in the JAX
    package, and recompute as under ``full``), the forward, dA and dB
    launches phase 14's by shape; then one step traced, and the three
    steps again under selective checkpointing (a dispatch-mode policy
    keeping the same products), the design ``dots`` does not use.  (b)
    phase 14(d)'s gradient check under ``dots``.  (c) mamba2-130m and
    zamba2-1.2b at published widths, one step each under ``full`` and
    under ``dots``: the same gradients, no launch in the blocks'
    recompute under ``dots``.  (e) qwen3-moe's router product kept under
    ``dots`` (:func:`moe_router_kept`; (d) is :func:`head_to_head`).  Adds
    ``launches_dots`` (and its parts by role) to the GEMM rows of (a)'s
    shapes."""
    import dataclasses
    import functools
    import gc

    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataPipeline, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import Model
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_paths

    def by_role(counter) -> collections.Counter:
        out = collections.Counter()
        for (role, _), n in counter.items():
            out[role] += n
        return out

    def block_recompute(counter, vocab: int) -> int:
        """Recompute launches but the loss head's: its chunks are
        checkpointed under every remat (the JAX package's ``@jax.checkpoint``
        on its streaming loss), so they run again under ``dots`` too."""
        return sum(n for (role, (_, _, n_out)), n in counter.items()
                   if role == "recompute" and n_out != vocab)

    # -- (a) the training path under dots: counts zeroed here, read after step 3
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=DOTS_LAYERS, remat="dots")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_stats()
    gemm_mod.reset_launches()
    fa.LAUNCHES.clear()
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0), TRAIN_BATCH)
    trainer = Trainer(cfg, pipe, None, lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 1,
                      device="cuda")
    trainer.initialize(resume=False)
    with ops.watch_kept() as kept_blocks:
        log = trainer.train(TRAIN_STEPS)
    roles = collections.Counter(gemm_mod.ROLE_LAUNCHES)
    flash_launched = sum(fa.LAUNCHES.values())
    peak = torch.cuda.max_memory_allocated()
    for rec, full_loss in zip(log, phase14["losses"]):
        print(f"[dots] step {rec['step']}: loss={rec['loss']:.6f} (remat full: {full_loss:.6f}) "
              f"grad_norm={rec['grad_norm']:.6f} step_s={rec['step_time_s']:.4f}", flush=True)
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise SystemExit(f"dots step {rec['step']}: loss or grad_norm not finite: {rec}")
    step_s = sum(r["step_time_s"] for r in log[1:]) / (len(log) - 1)
    print(f"[dots] yi-6b ({DOTS_LAYERS} of 32 layers, bf16, {cfg.optimizer}, remat dots), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: step_s={step_s:.4f} (mean of steps "
          f"2-{TRAIN_STEPS}) tok_s={tokens / step_s:.1f} peak_gb={peak / 1e9:.2f}; remat full "
          f"(phase 14): step_s={phase14['step_s']:.4f} peak_gb={phase14['peak'] / 1e9:.2f}; "
          f"dots/full step {step_s / phase14['step_s']:.4f}, peak +"
          f"{(peak - phase14['peak']) / 1e9:.2f} GB ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    parts, full_parts = by_role(roles), by_role(phase14["roles"])
    print(f"[dots] GEMM launches over {TRAIN_STEPS} steps: {dict(parts)} (remat full: "
          f"{dict(full_parts)}); flash kernel launches={flash_launched}", flush=True)
    shapes = sorted({dims for _, dims in roles})
    for dims in shapes:
        print(f"[dots] GEMM launches at {dims}: "
              f"{ {r: roles[(r, dims)] for r in parts if roles[(r, dims)]} }", flush=True)
    a, b = phase14["losses"][0], log[0]["loss"]
    if not abs(a - b) <= DOTS_LOSS_RTOL * abs(a):
        raise SystemExit(f"step 1's loss under dots {b!r} is not remat full's {a!r} "
                         f"(rtol {DOTS_LOSS_RTOL})")
    head = {(r, d): n for (r, d), n in roles.items() if r == "recompute"}
    if block_recompute(roles, cfg.padded_vocab):
        raise SystemExit(f"the GEMM kernel launched in the blocks' recompute under dots: "
                         f"{head}")
    full_head = {(r, d): n for (r, d), n in phase14["roles"].items()
                 if r == "recompute" and d[2] == cfg.padded_vocab}
    if head != full_head:
        raise SystemExit(f"the loss head recomputed {head} under dots, {full_head} under full")
    print(f"[dots] recompute launches: none in the blocks; the loss head's chunks "
          f"{sum(head.values())} (checkpointed under every remat, as in the JAX package; "
          f"remat full: {sum(full_head.values())})", flush=True)
    for role in ("forward", "dA", "dB"):
        got = {d: n for (r, d), n in roles.items() if r == role}
        want = {d: n for (r, d), n in phase14["roles"].items() if r == role}
        if got != want:
            raise SystemExit(f"dots launched the GEMM kernel as {role} at {got}, remat full "
                             f"at {want}")
    if flash_launched:
        raise SystemExit(f"flash launched {flash_launched} times in training")
    check_kept_products(cfg, tokens, kept_blocks, DOTS_LAYERS * TRAIN_STEPS)
    step_roles, busy, gemm_ms = trace_train_step(trainer, TRAIN_STEPS + 1, step_s)
    est = {role: sum(step_roles[(role, d)] * phase14["kernel_ms"][d] for d in shapes)
           for role in ("forward", "recompute", "dA", "dB")}
    print(f"[profile] dots step {TRAIN_STEPS + 1}: device busy {busy:.2f} ms (remat full, "
          f"phase 14: {phase14['busy']:.2f}), GEMM kernel {gemm_ms:.2f} (full: "
          f"{phase14['gemm_ms']:.2f}); from one step's launch counts x phase 14's spun times "
          f"a shape: { {r: round(t, 2) for r, t in est.items()} }", flush=True)
    rows = {tuple(r["shape"]): r for r in kernels if r.get("shape")}
    for dims in shapes:
        row = rows.get(dims)
        if row is None:
            raise SystemExit(f"dots launched the GEMM kernel at {dims}, a shape phase 14 did not")
        row["launches_dots_parts"] = {r: roles[(r, dims)] for r in ("forward", "recompute",
                                                                    "dA", "dB")}
        row["launches_dots"] = sum(row["launches_dots_parts"].values())
        row["launches"] += row["launches_dots"]
    for row in kernels:
        row.setdefault("launches_dots", 0)
    del trainer, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps under selective checkpointing, the design dots does
    # not use: a dispatch mode that keeps the operator's products (MUST_SAVE
    # for it, mm and addmm: the down product too, which dots leaves out) but
    # runs Python on every op
    def keep_2d(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in (
            torch.ops.repro_torch.gemm.default, torch.ops.aten.mm.default,
            torch.ops.aten.addmm.default) else CheckpointPolicy.PREFER_RECOMPUTE

    gemm_mod.reset_launches()
    kept = tf._kept_product_frames
    tf._kept_product_frames = functools.partial(create_selective_checkpoint_contexts, keep_2d)
    try:
        trainer = Trainer(cfg, DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0),
                                            TRAIN_BATCH),
                          None, lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 1,
                          device="cuda")
        sac_log = trainer.train(TRAIN_STEPS)
    finally:
        tf._kept_product_frames = kept
    sac_s = sum(r["step_time_s"] for r in sac_log[1:]) / (len(sac_log) - 1)
    sac_again = block_recompute(gemm_mod.ROLE_LAUNCHES, cfg.padded_vocab)
    print(f"[dots-sac] the same {TRAIN_STEPS} steps under selective checkpointing "
          f"(create_selective_checkpoint_contexts, MUST_SAVE the operator, mm, addmm): "
          f"step_s={sac_s:.4f} against dots' {step_s:.4f} and full's {phase14['step_s']:.4f}; "
          f"losses {[round(r['loss'], 6) for r in sac_log]}; blocks' recompute launches "
          f"{sac_again}", flush=True)
    if sac_again or abs(sac_log[0]["loss"] - log[0]["loss"]) > DOTS_LOSS_RTOL * abs(a):
        raise SystemExit("selective checkpointing kept other products than dots")
    del trainer, sac_log
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) phase 14(d)'s gradients under dots, against the CPU's f32
    t0 = time.perf_counter()
    gemm_mod.reset_launches()
    grad_rel, fault_rel = gradients_card_vs_cpu(dataclasses.replace(get_arch("yi-6b"),
                                                                    remat="dots"))
    again = block_recompute(gemm_mod.ROLE_LAUNCHES, get_arch("yi-6b").padded_vocab)
    print(f"[dots-grad] yi-6b ({GRAD_LAYERS} layers, published widths, remat dots) on 1 x "
          f"{GRAD_SEQ} tokens: worst per-leaf relative L2 error, card bf16 vs CPU f32: "
          f"{worst(grad_rel):.4g} (limit {GRAD_REL_LIMIT}); with dB computed from a "
          f"transposed operand: {max(fault_rel.values()):.4g}; the blocks' recompute "
          f"launches {again} ({time.perf_counter() - t0:.1f}s)", flush=True)
    if worst(grad_rel) > GRAD_REL_LIMIT or again:
        raise SystemExit(f"dots gradients on the card: {grad_rel}, recompute launches {again}")
    if max(fault_rel.values()) <= GRAD_REL_LIMIT:
        raise SystemExit("the gradient limit did not refuse the planted dB fault under dots")

    # -- (c) the SSM and the hybrid at published widths, full against dots
    for name in DOTS_SSM:
        t0 = time.perf_counter()
        arch = get_arch(name)
        params = Model(arch, device="cuda").init_params(seed=1)
        data = SyntheticLM(arch.vocab_size, DOTS_SSM_SEQ, seed=2)
        toks, labs = zip(*(data.sample(i) for i in range(DOTS_SSM_BATCH)))
        batch = {"tokens": torch.from_numpy(np.stack(toks)).long().cuda(),
                 "labels": torch.from_numpy(np.stack(labs)).long().cuda()}
        got = {}
        for remat in ("full", "dots"):
            gemm_mod.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            model = Model(dataclasses.replace(arch, remat=remat), device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads, metrics = value_and_grad(model, params, batch)
            torch.cuda.synchronize()
            step = time.perf_counter() - t1
            parts = by_role(gemm_mod.ROLE_LAUNCHES)
            parts["recompute_blocks"] = block_recompute(gemm_mod.ROLE_LAUNCHES,
                                                        arch.padded_vocab)
            got[remat] = (dict(tree_paths(grads)), float(metrics["loss"]), parts)
            print(f"[dots-ssm] {name} ({arch.n_layers} layers, published widths, bf16) "
                  f"{DOTS_SSM_BATCH} x {DOTS_SSM_SEQ} tokens, remat {remat}: "
                  f"loss={got[remat][1]:.6f} step_s={step:.4f} (one step, the first of its "
                  f"model) peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} GEMM launches "
                  f"{dict(parts)}", flush=True)
        (g_full, l_full, p_full), (g_dots, l_dots, p_dots) = got["full"], got["dots"]
        rel = {path: ((g_dots[path].float() - g.float()).norm()
                      / g.float().norm().clamp(min=1e-30)).item() for path, g in g_full.items()}
        print(f"[dots-ssm] {name}: worst per-leaf relative L2 error, dots vs full: "
              f"{worst(rel):.4g} (limit {GRAD_REL_LIMIT}) "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if (worst(rel) > GRAD_REL_LIMIT or p_dots["recompute_blocks"]
                or not p_full["recompute_blocks"]):
            raise SystemExit(f"{name}: dots against full: gradients {rel}, the blocks' "
                             f"recompute launches dots {p_dots['recompute_blocks']} full "
                             f"{p_full['recompute_blocks']}")
        if not abs(l_full - l_dots) <= DOTS_LOSS_RTOL * abs(l_full):
            raise SystemExit(f"{name}: loss under dots {l_dots!r}, under full {l_full!r}")
        del params, got, g_full, g_dots, grads, model, batch
        gc.collect()
        torch.cuda.empty_cache()

    # -- (e) qwen3-moe at published widths: the router's product kept under dots
    moe_router_kept()


def check_kept_products(cfg, tokens: int, kept_blocks: list, n_blocks: int) -> None:
    """Phase 16(a): every yi-6b block under ``dots`` kept the six products
    the JAX package's block keeps under ``dots_with_no_batch_dims_saveable``
    (wq, wk, wv, wo, gate, up: ``tests/test_torch_remat.py`` holds them
    against its ``print_saved_residuals``), left out the MLP's down
    product, and its recompute took the placeholder in its place."""
    hd = cfg.resolved_head_dim
    q, kv, d, ff = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_model, cfg.d_ff
    want = collections.Counter(((tokens, n), torch.bfloat16) for n in (q, kv, kv, d, ff, ff))
    down = ((tokens, d), torch.bfloat16)
    nbytes = [math.prod(shape) * torch.empty((), dtype=dt).element_size()
              for shape, dt in kept_blocks[0].kept] if kept_blocks else []
    if kept_blocks:
        print(f"[dots-kept] one yi-6b layer ({tokens} tokens) keeps {len(nbytes)} products: "
              f"{[(shape, str(dt).removeprefix('torch.')) for shape, dt in kept_blocks[0].kept]}"
              f", {sum(nbytes)} bytes ({sum(nbytes) / 1e6:.1f} MB; each "
              f"{nbytes}); left out: the down product {down[0]} "
              f"({math.prod(down[0]) * 2} bytes); recompute took its placeholder: "
              f"{kept_blocks[0].placeholder_handed}", flush=True)
    bad = [i for i, b in enumerate(kept_blocks)
           if collections.Counter(b.kept) != want or b.unread != down or not b.placeholder_handed]
    if len(kept_blocks) != n_blocks or bad:
        raise SystemExit(f"dots kept other products than the reference's six in blocks {bad} "
                         f"of {len(kept_blocks)} (want {n_blocks} blocks): "
                         f"{kept_blocks[bad[0]] if bad else None}")


def moe_router_kept() -> None:
    """Phase 16(e): qwen3-moe at published widths (2 of 94 layers, 1 x 512
    tokens, capacity factor E / k so that nothing drops), one forward and
    backward under ``full`` and under ``dots`` with no optimizer.  Under
    ``dots`` each block keeps attention's four products and the router's
    f32 logits (``ops.kept_mm``), the reference's five: the router's
    product runs in the forward only, where ``full`` runs it again in the
    recompute, and no GEMM launches in the blocks' recompute; the
    gradients agree per leaf within ``GRAD_REL_LIMIT``."""
    import dataclasses
    import gc

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import tree_paths

    class RouterProducts(TorchDispatchMode):
        """Counts the router's ``mm`` (its ``(T, E)`` output) by launch role."""

        def __init__(self, shape):
            super().__init__()
            self.shape, self.by_role = shape, collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.mm.default and tuple(out.shape) == self.shape:
                self.by_role[getattr(gemm_mod._ROLE, "name", "forward")] += 1
            return out

    t0 = time.perf_counter()
    arch = get_arch(DOTS_MOE)
    arch = dataclasses.replace(arch, n_layers=DOTS_MOE_LAYERS,
                               moe_capacity_factor=arch.n_experts / arch.experts_per_token)
    tokens = DOTS_MOE_BATCH * DOTS_MOE_SEQ
    params = Model(arch, device="cuda").init_params(seed=1)
    data = SyntheticLM(arch.vocab_size, DOTS_MOE_SEQ, seed=2)
    toks, labs = zip(*(data.sample(i) for i in range(DOTS_MOE_BATCH)))
    batch = {"tokens": torch.from_numpy(np.stack(toks)).long().cuda(),
             "labels": torch.from_numpy(np.stack(labs)).long().cuda()}
    hd = arch.resolved_head_dim
    q, kv, d = arch.n_heads * hd, arch.n_kv_heads * hd, arch.d_model
    want = collections.Counter([((tokens, n), torch.bfloat16) for n in (q, kv, kv, d)]
                               + [((tokens, arch.n_experts), torch.float32)])
    got = {}
    for remat in ("full", "dots"):
        model = Model(dataclasses.replace(arch, remat=remat), device="cuda")
        # timed alone, then counted again in a dispatch mode that sees each mm
        gemm_mod.reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # the weights, and full's gradients
        t1 = time.perf_counter()
        with ops.watch_kept() as kept_blocks:
            grads, metrics = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        step = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        again = sum(n for (role, (_, _, n_out)), n in gemm_mod.ROLE_LAUNCHES.items()
                    if role == "recompute" and n_out != arch.padded_vocab)
        got[remat] = (dict(tree_paths(grads)), float(metrics["loss"]))
        del grads
        router = RouterProducts((tokens, arch.n_experts))
        with router:
            value_and_grad(model, params, batch)
        one = [(sh, str(dt).removeprefix("torch.")) for sh, dt in kept_blocks[0].kept
               ] if kept_blocks else []
        print(f"[dots-moe] {DOTS_MOE} ({DOTS_MOE_LAYERS} of 94 layers, published widths, "
              f"bf16, capacity factor {arch.moe_capacity_factor:g}) {DOTS_MOE_BATCH} x "
              f"{DOTS_MOE_SEQ} tokens, remat {remat}: loss={got[remat][1]:.6f} step_s={step:.4f} "
              f"(one forward and backward, the first of its model) peak_gb={peak / 1e9:.2f} "
              f"(held before it {held / 1e9:.2f}, the step's own {(peak - held) / 1e9:.2f}); "
              f"blocks' recompute GEMM launches {again}; router products by role (a second "
              f"pass, counted) {dict(router.by_role)}; kept a block {one}", flush=True)
        if remat == "dots":
            bad = [b for b in kept_blocks if collections.Counter(b.kept) != want or b.unread]
            if (len(kept_blocks) != DOTS_MOE_LAYERS or bad or again
                    or router.by_role != {"forward": DOTS_MOE_LAYERS}):
                raise SystemExit(f"{DOTS_MOE} under dots: kept {kept_blocks}, router products "
                                 f"{dict(router.by_role)}, recompute launches {again}")
        elif router.by_role != {"forward": DOTS_MOE_LAYERS, "recompute": DOTS_MOE_LAYERS}:
            raise SystemExit(f"{DOTS_MOE} under full: router products {dict(router.by_role)}")
        del model
        gc.collect()
    (g_full, l_full), (g_dots, l_dots) = got["full"], got["dots"]
    rel = {path: ((g_dots[path].float() - g.float()).norm()
                  / g.float().norm().clamp(min=1e-30)).item() for path, g in g_full.items()}
    print(f"[dots-moe] {DOTS_MOE}: worst per-leaf relative L2 error, dots vs full: "
          f"{worst(rel):.4g} (limit {GRAD_REL_LIMIT}); the router's product kept, not "
          f"recomputed ({time.perf_counter() - t0:.1f}s)", flush=True)
    if worst(rel) > GRAD_REL_LIMIT or not abs(l_full - l_dots) <= DOTS_LOSS_RTOL * abs(l_full):
        raise SystemExit(f"{DOTS_MOE}: dots against full: gradients {rel}, loss {l_dots!r} "
                         f"against {l_full!r}")
    del params, got, g_full, g_dots, batch
    gc.collect()
    torch.cuda.empty_cache()


def head_to_head(kernels: list, rand, flush, peak_bytes: float) -> None:
    """Phase 16(d): ``TuningSession.compare`` on the card, phase 11's
    protocol (the SIMT kernel, times measured on the card, ``analyze=
    "prune"``, the session's warm start) at 512^3 float32: the paper's
    four tuners, two seeds, 0.1 % of the space each; every best re-timed
    (20 spun launches, L2 flushed) beside the state the analytical H100
    model's ``optimum()`` picks, brute-forced over the space on the
    host.  Adds the ``gemm[compare/512^3-f32]`` row."""
    from repro_torch.core import (AnalyticalHopperCost, Budget, GemmConfigSpace, GemmWorkload,
                                  TuningRecords, TuningSession)
    from repro_torch.core.tuners import rnn_controller
    from repro_torch.kernels.gemm import LAUNCHES, gemm_plain, gemm_tiled, kernel_config_from_state

    m, k, n = COMPARE_DIMS
    # the search: counts zeroed here, read after it
    LAUNCHES.clear()
    draws = draw_counter(rnn_controller)
    t0 = time.perf_counter()
    session = TuningSession(TuningRecords(), verbose=False, device="cuda")
    wl = GemmWorkload(m, k, n, dtype="float32", label="compare/512^3-f32")
    budget = Budget(max_fraction=COMPARE_FRACTION)
    results = session.compare(wl, COMPARE_TUNERS, budget, n_seeds=COMPARE_SEEDS,
                              warm_start=True, analyze="prune")
    launched = sum(LAUNCHES.values())
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    space = GemmConfigSpace(m, k, n)
    model = AnalyticalHopperCost(space, dtype="float32")
    opt_state, opt_cost = model.optimum()
    optimum_s = time.perf_counter() - t0
    cap = budget.resolve_trials(space.size())
    a, b = rand((m, k), torch.float32), rand((k, n), torch.float32)
    opt_cfg = kernel_config_from_state(opt_state)
    worst_err = check_close(f"[compare] the model's optimum {opt_cfg}", gemm_tiled(a, b, opt_cfg),
                            gemm_plain(a, b, opt_cfg), torch.float32)
    opt_ms = timed_ms(lambda: gemm_tiled(a, b, opt_cfg), 20, flush, spin=True)
    print(f"[compare] AnalyticalHopperCost(GemmConfigSpace{COMPARE_DIMS}, float32).optimum() "
          f"over {space.size()} states in {optimum_s:.1f}s on the host: {opt_state.as_lists()} "
          f"({opt_cfg}) model_ms={opt_cost * 1e3:.4f} {model.breakdown(opt_state)}; on the card "
          f"{opt_ms:.4f} ms (20 launches, spun)", flush=True)
    best_ms = {}
    for name, runs in results.items():
        for seed, res in enumerate(runs):
            if res.n_trials > cap or res.best_state is None or not math.isfinite(res.best_cost):
                raise SystemExit(f"[compare] {name} seed {seed}: {res.n_trials} trials of {cap}, "
                                 f"best {res.best_cost}")
            cfg = kernel_config_from_state(res.best_state)
            err = check_close(f"[compare] {name} seed {seed} best {cfg}", gemm_tiled(a, b, cfg),
                              gemm_plain(a, b, cfg), torch.float32)
            worst_err = max(worst_err, err)
            best_ms[name, seed] = timed_ms(lambda: gemm_tiled(a, b, cfg), 20, flush, spin=True)
            n_fin = sum(math.isfinite(t.cost) for t in res.trials)
            found = next(i for i, t in enumerate(res.trials) if t.cost == res.best_cost) + 1
            note = (draws_note(draws, session.seed + seed, res.wall_s)
                    if name == "rnn-controller" else "")
            print(f"[compare] tuner={name} seed={session.seed + seed} trials={res.n_trials} "
                  f"launchable={n_fin} best_ms={best_ms[name, seed]:.4f} "
                  f"measured_ms={res.best_cost * 1e3:.4f} found_at={found} "
                  f"vs_model_optimum={best_ms[name, seed] / opt_ms:.4f} wall_s={res.wall_s:.2f}"
                  f"{note} config={cfg} max_abs_err={err}", flush=True)
    for name in results:
        ms = [best_ms[name, s] for s in range(COMPARE_SEEDS)]
        print(f"[compare] {name}: best_ms over seeds {[round(x, 4) for x in ms]} mean "
              f"{sum(ms) / len(ms):.4f}, vs the model's optimum {min(ms) / opt_ms:.4f} (best) "
              f"{sum(ms) / len(ms) / opt_ms:.4f} (mean)", flush=True)
    if not launched:
        raise SystemExit("the head-to-head never launched the GEMM kernel")
    fastest = min(best_ms, key=best_ms.get)
    cfg = kernel_config_from_state(results[fastest[0]][fastest[1]].best_state)
    ms_unspun = timed_ms(lambda: gemm_tiled(a, b, cfg), 20, flush)
    plain_ms = timed_ms(lambda: gemm_plain(a, b, cfg), 1, flush)
    lib_ms = timed_ms(lambda: torch.matmul(a, b), 20, flush, spin=True)
    lib_unspun = timed_ms(lambda: torch.matmul(a, b), 20, flush)
    flops, nbytes = 2 * m * k * n, 4 * (m * k + k * n + m * n)
    bound_ms = 1e3 * max(flops / FP32_PEAK, nbytes / peak_bytes)
    print(f"[compare] search {search_s:.1f}s, {launched} kernel launches; fastest "
          f"{fastest[0]} (seed {session.seed + fastest[1]}) {best_ms[fastest]:.4f} ms spun, "
          f"{ms_unspun:.4f} unspun; torch.matmul f32 (no TF32) {lib_ms:.4f} spun; "
          f"bound_ms={bound_ms:.4f}", flush=True)
    kernels.append({
        "name": "gemm[compare/512^3-f32]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:96", "shape": list(COMPARE_DIMS),
        "launches_tune": launched, "launches_serve": 0, "launches_dots": 0,
        "launches": launched, "max_abs_err": worst_err, "ms": ms_unspun, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / FP32_PEAK >= nbytes / peak_bytes else "bytes",
        "library_ms": lib_unspun, "ms_spin": best_ms[fastest], "library_ms_spin": lib_ms,
        "model_optimum_ms_spin": opt_ms,
    })
    del a, b


def worst(rel: dict) -> float:
    """The largest of per-leaf errors, ``inf`` if any is not finite (a NaN
    would pass any comparison with a limit)."""
    return max(v if math.isfinite(v) else math.inf for v in rel.values())


def gradients_card_vs_cpu(arch) -> tuple[dict, dict]:
    """Phase 14(d): the same weights (bf16, from a seeded generator) and
    batch through ``value_and_grad`` on the card (bf16, the kernels) and
    on the CPU (f32, the plain versions); then on the card again with
    the GEMM operator's backward (``ops._gemm_backward``) computing dB
    from A's buffer read as if it were transposed.  Returns each leaf's
    relative L2 error, without and with the fault."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import tree_map, tree_paths

    cfg = dataclasses.replace(arch, n_layers=GRAD_LAYERS)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    card = Model(cfg, device="cuda")
    params = card.init_params(seed=1)
    params32 = tree_map(lambda t: t.float().cpu(), params)
    toks, labs = SyntheticLM(cfg.vocab_size, GRAD_SEQ, seed=2).sample(0)
    batch = {"tokens": torch.from_numpy(toks[None]).long(),
             "labels": torch.from_numpy(labs[None]).long()}
    want, _ = value_and_grad(Model(cfg32, device="cpu"), params32, batch)
    want = dict(tree_paths(want))
    batch = {k: v.cuda() for k, v in batch.items()}

    def rel_errors():
        got, _ = value_and_grad(card, params, batch)
        out = {}
        for path, gl in tree_paths(got):
            w = want[path]
            out[path] = ((gl.float().cpu() - w).norm() / w.norm().clamp(min=1e-30)).item()
        return out

    clean = rel_errors()
    real = ops._gemm_backward

    def transposed_db(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.ops.repro_torch.gemm(g, b.t().contiguous()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            # the fault: A's buffer read with its dims swapped, no transpose
            db = torch.ops.repro_torch.gemm(a.contiguous().view(a.shape[1], a.shape[0]),
                                            g).to(b.dtype)
        return da, db, None

    ops._gemm_backward = transposed_db
    try:
        faulty = rel_errors()
    finally:
        ops._gemm_backward = real
    return clean, faulty


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def resume_on_card(cfg) -> None:
    """Phase 14(e): the reduced yi-6b on the card, deterministic algorithms
    on: three steps straight, against two steps, a checkpoint, a new
    Trainer restored from it and a third step.  The restored tensors must
    equal the saved ones byte for byte, and the third step's loss the
    straight run's."""
    from repro_torch.data.pipeline import DataPipeline, SyntheticLM
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            def make(sub):
                pipe = DataPipeline(SyntheticLM(cfg.vocab_size, RESUME_SEQ, seed=4), RESUME_BATCH)
                return Trainer(cfg, pipe, os.path.join(d, sub), lr=3e-3, warmup_steps=1,
                               total_steps=3, ckpt_every=2, seed=3, device="cuda")

            straight = make("straight").train(3)
            first = make("resumed")
            first.train(2)
            second = make("resumed")
            second.initialize(resume=True)
            saved = tree_leaves({"p": first.params, "o": first.opt_state})
            restored = tree_leaves({"p": second.params, "o": second.opt_state})
            if second.step != 2 or [_bytes(t) for t in saved] != [_bytes(t) for t in restored]:
                raise SystemExit("the restored step-2 state differs from the saved one")
            got = second.train(3)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = straight[-1]["loss"], got[-1]["loss"]
    print(f"[resume] reduced yi-6b on the card: the step-2 checkpoint restored {len(saved)} "
          f"tensors byte for byte; step 3 loss straight={a!r} resumed={b!r} "
          f"({'equal' if a == b else f'differ by {abs(a - b):.3g}'})", flush=True)
    if not (math.isfinite(a) and abs(a - b) <= 1e-6 * abs(a)):
        raise SystemExit(f"the resumed step 3 loss {b} differs from the straight run's {a}")


def check_served_kernels(label, launched, batch, heads, kv_heads, gen, ops, fa, gemm_tiled):
    """Hold each kernel against its reference at every shape a serve path
    launched it on, on random bf16 operands: the GEMM kernel under the
    config dispatch chose against an f32 ``torch.matmul`` (MATMUL_TOL),
    the flash kernel on ``(batch, S, heads, hd)`` queries against
    ``(batch, S, kv_heads, hd)`` keys and values under the blocks dispatch
    chose against its plain version (FLASH_TOL).  Exits on a
    disagreement; returns the worst error of each (None where the path
    launched none)."""
    bf16 = torch.bfloat16

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    worst = {"gemm": None, "flash": None}
    for kind, dims in sorted(launched):
        if kind == "gemm":
            m, k, n = dims
            cfg, src = ops.kernel_config(m, k, n, bf16)
            a, b = rand((m, k)), rand((k, n))
            err = check_close(f"{label} served gemm {dims} {cfg}", gemm_tiled(a, b, cfg),
                              torch.matmul(a.float(), b.float()), bf16, MATMUL_TOL)
            print(f"[check] {label} served gemm {dims} ({src}) {cfg}: max abs err {err}")
            del a, b
        else:
            sq, sk, hd = dims
            blocks, src = ops.flash_blocks(sq, sk, hd, bf16, grid_y=batch * heads)
            q = rand((batch, sq, heads, hd))
            k, v = rand((batch, sk, kv_heads, hd)), rand((batch, sk, kv_heads, hd))
            err = check_close(f"{label} served flash {tuple(q.shape)} {blocks}",
                              fa.flash_attention(q, k, v, *blocks),
                              fa.flash_attention_plain(q, k, v, *blocks), bf16, FLASH_TOL)
            print(f"[check] {label} served flash q {tuple(q.shape)} k/v {tuple(k.shape)} "
                  f"(G = {heads // kv_heads}) blocks {blocks} ({src}): max abs err {err}")
            del q, k, v
        worst[kind] = err if worst[kind] is None else max(worst[kind], err)
        torch.cuda.empty_cache()
    return worst["gemm"], worst["flash"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_reduced_model_against_cpu(Model, get_arch, np) -> None:
    """The reduced yi-6b (f32, 2 layers, hd 16) through the kernels on the
    card against the same weights through the plain versions on the CPU
    (which the CPU tests hold against the JAX package): prefill of a
    right-padded 128-token bucket (flash under the heuristic blocks) and
    two decode steps."""
    cfg = get_arch("yi-6b").reduced()
    card, cpu = Model(cfg, device="cuda"), Model(cfg, device="cpu")
    params = cpu.init_params(seed=0)
    params_card = _map(params, lambda t: t.to("cuda"))
    lens = np.array([128, 97, 70, 128, 65, 100, 111, 80])
    rng = np.random.default_rng(1)
    toks = np.zeros((8, 128), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    out = {}
    for label, model, p in (("card", card, params_card), ("cpu", cpu, params)):
        d = model.device
        logits, cache = model.prefill(p, {"tokens": torch.from_numpy(toks).to(d)}, 136,
                                      last_idx=torch.from_numpy(lens - 1).to(d))
        cache.update(valid_len=torch.from_numpy(lens).to(d), prefill_len=128)
        steps = [logits]
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        for _ in range(2):
            logits, cache = model.decode_step(p, cache, tok)
            steps.append(logits)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        out[label] = [s.cpu() for s in steps]
    worst = 0.0
    for i, (got, ref) in enumerate(zip(out["card"], out["cpu"])):
        if not torch.isfinite(got).all() or not torch.allclose(got, ref, rtol=2e-4, atol=2e-4):
            raise SystemExit(f"reduced yi-6b step {i}: card and CPU disagree "
                             f"(max abs err {(got - ref).abs().max().item()})")
        worst = max(worst, (got - ref).abs().max().item())
    print(f"[check] reduced yi-6b on the card matches the CPU plain path "
          f"(prefill + 2 decode steps, max abs err {worst})")


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class BackgroundDryRun:
    """``python -m repro_torch.launch.dryrun --all`` on meta in a process
    of its own, writing under ``out_dir``; its wall time is taken when it
    ends."""

    def __init__(self, out_dir: str):
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.out_dir = out_dir
        self.log_path = os.path.join(out_dir, "dryrun.log")
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out", out_dir],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=HERE)
        self.t0 = time.perf_counter()
        self.wall_s = None
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self.proc.wait()
        self.wall_s = time.perf_counter() - self.t0

    def result(self, timeout: float) -> tuple[int, float, list, str]:
        """``(exit code, wall seconds, records, output)``; raises
        ``SystemExit`` if it has not ended within ``timeout``."""
        self._waiter.join(timeout)
        if self.wall_s is None:
            raise SystemExit(f"the dry run of every cell had not ended after "
                             f"{time.perf_counter() - self.t0:.0f}s")
        records = []
        single = os.path.join(self.out_dir, "single")
        for name in sorted(os.listdir(single)) if os.path.isdir(single) else ():
            with open(os.path.join(single, name)) as f:
                records.append(json.load(f))
        with open(self.log_path) as f:
            return self.proc.returncode, self.wall_s, records, f.read()


def count_problems(card, meta, gemm_launches, flash_launches, flash_flops) -> list[str]:
    """Why a probe's counts on the card fail the check (empty when they
    pass): the card's counted FLOPs and bytes, by kind, equal the meta
    trace's; the GEMM kernel's equal the sum over its launches of
    2·M·K·N, and flash's its launches times ``flash_flops`` a launch."""
    out = []
    if (card.flops, card.bytes) != (meta.flops, meta.bytes):
        out.append(f"card counted {card.flops} FLOPs / {card.bytes} bytes, meta "
                   f"{meta.flops} / {meta.bytes}")
    if card.by_kind != meta.by_kind:
        out.append(f"by kind: card {card.by_kind} meta {meta.by_kind}")
    want = sum(c * 2 * m * k * n for (m, k, n), c in gemm_launches.items())
    if card.by_kind["gemm_kernel"]["flops"] != want:
        out.append(f"GEMM kernel counted {card.by_kind['gemm_kernel']['flops']} FLOPs, its "
                   f"launches did {want}")
    want = sum(c * flash_flops for c in flash_launches.values())
    if card.by_kind["flash_kernel"]["flops"] != want:
        out.append(f"flash counted {card.by_kind['flash_kernel']['flops']} FLOPs, its "
                   f"launches did {want}")
    return out


def dry_run_on_card(kernels: list, dry: BackgroundDryRun, rand, flush, hw, smi: str) -> None:
    """Phase 15: (a) the dry run of the 40 cells on meta (started after
    phase 12): its roofline table and wall time, and no ``error`` record;
    (b) yi-6b probed at published widths and 1 and 2 layers on
    train_4k, prefill_32k and decode_32k with their batches cut to fit
    the card, each step counted on the card and traced on meta: the
    counts equal, the kernels' counted FLOPs equal their launch counters'
    work, the live peaks side by side, and a counter planted to drop the
    dB products refused; (c) each probe's step time against its roofline
    bound and the model-flops share; (d) ``examples_torch/
    tune_and_run_kernel.py`` at its default device: both kernels under
    tuned schedules against their plain versions.  The probes' counted
    runs are the path: counts zeroed before each and summed after
    (``launches_dryrun``), with a row added for each shape no earlier
    phase timed (the decode probe's GEMMs, the prefill probe's flash at
    S = 32768), each held against its reference at that shape."""
    import dataclasses
    import gc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.utils.op_costs import OpCounter
    from repro_torch.utils.roofline import model_flops, roofline_from_costs

    # -- (a) every cell on meta -----------------------------------------------------
    rc, wall, recs, log = dry.result(DRY_ALL_TIMEOUT_S)
    status = collections.Counter(r["status"] for r in recs)
    print(dryrun.table(recs), flush=True)
    print(f"[dryrun] --all on meta: {len(recs)} records ({dict(status)}), exit {rc}, wall "
          f"{wall:.1f}s (one process beside phases 13, 14 and 16); H100 terms: "
          f"{dataclasses.asdict(hw)}", flush=True)
    if rc != 0 or status["error"] or len(recs) != 40 or status["ok"] != 32:
        raise SystemExit(f"the dry run of every cell failed (exit {rc}):\n{log[-3000:]}")

    # -- (b) the probes, on the card and on meta --------------------------------------
    yi = get_arch("yi-6b")
    dtype = getattr(torch, yi.compute_dtype)
    h, hd = yi.n_heads, yi.resolved_head_dim
    failures, launched = [], collections.Counter()
    flash_launched = collections.Counter()  # (batch, (sq, sk, hd)) -> launches
    flash_f32 = 0  # of those, the float32 kernel's

    class DropsDB(OpCounter):
        """A planted counting fault: the dB products go uncounted."""

        def add_kernel(self, kind, dims, flops, nbytes, out):
            if kind == "gemm" and getattr(gemm_mod._ROLE, "name", "forward") == "dB":
                return
            super().add_kernel(kind, dims, flops, nbytes, out)

    for name, seq, batch, kind in DRY_PROBES:
        shape, full = ShapeSpec(name, seq, batch, kind), get_shape(name)
        blocks, _ = ops.flash_blocks(seq, seq, hd, dtype, grid_y=batch * h)
        flash_flops = fa.flash_work(batch, seq, seq, h, yi.n_kv_heads, hd, *blocks, True,
                                     dtype.itemsize)[0] \
            if blocks else 0
        for depth in DRY_DEPTHS:
            cfg = dryrun._depth_variant(yi, depth)
            meta = dryrun.count_step(dryrun.make_cell(cfg, shape, "meta")["run"])
            cell = dryrun.make_cell(cfg, shape, "cuda")
            cell["run"]()  # warm-up: the allocator's and cuBLAS's first use
            torch.cuda.synchronize()
            gc.collect()  # nothing of the warm-up left for the counted step to free
            gemm_mod.reset_launches()
            fa.LAUNCHES.clear()
            fa.DTYPE_LAUNCHES.clear()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            card = dryrun.count_step(cell["run"])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            gemm_l, flash_l = collections.Counter(gemm_mod.LAUNCHES), collections.Counter(fa.LAUNCHES)
            roles = collections.Counter(role for role, _ in gemm_mod.ROLE_LAUNCHES.elements())
            launched.update(gemm_l)
            flash_launched.update({(batch, dims): c for dims, c in flash_l.items()})
            flash_f32 += fa.DTYPE_LAUNCHES["float32"]
            label = f"yi-6b {name} ({depth} of 32 layers, batch {batch})"
            problems = count_problems(card, meta, gemm_l, flash_l, flash_flops)
            if card.kernel_launches != collections.Counter(
                    {("gemm", d): c for d, c in gemm_l.items()}) + collections.Counter(
                    {("flash", d): c for d, c in flash_l.items()}):
                problems.append(f"the counter saw {dict(card.kernel_launches)} kernel calls")
            want_roles = {"forward", "recompute", "dA", "dB"} if kind == "train" else {"forward"}
            if set(roles) != want_roles:
                problems.append(f"GEMM launched in {dict(roles)}, not in {sorted(want_roles)}")
            if (kind == "prefill") != bool(flash_l):
                problems.append(f"flash launched {dict(flash_l)}")
            if kind != "prefill" and not card.by_kind["attention"]["count"]:
                problems.append("no attention products were counted")
            peak_rel = abs(meta.peak_bytes - peak) / peak
            if peak_rel > PEAK_RTOL:
                problems.append(f"live peak: meta {meta.peak_bytes} card {peak}")
            print(f"[dryrun-probe] {label}: card and meta count {card.flops:.6e} FLOPs / "
                  f"{card.bytes:.6e} bytes (equal: {(card.flops, card.bytes) == (meta.flops, meta.bytes)}); "
                  f"GEMM kernel {card.by_kind['gemm_kernel']['flops']:.6e} FLOPs over "
                  f"{sum(gemm_l.values())} launches {dict(roles)}; flash "
                  f"{card.by_kind['flash_kernel']['flops']:.6e} over {sum(flash_l.values())} "
                  f"launches (blocks {blocks}); attention products "
                  f"{card.by_kind['attention']['flops']:.6e}; live peak meta "
                  f"{meta.peak_bytes / 1e9:.4f} GB, the card's allocator {peak / 1e9:.4f} GB "
                  f"(rel diff {peak_rel:.5f}, limit {PEAK_RTOL}; the counter's own on the card "
                  f"{card.peak_bytes / 1e9:.4f} GB)", flush=True)
            failures += [f"{label}: {p}" for p in problems]
            if kind == "train" and depth == DRY_DEPTHS[0]:
                gemm_mod.reset_launches()
                with DropsDB() as bad:
                    cell["run"]()
                torch.cuda.synchronize()
                caught = count_problems(bad, meta, gemm_mod.LAUNCHES, fa.LAUNCHES, flash_flops)
                print(f"[dryrun-probe] planted fault, a counter that drops the dB products: "
                      f"{'refused' if caught else 'NOT refused'}: {caught[:2]}", flush=True)
                if not caught:
                    failures.append("the count check did not refuse the planted dB fault")

            # -- (c) the step's time against its roofline bound
            times = []
            for _ in range(DRY_TIMED[kind]):
                t = time.perf_counter()
                cell["run"]()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            step_s = sum(times) / len(times)
            mf = model_flops(cfg, shape)
            terms = roofline_from_costs(card.flops, card.bytes, card.collectives(), 1, mf, hw)
            bound_s = max(terms.compute_s, terms.memory_s)
            rec = {"arch": "yi-6b", "shape": name, "kind": kind, "device": "cuda",
                   "reduced": [f"n_layers {yi.n_layers} -> {depth}",
                               f"global_batch {full.global_batch} -> {batch}"],
                   "step_s": step_s, "bound_s": bound_s, "step_over_bound": step_s / bound_s,
                   "model_flops_share": mf / step_s / hw.peak_flops,
                   "roofline": terms.as_dict(), "peak_bytes_card": peak,
                   "peak_bytes_meta": meta.peak_bytes, "card": smi}
            print(f"[dryrun-probe] {label}: step_s={step_s:.6f} (mean of {len(times)}) "
                  f"bound_s={bound_s:.6f} ({terms.dominant}: compute_s={terms.compute_s:.6f} "
                  f"memory_s={terms.memory_s:.6f}) step/bound={step_s / bound_s:.4f} "
                  f"model_flops_share={mf / step_s / hw.peak_flops:.4f} useful_ratio="
                  f"{terms.useful_ratio:.4f} on {smi}", flush=True)
            print(f"[dryrun-record] {json.dumps(rec)}", flush=True)
            del cell, card, meta
            gc.collect()
            torch.cuda.empty_cache()

    # the path's GEMM launches by shape: a row each (new shapes checked and timed)
    rows = {tuple(r["shape"]): r for r in kernels if r.get("shape")}
    for dims, count in sorted(launched.items()):
        row = rows.get(dims)
        if row is None:
            row = gemm_row(f"gemm[dryrun {'x'.join(map(str, dims))}]", dims, rand, flush, hw)
            kernels.append(row)
            rows[dims] = row
        row["launches_dryrun"] = row.get("launches_dryrun", 0) + count
        row["launches"] += count
    # the path's flash launches: a row for each shape (S = 32768 is new)
    for (batch, (sq, sk, hd_)), count in sorted(flash_launched.items()):
        row = flash_row(f"flash_attention[dryrun b{batch} s{sq} h{h}/{yi.n_kv_heads} d{hd_}]",
                        batch, sq, h, yi.n_kv_heads, hd_, rand, flush, hw)
        row["launches_dryrun"] = row["launches"] = count
        kernels.append(row)
    for row in kernels:
        row.setdefault("launches_dryrun", 0)
        if row["name"].startswith("flash_f32["):
            row["launches_dryrun"] += flash_f32
            row["launches"] += flash_f32
    print(f"[launches] phase 15: GEMM {sum(launched.values())} over {len(launched)} shapes, "
          f"flash {sum(flash_launched.values())} ({dict(flash_launched)})", flush=True)

    # -- (d) the example that runs both kernels under tuned schedules ----------------
    example = os.path.join(HERE, "examples_torch", "tune_and_run_kernel.py")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, example], capture_output=True, text=True, env=env,
                          cwd=HERE, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"[example] {line}", flush=True)
    if proc.returncode != 0 or not lines or lines[-1] != (
            "OK: both tuned kernels match their plain versions on cuda") or sum(
            "1 kernel launches)" in line for line in lines) != 2:
        failures.append(f"tune_and_run_kernel.py on the card (exit {proc.returncode}):\n"
                        f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    if failures:
        raise SystemExit("phase 15 failed:\n" + "\n".join(failures))


def flash_row(name: str, batch: int, seq: int, heads: int, kv_heads: int, hd: int, rand,
              flush, hw) -> dict:
    """A ``kernels`` row for a causal bf16 flash shape no earlier phase
    timed: q ``(batch, seq, heads, hd)`` over k/v ``(batch, seq, kv_heads,
    hd)`` under the blocks dispatch gives it, held against its plain
    version within ``FLASH_TOL``, timed beside it (once: its block loop
    takes seconds at S = 32768), SDPA and its bound (the causal
    triangle's products; q, k, v read and the output written once)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    blocks, src = ops.flash_blocks(seq, seq, hd, bf16, grid_y=batch * heads)
    q = rand((batch, seq, heads, hd), bf16)
    k, v = rand((batch, seq, kv_heads, hd), bf16), rand((batch, seq, kv_heads, hd), bf16)
    flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = fa.flash_attention_plain(q, k, v, *blocks)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = check_close(f"{name} {blocks}", fa.flash_attention(q, k, v, *blocks), ref, bf16,
                      FLASH_TOL)
    del ref
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, *blocks), 3, flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 3, flush)
    flops = 4 * batch * heads * hd * seq * (seq + 1) // 2
    nbytes = 2 * batch * seq * (2 * heads + 2 * kv_heads) * hd
    bound_ms = 1e3 * max(flops / hw.peak_flops, nbytes / hw.hbm_bw)
    print(f"[dryrun-flash] q {tuple(q.shape)} k/v {tuple(k.shape)} blocks {blocks} ({src}): "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bound_ms:.4f} max abs err vs plain {err}", flush=True)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34", "shape": [batch, seq, heads, hd],
        "launches_tune": 0, "launches_serve": 0, "launches_families": 0, "launches_train": 0,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / hw.peak_flops >= nbytes / hw.hbm_bw else "bytes",
        "library_ms": lib_ms,
    }


#: phase 7's f32 flash row: q (batch, seq, heads, hd) over k/v of kv_heads,
#: causal, one of the shapes phase 7 checks
FLASH_F32_SHAPE = (2, 256, 16, 2, 128)


def flash_f32_row(rand, flush, peak_bytes: float) -> dict:
    """A ``kernels`` row for the float32 flash kernel (CUDA cores), which
    no served or tuned path launches: at ``FLASH_F32_SHAPE`` under the
    blocks dispatch gives it, held against its plain version within
    ``FLASH_TOL``, timed (unspun and spun) beside its plain version,
    ``scaled_dot_product_attention`` in float32 and its bound (the causal
    triangle's products at the FP32 CUDA-core peak; q, k, v read and the
    output written once)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    f32 = torch.float32
    batch, seq, heads, kv_heads, hd = FLASH_F32_SHAPE
    blocks, src = ops.flash_blocks(seq, seq, hd, f32, grid_y=batch * heads)
    q = rand((batch, seq, heads, hd), f32)
    k, v = rand((batch, seq, kv_heads, hd), f32), rand((batch, seq, kv_heads, hd), f32)
    err = check_close(f"flash f32 {tuple(q.shape)} {blocks}", fa.flash_attention(q, k, v, *blocks),
                      fa.flash_attention_plain(q, k, v, *blocks), f32, FLASH_TOL)
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, *blocks), 20, flush)
    ms_spin = timed_ms(lambda: fa.flash_attention(q, k, v, *blocks), 20, flush, spin=True)
    plain_ms = timed_ms(lambda: fa.flash_attention_plain(q, k, v, *blocks), 3, flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms, lib_spin = timed_ms(sdpa, 20, flush), timed_ms(sdpa, 20, flush, spin=True)
    flops = 4 * batch * heads * hd * seq * (seq + 1) // 2
    nbytes = 4 * batch * seq * (2 * heads + 2 * kv_heads) * hd
    bound_ms = 1e3 * max(flops / FP32_PEAK, nbytes / peak_bytes)
    print(f"[time] flash f32 q {tuple(q.shape)} k/v {tuple(k.shape)} blocks {blocks} ({src}): "
          f"kernel_ms={ms:.4f} spun {ms_spin:.4f}; plain_ms={plain_ms:.4f}; SDPA f32 "
          f"library_ms={lib_ms:.4f} spun {lib_spin:.4f}; bound_ms={bound_ms:.4f} (fp32 peak "
          f"66.9 TFLOP/s); kernel/SDPA spun {ms_spin / lib_spin:.2f}x; max abs err {err}",
          flush=True)
    return {
        # not "flash_attention[...]": the served flash launches go to those rows
        "name": f"flash_f32[{batch}x{seq}x{heads}/{kv_heads}x{hd}]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34", "shape": [batch, seq, heads, hd],
        # no launch counts here: phases 8 and 9 write them from DTYPE_LAUNCHES
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / FP32_PEAK >= nbytes / peak_bytes else "bytes",
        "library_ms": lib_ms, "ms_spin": ms_spin, "library_ms_spin": lib_spin,
    }


def gemm_row(name: str, dims: tuple, rand, flush, hw) -> dict:
    """A ``kernels`` row for a bf16 GEMM shape no earlier phase timed:
    the kernel under the config dispatch gives it, held against an f32
    ``torch.matmul`` within ``gemm_tol``, timed (unspun and spun) beside
    its plain version, ``torch.matmul`` and its bound."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    m, k, n = dims
    cfg, src = ops.kernel_config(m, k, n, bf16)
    a, b = rand((m, k), bf16), rand((k, n), bf16)
    err = check_close(f"{name} {cfg}", gemm_mod.gemm_tiled(a, b, cfg),
                      torch.matmul(a.float(), b.float()), bf16, gemm_tol(k))
    ms = timed_ms(lambda: gemm_mod.gemm_tiled(a, b, cfg), 3, flush)
    ms_spin = timed_ms(lambda: gemm_mod.gemm_tiled(a, b, cfg), 3, flush, spin=True)
    lib_ms = timed_ms(lambda: torch.matmul(a, b), 3, flush)
    lib_spin = timed_ms(lambda: torch.matmul(a, b), 3, flush, spin=True)
    plain_ms = timed_ms(lambda: gemm_mod.gemm_plain(a, b, cfg), 1, flush)
    flops, nbytes = 2 * m * k * n, 2 * (m * k + k * n + m * n)
    bound_ms = 1e3 * max(flops / hw.peak_flops, nbytes / hw.hbm_bw)
    print(f"[dryrun-gemm] {dims} ({src}) {cfg}: kernel_ms={ms_spin:.4f} "
          f"library_ms={lib_spin:.4f} bound_ms={bound_ms:.4f} (spun) max abs err vs f32 "
          f"matmul {err}", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:96", "shape": list(dims),
        "launches_tune": 0, "launches_serve": 0, "launches_families": 0, "launches_train": 0,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / hw.peak_flops >= nbytes / hw.hbm_bw else "bytes",
        "library_ms": lib_ms, "ms_spin": ms_spin, "library_ms_spin": lib_spin,
    }


def search_only(src: str) -> None:
    """Phases 11(b) and 16(d) alone, the paper's searches on the f32 SIMT
    kernel, on the package under ``src``: this checkout's, or another
    tree's, whose kernel they then build and time under the same
    protocol (two trees compared in turns on one card):

        python3 chip_smoke.py --search-only [path/to/src]

    Prints the card, the GEMM source's digest, both phases' lines and the
    two kernels rows."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels.build import source_digest
    from repro_torch.kernels.gemm import build_kernel
    from repro_torch.utils.roofline import H100

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    import repro_torch

    print(f"[search-only] {os.path.dirname(repro_torch.__file__)} gemm.cu "
          f"{source_digest('gemm.cu')}", flush=True)
    build_kernel()
    peak_bytes = H100.for_device(torch.cuda.get_device_name(0)).hbm_bw
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(100 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    kernels: list = []
    t0 = time.perf_counter()
    paper_comparison(kernels, rand, flush, peak_bytes)
    phase("11(b) the paper's comparison", t0)
    t0 = time.perf_counter()
    head_to_head(kernels, rand, flush, peak_bytes)
    phase("16(d) the head-to-head", t0)
    print(json.dumps({"kernels": kernels}))


def become_subreaper() -> None:
    """Make this process the reaper of its descendants' orphans, so a
    process that outlives its parent (a lane's forkserver once a CLI has
    exited) is still this script's child and :func:`stop_children` finds
    it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children() -> list[int]:
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the command's closing parenthesis: state, then the parent's pid
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(d))
    return out


def _reaped(pid: int) -> bool:
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        return True


def stop_children() -> None:
    """Stop every process this script started that still runs: the
    process lanes' forkserver and resource tracker (Python would stop
    them only as the interpreter ends, and they outlive it for a moment),
    then any other child or orphan, by SIGTERM and after 5 s SIGKILL.
    Says on stderr what it had to stop."""
    executor = sys.modules.get("repro_torch.core.executor")
    if executor is not None:
        executor.stop_worker_servers()
    left = _children()
    if left:
        names = {}
        for pid in left:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    names[pid] = f.read().replace(b"\0", b" ").decode(errors="replace")[:120]
            except OSError:
                names[pid] = "?"
        print(f"[procs] stopping {len(left)} processes left running: {names}",
              file=sys.stderr, flush=True)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 5.0
        while left and time.monotonic() < deadline:
            left = [pid for pid in left if not _reaped(pid)]
            time.sleep(0.05)
    print(f"[procs] {len(_children())} processes of this script left running",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    become_subreaper()
    try:
        if sys.argv[1:2] == ["--search-only"]:
            search_only(sys.argv[2] if len(sys.argv) > 2 else SRC)
        else:
            main()
    finally:
        stop_children()
