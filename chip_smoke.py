"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: tune -> record ->
dispatch for yi-6b's five GEMMs and its prefill attention at full width,
through the hand-written GEMM and flash-attention kernels, yi-6b served
at full width on the tuned records, and the paper's tuners (N-A2C and
its baselines) compared on the GEMM kernel.

    python3 chip_smoke.py

Phases (each prints its wall time):

  1. build both kernels (``src/repro_torch/kernels/csrc/*.cu``) and two
     variants of each with a planted fault (its source with one line
     changed, built in a temporary directory), one nvcc per source, all
     started together; count the tensor-core instructions (``HGMMA``,
     ``HMMA``) of each bf16 instantiation of both kernels in
     ``cuobjdump -sass`` of the built library (fails on a count of 0), and
     print ptxas' registers, spills and injected ``warpgroup.arrive``s for
     them (the GEMM's ``wgmma`` instantiations must have neither spills
     nor injected arrives; phase 9 prints the served flash instantiation's);
  2. hold the GEMM kernels against their plain PyTorch version on small
     products: every compiled instantiation's launch limit against the
     analyzer's, the f32 SIMT kernel under several configs, every bf16
     ``wgmma`` instantiation with one and two warpgroups, the bf16
     bandwidth kernel at M = 8 and 16, and the autograd backward; then see
     the bf16 limit refuse both planted GEMM faults;
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
     limit refuses both planted faults;
  8. tune yi-6b's prefill attention (4096, 4096, 128) bf16 with G-BFS on
     times measured on the card, seeded from the kernel's heuristic
     blocks, then rerun ``tune --op flash --warm-start`` on the same
     records;
  9. serve yi-6b at full width (32 layers, random bf16 weights from a
     seeded generator on the card) on the records of phases 3-4 and 8:
     8 requests of ragged prompts in [2049, 4096], padded to the bucket
     4096, 16 greedy tokens each; then trace one more prefill and three
     decode steps with ``torch.profiler`` for the device time of each
     kernel kind against CUDA events around the same call; then hold the
     GEMM kernel, under the config dispatch chose, against an f32
     ``torch.matmul`` at every shape the serve launched it on;
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
     workload list does not hold, seeded from the kernel's heuristic
     state as in phase 3, onto the same fresh records and journal; each workload's trials, launchable share, ``c_ref`` and
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
     float32 H100 model at 256^3: the two trial sequences must be equal.

Launch counts of each path are zeroed just before it and read just after:
the GEMM tuning path is phases 3-5, the flash tuning path phase 8, the
serve phase 9, N-A2C's tuning and serve 11(a) (added to the yi-6b rows'
``launches_tune``), the paper's comparison 11(b) (its own row,
``gemm[paper/1024^3-f32]``; the CLIs' launches, made in their own
processes, are added from their output).  Each kernel row gives ``launches_tune`` and
``launches_serve`` and their sum as ``launches``.  GEMM rows give each
time twice: ``ms``/``library_ms`` timed as earlier slices timed them
(the event span holds the host's enqueue of the call), and
``ms_spin``/``library_ms_spin`` with the card kept busy while the host
enqueues (the device's time alone).  Tolerances, kernel against its plain version: GEMM
float32 rtol 1e-4 / atol 8e-4 (the JAX package's GEMM kernel tests),
bfloat16 rtol 1.6e-2 / atol 2e-3 * max(1, K / 4096) (kernel and plain
version sum the same products in f32 in another order and round the
output to bf16 once, so they differ by a rounding step, 2^-8 to 2^-7
relative; wgmma adds each k16 step to its accumulator with less than
f32's precision, an absolute error that grows with K: the ``[time]``
lines print the atol each full-width check needs); flash float32 rtol 2e-5 / atol 8e-5 (its flash
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
import subprocess
import sys
import tempfile
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: GEMM kernel against its plain version at K <= 4096 (see gemm_tol)
TOL = {torch.float32: (1e-4, 8e-4), torch.bfloat16: (1.6e-2, 2e-3)}
#: GEMM against an f32 torch.matmul: the JAX package's GEMM tolerances
MATMUL_TOL = {torch.float32: (1e-4, 8e-4), torch.bfloat16: (0.05, 0.4)}
GEMM_CU = os.path.join(SRC, "repro_torch", "kernels", "csrc", "gemm.cu")
#: planted faults the bf16 GEMM limit must refuse, each in the kernel it
#: breaks: one line of the source, and what a variant built beside it has
GEMM_FAULTS = {
    # the wgmma kernel's warpgroups read the ring slot after slab i's
    "wrong_ring_slot": ("const int slot = i % stages;", "const int slot = (i + 1) % stages;"),
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
#: dense peak (ops/s) and memory rate (bytes/s) by card, from NVIDIA's data sheets
PEAKS = {"PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12), "default": (989e12, 3.35e12)}
TUNE_TRIALS = 250  # total G-BFS pool over the five workloads (phase 3)
# total pool of the warm-started CLI rerun (phase 4), which starts from
# phase 3's records and serves every state phase 3 measured from the journal
CLI_TRIALS = 100
FLASH_TRIALS = 30  # G-BFS pool of the flash workload (phase 8)
FLASH_CLI_TRIALS = 12
SERVE_REQUESTS, SERVE_BUCKET, SERVE_TOKENS = 8, 4096, 16
#: phase 11: N-A2C's pool over the CLI's five GEMMs and its decode-product
#: budget (about 120 trials over six GEMMs), the paper's product, the
#: FP32 CUDA-core peak its bound uses (H100 SXM data sheet), and the
#: determinism runs' budget
NA2C_CLI_TRIALS, NA2C_DECODE_TRIALS = 100, 20
PAPER_DIMS = (1024, 1024, 1024)
FP32_PEAK = 66.9e12
NA2C_REPEAT_TRIALS = 200


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
    """The GEMM kernel's limit against its plain version for a K-deep
    product: TOL, with the bf16 atol grown in proportion to K above 4096.
    wgmma adds each k16 step to its accumulator with less than f32's
    precision, an error that grows with the number of steps (the
    ``[time]`` lines print the atol each full-width check needs)."""
    rtol, atol = TOL[torch.bfloat16]
    return {**TOL, torch.bfloat16: (rtol, atol * max(1.0, k / 4096))}


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


def sass_counts(lib, pattern: re.Pattern) -> dict:
    """Tensor-core instructions (``HGMMA`` for wgmma, ``HMMA`` for
    mma.sync) per kernel whose name ``pattern`` matches, keyed by the
    pattern's groups, from ``cuobjdump -sass`` of the built library."""
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
            counts[key].update(re.findall(r"\b(HGMMA|HMMA)\.", line))
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
    correct kernel was checked on; the bf16 limit must refuse it.
    Returns its max abs error."""
    from repro_torch.kernels.gemm import launch_with

    err, ok = within(launch_with(lib, a, b, cfg), ref, torch.bfloat16, gemm_tol(a.shape[1]))
    print(f"[fault] gemm {what} {cfg}: {name} max abs err {err} -> "
          f"{'within the limit' if ok else 'refused'}", flush=True)
    if ok:
        raise SystemExit(f"the bf16 GEMM limit let the planted fault {name} pass ({what})")
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
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import Budget, TrialJournal, TuningRecords, TuningSession
    from repro_torch.core.analysis import (
        GEMM_BW_BN, GEMM_WG_INSTANCES, flash_max_threads, gemm_bf16_max_threads,
        gemm_kernel_kind, max_threads_for_reg_tile,
    )
    from repro_torch.core.records import set_global_records
    from repro_torch.core.session import Workload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import (
        LAUNCHES, KernelConfig, build_kernel, default_config, gemm_plain,
        gemm_tiled, kernel_config_from_state, kernel_max_threads, kernel_max_threads_bf16,
        state_from_config,
    )
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.tune import flash_workloads_for_arch, workloads_for_arch
    from repro_torch.models.api import Model

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    device_name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = next(
        (v for k, v in PEAKS.items() if k in device_name), PEAKS["default"]
    )
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
    simt_configs = [
        KernelConfig(128, 32, 128, 32, 64, 8, 8),
        KernelConfig(64, 16, 64, 32, 32, 4, 4),
        KernelConfig(64, 128, 64, 32, 32, 2, 2),
        KernelConfig(128, 8, 64, 64, 16, 8, 2),
        KernelConfig(32, 64, 32, 0, 0, 1, 1),
        KernelConfig(8, 128, 8, 0, 0, 1, 1),
    ]
    # every wgmma instantiation with one warpgroup and with two (along m and
    # along n); the bandwidth kernel at 8 and 16 rows, every column count
    wgmma_configs = [KernelConfig(bm, bk, bn, sm, sn) for bk, sm, sn in GEMM_WG_INSTANCES
                     for bm, bn in ((sm, sn), (2 * sm, sn), (sm, 2 * sn))]
    stream_configs = [KernelConfig(bm, bk, bn, bm, bn) for bm in (8, 16) for bn in GEMM_BW_BN
                      for bk in (16, 48, 256, 512)]
    small = {
        torch.float32: (((1024, 1024, 1024), (512, 256, 768), (256, 1024, 128)), simt_configs),
        torch.bfloat16: (((256, 512, 512), (128, 1024, 256), (64, 512, 512), (8, 4096, 1024),
                          (16, 1024, 512), (8, 11008, 256)), wgmma_configs + stream_configs),
    }
    n_checked, worst = collections.Counter(), collections.defaultdict(float)
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
        a = rand((256, 512), dtype).requires_grad_()
        b = rand((512, 384), dtype).requires_grad_()
        g = rand((256, 384), dtype)
        (ops.gemm(a, b) * g).sum().backward()
        check_close(f"{dtype} dA", a.grad, g.float() @ b.detach().float().T, dtype, MATMUL_TOL)
        check_close(f"{dtype} dB", b.grad, a.detach().float().T @ g.float(), dtype, MATMUL_TOL)
    if not (n_checked["wgmma"] >= len(GEMM_WG_INSTANCES) and n_checked["stream"]
            and n_checked["simt"]):
        raise SystemExit(f"too few kernel/plain cases: {dict(n_checked)}")
    torch.cuda.synchronize()
    print(f"[check] kernel/plain products agree: {dict(n_checked)}; max abs err "
          f"{dict(worst)}; and 2 backward passes")
    for (m, k, n), fault in (((1024, 1024, 1024), "wrong_ring_slot"),
                             ((8, 4096, 4096), "split_k_drop")):
        a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
        cfg = default_config(m, k, n)
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
        phase("7 flash kernel vs plain", t0)

        # -- flash tuning path: counts zeroed here, read after phase 8 ---------------
        fa.LAUNCHES.clear()

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
        print(f"[launches] flash tuning path: {flash_tune_launches} kernel launches "
              f"({sum(flash_cli.values())} in the CLI process)")
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
        lens = rng.integers(SERVE_BUCKET // 2 + 1, SERVE_BUCKET + 1, SERVE_REQUESTS)
        lens[0] = SERVE_BUCKET
        prompts = np.zeros((SERVE_REQUESTS, SERVE_BUCKET), np.int64)
        for i, n in enumerate(lens):
            prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
        engine = ServeEngine(cfg, params, max_batch=SERVE_REQUESTS,
                             max_len=SERVE_BUCKET + SERVE_TOKENS,
                             prompt_buckets=[SERVE_BUCKET], device="cuda")
        # -- the serve path: counts zeroed here, read just after it ------------------
        ops.reset_dispatch_stats()
        LAUNCHES.clear()
        fa.LAUNCHES.clear()
        tokens = engine.generate(prompts, SERVE_TOKENS, prompt_lens=lens)
        timing = engine.last_timing
        stats = ops.dispatch_stats()
        serve_flash = sum(fa.LAUNCHES.values())
        serve_launches = {d: c for d, c in LAUNCHES.items() if c > 0}
        served_gemms = sorted(serve_launches)
        missing = sorted(set(SERVED_SHAPES) - set(served_gemms))
        if missing:
            raise SystemExit(f"the serve never launched the GEMM kernel at {missing}")
        for dims, row in gemm_rows.items():  # the serve is a main path too
            row["launches_serve"] = serve_launches.get(dims, 0)
            row["launches"] = row["launches_tune"] + row["launches_serve"]
        print(f"[serve] {SERVE_REQUESTS} requests, prompt lengths {lens.tolist()} -> bucket "
              f"{timing['prompt_bucket']}, {SERVE_TOKENS} tokens each: "
              f"prefill_s={timing['prefill_s']:.4f} decode_s={timing['decode_s']:.4f} "
              f"tok_s={SERVE_REQUESTS * SERVE_TOKENS / (timing['prefill_s'] + timing['decode_s']):.2f}")
        print(f"[serve] dispatch_stats={stats}")
        print(f"[serve] GEMM dispatch split: records={stats['gemm']['records']} "
              f"heuristic={stats['gemm']['heuristic']} matmul={stats['gemm']['matmul']}; "
              f"GEMM kernel launches={sum(serve_launches.values())}; "
              f"flash kernel launches={serve_flash}")
        print(f"[serve] sample tokens: {tokens[0][:8].tolist()}")
        if stats["flash"]["records"] != cfg.n_layers or stats["flash"]["heuristic"] != 0:
            raise SystemExit(f"flash dispatch {stats['flash']}: expected {cfg.n_layers} "
                             f"records per prefill call and no heuristic")
        if serve_flash < cfg.n_layers:
            raise SystemExit(f"the flash kernel launched {serve_flash} times in the serve")
        if tokens.shape != (SERVE_REQUESTS, SERVE_TOKENS) or not (
                (tokens >= 0) & (tokens < cfg.vocab_size)).all():
            raise SystemExit(f"served tokens of shape {tokens.shape} outside [0, vocab)")
        # where the time goes: one more prefill and 3 decode steps, traced
        dev_lens = torch.from_numpy(lens).to(dev)
        with torch.inference_mode():
            (logits, cache), _ = profile_split("prefill", lambda: model.prefill(
                params, {"tokens": torch.from_numpy(prompts).to(dev)},
                SERVE_BUCKET + SERVE_TOKENS, last_idx=dev_lens - 1))
            cache.update(valid_len=dev_lens, prefill_len=SERVE_BUCKET)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]

            def decode3():
                for _ in range(3):
                    model.decode_step(params, cache, tok)

            _, split = profile_split("3 decode steps", decode3)
            print(f"[profile] GEMM device time per decode step: {split['gemm'] / 3:.4f} ms")
        del engine, params, logits, cache
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

    t0 = time.perf_counter()
    paper_tuners(kernels, gemm_rows, rand, flush, peak_bytes)
    phase("11 N-A2C and the paper's baselines on the card", t0)

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


def paper_tuners(kernels: list, gemm_rows: dict, rand, flush, peak_bytes: float) -> None:
    """Phase 11: N-A2C on the served path, the paper's comparison at
    Fig. 7's operating point, and N-A2C's determinism on the card."""
    from repro_torch.core import (
        AnalyticalHopperCost, Budget, GemmConfigSpace, TrialJournal, TuneCheckpointer,
        TuningRecords, TuningSession, get_op,
    )
    from repro_torch.core.records import set_global_records
    from repro_torch.core.session import Workload
    from repro_torch.core.tuners import TUNERS, NA2CTuner
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import (
        LAUNCHES, default_config, gemm_plain, gemm_tiled, kernel_config_from_state,
        state_from_config,
    )

    # -- (a) N-A2C on the served path: counts zeroed here, read after the serve
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "na2c.json")
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
            # seeded from the kernel's heuristic state, as phase 3 seeds it: a
            # warm start would transplant the nearest tuned shape's state,
            # a wgmma tile the bandwidth kernel cannot launch at M = 8
            m, k, n = DECODE_TUNED
            s0 = state_from_config(default_config(m, k, n), m, k, n)
            res = session.tune_workload(
                wl, "n-a2c", Budget(max_trials=NA2C_DECODE_TRIALS), tuner_kwargs={"s0": s0},
                checkpointer=TuneCheckpointer(rec + ".tunestate", every_rounds=1))
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

    # -- (b) the paper's comparison at Fig. 7's operating point --------------------
    # how much of the space each dtype's kernels can launch at all
    from repro_torch.core.analysis import HopperSpec, _gemm_state_launch_error

    paper_space, spec = GemmConfigSpace(*PAPER_DIMS), HopperSpec()
    n_launch = collections.Counter()
    for st in paper_space.enumerate():
        for in_bytes in (2, 4):
            n_launch[in_bytes] += _gemm_state_launch_error(paper_space, st, in_bytes, spec) is None
    print(f"[paper] launchable states of GemmConfigSpace{PAPER_DIMS} (default HopperSpec): "
          f"bfloat16 {n_launch[2]}, float32 {n_launch[4]} of {paper_space.size()}", flush=True)
    LAUNCHES.clear()
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


def profile_split(label: str, fn):
    """Run ``fn`` once under ``torch.profiler`` and print the device time
    of its kernels by kind (the GEMM kernel, the flash kernel, the rest)
    beside the span of CUDA events recorded around the same call, and
    the host's wall time of the call (both taken inside the trace, so
    neither includes the profiler's own start and teardown); the idle
    share is the part of the event span in which no kernel ran.  Returns
    ``(fn(), split)``."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    split = {"gemm": 0.0, "flash": 0.0, "other": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("gemm" if "gemm_tiled" in ev.name else
                "flash" if "flash_fwd" in ev.name else "other")
        split[kind] += ev.time_range.elapsed_us() / 1e3
    busy = sum(split.values())
    shares = " ".join(f"{k}_ms={v:.2f} ({v / busy:.1%} of busy)" for k, v in split.items())
    print(f"[profile] {label}: wall_ms={wall_ms:.2f} event_span_ms={span_ms:.2f} "
          f"device_busy_ms={busy:.2f} idle_share={1 - busy / span_ms:.4f} {shares}", flush=True)
    return out, split


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


if __name__ == "__main__":
    main()
