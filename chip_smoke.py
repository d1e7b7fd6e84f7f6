"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: tune -> record ->
dispatch for yi-6b's five GEMMs at full width, through the hand-written
GEMM kernel.

    python3 chip_smoke.py

Phases (each prints its wall time):

  1. build the kernel (``src/repro_torch/kernels/csrc/gemm.cu``, nvcc);
  2. hold the kernel against its plain PyTorch version on small products
     (several configs, f32 and bf16, and the autograd backward);
  3. tune the five yi-6b bf16 GEMMs (8192 tokens) with G-BFS on times
     measured on the card, each seeded from the kernel's heuristic state;
  4. rerun the tune CLI with ``--warm-start`` on the same records;
  5. reload the records and serve every tuned shape through ``gemm()``,
     checked against an f32 ``torch.matmul``;
  6. hold the kernel under each tuned config against the plain version at
     full width and time the kernel, the plain version and torch.matmul.

Launch counts are zeroed just before phase 3 and read just after phase 5
(the CLI's launches, made in its own process, are added from its
output).  Tolerances: float32 rtol 1e-4 / atol 8e-4, bfloat16 rtol 0.05 /
atol 0.4 (the JAX package's GEMM kernel tests).  Exits non-zero on any
failure; prints the kernels JSON line, then the device line last.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

TOL = {torch.float32: (1e-4, 8e-4), torch.bfloat16: (0.05, 0.4)}
#: dense peak (ops/s) and memory rate (bytes/s) by card, from NVIDIA's data sheets
PEAKS = {"PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12), "default": (989e12, 3.35e12)}
TUNE_TRIALS = 250  # total G-BFS pool over the five workloads (phase 3)
# total pool of the warm-started CLI rerun (phase 4), which starts from
# phase 3's records and serves every state phase 3 measured from the journal
CLI_TRIALS = 100


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s", flush=True)


def timed_ms(fn, repeats: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of ``fn`` over ``repeats`` runs after one
    warm-up run, with the L2 flushed before each timed run."""
    fn()
    total = 0.0
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / repeats


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor, dtype) -> float:
    rtol, atol = TOL[dtype]
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise SystemExit(f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=rtol, atol=atol):
        raise SystemExit(f"{what}: max abs err {err} outside rtol={rtol} atol={atol}")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, SRC)
    from repro_torch.core import Budget, TrialJournal, TuningRecords, TuningSession
    from repro_torch.core.analysis import max_threads_for_reg_tile
    from repro_torch.core.records import set_global_records
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm import (
        LAUNCHES, KernelConfig, build_kernel, default_config, gemm_plain,
        gemm_tiled, kernel_config_from_state, kernel_max_threads, state_from_config,
    )
    from repro_torch.launch.tune import workloads_for_arch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = next(
        (v for k, v in PEAKS.items() if k in name), PEAKS["default"]
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(100 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _, ptxas = build_kernel()
    spills = [l.strip() for l in ptxas.splitlines()
              if "spill" in l and " 0 bytes spill stores" not in l]
    print(f"[build] kernel built in {time.perf_counter() - t0:.1f}s; "
          f"instantiations with spills: {len(spills)}")
    phase("1 build", t0)

    # -- 2. kernel vs plain on small products ----------------------------------
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for rm in (1, 2, 4, 8):
            for rn in (1, 2, 4, 8):
                got = kernel_max_threads(dtype, rm, rn)
                if got != max_threads_for_reg_tile(rm, rn):
                    raise SystemExit(f"launch limit {got} for {dtype} {rm}x{rn} "
                                     f"disagrees with the analyzer")
    configs = [
        KernelConfig(128, 32, 128, 32, 64, 8, 8),
        KernelConfig(64, 16, 64, 32, 32, 4, 4),
        KernelConfig(64, 128, 64, 32, 32, 2, 2),
        KernelConfig(128, 8, 64, 64, 16, 8, 2),
        KernelConfig(32, 64, 32, 0, 0, 1, 1),
        KernelConfig(8, 128, 8, 0, 0, 1, 1),
    ]
    n_checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((1024, 1024, 1024), (512, 256, 768), (256, 1024, 128)):
            a, b = rand((m, k), dtype), rand((k, n), dtype)
            for cfg in configs:
                out = gemm_tiled(a, b, cfg)
                check_close(f"{dtype} {(m, k, n)} {cfg}", out, gemm_plain(a, b, cfg), dtype)
                n_checked += 1
        a = rand((256, 512), dtype).requires_grad_()
        b = rand((512, 384), dtype).requires_grad_()
        g = rand((256, 384), dtype)
        (ops.gemm(a, b) * g).sum().backward()
        check_close(f"{dtype} dA", a.grad, g.float() @ b.detach().float().T, dtype)
        check_close(f"{dtype} dB", b.grad, a.detach().float().T @ g.float(), dtype)
    torch.cuda.synchronize()
    print(f"[check] {n_checked} kernel/plain products and 2 backward passes agree")
    phase("2 kernel vs plain", t0)

    workloads = workloads_for_arch("yi-6b", "train_4k")
    with tempfile.TemporaryDirectory() as tmp:
        records_path = os.path.join(tmp, "yi-6b.json")
        # -- main path: counts zeroed here, read after phase 5 -----------------
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
        torch.cuda.empty_cache()
        phase("3 tune", t0)

        # -- 4. the tune CLI, warm-started from the same records -------------------
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tune", "--arch", "yi-6b",
             "--shape", "train_4k", "--tuner", "g-bfs", "--warm-start",
             "--max-trials", str(CLI_TRIALS), "--records", records_path],
            capture_output=True, text=True, env=env, cwd=HERE, timeout=600,
        )
        print(cli.stdout, end="")
        if cli.returncode != 0:
            raise SystemExit(f"tune CLI failed ({cli.returncode}):\n{cli.stderr}")
        cli_launches = json.loads(re.search(r"kernel_launches=(.*)", cli.stdout).group(1))
        phase("4 tune CLI", t0)

        # -- 5. serve every tuned shape through gemm() from the records ------------
        t0 = time.perf_counter()
        set_global_records(TuningRecords(records_path))
        served = {}
        for label, ((m, k, n), _) in tuned.items():
            a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
            out = ops.gemm(a, b)
            err = check_close(f"gemm() {label}", out, torch.matmul(a.float(), b.float()),
                              torch.bfloat16)
            st = ops.lookup_tuned_state("gemm", (m, k, n), "bfloat16")
            served[label] = st
            print(f"[serve] {label}: config={kernel_config_from_state(st)} max_abs_err={err}")
            del a, b, out
        torch.cuda.synchronize()
        stats = ops.dispatch_stats()["gemm"]
        print(f"[serve] dispatch_stats={stats}")
        if stats["records"] < len(tuned):
            raise SystemExit(f"only {stats['records']} dispatches came from records")
        launches = dict(LAUNCHES)
        for shape, count in cli_launches.items():
            dims = tuple(int(d) for d in shape.split("x"))
            launches[dims] = launches.get(dims, 0) + count
        phase("5 serve", t0)
        set_global_records(TuningRecords())

    print(f"[launches] main path: {sum(launches.values())} kernel launches "
          f"({sum(cli_launches.values())} in the CLI process)")
    for label, (dims, _) in tuned.items():
        if launches.get(dims, 0) == 0:
            raise SystemExit(f"{label}: the kernel never launched on the main path")

    # -- 6. full-width kernel vs plain, and times ----------------------------------
    t0 = time.perf_counter()
    kernels = []
    for label, ((m, k, n), _) in tuned.items():
        cfg = kernel_config_from_state(served[label])
        a, b = rand((m, k), torch.bfloat16), rand((k, n), torch.bfloat16)
        err = check_close(f"full-width {label}", gemm_tiled(a, b, cfg), gemm_plain(a, b, cfg),
                          torch.bfloat16)
        ms = timed_ms(lambda: gemm_tiled(a, b, cfg), 3, flush)
        plain_ms = timed_ms(lambda: gemm_plain(a, b, cfg), 1, flush)
        lib_ms = timed_ms(lambda: torch.matmul(a, b), 5, flush)
        flops, nbytes = 2 * m * k * n, 2 * (m * k + k * n + m * n)
        bound_ms = 1e3 * max(flops / peak_ops, nbytes / peak_bytes)
        kernels.append({
            "name": f"gemm[{label}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm.py:96",
            "launches": launches.get((m, k, n), 0), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / peak_ops >= nbytes / peak_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"[time] {label} {(m, k, n)} {cfg}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"roofline={bound_ms / ms:.4f} tflops={flops / ms / 1e9:.2f}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    phase("6 full-width check and times", t0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
