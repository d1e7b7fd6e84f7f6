"""Single-card dry run: trace every (arch × shape) cell's step at
production size and read its roofline on one H100 — the twin of the JAX
package's ``launch/dryrun.py``.

The reference lowers and compiles each cell's step against abstract
shapes on a 256- or 512-chip TPU mesh and reads XLA's ``cost_analysis()``
and ``memory_analysis()``.  Eager PyTorch has no compiled artifact; its
counterpart is a trace of the real step on the ``meta`` device, which
allocates and computes nothing, under ``utils/op_costs.OpCounter``: each
dispatched op's FLOPs and bytes, the hand-written kernels' work as their
grids do it (their wrappers take the card's dispatch decisions on
``meta``), and the live bytes to a peak.  For each cell it records:

  * the step's counted FLOPs / bytes     -> roofline §compute / §memory
  * its live peak and its inputs' bytes  -> fits in the card's HBM
  * collectives                          -> none on one card

The step is ``make_train_step`` with the config's optimizer for
``train``, ``Model.prefill`` into an abstract cache for ``prefill`` and
``Model.decode_step`` on an abstract ``seq_len``-deep cache for
``decode``, at full depth and the shape's global batch.  Every layer
dispatches its own ops, so the full-depth trace needs no correction (XLA
counts a scan body once, hence the reference's extrapolation and its
analytic attention term); both are still computed and recorded
(``cost_analysis_extrapolated`` from traces at 1 and 2 depth units,
``attn_flops_analytic_per_device``), and the extrapolation must equal
the full trace.  The reference's ``dist.sharding`` does not exist and
one card has no mesh (``launch/mesh.py``), so ``--mesh single`` is the
only mesh.

Results land as JSON under ``<out>/single/<arch>__<shape>.json``.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.models.api import Model
from repro_torch.optim import make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.utils.op_costs import OpCounter, uncounted
from repro_torch.utils.roofline import H100, model_flops, roofline_from_costs
from repro_torch.utils.tree import tree_leaves

__all__ = ["run_cell", "make_cell", "count_step", "table", "main"]


def _tree_bytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _depth_variant(cfg, units: float):
    """A same-family config with ``units`` depth units (see
    ``_depth_units``): dense/ssm layers, encdec (dec+enc) pairs, hybrid
    groups-of-interval."""
    n = int(units)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=n, n_encoder_layers=n,
                                   scan_layers=False)
    if cfg.family == "hybrid" and cfg.hybrid_attn_interval:
        return dataclasses.replace(
            cfg, n_layers=n * cfg.hybrid_attn_interval, scan_layers=False
        )
    return dataclasses.replace(cfg, n_layers=n, scan_layers=False)


def _depth_units(cfg) -> float:
    if cfg.family == "hybrid" and cfg.hybrid_attn_interval:
        return cfg.n_layers / cfg.hybrid_attn_interval
    return float(cfg.n_layers)


def make_cell(cfg, shape: ShapeSpec, device="meta") -> dict:
    """One cell's step and its inputs on ``device``: ``{"run", "params",
    "state", "batch"}``, ``run()`` taking the step once.  On ``meta`` the
    inputs are abstract; elsewhere they are drawn from seed 0 (random
    weights and tokens, a zero cache whose length is ``seq_len - 1``)."""
    model = Model(cfg, device=device)
    b, s = shape.global_batch, shape.seq_len
    if torch.device(device).type == "meta":
        params, batch = model.abstract_params(), model.batch_specs(shape)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init_params(generator=gen)
        batch = {}
        for name, spec in model.batch_specs(shape).items():
            if spec.dtype.is_floating_point:
                batch[name] = torch.randn(spec.shape, generator=gen, device=device).to(spec.dtype)
            else:
                batch[name] = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                                            device=device, dtype=spec.dtype)
    if shape.kind == "train":
        optimizer = make_optimizer(cfg.optimizer, 1e-4)
        state = optimizer.init(params)
        step = make_train_step(model, optimizer, grad_accum=cfg.dryrun_grad_accum)

        def run():
            return step(params, state, batch)
    else:
        state = model.init_cache(b, s)
        if shape.kind == "prefill":
            def run():
                return model.prefill(params, batch, s, cache=state)
        else:
            state["len"].fill_(s - 1)  # one new token against a seq_len-deep cache

            def run():
                with uncounted():  # the same depth at every call
                    state["len"].fill_(s - 1)
                return model.decode_step(params, state, batch["tokens"])
    return {"run": run, "params": params, "state": state, "batch": batch}


def count_step(run) -> OpCounter:
    """Take one step under a fresh counter and return the counter."""
    with OpCounter() as counter:
        run()
    return counter


def _trace_cell(cfg, shape: ShapeSpec) -> dict:
    """Trace one step on ``meta``; returns a measurement dict (the keys of
    the reference's ``_compile_cell``: ``lower_s`` is building the
    abstract inputs, ``compile_s`` the trace)."""
    t0 = time.monotonic()
    cell = make_cell(cfg, shape, "meta")
    t_lower = time.monotonic() - t0
    counter = count_step(cell["run"])
    t_trace = time.monotonic() - t0 - t_lower
    param_bytes, state_bytes = _tree_bytes(cell["params"]), _tree_bytes(cell["state"])
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "by_kind": counter.by_kind,
        "collectives": counter.collectives(),
        "mem": {
            "argument_size_in_bytes": param_bytes + state_bytes + _tree_bytes(cell["batch"]),
            "alias_size_in_bytes": param_bytes + state_bytes if shape.kind == "train"
            else state_bytes,
            "temp_size_in_bytes": counter.peak_bytes,
        },
        "param_bytes": param_bytes,
        "state_bytes": state_bytes,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_trace, 2),
        "chips": 1,
    }


def analytic_chunked_attn_flops(cfg, shape: ShapeSpec) -> float:
    """GLOBAL attention flops hidden from cost_analysis when the
    flash-chunked path runs (its q-block map / kv-chunk scan bodies are
    counted once by XLA).  2·B·S²·H·hd per attention layer-application
    (qk + pv einsums, causal halving); x3 for training (fwd + bwd).  The
    port's trace counts attention itself: this is recorded, not added."""
    if shape.kind == "decode" or cfg.family == "ssm":
        return 0.0
    s = shape.seq_len
    if s <= cfg.attn_chunk_threshold:
        return 0.0  # full-attention path: flops visible to cost_analysis
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.hybrid_attn_interval, 1)
    else:
        n_attn = cfg.n_layers
    per_layer = 2.0 * shape.global_batch * float(s) * float(s) * cfg.n_heads * cfg.resolved_head_dim
    total = per_layer * n_attn
    if shape.kind == "train":
        total *= 3.0
    return total


def _extrapolate(m1: dict, m2: dict, u1: float, u2: float, u_full: float) -> dict:
    """Linear-in-depth extrapolation of flops/bytes/collective bytes."""
    def lin(a, b):
        slope = (b - a) / (u2 - u1)
        return a + slope * (u_full - u1)

    coll = {}
    kinds = set(m1["collectives"]) | set(m2["collectives"])
    kinds.discard("total_operand_bytes")
    for k in kinds:
        a = m1["collectives"].get(k, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        b = m2["collectives"].get(k, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        coll[k] = {
            "count": int(round(lin(a["count"], b["count"]))),
            "operand_bytes": lin(a["operand_bytes"], b["operand_bytes"]),
            "result_bytes": lin(a["result_bytes"], b["result_bytes"]),
        }
    coll["total_operand_bytes"] = sum(v["operand_bytes"] for v in coll.values())
    return {
        "flops": lin(m1["flops"], m2["flops"]),
        "bytes": lin(m1["bytes"], m2["bytes"]),
        "collectives": coll,
    }


def run_cell(arch_name: str, shape_name: str, mesh_kind: str = "single",
             out_dir: str = "experiments/dryrun", cfg_override=None, tag: str = "") -> dict:
    """Trace one cell at full depth and at 1 and 2 depth units, write its
    record (the reference's keys) and return it.  A cell that fails is
    recorded as ``error`` with its traceback.  Any mesh but ``single``
    raises ``ValueError``."""
    if mesh_kind != "single":
        raise ValueError(f"mesh {mesh_kind!r}: the port runs on one card and has no "
                         "device mesh (launch/mesh.py)")
    cfg = cfg_override or get_arch(arch_name)
    shape = get_shape(shape_name)
    model = Model(cfg, device="meta")
    rec: dict = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
    }
    ok, reason = model.supports_shape(shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _write(rec, out_dir, tag)
        return rec

    chips = 1
    hw = H100()
    try:
        full = _trace_cell(cfg, shape)
        u_full = _depth_units(cfg)
        u1, u2 = 1.0, 2.0
        m1 = _trace_cell(_depth_variant(cfg, u1), shape)
        m2 = _trace_cell(_depth_variant(cfg, u2), shape)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        _write(rec, out_dir, tag)
        return rec

    # the trace runs every microbatch (a loop, not a scan body), so unlike
    # the reference nothing is scaled by dryrun_grad_accum
    ext = _extrapolate(m1, m2, u1, u2, u_full)
    mf = model_flops(cfg, shape)
    attn = analytic_chunked_attn_flops(cfg, shape) / chips
    terms = roofline_from_costs(full["flops"], full["bytes"], full["collectives"], chips, mf,
                                hw)
    per_device_total = (
        full["param_bytes"] + full["state_bytes"] + full["mem"]["temp_size_in_bytes"]
    )
    rec.update(
        {
            "status": "ok",
            "chips": chips,
            "device": "meta",
            "hw": dataclasses.asdict(hw),
            "lower_s": full["lower_s"],
            "compile_s": full["compile_s"],
            "cost_analysis_raw": {"flops": full["flops"], "bytes accessed": full["bytes"]},
            "cost_analysis_extrapolated": {"flops": ext["flops"], "bytes accessed": ext["bytes"]},
            "cost_by_kind": full["by_kind"],
            "attn_flops_analytic_per_device": attn,
            "depth_units": {"full": u_full, "probe": [u1, u2]},
            "memory_analysis": full["mem"],
            "param_bytes_per_device": full["param_bytes"],
            "state_bytes_per_device": full["state_bytes"],
            "bytes_per_device_total": per_device_total,
            "fits_hbm": bool(per_device_total < hw.hbm_bytes),
            "collectives": ext["collectives"],
            "collectives_raw": full["collectives"],
            "roofline": terms.as_dict(),
            # a trace has no scan body: the raw terms are the full trace's
            "roofline_raw_scanbody": terms.as_dict(),
        }
    )
    _write(rec, out_dir, tag)
    return rec


def _write(rec: dict, out_dir: str, tag: str = "") -> None:
    d = os.path.join(out_dir, rec["mesh"] + (f"-{tag}" if tag else ""))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (
            f" compile={rec['compile_s']:.0f}s dominant={r['dominant']}"
            f" c/m/coll={r['compute_s']:.2e}/{r['memory_s']:.2e}/{r['collective_s']:.2e}s"
            f" fits_hbm={rec['fits_hbm']}"
        )
    elif status == "error":
        extra = " " + rec["error"][:200]
    elif status == "skipped":
        extra = " " + rec["reason"]
    print(f"[dryrun] {rec['mesh']:6s} {rec['arch']:24s} {rec['shape']:12s} {status}{extra}", flush=True)


def table(records: list[dict]) -> str:
    """The records as the reference's roofline report prints them: terms,
    dominant term, the model-flops share of the counted work, HBM fit."""
    header = (
        f"{'arch':24s} {'shape':12s} {'status':8s} {'compute_s':>10s} "
        f"{'memory_s':>10s} {'coll_s':>10s} {'dominant':>10s} "
        f"{'useful':>7s} {'fits':>5s}"
    )
    rows = [header, "-" * len(header)]
    for rec in records:
        if rec["status"] == "ok":
            r = rec["roofline"]
            rows.append(
                f"{rec['arch']:24s} {rec['shape']:12s} {'ok':8s} "
                f"{r['compute_s']:10.3e} {r['memory_s']:10.3e} "
                f"{r['collective_s']:10.3e} {r['dominant']:>10s} "
                f"{r['useful_ratio']:7.3f} {str(rec['fits_hbm']):>5s}"
            )
        else:
            reason = rec.get("reason", rec.get("error", ""))[:40]
            rows.append(f"{rec['arch']:24s} {rec['shape']:12s} {rec['status']:8s} {reason}")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="one card has no mesh (launch/mesh.py)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    for arch, shp in cells:
        out_path = os.path.join(args.out, args.mesh, f"{arch}__{shp}.json")
        if args.skip_existing and os.path.exists(out_path):
            with open(out_path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[dryrun] skip existing {args.mesh} {arch} {shp}")
                    continue
        run_cell(arch, shp, args.mesh, out_dir=args.out)


if __name__ == "__main__":
    main()
