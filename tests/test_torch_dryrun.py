"""The dry run's counts: a step traced on ``meta`` counts what the same
step counts when it runs, the depth extrapolation equals the full trace,
the GEMM kernel's reported FLOPs equal ``torch.utils.flop_counter``'s
count of the same products on ``torch.matmul``, and the CLI writes the
reference's records.

Inputs are a reduced yi-6b (published layout, narrow widths, f32 unless
a case says bf16) at a few depths; the CPU run takes the kernels' plain
versions, whose ops the counter skips while the wrapper reports the
kernel's work, so every count is compared exactly."""

import json
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import get_shape as ref_get_shape
from repro.utils.roofline import model_flops as ref_model_flops
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.utils.op_costs import OpCounter

#: steps of the reduced model: train above the reduced attention threshold
#: (64: chunked attention under autograd), prefill above it (flash),
#: decode over a 128-deep cache, 8 sequences
SMALL = {"train": ShapeSpec("train", 128, 2, "train"),
         "prefill": ShapeSpec("prefill", 128, 2, "prefill"),
         "decode": ShapeSpec("decode", 128, 8, "decode"),
         # 4 rows: a bf16 product is padded to the bandwidth kernel's 8
         "decode4": ShapeSpec("decode", 128, 4, "decode")}
#: dispatch counters that record a decision (the rest count memo lookups)
DECISIONS = ("records", "heuristic", "explicit", "matmul", "plain", "static_reject")
#: the reference's record keys for an ``ok`` cell (its ``rec.update``)
REF_KEYS = {
    "arch", "shape", "mesh", "kind", "status", "chips", "lower_s", "compile_s",
    "cost_analysis_raw", "cost_analysis_extrapolated", "attn_flops_analytic_per_device",
    "depth_units", "memory_analysis", "param_bytes_per_device", "state_bytes_per_device",
    "bytes_per_device_total", "fits_hbm", "collectives", "collectives_raw", "roofline",
    "roofline_raw_scanbody",
}
#: wall-clock limit of the --all run over the reduced configs (it takes
#: about a minute on one core)
ALL_LIMIT_S = 400


def _yi(layers: int, dtype: str = "float32"):
    return get_arch("yi-6b").reduced(n_layers=layers, param_dtype=dtype, compute_dtype=dtype)


def _counts(counter: OpCounter) -> dict:
    return {"flops": counter.flops, "bytes": counter.bytes, "by_kind": counter.by_kind,
            "kernels": dict(counter.kernel_launches), "peak": counter.peak_bytes}


def test_kernel_wrappers_on_meta_report_their_work_and_launch_nothing():
    gemm_mod.reset_launches()
    fa.LAUNCHES.clear()
    a = torch.empty(256, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(64, 128, dtype=torch.bfloat16, device="meta")
    q = torch.empty(2, 256, 8, 32, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 256, 2, 32, dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        out = ops.gemm(a, b, device="meta")
        o = fa.flash_attention(q, kv, kv, 64, 64)
    assert out.shape == (256, 128) and out.device.type == "meta"
    assert o.shape == q.shape and o.device.type == "meta"
    assert not gemm_mod.LAUNCHES and not gemm_mod.ROLE_LAUNCHES and not fa.LAUNCHES
    assert c.by_kind["gemm_kernel"]["flops"] == 2 * 256 * 64 * 128
    assert c.by_kind["gemm_kernel"]["bytes"] == 2 * (256 * 64 + 64 * 128 + 256 * 128)
    # causal, 4 q blocks of 64 over 4 kv blocks of 64: 1 + 2 + 3 + 4 visits a head
    assert c.by_kind["flash_kernel"]["flops"] == 4 * 2 * 8 * 64 * 64 * 32 * 10
    # q and the output (8 heads), k and v (2 heads), each moved once
    assert c.by_kind["flash_kernel"]["bytes"] == 2 * 2 * 32 * (2 * 256 * 8 + 2 * 256 * 2)
    assert c.kernel_launches == {("gemm", (256, 64, 128)): 1, ("flash", (256, 256, 32)): 1}


def test_alignment_on_meta_is_the_cards_decision():
    """A view one element into a bf16 row lies off a 16-byte boundary on
    the card; on meta its storage offset says so, and dispatch copies it
    as it would there."""
    base = torch.empty(8, 65, dtype=torch.bfloat16, device="meta")
    view = base.view(-1)[1:513].view(8, 64)
    assert gemm_mod.misaligned(view) and not gemm_mod.misaligned(base)
    assert ops._aligned(view).storage_offset() == 0
    b = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm_mod.gemm_tiled(view, b, gemm_mod.default_config(8, 64, 64))


@pytest.mark.parametrize("kind,layers,dtype", [
    ("train", 1, "float32"), ("train", 2, "float32"),
    ("prefill", 1, "float32"), ("prefill", 2, "float32"),
    ("decode", 1, "float32"), ("decode", 2, "float32"),
    ("decode4", 2, "bfloat16"),
])
def test_meta_trace_equals_a_cpu_run(kind, layers, dtype):
    """The same step on meta and run on the CPU: every count equal, and
    the same dispatch decisions."""
    cfg, shape = _yi(layers, dtype), SMALL[kind]
    got = {}
    for device in ("meta", "cpu"):
        ops.reset_dispatch_stats()
        cell = dryrun.make_cell(cfg, shape, device)
        counts = _counts(dryrun.count_step(cell["run"]))
        got[device] = (counts, {op: {k: d[k] for k in DECISIONS}
                                for op, d in ops.dispatch_stats().items()})
    assert got["meta"] == got["cpu"]
    counts, stats = got["cpu"]
    assert counts["by_kind"]["gemm_kernel"]["count"] > 0
    if kind == "prefill":
        assert counts["by_kind"]["flash_kernel"]["count"] == layers
    else:
        assert counts["by_kind"]["attention"]["count"] > 0
    if dtype == "bfloat16":
        assert all(m == 8 for (op, (m, _, _)) in counts["kernels"] if op == "gemm")


@pytest.mark.parametrize("name,kind", [("yi-6b", "train"), ("yi-6b", "prefill"),
                                       ("yi-6b", "decode"), ("whisper-tiny", "train"),
                                       ("qwen3-moe-235b-a22b", "prefill")])
def test_depth_extrapolation_equals_the_full_trace(name, kind):
    """Traces at 1 and 2 depth units, extrapolated to 4, equal the 4-deep
    trace: exactly for FLOPs, and for bytes too (every layer moves the
    same)."""
    cfg = get_arch(name).reduced(n_layers=4, n_encoder_layers=4) if name == "whisper-tiny" \
        else get_arch(name).reduced(n_layers=4)
    shape = SMALL[kind]
    full = dryrun._trace_cell(cfg, shape)
    m1 = dryrun._trace_cell(dryrun._depth_variant(cfg, 1.0), shape)
    m2 = dryrun._trace_cell(dryrun._depth_variant(cfg, 2.0), shape)
    ext = dryrun._extrapolate(m1, m2, 1.0, 2.0, dryrun._depth_units(cfg))
    assert ext["flops"] == full["flops"]
    assert ext["bytes"] == full["bytes"]


def test_gemm_flops_equal_flop_counter_on_matmul(monkeypatch):
    """The kernel's reported 2·M·K·N over a train step (forward, recompute,
    dA, dB) equals FlopCounterMode's count of the same step with every
    product on ``torch.matmul``; the attention products equal its bmm."""
    cfg, shape = _yi(2), SMALL["train"]
    counter = dryrun.count_step(dryrun.make_cell(cfg, shape, "cpu")["run"])
    monkeypatch.setattr(ops, "kernel_config", lambda *a, **k: (None, "matmul"))
    flop_mode = FlopCounterMode(display=False)
    with flop_mode:
        dryrun.make_cell(cfg, shape, "cpu")["run"]()
    per_op = flop_mode.get_flop_counts()["Global"]
    aten = torch.ops.aten
    assert counter.by_kind["gemm_kernel"]["flops"] == per_op[aten.mm]
    assert counter.by_kind["attention"]["flops"] == per_op[aten.bmm]
    assert counter.by_kind["matmul"]["flops"] == 0


def test_run_cell_writes_the_reference_record(tmp_path, capsys):
    cfg = _yi(2)
    rec = dryrun.run_cell("yi-6b", "decode_32k", out_dir=str(tmp_path), cfg_override=cfg)
    assert rec["status"] == "ok" and REF_KEYS <= set(rec)
    with open(tmp_path / "single" / "yi-6b__decode_32k.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["roofline"]["model_flops"] == ref_model_flops(
        ref_get_arch("yi-6b").reduced(n_layers=2), ref_get_shape("decode_32k"))
    assert rec["collectives"] == {"total_operand_bytes": 0} == rec["collectives_raw"]
    assert rec["cost_analysis_extrapolated"] == rec["cost_analysis_raw"]
    out = capsys.readouterr().out
    assert out.startswith("[dryrun] single yi-6b") and "dominant=" in out
    skipped = dryrun.run_cell("yi-6b", "long_500k", out_dir=str(tmp_path))
    assert skipped["status"] == "skipped" and "512k" in skipped["reason"]


def test_all_cells_on_reduced_configs(tmp_path, monkeypatch):
    """``--all`` over the 40 cells of the reduced archs: 32 ok, the
    reference's 8 skipped, no error, each ok record's model flops the
    reference's, within a wall-clock limit."""
    reduced = {name: cfg.reduced() for name, cfg in ARCHS.items()}
    monkeypatch.setattr(dryrun, "ARCHS", reduced)
    monkeypatch.setattr(dryrun, "get_arch", reduced.__getitem__)
    t0 = time.monotonic()
    dryrun.main(["--all", "--out", str(tmp_path)])
    elapsed = time.monotonic() - t0
    recs = []
    for name in os.listdir(tmp_path / "single"):
        with open(tmp_path / "single" / name) as f:
            recs.append(json.load(f))
    status = [r["status"] for r in recs]
    assert len(recs) == 40 and status.count("ok") == 32 and status.count("skipped") == 8
    for r in recs:
        if r["status"] == "ok":
            want = ref_model_flops(ref_get_arch(r["arch"]).reduced(), ref_get_shape(r["shape"]))
            assert r["roofline"]["model_flops"] == want
        else:
            assert r["shape"] == "long_500k" and ARCHS[r["arch"]].family not in ("ssm", "hybrid")
    assert "useful" in dryrun.table(recs) and len(dryrun.table(recs).splitlines()) == 42
    assert elapsed < ALL_LIMIT_S, f"--all over the reduced configs took {elapsed:.0f} s"
    assert set(SHAPES) == {r["shape"] for r in recs}


def test_collectives_keep_the_reference_layout(tmp_path):
    """A ``_c10d_functional`` all-reduce is counted under the reference's
    kind with its operand and result bytes (one process, gloo over a
    file store); one card's steps dispatch none."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        t = torch.ones(256)
        with OpCounter() as c:
            funcol.all_reduce(t, "sum", dist.group.WORLD).wait()
    finally:
        dist.destroy_process_group()
    coll = c.collectives()
    assert coll["all-reduce"] == {"count": 1, "operand_bytes": 1024, "result_bytes": 1024}
    assert coll["total_operand_bytes"] == 1024
    step = dryrun.count_step(dryrun.make_cell(_yi(1), SMALL["decode"], "meta")["run"])
    assert step.collectives() == {"total_operand_bytes": 0}
