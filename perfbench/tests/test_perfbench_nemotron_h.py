"""Nemotron-H's architecture (``architectures/nemotron_h.py``) and plain
reference (``references/nemotron_h.py``): the mapping onto the port and
its refusals, the layout against the engine's own tree, the work at the
cell's sizes pinned (the SSD's count against a hand count), and whole
runs on the CPU at a tiny size: sound, correct; with each fault of the
cell planted, not."""

import copy
import json
import math
import os

import pytest

from conftest import BENCH, ROOT, TINY_TRAFFIC
from perfbench import control, faults, run, specs, system, work

ARCH = specs.load_architecture("nemotron_h")
CELL = "nemotron-h-47b.long-prompt"
#: the configuration's widths cut to a tiny size (the pattern of
#: ``tests/test_torch_hybrid.py``)
TINY = dict(hidden_size=64, mamba_num_heads=8, mamba_head_dim=16, n_groups=2,
            ssm_state_size=16, chunk_size=16, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, attention_head_dim=16, vocab_size=256,
            hybrid_override_pattern="M-*M-M*-", num_hidden_layers=8)
#: at the tiny size, six seeds each: the program's widest gap 0-0.037 in
#: bf16 (0 in float32), the fp8 control's 0.087-0.235 (0.198-0.520)
LIMITS = {"bfloat16": {"widest_gap": 0.06}, "float32": {"widest_gap": 0.01}}


def config(**extra) -> dict:
    with open(os.path.join(BENCH, "configs", "nemotron-h-47b.json")) as f:
        cfg = json.load(f)
    cfg.update(extra)
    return cfg


def tiny_cell(dtype="bfloat16"):
    bench = specs.load_benchmark(ROOT)
    cfg = config(**TINY, torch_dtype=dtype)
    return specs.Cell(name="tiny-nemotron-h", chips=1, config=cfg,
                      architecture=specs.architecture_of(cfg),
                      traffic=copy.deepcopy(TINY_TRAFFIC),
                      check={"tune_trials": 2, "check_requests": 4, "limits": LIMITS[dtype]},
                      end_to_end=specs.metrics_for(bench["end_to_end"], CELL),
                      per_layer=specs.metrics_for(bench["per_layer"], CELL))


# -- the mapping ------------------------------------------------------------------------


def test_the_configuration_keeps_every_published_width():
    """The catalog's keys as run: only the depth and its pattern cut,
    the published values beside them."""
    cfg = config()
    assert cfg["reduced"] == ["num_hidden_layers", "hybrid_override_pattern"]
    pub = cfg["published"]
    assert pub["num_hidden_layers"] == 98 and len(pub["hybrid_override_pattern"]) == 98
    assert cfg["hybrid_override_pattern"] == pub["hybrid_override_pattern"][:49]
    assert [i for i, k in enumerate(cfg["hybrid_override_pattern"]) if k == "*"] == [17, 38]
    arch = system.arch_config(cfg, ARCH)
    assert arch.layer_counts() == {"M": 24, "-": 23, "*": 2}
    assert arch.n_params() == 24_548_345_856  # 49.1 GB in bf16
    assert (arch.d_inner, arch.ssm_heads, arch.padded_vocab) == (16384, 256, 131072)


def test_arch_fields_are_pinned():
    arch = system.arch_config(config(), ARCH)
    want = dict(
        name="nemotron-h-47b", family="hybrid", n_layers=49, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=30720, vocab_size=131072, norm="rmsnorm",
        norm_eps=1e-05, mlp_kind="squared_relu", qkv_bias=False, pos_embed="none",
        tie_embeddings=False, ssm_state=256, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
        ssm_chunk=128, ssm_n_groups=8, param_dtype="bfloat16", compute_dtype="bfloat16",
        attn_chunk_threshold=2048, hybrid_attn_interval=0)
    assert {k: getattr(arch, k) for k in want} == want
    assert arch.layer_pattern == config()["hybrid_override_pattern"]


@pytest.mark.parametrize("change,match", [
    ({"rope_theta": 10000.0}, "not mapped"),
    ({"moe_intermediate_size": 1856}, "not mapped"),
    ({"mlp_hidden_act": "silu"}, "mlp_hidden_act"),
    ({"attention_bias": True}, "attention_bias"),
    ({"use_conv_bias": False}, "use_conv_bias"),
    ({"time_step_limit": [0.0, 0.1]}, "time_step_limit"),
    ({"mamba_num_heads": 128}, "expand"),
    ({"n_groups": 3}, "groups"),
    ({"num_hidden_layers": 48}, "hybrid_override_pattern"),
    ({"hybrid_override_pattern": "E" * 49}, "hybrid_override_pattern"),
    ({"layer_norm_epsilon": 1e-6}, "layer_norm_epsilon"),
])
def test_arch_fields_refuse_what_they_do_not_map(change, match):
    with pytest.raises(ValueError, match=match):
        ARCH.arch_fields(config(**change))


# -- the layout against the engine's tree ---------------------------------------------


def _tree_leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _tree_leaves(value, path + (key,))
        else:
            yield path + (key,), tuple(value.shape), str(value.dtype).removeprefix("torch.")


@pytest.mark.parametrize("extra", [{}, TINY], ids=["cell", "tiny"])
def test_layout_is_the_engines_tree_leaf_for_leaf(extra):
    """Every leaf the engine's model makes (on ``meta`` at the cell's
    size: nothing is allocated), path, shape and type, and no other."""
    from repro_torch.models.api import Model

    cfg = config(**extra)
    arch = system.arch_config(cfg, ARCH)
    leaves = ARCH.layout(cfg, arch.padded_vocab)
    engine = sorted(_tree_leaves(Model(arch, device="meta").abstract_params()))
    assert sorted((path, shape, dtype) for path, shape, dtype, _, _ in leaves) == engine
    scalars = {path[-1]: (dtype, scale, offset) for path, _, dtype, scale, offset in leaves
               if path[0] == "mamba" and dtype == "float32"}
    assert set(scalars) == {"A_log", "D", "dt_bias"}
    a_mid, a_sd = scalars["A_log"][2], scalars["A_log"][1]
    assert math.exp(a_mid - 5 * a_sd) == pytest.approx(1.0)
    assert math.exp(a_mid + 5 * a_sd) == pytest.approx(16.0)
    dt_mid, dt_sd = scalars["dt_bias"][2], scalars["dt_bias"][1]
    for x, want in ((dt_mid - 5 * dt_sd, 1e-3), (dt_mid + 5 * dt_sd, 1e-1)):
        assert math.log1p(math.exp(x)) == pytest.approx(want)


# -- the work of a batch -------------------------------------------------------------


def test_served_products_at_the_cells_sizes():
    cfg = config()
    prods = ARCH.served_products(cfg, 8, 4096, 16)
    m, counts = 32768, {}
    for p in prods:
        counts[p] = counts.get(p, 0) + 1
    assert counts == {
        (m, 8192, 37120): 24, (m, 16384, 8192): 24, (m, 8192, 30720): 23,
        (m, 30720, 8192): 23, (m, 8192, 8192): 4, (m, 8192, 1024): 4,
        (8, 8192, 37120): 24 * 15, (8, 16384, 8192): 24 * 15, (8, 8192, 30720): 23 * 15,
        (8, 30720, 8192): 23 * 15, (8, 8192, 8192): 4 * 15, (8, 8192, 1024): 4 * 15,
        (8, 8192, 131072): 16}
    assert len(prods) == 16 * (24 * 2 + 23 * 2 + 2 * 4) + 16


def test_ssd_count_against_a_hand_count():
    """At 2049 positions (16 chunks of 128 and one of 1) in one layer:
    C·Bᵀ by group and the scores by head over the causal pairs inside
    the chunks, B ⊗ x and C against the entering state at every position,
    17 chunk states carried; bytes of x, dt, B, C and y in bf16 and the
    final state in f32; 24 Mamba layers."""
    cfg = config()
    pairs = 16 * 128 * 129 // 2 + 1
    flops = 2 * pairs * (8 * 256 + 256 * 64) + 4 * 2049 * 256 * 64 * 256 + 2 * 17 * 256 * 64 * 256
    assert ARCH.ssd_flops(cfg, 2049) == flops
    nbytes = 2 * 2049 * (2 * 16384 + 256 + 2 * 2048) + 4 * 256 * 64 * 256
    assert ARCH.ssd_bytes(cfg, 2049) == nbytes
    one = max(flops / work.PEAK_FLOPS_BF16, nbytes / work.PEAK_BYTES_PER_S)
    assert ARCH.ssd_bound_s(cfg, 2049) == one * 24
    assert nbytes / work.PEAK_BYTES_PER_S > flops / work.PEAK_FLOPS_BF16  # memory-bound
    assert ARCH.ssd_bound_s(cfg, 4096) == pytest.approx(2.298728998208955e-3)


def test_attention_and_model_work_at_the_cells_sizes():
    cfg = config()
    w = work.Widths(n_layers=49, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
                    d_ff=30720, vocab=131072)
    for n in (2049, 4096):
        assert ARCH.attention_bound_s(cfg, n) == 2 * work.flash_bound_s(w, n)
    weights = 24 * (8192 * 37120 + 16384 * 8192) + 23 * 2 * 8192 * 30720 + 2 * (
        2 * 8192 * 8192 + 2 * 8192 * 1024)
    per_token = 2 * (weights + 24 * 4 * 20480)
    n, gen = 2049, 16
    attn = work.causal_attention_flops(w, n) + sum(4 * 64 * 128 * (n + j) for j in range(1, gen))
    ssd = ARCH.ssd_flops(cfg, n) + 15 * 6 * 256 * 64 * 256
    want = per_token * (n + 15) + 2 * attn + 24 * ssd + 2 * 8192 * 131072 * 16
    assert ARCH.request_model_flops(cfg, n, gen) == want == 93_593_751_879_680


# -- whole runs on the CPU at a tiny size ------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sound_run_is_correct_and_reports_its_metrics(state_dir, dtype):
    result, ctx = run.run_cell(tiny_cell(dtype), 2 ** 31 + 17, 0.3, True, device="cpu",
                               state_dir=state_dir)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert {"engine.prefill_ms.prompt", "mfu.prompt"} <= set(result["metrics"])
    assert ctx.architecture is ARCH or ctx.architecture.__file__ == ARCH.__file__


@pytest.mark.parametrize("fault", ["stale_state", "pad_state", "half_batch"])
def test_each_fault_of_the_cell_is_refused(state_dir, fault):
    with faults.planted(fault, ARCH):
        result, _ = run.run_cell(tiny_cell(), 2 ** 31 + 17, 0.3, False, device="cpu",
                                 state_dir=state_dir)
    assert not result["correct"], result["checks"]


def test_every_fault_is_restored():
    from repro_torch.models import hybrid, mamba2

    before = (hybrid.hybrid_decode_step, mamba2.mamba_block_prefill)
    assert list(faults.of(ARCH))[:2] == ["stale_state", "pad_state"]
    for name in ("stale_state", "pad_state"):
        with faults.planted(name, ARCH):
            assert (hybrid.hybrid_decode_step, mamba2.mamba_block_prefill) != before
        assert (hybrid.hybrid_decode_step, mamba2.mamba_block_prefill) == before


def test_control_and_faults_are_judged_as_a_run_is(state_dir):
    seeds = [2 ** 31 + 101, 2 ** 31 + 102]
    rows = list(control.readings(tiny_cell(), seeds, set(seeds), 1,
                                 ("stale_state", "pad_state"), device="cpu",
                                 state_dir=state_dir))
    program = [r for r in rows if r["run"] == "program"]
    planted = [r for r in rows if r["run"].startswith("fault:")]
    assert all(r["correct"] and not r["control_correct"] for r in program), program
    assert len(planted) == 2 and not any(r["correct"] for r in planted), planted


def test_the_reference_imports_nothing_of_the_port():
    import ast

    for path in (os.path.join(BENCH, "references", "nemotron_h.py"),
                 os.path.join(ROOT, "tests", "torch_reference_nemotron_h.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert {n.partition(".")[0] for n in names} <= {"__future__", "contextlib", "math",
                                                         "torch"}, path
