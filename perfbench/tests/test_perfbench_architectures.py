"""The architecture modules (``perfbench/architectures/``): what the
decoder gives is pinned to the values the harness read before the
decoder's mapping, weights and arithmetic were gathered into
``architectures/decoder.py`` (each literal below was printed by the
earlier ``system.arch_config``, ``weights._layout`` / ``make_params`` and
``work.widths_of`` / ``served_products`` / ``flash_bound_s`` /
``request_model_flops`` on the committed configuration files); a new
architecture is new files only; the readers of ``ctx.spans``."""

import ast
import collections
import hashlib
import json
import os
import shutil

import pytest
import torch

from conftest import BENCH, ROOT, TINY, TINY_TRAFFIC, tiny_cell
from perfbench import readers, run, spans, specs, system, weights, work
from perfbench.context import RunContext
from perfbench.spans import SpanSummary
from perfbench.trace import TraceSummary
from perfbench.traffic import Mix

NAMES = ["qwen2-72b", "qwen3-moe-235b-a22b"]
DECODER = specs.load_architecture("decoder")


def config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


#: the ArchConfig fields the mapping sets, and the padded vocabulary
ARCH = {
    "qwen2-72b": dict(
        name="qwen2-72b", family="dense", n_layers=20, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=29568, vocab_size=152064, norm="rmsnorm", norm_eps=1e-06,
        mlp_kind="swiglu", qkv_bias=True, rope_theta=1000000.0, tie_embeddings=False,
        param_dtype="bfloat16", compute_dtype="bfloat16", n_experts=0, experts_per_token=0,
        router_norm_topk=True, moe_capacity_factor=1.25, padded_vocab=153600),
    "qwen3-moe-235b-a22b": dict(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=8, d_model=4096, n_heads=64,
        n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936, norm="rmsnorm",
        norm_eps=1e-06, mlp_kind="swiglu", qkv_bias=False, rope_theta=1000000.0,
        tie_embeddings=False, param_dtype="bfloat16", compute_dtype="bfloat16", n_experts=128,
        experts_per_token=8, router_norm_topk=True, moe_capacity_factor=1.25,
        padded_vocab=153600),
}

_BF, _F32 = "bfloat16", "float32"
_S8192, _S4096 = 0.011048543456039806, 0.015625
#: (path, shape, dtype, scale, offset), in order
LEAVES = {
    "qwen2-72b": [
        (("embed", "table"), (153600, 8192), _BF, _S8192, 0.0),
        (("ln_f", "scale"), (8192,), _BF, 0.1, 1.0),
        (("head", "w"), (8192, 153600), _BF, _S8192, 0.0),
        (("layers", "ln1", "scale"), (20, 8192), _BF, 0.1, 1.0),
        (("layers", "ln2", "scale"), (20, 8192), _BF, 0.1, 1.0),
        (("layers", "attn", "wq", "w"), (20, 8192, 8192), _BF, _S8192, 0.0),
        (("layers", "attn", "wq", "b"), (20, 8192), _BF, 0.1, 0.0),
        (("layers", "attn", "wk", "w"), (20, 8192, 1024), _BF, _S8192, 0.0),
        (("layers", "attn", "wk", "b"), (20, 1024), _BF, 0.1, 0.0),
        (("layers", "attn", "wv", "w"), (20, 8192, 1024), _BF, _S8192, 0.0),
        (("layers", "attn", "wv", "b"), (20, 1024), _BF, 0.1, 0.0),
        (("layers", "attn", "wo", "w"), (20, 8192, 8192), _BF, _S8192, 0.0),
        (("layers", "mlp", "wi", "w"), (20, 8192, 29568), _BF, _S8192, 0.0),
        (("layers", "mlp", "wg", "w"), (20, 8192, 29568), _BF, _S8192, 0.0),
        (("layers", "mlp", "wo", "w"), (20, 29568, 8192), _BF, 0.005815526314990443, 0.0),
    ],
    "qwen3-moe-235b-a22b": [
        (("embed", "table"), (153600, 4096), _BF, _S4096, 0.0),
        (("ln_f", "scale"), (4096,), _BF, 0.1, 1.0),
        (("head", "w"), (4096, 153600), _BF, _S4096, 0.0),
        (("layers", "ln1", "scale"), (8, 4096), _BF, 0.1, 1.0),
        (("layers", "ln2", "scale"), (8, 4096), _BF, 0.1, 1.0),
        (("layers", "attn", "wq", "w"), (8, 4096, 8192), _BF, _S4096, 0.0),
        (("layers", "attn", "wk", "w"), (8, 4096, 512), _BF, _S4096, 0.0),
        (("layers", "attn", "wv", "w"), (8, 4096, 512), _BF, _S4096, 0.0),
        (("layers", "attn", "wo", "w"), (8, 8192, 4096), _BF, _S8192, 0.0),
        (("layers", "mlp", "router", "w"), (8, 4096, 128), _F32, _S4096, 0.0),
        (("layers", "mlp", "wi"), (8, 128, 4096, 1536), _BF, _S4096, 0.0),
        (("layers", "mlp", "wg"), (8, 128, 4096, 1536), _BF, _S4096, 0.0),
        (("layers", "mlp", "wo"), (8, 128, 1536, 4096), _BF, 0.02551551815399144, 0.0),
    ],
}

#: the weights of each configuration at conftest's tiny size, seed 2**31 + 5
#: on the CPU: sha256 over every leaf's path and bytes in layout order, by
#: the served dtype
TINY_WEIGHTS = {
    ("qwen2-72b", "bfloat16"):
        "7aa199e066984fa1bb9e8aef69e7217739fb01107372d1c2cdce9e053ef36788",
    ("qwen2-72b", "float32"):
        "25c7a696f6cecc392f13a703a7c9c72b1066980edd4e814c523becc17eb58d4c",
    ("qwen3-moe-235b-a22b", "bfloat16"):
        "52954d9e78c6cb151621075789a8e80234b2f153beb6409dc9e5218cfbf31b43",
    ("qwen3-moe-235b-a22b", "float32"):
        "fc1865c4a42b8442b98fcaa68126d22f56df9b1fbc4a1ea1c5d1bcd78d625b87",
}

#: a batch at the cells' own sizes (8 rows, bucket 4096, 16 generated):
#: the served products (how many, sha256 of the list's repr, how many of
#: each), the least time of those products, the attention bound over every
#: layer and the model operations of one request at lengths 2049 and 4096
WORK = {
    "qwen2-72b": dict(
        n=2256, sha256="1cbd82d3c25ccc793336b74e9184ef1e695675406219e84c83fb647868e53c97",
        counts={(8, 8192, 1024): 600, (8, 8192, 8192): 600, (8, 8192, 29568): 600,
                (8, 8192, 152064): 16, (8, 29568, 8192): 300, (32768, 8192, 1024): 40,
                (32768, 8192, 8192): 40, (32768, 8192, 29568): 40, (32768, 29568, 8192): 20},
        gemm_bound_s=1.3324985072057323,
        attention_bound_s={2049: 0.0013917122912032358, 4096: 0.00556006098701719},
        flops={2049: 73895940980736, 4096: 149901206880256}),
    "qwen3-moe-235b-a22b": dict(
        n=528, sha256="dfeb8885a2b32709d36040cb1fa86304c121d2ac5e45d0ab467f14e6aafc1c85",
        counts={(8, 4096, 512): 240, (8, 4096, 8192): 120, (8, 4096, 151936): 16,
                (8, 8192, 4096): 120, (32768, 4096, 512): 16, (32768, 4096, 8192): 8,
                (32768, 8192, 4096): 8},
        gemm_bound_s=0.04888340745263643,
        attention_bound_s={2049: 0.0005566849164812943, 4096: 0.002224024394806876},
        flops={2049: 7937051328512, 4096: 16891978448896}),
}


@pytest.mark.parametrize("name", NAMES)
def test_arch_config_is_pinned(name):
    arch = system.arch_config(config(name), DECODER)
    assert {k: getattr(arch, k) for k in ARCH[name]} == ARCH[name]


@pytest.mark.parametrize("name", NAMES)
def test_leaf_list_is_pinned(name):
    cfg = config(name)
    leaves = DECODER.layout(cfg, system.arch_config(cfg, DECODER).padded_vocab)
    assert leaves == LEAVES[name]


def _leaf_bytes(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).contiguous().numpy().tobytes()


@pytest.mark.parametrize("name,dtype", sorted(TINY_WEIGHTS))
def test_tiny_weights_are_pinned_bit_for_bit(name, dtype):
    cfg = dict(config(name), **TINY[name], torch_dtype=dtype)
    leaves = DECODER.layout(cfg, system.arch_config(cfg, DECODER).padded_vocab)
    tree, bufs = weights.make_params(leaves, 2 ** 31 + 5, "cpu")
    digest = hashlib.sha256()
    for path, *_ in leaves:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        digest.update("/".join(path).encode())
        digest.update(_leaf_bytes(leaf))
    assert digest.hexdigest() == TINY_WEIGHTS[(name, dtype)]
    # a refill with the same seed draws the same weights into the same tensors
    before = [t.clone() for t in bufs.values()]
    weights.refill(leaves, tree, bufs, 2 ** 31 + 6)
    weights.refill(leaves, tree, bufs, 2 ** 31 + 5)
    assert all(torch.equal(a, b) for a, b in zip(before, bufs.values()))


@pytest.mark.parametrize("name", NAMES)
def test_work_at_the_cells_sizes_is_pinned(name):
    cfg, want = config(name), WORK[name]
    prods = DECODER.served_products(cfg, 8, 4096, 16)
    assert len(prods) == want["n"]
    assert hashlib.sha256(repr(prods).encode()).hexdigest() == want["sha256"]
    assert collections.Counter(prods) == want["counts"]
    assert sum(work.product_bound_s(*p) for p in prods) == want["gemm_bound_s"]
    for n in (2049, 4096):
        assert DECODER.attention_bound_s(cfg, n) == want["attention_bound_s"][n]
        assert DECODER.request_model_flops(cfg, n, 16) == want["flops"][n]


def test_a_configuration_without_an_architecture_is_refused():
    cfg = config("qwen2-72b")
    del cfg["architecture"]
    with pytest.raises(KeyError, match="'architecture'"):
        specs.architecture_of(cfg)


@pytest.mark.parametrize("change", [{"hidden_act": "relu2"}, {"hidden_act": None},
                                    {"mlp_hidden_act": "relu2"}])
def test_the_decoder_maps_only_swiglu(change):
    """A missing ``hidden_act`` is not taken for silu, and a file that
    states its FFN's activation under ``mlp_hidden_act`` (Nemotron-H's key)
    is refused rather than read as a SwiGLU decoder."""
    cfg = config("qwen2-72b")
    for key, value in change.items():
        if value is None:
            del cfg[key]
        else:
            cfg[key] = value
    with pytest.raises(ValueError, match="hidden_act"):
        DECODER.arch_fields(cfg)


def test_architectures_import_nothing_of_the_port():
    """The port is reached through ``perfbench/system.py`` alone."""
    folder = os.path.join(BENCH, "architectures")
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(folder, fname)) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        tops = {n.partition(".")[0] for n in names}
        assert tops <= {"__future__", "math", "perfbench"}, (fname, tops)


def test_a_new_architecture_is_new_files_only(tmp_path, state_dir):
    """A configuration that names an architecture found only in another
    bench dir (there a copy of the decoder's, under another name, counting
    its calls) is set up, served, checked and read through that module."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("_state", "tests"))
    bench_dir = root / "perfbench"
    copy = (bench_dir / "architectures" / "decoder.py").read_text() + (
        "\n\nCALLS = []\n_layout, _arch_fields = layout, arch_fields\n\n\n"
        "def layout(config, padded_vocab):\n"
        "    CALLS.append('layout')\n"
        "    return _layout(config, padded_vocab)\n\n\n"
        "def arch_fields(config):\n"
        "    CALLS.append('arch_fields')\n"
        "    return _arch_fields(config)\n")
    (bench_dir / "architectures" / "copied-decoder.py").write_text(copy)
    cfg = dict(config("qwen2-72b"), **TINY["qwen2-72b"], name="copied",
               architecture="copied-decoder")
    (bench_dir / "configs" / "copied.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (bench_dir / "cells" / "copied.tiny.json").write_text(json.dumps(
        {"name": "copied.tiny", "tune_trials": 2, "check_requests": 4,
         "limits": {"widest_gap": 0.05}}))
    grown = specs.load_benchmark(ROOT)
    grown["configs"].append({"name": "copied", "source": cfg["source"],
                             "file": "perfbench/configs/copied.json",
                             "reduced": ["num_hidden_layers"], "why": "a test"})
    grown["workloads"].append({"name": "copied.tiny", "config": "copied", "traffic": "tiny",
                               "chips": 1, "why": "a test"})
    for m in grown["end_to_end"] + grown["per_layer"]:
        if "workloads" in m and "qwen2-72b.long-prompt" in m["workloads"]:
            m["workloads"].append("copied.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(grown))

    cell = specs.load_cell("copied.tiny", root=str(root), bench_dir=str(bench_dir))
    arch = cell.architecture
    assert arch.__file__ == str(bench_dir / "architectures" / "copied-decoder.py")
    result, ctx = run.run_cell(cell, 2 ** 31 + 41, 0.3, True, device="cpu",
                               state_dir=state_dir)
    assert {"layout", "arch_fields"} <= set(arch.CALLS)
    assert result["correct"] and ctx.architecture is arch
    assert "mfu.prompt" in result["metrics"]
    # the readers' work is the copy's; a synthetic trace gives the rooflines a time
    ctx.trace = TraceSummary(1.0, 1.0, {"gemm_tiled_wgmma": 2.0, "flash_fwd_bf16": 0.5}, [])
    mix = Mix.from_file(TINY_TRAFFIC)
    traced = ctx.traced_batches()
    assert readers.gemm_roofline(ctx) == 100.0 * sum(
        work.product_bound_s(*p) for b in traced
        for p in DECODER.served_products(cfg, len(b.lens), mix.bucket, b.gen)) / 2.0
    assert readers.flash_roofline(ctx) == 100.0 * sum(
        DECODER.attention_bound_s(cfg, int(n)) for b in traced for n in b.lens) / 0.5
    assert readers.mfu(ctx) == result["metrics"]["mfu.prompt"]["value"]


# -- the readers of ctx.spans ---------------------------------------------------------


def _ctx(by_span, n_traced=2):
    batch = type("B", (), {"traced": True})
    ctx = RunContext(config={}, architecture=DECODER, mix=None, setup_s=1.0, window_s=1.0,
                     batches=[batch() for _ in range(n_traced)], dispatch={})
    if by_span is not None:
        ctx.spans = SpanSummary(1.0, 0.9, by_span, {}, {})
    return ctx


def test_moe_span_metrics_read_device_ms_a_traced_prefill():
    experts = specs.metric_reader("moe.experts_ms.prompt")
    overhead = specs.metric_reader("moe.overhead_ms.prompt")
    ctx = _ctx({"serve.prefill": 0.9, "block.moe": 0.5, "moe.route": 0.02,
                "moe.dispatch": 0.08, "moe.experts": 0.25, "moe.combine": 0.12})
    assert experts(ctx) == pytest.approx(125.0)
    assert overhead(ctx) == pytest.approx(110.0)


@pytest.mark.parametrize("by_span", [None, {}, {"serve.prefill": 0.9, "block.mlp": 0.6}])
def test_moe_span_metrics_read_nothing_without_their_spans(by_span):
    """An untraced run, a trace with no device work (the CPU) and a dense
    model's trace hold no MoE span: the metrics are left out, not 0."""
    for name in ("moe.experts_ms.prompt", "moe.overhead_ms.prompt"):
        assert specs.metric_reader(name)(_ctx(by_span)) is None


def test_a_traced_run_keeps_its_spans(state_dir):
    result, ctx = run.run_cell(tiny_cell("qwen2-72b", limits={"widest_gap": 0.05}),
                               2 ** 31 + 43, 0.3, True, device="cpu", state_dir=state_dir)
    assert isinstance(ctx.spans, spans.SpanSummary) and ctx.spans.window_s > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    _, untraced = run.run_cell(tiny_cell("qwen2-72b", limits={"widest_gap": 0.05}),
                               2 ** 31 + 43, 0.3, False, device="cpu", state_dir=state_dir)
    assert untraced.spans is None
