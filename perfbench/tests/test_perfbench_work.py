"""The frozen arithmetic: hand-worked counts, and the port's own op
counter on the same products at a tiny size."""

import pytest
import torch

from conftest import tiny_config
from perfbench import specs, work

decoder = specs.load_architecture("decoder")


def test_product_bound_by_hand():
    # 2·8·4096·4096 = 268.4 MFLOP → 0.271 µs; bytes 2·(8·4096 + 4096² + 8·4096) → 10.06 µs
    assert work.product_bound_s(8, 4096, 4096) == pytest.approx(
        2 * (8 * 4096 * 2 + 4096 * 4096) / 3.35e12)
    # a square 8192³ product is bound by its operations
    assert work.product_bound_s(8192, 8192, 8192) == pytest.approx(2 * 8192 ** 3 / 989e12)


def test_causal_attention_by_hand():
    w = work.Widths(1, 8, 2, 1, 4, 16, 10)
    # 3 positions: 6 visible pairs, 2 heads of width 4, Q·Kᵀ and P·V at 2 operations each
    assert work.causal_attention_flops(w, 3) == 6 * 2 * 4 * 2 * 2
    assert work.flash_bound_s(w, 3) == pytest.approx(
        max(192 / 989e12, (2 * 2 + 2 * 1) * 3 * 4 * 2 / 3.35e12))


def test_widths_of_the_two_configurations():
    dense = decoder.widths_of(tiny_config("qwen2-72b") | {"hidden_size": 8192,
                                                          "num_attention_heads": 64,
                                                          "num_key_value_heads": 8,
                                                          "intermediate_size": 29568,
                                                          "vocab_size": 152064})
    # Qwen2-72B: 877.7 M weights a layer (without the biases and norms)
    assert dense.layer_params_active() == 8192 * (64 + 16) * 128 + 8192 * 8192 + 3 * 8192 * 29568
    assert round(dense.layer_params_active() / 1e6, 1) == 877.7
    moe = decoder.widths_of(tiny_config("qwen3-moe-235b-a22b"))
    assert moe.moe and moe.head_dim == 16 and moe.d_ff == 32


def test_request_flops_by_hand():
    w = work.Widths(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16,
                    vocab=10)
    per_layer = 8 * (2 + 2) * 4 + 2 * 4 * 8 + 3 * 8 * 16
    prompt, gen = 5, 3
    expect = (2 * per_layer * 2 * (prompt + gen - 1)
              + 2 * (2 * 2 * 2 * 4 * 15 + 4 * 2 * 4 * (6 + 7))
              + 2 * 8 * 10 * gen)
    assert work.request_model_flops(w, prompt, gen) == expect


@pytest.mark.parametrize("name", ["qwen2-72b", "qwen3-moe-235b-a22b"])
def test_served_products_agree_with_the_ports_op_counter(name):
    """The products the engine's prefill and one decode step ask of the
    GEMM kernel, as the port's ``OpCounter`` counts them (the head over
    the port's padded vocabulary, which the frozen count leaves out)."""
    from perfbench import system, weights
    from repro_torch.models.api import Model
    from repro_torch.utils.op_costs import OpCounter

    cfg = tiny_config(name)
    arch = system.arch_config(cfg, decoder)
    params, _ = weights.make_params(decoder.layout(cfg, arch.padded_vocab), 3, "cpu")
    model = Model(arch, device="cpu")
    rows, bucket = 8, 16  # at least the 8 rows a bf16 product launches
    w = decoder.widths_of(cfg)
    toks = torch.randint(0, cfg["vocab_size"], (rows, bucket))
    with torch.no_grad(), OpCounter() as c:
        _, cache = model.prefill(params, {"tokens": toks}, bucket + 2)
        model.decode_step(params, cache, toks[:, :1])
    got = c.by_kind["gemm_kernel"]["flops"]
    prods = decoder.served_products(cfg, rows, bucket, 2)
    head_pad = 2 * rows * w.d_model * (arch.padded_vocab - w.vocab) * 2  # prefill + 1 step
    assert got == sum(2 * m * k * n for m, k, n in prods) + head_pad
    assert c.by_kind["gemm_kernel"]["count"] == len(prods)
