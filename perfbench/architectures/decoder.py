"""The decoder: a pre-norm transformer of GQA attention with rope and a
SwiGLU FFN, dense (Qwen2) or with routed experts in place of the FFN
(Qwen3 MoE).  Its plain reference is ``references/decoder.py``.

An architecture module is what the harness knows of one kind of model,
found by the name a configuration's file gives under ``architecture``
(:func:`perfbench.specs.architecture_of`).  It imports nothing of the port
(``perfbench/system.py`` is the only door into it) and gives:

* :func:`arch_fields`: the port's ``ArchConfig`` fields for a
  configuration's file;
* :func:`layout`: every weight leaf as ``(path, shape, dtype, scale,
  offset)``, drawn as ``offset + scale·N(0, 1)`` in ``dtype``
  (:mod:`perfbench.weights`);
* :func:`served_products`, :func:`attention_bound_s` and
  :func:`request_model_flops`: the work of a served batch, for the
  readers of ``gemm_roofline``, ``flash_roofline`` and ``mfu``, through
  the frozen arithmetic of :mod:`perfbench.work`;
* :func:`faults`: the planted faults that depend on the model's cache, by
  name, beside the general ones of :mod:`perfbench.faults`.
"""

from __future__ import annotations

from perfbench import system, work

__all__ = ["widths_of", "arch_fields", "layout", "served_products", "attention_bound_s",
           "request_model_flops", "faults"]


def widths_of(config: dict) -> work.Widths:
    """The widths of a configuration file (the published model's
    ``config.json`` keys)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    moe = config.get("num_experts", 0) > 0
    return work.Widths(
        n_layers=config["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=config["num_key_value_heads"], head_dim=config.get("head_dim") or d // h,
        d_ff=config["moe_intermediate_size"] if moe else config["intermediate_size"],
        vocab=config["vocab_size"], n_experts=config.get("num_experts", 0),
        experts_per_token=config.get("num_experts_per_tok", 0))


def arch_fields(config: dict) -> dict:
    """The port's ``ArchConfig`` fields for a configuration file: the
    published keys mapped onto the port's fields, plus ``serving`` (what
    the engine adds: MoE capacity).  Only a SwiGLU (``hidden_act: silu``)
    FFN is mapped: a file that states another activation, none, or one
    under ``mlp_hidden_act`` is refused."""
    if "mlp_hidden_act" in config:
        raise ValueError(f"{config['name']}: mlp_hidden_act {config['mlp_hidden_act']!r}: "
                         "the decoder maps only hidden_act")
    if config.get("hidden_act") != "silu":
        raise ValueError(f"{config['name']}: hidden_act {config.get('hidden_act')!r}: "
                         "the decoder maps only SwiGLU (silu)")
    d, h = config["hidden_size"], config["num_attention_heads"]
    moe = config.get("num_experts", 0) > 0
    fields = dict(
        name=config["name"], family="moe" if moe else "dense",
        n_layers=config["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=config["num_key_value_heads"], head_dim=config.get("head_dim") or d // h,
        d_ff=config["moe_intermediate_size"] if moe else config["intermediate_size"],
        vocab_size=config["vocab_size"], norm="rmsnorm", norm_eps=config["rms_norm_eps"],
        mlp_kind="swiglu", qkv_bias=bool(config.get("attention_bias")),
        rope_theta=float(config["rope_theta"]),
        tie_embeddings=bool(config.get("tie_word_embeddings")),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
    )
    if moe:
        fields.update(n_experts=config["num_experts"],
                      experts_per_token=config["num_experts_per_tok"],
                      router_norm_topk=bool(config.get("norm_topk_prob")),
                      moe_capacity_factor=float(config["serving"]["capacity_factor"]))
    return fields


def layout(config: dict, padded_vocab: int) -> list:
    """Every leaf of the tree the serving engine takes (layers stacked on
    axis 0, weights ``(d_in, d_out)``, experts ``(E, d_in, d_out)``), as
    ``(path, shape, dtype, scale, offset)``: weights ``N(0, 1)/sqrt(d_in)``,
    the embedding ``N(0, 1)/sqrt(d)``, biases ``0.1·N(0, 1)``, norm scales
    ``1 + 0.1·N(0, 1)`` (so that a scale left out shows), all in the served
    type but the router, which the engine keeps in float32."""
    w = widths_of(config)
    n, d, hd, f = w.n_layers, w.d_model, w.head_dim, w.d_ff
    h, kv = w.n_heads, w.n_kv_heads
    dt = config["torch_dtype"]
    leaves = [
        (("embed", "table"), (padded_vocab, d), dt, d ** -0.5, 0.0),
        (("ln_f", "scale"), (d,), dt, 0.1, 1.0),
        (("head", "w"), (d, padded_vocab), dt, d ** -0.5, 0.0),
        (("layers", "ln1", "scale"), (n, d), dt, 0.1, 1.0),
        (("layers", "ln2", "scale"), (n, d), dt, 0.1, 1.0),
    ]
    for name, d_in, d_out in (("wq", d, h * hd), ("wk", d, kv * hd), ("wv", d, kv * hd),
                              ("wo", h * hd, d)):
        leaves.append((("layers", "attn", name, "w"), (n, d_in, d_out), dt, d_in ** -0.5, 0.0))
        if name != "wo" and config.get("attention_bias"):
            leaves.append((("layers", "attn", name, "b"), (n, d_out), dt, 0.1, 0.0))
    if w.moe:
        e = w.n_experts
        leaves += [
            (("layers", "mlp", "router", "w"), (n, d, e), "float32", d ** -0.5, 0.0),
            (("layers", "mlp", "wi"), (n, e, d, f), dt, d ** -0.5, 0.0),
            (("layers", "mlp", "wg"), (n, e, d, f), dt, d ** -0.5, 0.0),
            (("layers", "mlp", "wo"), (n, e, f, d), dt, f ** -0.5, 0.0),
        ]
    else:
        leaves += [
            (("layers", "mlp", "wi", "w"), (n, d, f), dt, d ** -0.5, 0.0),
            (("layers", "mlp", "wg", "w"), (n, d, f), dt, d ** -0.5, 0.0),
            (("layers", "mlp", "wo", "w"), (n, f, d), dt, f ** -0.5, 0.0),
        ]
    return leaves


def served_products(config: dict, rows: int, bucket: int, gen: int) -> list:
    """Every dense product the engine asks of the GEMM kernel for one
    batch (:func:`perfbench.work.served_products`)."""
    return work.served_products(widths_of(config), rows, bucket, gen)


def attention_bound_s(config: dict, length: int) -> float:
    """The least time of one sequence's causal attention over ``length``
    real positions, over every layer (each attends)."""
    w = widths_of(config)
    return work.flash_bound_s(w, length) * w.n_layers


def request_model_flops(config: dict, prompt_len: int, gen: int) -> int:
    """Model operations of one request (:func:`perfbench.work.request_model_flops`)."""
    return work.request_model_flops(widths_of(config), prompt_len, gen)


def _stale(decode_step):
    """A decode step whose cache write and length advance are lost."""

    def stale(cfg, params, cache, tokens):
        kept = {k: cache[k].clone() for k in ("k", "v", "len")}
        logits, cache = decode_step(cfg, params, cache, tokens)
        for k, v in kept.items():
            cache[k].copy_(v)
        return logits, cache

    return stale


def faults() -> dict:
    """The faults of the decoder's KV cache, by name: each a context
    manager that plants it in the port."""
    return {"stale_state": lambda: system.patched("models.transformer", "decode_step", _stale)}
