"""Nemotron-H (arXiv:2504.03624): a hybrid stack of one mixer a layer, laid
out by ``hybrid_override_pattern``: Mamba-2 (``M``; heads of
``mamba_head_dim``, B and C in ``n_groups`` groups, a gated norm per
group), a squared-ReLU MLP with no gate (``-``) and GQA attention with no
position embedding (``*``).  Its plain reference is
``references/nemotron_h.py``.

What the harness knows of it, as ``architectures/decoder.py`` gives it
for the decoder (see that module's docstring): the port's ``ArchConfig``
fields (:func:`arch_fields`), the engine's weight tree leaf for leaf
(:func:`layout`), the work of a served batch (:func:`served_products`,
:func:`attention_bound_s`, :func:`request_model_flops`, and
:func:`ssd_bound_s` for the SSD's own roofline) through
:mod:`perfbench.work`, and the faults of its cache (:func:`faults`).
"""

from __future__ import annotations

import math

from perfbench import system, work

__all__ = ["arch_fields", "layout", "served_products", "attention_bound_s",
           "request_model_flops", "ssd_flops", "ssd_bytes", "ssd_bound_s", "faults"]

#: keys of a configuration's file that say nothing the engine runs: the
#: benchmark's own, and the published model's metadata, init and kernels
_META = {"name", "source", "paper", "architectures", "architecture", "reference",
         "published", "reduced", "assumed", "deployment", "departures", "torch_dtype",
         "model_type", "max_position_embeddings", "num_logits_to_keep",
         "rescale_prenorm_residual", "use_mamba_kernels", "time_step_min", "time_step_max",
         "time_step_floor", "time_step_rank"}
#: keys whose published value the port's layers hold, and only that value
_FIXED = {"attention_bias": False, "mlp_bias": False, "use_bias": False,
          "mamba_proj_bias": False, "use_conv_bias": True, "mamba_hidden_act": "silu",
          "mlp_hidden_act": "relu2", "residual_in_fp32": False, "tie_word_embeddings": False,
          "sliding_window": None, "time_step_limit": [0, None]}
#: keys mapped onto the port's fields
_MAPPED = {"hidden_size", "num_hidden_layers", "hybrid_override_pattern", "vocab_size",
           "num_attention_heads", "num_key_value_heads", "attention_head_dim",
           "intermediate_size", "rms_norm_eps", "layer_norm_epsilon", "mamba_num_heads",
           "mamba_head_dim", "n_groups", "ssm_state_size", "conv_kernel", "chunk_size",
           "expand"}

#: the Mamba-2 leaves drawn in float32 as ``offset + scale·N(0, 1)``: A = exp(A_log)
#: in [1, 16] and softplus(dt_bias) in [1e-3, 1e-1] (the published init's
#: uniform ranges) at 5 standard deviations
_SD = 5.0
_A_LOG = (math.log(16.0) / 2, math.log(16.0) / 2 / _SD)
_DT_LO, _DT_HI = (math.log(math.expm1(v)) for v in (1e-3, 1e-1))
_DT_BIAS = ((_DT_LO + _DT_HI) / 2, (_DT_HI - _DT_LO) / 2 / _SD)


def _counts(config: dict) -> dict:
    pattern = config["hybrid_override_pattern"]
    return {k: pattern.count(k) for k in "M-*"}


def _widths(config: dict) -> work.Widths:
    """The attention's widths, for :func:`perfbench.work.flash_bound_s`."""
    return work.Widths(
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"], n_kv_heads=config["num_key_value_heads"],
        head_dim=config["attention_head_dim"], d_ff=config["intermediate_size"],
        vocab=config["vocab_size"])


def _mamba_widths(config: dict) -> tuple[int, int, int, int, int, int]:
    """``(heads, head dim, inner width, groups, state, conv channels)``."""
    h, p = config["mamba_num_heads"], config["mamba_head_dim"]
    g, n = config["n_groups"], config["ssm_state_size"]
    return h, p, h * p, g, n, h * p + 2 * g * n


def arch_fields(config: dict) -> dict:
    """The port's ``ArchConfig`` fields for a configuration file.  A key
    this mapping does not know, a fixed key at another value, or widths
    that disagree are refused."""
    name = config.get("name")
    unknown = set(config) - _META - set(_FIXED) - _MAPPED
    if unknown:
        raise ValueError(f"{name}: keys {sorted(unknown)} are not mapped onto the port")
    for key, value in _FIXED.items():
        if config.get(key, value) != value:
            raise ValueError(f"{name}: {key} {config[key]!r}: the port runs only {value!r}")
    h, p, di, g, n, _ = _mamba_widths(config)
    d, pattern = config["hidden_size"], config["hybrid_override_pattern"]
    if di != config["expand"] * d or h % g:
        raise ValueError(f"{name}: mamba_num_heads x mamba_head_dim = {di} is not expand x "
                         f"hidden_size, or {g} groups do not divide {h} heads")
    if len(pattern) != config["num_hidden_layers"] or set(pattern) - set("M-*"):
        raise ValueError(f"{name}: hybrid_override_pattern {pattern!r} is not one of M, -, * "
                         f"for each of {config['num_hidden_layers']} layers")
    if config.get("layer_norm_epsilon", config["rms_norm_eps"]) != config["rms_norm_eps"]:
        raise ValueError(f"{name}: layer_norm_epsilon and rms_norm_eps differ")
    dt = config["torch_dtype"]
    return dict(
        name=name, family="hybrid", n_layers=config["num_hidden_layers"], d_model=d,
        n_heads=config["num_attention_heads"], n_kv_heads=config["num_key_value_heads"],
        head_dim=config["attention_head_dim"], d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"], norm="rmsnorm", norm_eps=config["rms_norm_eps"],
        mlp_kind="squared_relu", qkv_bias=False, pos_embed="none", tie_embeddings=False,
        ssm_state=n, ssm_head_dim=p, ssm_expand=config["expand"],
        ssm_conv_width=config["conv_kernel"], ssm_chunk=config["chunk_size"], ssm_n_groups=g,
        layer_pattern=pattern, param_dtype=dt, compute_dtype=dt)


def layout(config: dict, padded_vocab: int) -> list:
    """Every leaf of the engine's tree (each kind's layers stacked on axis 0
    in pattern order; weights ``(d_in, d_out)``; the conv ``(width,
    channels)``) as ``(path, shape, dtype, scale, offset)``: projections
    ``N(0, 1)/sqrt(d_in)``, the embedding ``N(0, 1)/sqrt(d)``, norm scales
    and ``D`` ``1 + 0.1·N(0, 1)``, the conv ``0.5·N(0, 1)/sqrt(width)`` and
    its bias ``0.1·N(0, 1)``; ``A_log``, ``dt_bias`` and ``D`` in float32
    as the engine keeps them, the rest in the served type."""
    d, f, dt = config["hidden_size"], config["intermediate_size"], config["torch_dtype"]
    h, _, di, g, n, ch = _mamba_widths(config)
    nh, kv, hd = (config[k] for k in ("num_attention_heads", "num_key_value_heads",
                                      "attention_head_dim"))
    width = config["conv_kernel"]
    c = _counts(config)
    leaves = [
        (("embed", "table"), (padded_vocab, d), dt, d ** -0.5, 0.0),
        (("ln_f", "scale"), (d,), dt, 0.1, 1.0),
        (("head", "w"), (d, padded_vocab), dt, d ** -0.5, 0.0),
    ]
    if c["M"]:
        m = c["M"]
        leaves += [
            (("mamba", "ln", "scale"), (m, d), dt, 0.1, 1.0),
            (("mamba", "in_proj", "w"), (m, d, 2 * di + 2 * g * n + h), dt, d ** -0.5, 0.0),
            (("mamba", "conv_w"), (m, width, ch), dt, 0.5 * width ** -0.5, 0.0),
            (("mamba", "conv_b"), (m, ch), dt, 0.1, 0.0),
            (("mamba", "A_log"), (m, h), "float32", _A_LOG[1], _A_LOG[0]),
            (("mamba", "D"), (m, h), "float32", 0.1, 1.0),
            (("mamba", "dt_bias"), (m, h), "float32", _DT_BIAS[1], _DT_BIAS[0]),
            (("mamba", "norm", "scale"), (m, di), dt, 0.1, 1.0),
            (("mamba", "out_proj", "w"), (m, di, d), dt, di ** -0.5, 0.0),
        ]
    if c["-"]:
        leaves += [
            (("mlp", "ln", "scale"), (c["-"], d), dt, 0.1, 1.0),
            (("mlp", "wi", "w"), (c["-"], d, f), dt, d ** -0.5, 0.0),
            (("mlp", "wo", "w"), (c["-"], f, d), dt, f ** -0.5, 0.0),
        ]
    if c["*"]:
        a = c["*"]
        leaves.append((("attn", "ln", "scale"), (a, d), dt, 0.1, 1.0))
        for name, d_in, d_out in (("wq", d, nh * hd), ("wk", d, kv * hd), ("wv", d, kv * hd),
                                  ("wo", nh * hd, d)):
            leaves.append((("attn", name, "w"), (a, d_in, d_out), dt, d_in ** -0.5, 0.0))
    return leaves


def _layer_products(config: dict, kind: str, m: int) -> list[tuple[int, int, int]]:
    d, f = config["hidden_size"], config["intermediate_size"]
    h, _, di, g, n, _ = _mamba_widths(config)
    if kind == "M":
        return [(m, d, 2 * di + 2 * g * n + h), (m, di, d)]
    if kind == "-":
        return [(m, d, f), (m, f, d)]
    nh, kv, hd = (config[k] for k in ("num_attention_heads", "num_key_value_heads",
                                      "attention_head_dim"))
    return [(m, d, nh * hd), (m, d, kv * hd), (m, d, kv * hd), (m, nh * hd, d)]


def served_products(config: dict, rows: int, bucket: int, gen: int) -> list:
    """Every product the engine asks of the GEMM kernel for one batch, as
    ``(M, K, N)``, once a launch: each layer's (a Mamba layer's in and out
    projections, an MLP's up and down, an attention's q, k, v and o) over
    all ``rows × bucket`` positions in prefill, then ``gen - 1`` decode
    steps of ``rows`` rows; the head at one position a row, over the
    published vocabulary."""
    pattern, head = config["hybrid_override_pattern"], (rows, config["hidden_size"],
                                                       config["vocab_size"])

    def stack(m: int) -> list:
        return [prod for kind in pattern for prod in _layer_products(config, kind, m)]

    return stack(rows * bucket) + [head] + (stack(rows) + [head]) * (gen - 1)


def attention_bound_s(config: dict, length: int) -> float:
    """The least time of one sequence's causal attention over ``length``
    real positions, over the attention layers (``*``) only."""
    return work.flash_bound_s(_widths(config), length) * _counts(config)["*"]


def _chunk_pairs(length: int, chunk: int) -> int:
    """Causal (query, key) pairs inside the chunks of a sequence of
    ``length``: a diagonal block at half."""
    full, last = divmod(length, chunk)
    return full * chunk * (chunk + 1) // 2 + last * (last + 1) // 2


def ssd_flops(config: dict, length: int) -> int:
    """Operations of the SSD (Mamba-2's Listing 1, arXiv:2405.21060) over
    one sequence of ``length`` positions, in one Mamba layer, a multiply-add
    two: ``C·Bᵀ`` by group and the decayed scores times ``x`` by head over
    the causal pairs inside each chunk, each position's ``B ⊗ x`` into its
    chunk's state and its ``C`` against the state entering its chunk, and
    the states carried from chunk to chunk."""
    h, p, _, g, n, _ = _mamba_widths(config)
    pairs = _chunk_pairs(length, config["chunk_size"])
    chunks = -(-length // config["chunk_size"])
    return 2 * pairs * (g * n + h * p) + 2 * 2 * length * h * p * n + 2 * chunks * h * p * n


def ssd_bytes(config: dict, length: int) -> int:
    """Bytes the SSD must move for one sequence in one Mamba layer: x, dt,
    B and C read and y written in bf16, the final state written in f32."""
    h, p, _, g, n, _ = _mamba_widths(config)
    return work.BF16 * length * (2 * h * p + h + 2 * g * n) + 4 * h * p * n


def ssd_bound_s(config: dict, length: int) -> float:
    """The least time of one sequence's SSD over ``length`` real positions,
    over every Mamba layer: its operations at the bf16 peak against its
    bytes at the memory's peak, whatever implements it."""
    one = max(ssd_flops(config, length) / work.PEAK_FLOPS_BF16,
              ssd_bytes(config, length) / work.PEAK_BYTES_PER_S)
    return one * _counts(config)["M"]


def request_model_flops(config: dict, prompt_len: int, gen: int) -> int:
    """Model operations of one request: ``prompt_len`` prompt tokens and
    ``gen - 1`` decoded ones through every layer's products and the Mamba
    layers' conv (two operations a weight), causal attention over each
    token's real context in the attention layers, the SSD over the prompt
    (:func:`ssd_flops`) and one recurrent step a decoded token (the state's
    decay and ``B ⊗ x``, and ``C`` against it), and the head at the last
    prompt position and at each decoded token."""
    c = _counts(config)
    h, p, _, _, n, ch = _mamba_widths(config)
    weights = sum(k * kk for kind in "M-*"
                  for _, k, kk in _layer_products(config, kind, 1) * c[kind])
    per_token = 2 * (weights + c["M"] * config["conv_kernel"] * ch)
    fed = prompt_len + gen - 1
    w = _widths(config)
    attn = work.causal_attention_flops(w, prompt_len)
    attn += sum(4 * w.n_heads * w.head_dim * (prompt_len + j) for j in range(1, gen))
    ssd = ssd_flops(config, prompt_len) + (gen - 1) * 3 * 2 * h * p * n
    head = 2 * config["hidden_size"] * config["vocab_size"] * gen
    return per_token * fed + attn * c["*"] + ssd * c["M"] + head


def _cache_tensors(cache: dict) -> dict:
    """Every state tensor of the cache, by dotted name: all but the
    lengths the engine sets at prefill."""
    out = {}
    for key, value in cache.items():
        if key in ("valid_len", "prefill_len") or value is None:
            continue
        if isinstance(value, dict):
            out.update({f"{key}.{k}": v for k, v in _cache_tensors(value).items()})
        else:
            out[key] = value
    return out


def _stale(decode_step):
    """A decode step whose conv, SSM and K/V writes and length advance are
    lost."""

    def stale(cfg, params, cache, tokens):
        kept = {k: (t, t.clone()) for k, t in _cache_tensors(cache).items()}
        logits, cache = decode_step(cfg, params, cache, tokens)
        for t, before in kept.values():
            t.copy_(before)
        return logits, cache

    return stale


def _pads_taken(prefill):
    """A Mamba prefill whose recurrent state runs to the bucket's end,
    taking in the pads (its rows' real lengths dropped)."""

    def padded(cfg, p, x, valid_len=None, index=None):
        return prefill(cfg, p, x, None, index)

    return padded


def faults() -> dict:
    """The faults of the hybrid's cache, by name: each a context manager
    that plants it in the port."""
    return {
        "stale_state": lambda: system.patched("models.hybrid", "hybrid_decode_step", _stale),
        "pad_state": lambda: system.patched("models.mamba2", "mamba_block_prefill",
                                            _pads_taken),
    }
