"""Dense GQA decoder (the ``dense`` family): parameters, forward, prefill
and greedy-decode steps, as plain functions on tensors with an explicit
device.

Parameters are nested dicts laid out as the JAX package's
``init_params`` tree: layers stacked on axis 0, weights ``(d_in,
d_out)``, so :func:`params_from_reference` carries that tree across
unchanged and both packages compute the same thing.  PyTorch runs
eagerly, so the layer ``scan`` of the JAX package is a Python loop over
the stacked layers.  The KV cache is updated in place (one buffer per
cache, where the JAX package returns a new one), which halves the
cache's memory at decode.  MoE, encoder-decoder, VLM and SSM families
are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import gemm
from repro_torch.models import common as cm

__all__ = [
    "init_params",
    "params_from_reference",
    "forward_logits",
    "embed_tokens",
    "lm_logits",
    "init_cache",
    "prefill",
    "decode_step",
]


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} archs are not ported yet")
    if cfg.pos_embed != "rope":
        raise NotImplementedError(f"pos_embed={cfg.pos_embed!r} is not ported yet")


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


# =============================================================================
# parameters
# =============================================================================


def _trunc_normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights from an explicit generator (which must live on
    ``device``), distributed as the JAX package's: truncated normals
    scaled by ``1/sqrt(d_in)`` (embedding ``d**-0.5``), unit norm
    scales, zero biases."""
    _check_dense(cfg)
    dt, L = _dt(cfg.param_dtype), cfg.n_layers
    d, hd, v, f = cfg.d_model, cfg.resolved_head_dim, cfg.padded_vocab, cfg.d_ff
    h, kv = cfg.n_heads, cfg.n_kv_heads

    def tn(shape, scale):
        return _trunc_normal(generator, shape, scale, dt, device)

    def dense_p(d_in, d_out, bias=False):
        p = {"w": tn((L, d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = torch.zeros((L, d_out), dtype=dt, device=device)
        return p

    def norm_p(stacked: bool):
        shape = (L, d) if stacked else (d,)
        p = {"scale": torch.ones(shape, dtype=dt, device=device)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(shape, dtype=dt, device=device)
        return p

    mlp = {"wi": dense_p(d, f), "wo": dense_p(f, d)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        mlp["wg"] = dense_p(d, f)
    p = {
        "embed": {"table": tn((v, d), d ** -0.5)},
        "ln_f": norm_p(False),
        "layers": {
            "ln1": norm_p(True),
            "attn": {
                "wq": dense_p(d, h * hd, cfg.qkv_bias),
                "wk": dense_p(d, kv * hd, cfg.qkv_bias),
                "wv": dense_p(d, kv * hd, cfg.qkv_bias),
                "wo": dense_p(h * hd, d),
            },
            "ln2": norm_p(True),
            "mlp": mlp,
        },
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": tn((d, v), 1.0 / math.sqrt(d))}
    return p


def params_from_reference(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's ``init_params`` tree, with its leaves given as
    numpy arrays, as the port's parameters in ``cfg.param_dtype`` on
    ``device``.  The layouts are the same, so this only converts leaves
    (through f32, which holds bfloat16 exactly)."""
    _check_dense(cfg)
    dt = _dt(cfg.param_dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device=device, dtype=dt)

    return conv(tree)


def _layer(layers: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


# =============================================================================
# blocks
# =============================================================================


def attn_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
               kv_cache: Optional[dict] = None, cache_len: int = 0,
               valid_len: Optional[torch.Tensor] = None,
               prefix_len: Optional[int] = None):
    """Causal self-attention.  Returns ``(out, (k, v))``.

    no cache: prefill — keys and values from x, attention through
              :func:`~repro_torch.models.common.attention_dispatch`;
    cache:    decode — write the new K/V into the layer's cache views at
              ``cache_len`` (in place) and attend the prefix."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = cm.dense(p["wq"], x).reshape(b, s, h, hd)
    k = cm.dense(p["wk"], x).reshape(b, s, kvh, hd)
    v = cm.dense(p["wv"], x).reshape(b, s, kvh, hd)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        kc[:, cache_len:cache_len + s] = k
        vc[:, cache_len:cache_len + s] = v
        out = cm.decode_attention(q, kc, vc, cache_len + s, softcap=cfg.attn_softcap,
                                  valid_len=valid_len, prefix_len=prefix_len)
    else:
        out = cm.attention_dispatch(q, k, v, softcap=cfg.attn_softcap,
                                    chunk_threshold=cfg.attn_chunk_threshold)
    return cm.dense(p["wo"], out.reshape(b, s, h * hd)), (k, v)


def mlp_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        hidden = cm.mlp_act(cfg.mlp_kind, cm.dense(p["wi"], x), cm.dense(p["wg"], x))
    else:
        hidden = cm.mlp_act(cfg.mlp_kind, cm.dense(p["wi"], x))
    return cm.dense(p["wo"], hidden)


def block_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, **kw):
    """One pre-norm block.  Returns ``(x, (k, v))``."""
    a, kv = attn_apply(cfg, p["attn"], cm.norm_apply(p["ln1"], x, cfg.norm, cfg.norm_eps),
                       positions, **kw)
    x = x + a
    x = x + mlp_apply(cfg, p["mlp"], cm.norm_apply(p["ln2"], x, cfg.norm, cfg.norm_eps))
    return x, kv


# =============================================================================
# full model
# =============================================================================


def embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens]


def lm_logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = cm.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["head"]["w"]
    logits = gemm(x, w, device=x.device.type).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def forward_logits(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, V).  (The JAX package also
    returns the MoE auxiliary loss, which the dense family does not have.)"""
    _check_dense(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x, _ = block_apply(cfg, _layer(params["layers"], i), x, positions)
    return lm_logits(cfg, params, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    dt = _dt(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": 0,
    }


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int,
            last_idx: Optional[torch.Tensor] = None):
    """Run the prompt; return ``(last_logits (B, 1, V), cache)``.

    ``last_idx`` (B,), optional: each sequence's last real token.  The
    serving engine right-pads prompts into fixed buckets, so the logits
    that seed decoding come from each sequence's own last real position,
    not the bucket's final column."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = block_apply(cfg, _layer(params["layers"], i), x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    if last_idx is None:
        x_last = x[:, -1:, :]
    else:
        x_last = x[torch.arange(b, device=x.device), last_idx.long()][:, None, :]
    cache["len"] = s
    return lm_logits(cfg, params, x_last), cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """One token for every sequence.  tokens: (B, 1).  Returns
    ``(logits (B, 1, V), cache)``: the cache's K/V are updated in place
    and its ``len`` advanced.

    Bucket-padded serving stashes each sequence's real prompt length
    (``valid_len``) and the bucket width (``prefill_len``) in the cache,
    so pad K/V rows are masked out of every step and each sequence's
    rope position continues from its own last real token."""
    _check_dense(cfg)
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    pos = cache["len"]
    valid_len, prefix_len = cache.get("valid_len"), cache.get("prefill_len")
    if valid_len is not None:
        positions = valid_len[:, None] + (pos - prefix_len)
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = block_apply(cfg, _layer(params["layers"], i), x, positions, kv_cache=kv,
                           cache_len=pos, valid_len=valid_len, prefix_len=prefix_len)
    cache["len"] = pos + 1
    return lm_logits(cfg, params, x), cache
