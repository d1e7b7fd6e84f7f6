"""Hybrid Mamba-2 / attention stacks, in two layouts.

**Zamba2** (``hybrid_attn_interval``): a Mamba2 backbone with ONE shared
attention+MLP block applied every ``hybrid_attn_interval`` mamba layers
(arXiv:2411.15242, simplified as in the JAX package: the shared block
reuses the same parameters at every application), the twin of
``repro/models/hybrid.py``.  Layout for L mamba layers and interval I:
  [mamba x I, shared_attn] x (L // I)  then  [mamba x (L % I)]
Group parameters are stacked ``(L // I, I, ...)``, the tail ``(L % I, ...)``.

**By layer pattern** (``layer_pattern``, Nemotron-H, arXiv:2504.03624):
one mixer a layer, ``x = x + mixer(rmsnorm(x))``, the mixer a Mamba-2
block (``M``), a dense MLP (``-``) or an attention (``*``, with no
position embedding where ``pos_embed`` is ``none``).  The layers of each
kind are stacked on axis 0 in pattern order: ``params["mamba"]`` (the
Mamba-2 block, its pre-norm ``ln`` inside), ``params["mlp"]`` and
``params["attn"]`` (each ``ln`` beside the sub-layer's weights); the
cache holds a conv window and an SSM state for each ``M`` layer and K/V
for each ``*`` layer only.  The MLP and attention sub-layers are
``models/transformer.py``'s, with its spans (``block.norm``,
``block.attn``, ``block.mlp``); a Mamba layer's are ``block.norm`` and
``block.mamba`` (``models/mamba2.py``), each with the layer's index.

Serving state (conv windows, SSM states, K/V and ``len``) lives on the
device and advances in place, so a decode step makes no host sync and can
be captured.  A right-padded prefill stops each row's recurrent state at
its real length (``last_idx``), and decode masks the pad K/V of every
attention (the cache's ``valid_len`` / ``prefill_len``), in both layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import LAYER_KINDS, ArchConfig
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tf
from repro_torch.utils.spans import span

__all__ = [
    "init_hybrid_params",
    "hybrid_forward",
    "hybrid_hidden",
    "hybrid_prefill",
    "hybrid_init_cache",
    "hybrid_decode_step",
]


def _split(cfg: ArchConfig):
    i = cfg.hybrid_attn_interval
    n_groups = cfg.n_layers // i if i else 0
    tail = cfg.n_layers - n_groups * i if i else cfg.n_layers
    return i, n_groups, tail


def _walk(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Each layer of ``layer_pattern`` as ``(kind, index among its kind)``."""
    seen = dict.fromkeys(LAYER_KINDS, 0)
    out = []
    for kind in cfg.layer_pattern:
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def init_hybrid_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    dt = getattr(torch, cfg.param_dtype)
    v, d = cfg.padded_vocab, cfg.d_model
    p: dict = {
        "embed": {"table": tf.trunc_normal(generator, (v, d), d ** -0.5, dt, device)},
        "ln_f": tf.norm_params((d,), cfg.norm, dt, device),
        "head": {"w": tf.trunc_normal(generator, (d, v), 1.0 / math.sqrt(d), dt, device)},
    }
    if cfg.layer_pattern:
        n = cfg.layer_counts()
        if n["M"]:
            p["mamba"] = mb.init_mamba_block(cfg, generator, device, (n["M"],))
        if n["-"]:
            p["mlp"] = {"ln": tf.norm_params((n["-"], d), cfg.norm, dt, device),
                        **tf.mlp_params(cfg, generator, device, (n["-"],))}
        if n["*"]:
            p["attn"] = {"ln": tf.norm_params((n["*"], d), cfg.norm, dt, device),
                         **tf.attn_params(cfg, generator, device, (n["*"],))}
        return p
    i, n_groups, tail = _split(cfg)
    p["shared_attn"] = tf.layer(tf.init_block(cfg, generator, device, 1, moe=False), 0)
    if n_groups:
        p["groups"] = mb.init_mamba_block(cfg, generator, device, (n_groups, i))
    if tail:
        p["tail"] = mb.init_mamba_block(cfg, generator, device, (tail,))
    return p


def _shared(cfg, params, x, positions, **kw):
    x, kv, _ = tf.block_apply(cfg, params["shared_attn"], x, positions, moe=False, **kw)
    return x, kv


def _pattern_hidden(cfg: ArchConfig, params: dict, batch: dict):
    """The pattern stack's final hidden states, each layer under the
    config's remat."""
    x = tf.embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    bodies = {
        "M": tf._remat(cfg, lambda p, x, i: mb.mamba_block_prefill(cfg, p, x, index=i)[0]),
        "-": tf._remat(cfg, lambda p, x, i: tf.mlp_sublayer(cfg, p["ln"], p, x, i)),
        "*": tf._remat(cfg, lambda p, x, i: tf.attn_sublayer(cfg, p["ln"], p, x, positions,
                                                             index=i)[0]),
    }
    n = cfg.layer_counts()
    stacks = {k: tf.unbind_layers(params[name], n[k])
              for k, name in (("M", "mamba"), ("-", "mlp"), ("*", "attn")) if n[k]}
    for i, (kind, j) in enumerate(_walk(cfg)):
        x = bodies[kind](stacks[kind][j], x, i)
    return x


def hybrid_hidden(cfg: ArchConfig, params: dict, batch: dict):
    """Returns ``(final hidden, aux = 0)``.  Zamba2: each group (its mamba
    layers and the shared block) runs under the config's remat; the tail
    does not, as in the JAX package.  A pattern stack: each layer."""
    if cfg.layer_pattern:
        x = _pattern_hidden(cfg, params, batch)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    i, n_groups, tail = _split(cfg)
    x = tf.embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def group_body(group, x):
        for p in tf.unbind_layers(group, i):
            x = mb.mamba_block_apply(cfg, p, x)
        return _shared(cfg, params, x, positions)[0]

    if n_groups:
        group_body = tf._remat(cfg, group_body)
        for group in tf.unbind_layers(params["groups"], n_groups):
            x = group_body(group, x)
    if tail:
        for p in tf.unbind_layers(params["tail"], tail):
            x = mb.mamba_block_apply(cfg, p, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_forward(cfg: ArchConfig, params: dict, batch: dict):
    """Returns ``(logits, aux = 0)``."""
    x, aux = hybrid_hidden(cfg, params, batch)
    return tf.lm_logits(cfg, params, x), aux


def hybrid_init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.layer_pattern:
        n = cfg.layer_counts()
        shape = (n["*"], batch, max_len, kvh, hd)
        return {"mamba": mb.init_mamba_state(cfg, batch, (n["M"],), device),
                "attn_k": torch.zeros(shape, dtype=dt, device=device),
                "attn_v": torch.zeros(shape, dtype=dt, device=device),
                "len": torch.zeros((), dtype=torch.long, device=device)}
    i, n_groups, tail = _split(cfg)
    shape = (max(n_groups, 1), batch, max_len, kvh, hd)
    cache = {
        "mamba": mb.init_mamba_state(cfg, batch, (n_groups, i), device) if n_groups else None,
        "attn_k": torch.zeros(shape, dtype=dt, device=device),
        "attn_v": torch.zeros(shape, dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.long, device=device),
    }
    if tail:
        cache["tail"] = mb.init_mamba_state(cfg, batch, (tail,), device)
    return cache


def _write_state(state: dict, st: dict, b: int) -> None:
    state["conv"][:b] = st["conv"]
    state["ssm"][:b] = st["ssm"]


def hybrid_prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int, cache=None,
                   last_idx: Optional[torch.Tensor] = None):
    """Run the prompt, writing each mamba layer's recurrent state and each
    attention's K/V into ``cache`` (a new one when none is given).
    ``last_idx`` (B,): each row's last real position of a right-padded
    batch, where its recurrent state stops and its seed logits are read.
    Returns ``(last_logits, cache)``."""
    with span("model.embed"):
        x = tf.embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    if cache is None:
        cache = hybrid_init_cache(cfg, b, max_len, device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    valid_len = None if last_idx is None else last_idx.long() + 1

    if cfg.layer_pattern:
        for i, (kind, j) in enumerate(_walk(cfg)):
            if kind == "M":
                x, st = mb.mamba_block_prefill(cfg, tf.layer(params["mamba"], j), x,
                                               valid_len, i)
                _write_state(tf.layer(cache["mamba"], j), st, b)
            elif kind == "-":
                p = tf.layer(params["mlp"], j)
                x = tf.mlp_sublayer(cfg, p["ln"], p, x, i)
            else:
                p = tf.layer(params["attn"], j)
                x, kv = tf.attn_sublayer(cfg, p["ln"], p, x, positions, index=i)
                cache["attn_k"][j, :b, :s] = kv["k"]
                cache["attn_v"][j, :b, :s] = kv["v"]
        cache["len"].fill_(s)
        return tf.last_logits(cfg, params, x, last_idx), cache

    i, n_groups, tail = _split(cfg)

    def prefill_mamba(p, state, x):
        x, st = mb.mamba_block_prefill(cfg, p, x, valid_len)
        _write_state(state, st, b)
        return x

    for gi in range(n_groups):
        for j in range(i):
            x = prefill_mamba(tf.layer(params["groups"], (gi, j)),
                              tf.layer(cache["mamba"], (gi, j)), x)
        x, kv = _shared(cfg, params, x, positions)
        cache["attn_k"][gi, :b, :s] = kv["k"]
        cache["attn_v"][gi, :b, :s] = kv["v"]
    for j in range(tail):
        x = prefill_mamba(tf.layer(params["tail"], j), tf.layer(cache["tail"], j), x)
    cache["len"].fill_(s)
    return tf.last_logits(cfg, params, x, last_idx), cache


def hybrid_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """One token for every sequence; states, K/V and ``len`` advance in
    place on the device.  Pad K/V rows of a bucket-padded prefill are
    masked out of every attention (``valid_len`` / ``prefill_len``), as
    ``transformer.decode_step`` masks them."""
    x = tf.embed_tokens(cfg, params, tokens)
    pos = cache["len"]
    positions = tf.decode_positions(cache, tokens.shape[0], x.device)
    masks = {"valid_len": cache.get("valid_len"), "prefix_len": cache.get("prefill_len")}
    if cfg.layer_pattern:
        for i, (kind, j) in enumerate(_walk(cfg)):
            if kind == "M":
                x = mb.mamba_block_decode(cfg, tf.layer(params["mamba"], j),
                                          tf.layer(cache["mamba"], j), x, i)
            elif kind == "-":
                p = tf.layer(params["mlp"], j)
                x = tf.mlp_sublayer(cfg, p["ln"], p, x, i)
            else:
                p = tf.layer(params["attn"], j)
                kv = {"k": cache["attn_k"][j], "v": cache["attn_v"][j]}
                x, _ = tf.attn_sublayer(cfg, p["ln"], p, x, positions, index=i, kv_cache=kv,
                                        cache_len=pos, **masks)
        cache["len"].add_(1)
        return tf.lm_logits(cfg, params, x), cache
    i, n_groups, tail = _split(cfg)
    for gi in range(n_groups):
        for j in range(i):
            x = mb.mamba_block_decode(cfg, tf.layer(params["groups"], (gi, j)),
                                      tf.layer(cache["mamba"], (gi, j)), x)
        kv = {"k": cache["attn_k"][gi], "v": cache["attn_v"][gi]}
        x, _ = _shared(cfg, params, x, positions, kv_cache=kv, cache_len=pos, **masks)
    for j in range(tail):
        x = mb.mamba_block_decode(cfg, tf.layer(params["tail"], j),
                                  tf.layer(cache["tail"], j), x)
    cache["len"].add_(1)
    return tf.lm_logits(cfg, params, x), cache
