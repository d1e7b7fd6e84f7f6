"""Zamba2-style hybrid: a Mamba2 backbone with ONE shared attention+MLP
block applied every ``hybrid_attn_interval`` mamba layers (arXiv:2411.15242,
simplified as in the JAX package: the shared block reuses the same
parameters at every application), the twin of ``repro/models/hybrid.py``.

Layout for L mamba layers and interval I:
  [mamba x I, shared_attn] x (L // I)  then  [mamba x (L % I)]
Group parameters are stacked ``(L // I, I, ...)``, the tail ``(L % I, ...)``.
Serving state (each mamba layer's conv window and SSM state, each shared
application's K/V, and ``len``) lives on the device and advances in
place, so a decode step makes no host sync and can be captured.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tf

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


def init_hybrid_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    dt = getattr(torch, cfg.param_dtype)
    i, n_groups, tail = _split(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    p: dict = {
        "embed": {"table": tf.trunc_normal(generator, (v, d), d ** -0.5, dt, device)},
        "ln_f": tf.norm_params((d,), cfg.norm, dt, device),
        "head": {"w": tf.trunc_normal(generator, (d, v), 1.0 / math.sqrt(d), dt, device)},
        "shared_attn": tf.layer(tf.init_block(cfg, generator, device, 1, moe=False), 0),
    }
    if n_groups:
        p["groups"] = mb.init_mamba_block(cfg, generator, device, (n_groups, i))
    if tail:
        p["tail"] = mb.init_mamba_block(cfg, generator, device, (tail,))
    return p


def _shared(cfg, params, x, positions, **kw):
    x, kv, _ = tf.block_apply(cfg, params["shared_attn"], x, positions, moe=False, **kw)
    return x, kv


def hybrid_hidden(cfg: ArchConfig, params: dict, batch: dict):
    """Returns ``(final hidden, aux = 0)``.  Each group (its mamba layers
    and the shared block) runs under the config's remat; the tail does
    not, as in the JAX package."""
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
    i, n_groups, tail = _split(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.compute_dtype)
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


def hybrid_prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int, cache=None):
    """Run the (exact-length) prompt, writing each mamba layer's recurrent
    state and each shared application's K/V into ``cache`` (a new one
    when none is given).  Returns ``(last_logits, cache)``."""
    i, n_groups, tail = _split(cfg)
    x = tf.embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    if cache is None:
        cache = hybrid_init_cache(cfg, b, max_len, device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]

    def prefill_mamba(p, state, x):
        x, st = mb.mamba_block_prefill(cfg, p, x)
        state["conv"][:b] = st["conv"]
        state["ssm"][:b] = st["ssm"]
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
    return tf.lm_logits(cfg, params, x[:, -1:, :]), cache


def hybrid_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """One token for every sequence; states, K/V and ``len`` advance in
    place on the device."""
    i, n_groups, tail = _split(cfg)
    x = tf.embed_tokens(cfg, params, tokens)
    pos = cache["len"]
    positions = tf.decode_positions(cache, tokens.shape[0], x.device)
    for gi in range(n_groups):
        for j in range(i):
            x = mb.mamba_block_decode(cfg, tf.layer(params["groups"], (gi, j)),
                                      tf.layer(cache["mamba"], (gi, j)), x)
        kv = {"k": cache["attn_k"][gi], "v": cache["attn_v"][gi]}
        x, _ = _shared(cfg, params, x, positions, kv_cache=kv, cache_len=pos)
    for j in range(tail):
        x = mb.mamba_block_decode(cfg, tf.layer(params["tail"], j),
                                  tf.layer(cache["tail"], j), x)
    cache["len"].add_(1)
    return tf.lm_logits(cfg, params, x), cache
