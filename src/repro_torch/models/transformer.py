"""Transformer model zoo: dense GQA decoders, MoE decoders, VLM backbones
(stub frontend: ``frontend_embeds`` arrive as precomputed embeddings) and
encoder-decoders (whisper family; ``enc_frames`` arrive as precomputed
frame embeddings), as plain functions on tensors with an explicit device.

Parameters are nested dicts laid out as the JAX package's
``init_params`` tree: layers stacked on axis 0, weights ``(d_in,
d_out)``, experts ``(E, d_in, d_out)``, so :func:`params_from_reference`
carries that tree across unchanged and both packages compute the same
thing.  PyTorch runs eagerly, so the layer ``scan`` of the JAX package is
a Python loop over the stacked layers, taken apart once per forward
(:func:`unbind_layers`).  Under autograd each block runs under
:func:`_remat` (the config's ``remat``: ``full`` keeps only the block's
inputs and recomputes the rest in the backward; ``dots`` keeps the 2-D
products its backward reads too).

Training's losses (:func:`lm_loss_from_logits`, :func:`streaming_lm_loss`,
:func:`loss_fn`) are the JAX package's: cross-entropy over labels >= 0,
the z-loss and the MoE aux loss; the streaming loss never holds the
whole ``(B, S, V)`` logits.

Serving state lives on the device: the KV cache is updated in place (one
buffer per cache, where the JAX package returns a new one), and its
``len`` (with the bucket-padded ``valid_len`` / ``prefill_len``) is a
tensor that :func:`decode_step` advances with ``add_``.  A decode step
therefore reads no Python length and makes no host sync, so the serving
engine captures a whole greedy loop in one CUDA graph and replays it at
any prompt length.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import constrain, logical
from repro_torch.kernels.gemm import launch_role
from repro_torch.kernels.ops import KeptStore, closing_product, gemm, kept_mm, kept_products
from repro_torch.models import common as cm
from repro_torch.utils.spans import span
from repro_torch.utils.tree import tree_from_numpy

__all__ = [
    "init_params",
    "attn_params",
    "mlp_params",
    "attn_sublayer",
    "mlp_sublayer",
    "params_from_reference",
    "forward_hidden",
    "forward_logits",
    "embed_tokens",
    "lm_logits",
    "lm_loss_from_logits",
    "streaming_lm_loss",
    "loss_fn",
    "unbind_layers",
    "moe_apply",
    "init_cache",
    "prefill",
    "last_logits",
    "decode_step",
]


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


# =============================================================================
# parameters
# =============================================================================


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """Truncated normal in [-2, 2] times ``scale``, in ``dtype``.  A
    tensor of more than two dims is drawn one trailing matrix at a time
    (a layer's weight, an expert's), so the f32 draw never holds more
    than one matrix beside the result.  On ``meta`` nothing is drawn: the
    result only has the shape and type (a dry run's abstract params)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    mats = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for mat in mats:
        x = torch.empty(mat.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        mat.copy_(x * scale)
    return out


def norm_params(shape, kind: str, dtype, device) -> dict:
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def dense_params(gen: torch.Generator, lead: tuple, d_in: int, d_out: int, dtype, device,
                 bias: bool = False) -> dict:
    """A projection ``(*lead, d_in, d_out)`` drawn as the JAX package's:
    a truncated normal scaled by ``1/sqrt(d_in)``, and a zero bias."""
    p = {"w": trunc_normal(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def attn_params(cfg: ArchConfig, gen: torch.Generator, device, lead: tuple) -> dict:
    """An attention sub-layer's ``wq``, ``wk``, ``wv`` and ``wo``."""
    dt = _dt(cfg.param_dtype)
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_params(gen, lead, d, h * hd, dt, device, cfg.qkv_bias),
        "wk": dense_params(gen, lead, d, kv * hd, dt, device, cfg.qkv_bias),
        "wv": dense_params(gen, lead, d, kv * hd, dt, device, cfg.qkv_bias),
        "wo": dense_params(gen, lead, h * hd, d, dt, device),
    }


def mlp_params(cfg: ArchConfig, gen: torch.Generator, device, lead: tuple) -> dict:
    """A dense MLP sub-layer's ``wi``, ``wo`` and, where gated, ``wg``."""
    dt = _dt(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"wi": dense_params(gen, lead, d, f, dt, device),
           "wo": dense_params(gen, lead, f, d, dt, device)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        mlp["wg"] = dense_params(gen, lead, d, f, dt, device)
    return mlp


def init_block(cfg: ArchConfig, gen: torch.Generator, device, n: int, *, moe: bool,
               cross: bool = False) -> dict:
    """``n`` blocks' parameters stacked on axis 0, distributed as the JAX
    package's ``init_block``: truncated normals scaled by
    ``1/sqrt(d_in)``, unit norm scales, zero biases."""
    dt = _dt(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    if moe:
        e = cfg.n_experts
        mlp = {
            "router": {"w": trunc_normal(gen, (n, d, e), 1.0 / math.sqrt(d), torch.float32,
                                         device)},
            "wi": trunc_normal(gen, (n, e, d, f), 1.0 / math.sqrt(d), dt, device),
            "wo": trunc_normal(gen, (n, e, f, d), 1.0 / math.sqrt(f), dt, device),
        }
        if cfg.mlp_kind in ("swiglu", "geglu"):
            mlp["wg"] = trunc_normal(gen, (n, e, d, f), 1.0 / math.sqrt(d), dt, device)
    else:
        mlp = mlp_params(cfg, gen, device, (n,))
    p = {
        "ln1": norm_params((n, d), cfg.norm, dt, device),
        "attn": attn_params(cfg, gen, device, (n,)),
        "ln2": norm_params((n, d), cfg.norm, dt, device),
        "mlp": mlp,
    }
    if cross:
        p["ln_cross"] = norm_params((n, d), cfg.norm, dt, device)
        p["cross"] = attn_params(cfg, gen, device, (n,))
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights from an explicit generator (which must live on
    ``device``), in the JAX package's tree and distribution."""
    dt = _dt(cfg.param_dtype)
    v, d = cfg.padded_vocab, cfg.d_model
    p: dict = {
        "embed": {"table": trunc_normal(generator, (v, d), d ** -0.5, dt, device)},
        "ln_f": norm_params((d,), cfg.norm, dt, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": trunc_normal(generator, (d, v), 1.0 / math.sqrt(d), dt, device)}
    p["layers"] = init_block(cfg, generator, device, cfg.n_layers, moe=cfg.family == "moe",
                             cross=cfg.family == "encdec")
    if cfg.family == "encdec":
        p["encoder"] = {
            "layers": init_block(cfg, generator, device, cfg.n_encoder_layers, moe=False),
            "ln_f": norm_params((d,), cfg.norm, dt, device),
        }
    if cfg.pos_embed == "learned":
        p["pos_table"] = trunc_normal(generator, (32768, d), 0.02, dt, device)
    return p


def params_from_reference(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (of any family), with its leaves
    given as numpy arrays, as the port's parameters on ``device``.  The
    layouts are the same, so this only converts leaves, each keeping its
    own type (bf16 weights, f32 routers and SSM scalars)."""
    return tree_from_numpy(tree, device)


def layer(layers: dict, i) -> dict:
    """Layer ``i`` (an index, or an index tuple) of a stacked tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def unbind_layers(layers: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, each leaf unbound once.  The
    backward of one ``unbind`` stacks a leaf's gradients once; indexing
    each layer out of the stack (:func:`layer`) would make every layer's
    backward write a zero-filled gradient of the whole stack."""
    per: list[dict] = [{} for _ in range(n)]
    for key, v in layers.items():
        parts = unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            per[i][key] = parts[i]
    return per


def _kept_product_frames():
    """``torch.utils.checkpoint``'s ``context_fn`` for ``dots``: the
    forward keeps the block's products, the recompute replays them."""
    store = KeptStore()
    return kept_products(store, replay=False), kept_products(store, replay=True)


def _checkpointed(fn, keep_products: bool = False):
    """``fn`` under a non-reentrant ``torch.utils.checkpoint`` while
    autograd records: the backward runs it again, with grad on as its
    first run had, so it takes the same attention path.  Only its inputs
    are kept, and everything is recomputed; with ``keep_products``
    (``dots``) the block keeps, besides its inputs, exactly the 2-D
    products that JAX's ``dots_with_no_batch_dims_saveable`` saves for the
    JAX package's block (``kernels/ops.kept_products``): every output of
    the GEMM operator and the MoE router's f32 product (:func:`kept_mm`)
    that the backward reads, which the recompute takes back in place of
    running it.  The block's closing product (the MLP's down product, an
    SSM block's output projection), whose output feeds only the residual
    add, is not kept: the backward reads nothing of it, and the recompute,
    which stops at the last tensor the forward saved, takes a placeholder
    there.  So a dense block keeps wq, wk, wv, wo, gate and up.
    Attention's batched products, the MoE experts' and the SSD scan's run
    again, as under JAX's policy.  GEMM launches of the second run count
    under the launch role ``recompute``: a ``dots`` block launches none
    there.  (Selective checkpointing,
    ``create_selective_checkpoint_contexts``, could keep products too, but
    its dispatch mode runs Python on every op of the forward and the
    recompute, which made yi-6b's step slower than ``full``'s:
    ``chip_smoke.py`` phase 16(a) times both, ``PERF.md`` §6.)"""

    context_fn = {"context_fn": _kept_product_frames} if keep_products else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        calls = []

        def body(*a):
            role = "recompute" if calls else "forward"
            calls.append(role)
            with launch_role(role), span(f"remat.{role}"):
                return fn(*a)

        # the blocks draw no random numbers: no RNG state to stash and
        # restore (which would copy the card's generator state each block)
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                          **context_fn)

    return run


def _remat(cfg: ArchConfig, fn):
    """A block body under the config's rematerialization: ``none`` keeps
    every intermediate for the backward, ``full`` only the body's inputs,
    ``dots`` its inputs and the 2-D products its backward reads
    (:func:`_checkpointed`)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return _checkpointed(fn)
    if cfg.remat == "dots":
        return _checkpointed(fn, keep_products=True)
    raise ValueError(f"unknown remat {cfg.remat!r}")


# =============================================================================
# blocks
# =============================================================================


def attn_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, cross: bool = False, kv_cache: Optional[dict] = None,
               cache_len=None, xkv: Optional[torch.Tensor] = None,
               valid_len: Optional[torch.Tensor] = None, prefix_len=None):
    """Self- or cross-attention.  Returns ``(out, new_kv | None)``.

    self, no cache:   keys/values from x (train / prefill)
    self, cache:      decode — write the (B, s) K/V into the layer's cache
                      views at ``cache_len`` (in place), attend the prefix
    cross, no cache:  keys/values from ``xkv`` = the encoder's output
    cross, cache:     decode — attend the encoder K/V cached at prefill"""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = cm.dense(p["wq"], x).reshape(b, s, h, hd)
    if cross and kv_cache is not None:
        out = cm.cross_attention(q, kv_cache["k"], kv_cache["v"], softcap=cfg.attn_softcap)
        return cm.dense(p["wo"], out.reshape(b, s, h * hd)), None

    src = x if xkv is None else xkv
    k = cm.dense(p["wk"], src).reshape(b, src.shape[1], kvh, hd)
    v = cm.dense(p["wv"], src).reshape(b, src.shape[1], kvh, hd)
    if cfg.pos_embed == "rope" and not cross:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if cross:
        out = cm.cross_attention(q, k, v, softcap=cfg.attn_softcap)
    elif kv_cache is not None:  # self-attention decode: append to the cache
        kc, vc = kv_cache["k"], kv_cache["v"]
        rows = cache_len + torch.arange(s, device=x.device)
        kc.index_copy_(1, rows, k.to(kc.dtype))
        vc.index_copy_(1, rows, v.to(vc.dtype))
        new_kv = {"k": kc, "v": vc}
        out = cm.decode_attention(q, kc, vc, cache_len + s, softcap=cfg.attn_softcap,
                                  valid_len=valid_len, prefix_len=prefix_len)
    else:
        if causal:
            out = cm.attention_dispatch(q, k, v, softcap=cfg.attn_softcap,
                                        chunk_threshold=cfg.attn_chunk_threshold)
        else:
            out = cm.cross_attention(q, k, v, softcap=cfg.attn_softcap)
        new_kv = {"k": k, "v": v}
    return cm.dense(p["wo"], out.reshape(b, s, h * hd)), new_kv


def mlp_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        hidden = cm.mlp_act(cfg.mlp_kind, cm.dense(p["wi"], x), cm.dense(p["wg"], x))
    else:
        hidden = cm.mlp_act(cfg.mlp_kind, cm.dense(p["wi"], x))
    with closing_product():  # its output feeds only the block's residual add
        return cm.dense(p["wo"], hidden)


def _moe_route(cfg: ArchConfig, p: dict, xf: torch.Tensor):
    """Router: top-k experts and weights, and the aux losses (Switch load
    balance + router z-loss), all in f32."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t = xf.shape[0]
    router_logits = kept_mm(xf.float(), p["router"]["w"].float())
    probs = torch.softmax(router_logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if cfg.router_norm_topk:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # one_hot(top_e[:, 0]).mean(0) without one_hot's range check (a host sync)
    density = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, top_e[:, 0], torch.ones(t, dtype=torch.float32, device=xf.device)) / t
    aux = e * torch.sum(density * probs.mean(dim=0))
    zloss = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    return top_e, top_w, 0.01 * aux + 1e-3 * zloss


def _sorted_capacity_buffers(t: int, e: int, cap: int, k: int, top_e: torch.Tensor):
    """Sorted-dispatch bookkeeping, all static shapes (sort, counts,
    cumsum, scatter: nothing reads a value on the host).  Returns
    ``(buf_tok (e, cap), buf_valid (e, cap), inv (t, k) slot or -1)``.

    A choice past its expert's capacity is dropped: it writes into a
    spare slot past the buffers.  (The JAX package writes it into its
    expert's slot 0 with token 0, where the last write wins, so an
    overflowing expert's first token is replaced by token 0: a gap of the
    reference, ROADMAP.md.)"""
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    flat_tok = torch.arange(t * k, device=dev) // k
    order = torch.argsort(flat_e, stable=True)
    sorted_e, sorted_tok = flat_e[order], flat_tok[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = sorted_e * cap + torch.where(keep, pos_in_e, 0)
    dest = torch.where(keep, slot, e * cap)
    buf_tok = torch.zeros(e * cap + 1, dtype=torch.long, device=dev).index_put_(
        (dest,), sorted_tok)
    buf_valid = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev).index_put_(
        (dest,), keep)
    inv = torch.full((t * k,), -1, dtype=torch.long, device=dev).index_put_(
        (order,), torch.where(keep, slot, -1))
    return buf_tok[:e * cap].view(e, cap), buf_valid[:e * cap].view(e, cap), inv.view(t, k)


def _expert_ffn(cfg: ArchConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """The experts' FFN as batched products over the expert axis (the JAX
    package's einsums, which it leaves outside any Pallas kernel)."""
    if "wg" in p:
        hid = cm.mlp_act(cfg.mlp_kind, torch.bmm(xe, p["wi"]), torch.bmm(xe, p["wg"]))
    else:
        hid = cm.mlp_act(cfg.mlp_kind, torch.bmm(xe, p["wi"]))
    return torch.bmm(hid, p["wo"])


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """Top-k routed MoE with capacity buffers (GShard/Switch-style sorted
    dispatch, O(T·k) memory).  The JAX package's all-to-all dispatch
    (``moe_impl="a2a"``) needs a device mesh; one card has none
    (``current_mesh()`` is None), so every MoE config runs this path, as
    the reference's does without a mesh.  Returns ``(out, aux_loss)``."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(t, d)
    with span("moe.route"):
        top_e, top_w, aux_total = _moe_route(cfg, p, xf)
    with span("moe.dispatch"):
        cap = max(1, int(k * t * cfg.moe_capacity_factor / e))
        buf_tok, buf_valid, inv = _sorted_capacity_buffers(t, e, cap, k, top_e)
        xe = constrain(xf[buf_tok] * buf_valid[..., None].to(xf.dtype),
                       logical("expert", "expert_cap", None))
    with span("moe.experts"):
        ye = _expert_ffn(cfg, p, xe)
    with span("moe.combine"):
        # combine as a gather: inv[t, j] is the slot of (token t, choice j)
        gathered = ye.reshape(e * cap, d)[inv.clamp(min=0)]  # (t, k, d)
        gathered = gathered * (inv >= 0)[..., None].to(ye.dtype) * top_w.to(ye.dtype)[..., None]
        return gathered.sum(dim=1).reshape(b, s, d), aux_total


def attn_sublayer(cfg: ArchConfig, ln: dict, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  *, index: Optional[int] = None, **kw):
    """A pre-norm self-attention sub-layer with its residual add: the span
    ``block.norm`` over the norm, ``block.attn`` over the attention and the
    add.  ``kw`` goes to :func:`attn_apply`.  Returns ``(x, new_kv)``."""
    with span("block.norm", index):
        h = cm.norm_apply(ln, x, cfg.norm, cfg.norm_eps)
    with span("block.attn", index):
        a, new_kv = attn_apply(cfg, p, h, positions, **kw)
        return x + a, new_kv


def mlp_sublayer(cfg: ArchConfig, ln: dict, p: dict, x: torch.Tensor,
                 index: Optional[int] = None) -> torch.Tensor:
    """A pre-norm dense MLP sub-layer with its residual add, under the
    spans ``block.norm`` and ``block.mlp``."""
    with span("block.norm", index):
        h = cm.norm_apply(ln, x, cfg.norm, cfg.norm_eps)
    with span("block.mlp", index):
        return x + mlp_apply(cfg, p, h)


def block_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                moe: bool, causal: bool = True, kv_cache: Optional[dict] = None,
                cache_len=None, cross_kv: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None, valid_len=None, prefix_len=None,
                index: Optional[int] = None):
    """One pre-norm block: :func:`attn_sublayer`, an encoder-decoder's
    cross-attention, then :func:`mlp_sublayer` or the MoE.  Returns ``(x,
    new_kv, aux)``.  Its spans carry ``index``: each pre-norm is
    ``block.norm``, and each sub-layer with its residual add ``block.attn``
    and ``block.mlp`` or ``block.moe``, so that a MoE block's ``moe.*``
    spans cover its ``block.moe`` but for the add."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, new_kv = attn_sublayer(cfg, p["ln1"], p["attn"], x, positions, index=index,
                              causal=causal, kv_cache=kv_cache, cache_len=cache_len,
                              valid_len=valid_len, prefix_len=prefix_len)
    if "cross" in p:
        with span("block.attn", index):
            h = cm.norm_apply(p["ln_cross"], x, cfg.norm, cfg.norm_eps)
            c, _ = attn_apply(cfg, p["cross"], h, positions, cross=True, kv_cache=cross_kv,
                              cache_len=cache_len, xkv=enc_out)
            x = x + c
    if not moe:
        return mlp_sublayer(cfg, p["ln2"], p["mlp"], x, index), new_kv, aux
    with span("block.norm", index):
        h = cm.norm_apply(p["ln2"], x, cfg.norm, cfg.norm_eps)
    with span("block.moe", index):
        m, aux = moe_apply(cfg, p["mlp"], h)
        return x + m, new_kv, aux


def _run_blocks(cfg: ArchConfig, layers: dict, n: int, x: torch.Tensor,
                positions: torch.Tensor, *, moe: bool, causal: bool = True,
                enc_out=None, on_kv=None):
    """The stacked blocks in turn, each under :func:`_remat`; ``on_kv(i,
    kv)`` receives each layer's K/V (prefill writes them into the cache).
    Returns ``(x, aux)``."""
    body = _remat(cfg, lambda p, x, i: block_apply(cfg, p, x, positions, moe=moe, causal=causal,
                                                    enc_out=enc_out, index=i))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(unbind_layers(layers, n)):
        x, kv, a = body(p, x, i)
        aux = aux + a
        if on_kv is not None:
            on_kv(i, kv)
    return x, aux


# =============================================================================
# full models
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


def _learned_positions(params: dict, positions: torch.Tensor) -> torch.Tensor:
    table = params["pos_table"]
    return table[positions % table.shape[0]]


def _encode(cfg: ArchConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-family encoder over precomputed frame embeddings (the conv
    frontend is a stub, as in the JAX package)."""
    x = frames.to(_dt(cfg.compute_dtype))
    x = x + cm.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _run_blocks(cfg, params["encoder"]["layers"], cfg.n_encoder_layers, x, pos,
                       moe=False, causal=False)
    return cm.norm_apply(params["encoder"]["ln_f"], x, cfg.norm, cfg.norm_eps)


def _embed_prompt(cfg: ArchConfig, params: dict, batch: dict):
    """Token embeddings with the VLM frontend prepended and learned
    positions added; returns ``(x, positions (1, S))``."""
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.pos_embed == "learned":
        x = x + _learned_positions(params, positions[0])
    return x, positions


def forward_hidden(cfg: ArchConfig, params: dict, batch: dict):
    """Forward to the final hidden states (before ``ln_f``).  batch:
    ``tokens`` (B, S_text) int, ``frontend_embeds`` (B, S_front, d) for a
    VLM, ``enc_frames`` (B, S_enc, d) for an encoder-decoder.  Returns
    ``(x (B, S, d), aux_loss)``."""
    x, positions = _embed_prompt(cfg, params, batch)
    enc_out = _encode(cfg, params, batch["enc_frames"]) if cfg.family == "encdec" else None
    return _run_blocks(cfg, params["layers"], cfg.n_layers, x, positions,
                       moe=cfg.family == "moe", enc_out=enc_out)


def forward_logits(cfg: ArchConfig, params: dict, batch: dict):
    """Full-sequence forward: ``(logits (B, S, V), aux_loss)``."""
    x, aux = forward_hidden(cfg, params, batch)
    return lm_logits(cfg, params, x), aux


# =============================================================================
# losses
# =============================================================================


def pad_labels(labels: torch.Tensor, length: int) -> torch.Tensor:
    """Labels left-padded with -1 (unsupervised) to ``length``: a VLM's
    frontend positions carry no label."""
    pad = length - labels.shape[1]
    if pad == 0:
        return labels
    fill = torch.full((labels.shape[0], pad), -1, dtype=labels.dtype, device=labels.device)
    return torch.cat([fill, labels], dim=1)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """``(valid, lab, lse)`` of f32 logits: the supervised positions, the
    labels with -1 read as 0, and each position's logsumexp."""
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    return valid, lab, torch.logsumexp(logits, dim=-1)


def lm_loss_from_logits(cfg: ArchConfig, logits: torch.Tensor, aux: torch.Tensor,
                        labels: torch.Tensor):
    """Cross-entropy (+ MoE aux, + z-loss) over the labels >= 0, shared by
    every family.  Returns ``(loss, metrics)``."""
    labels = pad_labels(labels, logits.shape[1])
    valid, lab, lse = _ce_terms(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, lab[..., None])[..., 0]
    n_valid = valid.sum()
    denom = torch.clamp(n_valid, min=1)
    ce = -torch.sum(torch.where(valid, ll, 0.0)) / denom
    zloss = 1e-4 * torch.sum(torch.where(valid, lse ** 2, 0.0)) / denom
    loss = ce + zloss + aux
    hits = torch.where(valid, torch.argmax(logits, -1) == lab, False)
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": n_valid,
                  "accuracy": hits.sum() / denom}


def _loss_chunk(cfg: ArchConfig, w: torch.Tensor, xi: torch.Tensor, li: torch.Tensor):
    """One sequence chunk's sums: cross-entropy, z-loss, hits, and the
    supervised positions."""
    logits = gemm(xi, w, device=xi.device.type).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=xi.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    valid, lab, lse = _ce_terms(logits, li)
    picked = torch.gather(logits, -1, lab[..., None])[..., 0]
    ce = torch.sum(torch.where(valid, lse - picked, 0.0))
    zl = torch.sum(torch.where(valid, lse ** 2, 0.0))
    acc = torch.sum(torch.where(valid, torch.argmax(logits, -1) == lab, False))
    return ce, zl, acc, valid.sum()


def streaming_lm_loss(cfg: ArchConfig, params: dict, x: torch.Tensor,
                      labels: torch.Tensor, aux: torch.Tensor, chunk: int = 512):
    """Cross-entropy + z-loss without the whole ``(B, S, V)`` logits: each
    ``chunk`` of positions computes its own logits, under a non-reentrant
    checkpoint while autograd records, so the backward recomputes them
    (the JAX package's ``jax.checkpoint``-ed ``lax.scan`` over chunks).
    A length the chunk does not divide takes one chunk.  Returns
    ``(loss, metrics)``."""
    x = cm.norm_apply(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["head"]["w"]
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    body = _checkpointed(lambda w, xi, li: _loss_chunk(cfg, w, xi, li))
    dev = x.device
    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=dev)
    acc_sum = n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    for c0 in range(0, s, chunk):
        ce, zl, acc, nv = body(w, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        ce_sum, z_sum = ce_sum + ce, z_sum + zl
        acc_sum, n_valid = acc_sum + acc, n_valid + nv
    denom = torch.clamp(n_valid, min=1)
    ce = ce_sum / denom
    zloss = 1e-4 * z_sum / denom
    loss = ce + zloss + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": n_valid,
                  "accuracy": acc_sum / denom}


def loss_fn(cfg: ArchConfig, params: dict, batch: dict):
    """Loss of the full logits (the attention families): ``(loss, metrics)``."""
    logits, aux = forward_logits(cfg, params, batch)
    return lm_loss_from_logits(cfg, logits, aux, batch["labels"])


# =============================================================================
# serving: prefill + decode
# =============================================================================


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    dt = _dt(cfg.compute_dtype)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, kvh, hd)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.long, device=device),
    }
    if cfg.family == "encdec":
        eshape = (cfg.n_layers, batch, cfg.encoder_len, kvh, hd)
        cache["cross_k"] = torch.zeros(eshape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(eshape, dtype=dt, device=device)
    return cache


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int,
            last_idx: Optional[torch.Tensor] = None, cache: Optional[dict] = None):
    """Run the prompt; return ``(last_logits (B, 1, V), cache)``.

    ``last_idx`` (B,), optional: each sequence's last real position along
    the full sequence (frontend included).  The serving engine
    right-pads prompts into fixed buckets, so the logits that seed
    decoding come from each sequence's own last real position, not the
    bucket's final column.  ``cache``, optional: an :func:`init_cache`
    of at least the prompt's batch and length to write into (the engine's
    own, whose addresses its decode graphs hold); a new one otherwise.
    Spans: ``model.embed``, the blocks', ``model.head``."""
    with span("model.embed"):
        x, positions = _embed_prompt(cfg, params, batch)
    b, s = x.shape[:2]
    if cache is None:
        cache = init_cache(cfg, b, max_len, device=x.device)
    enc_out = _encode(cfg, params, batch["enc_frames"]) if cfg.family == "encdec" else None

    def write_kv(i, kv):
        cache["k"][i, :b, :s] = kv["k"]
        cache["v"][i, :b, :s] = kv["v"]

    x, _ = _run_blocks(cfg, params["layers"], cfg.n_layers, x, positions,
                       moe=cfg.family == "moe", enc_out=enc_out, on_kv=write_kv)
    cache["len"].fill_(s)
    if cfg.family == "encdec":
        # the cross K/V of every layer, from the encoder's output, once
        kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        es = enc_out.shape[1]
        for i in range(cfg.n_layers):
            cp = layer(params["layers"]["cross"], i)
            cache["cross_k"][i, :b] = cm.dense(cp["wk"], enc_out).reshape(b, es, kvh, hd)
            cache["cross_v"][i, :b] = cm.dense(cp["wv"], enc_out).reshape(b, es, kvh, hd)
    return last_logits(cfg, params, x, last_idx), cache


def last_logits(cfg: ArchConfig, params: dict, x: torch.Tensor,
                last_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill's seed logits ``(B, 1, V)``, under the span ``model.head``:
    at each sequence's last real position ``last_idx`` (B,) of a
    right-padded batch, else at the last column."""
    with span("model.head"):
        if last_idx is None:
            x_last = x[:, -1:, :]
        else:
            x_last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()][:, None, :]
        return lm_logits(cfg, params, x_last)


def decode_positions(cache: dict, b: int, device) -> torch.Tensor:
    """(B, 1) positions of the token a decode step appends.  Bucket-padded
    serving stashes each sequence's real prompt length (``valid_len``)
    and the bucket width (``prefill_len``) in the cache, so each
    sequence's position continues from its own last real token, not the
    bucket boundary."""
    pos = cache["len"]
    valid_len, prefix_len = cache.get("valid_len"), cache.get("prefill_len")
    if valid_len is not None:
        return valid_len[:, None] + (pos - prefix_len)
    return pos + torch.zeros((b, 1), dtype=torch.long, device=device)


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """One token for every sequence.  tokens: (B, 1).  Returns
    ``(logits (B, 1, V), cache)``: the cache's K/V are written in place
    and its ``len`` advanced on the device, so the step makes no host
    sync and can be captured.  Pad K/V rows of a bucket-padded prefill
    are masked out of every step (``valid_len`` / ``prefill_len``)."""
    b = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    pos = cache["len"]
    positions = decode_positions(cache, b, x.device)
    valid_len, prefix_len = cache.get("valid_len"), cache.get("prefill_len")
    if cfg.pos_embed == "learned":
        x = x + _learned_positions(params, positions[:, 0])[:, None]
    moe, has_cross = cfg.family == "moe", cfg.family == "encdec"
    for i in range(cfg.n_layers):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        cross_kv = {"k": cache["cross_k"][i], "v": cache["cross_v"][i]} if has_cross else None
        x, _, _ = block_apply(cfg, layer(params["layers"], i), x, positions, moe=moe,
                              kv_cache=kv, cache_len=pos, cross_kv=cross_kv,
                              valid_len=valid_len, prefix_len=prefix_len, index=i)
    cache["len"].add_(1)
    return lm_logits(cfg, params, x), cache
