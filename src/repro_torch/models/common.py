"""Shared model building blocks, on tensors with an explicit device.

Params are nested dicts of tensors, laid out as the JAX package's
(``(d_in, d_out)`` weights).  Every dense projection goes through
``repro_torch.kernels.ops.gemm`` (the hand-written GEMM kernel under the
tuned or heuristic config), and long causal self-attention through
:func:`attention_dispatch` (the hand-written flash kernel under the tuned
or heuristic blocks).  Norms and softmax run in f32; matmul inputs stay
in the configured compute dtype.

Decode takes its lengths (``length``, ``prefix_len``, ``valid_len``) as
tensors on the model's device, so a whole decode loop can be captured in
a CUDA graph and replayed at other lengths.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import gemm
from repro_torch.utils.op_costs import counted_as

__all__ = [
    "dense",
    "rmsnorm",
    "layernorm",
    "norm_apply",
    "rope_freqs",
    "apply_rope",
    "sinusoidal_positions",
    "attention_dispatch",
    "causal_attention",
    "chunked_causal_attention",
    "cross_attention",
    "decode_attention",
    "mlp_act",
]


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = gemm(x, p["w"], device=x.device.type)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # statistics in f32, cast back to the compute dtype before the scale
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    y = y * p["scale"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    return layernorm(p, x, eps) if kind == "layernorm" else rmsnorm(p, x, eps)


# -- positions ----------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# -- attention ----------------------------------------------------------------


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def _group_q(q: torch.Tensor, kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd): GQA queries grouped by KV head, so
    attention contracts against the original K/V without repeating them."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv, h // kv, hd)


def attention_dispatch(q, k, v, softcap: float = 0.0,
                       chunk_threshold: int = 2048) -> torch.Tensor:
    """Causal self-attention.  Sequences longer than ``chunk_threshold``
    (with no softcap) run the flash kernel: under the **tuned**
    ``(block_q, block_kv)`` when ``launch/tune.py --op flash`` recorded
    one for this ``(seq_q, seq_kv, head_dim, dtype)`` workload (see
    ``kernels/ops.flash_schedule``), else under the kernel's heuristic
    blocks.  A long sequence the kernel cannot take — a softcap, or no
    block the kernel launches divides it (a shape rule, counted as
    ``plain``; the JAX package counts it as ``xla``) — runs
    :func:`chunked_causal_attention`; short ones plain
    :func:`causal_attention`.

    Whenever autograd records (grad mode on and an operand requires a
    gradient) a long sequence runs :func:`chunked_causal_attention`,
    counted as ``plain``: the flash kernel has no backward, in the JAX
    package either, whose training runs with flash off."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import flash_blocks, note_dispatch

    b, s, h, hd = q.shape
    sk = k.shape[1]
    records = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if records and s > chunk_threshold:
        note_dispatch("flash", "plain")
        with torch.profiler.record_function("attn.chunked"):
            return chunked_causal_attention(q, k, v, softcap=softcap)
    if softcap == 0.0 and s > chunk_threshold:
        blocks, source = flash_blocks(s, sk, hd, q.dtype, grid_y=b * h)
        note_dispatch("flash", source)
        if blocks is not None:
            return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), *blocks)
    if s > chunk_threshold:
        return chunked_causal_attention(q, k, v, softcap=softcap)
    return causal_attention(q, k, v, softcap=softcap)


@counted_as("attention")
def causal_attention(q, k, v, softcap: float = 0.0, causal: bool = True) -> torch.Tensor:
    """Attention without a repeated K/V.  q: (B,S,H,hd), k/v: (B,Sk,KV,hd).
    The causal mask is offset by ``Sk - Sq``, as the JAX package's is."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = _group_q(q, kv)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = _softcap(logits * (1.0 / math.sqrt(hd)), softcap)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, hd)


@counted_as("attention")
def chunked_causal_attention(q, k, v, chunk_q: int = 512, chunk_k: int = 1024,
                             softcap: float = 0.0) -> torch.Tensor:
    """Online-softmax causal attention in ``chunk_q x chunk_k`` blocks,
    O(S x chunk) memory: the JAX package's ``lax.map`` over q blocks and
    ``lax.scan`` over kv chunks become Python loops, and the chunks past
    the causal diagonal are skipped, as the reference's ``cond`` skips
    them.  Positions start at 0 for q and k (no ``Sk - Sq`` offset), and
    the chunks must divide the sequences."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    sk = k.shape[1]
    chunk_q, chunk_k = min(chunk_q, sq), min(chunk_k, sk)
    if sq % chunk_q or sk % chunk_k:
        raise ValueError(f"chunks ({chunk_q}, {chunk_k}) must divide ({sq}, {sk})")
    nq, nk = sq // chunk_q, sk // chunk_k
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(b, nq, chunk_q, kv, g, hd)
    out = torch.empty((b, nq, chunk_q, kv, g, hd), dtype=q.dtype, device=q.device)
    for iq in range(nq):
        q_i = qc[:, iq]
        acc = torch.zeros((b, kv, g, chunk_q, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, kv, g, chunk_q), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        q_pos = iq * chunk_q + torch.arange(chunk_q, device=q.device)
        last = min(nk - 1, ((iq + 1) * chunk_q - 1) // chunk_k)
        for ik in range(last + 1):
            k_j = k[:, ik * chunk_k:(ik + 1) * chunk_k]
            v_j = v[:, ik * chunk_k:(ik + 1) * chunk_k]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j).float()
            logits = _softcap(logits * scale, softcap)
            k_pos = ik * chunk_k + torch.arange(chunk_k, device=q.device)
            logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype), v_j).float()
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, iq] = o.permute(0, 3, 1, 2, 4).to(q.dtype)  # (b, cq, kv, g, hd)
    return out.reshape(b, sq, h, hd)


def cross_attention(q, k, v, softcap: float = 0.0) -> torch.Tensor:
    return causal_attention(q, k, v, softcap=softcap, causal=False)


@counted_as("attention")
def decode_attention(q, k_cache, v_cache, length, softcap: float = 0.0,
                     valid_len: Optional[torch.Tensor] = None,
                     prefix_len=None) -> torch.Tensor:
    """Single-position attention over a cache (no K/V repeat).

    q: (B,1,H,hd); k/v_cache: (B,S_max,KV,hd); ``length``: valid prefix.
    With bucket-padded prefill (prompts right-padded to ``prefix_len``),
    cache positions in ``[valid_len[b], prefix_len)`` hold pad-token K/V
    and are masked out per sequence; positions at or beyond
    ``prefix_len`` are decode appends, governed by ``length`` alone.
    ``length`` and ``prefix_len`` may be ints or 0-d tensors on q's
    device; as tensors, a captured decode reads them at each replay."""
    b, sq, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = _group_q(q, kv)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float()
    logits = _softcap(logits * (1.0 / math.sqrt(hd)), softcap)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = (pos < length)[None, None, None, None, :]
    if valid_len is not None:
        real = (pos[None, :] < valid_len[:, None]) | (pos[None, :] >= prefix_len)
        mask = mask & real[:, None, None, None, :]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(b, sq, h, hd)


# -- MLP activations -------------------------------------------------------------


def mlp_act(kind: str, x: torch.Tensor, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        if gate is None:
            raise ValueError(f"{kind} needs a gate")
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        return act * x
    if kind == "squared_relu":
        r = F.relu(x)
        return r * r
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind}")
