"""Mamba2 — State Space Duality (SSD) blocks (arXiv:2405.21060), the twin
of the JAX package's ``models/mamba2.py``.

Prefill uses the chunked SSD algorithm: a quadratic, attention-like form
inside chunks plus a linear recurrence across chunk boundaries (the JAX
package's ``lax.scan`` over chunks is a Python loop here).  The SSD math
is plain tensor code in the reference too (no Pallas kernel), so torch
ops carry it; the block's in/out projections go through ``cm.dense``,
i.e. the hand-written GEMM kernel.  Decode keeps an O(1)-in-sequence
recurrent state per layer (conv window and SSM state), updated in place
on the device, with the cache's ``len`` a device tensor, so a decode
step makes no host sync and can be captured in a CUDA graph.

B and C are kept per group (``ssm_n_groups``) throughout: the SSD's
contractions take the heads as ``(groups, heads per group)``, and the
gated norm normalises each group's slice of the inner width.  A
right-padded prefill stops each row's state at its real length: its pad
slots get ``dt = 0``, which leaves the state unchanged, and decode's conv
window is gathered at the row's last real positions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import constrain, logical
from repro_torch.kernels.ops import closing_product
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.utils.spans import span

__all__ = [
    "init_mamba_block",
    "mamba_block_apply",
    "mamba_block_prefill",
    "mamba_block_decode",
    "init_mamba_state",
    "ssd_chunked",
    "ssd_reference",
    "gated_rmsnorm",
    "init_mamba_lm",
    "mamba_lm_forward",
    "mamba_lm_hidden",
    "mamba_lm_prefill",
    "mamba_lm_init_cache",
    "mamba_lm_decode_step",
]


# =============================================================================
# SSD core
# =============================================================================


def ssd_reference(x, dt, A, B, C) -> torch.Tensor:
    """Naive O(L) recurrence, the oracle of the chunked path, in f32.
    x: (b,l,h,p); dt: (b,l,h); A: (h,); B,C: (b,l,h,n)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dA = torch.exp(dt[:, t] * A)  # (b,h)
        dBx = torch.einsum("bhn,bhp,bh->bhpn", B[:, t], x[:, t], dt[:, t])
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1)  # (b,l,h,p)


#: f32 bytes of the per-head decay blocks (b, c, q, q, h) one SSD pass may hold;
#: a longer batch runs in blocks of rows (about four such tensors are live)
_SSD_BLOCK_BYTES = 1 << 30


def ssd_chunked(x, dt, A, B, C, chunk: int, return_state: bool = False):
    """Chunked SSD (Mamba2 Listing 1).  All SSD math runs in f32, as the
    reference's does; inputs may be bf16.  x: (b,l,h,p); dt: (b,l,h);
    A: (h,) (negative); B,C: (b,l,g,n), g dividing h: head k reads group
    ``k // (h/g)`` (g = h: one a head, the JAX package's form).

    B and C stay per group: every contraction with them takes the heads as
    ``(g, h/g)``, and the decays scale x or a contraction's output, so no
    head-expanded ``(…, h, n)`` operand is formed (the chunk states are
    ``(h, p, n)`` by nature).  Each multi-operand einsum of the reference
    is written as pairwise products, so no (b,c,q,q,h,p) intermediate is
    ever formed.  A batch whose decay blocks exceed ``_SSD_BLOCK_BYTES``
    runs in blocks of rows.  A length the chunk does not divide is padded
    at its end with ``dt = 0``, which leaves the state unchanged."""
    b, l, h, p = x.shape
    q = min(chunk, l)
    tail = -l % q
    if tail:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, tail)) for t in (x, dt, B, C))
    rows = max(1, _SSD_BLOCK_BYTES // ((l + tail) * q * h * 4))
    parts = [_ssd_rows(x[r:r + rows], dt[r:r + rows], A, B[r:r + rows], C[r:r + rows], q)
             for r in range(0, b, rows)]
    y = parts[0][0] if len(parts) == 1 else torch.cat([y for y, _ in parts])
    y = y[:, :l].to(x.dtype)
    if return_state:
        return y, parts[0][1] if len(parts) == 1 else torch.cat([st for _, st in parts])
    return y


def _ssd_rows(x, dt, A, B, C, q: int):
    """:func:`ssd_chunked` over one block of rows, the length a multiple
    of the chunk ``q``: ``(y f32 (b,l,h,p), final state (b,h,p,n))``."""
    b, l, h, p = x.shape
    g, n = B.shape[-2:]
    r = h // g
    c = l // q
    xc = x.reshape(b, c, q, g, r, p).float()
    dtc = dt.reshape(b, c, q, g, r).float()
    Bc = B.reshape(b, c, q, g, n).float()
    Cc = C.reshape(b, c, q, g, n).float()

    dA_cs = torch.cumsum(dtc * A.reshape(g, r), dim=2)  # (b,c,q,g,r) within-chunk cumulative

    # -- intra-chunk (diagonal blocks): L[i,j] = exp(dA_cs[i] - dA_cs[j]), i >= j
    seg = dA_cs[:, :, :, None] - dA_cs[:, :, None, :]  # (b,c,qi,qj,g,r)
    ii = torch.arange(q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None, None]
    # masked before the exponential: above the diagonal seg grows with the
    # chunk and its exp overflows (at 256, every published config's chunk),
    # and the backward of the JAX package's where(causal, exp(seg), 0) then
    # multiplies the masked zeros by inf: NaN gradients (ROADMAP.md)
    L = torch.exp(torch.where(causal, seg, -math.inf))
    del seg
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)[..., None] * L  # C_i·B_j per group
    del L
    y_diag = torch.einsum("bcijgr,bcjgrp->bcigrp", scores * dtc[:, :, None], xc)
    del scores

    # -- chunk summary states: the decays and dt scale x ------------------------------
    decay_to_end = torch.exp(dA_cs[:, :, -1:] - dA_cs)  # (b,c,q,g,r)
    S = torch.einsum("bcqgn,bcqgrp->bcgrpn", Bc, xc * (dtc * decay_to_end)[..., None])

    # -- inter-chunk recurrence: carry states across chunks -----------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1])  # (b,c,g,r)
    state = torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for ci in range(c):  # emit the state ENTERING each chunk
        entering.append(state)
        state = state * chunk_decay[:, ci, :, :, None, None] + S[:, ci]
    entering = torch.stack(entering, dim=1)  # (b,c,g,r,p,n)

    # -- off-diagonal contribution of the carried state, its decay on the output --
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", Cc, entering) * torch.exp(dA_cs)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p), state.reshape(b, h, p, n)


# =============================================================================
# Mamba2 block
# =============================================================================


def _shapes(cfg: ArchConfig):
    di = cfg.d_inner
    g, n = cfg.ssm_n_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return di, g, n, h, conv_ch


def init_mamba_block(cfg: ArchConfig, gen: torch.Generator, device, lead: tuple) -> dict:
    """Blocks stacked on the leading dims ``lead``, distributed as the JAX
    package's ``init_mamba_block``: truncated-normal projections and conv,
    ``A_log = log(linspace(1, 16, h))``, ``D = 1``, and ``dt_bias`` the
    inverse softplus of a log-uniform draw in [1e-3, 1e-1]."""
    d = cfg.d_model
    di, g, n, h, conv_ch = _shapes(cfg)
    dt = getattr(torch, cfg.param_dtype)
    proj_out = 2 * di + 2 * g * n + h  # z, x, B, C, dt

    def full(shape, value, dtype):
        return torch.full((*lead, *shape), value, dtype=dtype, device=device)

    u = torch.rand((*lead, h), generator=gen, device=device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "ln": tf.norm_params((*lead, d), cfg.norm, dt, device),
        "in_proj": tf.dense_params(gen, lead, d, proj_out, dt, device),
        "conv_w": tf.trunc_normal(gen, (*lead, cfg.ssm_conv_width, conv_ch),
                                  0.5 / math.sqrt(cfg.ssm_conv_width), dt, device),
        "conv_b": full((conv_ch,), 0.0, dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).expand(
            *lead, h).contiguous(),
        "D": full((h,), 1.0, torch.float32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm": {"scale": full((di,), 1.0, dt)},
        "out_proj": tf.dense_params(gen, lead, di, d, dt, device),
    }


def _causal_conv(xBC, conv_w, conv_b):
    """Depthwise causal conv over the sequence.  xBC: (b, l, ch)."""
    w = conv_w.shape[0]
    pad = F.pad(xBC, (0, 0, w - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(w):  # the width is tiny (4): unrolled taps
        out = out + pad[:, i:i + xBC.shape[1], :] * conv_w[i][None, None, :]
    return out + conv_b[None, None, :]


def _conv_window(xBC_raw, w: int, valid_len):
    """The conv's inputs at each row's last ``w - 1`` real positions (zeros
    before its first), the window decode continues from; the sequence's
    last ``w - 1`` where every position is real (``valid_len`` None)."""
    if valid_len is None:
        return xBC_raw[:, -(w - 1):, :]
    b = xBC_raw.shape[0]
    idx = valid_len[:, None] - (w - 1) + torch.arange(w - 1, device=xBC_raw.device)
    rows = torch.arange(b, device=xBC_raw.device)[:, None]
    return xBC_raw[rows, idx.clamp(min=0)] * (idx >= 0)[..., None].to(xBC_raw.dtype)


def _split_proj(cfg, zxbcdt):
    di, g, n, h, conv_ch = _shapes(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch], zxbcdt[..., di + conv_ch:]


def _ssm_inputs(cfg, xBC, dt_raw, p):
    """x by head, B and C by group (each group's heads read them), dt and A."""
    di, g, n, h, conv_ch = _shapes(cfg)
    b, l = xBC.shape[:2]
    xs = xBC[..., :di].reshape(b, l, h, cfg.ssm_head_dim)
    Bm = xBC[..., di:di + g * n].reshape(b, l, g, n)
    Cm = xBC[..., di + g * n:].reshape(b, l, g, n)
    dt_f = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, Bm, Cm, dt_f, A


def gated_rmsnorm(p: dict, y: torch.Tensor, z: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    """``rmsnorm(y ⊙ silu(z))`` over each of ``groups`` equal slices of the
    inner width, times ``p["scale"]`` (Mamba-2's gated norm with
    ``n_groups`` groups; one group normalises the whole width)."""
    gated = y * F.silu(z.float()).to(y.dtype)
    lead, di = gated.shape[:-1], gated.shape[-1]
    scale = {"scale": p["scale"].reshape(groups, di // groups)}
    return cm.rmsnorm(scale, gated.reshape(*lead, groups, di // groups), eps).reshape(*lead, di)


def _gated_out(cfg, p, y, z, res):
    y = y.reshape(*y.shape[:2], cfg.d_inner)
    with span("mamba.gate"):
        y = gated_rmsnorm(p["norm"], y, z, cfg.ssm_n_groups, cfg.norm_eps)
    with closing_product():  # its output feeds only the block's residual add
        return res + cm.dense(p["out_proj"], y)


def mamba_block_prefill(cfg: ArchConfig, p: dict, x: torch.Tensor,
                        valid_len: Optional[torch.Tensor] = None, index: Optional[int] = None):
    """Full-sequence forward that also returns the recurrent state after
    each row's last real position (the prefill -> decode handoff).
    ``valid_len`` (b,), for a right-padded batch: each row's real length;
    its pad slots get ``dt = 0``, so the SSM state stops at the row's
    length, and the conv window is taken at its last real positions.
    Spans (``index``): ``block.norm``, then ``block.mamba`` over the mixer
    and its residual add, with ``mamba.conv``, ``mamba.ssd`` and
    ``mamba.gate`` inside."""
    with span("block.norm", index):
        xn = cm.norm_apply(p["ln"], x, cfg.norm, cfg.norm_eps)
    with span("block.mamba", index):
        z, xBC_raw, dt_raw = _split_proj(cfg, cm.dense(p["in_proj"], xn))
        with span("mamba.conv"):
            xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
        with span("mamba.ssd"):
            xs, Bm, Cm, dt_f, A = _ssm_inputs(cfg, xBC, dt_raw, p)
            if valid_len is not None:
                real = torch.arange(x.shape[1], device=x.device)[None, :] < valid_len[:, None]
                dt_f = dt_f * real[..., None]
            xs = constrain(xs, logical("dp", None, "tp", None))
            y, final_state = ssd_chunked(xs, dt_f, A, Bm, Cm, cfg.ssm_chunk, return_state=True)
            y = y + p["D"][None, None, :, None].to(y.dtype) * xs
        conv_state = _conv_window(xBC_raw, cfg.ssm_conv_width, valid_len).to(
            getattr(torch, cfg.compute_dtype))
        return _gated_out(cfg, p, y, z, x), {"conv": conv_state, "ssm": final_state}


def mamba_block_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (train / prefill)."""
    return mamba_block_prefill(cfg, p, x)[0]


def init_mamba_state(cfg: ArchConfig, batch: int, lead: tuple = (), device="cuda") -> dict:
    di, g, n, h, conv_ch = _shapes(cfg)
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=getattr(torch, cfg.compute_dtype), device=device),
        "ssm": torch.zeros((*lead, batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba_block_decode(cfg: ArchConfig, p: dict, state: dict, x: torch.Tensor,
                       index: Optional[int] = None):
    """One-token step.  x: (b, 1, d).  Writes the new conv window and SSM
    state into ``state``'s tensors in place; returns the block's output.
    B and C stay per group, as in prefill."""
    di, g, n, h, conv_ch = _shapes(cfg)
    b, r, hp = x.shape[0], h // g, cfg.ssm_head_dim
    with span("block.norm", index):
        xn = cm.norm_apply(p["ln"], x, cfg.norm, cfg.norm_eps)
    with span("block.mamba", index):
        z, xBC, dt_raw = _split_proj(cfg, cm.dense(p["in_proj"], xn))
        window = torch.cat([state["conv"], xBC.to(state["conv"].dtype)], dim=1)  # (b, w, ch)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(window.dtype)) + p["conv_b"]
        xBC = F.silu(conv_out)[:, None, :]
        xs, Bm, Cm, dt_f, A = _ssm_inputs(cfg, xBC, dt_raw, p)
        x_t, dt_t = xs[:, 0].float(), dt_f[:, 0]  # (b,h,p), (b,h)
        B_t, C_t = Bm[:, 0].float(), Cm[:, 0].float()  # (b,g,n)
        dA = torch.exp(dt_t * A)
        dBx = torch.einsum("bgn,bgrp->bgrpn", B_t, (x_t * dt_t[..., None]).view(b, g, r, hp))
        new_ssm = state["ssm"] * dA[..., None, None] + dBx.reshape(b, h, hp, n)
        y = torch.einsum("bgrpn,bgn->bgrp", new_ssm.view(b, g, r, hp, n), C_t)
        y = y.reshape(b, h, hp).to(x.dtype) + p["D"][None, :, None].to(x.dtype) * xs[:, 0]
        state["conv"].copy_(window[:, 1:, :])
        state["ssm"].copy_(new_ssm)
        return _gated_out(cfg, p, y[:, None], z, x)


# =============================================================================
# Mamba2 language model (attention-free)
# =============================================================================


def init_mamba_lm(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    dt = getattr(torch, cfg.param_dtype)
    v, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": {"table": tf.trunc_normal(generator, (v, d), d ** -0.5, dt, device)},
        "ln_f": tf.norm_params((d,), cfg.norm, dt, device),
        "head": {"w": tf.trunc_normal(generator, (d, v), 1.0 / math.sqrt(d), dt, device)},
        "layers": init_mamba_block(cfg, generator, device, (cfg.n_layers,)),
    }


def mamba_lm_hidden(cfg: ArchConfig, params: dict, batch: dict):
    """Final hidden states (before ``ln_f``), each layer under the
    config's remat, and ``aux = 0``."""
    x = tf.embed_tokens(cfg, params, batch["tokens"])
    body = tf._remat(cfg, lambda p, x: mamba_block_apply(cfg, p, x))
    for p in tf.unbind_layers(params["layers"], cfg.n_layers):
        x = body(p, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def mamba_lm_forward(cfg: ArchConfig, params: dict, batch: dict):
    x, aux = mamba_lm_hidden(cfg, params, batch)
    return tf.lm_logits(cfg, params, x), aux


def mamba_lm_init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, device="cuda") -> dict:
    return {"layers": init_mamba_state(cfg, batch, (cfg.n_layers,), device),
            "len": torch.zeros((), dtype=torch.long, device=device)}


def mamba_lm_prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int = 0,
                     cache=None, last_idx: Optional[torch.Tensor] = None):
    """Run the prompt; return ``(last_logits, cache)``, writing the
    per-layer states into ``cache`` when one is given.  ``last_idx`` (B,):
    each row's last real position of a right-padded batch, where its state
    stops and its seed logits are read (:func:`mamba_block_prefill`)."""
    with span("model.embed"):
        x = tf.embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    if cache is None:
        cache = mamba_lm_init_cache(cfg, b, max_len, device=x.device)
    valid_len = None if last_idx is None else last_idx.long() + 1
    for i in range(cfg.n_layers):
        x, st = mamba_block_prefill(cfg, tf.layer(params["layers"], i), x, valid_len, i)
        cache["layers"]["conv"][i, :b] = st["conv"]
        cache["layers"]["ssm"][i, :b] = st["ssm"]
    cache["len"].fill_(s)
    return tf.last_logits(cfg, params, x, last_idx), cache


def mamba_lm_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """One token for every sequence; the states advance in place (a
    right-padded prefill left each row's state at its own length)."""
    x = tf.embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        x = mamba_block_decode(cfg, tf.layer(params["layers"], i),
                               tf.layer(cache["layers"], i), x, i)
    cache["len"].add_(1)
    return tf.lm_logits(cfg, params, x), cache
