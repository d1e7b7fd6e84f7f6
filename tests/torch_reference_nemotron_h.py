"""Plain PyTorch reference of Nemotron-H (arXiv:2504.03624) as it is
served: float32 throughout, with TF32 off.  This is the copy the CPU
tests hold the port's pattern stack against; ``perfbench/references/
nemotron_h.py`` is the same forward pass, which the benchmark's check
runs on the card (the tests do not read a benchmark file a later change
to the benchmark may edit).

It imports nothing of the program and no kernel.  It reads the
configuration's file (the published ``config.json`` keys:
``hidden_size``, ``hybrid_override_pattern``, ``mamba_num_heads``,
``n_groups``, ...) and the weights the benchmark made, in the engine's
tree (layers of one kind stacked on axis 0 in pattern order: ``mamba``,
``mlp``, ``attn``; weights ``(d_in, d_out)``; the conv ``(width,
channels)``), and recomputes the logits that decide each served token.
``x`` is the residual stream:

* every layer ``i``: ``x = x + mixer_i(rmsnorm(x)·w_i)``;
* ``M``: ``z, xBC, dt = split(h·W_in)``; ``xBC = silu(causal depthwise
  conv(xBC) + b_conv)``, split into ``x`` (heads × head dim), ``B`` and
  ``C`` (groups × state), head ``k`` reading group ``k // (heads /
  groups)``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  ``S_t = exp(dt_t·A)·S_{t-1} + dt_t·x_t⊗B_t``, ``y_t = S_t·C_t + D·x_t``;
  ``out = rmsnorm_per_group(y ⊙ silu(z))·w_norm · W_out``;
* ``-``: ``relu(h·W_up)² · W_down``;
* ``*``: causal ``softmax(q·kᵀ/√hd)·v`` (GQA), no position embedding, ``·W_o``;
* the end: ``rmsnorm(x)·w_f · W_head`` over the published vocabulary.

The SSD is the Mamba-2 paper's chunked listing (arXiv:2405.21060,
Listing 1): B and C taken to every head, ``segsum`` decay blocks within
chunks, and the chunk states carried by a decay matrix over chunks.  A
sequence the chunk does not divide is padded at its end; every pad lies
after every real position, so causality leaves the real outputs exact.

**As served.**  Each row's sequence is its real prompt, then the tokens
it was served but the last (teacher-forced), in one causal pass: the
reference never sees a pad slot, so the engine's ragged prefill (its pad
masking) and its decode through the cache are held against a pass that
has neither.  Rows do not interact (:func:`couples_batch`).  The layers
run layer by layer over all the rows, each layer's weights taken to
float32 once.

**Precision.**  ``precision="f32"`` is the reference.  ``"fp8"`` is the
control: every weight product (the projections, the MLP, the head) on
operands rounded to float8 e4m3, activations scaled per row and weights
per column to the format's largest value, everything else as the
reference.

Departures: none from the equations.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["couples_batch", "served_gaps", "final_hidden", "logits", "no_tf32"]

_Q_CHUNK = 512  # query rows of one attention block
_H_CHUNK = 1024  # positions of one head block
_FP8_MAX = 448.0  # largest float8 e4m3 value


def couples_batch(config: dict) -> bool:
    """False: the rows of a batch do not interact."""
    return False


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled along ``dim`` to its range."""
    scale = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _weights(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A weight in float32, rounded to float8 per column for the control."""
    w = w.float()
    return _q8(w, 0) if precision == "fp8" else w


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` for a weight already taken by :func:`_weights`."""
    return (_q8(x, -1) if precision == "fp8" else x) @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``sum(a[j+1 .. i])`` at ``[i, j]``, i >= j;
    -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~keep, -math.inf)


def _ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
         block: int) -> torch.Tensor:
    """Listing 1 over one sequence: X (L, H, P) = x·dt, A (L, H) = dt·A,
    B, C (L, H, N).  Returns Y (L, H, P)."""
    length = X.shape[0]
    pad = -length % block
    X, A, B, C = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (X, A, B, C))
    c = X.shape[0] // block
    X, B, C = (t.reshape(c, block, *t.shape[1:]) for t in (X, B, C))
    A = A.reshape(c, block, -1).permute(2, 0, 1)  # (H, c, l)
    A_cs = torch.cumsum(A, dim=-1)
    # 1. within each chunk (the diagonal blocks)
    L = torch.exp(_segsum(A))  # (H, c, l, s)
    CB = torch.einsum("clhn,cshn->hcls", C, B)
    Y_diag = torch.einsum("hcls,cshp->clhp", CB * L, X)
    del CB, L
    # 2. each chunk's state
    decay_states = torch.exp(A_cs[:, :, -1:] - A_cs)  # (H, c, l)
    states = torch.einsum("clhn,clhp->chpn", B, X * decay_states.permute(1, 2, 0)[..., None])
    # 3. the recurrence over chunks
    states = torch.cat([torch.zeros_like(states[:1]), states])  # (c+1, H, P, N)
    decay_chunk = torch.exp(_segsum(F.pad(A_cs[:, :, -1], (1, 0))))  # (H, c+1, c+1)
    states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)[:-1]
    # 4. each chunk's entering state to its outputs
    Y_off = torch.einsum("clhn,chpn->clhp", C, states) * torch.exp(A_cs).permute(1, 2, 0)[
        ..., None]
    return (Y_diag + Y_off).reshape(c * block, *Y_diag.shape[2:])[:length]


def _mamba(config: dict, p: dict, i: int, w: dict, h: torch.Tensor,
           precision: str) -> torch.Tensor:
    heads, hd = config["mamba_num_heads"], config["mamba_head_dim"]
    g, n = config["n_groups"], config["ssm_state_size"]
    di, length = heads * hd, h.shape[0]
    z, xbc, dt = _mm(h, w["in"], precision).split([di, di + 2 * g * n, heads], dim=-1)
    width = config["conv_kernel"]
    conv_w = p["conv_w"][i].float()  # (width, channels)
    conv = F.conv1d(F.pad(xbc.T[None], (width - 1, 0)), conv_w.T[:, None, :],
                    bias=p["conv_b"][i].float(), groups=conv_w.shape[1])[0].T
    x, B, C = F.silu(conv).split([di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"][i].float())  # (L, H)
    A = -torch.exp(p["A_log"][i].float())
    x = x.reshape(length, heads, hd)
    B, C = (t.reshape(length, g, n).repeat_interleave(heads // g, dim=1) for t in (B, C))
    y = _ssd(x * dt[..., None], dt * A, B, C, config["chunk_size"])
    y = (y + p["D"][i].float()[:, None] * x).reshape(length, di) * F.silu(z)
    y = y.reshape(length, g, di // g)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + config["rms_norm_eps"])
    y = y.reshape(length, di) * p["norm"]["scale"][i].float()
    return _mm(y, w["out"], precision)


def _mlp(w: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    return _mm(torch.relu(_mm(h, w["wi"], precision)) ** 2, w["wo"], precision)


def _attention(config: dict, w: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    nh, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, length = config["attention_head_dim"], h.shape[0]
    q = _mm(h, w["wq"], precision).reshape(length, kv, nh // kv, hd)
    k = _mm(h, w["wk"], precision).reshape(length, kv, hd)
    v = _mm(h, w["wv"], precision).reshape(length, kv, hd)
    out = torch.empty_like(q)
    for c0 in range(0, length, _Q_CHUNK):
        c1 = min(c0 + _Q_CHUNK, length)
        s = torch.einsum("qkgd,skd->kgqs", q[c0:c1], k[:c1]) / math.sqrt(hd)
        qpos = torch.arange(c0, c1, device=h.device)
        s = s.masked_fill(torch.arange(c1, device=h.device)[None, :] > qpos[:, None],
                          -math.inf)
        out[c0:c1] = torch.einsum("kgqs,skd->qkgd", torch.softmax(s, dim=-1), v[:c1])
    return _mm(out.reshape(length, nh * hd), w["wo"], precision)


_KIND = {"M": ("mamba", {"in": ("in_proj", "w"), "out": ("out_proj", "w")}),
         "-": ("mlp", {"wi": ("wi", "w"), "wo": ("wo", "w")}),
         "*": ("attn", {n: (n, "w") for n in ("wq", "wk", "wv", "wo")})}


def final_hidden(config: dict, params: dict, rows: list, precision: str = "f32") -> list:
    """``rmsnorm(x)·w_f`` at every position of each row's ids (a list of
    (L,) tensors), layer by layer over all the rows: a list of (L, d)."""
    eps = config["rms_norm_eps"]
    xs = [params["embed"]["table"][ids].float() for ids in rows]
    seen = {"M": 0, "-": 0, "*": 0}
    for kind in config["hybrid_override_pattern"]:
        j = seen[kind]
        seen[kind] += 1
        group, names = _KIND[kind]
        p = params[group]
        w = {}
        for key, (a, b) in names.items():
            w[key] = _weights(p[a][b][j], precision)
        for r, x in enumerate(xs):
            h = _rmsnorm(x, p["ln"]["scale"][j], eps)
            if kind == "M":
                xs[r] = x + _mamba(config, p, j, w, h, precision)
            elif kind == "-":
                xs[r] = x + _mlp(w, h, precision)
            else:
                xs[r] = x + _attention(config, w, h, precision)
        del w
    return [_rmsnorm(x, params["ln_f"]["scale"], eps) for x in xs]


def _head_blocks(config: dict, params: dict, hid: torch.Tensor, precision: str):
    """Logits over the published vocabulary, ``_H_CHUNK`` positions at a time."""
    w = _weights(params["head"]["w"][:, :config["vocab_size"]], precision)
    for c0 in range(0, hid.shape[0], _H_CHUNK):
        yield c0, _mm(hid[c0:c0 + _H_CHUNK], w, precision)


def logits(config: dict, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """(L, vocab) float32 logits of one row's ``ids`` in one causal pass."""
    with torch.no_grad(), no_tf32():
        hid = final_hidden(config, params, [ids])[0]
        return torch.cat([lg for _, lg in _head_blocks(config, params, hid, "f32")])


def _served_hidden(config, params, prompts, lens, served, precision):
    """The final hidden state at each served token's position, row after
    row: (rows · g, d)."""
    g = served.shape[1]
    rows = [torch.cat([prompts[r, :int(n)], served[r, :g - 1]])
            for r, n in enumerate(lens.tolist())]
    hid = final_hidden(config, params, rows, precision)
    return torch.cat([h[int(n) - 1:] for h, n in zip(hid, lens.tolist())])


def served_gaps(config: dict, params: dict, prompts, lens, served, *, coupled: bool,
                control: bool = False, device="cuda") -> dict:
    """For each row and served token, ``best - logit(served)`` under the
    reference (``"gap"``, (rows, g)); with ``control``, also the
    reference's gap of the token the fp8 computation puts first at the
    same position (``"control_gap"``).  ``prompts`` (rows, bucket) right-
    padded, ``lens`` (rows,), ``served`` (rows, g): numpy or CPU ints.
    ``coupled`` is False for this model (:func:`couples_batch`)."""
    if coupled:
        raise ValueError("Nemotron-H's rows do not interact: coupled must be False")
    prompts = torch.as_tensor(prompts).to(device)
    served = torch.as_tensor(served)
    lens = torch.as_tensor(lens)
    b, g = served.shape
    with torch.no_grad(), no_tf32():
        want = served.reshape(-1).to(device)
        fed = served.to(device)
        picks = None
        if control:
            hid = _served_hidden(config, params, prompts, lens, fed, "fp8")
            picks = torch.empty_like(want)
            for c0, lg in _head_blocks(config, params, hid, "fp8"):
                picks[c0:c0 + lg.shape[0]] = lg.argmax(-1)
            del hid
        hid = _served_hidden(config, params, prompts, lens, fed, "f32")
        out = {"gap": torch.empty(want.shape, dtype=torch.float32, device=device)}
        if control:
            out["control_gap"] = torch.empty_like(out["gap"])
        for c0, lg in _head_blocks(config, params, hid, "f32"):
            c1 = c0 + lg.shape[0]
            best = lg.max(-1).values
            out["gap"][c0:c1] = best - lg.gather(1, want[c0:c1, None])[:, 0]
            if control:
                out["control_gap"][c0:c1] = best - lg.gather(1, picks[c0:c1, None])[:, 0]
    return {k: v.view(b, g).cpu() for k, v in out.items()}
