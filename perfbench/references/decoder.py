"""Plain PyTorch reference of a pre-norm decoder (Qwen2 dense, Qwen3 MoE)
as it is served: float32 throughout, with TF32 off.

It imports nothing of the program.  It reads the configuration's file
(the published ``config.json`` keys, and ``serving`` for what the engine
adds to the published model) and the weights the benchmark made, and it
recomputes from them, layer by layer, the logits that decide each served
token.

The equations, for each layer::

    h = rmsnorm(x) · ln1;  q, k, v = h·Wq + bq, h·Wk + bk, h·Wv + bv
    rope(q, k) at each token's position (rotate-half, θ = rope_theta)
    a = softmax(q·kᵀ / √hd over the visible keys) · v   (GQA: kv heads shared)
    x = x + a·Wo;  h = rmsnorm(x) · ln2
    dense: x = x + (silu(h·Wg) ⊙ h·Wi)·Wo
    MoE:   p = softmax(h·Wr); the top k experts, weights renormalized to sum 1;
           x = x + Σ over the kept picks of w · expert(h)

and at the end ``logits = rmsnorm(x) · ln_f · W_head`` over the published
vocabulary.

**As served.**  The engine serves a batch in two stages: a prefill of every
row right-padded to the prompt bucket, then one decode step for all rows
a token.  Teacher-forced with the served tokens, the reference computes
every stage at once, layer by layer: a row's sequence is its prompt slots
and then its decoded tokens, a prompt slot sees the slots before it, and
a decoded token sees its row's real prompt and the decoded tokens up to
itself (pad slots masked), at positions that continue from the row's
real length.  Where experts have a capacity (``serving.capacity_factor``),
the rows of a batch share it, stage by stage, as in the engine: each
stage (the prefill, then each decode step) is one group of tokens; an
expert keeps, of the picks made of it in a group, the first
``int(k · tokens · capacity_factor / E)`` in token order (at least one),
and drops the rest.  Then pad slots route too, so the whole padded batch
is computed (``coupled``); a dense model computes only the real tokens.

**Precision.**  ``precision="f32"`` is the reference.  ``"fp8"`` is the
control: every weight product (the projections, the experts, the head)
on operands rounded to float8 e4m3, activations scaled per row and
weights per column to the format's largest value, everything else as the
reference.
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["couples_batch", "served_gaps"]

_Q_CHUNK = 512  # query rows of one attention block
_T_CHUNK = 8192  # tokens of one FFN block
_H_CHUNK = 1024  # positions of one head block
_FP8_MAX = 448.0  # largest float8 e4m3 value


def couples_batch(config: dict) -> bool:
    """True where the rows of a batch share expert capacity."""
    return config.get("num_experts", 0) > 0 and bool(
        config.get("serving", {}).get("capacity_factor"))


@contextlib.contextmanager
def _no_tf32():
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


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    if precision == "fp8":
        return _q8(x, -1) @ _q8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd); pos: (T,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Tokens:
    """The flat token list of a batch, row after row: each row's prompt
    slots, then its decoded tokens."""

    def __init__(self, prompts, lens, served, coupled: bool, device):
        b, bucket = prompts.shape
        g = served.shape[1]
        ids, pos, slot, row, group, order, starts = [], [], [], [], [], [], [0]
        self.prompt_slots, self.served_at = [], []
        for r in range(b):
            n_real = int(lens[r])
            p = bucket if coupled else n_real
            ids += prompts[r, :p].tolist() + served[r, :g - 1].tolist()
            pos += list(range(p)) + [n_real + j for j in range(g - 1)]
            slot += list(range(p + g - 1))
            row += [r] * (p + g - 1)
            group += [0] * p + list(range(1, g))
            order += [r * bucket + s for s in range(p)] + [r] * (g - 1)
            # served token 0 from the last real prompt slot, token j from decode slot j
            self.served_at += [starts[-1] + n_real - 1] + [starts[-1] + p + j for j in range(g - 1)]
            self.prompt_slots.append(p)
            starts.append(starts[-1] + p + g - 1)
        as_t = lambda v: torch.tensor(v, dtype=torch.long, device=device)  # noqa: E731
        self.ids, self.pos, self.slot = as_t(ids), as_t(pos), as_t(slot)
        self.row, self.group, self.order = as_t(row), as_t(group), as_t(order)
        self.served_at = as_t(self.served_at)
        self.starts, self.lens, self.n_groups = starts, [int(x) for x in lens], g
        self.group_sizes = torch.bincount(self.group, minlength=g).tolist()


def _attention(tk: _Tokens, q, k, v, n_kv: int) -> torch.Tensor:
    """Per row, each query over the keys it sees (see the module
    docstring).  q: (T, H, hd), k/v: (T, KV, hd)."""
    t, h, hd = q.shape
    g = h // n_kv
    out = torch.empty_like(q)
    for r in range(len(tk.lens)):
        a, b = tk.starts[r], tk.starts[r + 1]
        p, n_real = tk.prompt_slots[r], tk.lens[r]
        slots = tk.slot[a:b]
        key_ok = (slots < n_real) | (slots >= p)
        for c0 in range(0, b - a, _Q_CHUNK):
            c1 = min(c0 + _Q_CHUNK, b - a)
            qs = q[a + c0:a + c1].reshape(c1 - c0, n_kv, g, hd)
            ks, vs = k[a:a + c1], v[a:a + c1]
            logits = torch.einsum("qkgd,skd->kgqs", qs, ks) / math.sqrt(hd)
            qslot = slots[c0:c1]
            vis = (slots[None, :c1] <= qslot[:, None]) & (
                (qslot[:, None] < p) | key_ok[None, :c1])
            logits = logits.masked_fill(~vis, float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            out[a + c0:a + c1] = torch.einsum("kgqs,skd->qkgd", probs, vs).reshape(c1 - c0, h, hd)
    return out


def _kept_picks(tk: _Tokens, top_e: torch.Tensor, n_exp: int, cf: float) -> torch.Tensor:
    """(T, k) bool: the picks their expert keeps.  In each group an expert
    keeps its first ``cap`` picks in token order."""
    t, k = top_e.shape
    grp = tk.group[:, None].expand(t, k)
    key = ((grp * n_exp + top_e) * (tk.order.max() + 1) + tk.order[:, None]).reshape(-1)
    srt = torch.argsort(key)
    seg = (grp * n_exp + top_e).reshape(-1)[srt]
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    idx = torch.arange(seg.numel(), device=seg.device)
    seg_start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[srt] = idx - seg_start
    caps = torch.tensor([max(1, int(k * n * cf / n_exp)) for n in tk.group_sizes],
                        device=top_e.device)
    return rank.view(t, k) < caps[grp]


def _moe(tk, config, mlp: dict, i: int, h: torch.Tensor, precision: str) -> torch.Tensor:
    n_exp, k = config["num_experts"], config["num_experts_per_tok"]
    probs = torch.softmax(h @ mlp["router"]["w"][i].float(), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if config.get("norm_topk_prob"):
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    cf = config.get("serving", {}).get("capacity_factor")
    kept = (_kept_picks(tk, top_e, n_exp, cf) if cf
            else torch.ones_like(top_e, dtype=torch.bool))
    out = torch.zeros_like(h)
    for e in range(n_exp):
        tok, choice = torch.nonzero((top_e == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = torch.nn.functional.silu(_mm(x, mlp["wg"][i, e], precision)) * _mm(
            x, mlp["wi"][i, e], precision)
        out.index_add_(0, tok, _mm(y, mlp["wo"][i, e], precision) * top_w[tok, choice][:, None])
    return out


def _dense_ffn(mlp: dict, i: int, h: torch.Tensor, precision: str) -> torch.Tensor:
    wi, wg, wo = (mlp[n]["w"][i].float() for n in ("wi", "wg", "wo"))
    out = torch.empty_like(h)
    for c0 in range(0, h.shape[0], _T_CHUNK):
        x = h[c0:c0 + _T_CHUNK]
        y = torch.nn.functional.silu(_mm(x, wg, precision)) * _mm(x, wi, precision)
        out[c0:c0 + _T_CHUNK] = _mm(y, wo, precision)
    return out


def _final_hidden(config: dict, params: dict, tk: _Tokens, precision: str) -> torch.Tensor:
    """rmsnorm(x)·ln_f at every served position: (positions, d)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    n_kv = config["num_key_value_heads"]
    hd = config.get("head_dim") or d // h
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    moe = config.get("num_experts", 0) > 0
    lay = params["layers"]
    x = params["embed"]["table"][tk.ids].float()
    for i in range(config["num_hidden_layers"]):
        hn = _rmsnorm(x, lay["ln1"]["scale"][i], eps)
        proj = {}
        for name in ("wq", "wk", "wv"):
            p = lay["attn"][name]
            proj[name] = _mm(hn, p["w"][i], precision)
            if "b" in p:
                proj[name] = proj[name] + p["b"][i].float()
        t = x.shape[0]
        q = _rope(proj["wq"].view(t, h, hd), tk.pos, theta)
        k = _rope(proj["wk"].view(t, n_kv, hd), tk.pos, theta)
        a = _attention(tk, q, k, proj["wv"].view(t, n_kv, hd), n_kv)
        del q, k, proj
        x = x + _mm(a.view(t, h * hd), lay["attn"]["wo"]["w"][i], precision)
        del a
        hn = _rmsnorm(x, lay["ln2"]["scale"][i], eps)
        if moe:
            x = x + _moe(tk, config, lay["mlp"], i, hn, precision)
        else:
            x = x + _dense_ffn(lay["mlp"], i, hn, precision)
        del hn
    return _rmsnorm(x[tk.served_at], params["ln_f"]["scale"], eps)


def _head_blocks(config: dict, params: dict, hid: torch.Tensor, precision: str):
    """Logits over the published vocabulary, ``_H_CHUNK`` positions at a time."""
    w = params["head"]["w"][:, :config["vocab_size"]].float()
    if precision == "fp8":
        w = _q8(w, 0)
    for c0 in range(0, hid.shape[0], _H_CHUNK):
        x = hid[c0:c0 + _H_CHUNK]
        yield c0, (_q8(x, -1) if precision == "fp8" else x) @ w


def served_gaps(config: dict, params: dict, prompts, lens, served, *, coupled: bool,
                control: bool = False, device="cuda") -> dict:
    """For each row and served token, ``best - logit(served)`` under the
    reference (``"gap"``, (rows, g)); with ``control``, also the
    reference's gap of the token the fp8 computation puts first at the
    same position (``"control_gap"``).  ``prompts`` (rows, bucket) right-
    padded, ``lens`` (rows,), ``served`` (rows, g): numpy or CPU ints."""
    prompts, served = torch.as_tensor(prompts), torch.as_tensor(served)
    b, g = served.shape
    with torch.no_grad(), _no_tf32():
        tk = _Tokens(prompts, torch.as_tensor(lens), served, coupled, device)
        want = served.reshape(-1).to(device)
        picks = None
        if control:
            hid = _final_hidden(config, params, tk, "fp8")
            picks = torch.empty_like(want)
            for c0, logits in _head_blocks(config, params, hid, "fp8"):
                picks[c0:c0 + logits.shape[0]] = logits.argmax(-1)
            del hid
        hid = _final_hidden(config, params, tk, "f32")
        out = {"gap": torch.empty(want.shape, dtype=torch.float32, device=device)}
        if control:
            out["control_gap"] = torch.empty_like(out["gap"])
        for c0, logits in _head_blocks(config, params, hid, "f32"):
            c1 = c0 + logits.shape[0]
            best = logits.max(-1).values
            out["gap"][c0:c1] = best - logits.gather(1, want[c0:c1, None])[:, 0]
            if control:
                out["control_gap"][c0:c1] = best - logits.gather(1, picks[c0:c1, None])[:, 0]
    return {k: v.view(b, g).cpu() for k, v in out.items()}
