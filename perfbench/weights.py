"""Seeded random weights, made on the device in a few large calls.

The tree has the layout the serving engine takes (layers stacked on axis
0, weights ``(d_in, d_out)``, experts ``(E, d_in, d_out)``), and the same
tensors go to the engine and to the plain reference.  Every bf16 leaf is
a view into one flat buffer of the type the
configuration serves (``torch_dtype``) filled by a handful of ``normal_`` calls from
one ``torch.Generator`` on the device, then scaled in place: weights by
``1/sqrt(d_in)``, the embedding by ``1/sqrt(d)``, biases by 0.1, and norm
scales to ``1 + 0.1·N(0, 1)`` so that a scale left out shows.  The router
is float32, as the engine keeps it.  :func:`refill` draws a new seed into
the same tensors, so an engine whose graphs hold their addresses serves
the new weights.
"""

from __future__ import annotations

import math

import torch

from .work import widths_of

__all__ = ["make_params", "refill"]

_ALIGN = 256  # elements: every leaf starts on a 512-byte boundary
_CHUNK = 1 << 30  # elements a normal_ call fills


def _layout(config: dict, padded_vocab: int) -> list[tuple[tuple, tuple, str, float]]:
    """``(path, shape, kind, scale)`` of every leaf: kind ``w`` (scaled
    normal), ``norm`` (1 + scale·normal) or ``router`` (float32)."""
    w = widths_of(config)
    n, d, hd, f = w.n_layers, w.d_model, w.head_dim, w.d_ff
    h, kv = w.n_heads, w.n_kv_heads
    leaves = [
        (("embed", "table"), (padded_vocab, d), "w", d ** -0.5),
        (("ln_f", "scale"), (d,), "norm", 0.1),
        (("head", "w"), (d, padded_vocab), "w", d ** -0.5),
        (("layers", "ln1", "scale"), (n, d), "norm", 0.1),
        (("layers", "ln2", "scale"), (n, d), "norm", 0.1),
    ]
    for name, d_in, d_out in (("wq", d, h * hd), ("wk", d, kv * hd), ("wv", d, kv * hd),
                              ("wo", h * hd, d)):
        leaves.append((("layers", "attn", name, "w"), (n, d_in, d_out), "w", d_in ** -0.5))
        if name != "wo" and config.get("attention_bias"):
            leaves.append((("layers", "attn", name, "b"), (n, d_out), "w", 0.1))
    if w.moe:
        e = w.n_experts
        leaves += [
            (("layers", "mlp", "router", "w"), (n, d, e), "router", d ** -0.5),
            (("layers", "mlp", "wi"), (n, e, d, f), "w", d ** -0.5),
            (("layers", "mlp", "wg"), (n, e, d, f), "w", d ** -0.5),
            (("layers", "mlp", "wo"), (n, e, f, d), "w", f ** -0.5),
        ]
    else:
        leaves += [
            (("layers", "mlp", "wi", "w"), (n, d, f), "w", d ** -0.5),
            (("layers", "mlp", "wg", "w"), (n, d, f), "w", d ** -0.5),
            (("layers", "mlp", "wo", "w"), (n, f, d), "w", f ** -0.5),
        ]
    return leaves


def _fill(buf: torch.Tensor, gen: torch.Generator) -> None:
    flat = buf.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        flat[i:i + _CHUNK].normal_(generator=gen)


def make_params(config: dict, seed: int, device, padded_vocab: int) -> tuple[dict, dict]:
    """The weights of ``config`` drawn from ``seed`` on ``device``:
    ``(tree, buffers)``, the flat buffers the leaves are views of."""
    leaves = _layout(config, padded_vocab)
    served = getattr(torch, config["torch_dtype"])
    sizes = {served: 0, torch.float32: 0}
    offsets = []
    for _, shape, kind, _ in leaves:
        dt = torch.float32 if kind == "router" else served
        offsets.append((dt, sizes[dt]))
        sizes[dt] += -(-math.prod(shape) // _ALIGN) * _ALIGN
    bufs = {dt: torch.empty(sz, dtype=dt, device=device) for dt, sz in sizes.items()}
    tree: dict = {}
    for (path, shape, _, _), (dt, off) in zip(leaves, offsets):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = bufs[dt][off:off + math.prod(shape)].view(shape)
    refill(config, tree, bufs, seed)
    return tree, bufs


def refill(config: dict, tree: dict, bufs: dict, seed: int) -> None:
    """Draw ``seed``'s weights into ``tree`` (views of ``bufs``) in place."""
    gen = torch.Generator(device=bufs[torch.float32].device).manual_seed(seed & (2 ** 64 - 1))
    for buf in bufs.values():
        _fill(buf, gen)
    padded_vocab = tree["embed"]["table"].shape[0]
    for path, _, kind, scale in _layout(config, padded_vocab):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if kind == "norm":
            leaf.mul_(scale).add_(1.0)
        else:
            leaf.mul_(scale)
