"""Seeded random weights, made on the device in a few large calls.

The leaves and how each is drawn are the architecture's
(``architectures/<name>.py``, ``layout``): ``(path, shape, dtype, scale,
offset)``, each leaf ``offset + scale·N(0, 1)`` in its dtype.  The same
tensors go to the engine and to the plain reference.  Every leaf is a
view into one flat buffer of its dtype (one a dtype, in the order the
layout first names them), filled by a handful of ``normal_`` calls from
one ``torch.Generator`` on the device, then scaled and offset in place.
:func:`refill` draws a new seed into the same tensors, so an engine whose
graphs hold their addresses serves the new weights.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_params", "refill"]

_ALIGN = 256  # elements: every leaf starts on a 512-byte boundary
_CHUNK = 1 << 30  # elements a normal_ call fills


def _fill(buf: torch.Tensor, gen: torch.Generator) -> None:
    flat = buf.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        flat[i:i + _CHUNK].normal_(generator=gen)


def make_params(leaves: list, seed: int, device) -> tuple[dict, dict]:
    """The weights of an architecture's ``leaves`` drawn from ``seed`` on
    ``device``: ``(tree, buffers)``, the flat buffers the leaves are views
    of, by dtype."""
    sizes: dict = {}
    offsets = []
    for _, shape, dtype, _, _ in leaves:
        dt = getattr(torch, dtype)
        offsets.append((dt, sizes.setdefault(dt, 0)))
        sizes[dt] += -(-math.prod(shape) // _ALIGN) * _ALIGN
    bufs = {dt: torch.empty(sz, dtype=dt, device=device) for dt, sz in sizes.items()}
    tree: dict = {}
    for (path, shape, _, _, _), (dt, off) in zip(leaves, offsets):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = bufs[dt][off:off + math.prod(shape)].view(shape)
    refill(leaves, tree, bufs, seed)
    return tree, bufs


def refill(leaves: list, tree: dict, bufs: dict, seed: int) -> None:
    """Draw ``seed``'s weights into ``tree`` (views of ``bufs``) in place."""
    device = next(iter(bufs.values())).device
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 64 - 1))
    for buf in bufs.values():
        _fill(buf, gen)
    for path, _, _, scale, offset in leaves:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        leaf.mul_(scale)
        if offset:
            leaf.add_(offset)
