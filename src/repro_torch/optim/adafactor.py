"""Adafactor (Shazeer & Stern 2018) — factored second moments (the twin
of ``repro/optim/adafactor.py``).

Used for the two MoE giants (grok-1-314b, qwen3-moe-235b), where full
AdamW state would not fit; a matrix's factored state is O(rows + cols).
The state tree is the reference's, ``{step, factored}``.  Like the
port's :class:`~repro_torch.optim.adamw.AdamW`, :meth:`Adafactor.update`
writes the new params and state into the trees it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.optim.adamw import _lr_at
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Adafactor"]


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-30)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    decay: float = 0.8  # beta2 schedule: 1 - t^-decay
    eps1: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> dict:
        dev = tree_leaves(params)[0].device

        def leaf(p):
            f32 = dict(dtype=torch.float32, device=dev)
            if p.ndim >= 2:  # factor over the two trailing dims
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "factored": tree_map(leaf, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step, in place: returns ``(params, state)``, the trees given."""
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-self.decay)
        lr = _lr_at(self.lr, step)

        def upd(p, g, st):
            g = g.float()
            g2 = g * g + self.eps1
            if p.ndim >= 2:
                st["vr"] = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                st["vc"] = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                vr_norm = st["vr"] / torch.clamp(
                    torch.mean(st["vr"], dim=-1, keepdim=True), min=1e-30)
                u = g * torch.rsqrt(vr_norm)[..., None] * torch.rsqrt(st["vc"])[..., None, :]
            else:
                st["v"] = beta2 * st["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(st["v"])
            u = u / torch.clamp(_rms(u) / self.clip_threshold, min=1.0)
            base = p.float()
            if self.weight_decay and p.ndim >= 2:
                u = u + self.weight_decay * base
            p.copy_(base - lr * u)

        tree_map(upd, params, grads, state["factored"])
        state["step"] = step
        return params, state
