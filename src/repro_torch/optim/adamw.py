"""AdamW with mixed-precision master weights (the twin of
``repro/optim/adamw.py``).

When params are bf16 the optimizer keeps f32 master copies and casts
back after each update; ``m``/``v`` are f32.  The state tree is the
reference's, ``{step, m, v[, master]}``.  Unlike the reference, which
returns new arrays, :meth:`AdamW.update` writes the new params and state
into the tensors it is given (one copy of each on the card, and two
transients the size of the largest leaf) and returns those same trees.

As in the reference, every leaf of two or more dims is decayed, the
stacked ``(L, d)`` norm scales included; the unstacked ``ln_f`` is not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["AdamW", "clip_by_global_norm", "global_norm"]


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf, summed leaf by leaf in JAX's order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to at most max_norm, its norm before)``; each leaf
    scaled in f32 and cast back to its type."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        dev = leaves[0].device
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params),
        }
        # master weights only for low-precision params
        if any(p.dtype != torch.float32 for p in leaves):
            state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
        return state

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step, in place: returns ``(params, state)``, the trees given."""
        step = state["step"] + 1
        t = step.to(torch.float32)
        lr = _lr_at(self.lr, step)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        masters = state.get("master")

        def upd(p, g, m, v, master=None):
            # each product rounded on its own, as the reference's are (a
            # fused multiply-add would round once and differ in the last bit)
            g32 = g.float()
            m.mul_(b1).add_(g32 * (1 - b1))
            g2 = g32 * (1 - b2)
            v.mul_(b2).add_(g2.mul_(g32))
            del g32, g2
            base = master if master is not None else p
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if p.ndim >= 2:  # decay matrices only (the unstacked ln_f is exempt)
                delta.add_(base * self.weight_decay)
            base.sub_(delta.mul_(lr))
            if master is not None:
                p.copy_(master)

        if masters is None:
            tree_map(upd, params, grads, state["m"], state["v"])
        else:
            tree_map(upd, params, grads, state["m"], state["v"], masters)
        state["step"] = step
        return params, state
