"""Train / serve step factories (the twin of ``repro/train/step.py``).

``make_train_step`` builds the step: the loss and its gradients
(``torch.autograd.grad`` over the parameter leaves, in the JAX package's
leaf order), optional microbatched accumulation in f32 over dim 0 (the
reference's ``lax.scan`` is a loop), the global-norm clip, and the
optimizer's update, which writes the new params and state in place.
Each part runs under a span (``utils/spans.py``: ``train.grads``,
``train.clip``, ``train.update``) that a profiler trace shows.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import Model
from repro_torch.optim import clip_by_global_norm
from repro_torch.utils.spans import span
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["value_and_grad", "make_train_step", "make_prefill_step", "make_decode_step"]


def value_and_grad(model: Model, params: dict, batch: dict):
    """``(grads, metrics)`` of ``model.loss``: the gradient of every
    parameter leaf in its own type (zeros for a leaf the loss does not
    use), and the metrics detached."""
    leaves = tree_leaves(params)
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return tree_unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, optimizer, grad_accum: int = 1, clip_norm: float = 1.0):
    def train_step(params, opt_state, batch):
        with span("train.grads"):
            if grad_accum <= 1:
                grads, metrics = value_and_grad(model, params, batch)
            else:
                # microbatches along dim 0, their gradients summed in f32
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                ms = []
                for i in range(grad_accum):
                    mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                          for k, v in batch.items()}
                    g, m = value_and_grad(model, params, mb)
                    tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                    ms.append(m)
                    del g
                grads = tree_map(lambda g: g / grad_accum, grads)
                metrics = {k: torch.stack([m[k] for m in ms]).to(torch.float32).mean(dim=0)
                           for k in ms[0]}
        with span("train.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        with span("train.update"):
            params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
