"""Optimizers and LR schedules, the twins of ``repro/optim``."""

from repro_torch.utils.tree import tree_from_numpy

from .adafactor import Adafactor
from .adamw import AdamW, clip_by_global_norm, global_norm
from .schedules import constant, warmup_cosine, warmup_linear


def make_optimizer(name: str, lr, **kw):
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr, **kw)
    raise ValueError(f"unknown optimizer {name}")


__all__ = [
    "AdamW",
    "Adafactor",
    "clip_by_global_norm",
    "global_norm",
    "constant",
    "warmup_cosine",
    "warmup_linear",
    "make_optimizer",
    "opt_state_from_reference",
]



def opt_state_from_reference(tree, device="cuda") -> dict:
    """The JAX package's optimizer state (AdamW's ``{step, m, v[,
    master]}`` or Adafactor's ``{step, factored}``), its leaves given as
    numpy arrays, as the port's state on ``device``: the same tree, each
    leaf keeping its type."""
    return tree_from_numpy(tree, device)
