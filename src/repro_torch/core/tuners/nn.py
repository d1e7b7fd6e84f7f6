"""Small PyTorch networks of the learned tuners (N-A2C's actor/critic
MLPs, the RNN controller's GRU and head) and their Adam state.

The arithmetic is the JAX package's (``repro/core/tuners/nn.py``):

* :class:`MLP` — linear layers with ``tanh`` between them, He-normal
  weights (std ``sqrt(2 / n_in)``) and zero biases;
* :class:`GRUCell` — the reference's cell, which is **not**
  ``torch.nn.GRUCell``: one bias per gate, added outside the reset gate
  (``cand = tanh(x·Wi_n + r·(h·Wh_n) + b_n)``), and the update gate
  weighs the candidate (``h' = (1 − z)·h + z·cand``);
* Adam as ``torch.optim.Adam`` with the reference's ``lr``, betas
  (0.9, 0.999) and eps 1e-8 — the same bias-corrected update.

Weights are drawn from an explicit ``torch.Generator`` on the host and
then moved to the tuner's device, so a CPU and a CUDA run start from the
same parameters.  :func:`params_from_reference` turns the reference's
``init_mlp`` / ``init_gru`` / ``init_linear`` trees (numpy arrays, ``w``
laid out ``(n_in, n_out)``) into these modules.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

__all__ = [
    "MLP",
    "GRUCell",
    "he_linear",
    "make_adam",
    "adam_state",
    "load_adam_state",
    "params_from_reference",
    "network_device",
]

#: Adam's moments decay rates and epsilon, as the reference's ``adam_update``
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def network_device(device) -> torch.device:
    """Where a learned tuner's networks run.  ``cuda`` without a card
    raises: nothing moves to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the tuner's networks were asked to run on {dev}, but no CUDA card "
            f"is available; pass device='cpu' to run them on the CPU"
        )
    return dev


def he_linear(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    """A linear layer with He-normal weights and a zero bias."""
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(n_out, n_in, generator=generator) * math.sqrt(2.0 / n_in))
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """Linear layers with ``tanh`` between them (none after the last)."""

    def __init__(self, sizes: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            he_linear(a, b, generator) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < last:
                x = torch.tanh(x)
        return x


class GRUCell(nn.Module):
    """The reference's GRU step (``repro/core/tuners/nn.py`` ``gru_step``),
    with its learned initial hidden state ``h0``.  Gate order in the
    packed weights is (reset, update, candidate)."""

    def __init__(self, n_in: int, n_hidden: int, generator: torch.Generator):
        super().__init__()
        self.n_hidden = n_hidden
        self.wi = nn.Linear(n_in, 3 * n_hidden, bias=False)
        self.wh = nn.Linear(n_hidden, 3 * n_hidden, bias=False)
        self.b = nn.Parameter(torch.zeros(3 * n_hidden))
        self.h0 = nn.Parameter(torch.zeros(n_hidden))
        with torch.no_grad():
            self.wi.weight.copy_(
                torch.randn(3 * n_hidden, n_in, generator=generator) * math.sqrt(1.0 / n_in)
            )
            self.wh.weight.copy_(
                torch.randn(3 * n_hidden, n_hidden, generator=generator)
                * math.sqrt(1.0 / n_hidden)
            )
            self.h0.copy_(torch.randn(n_hidden, generator=generator) * 0.01)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        nh = self.n_hidden
        xi, hh, b = self.wi(x), self.wh(h), self.b
        r = torch.sigmoid(xi[..., :nh] + hh[..., :nh] + b[:nh])
        z = torch.sigmoid(xi[..., nh:2 * nh] + hh[..., nh:2 * nh] + b[nh:2 * nh])
        cand = torch.tanh(xi[..., 2 * nh:] + r * hh[..., 2 * nh:] + b[2 * nh:])
        return (1.0 - z) * h + z * cand


# -- Adam -------------------------------------------------------------------------

def make_adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def adam_state(opt: torch.optim.Adam) -> dict:
    """The optimizer's moments in parameter order, in the reference's
    ``adam_init`` layout: ``{"m": [...], "v": [...], "t": steps}``."""
    params = [p for g in opt.param_groups for p in g["params"]]
    if not opt.state:
        zeros = [torch.zeros_like(p) for p in params]
        return {"m": zeros, "v": [z.clone() for z in zeros], "t": 0}
    st = [opt.state[p] for p in params]
    return {
        "m": [s["exp_avg"] for s in st],
        "v": [s["exp_avg_sq"] for s in st],
        "t": int(st[0]["step"]),
    }


def load_adam_state(opt: torch.optim.Adam, state: dict) -> None:
    """Inverse of :func:`adam_state` (moments as arrays or tensors)."""
    sd = opt.state_dict()
    t = int(state["t"])
    if t == 0:
        sd["state"] = {}
    else:
        sd["state"] = {
            i: {
                "step": torch.tensor(float(t)),
                "exp_avg": torch.as_tensor(np.asarray(m)),
                "exp_avg_sq": torch.as_tensor(np.asarray(v)),
            }
            for i, (m, v) in enumerate(zip(state["m"], state["v"]))
        }
    opt.load_state_dict(sd)  # casts the moments to each parameter's device


# -- parameters carried over from the reference ------------------------------------

def _linear_from(p: dict) -> nn.Linear:
    w = np.asarray(p["w"], np.float32)  # (n_in, n_out) in the reference
    lin = nn.Linear(w.shape[0], w.shape[1])
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        lin.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
    return lin


def params_from_reference(tree) -> nn.Module:
    """The port's module holding the reference's parameters: a list of
    ``{"w", "b"}`` layers (``init_mlp``) becomes an :class:`MLP`, a
    ``{"wi", "wh", "b", "h0"}`` dict (``init_gru``) a :class:`GRUCell`,
    one ``{"w", "b"}`` dict (``init_linear``) an ``nn.Linear``.  Leaves
    are numpy arrays (``np.asarray`` of the JAX arrays)."""
    if isinstance(tree, (list, tuple)):
        sizes = [np.shape(tree[0]["w"])[0]] + [np.shape(p["w"])[1] for p in tree]
        mlp = MLP(sizes, torch.Generator().manual_seed(0))
        mlp.layers = nn.ModuleList(_linear_from(p) for p in tree)
        return mlp
    if "wi" in tree:
        wi = np.asarray(tree["wi"], np.float32)
        wh = np.asarray(tree["wh"], np.float32)
        cell = GRUCell(wi.shape[0], wh.shape[0], torch.Generator().manual_seed(0))
        with torch.no_grad():
            cell.wi.weight.copy_(torch.tensor(wi.T))
            cell.wh.weight.copy_(torch.tensor(wh.T))
            cell.b.copy_(torch.tensor(np.asarray(tree["b"], np.float32)))
            cell.h0.copy_(torch.tensor(np.asarray(tree["h0"], np.float32)))
        return cell
    return _linear_from(tree)
