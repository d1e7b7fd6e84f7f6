"""Logical sharding annotations — the model-facing slice of
``repro_torch.dist``, with the JAX package's names and signatures.

Models annotate tensors with *logical* dimension names
(``constrain(x, logical("dp", "sp", None))``) and never name mesh axes.
The JAX package maps those names onto a device mesh inside a
:func:`mesh_context`; the port runs on one card, where no mesh exists,
so :func:`current_mesh` is None and :func:`constrain` returns its input.
Keeping the calls lets a ported model read like its reference (the MoE
dispatch branches on ``current_mesh()`` as the reference's does).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Union

import torch

__all__ = [
    "MeshRules",
    "mesh_context",
    "current_mesh",
    "current_rules",
    "logical",
    "constrain",
]

#: a logical entry: a name, or None for "replicated along this dim"
LogicalName = Optional[str]
#: a physical mapping: one axis name, a tuple of axis names, or None
Physical = Union[str, tuple, None]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """logical name -> physical mesh axes (unused on one card; kept so a
    caller that passes rules reads as it does against the reference)."""

    overrides: Optional[dict] = None

    def get(self, name: Optional[str]) -> Physical:
        return None if name is None else (self.overrides or {}).get(name)


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[MeshRules] = None):
    """The reference's mesh scope.  One card has no mesh: the body runs
    unchanged and :func:`current_mesh` stays None."""
    if mesh is not None:
        raise ValueError("the port runs on one card: it has no device mesh")
    yield mesh


def current_mesh():
    return None


def current_rules() -> MeshRules:
    return MeshRules()


def logical(*names: LogicalName) -> tuple:
    """Package per-dim logical names (keeps call sites greppable)."""
    return names


def constrain(x: torch.Tensor, names: Sequence[LogicalName]) -> torch.Tensor:
    """Sharding annotation: the identity on one card."""
    return x
