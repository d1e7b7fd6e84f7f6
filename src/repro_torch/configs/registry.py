"""Architecture registry: ``--arch <id>`` resolution for the launchers.
Only yi-6b is ported so far."""

from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.yi_6b import CONFIG as _yi

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [_yi]}

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shape"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape '{name}'; available: {sorted(SHAPES)}")
    return SHAPES[name]
