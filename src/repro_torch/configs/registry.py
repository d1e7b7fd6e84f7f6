"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.deepseek_67b import CONFIG as _deepseek
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _llava,
        _qwen2,
        _nemotron,
        _yi,
        _deepseek,
        _whisper,
        _qwen3moe,
        _grok,
        _mamba2,
        _zamba2,
    ]
}

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shape", "all_cells"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape '{name}'; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ArchConfig, ShapeSpec]]:
    """Every (architecture x input-shape) pair — 40 cells."""
    return [(a, s) for a in ARCHS.values() for s in SHAPES.values()]
