"""Unified model API — ``Model(cfg)`` gives init / logits / prefill /
decode for a ported arch (the dense family so far), on the card unless
the caller asks for ``device="cpu"``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

__all__ = ["Model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family != "dense":
            raise NotImplementedError(f"{self.cfg.family} archs are not ported yet")
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model runs on the card and none is present; pass device='cpu'")

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0,
                    generator: Optional[torch.Generator] = None) -> dict:
        """Random weights from ``generator``, or from a fresh one on the
        model's device seeded with ``seed``."""
        gen = generator or torch.Generator(device=self.device).manual_seed(seed)
        return tf.init_params(self.cfg, gen, self.device)

    # -- forward --------------------------------------------------------------
    def logits(self, params: dict, batch: dict):
        return tf.forward_logits(self.cfg, params, batch)

    # -- serving --------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, max_len: int,
                last_idx: Optional[torch.Tensor] = None):
        """``last_idx`` (B,) selects each sequence's last real position
        for the seed logits (bucket-padded serving)."""
        return tf.prefill(self.cfg, params, batch, max_len, last_idx=last_idx)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        return tf.init_cache(self.cfg, batch_size, max_len, device=self.device)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        return tf.decode_step(self.cfg, params, cache, tokens)
