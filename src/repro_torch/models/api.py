"""Unified model API — ``Model(cfg)`` gives init / logits / hidden / loss /
prefill / decode for every family of the zoo (dense, vlm, moe, encdec, ssm,
hybrid), dispatching as the JAX package's ``Model`` does, on the card
unless the caller asks for ``device="cpu"``.  The modality frontends are
stubs, as in the reference: ``frontend_embeds`` / ``enc_frames`` arrive
as precomputed embeddings."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid as hy
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tf

__all__ = ["Model"]

_ATTN = ("dense", "vlm", "moe", "encdec")
_FAMILIES = _ATTN + ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family}")
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model runs on the card and none is present; pass device='cpu'")

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0,
                    generator: Optional[torch.Generator] = None) -> dict:
        """Random weights from ``generator``, or from a fresh one on the
        model's device seeded with ``seed``."""
        gen = generator or torch.Generator(device=self.device).manual_seed(seed)
        c = self.cfg
        if c.family in _ATTN:
            return tf.init_params(c, gen, self.device)
        if c.family == "ssm":
            return mb.init_mamba_lm(c, gen, self.device)
        return hy.init_hybrid_params(c, gen, self.device)

    # -- forward --------------------------------------------------------------
    def logits(self, params: dict, batch: dict):
        """``(logits (B, S, V), aux_loss)``."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.forward_logits(c, params, batch)
        if c.family == "ssm":
            return mb.mamba_lm_forward(c, params, batch)
        return hy.hybrid_forward(c, params, batch)

    def hidden(self, params: dict, batch: dict):
        """``(final hidden states (B, S, d) before ln_f, aux_loss)``."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.forward_hidden(c, params, batch)
        if c.family == "ssm":
            return mb.mamba_lm_hidden(c, params, batch)
        return hy.hybrid_hidden(c, params, batch)

    # -- training -------------------------------------------------------------
    def loss(self, params: dict, batch: dict):
        """Streaming (sequence-chunked) cross-entropy, never the whole
        ``(B, S, V)`` logits (``transformer.streaming_lm_loss``); a VLM's
        frontend positions are unsupervised.  ``(loss, metrics)``."""
        x, aux = self.hidden(params, batch)
        labels = tf.pad_labels(batch["labels"], x.shape[1])
        return tf.streaming_lm_loss(self.cfg, params, x, labels, aux)

    # -- serving --------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, max_len: int,
                last_idx: Optional[torch.Tensor] = None, cache: Optional[dict] = None):
        """``last_idx`` (B,) selects each sequence's last real position
        for the seed logits (bucket-padded serving); attention families
        only — SSM/hybrid state would take in the pad tokens, so the
        engine never pads those.  ``cache``: an :meth:`init_cache` to
        write into (a new one otherwise)."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.prefill(c, params, batch, max_len, last_idx=last_idx, cache=cache)
        if last_idx is not None:
            raise ValueError(f"family {c.family} does not support padded prefill")
        if c.family == "ssm":
            return mb.mamba_lm_prefill(c, params, batch, max_len, cache=cache)
        return hy.hybrid_prefill(c, params, batch, max_len, cache=cache)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        c = self.cfg
        if c.family in _ATTN:
            return tf.init_cache(c, batch_size, max_len, device=self.device)
        if c.family == "ssm":
            return mb.mamba_lm_init_cache(c, batch_size, max_len, device=self.device)
        return hy.hybrid_init_cache(c, batch_size, max_len, device=self.device)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One greedy step: ``(logits (B, 1, V), cache)``, the cache
        advanced in place on the device."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.decode_step(c, params, cache, tokens)
        if c.family == "ssm":
            return mb.mamba_lm_decode_step(c, params, cache, tokens)
        return hy.hybrid_decode_step(c, params, cache, tokens)
