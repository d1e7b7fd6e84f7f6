"""Unified model API — ``Model(cfg)`` gives init / logits / hidden / loss /
prefill / decode for every family of the zoo (dense, vlm, moe, encdec, ssm,
hybrid), dispatching as the JAX package's ``Model`` does, on the card
unless the caller asks for ``device="cpu"`` (or ``device="meta"``, where
a dry run traces a step without allocating anything).  ``batch_specs``,
``abstract_params`` and ``abstract_cache`` give the dry run's inputs on
``meta``.  The modality frontends are
stubs, as in the reference: ``frontend_embeds`` / ``enc_frames`` arrive
as precomputed embeddings."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
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
        model's device (the CPU's for ``meta``, which has none) seeded with
        ``seed``."""
        gen_dev = "cpu" if torch.device(self.device).type == "meta" else self.device
        gen = generator or torch.Generator(device=gen_dev).manual_seed(seed)
        c = self.cfg
        if c.family in _ATTN:
            return tf.init_params(c, gen, self.device)
        if c.family == "ssm":
            return mb.init_mamba_lm(c, gen, self.device)
        return hy.init_hybrid_params(c, gen, self.device)

    def abstract_params(self) -> dict:
        """The parameter tree on ``meta``: every leaf's shape and type,
        nothing allocated (the reference's ``jax.eval_shape`` of
        ``init_params``)."""
        return dataclasses.replace(self, device="meta").init_params()

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
        for the seed logits (bucket-padded serving); in the SSM and hybrid
        families each row's recurrent state also stops there, taking in
        none of its pad tokens.  ``cache``: an :meth:`init_cache` to write
        into (a new one otherwise)."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.prefill(c, params, batch, max_len, last_idx=last_idx, cache=cache)
        if c.family == "ssm":
            return mb.mamba_lm_prefill(c, params, batch, max_len, cache=cache, last_idx=last_idx)
        return hy.hybrid_prefill(c, params, batch, max_len, cache=cache, last_idx=last_idx)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        c = self.cfg
        if c.family in _ATTN:
            return tf.init_cache(c, batch_size, max_len, device=self.device)
        if c.family == "ssm":
            return mb.mamba_lm_init_cache(c, batch_size, max_len, device=self.device)
        return hy.hybrid_init_cache(c, batch_size, max_len, device=self.device)

    def abstract_cache(self, batch_size: int, max_len: int) -> dict:
        """The cache tree of :meth:`init_cache` on ``meta``."""
        return dataclasses.replace(self, device="meta").init_cache(batch_size, max_len)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One greedy step: ``(logits (B, 1, V), cache)``, the cache
        advanced in place on the device."""
        c = self.cfg
        if c.family in _ATTN:
            return tf.decode_step(c, params, cache, tokens)
        if c.family == "ssm":
            return mb.mamba_lm_decode_step(c, params, cache, tokens)
        return hy.hybrid_decode_step(c, params, cache, tokens)

    # -- dry-run input specs --------------------------------------------------
    def batch_specs(self, shape: ShapeSpec) -> dict:
        """One step's data inputs as empty ``meta`` tensors, the reference's
        names, shapes and types: int32 tokens (and labels for training),
        a VLM's ``frontend_embeds`` and an encoder-decoder's ``enc_frames``
        in the compute type; decode takes one token a sequence."""
        c = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        emb_dt = getattr(torch, c.compute_dtype)
        specs: dict = {}
        if shape.kind in ("train", "prefill"):
            n_front = c.n_frontend_tokens if c.frontend != "none" else 0
            s_text = s - n_front
            specs["tokens"] = spec((b, s_text), torch.int32)
            if shape.kind == "train":
                specs["labels"] = spec((b, s_text), torch.int32)
            if n_front:
                specs["frontend_embeds"] = spec((b, n_front, c.d_model), emb_dt)
            if c.family == "encdec":
                specs["enc_frames"] = spec((b, c.encoder_len, c.d_model), emb_dt)
        else:  # decode: one new token against a seq_len-deep cache
            specs["tokens"] = spec((b, 1), torch.int32)
        return specs

    def supports_shape(self, shape: ShapeSpec) -> tuple[bool, str]:
        c = self.cfg
        if shape.name == "long_500k" and c.family not in ("ssm", "hybrid"):
            return False, "full quadratic attention: 512k KV cache skipped per assignment"
        return True, ""
