"""ArchConfig — one declarative record per architecture, carrying what
the tuner needs from it (the distinct GEMM workloads the arch executes,
``gemm_workloads``) and what the dense model reads.  ``reduced()``
shrinks the same record for CPU tests, exactly as the JAX package's
does.  Only dense decoders are ported so far."""

from __future__ import annotations

import dataclasses

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_kind: str = "swiglu"  # swiglu | geglu | squared_relu | gelu
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    pos_embed: str = "rope"  # only rope is ported
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    optimizer: str = "adamw"
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    #: prompts longer than this run the flash kernel in prefill
    attn_chunk_threshold: int = 2048
    vocab_pad_multiple: int = 2048

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the JAX package's
        ``reduced()`` for a dense arch)."""
        if self.family != "dense":
            raise NotImplementedError(f"{self.family} archs are not ported yet")
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            vocab_pad_multiple=64,
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk_threshold=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def gemm_workloads(self, batch: int, seq: int) -> list[tuple[int, int, int, str]]:
        """Distinct (M, K, N) GEMMs one block executes, plus the LM head —
        the tuner's per-arch workload list (M = batch*seq tokens)."""
        if self.family != "dense":
            raise NotImplementedError(f"{self.family} archs are not ported yet")
        t = batch * seq
        d, hd = self.d_model, self.resolved_head_dim
        return [
            (t, d, (self.n_heads + 2 * self.n_kv_heads) * hd, "qkv"),
            (t, self.n_heads * hd, d, "attn_out"),
            (t, d, self.d_ff, "ffn_in"),
            (t, self.d_ff, d, "ffn_out"),
            (t, d, self.padded_vocab, "lm_head"),
        ]
