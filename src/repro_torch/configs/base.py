"""ArchConfig — one declarative record per architecture, carrying what
the tuner needs from it: the distinct GEMM workloads the arch executes
(``gemm_workloads``).  Only dense decoders are ported so far."""

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
    norm: str = "rmsnorm"
    mlp_kind: str = "swiglu"
    rope_theta: float = 1e6
    optimizer: str = "adamw"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 2048

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

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
