"""ArchConfig — one declarative record per architecture, the twin of the
JAX package's.

Every architecture is a concrete instance of this dataclass in
``repro_torch/configs/<id>.py``; CPU tests shrink the same record with
``reduced()``, exactly as the JAX package's does.  The config also gives
the distinct GEMM workloads the arch executes (``gemm_workloads``), the
hook the tuner uses to tune a whole model.  Fields that name the JAX
package's mesh and compiler (``remat``, ``scan_layers``,
``dryrun_grad_accum``, ``moe_shard``, ``moe_impl``) are kept so both
records compare field for field; on one card the port reads none of
them (every MoE config runs ``models.transformer.moe_apply``).

``layer_pattern`` is the port's own field (the JAX package's record has
none): one character a layer, ``M`` a Mamba-2 mixer, ``-`` an MLP and
``*`` an attention mixer, each a pre-norm layer with its residual add
(Nemotron-H's ``hybrid_override_pattern``, run by ``models/hybrid.py``).
Empty, as in every registry config, keeps each family's own layout.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "LAYER_KINDS"]

#: the kinds of layer a ``layer_pattern`` names: Mamba-2, MLP, attention
LAYER_KINDS = "M-*"


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
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # block details
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    pos_embed: str = "rope"  # rope | learned | sinusoidal | none
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    router_norm_topk: bool = True
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # hybrid (zamba2): one shared attention block applied every N mamba layers
    hybrid_attn_interval: int = 0
    # hybrid by layer (nemotron-h): "M" mamba, "-" mlp, "*" attention, one a
    # layer; "" keeps the family's layout
    layer_pattern: str = ""

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 1500

    # modality frontend (stubbed per assignment: precomputed embeddings)
    frontend: str = "none"  # none | vision_patches | audio_frames
    n_frontend_tokens: int = 0  # e.g. anyres patch embeddings per sample

    # numerics / runtime
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # none | dots | full  (full: save only block inputs)
    #: prompts longer than this run the flash kernel (or, where it cannot
    #: take them, chunked attention) in prefill
    attn_chunk_threshold: int = 2048
    vocab_pad_multiple: int = 2048
    scan_layers: bool = True  # False: unroll (dry-run probes use this so
    #                            cost_analysis counts every layer)
    dryrun_grad_accum: int = 1  # microbatching in the dry-run train step

    # MoE sharding strategy of the JAX package's mesh: "ep" or "tp"
    moe_shard: str = "ep"
    # MoE dispatch of the JAX package's mesh: "gspmd" or "a2a" (its
    # shard_map all-to-all); on one card every MoE config takes moe_apply
    moe_impl: str = "gspmd"

    # ----------------------------------------------------------------------
    def __post_init__(self):
        if self.layer_pattern and (set(self.layer_pattern) - set(LAYER_KINDS)
                                   or len(self.layer_pattern) != self.n_layers):
            raise ValueError(f"layer_pattern {self.layer_pattern!r}: one of "
                             f"{LAYER_KINDS!r} for each of the {self.n_layers} layers")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_counts(self) -> dict[str, int]:
        """Layers of each kind of ``layer_pattern`` (all of ``LAYER_KINDS``)."""
        return {k: self.layer_pattern.count(k) for k in LAYER_KINDS}

    def _pattern_layer_params(self) -> dict[str, int]:
        """Parameters of one layer of each kind of ``layer_pattern``, its
        pre-norm included: a Mamba-2 mixer (projections, conv and its
        bias, ``A_log``, ``D``, ``dt_bias`` and the gated norm), an
        unbiased MLP, an unbiased attention."""
        d, hd = self.d_model, self.resolved_head_dim
        di, g, ns, h = self.d_inner, self.ssm_n_groups, self.ssm_state, self.ssm_heads
        conv_ch = di + 2 * g * ns
        gated = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return {
            "M": d + d * (2 * di + 2 * g * ns + h) + (self.ssm_conv_width + 1) * conv_ch
            + 3 * h + di + di * d,
            "-": d + gated * d * self.d_ff,
            "*": d + d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d,
        }

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.layer_pattern:
            per_kind = self._pattern_layer_params()
            return int(emb + d + sum(n * per_kind[k] for k, n in self.layer_counts().items()))
        per_layer = 0
        if self.family in ("dense", "vlm", "moe", "encdec"):
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
            o = self.n_heads * hd * d
            per_layer = qkv + o + 2 * d  # + norms
            if self.family == "moe":
                gated = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                per_layer += self.n_experts * gated * d * self.d_ff + d * self.n_experts
            else:
                gated = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                per_layer += gated * d * self.d_ff
        total = emb + self.n_layers * per_layer
        if self.family == "encdec":
            # encoder layers + cross attention in decoder
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
            o = self.n_heads * hd * d
            mlp = 2 * d * self.d_ff
            total += self.n_encoder_layers * (qkv + o + mlp + 2 * d)
            total += self.n_layers * (qkv + o + d)  # cross-attn in decoder
        if self.family in ("ssm", "hybrid"):
            di, g, ns = self.d_inner, self.ssm_n_groups, self.ssm_state
            h = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * ns + h)
            out_proj = di * d
            per = in_proj + out_proj + self.ssm_conv_width * (di + 2 * g * ns) + 3 * h + 2 * d
            total = emb + self.n_layers * per
            if self.family == "hybrid" and self.hybrid_attn_interval:
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                o = self.n_heads * hd * d
                mlp = 3 * d * self.d_ff
                total += qkv + o + mlp + 2 * d  # ONE shared block
        return int(total)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed experts only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        gated = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        all_experts = self.n_layers * self.n_experts * gated * d * self.d_ff
        active = self.n_layers * self.experts_per_token * gated * d * self.d_ff
        return self.n_params() - all_experts + active

    # ----------------------------------------------------------------------
    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
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
        if self.family == "moe":
            small.update(n_experts=4, experts_per_token=2)
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.family == "hybrid":
            small.update(hybrid_attn_interval=2)
        if self.layer_pattern:  # every layer of the pattern kept, each of its kind
            small.update(hybrid_attn_interval=0,
                         n_layers=len(overrides.get("layer_pattern", self.layer_pattern)))
        if self.family == "encdec":
            small.update(n_encoder_layers=2, encoder_len=32)
        if self.frontend != "none":
            small.update(n_frontend_tokens=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # ----------------------------------------------------------------------
    def gemm_workloads(self, batch: int, seq: int) -> list[tuple[int, int, int, str]]:
        """Distinct (M, K, N) GEMMs one block executes — the tuner's
        per-arch workload list (M = batch*seq tokens)."""
        t = batch * seq
        d, hd = self.d_model, self.resolved_head_dim
        out: list[tuple[int, int, int, str]] = []
        if self.layer_pattern:
            n = self.layer_counts()
            di, g, ns = self.d_inner, self.ssm_n_groups, self.ssm_state
            if n["M"]:
                out.append((t, d, 2 * di + 2 * g * ns + self.ssm_heads, "ssm_in"))
                out.append((t, di, d, "ssm_out"))
            if n["-"]:
                out.append((t, d, self.d_ff, "ffn_in"))
                out.append((t, self.d_ff, d, "ffn_out"))
            if n["*"]:
                out.append((t, d, (self.n_heads + 2 * self.n_kv_heads) * hd, "qkv"))
                out.append((t, self.n_heads * hd, d, "attn_out"))
            out.append((t, d, self.padded_vocab, "lm_head"))
            return out
        if self.family in ("dense", "vlm", "moe", "encdec"):
            out.append((t, d, (self.n_heads + 2 * self.n_kv_heads) * hd, "qkv"))
            out.append((t, self.n_heads * hd, d, "attn_out"))
            if self.family == "moe":
                cap = int(t * self.experts_per_token * self.moe_capacity_factor / self.n_experts)
                out.append((cap, d, self.d_ff, "expert_in"))
                out.append((cap, self.d_ff, d, "expert_out"))
                out.append((t, d, self.n_experts, "router"))
            else:
                out.append((t, d, self.d_ff, "ffn_in"))
                out.append((t, self.d_ff, d, "ffn_out"))
        else:  # ssm / hybrid
            di, g, ns = self.d_inner, self.ssm_n_groups, self.ssm_state
            out.append((t, d, 2 * di + 2 * g * ns + self.ssm_heads, "ssm_in"))
            out.append((t, di, d, "ssm_out"))
        out.append((t, d, self.padded_vocab, "lm_head"))
        return out
