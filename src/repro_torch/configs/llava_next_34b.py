"""llava-next-34b — VLM: anyres-tiled vision frontend (stub) + dense GQA
LM backbone.  [hf:llava-hf/llava-v1.6; backbone sizes per assignment]

The frontend is a stub per the assignment: ``input_specs`` feeds
precomputed patch embeddings (anyres base grid 24x24 = 576 tokens); the
backbone below is the graded article.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=5e6,
    frontend="vision_patches",
    n_frontend_tokens=576,
    optimizer="adamw",
)
