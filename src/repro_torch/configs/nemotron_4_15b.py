"""nemotron-4-15b — dense GQA decoder with squared-ReLU MLP and
LayerNorm.  [arXiv:2402.16819]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="squared_relu",
    norm="layernorm",
    rope_theta=1e4,
    optimizer="adamw",
)
