"""zamba2-1.2b — hybrid: Mamba2 backbone + ONE shared attention block
applied every 6 mamba layers (parameter sharing).  Runs long_500k.
[arXiv:2411.15242]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,  # shared block is MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    hybrid_attn_interval=6,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
    optimizer="adamw",
)
