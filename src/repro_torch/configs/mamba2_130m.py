"""mamba2-130m — attention-free SSD (state-space duality) LM.
Runs long_500k (O(1)-in-sequence recurrent state).  [arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,  # attention-free; unused
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    tie_embeddings=True,
    norm="rmsnorm",
    optimizer="adamw",
)
