"""qwen3-moe-235b-a22b — 128-expert top-8 MoE decoder, GQA kv=4.
Expert-parallel sharding (8 experts per model-axis device on the 16-way
production mesh).  [hf:Qwen/Qwen3 family]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert FFN width
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    router_norm_topk=True,
    moe_shard="ep",
    moe_impl="a2a",  # the JAX package's all-to-all dispatch on a mesh
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    optimizer="adafactor",  # factored states keep per-chip optimizer bytes flat
)
