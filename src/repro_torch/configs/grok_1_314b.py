"""grok-1-314b — 8-expert top-2 MoE decoder with attention-logit
softcapping.  Experts are TP-sharded (8 experts < 16-way model axis, so
each expert's FFN is split instead).  [hf:xai-org/grok-1]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,  # per-expert FFN width
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    router_norm_topk=True,
    moe_shard="tp",
    moe_impl="a2a",  # the JAX package's all-to-all dispatch on a mesh
    attn_softcap=30.0,
    mlp_kind="geglu",  # gated: matches the published 314B total
    norm="rmsnorm",
    rope_theta=1e4,
    optimizer="adafactor",  # 314B params: factored second moment
)
