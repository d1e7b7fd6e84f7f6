"""whisper-tiny — encoder-decoder; conv audio frontend is a stub
(``enc_frames`` arrive as precomputed frame embeddings).
[arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_encoder_layers=4,
    encoder_len=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_kind="gelu",
    norm="layernorm",
    pos_embed="learned",
    frontend="audio_frames",
    optimizer="adamw",
)
