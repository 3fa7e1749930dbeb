"""Hymba-1.5B — hybrid parallel attention + Mamba heads. [arXiv:2411.13676; hf]

Each layer runs attention heads and SSM heads in PARALLEL on the same input
and mean-fuses the normalized outputs.  Most layers use sliding-window
attention (window=1024); layers (first, middle, last) use global attention.
128 learnable meta tokens are prepended to the context.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=1024,
    num_meta_tokens=128,
    full_attn_layers=(0, 15, 31),
    activation="silu",
    norm="rmsnorm",
    pos_emb="rope",
    source="arXiv:2411.13676; hf",
)
