"""Mamba2-780M — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]

No KV cache exists; the decode state is a fixed-size SSD state per layer.
DéjàVu's KV streaming generalizes to SSM-state streaming for this arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # attn-free, no MLP block (Mamba-2 backbone)
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    activation="silu",
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
