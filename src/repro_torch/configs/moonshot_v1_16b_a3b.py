"""Moonshot/Moonlight-16B-A3B — MoE 64 experts top-6. [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                   # per-expert ffn width
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    activation="silu",
    norm="rmsnorm",
    pos_emb="rope",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
