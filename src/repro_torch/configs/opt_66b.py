"""OPT-66B — the paper's primary evaluation model (Fig. 12a, 14, 15)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="opt-66b",
    family="dense",
    num_layers=64,
    d_model=9216,
    num_heads=72,
    num_kv_heads=72,
    head_dim=128,
    d_ff=36864,
    vocab_size=50272,
    activation="gelu",
    norm="layernorm",
    pos_emb="learned",
    max_seq_len=2048,
    source="arXiv:2205.01068 (paper baseline)",
)
