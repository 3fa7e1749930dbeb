"""BLOOM-176B — the paper's largest evaluation model (Fig. 12b)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bloom-176b",
    family="dense",
    num_layers=70,
    d_model=14336,
    num_heads=112,
    num_kv_heads=112,
    head_dim=128,
    d_ff=57344,
    vocab_size=250880,
    activation="gelu",
    norm="layernorm",
    pos_emb="alibi",
    max_seq_len=2048,
    source="BigScience (paper baseline)",
)
