"""GPT2-1.5B — the paper's failure-recovery illustration model (Fig. 4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-1.5b",
    family="dense",
    num_layers=48,
    d_model=1600,
    num_heads=25,
    num_kv_heads=25,
    head_dim=64,
    d_ff=6400,
    vocab_size=50257,
    activation="gelu",
    norm="layernorm",
    pos_emb="learned",
    max_seq_len=2048,
    tie_embeddings=True,
    source="paper Fig. 4 model",
)
