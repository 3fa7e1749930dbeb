"""InternLM2-1.8B — dense GQA LM. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    activation="silu",
    norm="rmsnorm",
    pos_emb="rope",
    source="arXiv:2403.17297; hf",
)
