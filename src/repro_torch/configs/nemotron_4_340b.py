"""Nemotron-4-340B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",      # squared ReLU
    norm="layernorm",
    pos_emb="rope",
    source="arXiv:2402.16819; unverified",
)
