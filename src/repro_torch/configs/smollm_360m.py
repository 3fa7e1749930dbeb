"""SmolLM-360M — llama-arch small dense GQA LM. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    activation="silu",
    norm="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M; hf",
)
