"""Phi-3-vision-4.2B — phi3-mini backbone + CLIP frontend (STUB).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision tower is a STUB: callers pass precomputed patch embeddings
``patch_embeds [B, num_patches, d_model]``, which are projected and prepended
to the token embeddings; only the 32-layer transformer backbone is
implemented, as in the reference.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    activation="silu",
    norm="rmsnorm",
    pos_emb="rope",
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
