"""SeamlessM4T-large-v2 — enc-dec multimodal (audio) backbone. [arXiv:2308.11596; hf]

The modality frontend (speech feature extractor) is a STUB: callers pass
precomputed frame embeddings ``src_embeds [B, S_frames, d_model]``.  Only the
transformer backbone (24-layer encoder, 24-layer decoder with
cross-attention) is implemented, as in the reference.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,               # decoder layers
    num_encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    norm="layernorm",
    pos_emb="learned",
    max_source_len=4096,
    max_seq_len=32768,           # decoder learned-pos table bound
    source="arXiv:2308.11596; hf",
)
