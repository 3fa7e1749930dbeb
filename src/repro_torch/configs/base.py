"""Architecture configuration (the port's own copy of `repro.configs.base`).

Field names, defaults and `reduced()` match the JAX package's `ArchConfig`
so one config value means the same model in both packages; the tests build
a config here and its twin there from the same field values.  Only the
fields and properties the serving path reads are carried over.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // num_heads
    activation: str = "silu"                 # silu | gelu | relu2
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    pos_emb: str = "rope"                    # rope | learned | alibi | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    # --- hybrid (Hymba) ---
    sliding_window: int = 0                  # 0 = full attention everywhere
    num_meta_tokens: int = 0
    full_attn_layers: Tuple[int, ...] = ()
    # --- enc-dec ---
    num_encoder_layers: int = 0
    cross_attention: bool = False
    max_source_len: int = 4096
    # --- VLM ---
    num_patches: int = 0
    # --- paged KV cache (serving) ---
    kv_block_size: int = 8                   # tokens per KV block
    kv_pool_blocks: int = 0                  # pool size per stage; 0 = auto
    # Q tokens per chunked-prefill pipeline pass on the paged path; 0 runs
    # every prompt whole in one pass ("batch" mode, through flash_attention),
    # as do prompts no longer than a chunk when fused rounds are off.
    prefill_chunk_tokens: int = 64
    # Fused batched rounds: one pipeline pass decodes every live sequence
    # and one pass packs every in-flight prefill chunk.  False runs the
    # per-sequence path, which the fused one is tested against.
    fused_rounds: bool = True
    # --- misc ---
    dtype: str = "bfloat16"
    max_seq_len: int = 524288
    source: str = ""                         # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def context_overhead(self) -> int:
        """Non-text context slots prepended to the prompt (patches/meta)."""
        return self.num_patches + self.num_meta_tokens

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale config of the same family (CPU-runnable)."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            max_seq_len=256,
            max_source_len=32,
        )
        if self.is_moe:
            kw.update(num_experts=4, experts_per_token=2, d_ff=32)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=8, ssm_head_dim=16, ssm_expand=2)
        if self.family == "hybrid":
            kw.update(sliding_window=16, num_meta_tokens=4, full_attn_layers=(0,))
        if self.family == "encdec":
            kw.update(num_encoder_layers=2)
        if self.family == "vlm":
            kw.update(num_patches=8)
        return replace(self, **kw)
