"""Architecture configuration (the port's own copy of `repro.configs.base`).

Field names, defaults and `reduced()` match the JAX package's `ArchConfig`
so one config value means the same model in both packages; the tests build
a config here and its twin there from the same field values.  Only the
fields and properties the serving path reads are carried over, with the
analytic sizes the cost model and the planner read (`param_count`,
`kv_bytes_per_token`, `decode_state_bytes`, ...) and `supports_shape`.
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

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count N (analytic)."""
        d = self.d_model
        per_layer = 0
        if self.family != "ssm":
            # attention: q, k, v, o projections
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            # in_proj (z, x, B, C, dt) + out_proj + conv + A, D
            g = self.ssm_ngroups
            per_layer += d * (2 * di + 2 * g * self.ssm_state + self.ssm_nheads)
            per_layer += di * d
            per_layer += self.ssm_conv * (di + 2 * g * self.ssm_state)
            per_layer += 2 * self.ssm_nheads
        if self.is_moe:
            per_layer += self.num_experts * 3 * d * self.d_ff  # gated experts
            per_layer += d * self.num_experts                  # router
        elif self.d_ff:
            n_mats = 3 if self.activation == "silu" else 2     # gated vs plain
            per_layer += n_mats * d * self.d_ff
        per_layer += 2 * d                                     # norms
        total = self.num_layers * per_layer
        if self.cross_attention:
            total += self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                        + self.q_dim * d + d)
        if self.num_encoder_layers:
            enc_layer = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n_mats = 3 if self.activation == "silu" else 2
            enc_layer += n_mats * d * self.d_ff + 2 * d
            total += self.num_encoder_layers * enc_layer
        total += self.vocab_size * d                           # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d                       # lm head
        if self.num_meta_tokens:
            total += self.num_meta_tokens * d
        return total

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: only the routed experts)."""
        if not self.is_moe:
            return self.param_count()
        expert_params = self.num_layers * self.num_experts * 3 * self.d_model * self.d_ff
        active_expert = (self.num_layers * self.experts_per_token * 3 * self.d_model
                         * self.d_ff)
        return self.param_count() - expert_params + active_expert

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Decode-state bytes appended per generated token (per request)."""
        if self.family == "ssm":
            return 0  # a fixed-size state: nothing is appended
        return self.num_layers * 2 * self.kv_dim * dtype_bytes

    def decode_state_bytes(self, seq_len: int, dtype_bytes: int = 2) -> int:
        """Decode-state footprint of one request at context `seq_len`."""
        total = 0
        if self.family == "ssm":
            return self.num_layers * self.ssm_nheads * self.ssm_head_dim * self.ssm_state * 4
        if self.family == "hybrid":
            # SSM state + windowed KV on the SWA layers + full KV on the global ones
            total += self.num_layers * self.ssm_nheads * self.ssm_head_dim * self.ssm_state * 4
            n_full = len(self.full_attn_layers)
            n_swa = self.num_layers - n_full
            w = min(self.sliding_window or seq_len, seq_len)
            total += n_swa * 2 * self.kv_dim * w * dtype_bytes
            total += n_full * 2 * self.kv_dim * seq_len * dtype_bytes
            return total
        total += self.num_layers * 2 * self.kv_dim * seq_len * dtype_bytes
        if self.cross_attention:
            total += (self.num_layers * 2 * self.kv_dim
                      * min(self.max_source_len, seq_len) * dtype_bytes)
        return total

    def paged_state_bytes(self, live_tokens: int, dtype_bytes: int = 2) -> int:
        """Decode-state footprint under the paged pool: `live_tokens` rounded
        up to whole KV blocks (where `decode_state_bytes` reserves the full
        prompt+max_new window for the request's lifetime)."""
        bs = max(self.kv_block_size, 1)
        rounded = -(-live_tokens // bs) * bs
        return self.decode_state_bytes(rounded, dtype_bytes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(supported, the reason if not).  long_500k needs a decode state that
    grows less than linearly with the context."""
    if shape.name == "long_500k" and arch.family not in ("ssm", "hybrid"):
        return False, (f"long_500k needs sub-quadratic attention; {arch.name} is a "
                       "pure full-attention architecture (a 512k dense KV cache)")
    return True, ""
