"""Kernel entry points the model calls (counterparts of `repro.kernels.ops`).

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain PyTorch version in `ref`, a CUDA tensor to the hand-written kernel,
which launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import batched_decode_attention
from repro_torch.kernels.kv_pack import check_pack_args, check_ragged_args, kv_pack, kv_pack_ragged


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on cpu or cuda, not {t.device}")
    return t.device.type


def batched_decode_attention_auto(q, k_cache, v_cache, lengths, *,
                                  window: int = 0, num_meta: int = 0,
                                  alibi: Optional[torch.Tensor] = None):
    """Fused-round decode attention: one launch, B sequences, ragged
    lengths.  q [B,Hq,D]; k/v [B,S,Hkv,D]; lengths [B] int32.  A positive
    `window` becomes per-sequence window starts max(lengths - window, 0)."""
    win_starts = (lengths - int(window)).clamp(min=0) if window else None
    if _route(q) == "cpu":
        return ref.batched_decode_attention_ref(q, k_cache, v_cache, lengths,
                                                win_starts, alibi,
                                                num_meta=num_meta)
    return batched_decode_attention(q, k_cache, v_cache, lengths, win_starts,
                                    alibi, num_meta=num_meta)


def kv_pack_auto(cache, t0: int, width: int, token_block: int = 8):
    if _route(cache) == "cpu":
        check_pack_args(cache, [int(t0)], width, token_block)
        return ref.kv_pack_ref(cache, int(t0), width)
    return kv_pack(cache, t0, width=width, token_block=token_block)


def kv_pack_ragged_auto(cache, starts, width: int, token_block: int = 8):
    """Multi-sequence buffered copy: one window per batch row at its own
    offset (the fused-round KV write-back).  `starts` are host ints."""
    if _route(cache) == "cpu":
        starts = [int(s) for s in starts]
        check_ragged_args(cache, starts, width, token_block)
        return ref.kv_pack_ragged_ref(cache, starts, width)
    return kv_pack_ragged(cache, starts, width=width, token_block=token_block)
