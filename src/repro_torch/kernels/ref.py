"""Plain PyTorch versions of the port's kernels (counterparts of
`repro.kernels.ref`).

These are the functions the CUDA kernels compute, written as ordinary tensor
code.  On a CPU tensor `repro_torch.kernels.ops` runs them; on the card they
are what `chip_smoke.py` holds each kernel against.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def kv_pack_ref(cache: torch.Tensor, t0: int, width: int) -> torch.Tensor:
    """cache [L,B,S,H,D] -> contiguous window [L,B,width,H,D] at token t0."""
    return cache.narrow(2, t0, width).contiguous()


def kv_pack_ragged_ref(cache: torch.Tensor, starts: Sequence[int],
                       width: int) -> torch.Tensor:
    """cache [L,B,S,H,D]; starts [B] -> [L,B,width,H,D], batch row b being
    cache[:, b, starts[b]:starts[b]+width]."""
    rows = [cache[:, b, int(s):int(s) + width] for b, s in enumerate(starts)]
    return torch.stack(rows, dim=1)


def kv_unpack_ref(cache: torch.Tensor, buf: torch.Tensor, t0: int) -> torch.Tensor:
    """Write buf [L,B,W,H,D] into cache [L,B,S,H,D] at token t0, in place
    (the cache may be a view of a larger one).  Returns the cache."""
    cache[:, :, t0:t0 + buf.shape[2]] = buf.to(cache.dtype)
    return cache


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q [B,Sq,Hq,D]; k/v [B,Skv,Hkv,D] -> [B,Sq,Hq,D], f32 softmax.  Causal
    with the offset of a query block at the end of the keys: query i sees
    keys j <= i + (Skv - Sq)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (d ** -0.5)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,D]; k/v [B,S,Hkv,D]; kv_valid [S] bool, one validity row
    shared by every sequence (any pattern, not only a prefix) -> [B,Hq,D]."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k).float() * (d ** -0.5)
    scores = torch.where(kv_valid.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    return out.reshape(b, hq, d)


def batched_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lengths: torch.Tensor,
                                 win_starts: Optional[torch.Tensor] = None,
                                 slopes: Optional[torch.Tensor] = None, *,
                                 num_meta: int = 0) -> torch.Tensor:
    """q [B,Hq,D]; k/v [B,S,Hkv,D]; lengths [B] (live tokens per sequence,
    the new one included) -> [B,Hq,D].

    win_starts: optional [B] first non-meta slot each sequence may attend;
    slots below `num_meta` are always visible.  slopes: optional [Hq] ALiBi
    slopes, the query sitting at position lengths[b]-1.  Probabilities are
    cast to q.dtype before P·V, as in the reference's oracle."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    lengths = lengths.to(torch.int64)
    pos = torch.arange(s, device=q.device)[None, :]                    # [1,S]
    valid = pos < lengths[:, None]                                     # [B,S]
    if win_starts is not None:
        valid = valid & ((pos >= win_starts.to(torch.int64)[:, None])
                         | (pos < num_meta))
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k).float() * (d ** -0.5)
    if slopes is not None:
        dist = ((lengths[:, None] - 1) - pos).float()                  # [B,S]
        scores = scores - (slopes.float().reshape(hkv, g)[None, :, :, None]
                           * dist.clamp(min=0.0)[:, None, None, :])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    return out.reshape(b, hq, d)
