"""Kernel entry points the model calls (counterparts of `repro.kernels.ops`).

Dispatch is by the device of the tensor given: a CPU tensor goes to the
plain PyTorch version in `ref`, a CUDA tensor to the hand-written kernel,
which launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref, wants_grad
from repro_torch.kernels.decode_attention import (batched_decode_attention, decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention
from repro_torch.kernels.kv_pack import (check_pack_args, check_ragged_args,
                                         check_unpack_args, kv_pack, kv_pack_ragged,
                                         kv_unpack)
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on cpu or cuda, not {t.device}")
    return t.device.type


def attention_auto(q, k, v, mask=None, bias=None, *, window: int = 0,
                   with_lse: bool = False):
    """Whole-prompt attention.  q [B,Sq,Hq,D]; k/v [B,Skv,Hkv,D]; mask
    [..,Sq,Skv] bool or None; bias as `models.attention.attend` takes it.
    With `with_lse` (full attention only: no mask, no bias), (out, lse
    [B,Hq,Sq] f32) as `flash_attention` gives them.

    `flash_attention` runs where the layer is plain causal, decided from the
    layer's configuration (window 0, no ALiBi bias, Sq == Skv), never from
    the mask's shape: a windowed layer builds a mask of the same shape and
    must not lose its window.  Meta tokens matter only beside a window (they
    stay visible from outside it, `build_mask`), so a full-attention layer of
    a meta-token model (Hymba's) is plain causal and runs the kernel too.
    The mask of a plain causal layer is then the causal mask, which the
    kernel applies itself.  With neither mask nor bias it runs full
    (non-causal) attention.  Everything else goes to the plain `attend`."""
    if with_lse:
        if mask is not None or bias is not None or window:
            raise ValueError("attention with its LSE runs full attention only")
        if _route(q) == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=False, with_lse=True)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                               with_lse=True)
    if bias is None and window == 0:
        if mask is None:
            return _flash(q, k, v, causal=False)
        if q.shape[1] == k.shape[1]:
            return _flash(q, k, v, causal=True)
    from repro_torch.models.attention import attend
    return attend(q, k, v, mask=mask, bias=bias)


def _flash(q, k, v, *, causal: bool):
    """On the card, a call that autograd records goes through the forward
    with its LSE and the backward kernel; any other keeps the plain launch."""
    if _route(q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal)


def decode_attention_auto(q, k_cache, v_cache, mask, *, with_lse: bool = False):
    """One-query decode over a dense cache with one validity row shared by
    the batch.  q [B,1,Hq,D]; k/v [B,S,Hkv,D]; mask [1,S] or [S] bool ->
    [B,1,Hq,D]; with `with_lse`, (out, lse [B,Hq] f32) as `decode_attention`
    gives them."""
    valid = mask[0] if mask.dim() == 2 else mask
    if _route(q) == "cpu":
        res = ref.decode_attention_ref(q[:, 0], k_cache, v_cache, valid, with_lse=with_lse)
    else:
        res = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, valid.contiguous(),
                               with_lse=with_lse)
    return (res[0][:, None], res[1]) if with_lse else res[:, None]


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


def paged_decode_attention_auto(q, k_pages, v_pages, block_tables, lengths):
    """Decode attention reading the pool's pages in place through block
    tables.  q [B,1,Hq,D] or [B,Hq,D]; k/v_pages [N,bs,Hkv,D] (one layer's
    view of the pool); block_tables [B,max_blocks] int32; lengths [B] int32."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if _route(q) == "cpu":
        out = ref.paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    else:
        out = paged_decode_attention(q.contiguous(), k_pages, v_pages, block_tables, lengths)
    return out[:, None] if squeeze else out


def paged_prefill_attention_auto(q, k_pages, v_pages, block_tables, q_starts, q_lens):
    """A prefill chunk per sequence over the pool's pages, read in place.
    q [B,C,Hq,D]; the chunk's own K/V must already be in the pages."""
    if _route(q) == "cpu":
        return ref.paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, q_starts,
                                               q_lens)
    return paged_prefill_attention(q.contiguous(), k_pages, v_pages, block_tables, q_starts,
                                   q_lens)


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


def kv_unpack_auto(cache, buf, t0: int, token_block: int = 8):
    """Write buf [L,B,W,H,D] into the cache window at t0, in place; returns
    the cache.  t0 and W are multiples of the token block."""
    if _route(cache) == "cpu":
        check_unpack_args(cache, buf, int(t0), token_block)
        return ref.kv_unpack_ref(cache, buf, int(t0))
    return kv_unpack(cache, buf, t0, token_block=token_block)


def ssd_auto(x, dt, a_neg, bmat, cmat, chunk: int = 128, h0=None):
    """Chunked Mamba-2 SSD in chunks of min(chunk, S) tokens.  x [B,S,nh,hd];
    dt [B,S,nh] f32; a_neg [nh] f32; B/C [B,S,G,N]; h0 [B,nh,hd,N] f32 or
    None -> (y [B,S,nh,hd], h_final [B,nh,hd,N] f32)."""
    q = min(int(chunk), x.shape[1])
    if _route(x) == "cpu":
        return ref.ssd_scan_ref(x, dt, a_neg, bmat, cmat, h0=h0, chunk=q)
    args = (x.contiguous(), dt.contiguous(), a_neg.contiguous(), bmat.contiguous(),
            cmat.contiguous(), None if h0 is None else h0.contiguous())
    if wants_grad(*args):              # the forward with its chunk states, then ssd_scan_bwd
        return SSDScanFn.apply(*args, q)
    return ssd_scan(*args, chunk=q)
