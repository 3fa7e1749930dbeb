"""GQA attention: projections, position-based masks, plain attention and the
decode paths (counterparts of `repro.models.attention`).

Kernel routing, as the reference's ``backend="pallas"`` routes it: a whole
prompt goes through `ops.attention_auto` (the `flash_attention` kernel where
the layer is plain causal); a one-query step over a cache with one shared
position row goes through `decode_attention`, with ALiBi through
`batched_decode_attention`, as does every fused-round step over a gathered
cache; multi-token chunks over a gathered cache use the plain `attend`,
which the reference also leaves to the compiler.  A fused-round pass of a
stage whose layers are all plain causal reads the pool's pages in place
instead (`attention_paged_batch`): `paged_decode_attention` for a decode
pass, `paged_prefill_attention` for a chunk-set pass.  Masked scores take
the finite NEG_INF of the reference: a padded query row masked everywhere
then gives a finite uniform average instead of NaN.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import apply_rope, dense_init

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_init(generator, cfg, dtype, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    return {n: dense_init(generator, s, dtype, device) for n, s in shapes.items()}


def qkv_proj(x, p, cfg):
    """x [B,S,d] -> q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh]."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, dh)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, dh)
    return q, k, v


def out_proj(o, p):
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ p["wo"]


def build_mask(q_pos, kv_pos, *, causal: bool, window: int = 0, num_meta: int = 0):
    """Boolean mask [.., Sq, Skv]; True = attend.  q_pos [Sq] or [B,Sq];
    kv_pos [Skv] or [B,Skv] (-1 = empty slot).  Meta tokens at positions
    [0, num_meta) are always visible; a positive window admits kv within
    the last `window` positions of q."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((kp > qp - window) | (kp < num_meta))
    return mask


def attend(q, k, v, mask=None, bias=None):
    """q [B,Sq,Hq,Dh], k/v [B,Skv,Hkv,Dh], mask [.., Sq,Skv] bool; bias
    [Hq,Sq,Skv] or [B,Hq,Sq,Skv] f32, added before masking.  Softmax in
    f32, probabilities cast to q.dtype before P·V."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (dh ** -0.5)
    if bias is not None:
        if bias.dim() == 4:
            scores = scores + bias.reshape(b, hkv, g, *bias.shape[2:])
        else:
            scores = scores + bias.reshape(hkv, g, *bias.shape[1:])[None]
    if mask is not None:
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dh)


def alibi_bias(slopes, q_pos, kv_pos):
    """ALiBi additive bias: q_pos [Sq], kv_pos [Skv] -> [Hq,Sq,Skv]; per
    sequence q_pos [B,Sq], kv_pos [B,Skv] -> [B,Hq,Sq,Skv]."""
    dist = (q_pos[..., :, None] - kv_pos[..., None, :]).float().clamp(min=0.0)
    if dist.dim() == 2:
        return -slopes[:, None, None] * dist
    return -slopes[None, :, None, None] * dist[:, None]


def attention_prefill(x, p, cfg, positions, *, window: int = 0, num_meta: int = 0,
                      rope: bool = True, alibi: Optional[torch.Tensor] = None):
    """Causal self-attention over a whole prompt at `positions` [S].
    Returns (out, k, v), k/v [B,S,Hkv,Dh] for the caller's cache."""
    q, k, v = qkv_proj(x, p, cfg)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = build_mask(positions, positions, causal=True, window=window, num_meta=num_meta)
    bias = alibi_bias(alibi, positions, positions) if alibi is not None else None
    o = kops.attention_auto(q, k, v, mask=mask, bias=bias, window=window)
    return out_proj(o, p), k, v


def attention_decode(x, p, cfg, k_cache, v_cache, kv_positions, pos: int, *,
                     window: int = 0, num_meta: int = 0, rope: bool = True,
                     alibi: Optional[torch.Tensor] = None,
                     write_index: Optional[int] = None):
    """A decode step (C = 1) or prefill chunk (C > 1) of B sequences that
    share the positions pos..pos+C-1, over a cache [B,S,Hkv,Dh] whose slot
    positions are kv_positions [S] (-1 = empty).  The chunk's K/V is written
    into the cache in place at `write_index` (default `pos`; a ring-buffer
    cache passes its slot), clamped to the cache end like the reference's
    dynamic update.  Returns (out, k, v)."""
    b, c, _ = x.shape
    q, k_new, v_new = qkv_proj(x, p, cfg)
    posv = pos + torch.arange(c, dtype=torch.int32, device=x.device)
    if rope:
        q = apply_rope(q, posv[None, :], cfg.rope_theta)
        k_new = apply_rope(k_new, posv[None, :], cfg.rope_theta)
    wi = pos if write_index is None else write_index
    wi = min(max(wi, 0), k_cache.shape[1] - c)
    k_cache[:, wi:wi + c] = k_new.to(k_cache.dtype)
    v_cache[:, wi:wi + c] = v_new.to(v_cache.dtype)
    if c == 1 and alibi is None:
        mask = build_mask(posv, kv_positions, causal=True, window=window,
                          num_meta=num_meta)                         # [1,S]
        o = kops.decode_attention_auto(q, k_cache, v_cache, mask)
    elif c == 1:
        # ALiBi: batched_decode_attention with every sequence at length pos+1
        lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
        o = kops.batched_decode_attention_auto(q[:, 0].contiguous(), k_cache, v_cache,
                                               lengths, window=window,
                                               num_meta=num_meta, alibi=alibi)[:, None]
    else:
        mask = build_mask(posv, kv_positions, causal=True, window=window,
                          num_meta=num_meta)
        bias = (alibi_bias(alibi, posv, kv_positions.clamp(min=0))
                if alibi is not None else None)
        o = attend(q, k_cache, v_cache, mask=mask, bias=bias)
    return out_proj(o, p), k_cache, v_cache


def _scatter_rows(cache, new, pos, lens):
    """Write sequence b's new rows new[b, :lens[b]] into cache[b] at pos[b],
    in place on the freshly gathered cache [B,S,H,D].  The C-row window
    starts at min(pos, S-C); when a short final chunk's padded window would
    overrun the cache end it backs up and the valid rows shift within it.
    Rows outside the valid range keep the cache's own values, so padding
    never lands in the cache."""
    b, c = new.shape[:2]
    dev = cache.device
    ar = torch.arange(c, dtype=torch.int64, device=dev)
    pos = pos.to(torch.int64)
    pe = pos.clamp(max=cache.shape[1] - c)                         # [B]
    idx = ar[None, :] - (pos - pe)[:, None]                        # [B,C]
    keep = (idx >= 0) & (idx < lens.to(torch.int64)[:, None])
    rows = pe[:, None] + ar[None, :]                               # [B,C]
    bi = torch.arange(b, device=dev)[:, None]
    src = new.to(cache.dtype)[bi, idx.clamp(0, c - 1)]             # [B,C,H,D]
    cache[bi, rows] = torch.where(keep[..., None, None], src, cache[bi, rows])


def attention_decode_batch(x, p, cfg, k_cache, v_cache, kv_positions, pos,
                           q_lens=None, *, window: int = 0, num_meta: int = 0,
                           rope: bool = True, alibi: Optional[torch.Tensor] = None):
    """B sequences advance in one pass at their own positions.  x [B,C,d]:
    C = 1 decodes every sequence one step; C > 1 packs one prefill chunk
    per sequence, sequence b's chunk at positions pos[b]..pos[b]+q_lens[b]-1
    (rows past q_lens[b] are padding).  k/v_cache [B,S,Hkv,Dh] (each
    sequence's pages gathered to a common pad, updated in place);
    kv_positions [B,S] with -1 past each live length; pos [B] int32."""
    b, c, _ = x.shape
    dev = x.device
    q, k_new, v_new = qkv_proj(x, p, cfg)
    posv = pos[:, None] + torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    lens = (torch.full((b,), c, dtype=torch.int32, device=dev) if q_lens is None
            else q_lens)
    if rope:
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    _scatter_rows(k_cache, k_new, pos, lens)
    _scatter_rows(v_cache, v_new, pos, lens)
    if c == 1:
        o = kops.batched_decode_attention_auto(q[:, 0].contiguous(), k_cache, v_cache,
                                               pos + 1, window=window,
                                               num_meta=num_meta, alibi=alibi)[:, None]
    else:
        # padded query rows (>= q_lens[b]) get q_pos -1: their mask row is
        # all False, a finite uniform average the caller never reads
        q_pos = torch.where(posv < (pos + lens)[:, None], posv, -1)
        mask = build_mask(q_pos, kv_positions, causal=True, window=window,
                          num_meta=num_meta)
        bias = (alibi_bias(alibi, q_pos, kv_positions.clamp(min=0))
                if alibi is not None else None)
        o = attend(q, k_cache, v_cache, mask=mask, bias=bias)
    return out_proj(o, p), k_cache, v_cache


def attention_paged_batch(x, p, cfg, k_pages, v_pages, block_tables, write_idx, pos,
                          lengths=None, q_lens=None, *, rope: bool = True):
    """A fused-round pass of a plain causal layer (no window, no ALiBi) over
    the pool's pages, read and written in place: no dense cache.  x [B,C,d];
    k/v_pages [N,bs,Hkv,Dh], this layer's view of the stage's pool;
    block_tables [B,nb] int32; write_idx int64 [3,n] from
    `PagedKVCache.write_indices` (page, slot, row of the B*C new rows); pos
    [B] int32, sequence b's first new position.  A decode pass (`q_lens`
    None, C = 1) attends over `lengths` [B] = pos + 1 live tokens; a
    chunk-set pass over each sequence's prefix plus the q_lens[b] valid rows
    of its chunk.  The valid rows' K/V go into the pages before attending;
    padding rows never do."""
    b, c, _ = x.shape
    q, k_new, v_new = qkv_proj(x, p, cfg)
    if rope:
        posv = pos[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)[None, :]
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    page, slot, row = write_idx
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        rows = new.reshape(b * c, *new.shape[2:])
        if write_idx.shape[1] != b * c:           # ragged chunks: valid rows only
            rows = rows.index_select(0, row)
        pages[page, slot] = rows.to(pages.dtype)
    if q_lens is None:
        o = kops.paged_decode_attention_auto(q, k_pages, v_pages, block_tables, lengths)
    else:
        o = kops.paged_prefill_attention_auto(q, k_pages, v_pages, block_tables, pos, q_lens)
    return out_proj(o, p)
