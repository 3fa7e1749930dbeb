"""Plain PyTorch versions of the port's kernels (counterparts of
`repro.kernels.ref`).

These are the functions the CUDA kernels compute, written as ordinary tensor
code.  On a CPU tensor `repro_torch.kernels.ops` runs them; on the card they
are what `chip_smoke.py` holds each kernel against.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# The Pallas decode kernels' default key block (`block_k`,
# src/repro/kernels/decode_attention.py:179,243), which their callers keep.
# They pad S with zero K/V rows up to a multiple of min(512, S), so a row
# with no valid key averages V over that padded length.
PALLAS_BLOCK_K = 512


def no_key_divisor(s: int) -> int:
    """What a row with no valid key divides the sum of V over its S slots
    by in the Pallas decode kernels over a dense cache: S rounded up to a
    multiple of min(PALLAS_BLOCK_K, S)."""
    bk = min(PALLAS_BLOCK_K, s)
    return -(-s // bk) * bk


def _average_where_no_key(out: torch.Tensor, v: torch.Tensor, none: torch.Tensor,
                          divisor: int) -> torch.Tensor:
    """out [B,Hkv,G,D]; v [B,S,Hkv,D]; none [B] or [] bool, the rows with no
    valid key -> out with those rows replaced by sum of V over S / divisor,
    summed in f32 as the kernels do."""
    avg = (v.float().sum(dim=1) / divisor).to(out.dtype)[:, :, None, :]    # [B,Hkv,1,D]
    return torch.where(none.reshape(-1, 1, 1, 1), avg, out)


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
    shared by every sequence (any pattern, not only a prefix) -> [B,Hq,D].
    With no valid key, every row is the sum of V over the S slots divided by
    `no_key_divisor(S)`, as the Pallas kernel gives."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k).float() * (d ** -0.5)
    scores = torch.where(kv_valid.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    out = _average_where_no_key(out, v, ~kv_valid.bool().any(), no_key_divisor(s))
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
    cast to q.dtype before P·V, as in the reference's oracle.  A row with no
    valid key is the sum of V over the S slots divided by
    `no_key_divisor(S)`, as the Pallas kernel gives."""
    return _ragged_decode(q, k, v, lengths, win_starts, slopes, num_meta,
                          no_key_divisor(k.shape[1]))


def _ragged_decode(q, k, v, lengths, win_starts, slopes, num_meta: int, divisor: int):
    """`batched_decode_attention_ref` with the no-valid-key divisor given."""
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
    out = _average_where_no_key(out, v, ~valid.any(dim=1), divisor)
    return out.reshape(b, hq, d)


def paged_gather_ref(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pages [N,bs,H,D] (any page stride, e.g. one layer of the pool
    [N,L,bs,H,D]); block_tables [B,max_blocks] -> dense [B,max_blocks*bs,H,D]."""
    b, mb = block_tables.shape
    _, bs, h, d = pages.shape
    return pages[block_tables.reshape(-1).long()].reshape(b, mb * bs, h, d)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,D]; k/v_pages [N,bs,Hkv,D]; block_tables [B,max_blocks] int32
    (logical block j of sequence b in page block_tables[b,j]); lengths [B]
    live tokens -> [B,Hq,D].  Gathers the pages dense, then the masked f32
    softmax of `batched_decode_attention_ref`; a row at length 0 averages V
    over its max_blocks * bs slots (the Pallas kernel walks whole pages and
    pads nothing)."""
    k = paged_gather_ref(k_pages, block_tables)
    v = paged_gather_ref(v_pages, block_tables)
    return _ragged_decode(q, k, v, lengths, None, None, 0, k.shape[1])


def paged_prefill_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, block_tables: torch.Tensor,
                                q_starts: torch.Tensor, q_lens: torch.Tensor) -> torch.Tensor:
    """q [B,C,Hq,D], query i of sequence b at position q_starts[b] + i;
    k/v_pages [N,bs,Hkv,D] already holding the chunk's own K/V;
    block_tables [B,max_blocks]; q_starts, q_lens [B] -> [B,C,Hq,D].  Slot
    j is visible to query i iff j <= q_starts[b] + i and j < q_starts[b] +
    q_lens[b].  Rows past q_lens[b] are don't-care."""
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    k = paged_gather_ref(k_pages, block_tables)
    v = paged_gather_ref(v_pages, block_tables)
    s = k.shape[1]
    starts = q_starts.to(torch.int64)
    qpos = starts[:, None] + torch.arange(c, device=q.device)[None, :]          # [B,C]
    kvpos = torch.arange(s, device=q.device)[None, None, :]                      # [1,1,S]
    valid = (kvpos <= qpos[:, :, None]) \
        & (kvpos < (starts + q_lens.to(torch.int64))[:, None, None])           # [B,C,S]
    qg = q.reshape(b, c, hkv, g, d)
    scores = torch.einsum("bchgd,bkhd->bhgck", qg, k).float() * (d ** -0.5)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgck,bkhd->bchgd", probs, v)
    return out.reshape(b, c, hq, d)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """Chunked Mamba-2 SSD (the reference's `models.ssm.ssd_chunked`).
    x [B,S,nh,hd]; dt [B,S,nh] (post-softplus); a_neg [nh] (negative);
    bmat/cmat [B,S,G,N]; h0 [B,nh,hd,N] or None.  Returns (y [B,S,nh,hd] in
    x.dtype, h_final [B,nh,hd,N] f32).  All state math in f32; S is padded
    with zeros to a multiple of `chunk` (padded rows have dt 0 and leave the
    state unchanged)."""
    b, s, nh, hd = x.shape
    g, n = bmat.shape[-2], bmat.shape[-1]
    rep = nh // g
    a_neg = a_neg.float()
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    xs = x.reshape(b, nc, chunk, nh, hd).float()
    dts = dt.reshape(b, nc, chunk, nh).float()
    bs = bmat.reshape(b, nc, chunk, g, n).float()
    cs = cmat.reshape(b, nc, chunk, g, n).float()

    da_cum = torch.cumsum(dts * a_neg, dim=2)                  # [b,nc,q,nh], inclusive
    # intra-chunk decay exp(cum_i - cum_j) for i >= j.  Mask BEFORE exp: the
    # i < j entries are positive and overflow, and inf * 0 is NaN.
    li = da_cum[:, :, :, None, :] - da_cum[:, :, None, :, :]   # [b,nc,i,j,nh]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], li, -1e30))

    cb = torch.einsum("bcign,bcjgn->bcgij", cs, bs)            # [b,nc,g,i,j]
    cb_h = torch.repeat_interleave(cb, rep, dim=2)             # [b,nc,nh,i,j]
    scores = cb_h * lmat.movedim(-1, 2)
    y_diag = torch.einsum("bchij,bcjh,bcjhd->bcihd", scores, dts, xs)

    # chunk contributions S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)    # [b,nc,j,nh]
    b_h = torch.repeat_interleave(bs, rep, dim=3)              # [b,nc,j,nh,n]
    states = torch.einsum("bcjhn,bcjh,bcjh,bcjhd->bchdn", b_h, decay_states, dts, xs)
    chunk_decay = torch.exp(da_cum[:, :, -1, :])               # [b,nc,nh]

    h = (torch.zeros(b, nh, hd, n, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_in = []                                                  # the state entering each chunk
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [b,nc,nh,hd,n]

    c_h = torch.repeat_interleave(cs, rep, dim=3)              # [b,nc,i,nh,n]
    y_off = torch.einsum("bcihn,bchdn,bcih->bcihd", c_h, h_in, torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, sp, nh, hd)[:, :s]
    return y.to(x.dtype), h


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       h0: Optional[torch.Tensor] = None):
    """Token-by-token SSD recurrence, an oracle independent of the chunked
    algorithm.  Shapes as `ssd_scan_ref`; returns (y, h_final)."""
    b, s, nh, hd = x.shape
    g, n = bmat.shape[-2:]
    rep = nh // g
    h = (torch.zeros(b, nh, hd, n, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    a32 = a_neg.float()
    ys = []
    for t in range(s):
        bt = torch.repeat_interleave(bmat[:, t].float(), rep, dim=1)   # [b,nh,n]
        ct = torch.repeat_interleave(cmat[:, t].float(), rep, dim=1)
        dtt = dt[:, t].float()
        h = (h * torch.exp(dtt * a32)[:, :, None, None]
             + dtt[:, :, None, None] * x[:, t].float()[:, :, :, None] * bt[:, :, None, :])
        ys.append(torch.einsum("bhdn,bhn->bhd", h, ct))
    return torch.stack(ys, dim=1).to(x.dtype), h
