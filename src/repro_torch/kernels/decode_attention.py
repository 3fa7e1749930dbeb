"""batched_decode_attention, decode_attention and paged_decode_attention as
hand-written CUDA (``csrc/decode_attention.cu``), replacing the TPU kernels
of those names in `repro.kernels.decode_attention`.

One query per sequence for B sequences: `batched_decode_attention` over
dense per-sequence K/V, each sequence masked to its own live length, with
optional window starts, meta sinks and ALiBi slopes; `decode_attention`
over dense K/V with one shared validity vector; `paged_decode_attention`
over pool pages read in place through block tables.  All three split each
(KV head, sequence)'s keys across a thread-block cluster and combine the
partials on chip, in one launch (`split_plan` gives its shape).  A row with
no valid key gets the sum of V over its S slots divided by what the Pallas
kernel's walk covers (`ref.no_key_divisor(S)` over a dense cache, S over
pages), as the plain versions give.  The wrappers take CUDA tensors only
(the CPU goes to the plain versions through `repro_torch.kernels.ops`),
check what the kernel needs, allocate the output and count their launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.ref import no_key_divisor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448          # bytes of shared memory one block may use (H100)


def _int_vec(t: torch.Tensor, b: int, what: str, dev) -> None:
    if t.device != dev or t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 [{b}] on {dev}")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; use repro_torch.kernels.ops "
                         "for the CPU")
    refuse_grad(what, q, k, v)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Hq,D], k/v [B,S,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    _, s, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv or s == 0 or b == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d > 256 or d % 8:
        raise ValueError(f"head dim {d} unsupported (needs D <= 256 and D % 8 == 0)")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {dev}")


@functools.lru_cache(maxsize=256)
def split_plan(dtype: torch.dtype, b: int, s: int, hq: int, hkv: int, d: int):
    """The launch shape of `decode_attention` and `batched_decode_attention`
    (s the cache length) and `paged_decode_attention` (s = max_blocks * bs):
    (blocks per cluster, ring stages, shared memory bytes per block), chosen
    from the shapes alone."""
    lib = _build.lib("decode_attention")
    splits, stages = ctypes.c_int(), ctypes.c_int()
    smem = lib.repro_decode_split_plan(_DTYPE_CODE[dtype], b, s, hq, hkv, d,
                                       ctypes.byref(splits), ctypes.byref(stages))
    return splits.value, stages.value, smem


def _split_lib(q: torch.Tensor, s: int, hkv: int):
    b, hq, d = q.shape
    smem = split_plan(q.dtype, b, s, hq, hkv, d)[2]
    if smem > MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory per block exceed {MAX_SMEM}")
    return _build.lib("decode_attention")


def batched_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor,
                             win_starts: Optional[torch.Tensor] = None,
                             slopes: Optional[torch.Tensor] = None, *,
                             num_meta: int = 0) -> torch.Tensor:
    """q [B,Hq,D]; k/v [B,S,Hkv,D]; lengths [B] int32, each in [0, S] (the
    new token included); win_starts [B] int32 or None; slopes [Hq] float32
    or None -> [B,Hq,D] in q.dtype.  A row with no valid key (length 0, or
    a window start past its length and no meta sink below it) gets the sum
    of V over the S slots divided by `no_key_divisor(S)`."""
    _check_qkv(q, k, v, "batched_decode_attention")
    dev = q.device
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    _int_vec(lengths, b, "lengths", dev)
    if win_starts is not None:
        _int_vec(win_starts, b, "win_starts", dev)
    if slopes is not None and (slopes.device != dev or slopes.dtype != torch.float32
                               or slopes.shape != (hq,) or not slopes.is_contiguous()):
        raise ValueError(f"slopes must be a contiguous float32 [{hq}] on {dev}")
    if num_meta < 0:
        raise ValueError(f"num_meta must be non-negative, got {num_meta}")
    lib = _split_lib(q, s, hkv)
    out = torch.empty_like(q)
    err = lib.repro_batched_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), None if win_starts is None else win_starts.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        b, s, hq, hkv, d, int(num_meta), float(d) ** -0.5, no_key_divisor(s),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "batched_decode_attention")
    LAUNCHES["batched_decode_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: torch.Tensor, *, with_lse: bool = False):
    """q [B,Hq,D]; k/v [B,S,Hkv,D]; kv_valid bool [S], one validity row
    shared by every sequence -> [B,Hq,D] in q.dtype.  With no valid key,
    a row gets the sum of V over the S slots divided by
    `no_key_divisor(S)`.  With `with_lse`, returns (out, lse): lse [B,Hq]
    f32, each row's log-sum-exp of its scaled scores over its valid keys
    (NEG_INF where it has none), from the same launch; `out` is the same
    bits either way."""
    _check_qkv(q, k, v, "decode_attention")
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if (kv_valid.device != q.device or kv_valid.dtype != torch.bool
            or kv_valid.shape != (s,) or not kv_valid.is_contiguous()):
        raise ValueError(f"kv_valid must be a contiguous bool [{s}] on {q.device}")
    lib = _split_lib(q, s, hkv)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.repro_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, hq, hkv, d,
        float(d) ** -0.5, no_key_divisor(s),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return (out, lse) if with_lse else out


def check_pages(k_pages: torch.Tensor, v_pages: torch.Tensor, what: str) -> int:
    """The page layout the paged kernels take: k/v [N,bs,Hkv,D] with dense
    (bs, Hkv, D), one page stride shared by k and v (one layer's view of the
    pool [N,L,bs,Hkv,D] qualifies), 16-byte aligned.  Returns the page
    stride in elements."""
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{what}: want k/v pages [N,bs,Hkv,D], got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    _, bs, hkv, d = k_pages.shape
    es = k_pages.element_size()
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.stride()[1:] != (hkv * d, d, 1) or t.stride() != k_pages.stride():
            raise ValueError(f"{what}: {name} must have dense (bs, Hkv, D) and the "
                             f"page stride of k_pages, got strides {t.stride()}")
        if t.data_ptr() % 16 or (t.stride(0) * es) % 16:
            raise ValueError(f"{what}: {name} base and page stride must be 16-byte aligned")
    return k_pages.stride(0)


def check_tables(block_tables: torch.Tensor, b: int, dev, what: str) -> int:
    """block_tables: contiguous int32 [b, max_blocks] on `dev`.  Returns
    max_blocks."""
    if (block_tables.device != dev or block_tables.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.shape[1] == 0 or not block_tables.is_contiguous()):
        raise ValueError(f"{what}: block_tables must be a contiguous int32 [{b}, max_blocks] "
                         f"on {dev}, got {tuple(block_tables.shape)} {block_tables.dtype}")
    return block_tables.shape[1]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,D]; k/v_pages [N,bs,Hkv,D] (see `check_pages`; not copied);
    block_tables [B,max_blocks] int32, every entry a valid page id (pad with
    0); lengths [B] int32, each in [0, max_blocks*bs], the new token
    included -> [B,Hq,D] in q.dtype.  A row reads the pages of its first
    ceil(lengths[b] / bs) entries only; a row at 0 gets the average of V over
    all max_blocks*bs slots of its table, as the plain version does."""
    what = "paged_decode_attention"
    if not q.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; use repro_torch.kernels.ops "
                         "for the CPU")
    refuse_grad(what, q, k_pages, v_pages)
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    dev = q.device
    if q.dim() != 3 or k_pages.device != dev or v_pages.device != dev:
        raise ValueError(f"{what}: want q [B,Hq,D] and pages on {dev}, got {tuple(q.shape)}")
    page_stride = check_pages(k_pages, v_pages, what)
    b, hq, d = q.shape
    _, bs, hkv, dk = k_pages.shape
    if dk != d or hkv == 0 or hq % hkv or b == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if d > 256 or d % 8:
        raise ValueError(f"head dim {d} unsupported (needs D <= 256 and D % 8 == 0)")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    max_blocks = check_tables(block_tables, b, dev, what)
    _int_vec(lengths, b, "lengths", dev)
    lib = _split_lib(q, max_blocks * bs, hkv)
    out = torch.empty_like(q)
    err = lib.repro_paged_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, max_blocks, bs,
        page_stride, hq, hkv, d, float(d) ** -0.5,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, what)
    LAUNCHES["paged_decode_attention"] += 1
    return out
