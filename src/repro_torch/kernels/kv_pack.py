"""kv_pack / kv_pack_ragged / kv_unpack: the DéjàVuLib buffered copies
(paper §4.1) as hand-written CUDA (``csrc/kv_pack.cu``), replacing the TPU
kernels of `repro.kernels.kv_pack`.

The packs gather token windows of a stacked cache [L,B,S,H,D] into one dense
buffer [L,B,W,H,D]: `kv_pack` at one start t0 for every row, `kv_pack_ragged`
at a start per batch row.  `kv_unpack` writes such a buffer back into the
cache window at t0, in place.  The wrappers take CUDA tensors only (the CPU
goes to the plain versions through `repro_torch.kernels.ops`), check what
the kernel needs, allocate any output and count their launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import LAUNCHES, _build

_DTYPES = (torch.float32, torch.bfloat16)


def check_pack_args(cache: torch.Tensor, starts: Sequence[int], width: int,
                    token_block: int) -> None:
    """Alignment and bounds of a buffered copy.  The TPU kernel addresses
    the window in blocks of bt = min(token_block, width) tokens (block index
    start // bt), so an unaligned start would silently round down there;
    the port refuses it, and a window past the cache end, on every device."""
    if cache.dim() != 5 or min(cache.shape) == 0:
        raise ValueError(f"cache must be a non-empty [L,B,S,H,D], got {tuple(cache.shape)}")
    s = cache.shape[2]
    bt = min(token_block, width)
    if width <= 0 or bt <= 0 or width % bt:
        raise ValueError(f"width {width} is not a multiple of the token block {bt}")
    for t0 in starts:
        if t0 % bt:
            raise ValueError(f"start {t0} is not aligned to the token block {bt}")
        if t0 < 0 or t0 + width > s:
            raise ValueError(f"window [{t0}, {t0 + width}) outside the cache of {s} tokens")


def check_ragged_args(cache: torch.Tensor, starts: Sequence[int], width: int,
                      token_block: int) -> None:
    """`check_pack_args` for a window per batch row: one start per row."""
    if cache.dim() == 5 and len(starts) != cache.shape[1]:
        raise ValueError(f"{len(starts)} starts for {cache.shape[1]} batch rows")
    check_pack_args(cache, starts, width, token_block)


def _vec_bytes(*vals: int) -> int:
    for v in (16, 8, 4, 2):
        if all(x % v == 0 for x in vals):
            return v
    raise ValueError("cache rows are not 2-byte aligned")


def _cache_layout(cache: torch.Tensor):
    """Checks shared by the three copies; returns (lib, row bytes, layer
    and batch strides in bytes)."""
    if not cache.is_cuda:
        raise ValueError("the kv_pack kernels take CUDA tensors; use "
                         "repro_torch.kernels.ops for the CPU")
    if cache.dtype not in _DTYPES:
        raise TypeError(f"kv_pack takes float32 or bfloat16, not {cache.dtype}")
    _, b, _, h, d = cache.shape
    if cache.stride(4) != 1 or cache.stride(3) != d or cache.stride(2) != h * d:
        raise ValueError("the [S,H,D] dims of the cache must be contiguous")
    lib = _build.lib("kv_pack")
    if b > lib.repro_kv_pack_max_rows():
        raise ValueError(f"{b} batch rows exceed the kernel's "
                         f"{lib.repro_kv_pack_max_rows()}")
    es = cache.element_size()
    return lib, h * d * es, cache.stride(0) * es, cache.stride(1) * es


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(cache: torch.Tensor, starts: Optional[Sequence[int]], t0: int,
            width: int) -> torch.Tensor:
    lib, row_bytes, sl, sb = _cache_layout(cache)
    l, b, _, h, d = cache.shape
    out = torch.empty((l, b, width, h, d), dtype=cache.dtype, device=cache.device)
    vec = _vec_bytes(cache.data_ptr(), out.data_ptr(), row_bytes, sl, sb)
    # host starts: the C side copies them into the launch's parameters
    host = None if starts is None else (ctypes.c_int * b)(*starts)
    err = lib.repro_kv_pack(
        cache.data_ptr(), out.data_ptr(),
        None if host is None else ctypes.cast(host, ctypes.c_void_p), t0, l, b, sl, sb,
        row_bytes, width, vec, _stream(cache))
    _build.check(err, "kv_pack")
    return out


def kv_pack(cache: torch.Tensor, t0: int, *, width: int,
            token_block: int = 8) -> torch.Tensor:
    """cache[:, :, t0:t0+width] as a new dense [L,B,width,H,D] (CUDA).
    t0 is a host int, a multiple of min(token_block, width)."""
    t0 = int(t0)
    check_pack_args(cache, [t0], width, token_block)
    out = _launch(cache, None, t0, width)
    LAUNCHES["kv_pack"] += 1
    return out


def kv_pack_ragged(cache: torch.Tensor, starts: Sequence[int], *, width: int,
                   token_block: int = 8) -> torch.Tensor:
    """Row b of the result is cache[:, b, starts[b]:starts[b]+width] (CUDA).
    `starts` are host ints (the scheduler's positions), checked here and
    passed to the kernel by value."""
    starts = [int(s) for s in starts]
    check_ragged_args(cache, starts, width, token_block)
    out = _launch(cache, starts, 0, width)
    LAUNCHES["kv_pack_ragged"] += 1
    return out


def check_unpack_args(cache: torch.Tensor, buf: torch.Tensor, t0: int,
                      token_block: int) -> None:
    """`check_pack_args` for the inverse copy, plus the buffer's shape."""
    if buf.dim() != 5 or cache.dim() != 5 or buf.shape[:2] != cache.shape[:2] \
            or buf.shape[3:] != cache.shape[3:]:
        raise ValueError(f"buffer {tuple(buf.shape)} does not fit the cache "
                         f"{tuple(cache.shape)}")
    check_pack_args(cache, [t0], buf.shape[2], token_block)


def kv_unpack(cache: torch.Tensor, buf: torch.Tensor, t0: int, *,
              token_block: int = 8) -> torch.Tensor:
    """Write buf [L,B,W,H,D] into cache[:, :, t0:t0+W] in place (CUDA) and
    return the cache.  t0 and W are multiples of min(token_block, W); the
    cache may be a view whose [S,H,D] dims are contiguous."""
    t0 = int(t0)
    check_unpack_args(cache, buf, t0, token_block)
    lib, row_bytes, sl, sb = _cache_layout(cache)
    if buf.device != cache.device or buf.dtype != cache.dtype or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous {cache.dtype} tensor on {cache.device}")
    l, b, width = buf.shape[:3]
    vec = _vec_bytes(cache.data_ptr(), buf.data_ptr(), row_bytes, sl, sb)
    err = lib.repro_kv_unpack(cache.data_ptr(), buf.data_ptr(), t0, l, b, sl, sb, row_bytes,
                              width, vec, _stream(cache))
    _build.check(err, "kv_unpack")
    LAUNCHES["kv_unpack"] += 1
    return cache
