"""paged_prefill_attention as hand-written CUDA (``csrc/paged_prefill.cu``),
replacing the TPU kernel of `repro.kernels.paged_prefill`.

A chunk of C queries per sequence, q [B,C,Hq,D] at positions q_starts[b]..,
attends causally over the K/V pages [N,bs,Hkv,D] it reads in place through
its block-table row; the chunk's own K/V are already in the pages.  The
wrapper takes CUDA tensors only (the CPU goes to the plain version through
`repro_torch.kernels.ops`), checks what the kernel needs, allocates the
output and counts its launches.  The C function picks the body by dtype:
bf16 runs on wgmma over cp.async-fed page tiles, float32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build, refuse_grad
from repro_torch.kernels.decode_attention import (MAX_SMEM, _DTYPE_CODE, _int_vec,
                                                  check_pages, check_tables)
from repro_torch.kernels.flash_attention import HEAD_DIMS


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_tables: torch.Tensor, q_starts: torch.Tensor,
                            q_lens: torch.Tensor) -> torch.Tensor:
    """q [B,C,Hq,D]; k/v_pages [N,bs,Hkv,D] (see
    `decode_attention.check_pages`; not copied); block_tables [B,max_blocks]
    int32; q_starts, q_lens [B] int32 -> [B,C,Hq,D] in q.dtype.  Query i of
    sequence b sees slot j iff j <= q_starts[b] + i and j < q_starts[b] +
    q_lens[b]; rows past q_lens[b] are don't-care.  Table entries past a
    sequence's first ceil(min(q_starts[b] + q_lens[b], max_blocks*bs) / bs)
    are never read and may hold any value."""
    what = "paged_prefill_attention"
    if not q.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; use repro_torch.kernels.ops "
                         "for the CPU")
    refuse_grad(what, q, k_pages, v_pages)
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    dev = q.device
    if q.dim() != 4 or k_pages.device != dev or v_pages.device != dev:
        raise ValueError(f"{what}: want q [B,C,Hq,D] and pages on {dev}, got "
                         f"{tuple(q.shape)}")
    page_stride = check_pages(k_pages, v_pages, what)
    b, c, hq, d = q.shape
    _, bs, hkv, dk = k_pages.shape
    if dk != d or hkv == 0 or hq % hkv or b == 0 or c == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported (the kernel takes {HEAD_DIMS})")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    max_blocks = check_tables(block_tables, b, dev, what)
    _int_vec(q_starts, b, "q_starts", dev)
    _int_vec(q_lens, b, "q_lens", dev)
    lib = _build.lib("paged_prefill")
    smem = lib.repro_paged_prefill_smem(_DTYPE_CODE[q.dtype], d)
    if smem > MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory per block exceed {MAX_SMEM}")
    out = torch.empty_like(q)
    err = lib.repro_paged_prefill_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), q_starts.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
        b, c, max_blocks, bs, page_stride, hq, hkv, d, float(d) ** -0.5,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, what)
    LAUNCHES["paged_prefill_attention"] += 1
    return out
