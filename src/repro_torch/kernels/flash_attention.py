"""flash_attention as hand-written CUDA (``csrc/flash_attention.cu``),
replacing the TPU kernel of `repro.kernels.flash_attention`.

Whole-prompt attention: q [B,Sq,Hq,D] over k/v [B,Skv,Hkv,D], causal with
the offset of a query block at the end of the keys, or full.  The wrapper
takes CUDA tensors only (the CPU goes to the plain version through
`repro_torch.kernels.ops`), checks what the kernel needs, allocates the
output and counts its launches.  The C function picks the body by dtype:
bf16 runs on wgmma with TMA loads, float32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 192)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,Sq,Hq,D]; k/v [B,Skv,Hkv,D] -> [B,Sq,Hq,D] in q.dtype.  Causal:
    query i sees keys j <= i + (Skv - Sq), so a causal call needs Sq <= Skv."""
    if not q.is_cuda:
        raise ValueError("flash_attention takes CUDA tensors; use "
                         "repro_torch.kernels.ops for the CPU")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv or min(b, sq, skv) == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported (the kernel takes {HEAD_DIMS})")
    if causal and sq > skv:
        raise ValueError(f"causal attention with Sq {sq} > Skv {skv} leaves query rows "
                         "without a key")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {q.device}")
    lib = _build.lib("flash_attention")
    out = torch.empty_like(q)
    err = lib.repro_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), float(d) ** -0.5,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
