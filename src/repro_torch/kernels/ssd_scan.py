"""ssd_scan as hand-written CUDA (``csrc/ssd_scan.cu``), replacing the TPU
kernel of `repro.kernels.ssd_scan`.

The chunked Mamba-2 SSD scan: x [B,S,nh,hd], dt [B,S,nh] f32, a_neg [nh]
f32, B/C [B,S,G,N], an optional initial state h0 [B,nh,hd,N] f32 -> (y
[B,S,nh,hd] in x.dtype, the final state [B,nh,hd,N] f32).  The wrapper takes
CUDA tensors only (the CPU goes to the plain version through
`repro_torch.kernels.ops`), checks what the kernel needs, allocates the
outputs and counts its launches.  The C function picks the body by dtype:
bf16 runs its products on the tensor cores, float32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448          # bytes of shared memory one block may use (H100)
MAX_CHUNK = 256


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, h0: Optional[torch.Tensor] = None, *, chunk: int = 128):
    """Chunks of Q = min(chunk, S) tokens, walked in order per (batch row,
    head).  Returns (y, h_final)."""
    if not x.is_cuda:
        raise ValueError("ssd_scan takes CUDA tensors; use repro_torch.kernels.ops "
                         "for the CPU")
    if x.dtype not in _DTYPE_CODE or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16, got "
                        f"{x.dtype}/{bmat.dtype}/{cmat.dtype}")
    if x.dim() != 4 or bmat.dim() != 4 or cmat.shape != bmat.shape:
        raise ValueError(f"want x [B,S,nh,hd], B/C [B,S,G,N]; got {tuple(x.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if bmat.shape[:2] != (b, s) or min(b, s, nh, hd, g, n) == 0 or nh % g:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, B {tuple(bmat.shape)} "
                         "(needs nh % G == 0)")
    f32 = {"dt": (dt, (b, s, nh)), "a_neg": (a_neg, (nh,))}
    if h0 is not None:
        f32["h0"] = (h0, (b, nh, hd, n))
    for name, (t, shape) in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    q = min(int(chunk), s)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    ins = {"x": x, "B": bmat, "C": cmat, **{k: v for k, (v, _) in f32.items()}}
    for name, t in ins.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    lib = _build.lib("ssd_scan")
    smem = lib.repro_ssd_scan_smem(_DTYPE_CODE[x.dtype], hd, n, q)
    if smem > MAX_SMEM:
        raise ValueError(f"hd {hd}, N {n}, chunk {q} need {smem} bytes of shared memory "
                         f"per block, more than {MAX_SMEM}")
    y = torch.empty_like(x)
    hout = torch.empty(b, nh, hd, n, dtype=torch.float32, device=x.device)
    err = lib.repro_ssd_scan(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
        b, s, nh, hd, g, n, q, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, hout
