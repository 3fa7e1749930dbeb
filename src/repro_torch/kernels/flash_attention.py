"""flash_attention as hand-written CUDA (``csrc/flash_attention.cu``),
replacing the TPU kernel of `repro.kernels.flash_attention`, and its
backward (``csrc/flash_attention_bwd.cu``), which has no TPU counterpart:
the reference trains through XLA's attention.

Whole-prompt attention: q [B,Sq,Hq,D] over k/v [B,Skv,Hkv,D], causal with
the offset of a query block at the end of the keys, or full.  The wrappers
take CUDA tensors only (the CPU goes to the plain version through
`repro_torch.kernels.ops`), check what the kernels need, allocate the
outputs and count their launches.  The forward's C function picks the body
by dtype: bf16 runs on wgmma with TMA loads (split over a cluster of blocks
where its query tiles leave the SMs short, `split_plan`), float32 on the
CUDA cores; so
does the backward's, bf16 on warp-specialised wgmma over a TMA ring (on
mma.sync at head dim 192), float32 on the CUDA cores.
`FlashAttentionFn` ties the two together for autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 192)


def _check(q, k, v, causal: bool):
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


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def split_plan(dtype: torch.dtype, b: int, sq: int, skv: int, hq: int, d: int) -> int:
    """Blocks of the cluster that shares each query tile's key tiles in a
    `flash_attention` call at these shapes (1: no split), chosen from the
    shapes alone: bf16 splits where its query tiles leave the SMs short,
    float32 never."""
    return _build.lib("flash_attention").repro_flash_attention_splits(
        _DTYPE_CODE[dtype], b, sq, skv, hq, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, with_lse: bool = False):
    """q [B,Sq,Hq,D]; k/v [B,Skv,Hkv,D] -> [B,Sq,Hq,D] in q.dtype.  Causal:
    query i sees keys j <= i + (Skv - Sq), so a causal call needs Sq <= Skv.
    With `with_lse`, returns (out, lse) where lse [B,Hq,Sq] f32 is each
    query row's log-sum-exp of its scaled scores, which the backward
    needs; serving leaves it off and the kernel writes none."""
    _check(q, k, v, causal)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lib = _build.lib("flash_attention")
    out = torch.empty_like(q)
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if with_lse
           else None)
    err = lib.repro_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
        float(d) ** -0.5, _stream(q))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True):
    """The gradient of `flash_attention` (FlashAttention's backward, dQ in
    a pass of its own): dout and out [B,Sq,Hq,D] like q, lse [B,Hq,Sq] f32
    from the forward -> (dq, dk, dv) in q.dtype, each accumulated in f32.
    Deterministic: no atomics, a KV head's G query heads summed inside one
    block.  The bf16 body's TMA maps over q, dout, k and v are encoded for
    each call, inside the C function."""
    _check(q, k, v, causal)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for t, name in ((dout, "dout"), (out, "out")):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and shaped as q "
                             f"{tuple(q.shape)} {q.dtype}; got {tuple(t.shape)} {t.dtype}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 [{b},{hq},{sq}] on {q.device}")
    lib = _build.lib("flash_attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    err = lib.repro_flash_attention_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), float(d) ** -0.5, _stream(q))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with its backward kernel: the forward launches with
    the LSE output and saves q, k, v, out and lse; the backward launches
    `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(dout.contiguous(), q, k, v, out, lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None
