"""ssd_scan as hand-written CUDA (``csrc/ssd_scan.cu``), replacing the TPU
kernel of `repro.kernels.ssd_scan`, and its backward
(``csrc/ssd_scan_bwd.cu``), which has no TPU counterpart: the reference
trains through XLA's `ssd_chunked`.

The chunked Mamba-2 SSD scan: x [B,S,nh,hd], dt [B,S,nh] f32, a_neg [nh]
f32, B/C [B,S,G,N], an optional initial state h0 [B,nh,hd,N] f32 -> (y
[B,S,nh,hd] in x.dtype, the final state [B,nh,hd,N] f32).  The wrappers
take CUDA tensors only (the CPU goes to the plain version through
`repro_torch.kernels.ops`), check what the kernels need, allocate the
outputs and count their launches.  Each C function picks the body by
dtype: bf16 runs its products on the tensor cores, float32 on the CUDA
cores.  `SSDScanFn` ties the two together for autograd.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448          # bytes of shared memory one block may use (H100)
MAX_CHUNK = 256


def _check(x, dt, a_neg, bmat, cmat, h0, chunk: int, what: str) -> int:
    """The checks both kernels share; returns Q = min(chunk, S)."""
    if not x.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; use repro_torch.kernels.ops "
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
    return q


def _smem(kernel: str, dtype, hd: int, n: int, q: int) -> None:
    """Raise unless one block of `kernel` fits the shared memory of an SM."""
    lib = _build.lib(kernel)
    smem = getattr(lib, f"repro_{kernel}_smem")(_DTYPE_CODE[dtype], hd, n, q)
    if not 0 <= smem <= MAX_SMEM:
        raise ValueError(f"{kernel}: hd {hd}, N {n}, chunk {q} need more than {MAX_SMEM} "
                         "bytes of shared memory per block")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, h0: Optional[torch.Tensor] = None, *, chunk: int = 128,
             with_states: bool = False):
    """Chunks of Q = min(chunk, S) tokens, walked in order per (batch row,
    head).  Returns (y, h_final); with `with_states`, (y, h_final, states)
    where states [B, ceil(S/Q), nh, hd, N] f32 holds the state entering each
    chunk, which the backward needs; serving leaves it off and the kernel
    writes none."""
    q = _check(x, dt, a_neg, bmat, cmat, h0, chunk, "ssd_scan")
    b, s, nh, hd = x.shape
    n = bmat.shape[3]
    _smem("ssd_scan", x.dtype, hd, n, q)
    lib = _build.lib("ssd_scan")
    y = torch.empty_like(x)
    hout = torch.empty(b, nh, hd, n, dtype=torch.float32, device=x.device)
    states = (torch.empty(b, -(-s // q), nh, hd, n, dtype=torch.float32, device=x.device)
              if with_states else None)
    err = lib.repro_ssd_scan(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), _ptr(h0), y.data_ptr(), hout.data_ptr(), _ptr(states), b, s, nh, hd,
        bmat.shape[2], n, q, _stream(x))
    _build.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return (y, hout, states) if with_states else (y, hout)


def ssd_scan_bwd(dy: torch.Tensor, dh_final: Optional[torch.Tensor], x: torch.Tensor,
                 dt: torch.Tensor, a_neg: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 h0: Optional[torch.Tensor], states: torch.Tensor, h_final: torch.Tensor, *,
                 chunk: int = 128):
    """The gradient of `ssd_scan`: dy [B,S,nh,hd] in x.dtype and dh_final
    [B,nh,hd,N] f32 (None: zero), with the forward's inputs, its `states`
    and h_final -> (dx, ddt, da, dB, dC, dh0): dx, dB and dC in x.dtype,
    ddt, da and dh0 f32, dh0 None without h0.  Deterministic: no atomics,
    the heads of a group summed in a fixed order.  Its f32 scratch (the
    gradients of the chunk states, one dB and dC slab per slice of a
    group's heads) comes from `torch.empty`."""
    q = _check(x, dt, a_neg, bmat, cmat, h0, chunk, "ssd_scan_bwd")
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    nc = -(-s // q)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {x.dtype} {list(x.shape)}, got {dy.dtype} "
                         f"{list(dy.shape)}")
    f32 = {"states": (states, (b, nc, nh, hd, n)), "h_final": (h_final, (b, nh, hd, n))}
    if dh_final is not None:
        f32["dh_final"] = (dh_final, (b, nh, hd, n))
    for name, (t, shape) in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    for name, t in {"dy": dy, **{k: v for k, (v, _) in f32.items()}}.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    _smem("ssd_scan_bwd", x.dtype, hd, n, q)
    lib = _build.lib("ssd_scan_bwd")
    slices = lib.repro_ssd_scan_bwd_slices(b, s, nh, g, q)
    f = dict(dtype=torch.float32, device=x.device)
    dhout = torch.empty(b, nc, nh, hd, n, **f)
    dlast, dapart = torch.empty(b, nc, nh, **f), torch.empty(b, nc, nh, **f)
    dbslab, dcslab = torch.empty(slices, b, s, g, n, **f), torch.empty(slices, b, s, g, n, **f)
    dx, dbm, dcm = torch.empty_like(x), torch.empty_like(bmat), torch.empty_like(cmat)
    ddt, da = torch.empty(b, s, nh, **f), torch.empty(nh, **f)
    dh0 = None if h0 is None else torch.empty(b, nh, hd, n, **f)
    err = lib.repro_ssd_scan_bwd(
        _DTYPE_CODE[x.dtype], dy.data_ptr(), _ptr(dh_final), x.data_ptr(), dt.data_ptr(),
        a_neg.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), states.data_ptr(),
        h_final.data_ptr(), dhout.data_ptr(), dlast.data_ptr(), dbslab.data_ptr(),
        dcslab.data_ptr(), dapart.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        dbm.data_ptr(), dcm.data_ptr(), _ptr(dh0), b, s, nh, hd, g, n, q, slices, _stream(x))
    _build.check(err, "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, da, dbm, dcm, dh0


class SSDScanFn(torch.autograd.Function):
    """`ssd_scan` with its backward kernel: the forward checks that the
    backward fits the card, launches with the chunk states and saves the
    inputs, the states and h_final; the backward launches `ssd_scan_bwd`
    (dh_final None where the caller dropped h_final, as both losses do)."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, bmat, cmat, h0, chunk: int):
        q = _check(x, dt, a_neg, bmat, cmat, h0, chunk, "ssd_scan")
        _smem("ssd_scan_bwd", x.dtype, x.shape[3], bmat.shape[3], q)
        y, hout, states = ssd_scan(x, dt, a_neg, bmat, cmat, h0, chunk=chunk,
                                   with_states=True)
        ctx.save_for_backward(x, dt, a_neg, bmat, cmat, h0, states, hout)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hout

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a_neg, bmat, cmat, h0, states, hout = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        dh_final = None if dh_final is None else dh_final.float().contiguous()
        grads = ssd_scan_bwd(dy, dh_final, x, dt, a_neg, bmat, cmat, h0, states, hout,
                             chunk=ctx.chunk)
        return (*grads, None)
