"""Decode-state structures (the port's copy of `repro.kvcache.cache`).

The decode state is a nested dict of tensors so that DéjàVuLib streaming can
address leaves by path.  Layouts:

dense, moe, vlm    {"kv": {"k": [L,B,S,Hkv,Dh], "v": ...}}   (vlm: S counts the patches)
encdec             {"kv": ..., "cross": {"k": [L,B,Ssrc,Hkv,Dh], "v": ...}}
ssm (mamba2)       {"conv": [L,B,K-1,conv_dim], "ssd": [L,B,nh,hd,N] f32}
hybrid (hymba)     {"kv_swa":  {"k": [Lswa,B,M+W,Hkv,Dh], "v": ...},
                    "kv_full": {"k": [Lfull,B,M+S,Hkv,Dh], "v": ...},
                    "swa_pos": [M+W] int32 (absolute position per slot, -1 = empty),
                    "conv": [L,B,K-1,conv_dim], "ssd": [L,B,nh,hd,N] f32}

For the attention-free and hybrid families the paper's "KV cache"
generalises to this decode state: everything that must be swapped, streamed
or replicated to resume generation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import ArchConfig


def _conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def decode_state_shapes(cfg: ArchConfig, batch: int, seq_len: int,
                        layers: Optional[int] = None) -> Dict:
    """Nested dict of (shape, torch dtype) describing the decode state of
    `layers` layers (default: the whole model; a pipeline stage of a dense
    model passes its own layer count)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if layers is not None and cfg.family in ("hybrid", "encdec"):
        raise ValueError(f"a {cfg.family} decode state covers the whole model "
                         "(no stage layout)")
    L = cfg.num_layers if layers is None else layers
    dt = torch_dtype(cfg.dtype)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        shape = (L, batch, seq_len, hkv, dh)
        kv = {"kv": {"k": (shape, dt), "v": (shape, dt)}}
        if cfg.family == "encdec":
            src = (L, batch, min(cfg.max_source_len, seq_len), hkv, dh)
            kv["cross"] = {"k": (src, dt), "v": (src, dt)}
        return kv
    ssm = {"conv": ((L, batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dt),
           "ssd": ((L, batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)}
    if cfg.family == "ssm":
        return ssm
    m = cfg.num_meta_tokens
    n_full = len(cfg.full_attn_layers)
    w = m + min(cfg.sliding_window, seq_len + m)
    swa = (L - n_full, batch, w, hkv, dh)
    full = (n_full, batch, seq_len + m, hkv, dh)
    return {"kv_swa": {"k": (swa, dt), "v": (swa, dt)},
            "kv_full": {"k": (full, dt), "v": (full, dt)},
            "swa_pos": ((w,), torch.int32), **ssm}


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    return fn(*shapes)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, device="cuda",
                      layers: Optional[int] = None) -> Dict:
    """The empty decode state of `layers` layers on `device`: zeros, and -1
    (no position) in the int32 slot-position vector."""
    def mk(shape, dt):
        if dt == torch.int32:
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    return _map_shapes(decode_state_shapes(cfg, batch, seq_len, layers=layers), mk)


def state_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    return state.numel() * state.element_size()
