"""Decode-state structures of the microbatch path (the port's copy of
`repro.kvcache.cache`, dense family).

The decode state is a nested dict of tensors so that DéjàVuLib streaming can
address leaves by path: ``{"kv": {"k": [L,B,S,Hkv,Dh], "v": ...}}``.  The
other families' layouts (encdec cross K/V, ssm and hybrid state) come with
those families.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import not_ported, torch_dtype
from repro_torch.configs.base import ArchConfig


def decode_state_shapes(cfg: ArchConfig, batch: int, seq_len: int,
                        layers: Optional[int] = None) -> Dict:
    """Nested dict of (shape, torch dtype) describing the decode state of
    `layers` layers (default: the whole model; a pipeline stage passes its
    own layer count)."""
    not_ported(**{f"family={cfg.family}": cfg.family != "dense"})
    shape = (cfg.num_layers if layers is None else layers, batch, seq_len,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"kv": {"k": (shape, dt), "v": (shape, dt)}}


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    return fn(*shapes)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, device="cuda",
                      layers: Optional[int] = None) -> Dict:
    """The zero decode state of `layers` layers on `device`."""
    return _map_shapes(decode_state_shapes(cfg, batch, seq_len, layers=layers),
                       lambda shape, dt: torch.zeros(shape, dtype=dt, device=device))


def state_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    return state.numel() * state.element_size()
