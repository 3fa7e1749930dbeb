"""Shared model building blocks: norms, activations, positional encodings and
weight init (counterparts of `repro.models.common`).

Norms compute in f32 and cast back, and scale by ``(1 + scale)`` with
zero-initialised scales, as the reference does; `torch.nn.LayerNorm` with the
bridged weight as-is would compute a different function.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float()) + bias.float()).to(dtype)


def norm_apply(kind: str, x, p):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(kind: str, d: int, dtype, device):
    z = lambda: torch.zeros((d,), dtype=dtype, device=device)   # noqa: E731
    if kind == "rmsnorm":
        return {"scale": z()}
    return {"scale": z(), "bias": z()}


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float):
    """x [..., S, H, Dh]; positions [..., S] int (broadcastable)."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), device=x.device)        # [Dh/2]
    angles = positions[..., None].float() * freqs                          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                                  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(num_heads: int):
    """ALiBi per-head slopes (BLOOM)."""
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(num_heads).is_integer():
        return np.asarray(pow2slopes(num_heads), np.float32)
    n = 2 ** math.floor(math.log2(num_heads))
    base = pow2slopes(n)
    extra = pow2slopes(2 * n)[0::2][: num_heads - n]
    return np.asarray(base + extra, np.float32)


def _truncated_normal(shape, generator: torch.Generator, lo=-2.0, hi=2.0):
    """Standard normal truncated to [lo, hi] by inverse-CDF sampling on the
    generator's device."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))   # noqa: E731
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (cdf(hi) - cdf(lo)) + cdf(lo)
    return (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(lo, hi)


def dense_init(generator, shape, dtype, device, scale: Optional[float] = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (std * _truncated_normal(shape, generator)).to(device=device, dtype=dtype)


def embed_init(generator, shape, dtype, device):
    return (0.02 * _truncated_normal(shape, generator)).to(device=device, dtype=dtype)


def head_init(generator, cfg, dtype, device) -> dict:
    """The final norm and, for an untied head, lm_head [d, V]."""
    p = {"final_norm": norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return p


def unembed(cfg, params, x):
    """The final norm, then the tied or untied LM head: x [..., d] -> [..., V]."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return norm_apply(cfg.norm, x, params["final_norm"]) @ head


def stack_layers(items):
    """Per-layer parameter trees -> one tree with the layers stacked [L, ...]."""
    if isinstance(items[0], dict):
        return {k: stack_layers([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def layer_params(layers, i: int):
    """Layer i's parameters from a stacked ``[L, ...]`` tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}
