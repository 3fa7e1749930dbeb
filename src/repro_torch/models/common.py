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
import torch.utils.checkpoint

from repro_torch.models.losses import causal_lm_loss


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def rmsnorm(x, scale, eps: float = 1e-6, tp=None):
    """RMSNorm over the last dim; under `tp` (a `distributed.tensor_parallel.
    Split`), x is a rank's share of the Mamba-2 block's d_inner channels
    and the mean of squares is over all of them."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    if tp is not None:
        var = tp.inner_mean(var, x.shape[-1])
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
    generator's device, in place in one f32 buffer: a full-width embedding
    (nemotron's 256,000 x 18,432) is 18.9 GB of it."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))   # noqa: E731
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.mul_(cdf(hi) - cdf(lo)).add_(cdf(lo))
    return u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)


def dense_init(generator, shape, dtype, device, scale: Optional[float] = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _truncated_normal(shape, generator).mul_(std).to(device=device, dtype=dtype)


def embed_init(generator, shape, dtype, device):
    return _truncated_normal(shape, generator).mul_(0.02).to(device=device, dtype=dtype)


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


def hooked(lp, tp, stack: str = "layers"):
    """The per-layer parameter hook: a layer's weights as they are, or under
    `tp` (a `distributed.tensor_parallel.Split`) those its rank computes
    with (`stack` names the stacked layers they come from)."""
    return lp if tp is None else tp.layer(lp, stack)


def lookup(table, tokens, tp=None):
    """Token embeddings; under `tp` vocabulary-parallel."""
    return F.embedding(tokens, table) if tp is None else tp.embed(table, tokens)


def head(cfg, params, x, tp=None):
    """`unembed`; under `tp` the rank's vocabulary columns."""
    return unembed(cfg, params, x) if tp is None else tp.logits(params, x)


def lm_loss(cfg, params, x, batch, tp=None, skip: int = 0):
    """The causal-LM loss of the hidden states x [B,S,d] past their first
    `skip` positions (a prefix the head does not read) against the batch's
    targets and mask, through the head; under `tp` vocabulary-parallel,
    `x` the rank's slice of a stream cut over `model` (`Split.on_seq`)."""
    if tp is None:
        return causal_lm_loss(unembed(cfg, params, x[:, skip:] if skip else x),
                              batch["targets"], batch["loss_mask"])
    return tp.lm_loss(tp.logits(params, x, skip), batch["targets"], batch["loss_mask"])


def on_seq(tp, length: int):
    """`tp` for a residual stream of `length` tokens (`Split.on_seq`)."""
    return None if tp is None else tp.on_seq(length)


def scatter(x, tp, dim: int = 1):
    """`x`, whole on every rank, as the rank's slice of `tp`'s stream."""
    return x if tp is None else tp.scatter(x, dim)


def shared(p, tp):
    """Weights applied to the rank's slice of `tp`'s stream (`Split.shared`)."""
    return p if tp is None else tp.shared(p)


def stack_layers(items):
    """Per-layer parameter trees -> one tree with the layers stacked [L, ...]."""
    if isinstance(items[0], dict):
        return {k: stack_layers([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def layer_params(layers, i: int):
    """Layer i's parameters from a stacked ``[L, ...]`` tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def unstack_layers(layers, n: int):
    """Every layer's parameters from a stacked ``[L, ...]`` tree, by one
    `unbind` a leaf: its backward stacks the L gradients once, where L
    `layer_params` views would each add a zero-filled [L, ...] gradient."""
    if isinstance(layers, dict):
        per_key = {k: unstack_layers(v, n) for k, v in layers.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return layers.unbind(0)


def run_layer(fn, remat: bool, *args):
    """fn(*args), or with `remat` under activation checkpointing: the
    forward keeps only the layer's inputs and runs again in the backward,
    as the reference's ``jax.checkpoint(body)``."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
