"""Hand the reference's weights to the port.

`params_from_jax` takes the JAX package's params pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``) and returns the
port's nested dict of tensors, same keys, same stacked ``[L, ...]`` layer
layout, bit for bit: a float32 leaf of a bfloat16 model (the SSD block's
``A_log``, ``dt_bias``, ``D``) stays float32.  It needs neither JAX nor
ml_dtypes: a bfloat16 leaf is reinterpreted through its 16-bit pattern.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)                   # a writable copy: the port owns its weights
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


# per family, the stacked leaves whose first axis must be the layer count
_STACKED = {"ssm": (("ssm", "w_in"),), "hybrid": (("attn", "wq"), ("ssm", "w_in")),
            "moe": (("attn", "wq"), ("moe", "w_gate"))}


def _stacks(cfg: ArchConfig):
    """(stack key, layer count, the leaves to check) of each layer stack."""
    if cfg.family == "encdec":
        return (("enc_layers", cfg.num_encoder_layers, (("attn", "wq"), ("mlp", "w_down"))),
                ("dec_layers", cfg.num_layers, (("attn", "wq"), ("cross", "wq"))))
    return (("layers", cfg.num_layers, _STACKED.get(cfg.family, (("attn", "wq"),))),)


def params_from_jax(cfg: ArchConfig, params_np: Dict, device="cuda") -> Dict:
    dev = resolve_device(device)
    embed = params_np["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(embed.shape)} does not match {cfg.name}: "
                         f"({cfg.vocab_size}, {cfg.d_model})")
    for stack, want, leaves in _stacks(cfg):
        layers = params_np.get(stack, {})
        for block, leaf in leaves:
            if block not in layers:
                raise ValueError(f"params have no {stack}.{block} stack, which a "
                                 f"{cfg.family} model ({cfg.name}) needs")
            n = layers[block][leaf].shape[0]
            if n != want:
                raise ValueError(f"params stack {n} layers in {stack}.{block}.{leaf}, "
                                 f"config has {want}")
    if cfg.family == "vlm":
        proj = params_np.get("patch_proj")
        if proj is None or tuple(proj.shape) != (cfg.d_model, cfg.d_model):
            raise ValueError(f"a vlm model ({cfg.name}) needs patch_proj "
                             f"({cfg.d_model}, {cfg.d_model}), got "
                             f"{None if proj is None else tuple(proj.shape)}")
    return _convert(params_np, dev)
