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


def params_from_jax(cfg: ArchConfig, params_np: Dict, device="cuda") -> Dict:
    dev = resolve_device(device)
    embed = params_np["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(embed.shape)} does not match {cfg.name}: "
                         f"({cfg.vocab_size}, {cfg.d_model})")
    layers = params_np["layers"]
    for block, leaf in _STACKED.get(cfg.family, (("attn", "wq"),)):
        if block not in layers:
            raise ValueError(f"params have no layers.{block} stack, which a {cfg.family} "
                             f"model ({cfg.name}) needs")
        n = layers[block][leaf].shape[0]
        if n != cfg.num_layers:
            raise ValueError(f"params stack {n} layers in layers.{block}.{leaf}, "
                             f"config has {cfg.num_layers}")
    return _convert(params_np, dev)
