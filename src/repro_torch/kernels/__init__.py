"""The port's kernels: CUDA sources under ``csrc/``, their wrappers, their
plain PyTorch versions (`ref`) and the `ops` entry points the model calls.

`LAUNCHES` counts, per kernel, the launches its wrapper made on the card; a
wrapper adds one where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("batched_decode_attention", "kv_pack_ragged", "kv_pack", "decode_attention",
           "flash_attention", "kv_unpack", "ssd_scan", "paged_decode_attention",
           "paged_prefill_attention", "flash_attention_bwd", "ssd_scan_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


# the kernels a training step launches, and how many times
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def train_launches(cfg, passes: int, remat: bool = False) -> Dict[str, int]:
    """Each training kernel's launches on the card for `passes` forward and
    backward passes of `cfg`: flash and its backward once per attention
    (every layer of a dense, moe or vlm model, Hymba's global ones; an
    encdec decoder layer's self- and cross-attention, and each encoder
    layer), the SSD scan and its backward once per Mamba-2 or Hymba layer;
    with `remat` each forward runs once more in the backward (an encdec's
    encoder runs without it, as the reference's)."""
    attn = {"ssm": 0, "hybrid": len(cfg.full_attn_layers),
            "encdec": 2 * cfg.num_layers}.get(cfg.family, cfg.num_layers)
    enc = cfg.num_encoder_layers if cfg.family == "encdec" else 0
    ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    fwd = passes * (2 if remat else 1)
    return {"flash_attention": attn * fwd + enc * passes,
            "flash_attention_bwd": (attn + enc) * passes,
            "ssd_scan": ssd * fwd, "ssd_scan_bwd": ssd * passes}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def wants_grad(*tensors) -> bool:
    """Whether autograd records a call on these tensors (None allowed)."""
    import torch
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would record a call of `kernel`, which has no
    backward: its output would silently cut the gradient.  (On the CPU the
    plain versions stay differentiable; flash attention's kernel and the SSD
    scan's, which have backward kernels, go through a
    `torch.autograd.Function` instead.)"""
    if wants_grad(*tensors):
        raise RuntimeError(f"{kernel} has no backward on the card; call it under "
                           "torch.no_grad() or on tensors that do not require grad")
