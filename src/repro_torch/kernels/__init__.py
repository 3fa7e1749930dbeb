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
           "paged_prefill_attention", "flash_attention_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


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
    plain versions stay differentiable; flash attention's kernel, which has
    a backward, and the SSD scan's, whose backward raises, go through a
    `torch.autograd.Function` instead.)"""
    if wants_grad(*tensors):
        raise RuntimeError(f"{kernel} has no backward on the card; call it under "
                           "torch.no_grad() or on tensors that do not require grad")
