"""PyTorch / CUDA port of the DéjàVu serving stack (see `repro` for the JAX
reference).

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``.  On the CPU every
kernel wrapper runs its plain PyTorch version; on a CUDA tensor it launches
the hand-written kernel under `repro_torch.kernels.csrc`.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  No silent fallback: a CUDA
    device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not served (float32 or bfloat16)")
    return _DTYPES[name]


def not_ported(**knobs) -> None:
    """Raise NotImplementedError naming every knob set to a value this
    slice of the port does not serve (left for a later slice)."""
    bad = sorted(k for k, v in knobs.items() if v)
    if bad:
        raise NotImplementedError(
            f"repro_torch does not port {', '.join(bad)} yet (see ROADMAP.md)")
