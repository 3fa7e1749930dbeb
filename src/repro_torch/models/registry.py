"""build_model(cfg) — family dispatch for the unified Model API
(counterpart of `repro.models.registry`).

Every model exposes ``init(generator)``, ``prefill(params, batch, max_len)``
and ``decode_step(params, state, token, pos)``; training (``loss``) and the
moe, encdec and vlm families are later slices.
"""
from __future__ import annotations

from repro_torch import not_ported
from repro_torch.configs.base import ArchConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.transformer import DecoderLM

_FAMILIES = {"dense": DecoderLM, "ssm": MambaLM, "hybrid": HybridLM}


def build_model(cfg: ArchConfig, device="cuda"):
    if cfg.family not in _FAMILIES:
        not_ported(**{f"family={cfg.family}": cfg.family in ("moe", "encdec", "vlm")})
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device)
