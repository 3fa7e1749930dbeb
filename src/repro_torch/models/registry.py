"""build_model(cfg) — family dispatch for the unified Model API
(counterpart of `repro.models.registry`).

Every model exposes ``init(generator)``, ``loss(params, batch)``,
``prefill(params, batch, max_len)`` and ``decode_step(params, state, token,
pos)``; a vlm's batches also carry ``patch_embeds``, an encdec's
``src_embeds``.  ``remat`` runs each layer of ``loss`` under activation
checkpointing (an encdec's decoder layers, as the reference's).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.transformer import DecoderLM

_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM, "ssm": MambaLM,
             "hybrid": HybridLM, "encdec": EncDecLM}


def build_model(cfg: ArchConfig, device="cuda", remat: bool = False):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device, remat=remat)
