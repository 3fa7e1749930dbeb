"""Registry of the architectures the port serves."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gpt2_1_5b import CONFIG as _gpt2
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_gpt2, _mamba2, _hymba)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves: {sorted(ARCHS)}")
    return ARCHS[name]
