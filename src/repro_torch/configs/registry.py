"""Registry of the port's architectures: those it serves, and the paper's
evaluation models, which the cost model, the planner and the simulator
read (`PAPER_ARCHS`; opt-66b and bloom-176b have no weights and nothing
serves them)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.bloom_176b import CONFIG as _bloom
from repro_torch.configs.gpt2_1_5b import CONFIG as _gpt2
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.opt_66b import CONFIG as _opt66b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_gpt2, _mamba2, _hymba)}

# the paper's own evaluation models
PAPER_ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_opt66b, _bloom, _gpt2)}

_ALL = {**ARCHS, **PAPER_ARCHS}


def get_arch(name: str) -> ArchConfig:
    if name not in _ALL:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ALL)}")
    return _ALL[name]
