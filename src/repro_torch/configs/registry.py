"""Registry of the port's architectures: those it serves, and the paper's
evaluation models, which the cost model, the planner and the simulator
read (`PAPER_ARCHS`; opt-66b and bloom-176b have no weights and nothing
serves them)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.bloom_176b import CONFIG as _bloom
from repro_torch.configs.gpt2_1_5b import CONFIG as _gpt2
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.opt_66b import CONFIG as _opt66b
from repro_torch.configs.phi_3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.yi_34b import CONFIG as _yi_34b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (_gpt2, _mamba2, _hymba, _yi_34b, _nemotron, _smollm, _internlm2, _moonshot,
              _qwen3_moe, _phi3v, _seamless)
}

# the paper's own evaluation models
PAPER_ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_opt66b, _bloom, _gpt2)}

_ALL = {**ARCHS, **PAPER_ARCHS}


def get_arch(name: str) -> ArchConfig:
    if name not in _ALL:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ALL)}")
    return _ALL[name]


def list_archs(include_paper: bool = False) -> list[str]:
    """The reference's ten assigned architectures (ARCHS less the paper's
    models), or with `include_paper` every one the registry holds."""
    return sorted(_ALL if include_paper else set(ARCHS) - set(PAPER_ARCHS))
