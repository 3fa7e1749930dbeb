from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM", "EncDecLM", "HybridLM", "MambaLM", "build_model"]
