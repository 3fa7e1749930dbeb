from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, supports_shape
from repro_torch.configs.registry import ARCHS, PAPER_ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "ARCHS", "PAPER_ARCHS", "SHAPES", "ShapeConfig", "get_arch",
           "list_archs", "supports_shape"]
