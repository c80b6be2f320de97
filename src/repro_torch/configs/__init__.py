"""Architecture configs of the LM framework (``qwen3-0.6b`` is ported)."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, PORTED, get

__all__ = ["ARCHS", "PORTED", "SHAPES", "ArchConfig", "ShapeConfig", "get"]
