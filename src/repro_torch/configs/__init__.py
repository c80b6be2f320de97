"""Architecture configs of the LM framework (the dense, moe, ssm and
encdec ones are ported: :data:`PORTED`)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.registry import ARCHS, PORTED, get

__all__ = ["ARCHS", "PORTED", "SHAPES", "ArchConfig", "ShapeConfig", "get",
           "shape_applicable"]
