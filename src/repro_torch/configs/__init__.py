"""Architecture registry (the JAX package's archs)."""
from .base import SHAPES, ArchConfig, LayerSpec, NodeConfig, ShapeConfig
from .registry import (ARCH_IDS, cell_is_applicable, get_arch,
                       get_smoke_arch)

__all__ = ["ArchConfig", "LayerSpec", "NodeConfig", "ShapeConfig", "SHAPES",
           "ARCH_IDS", "cell_is_applicable", "get_arch", "get_smoke_arch"]
