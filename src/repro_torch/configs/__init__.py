"""Architecture registry (the ported subset of the JAX package's)."""
from .base import ArchConfig, LayerSpec, NodeConfig
from .registry import ARCH_IDS, get_arch, get_smoke_arch

__all__ = ["ArchConfig", "LayerSpec", "NodeConfig", "ARCH_IDS", "get_arch",
           "get_smoke_arch"]
