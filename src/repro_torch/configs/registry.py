"""Arch registry: ``--arch <id>`` resolution for the launchers; the same
ids as the JAX package's."""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-1.7b": "qwen3_1_7b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = tuple(_MODULES)

# archs whose attention is strictly quadratic-full: long_500k is skipped
FULL_ATTENTION_ARCHS = frozenset({
    "deepseek-v2-lite-16b", "qwen3-1.7b", "minicpm-2b", "qwen3-0.6b",
    "stablelm-12b", "internvl2-1b", "seamless-m4t-medium",
})


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_arch(arch_id: str) -> ArchConfig:
    return _mod(arch_id).FULL


def get_smoke_arch(arch_id: str) -> ArchConfig:
    return _mod(arch_id).SMOKE


def cell_is_applicable(arch_id: str, shape_name: str) -> bool:
    return not (shape_name == "long_500k"
                and arch_id in FULL_ATTENTION_ARCHS)
