"""Arch registry: ``--arch <id>`` resolution for the launchers.

Only the archs whose layers are ported resolve; the JAX package's other
ids raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
}
# the JAX package's other archs: MLA, MoE, Mamba, xLSTM, enc-dec, the VLM
# frontend, and the dense configs not ported yet
_NOT_PORTED = ("mixtral-8x7b", "deepseek-v2-lite-16b", "qwen3-1.7b",
               "minicpm-2b", "stablelm-12b", "internvl2-1b", "xlstm-1.3b",
               "seamless-m4t-medium", "jamba-v0.1-52b")

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ROADMAP "
            f"queue 1, item 13); have {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_arch(arch_id: str) -> ArchConfig:
    return _mod(arch_id).FULL


def get_smoke_arch(arch_id: str) -> ArchConfig:
    return _mod(arch_id).SMOKE
