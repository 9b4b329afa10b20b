"""Config registry: ``get_config(name)`` / ``list_configs()``, the
counterpart of :mod:`repro.configs` (data, copied whole).

Each assigned architecture has one module exporting ``CONFIG``; the exact
dimensions follow the assignment table (source papers cited per config).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, BlockSpec, InputShape, ModelConfig

ARCH_IDS = [
    "internvl2-76b",
    "mamba2-130m",
    "kimi-k2-1t-a32b",
    "llama3.2-3b",
    "phi3-mini-3.8b",
    "starcoder2-3b",
    "seamless-m4t-large-v2",
    "internlm2-1.8b",
    "deepseek-v2-lite-16b",
    "jamba-v0.1-52b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "BlockSpec",
    "InputShape",
    "ModelConfig",
    "get_config",
    "list_configs",
]
