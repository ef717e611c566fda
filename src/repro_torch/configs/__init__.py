"""Assigned-architecture configs (public literature) + input shapes — port
of ``repro.configs``.

Every architecture is selectable via ``--arch <id>`` in the launchers; use
:func:`get_config` / :func:`list_archs`.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, InputShape, SHAPES
from .shapes import shape_applicable

ARCH_IDS: List[str] = [
    "mistral-large-123b",
    "h2o-danube-1.8b",
    "gemma-7b",
    "gemma3-4b",
    "zamba2-1.2b",
    "mamba2-370m",
    "paligemma-3b",
    "musicgen-large",
    "deepseek-v2-236b",
    "moonshot-v1-16b-a3b",
]

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma-7b": "gemma_7b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-370m": "mamba2_370m",
    "paligemma-3b": "paligemma_3b",
    "musicgen-large": "musicgen_large",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.config()


def list_archs() -> List[str]:
    return list(ARCH_IDS)
