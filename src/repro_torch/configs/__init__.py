"""Architecture registry: one module per assigned arch.

Port of ``repro/configs/__init__.py``; the config modules are copies of the
reference's data.  ``get_config(name)`` returns the exact published config;
``get_config(name).reduced()`` is the CPU smoke variant.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "zamba2-7b",
    "qwen3-14b",
    "yi-9b",
    "qwen2-7b",
    "granite-20b",
    "falcon-mamba-7b",
    "dbrx-132b",
    "llama4-maverick-400b-a17b",
    "llava-next-34b",
    "whisper-tiny",
]

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "qwen2-7b": "qwen2_7b",
    "granite-20b": "granite_20b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "llava-next-34b": "llava_next_34b",
    "whisper-tiny": "whisper_tiny",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
