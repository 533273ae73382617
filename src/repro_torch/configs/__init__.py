"""Architecture config registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port serves the attention-only architectures (dense, MoE, audio and
VLM backbones), so it registers those configs, in the reference's order; the
recurrent hybrids (mamba2, recurrentgemma) join with their model code.
Every config cites its source in the module docstring.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "musicgen-large",
    "granite-8b",
    "qwen2-1.5b",
    "qwen3-moe-30b-a3b",
    "llava-next-mistral-7b",
    "chatglm3-6b",
    "gemma2-9b",
    "mixtral-8x7b",
    "qwen3-14b",
]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
