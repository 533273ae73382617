"""Architecture config registry: ``get_config(arch_id)`` / ``--arch <id>``.

Ten assigned architectures + the paper's own evaluation model (qwen3-14b),
in the reference's order: dense, MoE, audio and VLM backbones, the SSM
(mamba2) and the RG-LRU hybrid (recurrentgemma).  Every config cites its
source in the module docstring.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "musicgen-large",
    "granite-8b",
    "qwen2-1.5b",
    "mamba2-370m",
    "qwen3-moe-30b-a3b",
    "llava-next-mistral-7b",
    "chatglm3-6b",
    "gemma2-9b",
    "mixtral-8x7b",
    "recurrentgemma-9b",
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
