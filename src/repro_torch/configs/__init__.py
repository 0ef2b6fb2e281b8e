"""Architecture config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, SHAPES,  # noqa: F401
                                      ShapeConfig)

_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "rps-paper-mlp": "repro_torch.configs.rps_paper",
}

ARCH_IDS = [k for k in _MODULES if k != "rps-paper-mlp"]


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
