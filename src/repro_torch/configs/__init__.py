"""Architecture config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "rps-paper-mlp": "repro_torch.configs.rps_paper",
}
# the reference's vlm and audio families, whose models are not ported yet
NOT_PORTED = ("llava-next-mistral-7b", "whisper-large-v3")


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
