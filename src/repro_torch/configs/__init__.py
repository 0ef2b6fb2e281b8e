"""Architecture config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rps-paper-mlp": "repro_torch.configs.rps_paper",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
