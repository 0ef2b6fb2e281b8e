"""Layer-stack machinery (port of :mod:`repro.models.stack`), faithful
layer order only.

The JAX package can also run the layers grouped by kind (one scan per
group); for gemma3's 5:1 pattern that runs all local layers before the
global ones, which is not the model's order. The port follows the
ungrouped, faithful path (``build_model(cfg, grouped=False)``). Parameters
and the paged pool are plain lists with one entry per layer, in order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def group_layout(kinds: Sequence[str]) -> Dict[str, List[int]]:
    """kind name -> faithful layer indices, in first-appearance order (the
    rule the JAX package stacks its parameter groups by)."""
    out: Dict[str, List[int]] = {}
    for i, k in enumerate(kinds):
        out.setdefault(k, []).append(i)
    return out


def init_stack(gen: torch.Generator, cfg: ArchConfig,
               kinds: Sequence[str]) -> list:
    """Per-layer parameter dicts, drawn in layer order from ``gen``."""
    return [T.init_layer(gen, cfg) for _ in kinds]


def apply_stack(params: list, x, cfg: ArchConfig, kinds: Sequence[str], *,
                mode: str, cache=None, pos=None, paged=None):
    """Run every layer in faithful order.

    prefill:      returns (x, [{"k", "v"} per layer]);
    decode_paged: returns (x, cache) with the pool written in place.
    """
    if mode == "prefill":
        caches = []
        for p, kind in zip(params, kinds):
            x, c = T.prefill(p, x, cfg, T.window_of(kind))
            caches.append(c)
        return x, caches
    if mode == "decode_paged":
        for p, kind, cache_l in zip(params, kinds, cache):
            x = T.decode_paged(p, x, cache_l, pos, paged, cfg,
                               T.window_of(kind))
        return x, cache
    raise ValueError(f"mode={mode!r} is not ported yet")


def init_paged(cfg: ArchConfig, kinds: Sequence[str], n_slots: int,
               device) -> list:
    """The paged slot pool: per layer {"k", "v": (n_slots, kvh, hd),
    "layer_id": faithful index} — the layer id picks the layer's
    collective sites' drop masks."""
    shape = (n_slots, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "layer_id": i}
            for i in range(len(kinds))]
