"""Layer-stack machinery (port of :mod:`repro.models.stack`), faithful
layer order only.

An architecture is a *kind sequence*, one entry per layer: dense kinds
(``"attn"``, ``"attn@<window>"``, :mod:`repro_torch.models.transformer`)
and the RWKV-6 kind (``"rwkv"``, :mod:`repro_torch.models.rwkv6`). The
JAX package can also run the layers grouped by kind (one scan per
group); for gemma3's 5:1 pattern that runs all local layers before the
global ones, which is not the model's order. The port follows the
ungrouped, faithful path (``build_model(cfg, grouped=False)``).
Parameters and caches are plain lists with one entry per layer, in order.

Which kinds serve on which cache:

- the paged pool (``decode_paged``, the continuous engine): dense kinds;
- the contiguous cache (``prefill(paged=False)``, ``decode``, the
  static-batch engine): the rwkv kind. The dense kinds' contiguous
  ring-buffer KV cache is not ported yet and raises
  ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T


def group_layout(kinds: Sequence[str]) -> Dict[str, List[int]]:
    """kind name -> faithful layer indices, in first-appearance order (the
    rule the JAX package stacks its parameter groups by)."""
    out: Dict[str, List[int]] = {}
    for i, k in enumerate(kinds):
        out.setdefault(k, []).append(i)
    return out


def _is_rwkv(kind: str) -> bool:
    return kind == "rwkv"


def check_contiguous(kinds: Sequence[str]) -> None:
    """Raise ``NotImplementedError`` naming the kinds that have no
    contiguous-cache path in the port (the dense kinds)."""
    missing = sorted({k for k in kinds if not _is_rwkv(k)})
    if missing:
        raise NotImplementedError(
            f"layer kinds {missing} have no contiguous-cache decode in the "
            f"port yet (the dense ring-buffer KV cache of the legacy "
            f"static-batch path is not ported); serve them through the "
            f"paged path (prefill(paged=True), ContinuousEngine)")


def init_stack(gen: torch.Generator, cfg: ArchConfig,
               kinds: Sequence[str]) -> list:
    """Per-layer parameter dicts, drawn in layer order from ``gen``."""
    return [R.init_rwkv(gen, cfg) if _is_rwkv(k) else T.init_layer(gen, cfg)
            for k in kinds]


def apply_stack(params: list, x, cfg: ArchConfig, kinds: Sequence[str], *,
                mode: str, cache=None, pos=None, paged=None):
    """Run every layer in faithful order.

    prefill:      returns (x, per-layer caches); ``paged`` truthy keeps
                  every position's K/V for the slot pool (dense kinds),
                  falsy asks for the contiguous decode cache;
    decode:       one step against the contiguous cache; returns
                  (x, new per-layer caches);
    decode_paged: one step against the paged pool; returns (x, pool),
                  the pool written in place.
    """
    if mode == "prefill":
        if not paged:
            check_contiguous(kinds)
        caches = []
        for p, kind in zip(params, kinds):
            if _is_rwkv(kind):
                x, c = R.prefill(p, x, cfg)
            else:
                x, c = T.prefill(p, x, cfg, T.window_of(kind))
            caches.append(c)
        return x, caches
    if mode == "decode":
        check_contiguous(kinds)
        caches = []
        for p, cache_l in zip(params, cache):
            x, c = R.decode(p, x, cache_l, cfg)
            caches.append(c)
        return x, caches
    if mode == "decode_paged":
        for p, kind, cache_l in zip(params, kinds, cache):
            if _is_rwkv(kind):
                raise ValueError(f"kind {kind!r} has no paged decode path")
            x = T.decode_paged(p, x, cache_l, pos, paged, cfg,
                               T.window_of(kind))
        return x, cache
    raise ValueError(f"mode={mode!r}, want prefill, decode or decode_paged")


def init_cache(cfg: ArchConfig, kinds: Sequence[str], batch: int,
               device) -> list:
    """Per-layer empty contiguous decode caches."""
    check_contiguous(kinds)
    return [R.cache_spec(cfg, batch, device) for _ in kinds]


def init_paged(cfg: ArchConfig, kinds: Sequence[str], n_slots: int,
               device) -> list:
    """The paged slot pool: per layer {"k", "v": (n_slots, kvh, hd),
    "layer_id": faithful index} — the layer id picks the layer's
    collective sites' drop masks."""
    shape = (n_slots, cfg.n_kv_heads, cfg.hd)
    for kind in kinds:
        if _is_rwkv(kind):
            raise ValueError(f"kind {kind!r} has no paged cache spec")
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "layer_id": i}
            for i in range(len(kinds))]
