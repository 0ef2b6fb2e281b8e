"""Layer-stack machinery (port of :mod:`repro.models.stack`), faithful
layer order only.

An architecture is a *kind sequence*, one entry per layer: dense kinds
(``"attn"``, ``"attn@<window>"``, :mod:`repro_torch.models.transformer`),
the RWKV-6 kind (``"rwkv"``, :mod:`repro_torch.models.rwkv6`) and the
RG-LRU kind (``"rec"``, :mod:`repro_torch.models.hybrid`). The JAX
package can also run the layers grouped by kind (one scan per group);
for gemma3's 5:1 pattern that runs all local layers before the global
ones, which is not the model's order. The port follows the ungrouped,
faithful path (``build_model(cfg, grouped=False)``). For serving,
parameters and caches are plain lists with one entry per layer, in order.
The train path keeps the JAX package's stacked layout instead
(``{kind: leaves with a leading per-kind layer dim}``,
:func:`stack_layers`): the exchange partitions each leaf into server
blocks, so only that layout puts the blocks, the buckets and the drop
masks on the same elements as the reference. :func:`apply_stack_train`
reads layer l's weights as views into the stacked leaves.

Which kinds serve on which cache:

- the contiguous cache (``prefill(paged=False)``, ``decode``, the
  static-batch engine): every kind — the dense kinds' ring-buffer or
  ``max_len`` KV cache, rwkv's state and token shifts, rec's conv state
  and f32 carry;
- the paged pool (``decode_paged``, the continuous engine): the dense
  kinds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid as H
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T

RECURRENT = {"rwkv": R, "rec": H}     # kinds with no KV cache


def group_layout(kinds: Sequence[str]) -> Dict[str, List[int]]:
    """kind name -> faithful layer indices, in first-appearance order (the
    rule the JAX package stacks its parameter groups by)."""
    out: Dict[str, List[int]] = {}
    for i, k in enumerate(kinds):
        out.setdefault(k, []).append(i)
    return out


def _no_paged(kind: str, what: str) -> None:
    if kind in RECURRENT:
        raise ValueError(f"kind {kind!r} has no paged {what}")


def init_stack(gen: torch.Generator, cfg: ArchConfig,
               kinds: Sequence[str]) -> list:
    """Per-layer parameter dicts, drawn in layer order from ``gen``."""
    init = {"rwkv": R.init_rwkv, "rec": H.init_rec}
    return [init.get(k, T.init_layer)(gen, cfg) for k in kinds]


def stack_layers(layers: Sequence[dict], kinds: Sequence[str]) -> dict:
    """Per-layer parameter dicts -> {kind: stacked leaves}, each kind's
    layers stacked along a new leading dim in faithful order (the JAX
    package's ``init_stack`` layout)."""
    return {kind: tree_lib.map(lambda *xs: torch.stack(xs),
                               *[layers[i] for i in idxs])
            for kind, idxs in group_layout(kinds).items()}


def apply_stack_train(params: dict, x, cfg: ArchConfig,
                      kinds: Sequence[str]):
    """The train-mode pass over the stacked layout, in faithful order
    (the JAX package's ``apply_stack(mode="train", grouped=False)``).
    Dense kinds only; returns x."""
    pos = {kind: 0 for kind in params}
    for kind in kinds:
        if kind in RECURRENT:
            raise NotImplementedError(f"kind {kind!r} has no ported train "
                                      f"mode yet")
        i = pos[kind]
        pos[kind] += 1
        p = tree_lib.map(lambda a, i=i: a[i], params[kind])
        x = T.train(p, x, cfg, T.window_of(kind))
    return x


def apply_stack(params: list, x, cfg: ArchConfig, kinds: Sequence[str], *,
                mode: str, cache=None, pos=None, paged=None,
                max_len: Optional[int] = None):
    """Run every layer in faithful order.

    prefill:      returns (x, per-layer caches); ``paged`` truthy keeps
                  every position's K/V for the slot pool (dense kinds),
                  falsy gives the contiguous decode cache (``max_len``
                  sizes the global layers' KV cache);
    decode:       one step at position ``pos`` against the contiguous
                  cache; returns (x, per-layer caches), the dense kinds'
                  K/V written in place;
    decode_paged: one step against the paged pool; returns (x, pool),
                  the pool written in place.
    """
    if mode == "prefill":
        caches = []
        for p, kind in zip(params, kinds):
            if kind in RECURRENT:
                x, c = RECURRENT[kind].prefill(p, x, cfg)
            else:
                x, c = T.prefill(p, x, cfg, T.window_of(kind),
                                 paged=bool(paged), max_len=max_len)
            caches.append(c)
        return x, caches
    if mode == "decode":
        caches = []
        for p, kind, cache_l in zip(params, kinds, cache):
            if kind in RECURRENT:
                x, c = RECURRENT[kind].decode(p, x, cache_l, cfg)
            else:
                x, c = T.decode(p, x, cache_l, pos, cfg, T.window_of(kind))
            caches.append(c)
        return x, caches
    if mode == "decode_paged":
        for p, kind, cache_l in zip(params, kinds, cache):
            _no_paged(kind, "decode path")
            x = T.decode_paged(p, x, cache_l, pos, paged, cfg,
                               T.window_of(kind))
        return x, cache
    raise ValueError(f"mode={mode!r}, want prefill, decode or decode_paged")


def init_cache(cfg: ArchConfig, kinds: Sequence[str], batch: int,
               max_len: int, device) -> list:
    """Per-layer empty contiguous decode caches."""
    out = []
    for kind in kinds:
        if kind in RECURRENT:
            out.append(RECURRENT[kind].cache_spec(cfg, batch, device))
        else:
            out.append(T.cache_spec(cfg, batch, max_len, T.window_of(kind),
                                    device))
    return out


def init_paged(cfg: ArchConfig, kinds: Sequence[str], n_slots: int,
               device) -> list:
    """The paged slot pool: per layer {"k", "v": (n_slots, kvh, hd),
    "layer_id": faithful index} — the layer id picks the layer's
    collective sites' drop masks."""
    shape = (n_slots, cfg.n_kv_heads, cfg.hd)
    for kind in kinds:
        _no_paged(kind, "cache spec")
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "layer_id": i}
            for i in range(len(kinds))]
