"""Dense decoder layer: GQA + RoPE with an optional sliding window, gated
MLP (port of the dense kind of :mod:`repro.models.transformer`).

Ported so far: parameter init, the paged prefill and the paged decode
step with the tensor-parallel hooks. A layer with ``tp`` set sends both
output projections through the drop-masked exchange: collective site
``2·layer`` (attention) and ``2·layer + 1`` (MLP).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def window_of(kind_name: str) -> Optional[int]:
    """Kind names encode the static window: 'attn' or 'attn@512'."""
    if "@" not in kind_name:
        return None
    return int(kind_name.split("@", 1)[1])


def dense_kind_sequence(cfg: ArchConfig) -> List[str]:
    """Per-layer kind names in faithful order (every ``global_every``-th
    layer is a global, full-attention layer)."""
    kinds = []
    for i in range(cfg.n_layers):
        w = cfg.window
        if cfg.global_every is not None and (i + 1) % cfg.global_every == 0:
            w = None
        kinds.append(f"attn@{w}" if w is not None else "attn")
    return kinds


def init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
            "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def prefill(p, x, cfg: ArchConfig, window: Optional[int]):
    """Full-sequence layer pass. Returns (x, {"k", "v"}) with every
    position kept: the engine scatters rows [0, S) into the request's
    slots and the decode mask applies the window."""
    h, (k, v) = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]),
                                cfg=cfg, window=window)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x, {"k": k, "v": v}


def decode_paged(p, x, cache_l, pos, paged: dict, cfg: ArchConfig,
                 window: Optional[int]):
    """One decode step of one layer against its slice of the slot pool
    (``cache_l``: {"k", "v": (n_slots, kvh, hd), "layer_id"}); the pool
    is written in place. ``paged`` carries the block table, the page
    size and the TP hooks."""
    tp = paged.get("tp")
    masks = paged.get("masks")
    li = cache_l["layer_id"]
    h, _, _ = L.attention_decode_paged(
        p["attn"], L.rms_norm(x, p["ln1"]), cache_l["k"], cache_l["v"], pos,
        bt=paged["bt"], page=paged["page"], cfg=cfg, window=window, tp=tp,
        tp_masks=masks, site=2 * li)
    x = x + h
    if tp is None:
        return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x + tp.combine_mlp(p["mlp"], L.rms_norm(x, p["ln2"]), masks,
                              2 * li + 1)
