"""Dense decoder layer: GQA + RoPE with an optional sliding window, gated
MLP (port of the dense kind of :mod:`repro.models.transformer`).

Ported: parameter init; the train-mode layer pass; the prefill, for the
paged pool (every
position's K/V) or the contiguous cache; the contiguous decode step; the
paged decode step with the tensor-parallel hooks. A layer with ``tp``
set sends both output projections through the drop-masked exchange:
collective site ``2·layer`` (attention) and ``2·layer + 1`` (MLP).

The contiguous cache is the reference's: a windowed layer keeps a ring
buffer of its last ``window`` rows (all S rows when S < window) and
decode writes slot ``pos % C``; a global layer is padded to ``max_len``
and decode writes slot ``pos``. As in the reference, the ring holds the
right positions only when the prompt length is a multiple of the
window; at other lengths decode evicts the wrong slots, and the port
reproduces that (ROADMAP C).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

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


def train(p, x, cfg: ArchConfig, window: Optional[int]):
    """The train-mode layer pass (causal full attention; autograd gives
    its backward). Returns x."""
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=window)
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def prefill(p, x, cfg: ArchConfig, window: Optional[int], *,
            paged: bool = False, max_len: Optional[int] = None):
    """Full-sequence layer pass. Returns (x, {"k", "v"}).

    ``paged``: every position kept; the engine scatters rows [0, S) into
    the request's slots and the decode mask applies the window. Else the
    contiguous decode cache: a windowed layer keeps its last ``window``
    rows (the ring buffer), a global layer is zero-padded to ``max_len``
    rows so that decode writes land at slot == position."""
    h, (k, v) = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]),
                                cfg=cfg, window=window)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    if paged:
        return x, {"k": k, "v": v}
    if window is not None:
        k, v = k[:, -window:].contiguous(), v[:, -window:].contiguous()
    elif max_len is not None and max_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
        k, v = F.pad(k, pad), F.pad(v, pad)
    return x, {"k": k, "v": v}


def decode(p, x, cache_l: dict, pos: int, cfg: ArchConfig,
           window: Optional[int]):
    """One decode step of one layer against its contiguous cache (a ring
    buffer when ``window`` is set); the cache is written in place and
    returned."""
    h, k, v = L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]),
                                 cache_l["k"], cache_l["v"], pos, cfg=cfg,
                                 window=window, ring=window is not None)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x, {"k": k, "v": v}


def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int], device) -> dict:
    """One layer's empty contiguous cache: ``min(window, max_len)`` ring
    slots for a windowed layer, ``max_len`` slots for a global one."""
    C = min(window, max_len) if window is not None else max_len
    shape = (batch, C, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


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
