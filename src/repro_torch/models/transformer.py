"""Dense decoder layer kinds: GQA + RoPE with an optional sliding window,
and a gated MLP (``attn[@w]``) or a sort-based top-k MoE FFN
(``moe_attn[@w]``) (port of :mod:`repro.models.transformer`).

Ported: parameter init; the train-mode layer pass; the prefill, for the
paged pool (every position's K/V) or the contiguous cache; the
contiguous decode step; the paged decode step with the tensor-parallel
hooks. Train and prefill take the reference's attention routes with
``blocked=True`` (blocked local above 2·window, chunked above 2048
tokens). The train pass, the prefill and the contiguous decode run a
replica's shards on a mesh too (``tp``, a
:class:`repro_torch.models.parallel.TP`: tensor parallelism inside a
replica, exact). A paged decode layer with ``tp`` set (a
``serve.tp.TPContext``: the lossy TP) sends its attention output
projection through the drop-masked exchange at collective site
``2·layer``, and a dense MLP's at ``2·layer + 1``; an MoE FFN keeps the
dense expert path, as the reference's does (expert dispatch is an
all-to-all, not an RS+AG). The MoE FFN adds ``0.01 · aux`` to the
train-mode loss.

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
from repro_torch.models import parallel as P


def window_of(kind_name: str) -> Optional[int]:
    """Kind names encode the static window: 'attn' or 'attn@512'."""
    if "@" not in kind_name:
        return None
    return int(kind_name.split("@", 1)[1])


def is_moe(kind_name: str) -> bool:
    return kind_name.startswith("moe_attn")


def dense_kind_sequence(cfg: ArchConfig) -> List[str]:
    """Per-layer kind names in faithful order (every ``global_every``-th
    layer is a global, full-attention layer; ``moe_attn`` when the
    config has experts)."""
    base = "moe_attn" if cfg.is_moe else "attn"
    kinds = []
    for i in range(cfg.n_layers):
        w = cfg.window
        if cfg.global_every is not None and (i + 1) % cfg.global_every == 0:
            w = None
        kinds.append(f"{base}@{w}" if w is not None else base)
    return kinds


def init_layer(gen: torch.Generator, cfg: ArchConfig,
               moe: bool = False) -> dict:
    dt = cfg.torch_dtype
    p = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
         "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
         "attn": L.init_attention(gen, cfg)}
    if moe:
        p["moe"] = L.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def _ffn(p, x, cfg: ArchConfig, tp=None, rows=None):
    """The FFN residual: (x + ffn(norm(x)), its aux loss — 0.01 · the
    MoE's load-balance loss, None for a dense MLP). ``tp`` shards a
    dense MLP or an MoE FFN's experts. ``rows``: the group the batch's
    rows are split over (the MoE's batch statistics span it)."""
    if "moe" in p:
        out, aux = L.moe(p["moe"], L.rms_norm(x, p["ln2"]), cfg, rows, tp)
        return x + out, 0.01 * aux
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), tp), None


def train(p, x, cfg: ArchConfig, window: Optional[int], tp=None,
          rows=None):
    """The train-mode layer pass (autograd gives its backward); ``tp``
    (:class:`repro_torch.models.parallel.TP`) runs this rank's share of
    a sharded layer; ``rows`` as in :func:`_ffn`. Returns (x, aux loss
    or None)."""
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=window, blocked=True, tp=tp)
    return _ffn(p, x + h, cfg, tp, rows)


def prefill(p, x, cfg: ArchConfig, window: Optional[int], *,
            paged: bool = False, max_len: Optional[int] = None, tp=None,
            rows=None):
    """Full-sequence layer pass. Returns (x, {"k", "v"}).

    ``paged``: every position kept; the engine scatters rows [0, S) into
    the request's slots and the decode mask applies the window. Else the
    contiguous decode cache: a windowed layer keeps its last ``window``
    rows (the ring buffer), a global layer is zero-padded to ``max_len``
    rows so that decode writes land at slot == position. ``tp`` and
    ``rows`` as in :func:`train`: under ``tp`` the cache holds the KV
    heads this rank's query heads read."""
    h, (k, v) = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]),
                                cfg=cfg, window=window, blocked=True, tp=tp)
    x, _ = _ffn(p, x + h, cfg, tp, rows)
    if paged:
        return x, {"k": k, "v": v}
    if window is not None:
        k, v = k[:, -window:].contiguous(), v[:, -window:].contiguous()
    elif max_len is not None and max_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
        k, v = F.pad(k, pad), F.pad(v, pad)
    return x, {"k": k, "v": v}


def decode(p, x, cache_l: dict, pos: int, cfg: ArchConfig,
           window: Optional[int], tp=None, rows=None):
    """One decode step of one layer against its contiguous cache (a ring
    buffer when ``window`` is set); the cache is written in place and
    returned. ``tp`` and ``rows`` as in :func:`prefill`."""
    h, k, v = L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]),
                                 cache_l["k"], cache_l["v"], pos, cfg=cfg,
                                 window=window, ring=window is not None,
                                 tp=tp)
    x, _ = _ffn(p, x + h, cfg, tp, rows)
    return x, {"k": k, "v": v}


def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int], device, tp=None) -> dict:
    """One layer's empty contiguous cache: ``min(window, max_len)`` ring
    slots for a windowed layer, ``max_len`` slots for a global one; under
    ``tp`` with the heads sharded, the KV heads this rank's query heads
    read (:func:`repro_torch.models.parallel.kv_range`)."""
    C = min(window, max_len) if window is not None else max_len
    kvh = cfg.n_kv_heads
    if L._tp_attn(tp):
        lo, hi = P.kv_range(tp, kvh, cfg.n_heads)
        kvh = hi - lo
    shape = (batch, C, kvh, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def decode_paged(p, x, cache_l, pos, paged: dict, cfg: ArchConfig,
                 window: Optional[int]):
    """One decode step of one layer against its slice of the slot pool
    (``cache_l``: {"k", "v": (n_slots, kvh, hd), "layer_id"}); the pool
    is written in place. ``paged`` carries the block table, the page
    size and the TP hooks; an MoE FFN keeps the dense expert path under
    TP."""
    tp = paged.get("tp")
    masks = paged.get("masks")
    li = cache_l["layer_id"]
    h, _, _ = L.attention_decode_paged(
        p["attn"], L.rms_norm(x, p["ln1"]), cache_l["k"], cache_l["v"], pos,
        bt=paged["bt"], page=paged["page"], cfg=cfg, window=window, tp=tp,
        tp_masks=masks, site=2 * li)
    x = x + h
    if tp is None or "moe" in p:
        return _ffn(p, x, cfg)[0]
    return x + tp.combine_mlp(p["mlp"], L.rms_norm(x, p["ln2"]), masks,
                              2 * li + 1)
