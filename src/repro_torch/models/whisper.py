"""Whisper-style encoder-decoder kinds (port of :mod:`repro.models.whisper`).

The mel-spectrogram and conv frontend is a stub: the model takes
precomputed frame embeddings (B, S_src, d). The ``enc`` kind is a
bidirectional pre-norm encoder layer; the ``xattn`` kind is a decoder
layer of causal self-attention, cross-attention on the encoder output,
and the gated MLP. Prefill computes each layer's cross K/V once and
stores them in the cache (``xk`` / ``xv``), and decode reads them from
there; the encoder never decodes. The products are plain ``einsum`` and
the attention the plain routes of :mod:`repro_torch.models.layers`, as
the reference computes them outside any Pallas kernel. Neither kind has
a paged form (the reference's neither): they serve on the contiguous
cache only, on a serving mesh too (``tp``: each rank its share of the
attention and the MLP, as in training).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import parallel as P

KINDS = ("enc", "xattn")


def init_enc(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    z = lambda: torch.zeros((cfg.d_model,), dtype=dt,   # noqa: E731
                            device=gen.device)
    return {"ln1": z(), "ln2": z(), "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def enc_train(p, x, cfg: ArchConfig, tp=None):
    """One encoder layer: bidirectional self-attention (full, or chunked
    above 2048 frames, unmasked), then the MLP; ``tp`` this rank's share
    of a sharded layer."""
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=None, causal=False, tp=tp)
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), tp)


def init_xattn(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    z = lambda: torch.zeros((cfg.d_model,), dtype=dt,   # noqa: E731
                            device=gen.device)
    return {"ln1": z(), "lnx": z(), "ln2": z(),
            "attn": L.init_attention(gen, cfg),
            "xattn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def _split(tp) -> bool:
    """Whether ``tp`` splits the cross-attention's query heads (``wq``
    and ``wo`` together: the rule shards both by the head count)."""
    return tp is not None and tp.sharded("xattn/wq")


def _cross(p, x, k, v, tp=None):
    """Cross-attention of the stream ``x`` on the encoder's K/V (no RoPE,
    no mask); under ``tp``, this rank's query heads on the K/V heads
    they read, the output's partial sums reduced over the group."""
    split = _split(tp)
    q = L.einsum("bsd,dhe->bshe", tp.copy_to(x) if split else x,
                 p["xattn"]["wq"])
    out = L.full_attention(q, k, v, causal=False, window=None)
    out = L.einsum("bshe,hed->bsd", out, p["xattn"]["wo"])
    return tp.reduce_from(out) if split else out


def enc_kv(p, enc_out, tp=None):
    """The layer's cross K/V of the encoder output: (B, S_src, kvh, hd);
    under ``tp`` with the query heads split, the KV heads this rank's
    query heads read."""
    if not _split(tp):
        return (L.einsum("bsd,dhe->bshe", enc_out, p["xattn"]["wk"]),
                L.einsum("bsd,dhe->bshe", enc_out, p["xattn"]["wv"]))
    xt = tp.copy_to(enc_out)
    n_heads = p["xattn"]["wq"].shape[1] * tp.size
    kv = []
    for name in ("wk", "wv"):
        w = p["xattn"][name]
        if tp.sharded("xattn/" + name):
            kv.append(L.einsum("bsd,dhe->bshe", xt, w))
        else:
            kv.append(P.local_kv(tp, L.einsum("bsd,dhe->bshe", enc_out, w),
                                 n_heads))
    return tuple(kv)


def _tail(p, x, xk, xv, tp=None):
    """The cross-attention and MLP residuals after self-attention."""
    x = x + _cross(p, L.rms_norm(x, p["lnx"]), xk, xv, tp)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), tp)


def xattn_train(p, x, enc_out, cfg: ArchConfig, tp=None):
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=None, tp=tp)
    return _tail(p, x + h, *enc_kv(p, enc_out, tp), tp)


def xattn_prefill(p, x, enc_out, cfg: ArchConfig,
                  max_len: Optional[int] = None, tp=None):
    """Returns (x, {"k", "v", "xk", "xv"}): the self K/V padded to
    ``max_len`` rows (decode writes slot == position, as a global dense
    layer's), and the cross K/V computed once. Under ``tp``, this rank's
    share of a sharded layer (as :func:`xattn_train`): both caches hold
    the KV heads its query heads read."""
    h, (k, v) = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]),
                                cfg=cfg, window=None, tp=tp)
    xk, xv = enc_kv(p, enc_out, tp)
    x = _tail(p, x + h, xk, xv, tp)
    if max_len is not None and max_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
        k, v = F.pad(k, pad), F.pad(v, pad)
    return x, {"k": k, "v": v, "xk": xk, "xv": xv}


def xattn_decode(p, x, cache_l: dict, pos: int, cfg: ArchConfig, tp=None):
    """One decode step against the contiguous cache: the self K/V written
    in place at slot ``pos``, the cross K/V read as prefill stored them;
    ``tp`` as in :func:`xattn_prefill`."""
    h, k, v = L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]),
                                 cache_l["k"], cache_l["v"], pos, cfg=cfg,
                                 tp=tp)
    x = _tail(p, x + h, cache_l["xk"], cache_l["xv"], tp)
    return x, {**cache_l, "k": k, "v": v}


def xattn_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                     device, tp=None) -> dict:
    """One decoder layer's empty cache: ``max_len`` self K/V rows and
    ``max_len // enc_frames_ratio`` cross rows; under ``tp`` with the
    heads split, the KV heads this rank's query heads read
    (:func:`repro_torch.models.parallel.kv_range`)."""
    kvh = xkvh = cfg.n_kv_heads
    if L._tp_attn(tp):
        lo, hi = P.kv_range(tp, kvh, cfg.n_heads)
        kvh = hi - lo
    if _split(tp):
        lo, hi = P.kv_range(tp, xkvh, cfg.n_heads)
        xkvh = hi - lo
    kv = (batch, max_len, kvh, cfg.hd)
    xs = (batch, max_len // cfg.enc_frames_ratio, xkvh, cfg.hd)
    z = lambda s: torch.zeros(s, dtype=cfg.torch_dtype,   # noqa: E731
                              device=device)
    return {"k": z(kv), "v": z(kv), "xk": z(xs), "xv": z(xs)}
