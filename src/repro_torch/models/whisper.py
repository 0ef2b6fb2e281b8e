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
cache only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

KINDS = ("enc", "xattn")


def init_enc(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    z = lambda: torch.zeros((cfg.d_model,), dtype=dt,   # noqa: E731
                            device=gen.device)
    return {"ln1": z(), "ln2": z(), "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def enc_train(p, x, cfg: ArchConfig):
    """One encoder layer: bidirectional self-attention (full, or chunked
    above 2048 frames, unmasked), then the MLP."""
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=None, causal=False)
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def init_xattn(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    z = lambda: torch.zeros((cfg.d_model,), dtype=dt,   # noqa: E731
                            device=gen.device)
    return {"ln1": z(), "lnx": z(), "ln2": z(),
            "attn": L.init_attention(gen, cfg),
            "xattn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def _cross(p, x, k, v):
    """Cross-attention of the stream ``x`` on the encoder's K/V (no RoPE,
    no mask)."""
    q = L.einsum("bsd,dhe->bshe", x, p["xattn"]["wq"])
    out = L.full_attention(q, k, v, causal=False, window=None)
    return L.einsum("bshe,hed->bsd", out, p["xattn"]["wo"])


def enc_kv(p, enc_out):
    """The layer's cross K/V of the encoder output: (B, S_src, kvh, hd)."""
    return (L.einsum("bsd,dhe->bshe", enc_out, p["xattn"]["wk"]),
            L.einsum("bsd,dhe->bshe", enc_out, p["xattn"]["wv"]))


def _tail(p, x, xk, xv):
    """The cross-attention and MLP residuals after self-attention."""
    x = x + _cross(p, L.rms_norm(x, p["lnx"]), xk, xv)
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def xattn_train(p, x, enc_out, cfg: ArchConfig):
    h, _ = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]), cfg=cfg,
                           window=None)
    return _tail(p, x + h, *enc_kv(p, enc_out))


def xattn_prefill(p, x, enc_out, cfg: ArchConfig,
                  max_len: Optional[int] = None):
    """Returns (x, {"k", "v", "xk", "xv"}): the self K/V padded to
    ``max_len`` rows (decode writes slot == position, as a global dense
    layer's), and the cross K/V computed once."""
    h, (k, v) = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"]),
                                cfg=cfg, window=None)
    xk, xv = enc_kv(p, enc_out)
    x = _tail(p, x + h, xk, xv)
    if max_len is not None and max_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
        k, v = F.pad(k, pad), F.pad(v, pad)
    return x, {"k": k, "v": v, "xk": xk, "xv": xv}


def xattn_decode(p, x, cache_l: dict, pos: int, cfg: ArchConfig):
    """One decode step against the contiguous cache: the self K/V written
    in place at slot ``pos``, the cross K/V read as prefill stored them."""
    h, k, v = L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]),
                                 cache_l["k"], cache_l["v"], pos, cfg=cfg)
    x = _tail(p, x + h, cache_l["xk"], cache_l["xv"])
    return x, {**cache_l, "k": k, "v": v}


def xattn_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                     device) -> dict:
    """One decoder layer's empty cache: ``max_len`` self K/V rows and
    ``max_len // enc_frames_ratio`` cross rows."""
    kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    xs = (batch, max_len // cfg.enc_frames_ratio, cfg.n_kv_heads, cfg.hd)
    z = lambda s: torch.zeros(s, dtype=cfg.torch_dtype,   # noqa: E731
                              device=device)
    return {"k": z(kv), "v": z(kv), "xk": z(xs), "xv": z(xs)}
