"""RWKV-6 "Finch" layer kind (port of :mod:`repro.models.rwkv6`):
time-mix (data-dependent-decay linear attention) and channel-mix.
Attention-free; the decode state is O(1) in the sequence length.

As in the JAX package: static token-shift lerp coefficients instead of
the data-dependent LoRA lerp, the decay LoRA kept. The dtype steps are
the reference's: the decay is computed in f32 and cast to the model
dtype, the bonus ``u`` stays f32, the recurrence runs in f32 and its
output comes back in the model dtype.

Ported: parameter init, the prefill (one kernel launch per layer, whose
final state is the decode cache) and the decode step. Training waits
for a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L

DECAY_LORA = 64


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, S, d = x.shape
    return x.reshape(B, S, h, d // h)


def init_rwkv(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's parameters at the reference's shapes and scales."""
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    dev = gen.device
    s = d ** -0.5
    return {
        "ln1": torch.zeros((d,), dtype=dt, device=dev),
        "ln2": torch.zeros((d,), dtype=dt, device=dev),
        # time-mix
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # r,k,v,g,w
        "wr": L._init(gen, (d, d), s, dt),
        "wk": L._init(gen, (d, d), s, dt),
        "wv": L._init(gen, (d, d), s, dt),
        "wg": L._init(gen, (d, d), s, dt),
        "wo": L._init(gen, (d, d), s, dt),
        "w_lora_a": L._init(gen, (d, DECAY_LORA), s, dt),
        "w_lora_b": L._init(gen, (DECAY_LORA, d), DECAY_LORA ** -0.5, dt),
        "w0": torch.full((d,), -2.0, dtype=dt, device=dev),   # decay logit
        "u": L._init(gen, (d,), 0.1, torch.float32),          # bonus
        # channel-mix
        "mu_c": torch.full((2, d), 0.5, dtype=dt, device=dev),
        "ck": L._init(gen, (d, ff), s, dt),
        "cv": L._init(gen, (ff, d), ff ** -0.5, dt),
        "cr": L._init(gen, (d, d), s, dt),
    }


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1), f32."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    f32 = torch.float32
    return torch.exp(-torch.exp(torch.clamp(
        p["w0"].to(f32) + lora.to(f32), -8.0, 4.0)))


def _tmix(p, x: torch.Tensor, cfg: ArchConfig, shifted: torch.Tensor):
    """``shifted`` is x_{t-1} along S (or the cached last token when
    decoding). Returns r, k, v, w (B, S, h, ·), u (h, dk) f32 and the
    gate g (B, S, d)."""
    h = cfg.n_heads
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (shifted - x) for i in range(5))
    r = _split_heads(xr @ p["wr"], h)
    k = _split_heads(xk @ p["wk"], h)
    v = _split_heads(xv @ p["wv"], h)
    g = F.silu(xg @ p["wg"])
    w = _split_heads(_decay(p, xw), h).to(x.dtype)
    u = p["u"].reshape(h, -1)
    return r, k, v, w, u, g


def _cmix(p, x: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    mu = p["mu_c"].to(x.dtype)
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    k = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"])


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along S, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def prefill(p, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence layer pass. Returns (x, cache) with the cache
    {"state": (B, h, dk, dv) f32, "shift_t", "shift_c": (B, d)}. The
    state is the recurrence's final state, which the kernel writes
    beside its output (the JAX package folds the sequence a second time
    to get it; the two agree, tests/test_torch_rwkv6.py)."""
    xi = L.rms_norm(x, p["ln1"])
    r, k, v, w, u, g = _tmix(p, xi, cfg, _shift(xi))
    o, state = K.rwkv6(r, k, v, w, u)
    B, S = o.shape[:2]
    x = x + (o.reshape(B, S, -1) * g).to(x.dtype) @ p["wo"]
    xc = L.rms_norm(x, p["ln2"])
    x = x + _cmix(p, xc, _shift(xc))
    return x, {"state": state, "shift_t": xi[:, -1], "shift_c": xc[:, -1]}


def decode(p, x: torch.Tensor, cache_l: dict, cfg: ArchConfig):
    """One decode step of one layer; x: (B, 1, d). Returns (x, new
    cache) — the caller's cache is not modified."""
    xi = L.rms_norm(x, p["ln1"])
    prev_t = cache_l["shift_t"][:, None, :].to(xi.dtype)
    r, k, v, w, u, g = _tmix(p, xi, cfg, prev_t)
    o, state = K.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                            cache_l["state"])
    o = o.reshape(o.shape[0], 1, -1)                          # (B, 1, d)
    x = x + (o * g).to(x.dtype) @ p["wo"]
    xc = L.rms_norm(x, p["ln2"])
    prev_c = cache_l["shift_c"][:, None, :].to(xc.dtype)
    x = x + _cmix(p, xc, prev_c)
    return x, {"state": state, "shift_t": xi[:, 0], "shift_c": xc[:, 0]}


def cache_spec(cfg: ArchConfig, batch: int, device) -> dict:
    """One layer's empty decode cache."""
    h = cfg.n_heads
    dk = cfg.d_model // h
    dt = cfg.torch_dtype
    return {"state": torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                                 device=device),
            "shift_t": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device),
            "shift_c": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device)}
