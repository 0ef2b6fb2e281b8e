"""RecurrentGemma (Griffin) ``rec`` kind: the RG-LRU recurrent block (port
of :mod:`repro.models.hybrid`). The local-attention layers of the 2:1
pattern are the dense ``attn@<window>`` kind
(:mod:`repro_torch.models.transformer`).

Recurrent block: x → (gate branch: gelu(x·Wy)) ⊗ (rec branch: causal
conv1d(4) → RG-LRU) → Wo, with the pre-norm residual and the gated MLP.

The dtype steps are the reference's: the projections, the conv and the
sigmoid gates run in the model dtype; the decay ``a`` is f32 (``lam`` is
f32) while the gated input ``i·u`` stays in the model dtype, so the
kernel takes mixed dtypes; the recurrence carries in f32 and its output
comes back in the model dtype. ``jax.nn.gelu`` defaults to the tanh
approximation, and so does :func:`_block`.

Ported: parameter init, the prefill (one kernel launch per layer, whose
final f32 carry is the decode state) and the decode step. Training waits
for a later slice.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L

CONV_W = 4
RGLRU_C = 8.0


def init_rec(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's parameters at the reference's shapes and scales."""
    d = cfg.d_model
    dr = cfg.d_state or d
    dt = cfg.torch_dtype
    dev = gen.device
    s = d ** -0.5
    return {
        "ln1": torch.zeros((d,), dtype=dt, device=dev),
        "ln2": torch.zeros((d,), dtype=dt, device=dev),
        "wy": L._init(gen, (d, dr), s, dt),
        "wx": L._init(gen, (d, dr), s, dt),
        "conv": L._init(gen, (CONV_W, dr), 0.5, dt),
        "wa": L._init(gen, (dr, dr), dr ** -0.5, dt),
        "wi": L._init(gen, (dr, dr), dr ** -0.5, dt),
        "lam": torch.full((dr,), 0.7, dtype=torch.float32, device=dev),
        "wo": L._init(gen, (dr, d), dr ** -0.5, dt),
        "mlp": L.init_mlp(gen, cfg),
    }


def _causal_conv(u: torch.Tensor, conv: torch.Tensor, state=None):
    """Depthwise causal conv. u: (B, S, dr); conv: (W, dr); state:
    (B, W-1, dr) or None (zeros). The W taps are summed left to right in
    u's dtype, as the reference's Python ``sum`` does. Returns (out, new
    state = the last W-1 rows of the padded input)."""
    W = conv.shape[0]
    if state is None:
        up = F.pad(u, (0, 0, W - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = sum(up[:, i:i + S] * conv[i] for i in range(W))
    # a copy, so that the cache does not keep the padded input alive
    return out, up[:, -(W - 1):].clone()


def _gates(p, u: torch.Tensor):
    """Returns the f32 decay a = exp(-8·softplus(lam)·r) and the input
    gate i (u's dtype)."""
    r = torch.sigmoid(u @ p["wa"])
    i = torch.sigmoid(u @ p["wi"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r.to(torch.float32)
    return torch.exp(log_a), i


def _block(p, xin: torch.Tensor, conv_state=None, rec_state=None):
    """The recurrent block over a sequence (``rec_state`` None: the
    kernel from a zero carry) or one decode step (from ``rec_state``).
    Returns (out, new conv state, h_last f32)."""
    y = F.gelu(xin @ p["wy"], approximate="tanh")
    u = xin @ p["wx"]
    u, new_conv = _causal_conv(u, p["conv"], conv_state)
    a, i = _gates(p, u)
    gated = i * u
    if rec_state is None:
        h_seq, h_last = K.rglru(gated, a)
    else:
        h_last = K.rglru_step(gated[:, 0], a[:, 0], rec_state)
        h_seq = h_last[:, None, :]
    out = (h_seq.to(xin.dtype) * y) @ p["wo"]
    return out, new_conv, h_last


def prefill(p, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence layer pass. Returns (x, {"conv": (B, W-1, dr),
    "h": (B, dr) f32}); ``h`` is the kernel's final carry."""
    xin = L.rms_norm(x, p["ln1"])
    out, conv_state, h_last = _block(p, xin)
    x = x + out
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x, {"conv": conv_state, "h": h_last}


def decode(p, x: torch.Tensor, cache_l: dict, cfg: ArchConfig):
    """One decode step of one layer; x: (B, 1, d). Returns (x, new
    cache) — the caller's cache is not modified."""
    xin = L.rms_norm(x, p["ln1"])
    out, conv_state, h_last = _block(p, xin, cache_l["conv"], cache_l["h"])
    x = x + out
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x, {"conv": conv_state, "h": h_last}


def cache_spec(cfg: ArchConfig, batch: int, device) -> dict:
    """One layer's empty decode cache."""
    dr = cfg.d_state or cfg.d_model
    return {"conv": torch.zeros((batch, CONV_W - 1, dr),
                                dtype=cfg.torch_dtype, device=device),
            "h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device)}


def hybrid_kind_sequence(cfg: ArchConfig) -> List[str]:
    """Per-layer kind names in faithful order: ``block_pattern`` repeated,
    its "attn" entries as ``attn@<window>``."""
    pattern = cfg.block_pattern or ("rec", "rec", "attn")
    kinds = []
    for i in range(cfg.n_layers):
        k = pattern[i % len(pattern)]
        kinds.append(f"attn@{cfg.window}" if k == "attn" and cfg.window
                     else ("attn" if k == "attn" else "rec"))
    return kinds
