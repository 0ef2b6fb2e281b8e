"""RWKV-6 "Finch" layer kind (port of :mod:`repro.models.rwkv6`):
time-mix (data-dependent-decay linear attention) and channel-mix.
Attention-free; the decode state is O(1) in the sequence length.

As in the JAX package: static token-shift lerp coefficients instead of
the data-dependent LoRA lerp, the decay LoRA kept. The dtype steps are
the reference's: the decay is computed in f32 and cast to the model
dtype, the bonus ``u`` stays f32, the recurrence runs in f32 and its
output comes back in the model dtype.

Ported: parameter init, the train-mode layer pass (on the reference's
XLA route, ``ops.rwkv6(backend="xla")``: the chunked scan of scans that
autograd differentiates; the CUDA kernel is forward only), the prefill
(one kernel launch per layer, whose final state is the decode cache) and
the decode step.

Under tensor parallelism inside a replica (``train(tp=)``, and
``prefill`` / ``decode`` / ``cache_spec`` on a serving mesh,
:mod:`repro_torch.models.parallel`) the rule
(``launch/sharding.py::_rule``) splits every projection's last dim over
"model": ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``ck`` are column-parallel
(the rank's heads of r, k, v, its channels of g, its d_ff columns of the
channel-mix key), and ``wo`` / ``cr`` / ``cv`` split their output dim,
so their input is joined over the group first (``parallel.join``) and
their output leaves through ``gather_from``. The whole leaves (the lerp
coefficients, the decay LoRA, ``w0``, ``u``) are read alike on every
rank; the decay and the bonus enter the region through ``copy_to``
before they are cut to the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models import parallel as P

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


def _tmix(p, x: torch.Tensor, cfg: ArchConfig, shifted: torch.Tensor,
          tp=None):
    """``shifted`` is x_{t-1} along S (or the cached last token when
    decoding). Returns r, k, v, w (B, S, h, ·), u (h, dk) f32 and the
    gate g (B, S, d); under ``tp`` with the projections split, this
    rank's heads of each and its channels of g."""
    h = cfg.n_heads
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (shifted - x) for i in range(5))
    split = tp is not None and tp.sharded("rwkv/wr")
    w = _decay(p, xw).to(x.dtype)
    u = p["u"]
    if split:
        h //= tp.size
        xr, xk, xv, xg = (tp.copy_to(t) for t in (xr, xk, xv, xg))
        w = tp.part(tp.copy_to(w), 2)
        u = tp.part(tp.copy_to(u), 0)
    r = _split_heads(xr @ p["wr"], h)
    k = _split_heads(xk @ p["wk"], h)
    v = _split_heads(xv @ p["wv"], h)
    g = F.silu(xg @ p["wg"])
    return r, k, v, _split_heads(w, h), u.reshape(h, -1), g


def _out(p, y: torch.Tensor, tp=None) -> torch.Tensor:
    """The time-mix's output projection of y = o ⊙ g (B, S, d, or this
    rank's channels under ``tp``)."""
    split_in = tp is not None and tp.sharded("rwkv/wr")
    split_out = tp is not None and tp.sharded("rwkv/wo")
    out = P.join(tp, y, split_in, split_out) @ p["wo"]
    return tp.gather_from(out, 2) if split_out else out


def _cmix(p, x: torch.Tensor, shifted: torch.Tensor, tp=None
          ) -> torch.Tensor:
    mu = p["mu_c"].to(x.dtype)
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    split_k = tp is not None and tp.sharded("rwkv/ck")
    split_v = tp is not None and tp.sharded("rwkv/cv")
    if split_k:
        xk = tp.copy_to(xk)
    k = P.join(tp, torch.square(F.relu(xk @ p["ck"])), split_k, split_v)
    if split_v:
        xr = tp.copy_to(xr)
    # cr and cv split alike (their last dim is d): the rank's columns of
    # both products, multiplied, then joined once
    out = torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"])
    return tp.gather_from(out, 2) if split_v else out


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along S, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def train(p, x: torch.Tensor, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """The train-mode layer pass (the reference's ``train``, its rwkv6 on
    the XLA route); ``tp`` runs this rank's share of a sharded layer (the
    recurrence over its heads). Returns x."""
    xi = L.rms_norm(x, p["ln1"])
    r, k, v, w, u, g = _tmix(p, xi, cfg, _shift(xi), tp)
    o, _ = K.rwkv6(r, k, v, w, u, backend="xla")
    B, S = o.shape[:2]
    x = x + _out(p, (o.reshape(B, S, -1) * g).to(x.dtype), tp)
    xc = L.rms_norm(x, p["ln2"])
    return x + _cmix(p, xc, _shift(xc), tp)


def prefill(p, x: torch.Tensor, cfg: ArchConfig, tp=None):
    """Full-sequence layer pass. Returns (x, cache) with the cache
    {"state": (B, h, dk, dv) f32, "shift_t", "shift_c": (B, d)}. The
    state is the recurrence's final state, which the kernel writes
    beside its output (the JAX package folds the sequence a second time
    to get it; the two agree, tests/test_torch_rwkv6.py). ``tp`` runs
    this rank's share of a sharded layer, as :func:`train` does: the
    kernel takes the rank's heads, the state holds them (B, h/n, dk, dv),
    and the token shifts stay whole rows (the lerp reads the whole
    normed input)."""
    xi = L.rms_norm(x, p["ln1"])
    r, k, v, w, u, g = _tmix(p, xi, cfg, _shift(xi), tp)
    # a rank's decay is a slice of the whole one's channels: laid out
    # afresh for the kernel, which reads its inputs densely
    o, state = K.rwkv6(r, k, v, w.contiguous(), u)
    B, S = o.shape[:2]
    x = x + _out(p, (o.reshape(B, S, -1) * g).to(x.dtype), tp)
    xc = L.rms_norm(x, p["ln2"])
    x = x + _cmix(p, xc, _shift(xc), tp)
    return x, {"state": state, "shift_t": xi[:, -1], "shift_c": xc[:, -1]}


def decode(p, x: torch.Tensor, cache_l: dict, cfg: ArchConfig, tp=None):
    """One decode step of one layer; x: (B, 1, d). Returns (x, new
    cache) — the caller's cache is not modified. ``tp`` as in
    :func:`prefill` (the cache's state the rank's heads)."""
    xi = L.rms_norm(x, p["ln1"])
    prev_t = cache_l["shift_t"][:, None, :].to(xi.dtype)
    r, k, v, w, u, g = _tmix(p, xi, cfg, prev_t, tp)
    o, state = K.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                            cache_l["state"])
    o = o.reshape(o.shape[0], 1, -1)                          # (B, 1, d)
    x = x + _out(p, (o * g).to(x.dtype), tp)
    xc = L.rms_norm(x, p["ln2"])
    prev_c = cache_l["shift_c"][:, None, :].to(xc.dtype)
    x = x + _cmix(p, xc, prev_c, tp)
    return x, {"state": state, "shift_t": xi[:, 0], "shift_c": xc[:, 0]}


def cache_spec(cfg: ArchConfig, batch: int, device, tp=None) -> dict:
    """One layer's empty decode cache; under ``tp`` with the time-mix
    split, the state of this rank's heads."""
    h = cfg.n_heads
    dk = cfg.d_model // h
    if tp is not None and tp.sharded("rwkv/wr"):
        h //= tp.size
    dt = cfg.torch_dtype
    return {"state": torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                                 device=device),
            "shift_t": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device),
            "shift_c": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device)}
