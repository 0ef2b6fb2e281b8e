"""Plain PyTorch versions of the port's kernels (port of
:mod:`repro.kernels.ref`). They are the semantic ground truth: the CPU
route of every kernel wrapper, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card."""
from __future__ import annotations

import torch


def masked_avg_ref(blocks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Renormalised drop-masked average over the worker axis.

    blocks: (..., n, d) — worker i's copy of a model block;
    mask:   (..., n)    — any dtype; nonzero where worker i's packet arrived.
    Returns (..., d) in ``blocks.dtype``:
    ``Σ_i mask_i · blocks_i / max(Σ_i mask_i, 1)``, accumulated in f32.
    """
    m = mask.to(torch.float32)
    s = torch.einsum("...n,...nd->...d", m, blocks.to(torch.float32))
    c = m.sum(-1).clamp_min(1.0)
    return (s / c[..., None]).to(blocks.dtype)


def rwkv6_ref(r, k, v, w, u):
    """Sequential RWKV-6 recurrence from ``S_0 = 0``, in f32.

    r, k, w: (B, S, h, dk); v: (B, S, h, dv); u: (h, dk).
      o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
      S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    Returns (o: (B, S, h, dv) in ``r.dtype``, S_S: (B, h, dk, dv) f32).
    The final state is the one the JAX package's prefill folds over the
    sequence (``repro/models/rwkv6.py``): the same f32 update, step by
    step, so it equals that fold exactly.
    """
    B, S, h, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    state = torch.zeros((B, h, dk, dv), dtype=f32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B,h,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[..., :, None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def rwkv6_step_ref(r, k, v, w, u, state):
    """One decode step. r, k, w: (B, h, dk); v: (B, h, dv); state:
    (B, h, dk, dv). Returns (o: (B, h, dv) f32, new_state f32)."""
    f32 = torch.float32
    r, k, v, w, state = (x.to(f32) for x in (r, k, v, w, state))
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r,
                     state + u.to(f32)[..., :, None] * kv)
    return o, w[..., :, None] * state + kv


def rglru_ref(x, a, h0=None):
    """Sequential RG-LRU recurrence, in f32.

    x, a: (B, S, d), a in (0, 1); h0: (B, d) or None (zero).
      h_t = a_t ⊙ h_{t-1} + sqrt(max(1 - a_t², 0)) ⊙ x_t
    Returns (h: (B, S, d) in ``x.dtype``, h_last: (B, d) f32). The JAX
    package's ``rglru_ref`` returns h in f32; the model casts it to its
    dtype at once, which is the rounding done here.
    """
    B, S, d = x.shape
    f32 = torch.float32
    af = a.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(f32)
    h = (torch.zeros((B, d), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    hs = torch.empty((B, S, d), dtype=f32, device=x.device)
    for t in range(S):
        h = af[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def rglru_step_ref(x, a, state):
    """One decode step; x, a, state: (B, d). Returns the new h, f32."""
    f32 = torch.float32
    af = a.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(f32)
    return af * state.to(f32) + b
