"""Model primitives (port of :mod:`repro.models.layers`): RMS norm, RoPE,
GQA attention (prefill, contiguous and paged decode), gated MLP,
embedding and head.

Layouts are the JAX package's: ``wq``/``wk``/``wv`` are (d, h, hd), ``wo``
is (h, hd, d), activations (B, S, …), the contiguous KV cache is
(B, C, kvh, hd) and the paged KV pool (n_slots, kvh, hd) per layer.
Mixed-dtype products follow JAX's type promotion (:func:`einsum`), so a
bf16 weight meeting an f32 activation is computed in f32, as the
reference does.

Prefill runs :func:`full_attention` at every length. The JAX package
switches to blocked local or chunked attention above 2·window or 2048
tokens; those compute the same function and the tests hold the port to
them within tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

NEG_INF = -1e30


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to their common dtype
    first (JAX promotes; torch would refuse mixed dtypes)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _init(gen: torch.Generator, shape, scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, scale²) in f32 cast to ``dtype`` (the reference's
    ``_init``), drawn from ``gen`` on its device."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the ``(1 + gamma)`` scale (norms initialise to 0)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + gamma.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    dt = cfg.torch_dtype
    return {"wq": _init(gen, (d, h, hd), s, dt),
            "wk": _init(gen, (d, kv, hd), s, dt),
            "wv": _init(gen, (d, kv, hd), s, dt),
            "wo": _init(gen, (h, hd, d), (h * hd) ** -0.5, dt)}


def _sdpa(q, k, v, mask):
    """q: (B,Sq,h,hd); k, v: (B,Sk,kv,hd); mask broadcastable to
    (B,kv,g,Sq,Sk)."""
    B, Sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qr = q.reshape(B, Sq, kvh, g, hd)
    logits = einsum("bqkgh,bskh->bkgqs", qr, k).to(torch.float32)
    logits = logits * (hd ** -0.5)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, h, hd)


def full_attention(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0):
    """Quadratic attention with an arithmetic banded window mask (local
    and global layers share one code path)."""
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    delta = qpos[:, None] - kpos[None, :]
    mask = delta >= 0 if causal else torch.ones_like(delta, dtype=torch.bool)
    if window is not None:
        mask = mask & (delta < window)
    return _sdpa(q, k, v, mask)


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, ring: bool = False):
    """One-token attention against a contiguous cache view.

    q: (B,1,h,hd); caches: (B,C,kv,hd); ``pos``: the absolute position of
    the new token, a scalar or a (B,) tensor of per-request positions.
    With ``ring`` the cache is a ring buffer of C slots and every slot
    written so far is valid (``idx < min(pos + 1, C)``, the reference's
    mask); otherwise slots ``pos - window < idx <= pos`` are valid.
    """
    B, C, kvh, hd = k_cache.shape
    idx = torch.arange(C, device=q.device)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1, 1)   # (B|1, 1)
    if ring:
        valid = idx[None, :] < torch.clamp(pos + 1, max=C)
    else:
        valid = idx[None, :] <= pos
        if window is not None:
            valid = valid & (idx[None, :] > pos - window)
    mask = valid.reshape(-1, 1, 1, 1, C)
    g = q.shape[2] // kvh
    qr = q.reshape(B, 1, kvh, g, hd)
    logits = einsum("bqkgh,bskh->bkgqs", qr, k_cache).to(torch.float32)
    logits = logits * (hd ** -0.5)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(B, 1, q.shape[2], hd)


def attention_fwd(p, x, *, cfg: ArchConfig, window: Optional[int]):
    """Full-sequence causal self-attention (prefill). Returns
    (out, (k, v))."""
    q = einsum("bsd,dhe->bshe", x, p["wq"])
    k = einsum("bsd,dhe->bshe", x, p["wk"])
    v = einsum("bsd,dhe->bshe", x, p["wv"])
    positions = torch.arange(q.shape[1], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = full_attention(q, k, v, causal=True, window=window)
    out = einsum("bshe,hed->bsd", out, p["wo"])
    return out, (k, v)


def attention_decode(p, x, k_cache, v_cache, pos: int, *, cfg: ArchConfig,
                     window: Optional[int] = None, ring: bool = False):
    """One-step decode against the contiguous cache (all requests at one
    position ``pos``): writes the new token's K/V at slot ``pos % C``
    with ``ring``, else at slot ``pos`` (clamped to the last slot, as the
    reference's ``dynamic_update_slice`` clamps), then attends. The
    caches are written **in place** (the JAX package returns updated
    copies and its decode step donates the cache). Returns
    (out, k_cache, v_cache)."""
    q = einsum("bsd,dhe->bshe", x, p["wq"])
    k = einsum("bsd,dhe->bshe", x, p["wk"])
    v = einsum("bsd,dhe->bshe", x, p["wv"])
    positions = torch.full((1,), pos, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    C = k_cache.shape[1]
    slot = pos % C if ring else min(pos, C - 1)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, pos, window=window,
                           ring=ring)
    out = einsum("bshe,hed->bsd", out, p["wo"])
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# Paged KV attention
# ---------------------------------------------------------------------------

def paged_gather(pool: torch.Tensor, bt: torch.Tensor,
                 page: int) -> torch.Tensor:
    """Per-request contiguous cache view from the slot pool.

    pool: (n_slots, kvh, hd); bt: (B, P) int block table. Returns
    (B, P·page, kvh, hd) where row i is the slot holding position i of
    that request. Unwritten positions read whatever their slot holds
    (block 0, the null block, for unallocated pages); the decode mask
    hides them.
    """
    B, P = bt.shape
    slots = bt[:, :, None] * page + torch.arange(page, device=bt.device)
    return pool[slots.reshape(B, P * page)]


def paged_write(pool: torch.Tensor, new: torch.Tensor, bt: torch.Tensor,
                pos: torch.Tensor, page: int) -> torch.Tensor:
    """Write one token's K or V for each request at ``pos``, **in place**
    (the JAX package returns an updated copy; the port mutates the pool
    to keep one copy of it). new: (B, 1, kvh, hd); pos: (B,). Inactive
    lanes point at the null block and harmlessly overwrite its slots."""
    B = bt.shape[0]
    rows = torch.arange(B, device=bt.device)
    flat = bt[rows, pos // page] * page + pos % page
    pool[flat] = new[:, 0].to(pool.dtype)
    return pool


def attention_decode_paged(p, x, pool_k, pool_v, pos, *, bt, page: int,
                           cfg: ArchConfig, window: Optional[int] = None,
                           tp=None, tp_masks=None, site=None):
    """One-step decode against the paged pool: write the new token's K/V
    through the block table, gather the contiguous view, attend with
    per-request positions. ``tp`` (a ``serve.tp.TPContext``) reroutes the
    output projection through the drop-masked exchange; ``site`` indexes
    this layer's packet masks in ``tp_masks``. Returns
    (out, pool_k, pool_v)."""
    q = einsum("bsd,dhe->bshe", x, p["wq"])
    k = einsum("bsd,dhe->bshe", x, p["wk"])
    v = einsum("bsd,dhe->bshe", x, p["wv"])
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    paged_write(pool_k, k, bt, pos, page)
    paged_write(pool_v, v, bt, pos, page)
    kc = paged_gather(pool_k, bt, page)
    vc = paged_gather(pool_v, bt, page)
    out = decode_attention(q, kc, vc, pos, window=window)
    if tp is None:
        out = einsum("bshe,hed->bsd", out, p["wo"])
    else:
        out = tp.combine_attn(out, p["wo"], tp_masks, site)
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {"wi": _init(gen, (d, ff), d ** -0.5, dt),
            "wg": _init(gen, (d, ff), d ** -0.5, dt),
            "wo": _init(gen, (ff, d), ff ** -0.5, dt)}


def mlp_hidden(p, x):
    """The gated hidden activation silu(x·wg) ⊙ (x·wi)."""
    h = einsum("bsd,df->bsf", x, p["wi"])
    g = einsum("bsd,df->bsf", x, p["wg"])
    return F.silu(g) * h


def mlp(p, x):
    return einsum("bsf,fd->bsd", mlp_hidden(p, x), p["wo"])


def init_embed(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    V = cfg.padded_vocab
    return {"tok": _init(gen, (V, cfg.d_model), 1.0, dt),
            "head": _init(gen, (cfg.d_model, V), cfg.d_model ** -0.5, dt),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=gen.device)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_head(p, x, vocab_size: Optional[int] = None) -> torch.Tensor:
    """Logits over the padded vocab with the padding masked to -1e30."""
    x = rms_norm(x, p["final_norm"])
    logits = einsum("bsd,dv->bsv", x, p["head"])
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32; logits (B, S, V), labels
    (B, S) of any integer dtype."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
