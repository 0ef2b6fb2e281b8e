"""Model primitives (port of :mod:`repro.models.layers`): RMS norm, RoPE,
GQA attention (full, chunked and blocked-local for prefill and training;
contiguous and paged decode), gated MLP, sort-based MoE, embedding and
head.

Layouts are the JAX package's: ``wq``/``wk``/``wv`` are (d, h, hd), ``wo``
is (h, hd, d), the experts' ``wi``/``wg`` (E, d, ff) and ``wo`` (E, ff,
d), activations (B, S, …), the contiguous KV cache is (B, C, kvh, hd) and
the paged KV pool (n_slots, kvh, hd) per layer. Mixed-dtype products
follow JAX's type promotion (:func:`einsum`), so a bf16 weight meeting an
f32 activation is computed in f32, as the reference does.

:func:`attention_fwd` takes the reference's routes: blocked local
attention above 2·window (with ``blocked``), chunked online-softmax
attention above 2048 tokens, the quadratic form otherwise. They are plain
torch products, as the reference's are plain XLA; no kernel replaces
them.

The train path's functions take ``tp`` (a :class:`repro_torch.models.
parallel.TP`) on a "model" axis > 1: column-parallel products for the
sharded ``wq`` / ``wk`` / ``wv`` and ``wi`` / ``wg``, row-parallel ones
for a sharded ``wo``, the vocab-parallel embedding, head and
cross-entropy. With ``tp=None`` each is the unsharded function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm
from repro_torch.models import parallel as P

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
    ``_init``), drawn from ``gen`` on its device (scaled in place: one f32
    copy at a time)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _init_stacked(gen: torch.Generator, shape, scale: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """:func:`_init` drawn slice by slice along the leading axis into the
    ``dtype`` tensor: an expert stack holds one f32 slice at a time (a
    (384, 7168, 2048) stack is 22.5 GB in f32, 11.3 GB in bf16). On the
    meta device (the dry-run's count) there is nothing to draw: the
    stack's shape and dtype at once."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.device.type == "meta":
        return out
    for i in range(shape[0]):
        out[i] = _init(gen, shape[1:], scale, dtype)
    return out


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


def _kv_step(acc, m, l, q_i, kj, vj, q_lo: int, k_lo: int, Sk: int,
             causal: bool, window: Optional[int]):
    """One KV chunk of the online softmax: the (qc x kc) score tile
    against chunk ``kj``/``vj`` folded into the running (acc, max, sum)."""
    qc, kc = q_i.shape[1], kj.shape[1]
    s = einsum("bqkgh,bskh->bkgqs", q_i, kj).to(torch.float32)
    s = s * (q_i.shape[-1] ** -0.5)
    qpos = q_lo + torch.arange(qc, device=s.device)
    kpos = k_lo + torch.arange(kc, device=s.device)
    delta = qpos[:, None] - kpos[None, :]
    mask = (kpos < Sk)[None, :] if not causal else delta >= 0
    if window is not None:
        mask = mask & (delta < window)
    s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + einsum("bkgqs,bskh->bkgqh",
                                         p.to(vj.dtype), vj)
    return acc, m_new, l


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_chunk: int = 512,
                      k_chunk: int = 1024):
    """Memory-efficient (flash-style) attention in plain torch: online
    softmax over KV chunks, the q chunks unrolled so that causally dead
    (and out-of-window) KV chunks are skipped by their static ranges, as
    the reference's. With grad on, each KV step is checkpointed
    (``torch.utils.checkpoint`` where the reference has
    ``jax.checkpoint``), so the backward recomputes the (qc x kc) score
    tiles instead of keeping S x S f32 scores."""
    B, S, h, hd = q.shape
    Sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc, kc = min(q_chunk, S), min(k_chunk, Sk)
    pad_q, pad_k = (-S) % qc, (-Sk) % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (S + pad_q) // qc, (Sk + pad_k) // kc
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    f32 = torch.float32
    outs = []
    for iq in range(nq):
        q_i = q[:, iq * qc:(iq + 1) * qc].reshape(B, qc, kvh, g, hd)
        q_lo, q_hi = iq * qc, iq * qc + qc - 1
        # static KV-chunk range: causal upper bound, window lower bound
        j_hi = nk - 1 if not causal else min(nk - 1, q_hi // kc)
        j_lo = 0 if window is None else max(0, (q_lo - int(window)) // kc)
        acc = torch.zeros((B, kvh, g, qc, hd), dtype=f32, device=q.device)
        m = torch.full((B, kvh, g, qc), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, kvh, g, qc), dtype=f32, device=q.device)
        for j in range(j_lo, j_hi + 1):
            args = (acc, m, l, q_i, k[:, j * kc:(j + 1) * kc],
                    v[:, j * kc:(j + 1) * kc], q_lo, j * kc, Sk, causal,
                    window)
            if remat:
                acc, m, l = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                acc, m, l = _kv_step(*args)
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        o = o.movedim(3, 1).reshape(B, qc, h, hd)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S]


def blocked_local_attention(q, k, v, *, window: int):
    """Exact sliding-window causal attention in O(S·window): the queries
    of block b (block size = window) attend to key blocks b-1 and b,
    masked to ``qpos - kpos`` in [0, window). The reference computes all
    blocks in one product; the port loops over the blocks, the same
    products block by block, so that one block's (w x 2w) f32 scores
    live at a time (starcoder2-15b's 48 heads at w = 4096: 6.4 GB a
    block, against 19 GB at S = 12,288 for all three)."""
    B, S, h, hd = q.shape
    kvh = k.shape[2]
    w = int(window)
    if S <= 2 * w:      # not worth blocking
        return full_attention(q, k, v, causal=True, window=w)
    pad = (-S) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = (S + pad) // w
    g = h // kvh
    # the previous block of block 0 is zeros, masked out
    kp = F.pad(k, (0, 0, 0, 0, w, 0))
    vp = F.pad(v, (0, 0, 0, 0, w, 0))
    i = torch.arange(w, device=q.device)[:, None]
    j = torch.arange(2 * w, device=q.device)[None, :]
    delta = (i + w) - j
    band = (delta >= 0) & (delta < w)                       # (w, 2w)
    outs = []
    for b in range(nb):
        qb = q[:, b * w:(b + 1) * w].reshape(B, w, kvh, g, hd)
        kw, vw = kp[:, b * w:(b + 2) * w], vp[:, b * w:(b + 2) * w]
        mask = band if b > 0 else band & (j >= w)
        # in place: neither product's backward reads the scores
        logits = einsum("bqkgh,bskh->bkgqs", qb, kw).to(torch.float32)
        logits.mul_(hd ** -0.5).masked_fill_(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(vw.dtype)
        del logits
        out = einsum("bkgqs,bskh->bqkgh", probs, vw)
        outs.append(out.reshape(B, w, h, hd))
    return torch.cat(outs, dim=1)[:, :S]


def attention_route(S: int, window: Optional[int], blocked: bool) -> str:
    """Which of the reference's routes :func:`attention_fwd` takes at
    sequence length ``S``: "blocked", "chunked" or "full"."""
    if blocked and window is not None and S > 2 * int(window):
        return "blocked"
    if S > 2048:
        return "chunked"
    return "full"


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


def _tp_attn(tp) -> bool:
    """Whether ``tp`` splits the attention's heads (``wq`` and ``wo``
    together: the rule shards both by the head count)."""
    return tp is not None and tp.sharded("attn/wq")


def attention_qkv(p, x, *, cfg: ArchConfig, tp=None, positions=None):
    """The projections with RoPE at ``positions`` (default 0..S-1, the
    full sequence): q (B, S, h, hd), k and v (B, S, kvh, hd). Under
    ``tp`` with the heads sharded: this rank's query heads and the KV
    heads they read (its own slice of a sharded ``wk`` / ``wv``, else the
    whole projection's heads,
    :func:`repro_torch.models.parallel.local_kv`)."""
    if _tp_attn(tp):
        xt = tp.copy_to(x)
        q = einsum("bsd,dhe->bshe", xt, p["wq"])
        kv = []
        for name in ("wk", "wv"):
            if tp.sharded("attn/" + name):
                kv.append(einsum("bsd,dhe->bshe", xt, p[name]))
            else:
                kv.append(P.local_kv(tp, einsum("bsd,dhe->bshe", x, p[name]),
                                     cfg.n_heads))
        k, v = kv
    else:
        q = einsum("bsd,dhe->bshe", x, p["wq"])
        k = einsum("bsd,dhe->bshe", x, p["wk"])
        v = einsum("bsd,dhe->bshe", x, p["wv"])
    if positions is None:
        positions = torch.arange(q.shape[1], device=x.device)
    return (rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta), v)


def attention_fwd(p, x, *, cfg: ArchConfig, window: Optional[int],
                  blocked: bool = False, causal: bool = True, tp=None):
    """Full-sequence self-attention (train, prefill; causal unless
    ``causal=False``, the encoder's) on the route the reference takes
    (:func:`attention_route`): blocked local above 2·window when
    ``blocked``, chunked above 2048 tokens, else full. Returns
    (out, (k, v)); under ``tp`` with the heads sharded, this rank's heads
    and the output projection's partial sums reduced over the group."""
    q, k, v = attention_qkv(p, x, cfg=cfg, tp=tp)
    route = attention_route(q.shape[1], window, blocked)
    if route == "blocked":
        out = blocked_local_attention(q, k, v, window=int(window))
    elif route == "chunked":
        out = chunked_attention(q, k, v, causal=causal, window=window)
    else:
        out = full_attention(q, k, v, causal=causal, window=window)
    out = einsum("bshe,hed->bsd", out, p["wo"])
    if _tp_attn(tp):
        out = tp.reduce_from(out)
    return out, (k, v)


def attention_decode(p, x, k_cache, v_cache, pos: int, *, cfg: ArchConfig,
                     window: Optional[int] = None, ring: bool = False,
                     tp=None):
    """One-step decode against the contiguous cache (all requests at one
    position ``pos``): writes the new token's K/V at slot ``pos % C``
    with ``ring``, else at slot ``pos`` (clamped to the last slot, as the
    reference's ``dynamic_update_slice`` clamps), then attends. The
    caches are written **in place** (the JAX package returns updated
    copies and its decode step donates the cache). Under ``tp`` with the
    heads sharded the rank attends with its query heads against a cache
    of the KV heads they read (:func:`attention_qkv`) and the output
    projection's partial sums are reduced over the group. Returns
    (out, k_cache, v_cache)."""
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = attention_qkv(p, x, cfg=cfg, tp=tp, positions=positions)
    C = k_cache.shape[1]
    slot = pos % C if ring else min(pos, C - 1)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, pos, window=window,
                           ring=ring)
    out = einsum("bshe,hed->bsd", out, p["wo"])
    if _tp_attn(tp):
        out = tp.reduce_from(out)
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
# MLP, MoE, embedding, head
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {"wi": _init(gen, (d, ff), d ** -0.5, dt),
            "wg": _init(gen, (d, ff), d ** -0.5, dt),
            "wo": _init(gen, (ff, d), ff ** -0.5, dt)}


def _tp_mlp(tp) -> bool:
    """Whether ``tp`` splits the MLP's hidden dim (``wi``, ``wg`` and
    ``wo`` together: the rule shards all three by d_ff)."""
    return tp is not None and tp.sharded("mlp/wi")


def mlp_hidden(p, x, tp=None):
    """The gated hidden activation silu(x·wg) ⊙ (x·wi); under ``tp`` with
    the hidden dim sharded, this rank's columns of it."""
    if _tp_mlp(tp):
        x = tp.copy_to(x)
    h = einsum("bsd,df->bsf", x, p["wi"])
    g = einsum("bsd,df->bsf", x, p["wg"])
    return F.silu(g) * h


def mlp(p, x, tp=None):
    out = einsum("bsf,fd->bsd", mlp_hidden(p, x, tp), p["wo"])
    if _tp_mlp(tp):
        out = tp.reduce_from(out)
    return out


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """The router (d, E) in f32 and the experts' gated MLPs, the expert
    axis first; each expert stack drawn slice by slice
    (:func:`_init_stacked`)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.torch_dtype
    return {"router": _init(gen, (d, E), d ** -0.5, torch.float32),
            "wi": _init_stacked(gen, (E, d, ff), d ** -0.5, dt),
            "wg": _init_stacked(gen, (E, d, ff), d ** -0.5, dt),
            "wo": _init_stacked(gen, (E, ff, d), ff ** -0.5, dt)}


def moe_route(p, x: torch.Tensor, cfg: ArchConfig, rows=None) -> dict:
    """The sort-based top-k dispatch of :func:`moe` without the experts:
    the router's f32 probabilities, the normalised gates and their
    experts (T, K), the Switch-style aux loss, the capacity, and per
    assignment (token-major, (T·K,)) its rank within its expert, whether
    the capacity kept it and its buffer slot.

    ``rows`` (a :class:`repro_torch.core.comm.Group`): ``x`` is this
    rank's share of a batch whose rows are split over the group in its
    ranks' order, equally. The batch statistics are the whole batch's,
    as the reference computes them on its rows: the capacity from the
    whole batch's tokens; each assignment's rank within its expert after
    the lower ranks' assignments to it (``rank`` and ``keep`` whole-batch;
    ``slot`` in this rank's buffer, by its rank among its own); the aux
    loss from the whole batch's mean probabilities and counts, its
    gradient through this rank's mean probabilities (the trainer averages
    the group's gradients: each rank carries its rows' share n times)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    n = 1 if rows is None else rows.size
    logits = x.reshape(T, d).to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(0)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    counts = counts.index_add(0, gate_idx.reshape(-1),
                              torch.ones((T * K,), dtype=torch.float32,
                                         device=x.device))
    offset = None
    if n > 1:
        # every rank's counts (exact integers in f32), in the rows' order
        every = comm.all_gather(counts[None], rows)
        offset = every[:rows.index].sum(0)
        counts = every.sum(0)
        me_all = comm.all_reduce_mean(me.detach(), rows)
        me = me + (me_all - me).detach()
    ce = counts / (n * T * K)
    aux = E * torch.sum(me * ce)
    cap = max(int(math.ceil(n * T * K / E * cfg.capacity_factor)), 4)
    flat_e = gate_idx.reshape(-1)
    # rank of each assignment within its expert, via a stable sort
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(T * K, device=x.device) - starts[sorted_e]
    local = rank
    if offset is not None:
        rank = rank + offset.to(rank.dtype)[flat_e]
    keep = rank < cap
    slot = flat_e * cap + torch.where(keep, local, 0)
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "aux": aux, "cap": cap, "rank": rank, "keep": keep,
            "slot": slot}


def _experts(p, ebuf: torch.Tensor, tp=None) -> torch.Tensor:
    """The experts' gated MLPs over an (E, cap, d) buffer as batched
    products over the expert axis. Under ``tp`` (the rule's width branch)
    ``wi`` / ``wg`` hold this rank's d_ff columns and ``wo`` its d
    columns, where the rule splits them: the hidden activation is joined
    over d_ff and the output over d, so that the result is whole and the
    same on every rank of the group."""
    wide_in = tp is not None and tp.sharded("moe/wi")
    wide_out = tp is not None and tp.sharded("moe/wo")
    h = einsum("ecd,edf->ecf", ebuf, p["wi"])
    g = einsum("ecd,edf->ecf", ebuf, p["wg"])
    h = P.join(tp, F.silu(g) * h, wide_in, wide_out)
    out = einsum("ecf,efd->ecd", h, p["wo"])
    if wide_out:
        out = comm.gather_from(out, tp.group, 2)
    return out


def moe(p, x: torch.Tensor, cfg: ArchConfig, rows=None, tp=None):
    """Sort-based top-k MoE with per-expert capacity (the reference's
    Megablocks-style permutation dispatch, not a (T, E, C) one-hot): the
    kept assignments scattered into an (E·cap, d) buffer, the experts'
    gated MLPs as batched products over the expert axis, the outputs
    gathered back weighted by their gates. Returns (out, aux_loss).
    ``rows``: ``x`` is this rank's share of a batch split over the
    group (:func:`moe_route`); a token's output is its own.

    ``tp`` (:class:`repro_torch.models.parallel.TP`) runs this rank's
    share of experts split by ``launch/sharding.py::_rule``. The routing
    (the router's probabilities, top-k, gates, capacity, slots and the
    aux term) is computed alike on every rank of the group, and the aux
    enters the loss once. The expert branch (E divides by 16): the rank
    holds experts [j·E/m, (j+1)·E/m), dispatches and combines only the
    assignments to them, and its partial (T, d) output is summed over the
    group; the tokens and the gates enter the region through ``copy_to``,
    so the router's gradient sums every rank's share. The width branch:
    the tokens enter through ``copy_to``, and :func:`_experts` joins the
    split products; the combine runs alike on every rank.

    The reference's sharding constraints on the expert buffer
    (``expert_sharding``, ``shard_acts``) have no counterpart on one
    device."""
    B, S, d = x.shape
    K = cfg.top_k
    T = B * S
    rt = moe_route(p, x, cfg, rows)
    xt = x.reshape(T, d)
    keep, slot, gates = rt["keep"], rt["slot"], rt["gate_vals"]
    cap = rt["cap"]
    n_loc = p["wi"].shape[0]
    split = tp is not None and tp.sharded("moe/wi")
    expert = split and n_loc < cfg.n_experts
    if expert:
        lo = tp.index * n_loc
        flat_e = rt["gate_idx"].reshape(-1)
        keep = keep & (flat_e >= lo) & (flat_e < lo + n_loc)
        slot = torch.where(keep, slot - lo * cap, 0)
        xt, gates = tp.copy_to(xt), tp.copy_to(gates)
    elif split:
        xt = tp.copy_to(xt)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    contrib = torch.where(keep[:, None], xt[tok_idx], 0)
    buf = torch.zeros((n_loc * cap, d), dtype=x.dtype,
                      device=x.device).index_add(0, slot, contrib)
    out_e = _experts(p, buf.reshape(n_loc, cap, d),
                     None if expert else tp).reshape(-1, d)
    gathered = out_e[slot] * gates.reshape(-1, 1).to(x.dtype)
    gathered = torch.where(keep[:, None], gathered, 0)
    out = torch.zeros((T, d), dtype=x.dtype,
                      device=x.device).index_add(0, tok_idx, gathered)
    if expert:
        out = tp.reduce_from(out)
    return out.reshape(B, S, d), rt["aux"]


def init_embed(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = cfg.torch_dtype
    V = cfg.padded_vocab
    return {"tok": _init(gen, (V, cfg.d_model), 1.0, dt),
            "head": _init(gen, (cfg.d_model, V), cfg.d_model ** -0.5, dt),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=gen.device)}


def embed(p, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The token embeddings; under ``tp`` with the table sharded, the
    vocab-parallel lookup (:func:`repro_torch.models.parallel.embed`)."""
    if tp is not None and tp.sharded("embed/tok"):
        return P.embed(tp, p["tok"], tokens)
    return p["tok"][tokens]


def lm_head(p, x, vocab_size: Optional[int] = None,
            tp=None) -> torch.Tensor:
    """Logits over the padded vocab with the padding masked to -1e30;
    under ``tp`` with the head sharded, this rank's columns of them."""
    x = rms_norm(x, p["final_norm"])
    if tp is not None and tp.sharded("embed/head"):
        logits = einsum("bsd,dv->bsv", tp.copy_to(x), p["head"])
        return P.mask_vocab(tp, logits, vocab_size)
    logits = einsum("bsd,dv->bsv", x, p["head"])
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def lm_head_whole(p, x, vocab_size: Optional[int] = None,
                  tp=None) -> torch.Tensor:
    """:func:`lm_head`'s logits whole on every rank: under ``tp`` with the
    head sharded, the ranks' columns gathered over the group (the
    reference's serving steps return replicated logits)."""
    logits = lm_head(p, x, vocab_size, tp)
    if tp is not None and tp.sharded("embed/head"):
        logits = tp.gather_from(logits, logits.dim() - 1)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32; logits (B, S, V), labels
    (B, S) of any integer dtype; under ``tp`` with the head sharded,
    over vocab-parallel logits
    (:func:`repro_torch.models.parallel.softmax_xent`)."""
    if tp is not None and tp.sharded("embed/head"):
        return P.softmax_xent(tp, logits, labels, mask)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
