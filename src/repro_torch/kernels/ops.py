"""Public kernel entry points with backend routing (port of
:mod:`repro.kernels.ops`).

Backends:
  - "auto": the kernel wrapper — the CUDA kernel for a CUDA tensor, its
            plain version for a CPU tensor (the wrapper routes by device);
  - "ref":  the plain PyTorch version on either device. On a CUDA device
            only ``chip_smoke.py``'s comparison uses it;
  - "xla":  (``rwkv6``, ``rglru``) the reference's XLA routes, what it
            runs off TPU and trains through: plain torch that autograd
            differentiates, on either device. The train-mode kinds ask
            for it by name; serving never reaches it, and the CUDA
            kernels (forward only) stay the serving route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import masked_avg as _kernel
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import ring as _ring
from repro_torch.kernels import rwkv6 as _rwkv6
from repro_torch.kernels.ref import (masked_avg_ref, rglru_ref,
                                     rglru_step_ref, ring_round_ref,
                                     rwkv6_ref, rwkv6_step_ref)


def masked_avg_grid(blocks: torch.Tensor, mask: torch.Tensor, *,
                    backend: str = "auto") -> torch.Tensor:
    """(B, n, d) stack, (B, n) raw mask -> (B, d) renormalised average."""
    if backend == "auto":
        return _kernel.masked_avg_grid(blocks, mask)
    if backend == "ref":
        _kernel._check_shapes(blocks, mask)
        return masked_avg_ref(blocks, mask)
    raise ValueError(f"backend={backend!r}, want 'auto' or 'ref'")


def masked_avg(blocks: torch.Tensor, mask: torch.Tensor, *,
               backend: str = "auto") -> torch.Tensor:
    """(n, d) stack, (n,) mask -> (d,)."""
    return masked_avg_grid(blocks[None], mask.reshape(1, -1),
                           backend=backend)[0]


# the smallest decay the chunked form takes the log of (the CUDA kernel
# clips at the same value); below it a step's contribution is < 1e-30
RWKV_MIN_DECAY = 1e-30


def _rwkv6_chunk(state, r, k, v, w, u):
    """One chunk of the recurrence in closed form, f32: r, k, w
    (B, C, h, dk), v (B, C, h, dv), state (B, h, dk, dv) at the chunk's
    start. With l_j = log w_j,

        o_t = (r_t ⊙ e^{Σ_{j<t} l_j}) S_0
              + Σ_{s<t} (Σ_k r_tk k_sk e^{Σ_{s<j<t} l_jk}) v_s
              + (r_t · (u ⊙ k_t)) v_t,
        S_C = e^{Σ_j l_j} ⊙ S_0 + Σ_s (k_s ⊙ e^{Σ_{j>s} l_j}) ⊗ v_s.

    Every exponent is a sum over its own index range (a prefix, a
    suffix, or a product of the 0/1 "strictly between" matrix with l),
    never a difference of two cumulative sums, which would cancel: after
    a run of tiny decays the cumulative sum is ~-1e3, and the difference
    of two such sums loses ~1e-4 of a small exponent. Every exponent is
    <= 0. The pairs s >= t are masked in the exponent (to -inf, so
    e^… = 0) and not in the product: a masked product inf · 0 would be
    NaN in the backward."""
    C = r.shape[1]
    la = torch.log(torch.clamp(w, min=RWKV_MIN_DECAY))
    incl = torch.cumsum(la, dim=1)
    prefix = F.pad(incl[:, :-1], (0, 0, 0, 0, 1, 0))        # Σ_{j<t}
    suffix = F.pad(torch.flip(torch.cumsum(torch.flip(la, (1,)), 1),
                              (1,))[:, 1:], (0, 0, 0, 0, 0, 1))   # Σ_{j>s}
    idx = torch.arange(C, device=r.device)
    between = ((idx[None, :, None] < idx[None, None, :])
               & (idx[None, None, :] < idx[:, None, None]))  # (t, s, j)
    expo = torch.einsum("tsj,bjhk->btshk", between.to(la.dtype), la)
    past = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    expo = expo.masked_fill(~past, float("-inf"))
    o = torch.einsum("bthk,bhkv->bthv", r * torch.exp(prefix), state)
    att = torch.einsum("bthk,btshk,bshk->bths", r, torch.exp(expo), k)
    o = o + torch.einsum("bths,bshv->bthv", att, v)
    o = o + torch.sum(r * u * k, -1, keepdim=True) * v
    state = torch.exp(incl[:, -1])[..., None] * state + torch.einsum(
        "bshk,bshv->bhkv", k * torch.exp(suffix), v)
    return state, o


def _rwkv6_scan_of_scans(r, k, v, w, u, chunk: int):
    """The reference's XLA route (``_rwkv6_scan_of_scans``): an outer loop
    over ``chunk``-step chunks carries the f32 (dk, dv) state; each chunk
    is one :func:`_rwkv6_chunk` (the inner scan in closed form),
    checkpointed when grad is on, so the backward keeps O(S / chunk)
    states. Padded steps have w = 1 and r = k = v = 0, as the
    reference's; a sequence shorter than a chunk is one chunk of its own
    length (the reference pads it to ``chunk``: the same function, the
    closed form at any length)."""
    B, S, h, dk = r.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    f32 = torch.float32
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    if pad:
        rf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf))
        wf = F.pad(wf, (0, 0, 0, 0, 0, pad), value=1.0)
    uf = u.to(f32)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u))
    state = torch.zeros((B, h, dk, v.shape[-1]), dtype=f32, device=r.device)
    outs = []
    for c in range(0, S + pad, chunk):
        xs = tuple(t[:, c:c + chunk] for t in (rf, kf, vf, wf))
        if remat:
            state, o = checkpoint(_rwkv6_chunk, state, *xs, uf,
                                  use_reentrant=False)
        else:
            state, o = _rwkv6_chunk(state, *xs, uf)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :S].to(r.dtype), state


def rwkv6(r, k, v, w, u, *, backend: str = "auto", chunk: int = 64):
    """RWKV-6 over a sequence from a zero state: r, k, w (B, S, h, dk),
    v (B, S, h, dv), u (h, dk) -> (o (B, S, h, dv) in ``r.dtype``, final
    state (B, h, dk, dv) f32). ``backend="xla"`` is the reference's
    scan of scans over ``chunk``-step chunks, for training."""
    if backend == "auto":
        return _rwkv6.rwkv6(r, k, v, w, u)
    if backend == "ref":
        _rwkv6.check_shapes(r, k, v, w, u)
        return rwkv6_ref(r, k, v, w, u)
    if backend == "xla":
        _rwkv6.check_shapes(r, k, v, w, u)
        return _rwkv6_scan_of_scans(r, k, v, w, u, chunk)
    raise ValueError(f"backend={backend!r}, want 'auto', 'ref' or 'xla'")


def rwkv6_step(r, k, v, w, u, state):
    """One decode step, plain PyTorch on every device (in the JAX package
    too it is the reference step, not a kernel): r, k, w (B, h, dk),
    v (B, h, dv), state (B, h, dk, dv) -> (o (B, h, dv) in ``r.dtype``,
    new state f32)."""
    o, new_state = rwkv6_step_ref(r, k, v, w, u, state)
    return o.to(r.dtype), new_state


def _rglru_assoc(x, a):
    """The reference's XLA route (``_rglru_assoc``, an associative scan
    over (a, b) pairs): h_t = a_t h_{t-1} + b_t with b_t = sqrt(1 - a_t²)
    x_t, in f32, as a log-step (Hillis–Steele) scan — ceil(log2 S)
    elementwise rounds that autograd takes without a graph per time
    step. Returns h (B, S, d) f32."""
    af = a.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(torch.float32)
    S = af.shape[1]
    step = 1
    while step < S:
        # combine(earlier, later) = (a_l a_r, b_l a_r + b_r); the steps
        # before the sequence are the identity (a = 1, b = 0)
        b = F.pad(b[:, :-step], (0, 0, step, 0)) * af + b
        af = F.pad(af[:, :-step], (0, 0, step, 0), value=1.0) * af
        step *= 2
    return b


def rglru(x, a, *, backend: str = "auto"):
    """RG-LRU over a sequence from a zero carry: x, a (B, S, d) ->
    (h (B, S, d), h_last (B, d) f32). On the kernel's routes h is in
    ``x.dtype``: the JAX package's ``ops.rglru`` returns h in f32, and
    its only caller casts h to the model dtype at once, so the two give
    the same model outputs. ``backend="xla"`` is the reference's
    associative scan, for training; it returns h in f32 as the
    reference's does."""
    if backend == "auto":
        return _rglru.rglru(x, a)
    if backend == "ref":
        _rglru.check_shapes(x, a)
        return rglru_ref(x, a)
    if backend == "xla":
        _rglru.check_shapes(x, a)
        h = _rglru_assoc(x, a)
        return h, h[:, -1]
    raise ValueError(f"backend={backend!r}, want 'auto', 'ref' or 'xla'")


def rglru_step(x, a, state):
    """One decode step, plain PyTorch on every device (the reference
    step, not a kernel, in the JAX package too): x, a, state (B, d) ->
    new h (B, d) f32."""
    return rglru_step_ref(x, a, state)


def ring_round(stack, rs, ag, div, *, mode: str, rs_dtype=torch.float32,
               enc=None, scale=None, levels: int = 0,
               backend: str = "auto"):
    """One exchange group's drop-masked ring round for all n stacked
    ranks: stack (G, n, s, d), rs / ag (G, n, s), div (G, s) f32 ->
    (G, n, s, d) in ``stack.dtype`` (see :mod:`repro_torch.kernels.ring`).
    With ``enc`` (an int8 table and its (G, n, s) ``scale``, or the EF
    send in stack's dtype) the contributions come from ``enc`` and
    ``levels > 0`` re-encodes the partial on every hop: the encoded
    variant, :func:`repro_torch.kernels.ring.ring_round_enc`."""
    if enc is None and levels:
        raise ValueError("levels > 0 needs an int8 enc")
    if backend == "auto":
        if enc is None:
            return _ring.ring_round(stack, rs, ag, div, mode=mode,
                                    rs_dtype=rs_dtype)
        return _ring.ring_round_enc(stack, enc, scale, rs, ag, div,
                                    mode=mode, rs_dtype=rs_dtype,
                                    levels=levels)
    if backend == "ref":
        _ring.check_shapes(stack, rs, ag, div, mode)
        if enc is not None:
            _ring.check_enc(stack, enc, scale, rs_dtype, levels)
        return ring_round_ref(stack, rs, ag, div, mode=mode,
                              rs_dtype=rs_dtype, enc=enc, scale=scale,
                              levels=levels)
    raise ValueError(f"backend={backend!r}, want 'auto' or 'ref'")
