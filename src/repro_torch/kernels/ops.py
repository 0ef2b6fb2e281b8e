"""Public kernel entry points with backend routing (port of
:mod:`repro.kernels.ops`).

Backends:
  - "auto": the kernel wrapper — the CUDA kernel for a CUDA tensor, its
            plain version for a CPU tensor (the wrapper routes by device);
  - "ref":  the plain PyTorch version on either device. On a CUDA device
            only ``chip_smoke.py``'s comparison uses it.
"""
from __future__ import annotations

import torch

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


def rwkv6(r, k, v, w, u, *, backend: str = "auto"):
    """RWKV-6 over a sequence from a zero state: r, k, w (B, S, h, dk),
    v (B, S, h, dv), u (h, dk) -> (o (B, S, h, dv) in ``r.dtype``, final
    state (B, h, dk, dv) f32)."""
    if backend == "auto":
        return _rwkv6.rwkv6(r, k, v, w, u)
    if backend == "ref":
        _rwkv6.check_shapes(r, k, v, w, u)
        return rwkv6_ref(r, k, v, w, u)
    raise ValueError(f"backend={backend!r}, want 'auto' or 'ref'")


def rwkv6_step(r, k, v, w, u, state):
    """One decode step, plain PyTorch on every device (in the JAX package
    too it is the reference step, not a kernel): r, k, w (B, h, dk),
    v (B, h, dv), state (B, h, dk, dv) -> (o (B, h, dv) in ``r.dtype``,
    new state f32)."""
    o, new_state = rwkv6_step_ref(r, k, v, w, u, state)
    return o.to(r.dtype), new_state


def rglru(x, a, *, backend: str = "auto"):
    """RG-LRU over a sequence from a zero carry: x, a (B, S, d) ->
    (h (B, S, d) in ``x.dtype``, h_last (B, d) f32). The JAX package's
    ``ops.rglru`` returns h in f32; its only caller casts h to the model
    dtype at once, so the two give the same model outputs."""
    if backend == "auto":
        return _rglru.rglru(x, a)
    if backend == "ref":
        _rglru.check_shapes(x, a)
        return rglru_ref(x, a)
    raise ValueError(f"backend={backend!r}, want 'auto' or 'ref'")


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
