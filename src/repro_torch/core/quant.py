"""Block-scale quantisation core (port of :mod:`repro.core.quant`).

One quantisation library, two consumers: the int8 wire codec
(:class:`repro_torch.core.wire.WireCodec`) maps a block table onto the
symmetric grid {−levels, …, +levels} with one f32 scale per block, and
the packed trainer state (:mod:`repro_torch.optim.statepack`) stores
Adam's second moments and the EF residual on the same grid at rest.

Conventions, as in the reference:

  * a *block* is everything after the ``lead`` axis: ``block_delta``
    reduces ``max|x|`` over dims ``lead+1 …`` with ``keepdim``, so the
    scale broadcasts back against ``x``; ``lead = -1`` gives one scale for
    the whole array, :func:`row_lead` one per trailing-dim row;
  * an all-zero block gets Δ = 1/levels, so decode(encode(0)) == 0;
  * rounding is round-to-nearest-even without noise, and stochastic,
    ``⌊y⌋ + (u < y − ⌊y⌋)``, with uniforms ``u`` in [0, 1).

Torch cannot reproduce JAX's threefry stream, so the rounding noise is an
input, as the drop masks are: ``uniforms=`` takes it (the parity tests
hand in the reference's), ``gen=`` draws it from a ``torch.Generator``.

Every step is the reference's op in the reference's order: the scale is
``where(amax > 0, amax, 1) / levels`` and ``y = x / Δ``, both IEEE f32
divisions by a tensor (PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which can differ in the last bit), then
``round`` (half to even), ``clamp`` and the cast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def row_lead(ndim: int) -> int:
    """The ``lead`` that yields one scale per trailing-dim row: a scale
    per output row of a matrix, one in all for vectors and scalars."""
    return max(ndim - 2, -1)


def _levels_like(x: torch.Tensor, levels: int) -> torch.Tensor:
    """``levels`` as a 0-dim f32 tensor on ``x``'s device: dividing by it
    is an IEEE division on every device."""
    return torch.full((), float(levels), dtype=torch.float32,
                      device=x.device)


def block_delta(x: torch.Tensor, levels: int, lead: int = 0) -> torch.Tensor:
    """Per-block grid step: ``max|x|`` over every dim after ``lead``
    (keepdim), divided by ``levels``; all-zero blocks get 1/levels."""
    red = tuple(range(lead + 1, x.dim()))
    amax = x.abs()
    if red:
        amax = amax.amax(dim=red, keepdim=True)
    one = torch.ones((), dtype=amax.dtype, device=amax.device)
    return torch.where(amax > 0, amax, one) / _levels_like(amax, levels)


def stochastic_round(y: torch.Tensor, uniforms: torch.Tensor
                     ) -> torch.Tensor:
    """Unbiased randomised rounding ``⌊y⌋ + (u < y − ⌊y⌋)``. Overwrites
    ``y`` (it holds the fraction afterwards) to spare one full copy."""
    f = torch.floor(y)
    frac = y.sub_(f)
    return f.add_(uniforms < frac)


def quantize(x: torch.Tensor, levels: int, out_dtype: torch.dtype,
             uniforms: Optional[torch.Tensor] = None,
             gen: Optional[torch.Generator] = None, lead: int = 0,
             consume: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x → (grid payload in ``out_dtype``, per-block f32 scales).

    Stochastic rounding with ``uniforms`` (x's shape, f32 in [0, 1)) or
    uniforms drawn from ``gen``; round-to-nearest-even with neither.
    ``consume``: an f32 ``x`` may be overwritten (it holds the scaled
    values afterwards), sparing one x-sized buffer."""
    xf = x.to(torch.float32)
    delta = block_delta(xf, levels, lead)
    y = xf.div_(delta) if consume else xf / delta
    if uniforms is None and gen is not None:
        uniforms = torch.rand(y.shape, generator=gen, dtype=torch.float32,
                              device=y.device)
    if uniforms is None:
        q = y.round_() if consume else torch.round(y)
    else:
        if tuple(uniforms.shape) != tuple(y.shape):
            raise ValueError(f"uniforms shape {tuple(uniforms.shape)} != "
                             f"{tuple(y.shape)}")
        q = stochastic_round(y, uniforms.to(y.device))
    q = q.clamp_(-levels, levels)
    return q.to(out_dtype), delta


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Grid payload back to f32 values (payload × per-block scale)."""
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, levels: int, out_dtype: torch.dtype,
               uniforms: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               lead: int = 0) -> torch.Tensor:
    """dequantize(quantize(x)) in ``x``'s dtype: the value one
    encode/decode round trip delivers."""
    return dequantize(*quantize(x, levels, out_dtype, uniforms, gen, lead)
                      ).to(x.dtype)
