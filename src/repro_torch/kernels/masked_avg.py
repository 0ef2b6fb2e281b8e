"""Fused drop-masked renormalised block average (port of
:mod:`repro.kernels.masked_avg`).

The owner's step of the RPS reduce-scatter (Algorithm 1, line 6):
``out[b] = Σ_i mask[b,i]·blocks[b,i] / max(Σ_i mask[b,i], 1)`` for all B
server blocks of an exchange round. On a CUDA tensor
:func:`masked_avg_grid` launches the hand-written Hopper kernel in
``csrc/masked_avg.cu`` (or raises); on a CPU tensor it computes the plain
version :func:`repro_torch.kernels.ref.masked_avg_ref`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import masked_avg_ref

DEFAULT_TILE_D = 512
BLOCK_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MASK_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64,
               torch.float32, torch.bfloat16, torch.float16)
# the op ``torch.ops.repro_torch.masked_avg_grid``, loaded at first launch
_op = None


def pick_tile_d(d: int, cap: int = DEFAULT_TILE_D) -> int:
    """Largest tile ≤ cap that divides d (so no padded tiles), preferring
    d itself when it fits; 512-with-padding only when d has no divisor of
    at least 128 (padding then costs < one tile)."""
    if d <= cap:
        return max(d, 1)
    for t in range(cap, 127, -1):
        if d % t == 0:
            return t
    return cap


def _check_shapes(blocks: torch.Tensor, mask: torch.Tensor) -> None:
    if blocks.dim() != 3:
        raise ValueError(f"blocks must be (B, n, d), got {tuple(blocks.shape)}")
    B, n, _ = blocks.shape
    if tuple(mask.shape) != (B, n):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({B}, {n})")


def _check_cuda(blocks: torch.Tensor, mask: torch.Tensor) -> None:
    """Devices, dtypes and contiguity; the binding checks the launch
    limits on B, n and d."""
    if mask.device != blocks.device:
        raise ValueError(f"mask on {mask.device}, blocks on {blocks.device}")
    if blocks.dtype not in BLOCK_DTYPES:
        raise TypeError(f"blocks dtype {blocks.dtype} not in {BLOCK_DTYPES}")
    if mask.dtype not in MASK_DTYPES:
        raise TypeError(f"mask dtype {mask.dtype} not in {MASK_DTYPES}")
    if not (blocks.is_contiguous() and mask.is_contiguous()):
        raise ValueError("blocks and mask must be contiguous")


_tile_for = functools.lru_cache(maxsize=None)(pick_tile_d)


def masked_avg_grid(blocks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched renormalised block average, one launch for all B blocks.

    blocks: (B, n, d) in f32 / bf16 / f16; mask: (B, n) raw, any dtype
    (cast inside the kernel). Returns (B, d) in ``blocks.dtype``,
    accumulated in f32. ``masked_avg_grid.launches`` counts kernel
    launches (CPU calls run the plain version and do not count).
    """
    _check_shapes(blocks, mask)
    if blocks.device.type == "cpu":
        return masked_avg_ref(blocks, mask)
    if blocks.device.type != "cuda":
        raise ValueError(f"masked_avg_grid: no kernel for {blocks.device}")
    _check_cuda(blocks, mask)
    global _op
    if _op is None:
        _op = build.load_kernels().masked_avg_grid
    B, _, d = blocks.shape
    out = torch.empty((B, d), dtype=blocks.dtype, device=blocks.device)
    _op(blocks, mask, out, _tile_for(d))
    masked_avg_grid.launches += 1
    return out


masked_avg_grid.launches = 0


def masked_avg(blocks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """blocks: (n, d); mask: (n,) -> (d,). Single-block form of
    :func:`masked_avg_grid` (B = 1)."""
    return masked_avg_grid(blocks[None], mask.reshape(1, -1))[0]
