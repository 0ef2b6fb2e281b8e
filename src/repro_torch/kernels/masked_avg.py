"""Fused drop-masked renormalised block average (port of
:mod:`repro.kernels.masked_avg`).

The owner's step of the RPS reduce-scatter (Algorithm 1, line 6):
``out[b] = Σ_i mask[b,i]·blocks[b,i] / max(Σ_i mask[b,i], 1)`` for all B
server blocks of an exchange round. On a CUDA tensor
:func:`masked_avg_grid` launches the hand-written Hopper kernel in
``csrc/masked_avg.cu`` (or raises); on a CPU tensor it computes the plain
version :func:`repro_torch.kernels.ref.masked_avg_ref`; on a meta tensor
under the dry-run's counter (``roofline/count.py``) it records the
kernel's cost (``roofline/analysis.py::kernel_cost``) and returns an
empty result, as :func:`tp_combine` does.

:func:`tp_combine` is the same average redesigned for the serving path:
one drop-masked tensor-parallel site (``serve/tp.py``) in one launch,
from the einsum's partials and the step's mask stacks to the receiver's
consensus, its plain version
:func:`repro_torch.kernels.ref.tp_combine_ref`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import masked_avg_ref, tp_combine_ref
from repro_torch.roofline.count import counting, record_kernel

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
    launches (CPU calls run the plain version and do not count; a meta
    call under the dry-run's counter records the kernel's cost and
    returns an empty result).
    """
    _check_shapes(blocks, mask)
    if blocks.device.type == "cpu":
        return masked_avg_ref(blocks, mask)
    if counting(blocks):
        record_kernel("masked_avg_grid", blocks, mask)
        return blocks.new_empty((blocks.shape[0], blocks.shape[2]))
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


class CombineGeometry(NamedTuple):
    """The decode plan's layout of the (d, B) leaf that :func:`tp_combine`
    needs: ``s`` server blocks of ``blk`` rows, ``pad`` zero rows at the
    end (``s · blk − pad = d · B``)."""
    s: int
    blk: int
    pad: int


PARTIAL_DTYPES = (torch.float32, torch.bfloat16)
WIRE_DTYPES = (torch.float32, torch.bfloat16)


def _check_combine(partials, rs, ag, site, n, receiver, geom, wire_dtype):
    if partials.dim() != 4 or partials.shape[0] != n \
            or partials.shape[2] != 1:
        raise ValueError(f"partials must be ({n}, B, 1, d), got "
                         f"{tuple(partials.shape)}")
    _, B, _, d = partials.shape
    if rs.dim() != 3 or tuple(rs.shape[1:]) != (n, geom.s) \
            or ag.shape != rs.shape:
        raise ValueError(f"rs {tuple(rs.shape)} and ag {tuple(ag.shape)} "
                         f"must both be (n_sites, {n}, {geom.s})")
    if not 0 <= site < rs.shape[0]:
        raise ValueError(f"site={site} not in [0, {rs.shape[0]})")
    if not 0 <= receiver < n:
        raise ValueError(f"receiver={receiver} not in [0, {n})")
    if geom.blk < 1 or geom.s * geom.blk - geom.pad != d * B \
            or not 0 <= geom.pad < geom.s * geom.blk:
        raise ValueError(f"{geom} does not lay out d·B = {d * B}")
    if partials.dtype not in PARTIAL_DTYPES:
        raise TypeError(f"partials dtype {partials.dtype} not in "
                        f"{PARTIAL_DTYPES}")
    if wire_dtype not in WIRE_DTYPES:
        raise TypeError(f"wire dtype {wire_dtype} not in {WIRE_DTYPES}")
    if rs.dtype != torch.bool or ag.dtype != torch.bool:
        raise TypeError(f"rs {rs.dtype} and ag {ag.dtype} must be bool, "
                        f"the channels' masks")
    if not partials.device == rs.device == ag.device:
        raise ValueError(f"partials on {partials.device}, rs on "
                         f"{rs.device}, ag on {ag.device}")


def tp_combine(partials: torch.Tensor, rs: torch.Tensor, ag: torch.Tensor,
               site: int, *, n: int, receiver: int,
               plan_geometry: CombineGeometry,
               wire_dtype: torch.dtype) -> torch.Tensor:
    """The drop-masked TP combine of decode site ``site`` in one launch.

    partials: (n, B, 1, d) f32 / bf16, the shards' partial sums (read
    through their strides); rs, ag: the step's (n_sites, n, s) bool mask
    stacks in any layout (the kernel reads the site's rows in place,
    through their strides);
    ``plan_geometry``: the decode plan's blocks; ``wire_dtype``: f32 or
    bf16. Returns the receiver's consensus (B, 1, d) f32, the value of
    the exchange route (:func:`repro_torch.kernels.ref.tp_combine_ref`).
    ``tp_combine.launches`` counts kernel launches (CPU calls run the
    plain version and do not count).
    """
    geom = plan_geometry
    _check_combine(partials, rs, ag, site, n, receiver, geom, wire_dtype)
    if partials.device.type == "cpu":
        return tp_combine_ref(partials, rs, ag, site, n=n,
                              receiver=receiver, s=geom.s, blk=geom.blk,
                              pad=geom.pad, wire_dtype=wire_dtype)
    if counting(partials):
        record_kernel("tp_combine", partials, rs, ag, site, n=n,
                      receiver=receiver, plan_geometry=geom,
                      wire_dtype=wire_dtype)
        return partials.new_empty((partials.shape[1], 1, partials.shape[3]),
                                  dtype=torch.float32)
    if partials.device.type != "cuda":
        raise ValueError(f"tp_combine: no kernel for {partials.device}")
    global _tp_op
    if _tp_op is None:
        _tp_op = build.load_kernels().tp_combine
    _, B, _, d = partials.shape
    out = torch.empty((B, 1, d), dtype=torch.float32, device=partials.device)
    _tp_op(partials, rs, ag, out, site, receiver, geom.blk,
           wire_dtype == torch.bfloat16)
    tp_combine.launches += 1
    return out


tp_combine.launches = 0
# the op ``torch.ops.repro_torch.tp_combine``, loaded at first launch
_tp_op = None
