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
