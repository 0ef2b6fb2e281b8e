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
from repro_torch.kernels.ref import masked_avg_ref


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
