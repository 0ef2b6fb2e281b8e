"""PyTorch/CUDA port of :mod:`repro` (the JAX package stays the reference).

The port is laid out like the JAX package so that every module has an
obvious counterpart. Entry points run on the GPU by default; they run on
the CPU only when the caller passes ``device="cpu"``, and asking for CUDA
on a machine without it raises instead of falling back.
"""
from __future__ import annotations


def resolve_device(device="cuda"):
    """The device (a ``torch.device``) an entry point runs on. ``"cuda"``
    (the default) raises when no GPU is visible — there is no silent move
    to the CPU. torch is imported here, not with the package, so that
    :mod:`repro_torch.launch.env` can set the thread pools first."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
