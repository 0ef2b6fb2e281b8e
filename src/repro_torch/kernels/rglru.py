"""RG-LRU gated diagonal linear recurrence over a whole sequence (port of
:mod:`repro.kernels.rglru_scan`).

From ``h_0 = 0``, ``h_t = a_t ⊙ h_{t−1} + sqrt(max(1 − a_t², 0)) ⊙ x_t``
for every (batch, channel), with the carry in f32. On a CUDA tensor
:func:`rglru` launches the hand-written Hopper kernel in
``csrc/rglru.cu`` (or raises); on a CPU tensor it computes the plain
version :func:`repro_torch.kernels.ref.rglru_ref`. Both write h in
``x.dtype`` (as the TPU kernel does) and return the final f32 carry
beside it: the prefill keeps it as the decode state.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_ref

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the op ``torch.ops.repro_torch.rglru_fwd``, loaded at first launch
_op = None


def check_shapes(x, a) -> None:
    """x, a (B, S, d); S >= 1."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, d), got {tuple(x.shape)}")
    if tuple(a.shape) != tuple(x.shape):
        raise ValueError(f"a {tuple(a.shape)} must equal x "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError("rglru needs a sequence of at least one step")


def _check_cuda(x, a) -> None:
    """Devices, dtypes and contiguity; the binding checks the launch
    limits."""
    if a.device != x.device:
        raise ValueError(f"a on {a.device}, x on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {DTYPES}")
    if a.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"a must be float32 or x's dtype {x.dtype}, got "
                        f"{a.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("x and a must be contiguous")


def rglru(x, a):
    """The recurrence over the whole sequence, one launch for all
    (batch, channel) pairs.

    x: (B, S, d) f32 / bf16 / f16; a: (B, S, d) f32 or ``x.dtype``.
    Returns (h: (B, S, d) in ``x.dtype``, h_last (B, d) f32).
    ``rglru.launches`` counts kernel launches (CPU calls run the plain
    version and do not count).
    """
    check_shapes(x, a)
    if x.device.type == "cpu":
        return rglru_ref(x, a)
    if x.device.type != "cuda":
        raise ValueError(f"rglru: no kernel for {x.device}")
    _check_cuda(x, a)
    global _op
    if _op is None:
        _op = build.load_kernels().rglru_fwd
    B, S, d = x.shape
    out = torch.empty_like(x)
    h_last = torch.empty((B, d), dtype=torch.float32, device=x.device)
    _op(x, a, out, h_last)
    rglru.launches += 1
    return out, h_last


rglru.launches = 0
