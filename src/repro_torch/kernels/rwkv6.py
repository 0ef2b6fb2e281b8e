"""RWKV-6 recurrence over a whole sequence (port of
:mod:`repro.kernels.rwkv6_scan`).

From a zero state, ``o_t = r_t·(S_{t−1} + diag(u)·k_t⊗v_t)`` and
``S_t = diag(w_t)·S_{t−1} + k_t⊗v_t`` for every (batch, head), with the
(dk, dv) state in f32. On a CUDA tensor :func:`rwkv6` launches the
hand-written Hopper kernel in ``csrc/rwkv6.cu`` — the chunked form on
tensor cores, one CUDA launch per call — (or raises); on a CPU
tensor it computes the plain version
:func:`repro_torch.kernels.ref.rwkv6_ref`; on a meta tensor under the
dry-run's counter it records the kernel's cost and returns empty results. Both
return the final state
beside the output: the prefill keeps it as the decode cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rwkv6_ref
from repro_torch.roofline.count import counting, record_kernel

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_DIM = 64          # kRwkv6MaxDim in csrc/kernels.h
CHUNK = 64            # tokens per chunk of the kernel
# the op ``torch.ops.repro_torch.rwkv6_fwd``, loaded at first launch
_op = None


def check_shapes(r, k, v, w, u) -> None:
    """r, k, w (B, S, h, dk); v (B, S, h, dv); u (h, dk); S >= 1."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, h, dk), got {tuple(r.shape)}")
    B, S, h, dk = r.shape
    if tuple(k.shape) != tuple(r.shape) or tuple(w.shape) != tuple(r.shape):
        raise ValueError(f"k {tuple(k.shape)} and w {tuple(w.shape)} must "
                         f"equal r {tuple(r.shape)}")
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, S, h):
        raise ValueError(f"v must be ({B}, {S}, {h}, dv), got "
                         f"{tuple(v.shape)}")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be ({h}, {dk}), got {tuple(u.shape)}")
    if S < 1:
        raise ValueError("rwkv6 needs a sequence of at least one step")


def _check_cuda(r, k, v, w, u) -> None:
    """Devices, dtypes, contiguity and the kernel's dk, dv limit."""
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not r.is_contiguous():
        raise ValueError("r must be contiguous")
    if r.dtype not in DTYPES:
        raise TypeError(f"r dtype {r.dtype} not in {DTYPES}")
    if not (k.dtype == v.dtype == w.dtype == r.dtype):
        raise TypeError(f"r, k, v, w must share one dtype, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}, {w.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    dk, dv = r.shape[-1], v.shape[-1]
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"dk = {dk}, dv = {dv}: the kernel takes at most "
                         f"{MAX_DIM}")


def rwkv6(r, k, v, w, u):
    """The recurrence over the whole sequence, one call for all
    (batch, head) pairs: one CUDA launch, and a memset of the flags that
    chain the chunks' states.

    r, k, w: (B, S, h, dk); v: (B, S, h, dv), all of one float dtype;
    u: (h, dk) f32. Returns (o: (B, S, h, dv) in ``r.dtype``, final state
    (B, h, dk, dv) f32). ``rwkv6.launches`` counts kernel launches (CPU
    calls run the plain version and do not count).
    """
    check_shapes(r, k, v, w, u)
    if r.device.type == "cpu":
        return rwkv6_ref(r, k, v, w, u)
    if counting(r):         # the dry-run's count: its cost only
        record_kernel("rwkv6", r, k, v, w, u)
        B, S, h, dk = r.shape
        return (r.new_empty((B, S, h, v.shape[-1])),
                r.new_empty((B, h, dk, v.shape[-1]), dtype=torch.float32))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6: no kernel for {r.device}")
    _check_cuda(r, k, v, w, u)
    global _op
    if _op is None:
        _op = build.load_kernels().rwkv6_fwd
    B, S, h, dk = r.shape
    dv = v.shape[-1]
    out = torch.empty((B, S, h, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((B, h, dk, dv), dtype=torch.float32,
                        device=r.device)
    # per (b, h, chunk): the (64, 64) state it passes on, and its flag
    chunks = B * h * (-(-S // CHUNK))
    scratch = torch.empty(chunks * MAX_DIM * MAX_DIM, dtype=torch.float32,
                          device=r.device)
    ready = torch.zeros(chunks, dtype=torch.int32, device=r.device)
    _op(r, k, v, w, u, out, state, scratch, ready)
    rwkv6.launches += 1
    return out, state


rwkv6.launches = 0
