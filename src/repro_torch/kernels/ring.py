"""The drop-masked ring round of one exchange group, for all n stacked
ranks in one launch (port of :mod:`repro.kernels.rps_ring`'s
``ring_bucket_fused`` for the linear wires).

For G buckets of s blocks of width d, with block j owned by rank
``o = j % n``::

    acc  = Σ over ranks r = o+1, o+2, …, o+n−1, o (mod n) of
           cast_acc(stack[g, r, j]) · cast_acc(rs[g, r, j])
           (every add in the accumulation dtype, no leading zero)
    mine = cast_payload(acc / cast_acc(div[g, j]))
    out[g, i, j] = mine             where ag[g, i, j] is nonzero
                 = stack[g, i, j]   elsewhere (model, grad_renorm)
                 = 0                elsewhere (grad)

— what ``ring_bucket_fused`` returns on device i of an n-device ring.
On a CUDA tensor :func:`ring_round` launches the hand-written Hopper
kernel in ``csrc/ring.cu`` (or raises); on a CPU tensor it computes the
plain version :func:`repro_torch.kernels.ref.ring_round_ref`, which runs
the ring hop for hop. The two agree bit for bit: the same adds in the
same order and dtype, one IEEE division.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ring_round_ref

PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)
ACC_DTYPES = (torch.float32, torch.bfloat16)
MASK_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64,
               torch.float32, torch.bfloat16, torch.float16)
MODES = ("model", "grad", "grad_renorm")
# the op ``torch.ops.repro_torch.ring_round``, loaded at first launch
_op = None


def check_shapes(stack, rs, ag, div, mode: str) -> None:
    """stack (G, n, s, d); rs, ag (G, n, s); div (G, s)."""
    if stack.dim() != 4:
        raise ValueError(f"stack must be (G, n, s, d), got "
                         f"{tuple(stack.shape)}")
    G, n, s, _ = stack.shape
    for name, m in (("rs", rs), ("ag", ag)):
        if tuple(m.shape) != (G, n, s):
            raise ValueError(f"{name} shape {tuple(m.shape)} != "
                             f"{(G, n, s)}")
    if tuple(div.shape) != (G, s):
        raise ValueError(f"div shape {tuple(div.shape)} != {(G, s)}")
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}, want one of {MODES}")


def _check_cuda(stack, rs, ag, div, rs_dtype) -> None:
    """Devices, dtypes and contiguity; the binding checks the launch
    limits."""
    for name, t in (("rs", rs), ("ag", ag), ("div", div)):
        if t.device != stack.device:
            raise ValueError(f"{name} on {t.device}, stack on "
                             f"{stack.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    if stack.dtype not in PAYLOAD_DTYPES:
        raise TypeError(f"stack dtype {stack.dtype} not in "
                        f"{PAYLOAD_DTYPES}")
    if rs_dtype not in ACC_DTYPES:
        raise TypeError(f"accumulation dtype {rs_dtype} not in "
                        f"{ACC_DTYPES}")
    for name, m in (("rs", rs), ("ag", ag)):
        if m.dtype not in MASK_DTYPES:
            raise TypeError(f"{name} dtype {m.dtype} not in {MASK_DTYPES}")
    if div.dtype != torch.float32:
        raise TypeError(f"div must be float32, got {div.dtype}")


def ring_round(stack, rs, ag, div, *, mode: str, rs_dtype=torch.float32):
    """One group's ring round, one launch for every bucket, block and
    rank.

    stack: (G, n, s, d) f32 / bf16 payload in block order; rs, ag:
    (G, n, s) masks of any dtype (nonzero = delivered); div: (G, s) f32
    divisor; ``rs_dtype``: the accumulation dtype (f32 or bf16). Returns
    (G, n, s, d) in ``stack.dtype``. ``ring_round.launches`` counts
    kernel launches (CPU calls run the plain version and do not count).
    """
    check_shapes(stack, rs, ag, div, mode)
    if stack.device.type == "cpu":
        return ring_round_ref(stack, rs, ag, div, mode=mode,
                              rs_dtype=rs_dtype)
    if stack.device.type != "cuda":
        raise ValueError(f"ring_round: no kernel for {stack.device}")
    _check_cuda(stack, rs, ag, div, rs_dtype)
    global _op
    if _op is None:
        _op = build.load_kernels().ring_round
    out = torch.empty_like(stack)
    _op(stack, rs, ag, div, out, mode != "grad", rs_dtype == torch.bfloat16)
    ring_round.launches += 1
    return out


ring_round.launches = 0
