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

:func:`ring_round_enc` is the round's encoded variant (``ring_bucket_fused``
with ``has_enc``, and ``levels > 0``): the contributions come from a
separate table — an int8 payload with per-row f32 scales, decoded in the
kernel, or the EF send on a linear wire — while ``stack`` stays the
all-gather fallback (the same kernel in ``csrc/ring.cu``); with
``levels > 0`` every hop re-encodes the running f32 partial onto the int8
grid (``csrc/ring_q.cu``): one thread block cluster per row, which carries
the partial as int8 in shared memory, sized by :func:`requant_plan`; a
row wider than the largest cluster holds takes the kernel's cooperative
wide path.
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
MAX_LEVELS = 127               # the int8 grid
# the re-encoding kernel's cluster path (kRingQMaxCluster, kRingQMaxChunk
# in csrc/kernels.h): at most 16 blocks per row, each carrying at most
# 192 KiB of int8 partial; HALF_CHUNK fits two blocks per SM (the SM's
# 228 KiB of shared memory, 1 KiB reserved per block, a little static)
MAX_CLUSTER = 16
MAX_CHUNK = 192 * 1024
HALF_CHUNK = 112 * 1024
MIN_SPLIT = 8192               # columns a block keeps when a row is split
# the ops ``torch.ops.repro_torch.ring_round`` and ``ring_round_enc``,
# loaded at first launch
_op = None
_op_enc = None


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


def check_enc(stack, enc, scale, rs_dtype, levels: int) -> None:
    """enc (G, n, s, d): int8 with f32 ``scale`` (G, n, s), summed in
    f32; or stack's dtype with no scale. ``levels > 0`` (the per-hop
    re-encode) needs the int8 table."""
    if tuple(enc.shape) != tuple(stack.shape):
        raise ValueError(f"enc shape {tuple(enc.shape)} != "
                         f"{tuple(stack.shape)}")
    if enc.dtype == torch.int8:
        if scale is None or tuple(scale.shape) != tuple(stack.shape[:3]):
            raise ValueError(f"an int8 enc needs scale of shape "
                             f"{tuple(stack.shape[:3])}")
        if scale.dtype != torch.float32 or rs_dtype != torch.float32:
            raise TypeError("an int8 enc takes f32 scales and sums in f32")
    elif enc.dtype != stack.dtype or scale is not None:
        raise TypeError(f"enc must be int8 (with scale) or stack's dtype "
                        f"{stack.dtype} (without), got {enc.dtype}")
    if not 0 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels={levels}, want 0..{MAX_LEVELS}")
    if levels and enc.dtype != torch.int8:
        raise ValueError("levels > 0 re-encodes an int8 wire; enc is "
                         f"{enc.dtype}")


def requant_plan(rows: int, d: int, sms: int) -> tuple:
    """(cluster, chunk) of the re-encoding kernel for ``rows`` rows of
    ``d`` columns on a card of ``sms`` SMs: the fewest blocks per row (a
    power of two) whose chunk of columns (rounded up to 16) fits two
    blocks per SM, doubled while the grid has fewer than two blocks per
    SM and a block keeps at least MIN_SPLIT columns; a row too wide for
    two blocks per SM takes MAX_CLUSTER blocks of up to MAX_CHUNK. (0, 0):
    the row is wider than MAX_CLUSTER * MAX_CHUNK, the wide path."""
    def chunk(c):  # ceil(d / c) rounded up to 16 columns
        cols = -(-d // c)
        return -(-cols // 16) * 16

    if chunk(MAX_CLUSTER) > MAX_CHUNK:
        return 0, 0
    c = 1
    while c < MAX_CLUSTER and chunk(c) > HALF_CHUNK:
        c *= 2
    while (c < MAX_CLUSTER and rows * c < 2 * sms
           and chunk(2 * c) >= MIN_SPLIT):
        c *= 2
    return c, chunk(c)


def ring_round_enc(stack, enc, scale, rs, ag, div, *, mode: str,
                   rs_dtype=torch.float32, levels: int = 0):
    """One group's ring round with the contributions from an encoded
    table, one launch for every bucket, block and rank.

    stack: (G, n, s, d) f32 / bf16 payload, the all-gather fallback;
    enc: (G, n, s, d) int8 with ``scale`` (G, n, s) f32 — contribution
    ``float(cast_payload(q · scale))``, summed in f32 — or a table in
    stack's dtype (the EF send on a linear wire) with ``scale=None``,
    summed in ``rs_dtype``; rs, ag, div as :func:`ring_round`.
    ``levels > 0``: before each hop's add the running partial is
    re-encoded per row onto {−levels, …, levels} and decoded. Returns
    (G, n, s, d) in ``stack.dtype``; ``ring_round_enc.launches`` counts
    kernel launches (CPU calls run the plain version and do not count),
    ``ring_round_enc.requant_launches`` those with ``levels > 0`` (the
    re-encoding kernel of ring_q.cu; the others run ring.cu's encoded
    variant)."""
    check_shapes(stack, rs, ag, div, mode)
    check_enc(stack, enc, scale, rs_dtype, levels)
    if stack.device.type == "cpu":
        return ring_round_ref(stack, rs, ag, div, mode=mode,
                              rs_dtype=rs_dtype, enc=enc, scale=scale,
                              levels=levels)
    if stack.device.type != "cuda":
        raise ValueError(f"ring_round_enc: no kernel for {stack.device}")
    _check_cuda(stack, rs, ag, div, rs_dtype)
    for name, t in (("enc", enc), ("scale", scale)):
        if t is None:
            continue
        if t.device != stack.device:
            raise ValueError(f"{name} on {t.device}, stack on "
                             f"{stack.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    global _op_enc
    if _op_enc is None:
        _op_enc = build.load_kernels().ring_round_enc
    G, n, s, d = stack.shape
    out = torch.empty_like(stack)
    cluster = chunk = 0
    if levels:
        sms = torch.cuda.get_device_properties(
            stack.device).multi_processor_count
        cluster, chunk = requant_plan(G * s, d, sms)
    # the wide path's scratch: the f32 partial between hops and each row's
    # max|partial| per hop, as float bits (zeroed)
    wide = levels and not cluster
    part = torch.empty((G, s, d) if wide else (0,), dtype=torch.float32,
                       device=stack.device)
    amax = torch.zeros((G * s, n) if wide else (0,), dtype=torch.int32,
                       device=stack.device)
    _op_enc(stack, enc, scale, rs, ag, div, out, part, amax,
            mode != "grad", rs_dtype == torch.bfloat16, levels, cluster,
            chunk)
    ring_round_enc.launches += 1
    if levels:
        ring_round_enc.requant_launches += 1
    return out


ring_round_enc.launches = 0
ring_round_enc.requant_launches = 0
