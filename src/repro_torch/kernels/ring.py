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
same order and dtype, one IEEE division. On a meta tensor under the
dry-run's counter (``roofline/count.py``) each wrapper of this module
records its kernel's cost (``roofline/analysis.py::kernel_cost``) and
returns an empty result.

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

The collective path (one process per rank, :mod:`repro_torch.core.comm`)
runs one rank's share of the round: :func:`ring_exchange_scatter_table`
walks the ring hop for hop (:func:`ring_schedule`), each hop's add one
call of ``csrc/ring_rank.cu`` (:func:`ring_rank_hop`; a re-encoding hop
splits its rows over the card, :func:`rank_requant_plan`) and each
all-gather landing another (:func:`ring_rank_land`), between
:func:`repro_torch.core.comm.ring_shift` transfers; the ring's order is
the RPS axes flattened (:func:`logical_ring_ids`).
"""
from __future__ import annotations

import torch

from repro_torch.core import comm
from repro_torch.kernels import build
from repro_torch.kernels.ref import (ring_rank_hop_ref, ring_rank_land_ref,
                                     ring_round_ref)
from repro_torch.roofline.count import counting, record_kernel

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
# ring_rank.cu's re-encoding hop: columns a block keeps when a row is split
# (one 16-byte vector for each of its 256 threads)
RANK_MIN_COLS = 4096
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


def check_wire(rs_dtype) -> None:
    """Raise for a wire whose sums the ring kernels do not take: they
    instantiate f32 and bf16 accumulations (and the int8 wire's f32), so
    the float16 linear wire is refused here by name, on every device —
    the plain versions could sum it, the card could not. The masked
    average (the xla engine) takes float16."""
    if rs_dtype not in ACC_DTYPES:
        name = str(rs_dtype).removeprefix("torch.")
        raise ValueError(
            f"the {name} wire on the ring engine: ring.cu, ring_q.cu and "
            "ring_rank.cu sum in f32 or bf16 only; use engine='xla'")


def ring_round(stack, rs, ag, div, *, mode: str, rs_dtype=torch.float32):
    """One group's ring round, one launch for every bucket, block and
    rank.

    stack: (G, n, s, d) f32 / bf16 payload in block order; rs, ag:
    (G, n, s) masks of any dtype (nonzero = delivered); div: (G, s) f32
    divisor; ``rs_dtype``: the accumulation dtype (f32 or bf16). Returns
    (G, n, s, d) in ``stack.dtype``. ``ring_round.launches`` counts
    kernel launches (CPU calls run the plain version and do not count).
    """
    check_wire(rs_dtype)
    check_shapes(stack, rs, ag, div, mode)
    if stack.device.type == "cpu":
        return ring_round_ref(stack, rs, ag, div, mode=mode,
                              rs_dtype=rs_dtype)
    if counting(stack):
        record_kernel("ring_round", stack, rs, ag, div, mode=mode)
        return torch.empty_like(stack)
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


def rank_requant_plan(k: int, W: int, sms: int) -> tuple:
    """(blocks, cols) of ``csrc/ring_rank.cu``'s re-encoding hop for a
    chunk of ``k`` rows of ``W`` columns on a card of ``sms`` SMs: each
    row split into ``blocks`` blocks of ``cols`` columns (a multiple of
    16; no block empty), enough that the grid holds two blocks per SM
    where every block keeps at least RANK_MIN_COLS columns; one block a
    row when k alone fills the card or the row is narrow. One block a row
    makes the hop one launch; more make it two (the blocks' maxima, then
    the encode)."""
    want = -(-2 * sms // k)
    blocks = max(1, min(want, W // RANK_MIN_COLS))
    cols = -(-(-(-W // blocks)) // 16) * 16
    return -(-W // cols), cols


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
    check_wire(rs_dtype)
    check_shapes(stack, rs, ag, div, mode)
    check_enc(stack, enc, scale, rs_dtype, levels)
    if stack.device.type == "cpu":
        return ring_round_ref(stack, rs, ag, div, mode=mode,
                              rs_dtype=rs_dtype, enc=enc, scale=scale,
                              levels=levels)
    if counting(stack):
        record_kernel("ring_round_enc", stack, enc, scale, rs, ag, div,
                      mode=mode, levels=levels)
        return torch.empty_like(stack)
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


# ---------------------------------------------------------------------------
# One rank's share of the round, between real transfers (csrc/ring_rank.cu)
# ---------------------------------------------------------------------------

def _check_rank_cuda(name: str, ref: torch.Tensor, *ts) -> None:
    for t in ts:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def ring_rank_hop(src, src_scale, rs_row, recv, recv_scale, div, *,
                  chunk: int, k: int, acc_dtype=torch.float32,
                  out_dtype=torch.float32, levels: int = 0,
                  last: bool = False):
    """One hop of this rank's ring round: the gated contributions of
    chunk ``chunk`` of the (S, W) table ``src`` (int8 with its (S,) f32
    ``src_scale``, or a payload-dtype table) added to the received (k, W)
    partial ``recv`` (None on the first hop; int8 with its (k,)
    ``recv_scale`` on the int8 wire) in ``acc_dtype``. Returns the last
    hop's chunk divided by ``div`` in ``out_dtype``, a middle hop's
    partial, or with ``levels > 0`` its re-encoding ``(q, scale)``.

    On a CUDA tensor it launches ``csrc/ring_rank.cu``'s hop (counted
    once a call in ``ring_rank_hop.launches``) or raises: one CUDA launch,
    or two for a re-encoding hop whose rows :func:`rank_requant_plan`
    splits over several blocks (the blocks' maxima, then the encode). On
    a CPU tensor it computes the plain version :func:`repro_torch.kernels.
    ref.ring_rank_hop_ref`."""
    if src.device.type == "cpu":
        return ring_rank_hop_ref(src, src_scale, rs_row, recv, recv_scale,
                                 div, chunk=chunk, k=k, acc_dtype=acc_dtype,
                                 out_dtype=out_dtype, levels=levels,
                                 last=last)
    if counting(src):
        record_kernel("ring_rank_hop", src, src_scale, rs_row, recv,
                      recv_scale, div, chunk=chunk, k=k, acc_dtype=acc_dtype,
                      out_dtype=out_dtype, levels=levels, last=last)
        W = src.shape[1]
        if last:
            return src.new_empty((k, W), dtype=out_dtype)
        if levels:
            return (src.new_empty((k, W), dtype=torch.int8),
                    src.new_empty((k,), dtype=torch.float32))
        return src.new_empty((k, W), dtype=acc_dtype)
    if src.device.type != "cuda":
        raise ValueError(f"ring_rank_hop: no kernel for {src.device}")
    _check_rank_cuda("ring_rank_hop", src, src, src_scale, rs_row, recv,
                     recv_scale, div)
    W = src.shape[1]
    out_scale = part_max = None
    blocks = cols = 0
    if last:
        out = torch.empty((k, W), dtype=out_dtype, device=src.device)
    elif levels:
        out = torch.empty((k, W), dtype=torch.int8, device=src.device)
        out_scale = torch.empty((k,), dtype=torch.float32, device=src.device)
        sms = torch.cuda.get_device_properties(
            src.device).multi_processor_count
        blocks, cols = rank_requant_plan(k, W, sms)
        if blocks > 1:      # each block's max|acc| between the two launches
            part_max = torch.empty((k, blocks), dtype=torch.float32,
                                   device=src.device)
    else:
        out = torch.empty((k, W), dtype=acc_dtype, device=src.device)
    build.load_kernels().ring_rank_hop(
        src, src_scale, rs_row, recv, recv_scale, div, out, out_scale,
        part_max, chunk, acc_dtype == torch.bfloat16, levels, last, blocks,
        cols)
    ring_rank_hop.launches += 1
    return (out, out_scale) if out_scale is not None else out


ring_rank_hop.launches = 0


def ring_rank_land(out, cur, ag_row, blocks, *, chunk: int, k: int,
                   renorm: bool) -> None:
    """One landing of this rank's all-gather, in place: the (k, W) chunk
    ``cur`` into rows chunk·k … of the (S, W) ``out`` where ``ag_row``
    delivered it, this rank's ``blocks`` (``renorm``) or zero elsewhere.
    A CUDA tensor launches ``csrc/ring_rank.cu``'s landing (counted in
    ``ring_rank_land.launches``) or raises; a CPU tensor takes the plain
    version."""
    if out.device.type == "cpu":
        ring_rank_land_ref(out, cur, ag_row, blocks, chunk=chunk, k=k,
                           renorm=renorm)
        return
    if counting(out):
        record_kernel("ring_rank_land", out, cur, ag_row, blocks,
                      chunk=chunk, k=k, renorm=renorm)
        return
    if out.device.type != "cuda":
        raise ValueError(f"ring_rank_land: no kernel for {out.device}")
    _check_rank_cuda("ring_rank_land", out, out, cur, ag_row, blocks)
    build.load_kernels().ring_rank_land(cur, ag_row, blocks, out, chunk,
                                        renorm)
    ring_rank_land.launches += 1


ring_rank_land.launches = 0


def logical_ring_ids(names, mesh, rank=None) -> tuple:
    """(pos, left, right) of a rank on the ring over the mesh axes
    ``names`` flattened major to minor: its ring position and the global
    ranks (the reference's logical device ids) of its neighbours; the
    other axes keep the rank's coordinates."""
    names = (names,) if isinstance(names, str) else tuple(names)
    order = mesh.group_ranks(names, rank)
    pos = mesh.axis_index(names, rank)
    n = len(order)
    return pos, order[(pos - 1) % n], order[(pos + 1) % n]


def ring_schedule(blocks, rs_row, ag_row, div, *, group, order, n: int,
                  i: int, k: int, mode: str, rs_dtype=torch.float32,
                  src=None, src_scale=None, levels: int = 0):
    """The ring round on rank i of n, hop for hop as the reference's
    interpret ring runs it (``rps_ring._ring_schedule_jax``), each hop's
    arithmetic one :func:`ring_rank_hop` and each landing one
    :func:`ring_rank_land` between :func:`repro_torch.core.comm.ring_shift`
    transfers:

      RS  hop t = 0 … n−1 adds this rank's gated contribution to chunk
          (i − 1 − t) mod n's partial (started here at t = 0), and sends
          it right; on the int8 wire (``levels > 0``) the partial travels
          re-encoded, int8 with a scale per row. The last hop is the
          owner's (chunk i): it divides by ``div`` and casts to the
          payload dtype;
      AG  the averaged chunk lands here and travels n−1 hops right, each
          landing selected against this rank's ``blocks`` (or zero).

    blocks: (S, W) payload in the scatter layout (the AG fallback);
    src: the contribution table (default ``blocks``; int8 with (S,)
    ``src_scale``); rs_row, ag_row: this rank's (S,) mask rows; div:
    (S,) f32 divisor. Returns (S, W) in ``blocks.dtype``."""
    src = blocks if src is None else src
    part = scale = mine = None
    for t in range(n):
        last = t == n - 1
        if t:
            sent = [part] if scale is None else [part, scale]
            got = comm.ring_shift(sent, group, order)
            part, scale = got[0], (got[1] if len(got) > 1 else None)
        res = ring_rank_hop(src, src_scale, rs_row, part, scale, div,
                            chunk=(i - 1 - t) % n, k=k, acc_dtype=rs_dtype,
                            out_dtype=blocks.dtype, levels=levels,
                            last=last)
        if last:
            mine = res
        elif levels:
            part, scale = res
        else:
            part = res
    renorm = mode != "grad"
    out = torch.empty_like(blocks)
    ring_rank_land(out, mine, ag_row, blocks, chunk=i, k=k, renorm=renorm)
    cur = mine
    for t in range(n - 1):
        cur = comm.ring_shift([cur], group, order)[0]
        ring_rank_land(out, cur, ag_row, blocks, chunk=(i - 1 - t) % n, k=k,
                       renorm=renorm)
    return out


def ring_exchange_scatter_table(blocks, rs_sc, ag_sc, *, group, order,
                                n: int, i: int, k: int, mode: str,
                                div, rs_dtype=torch.float32, codec=None,
                                enc=None, send=None):
    """The ring engine's round of this rank's scatter-ordered (S, blk[, m])
    table (the reference's ``ring_exchange_scatter_table`` off the TPU,
    its interpret ring): ``rs_sc`` / ``ag_sc`` the (n, S) scatter-ordered
    masks, ``div`` the (S,) f32 recovery divisor. A quantised ``codec`` takes the contributions from ``enc``,
    the (q, scale) encode of this rank's table, and re-encodes the
    partial on every hop; on a linear wire ``send`` (the EF intent or a
    corrupted offer) replaces ``blocks`` as the contributions, which stay
    the all-gather fallback. Returns the table's shape and dtype."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}, want one of {MODES}")
    check_wire(rs_dtype)
    shape = tuple(blocks.shape)
    S = shape[0]
    tbl = blocks.reshape(S, -1).contiguous()
    src = src_scale = None
    levels = 0
    if codec is not None and codec.quantized:
        q, sc = enc
        src = q.reshape(S, -1).contiguous()
        src_scale = sc.reshape(S, -1)[:, 0].to(torch.float32).contiguous()
        levels = codec.levels
    elif send is not None:
        src = send.reshape(S, -1).to(blocks.dtype).contiguous()
    out = ring_schedule(tbl, rs_sc[i].contiguous(), ag_sc[i].contiguous(),
                        div.to(torch.float32).contiguous(), group=group,
                        order=order, n=n, i=i, k=k, mode=mode,
                        rs_dtype=rs_dtype, src=src, src_scale=src_scale,
                        levels=levels)
    return out.reshape(shape)
