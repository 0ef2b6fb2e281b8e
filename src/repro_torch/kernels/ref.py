"""Plain PyTorch versions of the port's kernels (port of
:mod:`repro.kernels.ref`). They are the semantic ground truth: the CPU
route of every kernel wrapper, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card."""
from __future__ import annotations

import torch

from repro_torch.core import quant as quant_lib


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


def tp_combine_ref(partials: torch.Tensor, rs: torch.Tensor,
                   ag: torch.Tensor, site: int, *, n: int, receiver: int,
                   s: int, blk: int, pad: int,
                   wire_dtype: torch.dtype) -> torch.Tensor:
    """The tensor-parallel combine of one drop-masked decode site, as
    ``serve/tp.py`` computes it through the exchange: ``n · partials``
    in their dtype, laid out as the decode plan's f32 (d, B) leaf in ``s``
    server blocks of ``blk`` (``pad`` zeros at the end), each block's
    renormalised average over the site's ``rs`` rows in ``wire_dtype``,
    kept where the receiver's ``ag`` row delivers it and the receiver's
    own block elsewhere.

    partials: (n, B, 1, d); rs, ag: (n_sites, n, s) of any dtype.
    Returns the receiver's consensus (B, 1, d) f32, the values of the
    exchange route on the same inputs (the same ops on the same layouts,
    so bit for bit on the CPU).
    """
    _, B, _, d = partials.shape
    f32 = torch.float32
    y = torch.permute(partials[:, :, 0, :] * n, (0, 2, 1))    # (n, d, B)
    flat = y.reshape(n, d * B).to(f32)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    table = flat.reshape(n, s, blk)                 # the plan's f32 table
    send = table.to(wire_dtype)
    tilde = masked_avg_ref(send.transpose(0, 1).contiguous(),
                           rs[site].transpose(0, 1).contiguous())
    keep = ag[site][receiver].to(torch.bool)[:, None]
    out = torch.where(keep, tilde.to(f32), table[receiver])  # (s, blk)
    return out.reshape(s * blk)[:d * B].reshape(d, B).transpose(0, 1)[
        :, None, :]


def rwkv6_ref(r, k, v, w, u):
    """Sequential RWKV-6 recurrence from ``S_0 = 0``, in f32.

    r, k, w: (B, S, h, dk); v: (B, S, h, dv); u: (h, dk).
      o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
      S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    Returns (o: (B, S, h, dv) in ``r.dtype``, S_S: (B, h, dk, dv) f32).
    The final state is the one the JAX package's prefill folds over the
    sequence (``repro/models/rwkv6.py``): the same f32 update, step by
    step, so it equals that fold exactly.
    """
    B, S, h, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    state = torch.zeros((B, h, dk, dv), dtype=f32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B,h,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[..., :, None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def rwkv6_step_ref(r, k, v, w, u, state):
    """One decode step. r, k, w: (B, h, dk); v: (B, h, dv); state:
    (B, h, dk, dv). Returns (o: (B, h, dv) f32, new_state f32)."""
    f32 = torch.float32
    r, k, v, w, state = (x.to(f32) for x in (r, k, v, w, state))
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r,
                     state + u.to(f32)[..., :, None] * kv)
    return o, w[..., :, None] * state + kv


def rglru_ref(x, a, h0=None):
    """Sequential RG-LRU recurrence, in f32.

    x, a: (B, S, d), a in (0, 1); h0: (B, d) or None (zero).
      h_t = a_t ⊙ h_{t-1} + sqrt(max(1 - a_t², 0)) ⊙ x_t
    Returns (h: (B, S, d) in ``x.dtype``, h_last: (B, d) f32). The JAX
    package's ``rglru_ref`` returns h in f32; the model casts it to its
    dtype at once, which is the rounding done here.
    """
    B, S, d = x.shape
    f32 = torch.float32
    af = a.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(f32)
    h = (torch.zeros((B, d), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    hs = torch.empty((B, S, d), dtype=f32, device=x.device)
    for t in range(S):
        h = af[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def rglru_step_ref(x, a, state):
    """One decode step; x, a, state: (B, d). Returns the new h, f32."""
    f32 = torch.float32
    af = a.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(f32)
    return af * state.to(f32) + b


def scatter_layout(n: int, s: int):
    """Layout of s round-robin-owned blocks on an n-device axis: the
    blocks padded with dummy blocks to S = k·n (k = ceil(s/n)) and
    permuted to owner-major order, scatter row i·k + c holding block
    c·n + i. Returns (k, S, order, inv); ``order``/``inv`` are None when
    k == 1 (the identity)."""
    k = -(-s // n)
    S = k * n
    if k == 1:
        return k, S, None, None
    r = torch.arange(S)
    order = (r % k) * n + r // k          # scatter row -> block index
    inv = (r % n) * k + r // n            # block index -> scatter row
    return k, S, order, inv


def pad_mask_blocks(m: torch.Tensor, S: int) -> torch.Tensor:
    """Extend (…, s) mask columns with always-delivered dummy blocks."""
    s = m.shape[-1]
    if S == s:
        return m
    ones = torch.ones(tuple(m.shape[:-1]) + (S - s,), dtype=m.dtype,
                      device=m.device)
    return torch.cat([m, ones], dim=-1)


def masks_to_scatter(rs: torch.Tensor, ag: torch.Tensor, S: int, order):
    """(rs, ag) padded to S dummy-extended columns and permuted to the
    owner-major scatter order (``order=None``: the identity)."""
    rs_sc, ag_sc = pad_mask_blocks(rs, S), pad_mask_blocks(ag, S)
    if order is not None:
        order = order.to(rs.device)
        rs_sc, ag_sc = rs_sc[..., order], ag_sc[..., order]
    return rs_sc, ag_sc


def requant_rows(x: torch.Tensor, levels: int) -> torch.Tensor:
    """One int8-wire hop of a running f32 partial: every row (the last
    dim) encoded onto the grid {−levels, …, levels} with its own scale
    ``max|row| / levels``, rounded to nearest-even, and decoded — what
    the wire carries between two adds."""
    return quant_lib.dequantize(*quant_lib.quantize(
        x, levels, torch.int8, lead=x.dim() - 2))


def ring_global_sums(stack, rs_g, own, *, rs_dtype=torch.float32,
                     codec=None):
    """Single-device replay of the ring RS arithmetic (the JAX package's
    ``rps_ring.ring_global_sums``): ``stack`` (G, n, s, d) contributions,
    ``rs_g`` (G, n, s) masks, ``own`` (s,) block owners. Returns (G, s, d)
    masked sums accumulated in ring order in ``rs_dtype`` — block j's
    contributions added owner+1, …, owner+n−1, owner, each cast to
    ``rs_dtype`` and gated first — from a zero start as the reference's
    scan does. A quantised ``codec`` (``levels > 0``) re-encodes the
    running partial before every hop's add (:func:`requant_rows`, one
    scale per (g, block)); ``stack`` then holds the decoded sends."""
    G, n, s, d = stack.shape
    levels = codec.levels if codec is not None and codec.quantized else 0
    rs_w = rs_g.to(rs_dtype)
    cols = torch.arange(s, device=stack.device)
    own = own.to(stack.device)
    acc = torch.zeros((G, s, d), dtype=rs_dtype, device=stack.device)
    for t in range(1, n + 1):
        if levels:
            acc = requant_rows(acc, levels)
        idx = (own + t) % n
        acc = acc + stack[:, idx, cols, :].to(rs_dtype) \
            * rs_w[:, idx, cols][..., None]
    return acc


def decode_contrib(enc: torch.Tensor, scale, dtype: torch.dtype
                   ) -> torch.Tensor:
    """The contribution table an encoded source stands for: an int8
    payload times its (G, n, s) f32 row scales, rounded to the payload
    ``dtype`` (as the global path's fake-quant send is); a payload-dtype
    table (the EF send on a linear wire) as it is."""
    if enc.dtype == torch.int8:
        return quant_lib.dequantize(enc, scale[..., None]).to(dtype)
    return enc


def ring_round_ref(stack, rs_g, ag_g, div_g, *, mode: str,
                   rs_dtype=torch.float32, enc=None, scale=None,
                   levels: int = 0):
    """The drop-masked ring round over n stacked ranks, hop for hop as
    the JAX package's interpret ring (``rps_ring._ring_schedule_jax``)
    runs it on n devices; the plain version of the ring-round kernel and
    of its encoded variant.

    stack: (G, n, s, d) payload in block order (rank i's blocks in row
    i); rs_g, ag_g: (G, n, s) masks, nonzero = delivered; div_g: (G, s)
    f32 recovery divisor; mode: "model", "grad" or "grad_renorm";
    rs_dtype: the accumulation (wire) dtype. The encoded variant takes
    the contributions from ``enc`` instead of ``stack`` (which stays the
    all-gather fallback): an int8 (G, n, s, d) payload with its (G, n, s)
    f32 ``scale`` — decoded and rounded to the payload dtype, summed in
    f32 — or a payload-dtype table (the EF send on a linear wire).
    ``levels > 0`` re-encodes every chunk's partial onto the int8 grid
    before each hop's add (:func:`requant_rows`). Works in the collective
    path's scatter layout — blocks padded with dummy blocks to S = k·n
    and permuted owner-major, so rank i owns chunk i (rows i·k …
    i·k+k−1) — with the ranks on dim 1 and ``torch.roll`` over it as the
    ring's ``ppermute``:

      RS  rank i starts chunk i−1's partial with its gated contribution;
          n−1 hops each pass the partial (re-encoded when ``levels``) to
          the right neighbour, which adds its own (so chunk c sums ranks
          c+1, c+2, …, c, owner last, every add in ``rs_dtype``);
      div the owner divides by the chunk's divisor (cast to rs_dtype);
      AG  n−1 hops broadcast the averaged chunks in the payload dtype,
          each selected against the rank's own block (model,
          grad_renorm) or zero (grad) where ``ag`` dropped it.

    Returns (G, n, s, d) in ``stack.dtype``: row i is what rank i's
    ``ring_exchange_scatter_table`` returns, cropped back to block order.
    """
    G, n, s, d = stack.shape
    k, S, order, inv = scatter_layout(n, s)
    rs_sc, ag_sc = masks_to_scatter(rs_g, ag_g, S, order)
    div_sc = pad_mask_blocks(div_g.to(torch.float32), S)
    src = stack if enc is None else decode_contrib(enc, scale, stack.dtype)

    def to_scatter(x):
        if S != s:
            x = torch.nn.functional.pad(x, (0, 0, 0, S - s))
        return x if order is None else x[:, :, order.to(stack.device)]

    blocks = to_scatter(stack)
    src = blocks if enc is None else to_scatter(src)
    if order is not None:
        div_sc = div_sc[..., order.to(stack.device)]
    ch = src.reshape(G, n, n, k, d)             # (G, rank, chunk, k, d)
    rs_ch = rs_sc.to(rs_dtype).reshape(G, n, n, k, 1)
    ranks = torch.arange(n, device=stack.device)

    def at_chunk(x, offset):
        """Every rank's chunk (rank + offset) mod n: (G, n, k, …)."""
        idx = (ranks + offset) % n
        return x[:, ranks, idx]

    def contrib(offset):
        return at_chunk(ch, offset).to(rs_dtype) * at_chunk(rs_ch, offset)

    acc = contrib(-1)
    for t in range(n - 1):
        acc = torch.roll(acc, 1, dims=1)
        if levels:
            acc = requant_rows(acc, levels)
        acc = acc + contrib(-2 - t)
    my_div = div_sc.reshape(G, n, k)[..., None].to(rs_dtype)   # chunk i
    cur = (acc / my_div).to(stack.dtype)
    gathered = torch.zeros_like(blocks).reshape(G, n, n, k, d)
    gathered[:, ranks, ranks] = cur
    for t in range(n - 1):
        cur = torch.roll(cur, 1, dims=1)
        gathered[:, ranks, (ranks - 1 - t) % n] = cur
    gathered = gathered.reshape(G, n, S, d)
    keep = (ag_sc != 0)[..., None]
    if mode in ("model", "grad_renorm"):
        out = torch.where(keep, gathered, blocks)
    elif mode == "grad":
        out = torch.where(keep, gathered, torch.zeros_like(blocks))
    else:
        raise ValueError(mode)
    if inv is not None:
        out = out[:, :, inv.to(stack.device)]
    return out[:, :, :s]


def ring_rank_hop_ref(src, src_scale, rs_row, recv, recv_scale, div, *,
                      chunk: int, k: int, acc_dtype=torch.float32,
                      out_dtype=torch.float32, levels: int = 0,
                      last: bool = False):
    """One hop of rank i's share of the ring round, as the JAX package's
    interpret ring (``rps_ring._ring_schedule_jax``) takes it between two
    ``ppermute``s; the plain version of ``csrc/ring_rank.cu``'s hop.

    src: (S, W) contribution table — the payload, or the EF send / a
    corrupted offer on a linear wire, or int8 with its (S,) f32
    ``src_scale`` (decoded in f32, not rounded to the payload dtype);
    rs_row: (S,) this rank's RS mask row; recv: the received (k, W)
    partial in ``acc_dtype`` (or int8 with its (k,) f32 ``recv_scale``),
    None on the first hop; div: (S,) f32 divisor. Adds the gated
    contributions of chunk ``chunk`` (rows chunk·k … chunk·k+k−1) to the
    partial in ``acc_dtype``. The last hop (the owner's) divides and
    returns the (k, W) chunk in ``out_dtype``; a middle hop returns the
    partial, or with ``levels > 0`` its re-encoding ``(q, scale)`` — one
    f32 scale per row, round-to-nearest-even — as the wire carries it."""
    rows = slice(chunk * k, (chunk + 1) * k)
    if src.dtype == torch.int8:
        val = quant_lib.dequantize(src[rows], src_scale[rows, None])
    else:
        val = src[rows]
    contrib = val.to(acc_dtype) * rs_row[rows].to(acc_dtype)[:, None]
    if recv is None:
        acc = contrib
    else:
        got = recv if recv_scale is None else quant_lib.dequantize(
            recv, recv_scale[:, None])
        acc = got + contrib
    if last:
        return (acc / div[rows].to(acc_dtype)[:, None]).to(out_dtype)
    if levels:
        q, scale = quant_lib.quantize(acc, levels, torch.int8, lead=0)
        return q, scale[:, 0]
    return acc


def ring_rank_land_ref(out, cur, ag_row, blocks, *, chunk: int, k: int,
                       renorm: bool) -> None:
    """One landing of rank i's all-gather, in place: the averaged (k, W)
    chunk ``cur`` written to rows chunk·k … chunk·k+k−1 of the (S, W)
    ``out`` where ``ag_row`` delivered it, and the rank's own ``blocks``
    (``renorm``) or zero elsewhere; the plain version of
    ``csrc/ring_rank.cu``'s landing."""
    rows = slice(chunk * k, (chunk + 1) * k)
    keep = (ag_row[rows] != 0)[:, None]
    fallback = blocks[rows] if renorm else torch.zeros_like(cur)
    out[rows] = torch.where(keep, cur, fallback)
