"""RPS exchange on one device (port of :mod:`repro.core.rps`).

The paper's drop-tolerant reduce-scatter / all-gather round (Algorithm 1)
on *stacked* worker tensors (leading dim n), with boolean ``(n, s)`` drop
masks whose owner entries (block j is owned by worker ``j % n``) are
always delivered:

  - RS-drop: worker i's block-j contribution is left out of the owner's
    sum when ``rs[i, j]`` is False; the owner renormalises by the
    received count (model / grad_renorm modes) or divides by n (the
    fragile "grad" baseline);
  - AG-drop: receiver i keeps its own pre-average block j when
    ``ag[i, j]`` is False (model mode), or applies no update (grad modes).

:func:`rps_exchange_global` runs the round on stacked worker trees, one
batched call per group of equal-width buckets, under two engines:

  - ``"xla"``: the renormalised average on the hand-written masked-average
    kernel (``kernels/masked_avg.py``), an f32 einsum for the other
    divisors;
  - ``"ring"``: the ring engine's arithmetic, contributions summed in ring
    order in the wire dtype, on the hand-written drop-masked ring-round
    kernel (``kernels/ring.py``).

The int8 wire's ring engine runs the kernel's encoded variant (int8
contributions decoded in the kernel, the partial re-encoded on every hop),
and the error-feedback recovery sends through the same variant, as does a
corrupted offer (Byzantine senders transform what they send, before the
codec; the honest stack stays the all-gather fallback). The robust
recoveries (median, trimmed, clip) aggregate the pre-reduce table on the
xla engine (:mod:`repro_torch.core.robust`). On a CUDA stack every kernel
launches or raises; there is no fallback to the plain versions. Ported:
the global path with the f32 / bf16 / int8 wires, every recovery, any
plan, shared or per-bucket masks, corruption, and the async schedule's
lateness masks. With a tap collector installed
(:mod:`repro_torch.telemetry.taps`) the exchange taps the reference's
counters: the step's delivery, lateness and corruption bundles, the
per-bucket delivered counts, and per group the EF residual's squared
norm and the divisor table. The collective paths are still to port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import robust as robust_lib
from repro_torch.core import wire as wire_lib
from repro_torch.kernels import masked_avg as masked_avg_lib
from repro_torch.kernels import ops
# the reference keeps the scatter layout here (rps.py:167-205); the port
# keeps it with its only user, the plain ring round
from repro_torch.kernels.ref import masks_to_scatter as _masks_to_scatter
from repro_torch.kernels.ref import pad_mask_blocks as _pad_mask_blocks
from repro_torch.kernels.ref import scatter_layout as _scatter_layout
from repro_torch.telemetry import taps


def owners(n: int, s: Optional[int] = None, *,
           device="cpu") -> torch.Tensor:
    """Block → owner-worker map: block j is averaged by worker j % n."""
    s = n if s is None else int(s)
    return torch.arange(s, device=device) % n


def owner_mask(n: int, s: Optional[int] = None, *,
               device="cpu") -> torch.Tensor:
    """Boolean (n, s), True at (owner(j), j) — the entries every drop
    mask forces True (the identity when s == n)."""
    s = n if s is None else int(s)
    m = torch.zeros((n, s), dtype=torch.bool, device=device)
    m[owners(n, s, device=device), torch.arange(s, device=device)] = True
    return m


def sample_masks(gen: torch.Generator, n: int, p: float,
                 s: Optional[int] = None,
                 n_buckets: Optional[int] = None):
    """(rs, ag) boolean (n, s) i.i.d. Bernoulli(1−p) delivery masks with
    owner entries forced True, drawn from ``gen`` on its device;
    ``n_buckets`` gives independent ``(n_buckets, n, s)`` draws."""
    s = n if s is None else int(s)
    shape = (n, s) if n_buckets is None else (int(n_buckets), n, s)
    rs = torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p
    ag = torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p
    own = owner_mask(n, s, device=gen.device)
    return rs | own, ag | own


def _divisor(rec: wire_lib.Recovery, mode: str, rs: torch.Tensor,
             n: int) -> torch.Tensor:
    """The (…, S) f32 per-block divisor the recovery prescribes, from
    (…, n, S) RS masks: the received count (renorm in model /
    grad_renorm modes), n (the naive "grad" mode), or the expected count
    n(1−p) (``scale``, every mode)."""
    shape = tuple(rs.shape[:-2]) + tuple(rs.shape[-1:])
    if rec.kind == "scale":
        return torch.full(shape, rec.expected_count(n), dtype=torch.float32,
                          device=rs.device)
    if mode in ("model", "grad_renorm"):
        return rs.to(torch.float32).sum(-2).clamp_min(1.0)
    if mode == "grad":
        return torch.full(shape, float(n), dtype=torch.float32,
                          device=rs.device)
    raise ValueError(mode)


def _global_groups(plan: plan_lib.ExchangePlan) -> dict:
    """Bucket indices grouped by (blk, m, dtype): each group is one
    batched call in the global path."""
    groups: dict = {}
    for b, bk in enumerate(plan.buckets):
        groups.setdefault((bk.blk, bk.m, bk.dtype), []).append(b)
    return groups


def _bucket_masks(rs: torch.Tensor, ag: torch.Tensor, b: int):
    """Bucket b's (n, s) mask pair: per-bucket (n_buckets, n, s) masks
    index their own draw, (n, s) masks are shared by every bucket."""
    if rs.dim() == 3:
        return rs[b], ag[b]
    return rs, ag


def _resolve_masks(gen, n: int, p: float, plan: plan_lib.ExchangePlan,
                   masks):
    """The given masks (checked against the plan), or the draw the plan
    prescribes: per-bucket for packetised plans, one shared draw
    otherwise."""
    if masks is not None:
        rs, ag = masks
        if rs.dim() == 3 and rs.shape[0] != plan.n_buckets:
            raise ValueError(f"per-bucket masks carry {rs.shape[0]} "
                             f"buckets, plan has {plan.n_buckets}")
        return rs, ag
    if gen is None:
        raise ValueError("give masks= or a generator to draw them")
    return sample_masks(gen, n, p, plan.s,
                        n_buckets=plan.n_buckets
                        if plan.per_bucket_masks else None)


def _group_stack(tables, idxs, n: int, s: int, d: int) -> torch.Tensor:
    """A group's (G, n, s, d) stack of bucket tables: a view for one
    bucket, a copy for several."""
    if len(idxs) == 1:
        return tables[idxs[0]].reshape(1, n, s, d)
    return torch.stack([tables[j].reshape(n, s, d) for j in idxs])


def _group_noise(wire_noise, g_idx: int, shape: tuple) -> dict:
    """The stochastic-rounding source of group ``g_idx`` as ``encode``
    keywords: a hook's uniforms or a generator."""
    if isinstance(wire_noise, torch.Generator):
        return {"gen": wire_noise}
    return {"uniforms": wire_noise(g_idx, shape)}


def _resolve_corruption(corruption, corrupt_masks, gen, n: int, s: int,
                        n_buckets=None):
    """The round's corruption masks: the given ``corrupt_masks`` (shared
    ``(n, s)`` or per-bucket), else the process's own draw from ``gen``;
    None without a process."""
    if corruption is None:
        if corrupt_masks is not None:
            raise ValueError("corrupt_masks without a corruption process")
        return None
    if corrupt_masks is None:
        if gen is None:
            raise ValueError("give corrupt_masks= or a generator to draw "
                             "them")
        return corruption.sample(gen, n, s, n_buckets=n_buckets)
    if corrupt_masks.dim() == 3 and n_buckets is not None \
            and corrupt_masks.shape[0] != n_buckets:
        raise ValueError(f"corrupt_masks carry {corrupt_masks.shape[0]} "
                         f"buckets, plan has {n_buckets}")
    return corrupt_masks


def _check_late(late, rs: torch.Tensor, ag: torch.Tensor) -> None:
    """The async lateness masks ``{"rs": …, "ag": …}`` match the drop
    masks' shapes. They move no value: the masks are already
    deadline-arbitrated."""
    if not isinstance(late, dict) or set(late) != {"rs", "ag"}:
        raise ValueError("late= takes {'rs': mask, 'ag': mask}")
    for leg, m in (("rs", rs), ("ag", ag)):
        if tuple(late[leg].shape) != tuple(m.shape):
            raise ValueError(f"late[{leg!r}] shape "
                             f"{tuple(late[leg].shape)} != the masks' "
                             f"{tuple(m.shape)}")


def _group_bits(corruption, corrupt_bits, g_idx: int, shape: tuple) -> dict:
    """The bitflip positions of group ``g_idx`` as ``apply`` keywords: a
    hook's bits or a generator (nothing for the deterministic kinds)."""
    if corruption.kind != "bitflip":
        return {}
    if corrupt_bits is None or isinstance(corrupt_bits, torch.Generator):
        return {"gen": corrupt_bits}
    return {"bits": corrupt_bits(g_idx, shape)}


def _tap_step(rs, ag, late, cmasks, n: int, plan, codec, rec, mode: str,
              engine: str) -> None:
    """The reference's step-level taps: the whole draw's per-link bundle
    (summed over the bucket dim of per-bucket masks), the lateness and
    corruption bundles, the per-bucket x per-link delivered RS counts,
    and the plan and exchange annotations (owner entries excluded)."""
    from repro_torch.telemetry import counters
    for k, v in counters.mask_step_stats(rs, ag).items():
        taps.emit(k, v)
    if late is not None:
        for k, v in counters.staleness_stats(late["rs"], late["ag"]).items():
            taps.emit(k, v)
    if cmasks is not None:
        for k, v in counters.corruption_stats(cmasks, rs).items():
            taps.emit(k, v)
    if rs.dim() == 3:
        non_own = ~owner_mask(n, plan.s, device=rs.device)
        taps.emit("rs_bucket_link_delivered",
                  (rs.to(torch.bool) & non_own).sum(-1, dtype=torch.int32))
    taps.annotate("plan", {"n_buckets": plan.n_buckets, "s": plan.s,
                           "rs_leg_bytes": int(plan.rs_leg_bytes(codec))})
    taps.annotate("exchange", {"n": n, "s": plan.s, "mode": mode,
                               "engine": engine, "codec": codec.name,
                               "recovery": rec.kind})


def rps_exchange_global(tree, gen: Optional[torch.Generator], p: float,
                        n: int, *, mode: str = "model", masks=None,
                        s: Optional[int] = None,
                        plan: Optional[plan_lib.ExchangePlan] = None,
                        engine: str = "xla",
                        rs_dtype=torch.float32, wire=None,
                        recovery=None, ef_state=None, wire_noise=None,
                        late=None, corruption=None, corrupt_masks=None,
                        corrupt_bits=None):
    """Global-view exchange of a stacked tree (every leaf has the worker
    dim n first).

    ``masks``: a precomputed ``(rs, ag)`` pair, shared ``(n, s)`` or
    per-bucket ``(n_buckets, n, s)``; otherwise drawn from ``gen`` as the
    plan prescribes. ``plan``: the layout over the per-worker tree (n
    stripped); ``None`` builds the per-leaf plan. ``wire``/``recovery``
    default to the plan's fields.

    Each group of equal-width buckets is one batched call:

    - ``engine="xla"`` (or "auto"): a codec narrower than the payload
      rounds each contribution to the wire grid before the f32-accumulated
      sum. The renorm average runs through the masked-average kernel's
      wrapper and comes back in the wire dtype, as the JAX package's
      Pallas route returns it; the other divisors take an f32 einsum.
    - ``engine="ring"``: the ring engine's arithmetic — contributions
      added in ring order (owner+1, …, owner) in the codec's accumulation
      dtype, divided by the recovery divisor, AG-selected — through
      :func:`repro_torch.kernels.ops.ring_round`.

    The int8 wire encodes each contribution with one scale per (group,
    worker, block), rounding stochastically: ``wire_noise`` is a
    ``torch.Generator`` or a hook ``(g_idx, shape) -> uniforms`` (the
    parity tests hand in the reference's), defaulting to ``gen``. The xla
    engine sums the decoded contributions; the ring engine hands the int8
    table and its scales to the encoded ring round, which re-encodes the
    running partial on every hop. ``recovery="ef"`` takes the stacked
    residual ``ef_state`` (``wire.init_ef_state(tree)`` to start), sends
    ``intent = x + e`` — the int8 encode then deterministic — and returns
    ``(out_tree, new_ef_state)``, the residual ``intent − send`` where the
    block was delivered and ``e`` where it was dropped.

    ``corruption`` (a :class:`repro_torch.channels.Corruption`)
    transforms each corrupted sender's offer before the codec, at
    ``corrupt_masks`` (shared ``(n, s)`` or per-bucket; drawn from ``gen``
    when not given); the bitflip kind's bit positions come from
    ``corrupt_bits``, a generator or a hook ``(g_idx, shape) -> bits``
    (default ``gen``). The ring engine sums the corrupted offer through
    the kernel's encoded variant, so the input stack stays the fallback.
    A robust ``recovery`` (median, trimmed, clip) aggregates the
    ``(G, s, n, d)`` table of each group's send over the RS masks, on the
    xla engine and in the renormalising modes. ``late`` (the async
    schedule's ``{"rs", "ag"}`` lateness masks) is shape-checked and moves
    no value.

    The AG fallback is the input stack (model / grad_renorm) or zero
    (grad).
    """
    if plan is None:
        per_worker = tree_lib.map(
            lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
            tree)
        if masks is not None:
            s = masks[0].shape[-1]
        plan = plan_lib.per_leaf_plan(per_worker, n, s)
    wire = plan.wire if wire is None else wire
    recovery = plan.recovery if recovery is None else recovery
    codec = wire_lib.resolve_codec(wire, rs_dtype)
    rec = wire_lib.make_recovery(recovery, p=p)
    use_ef = rec.needs_state
    if use_ef and ef_state is None:
        raise ValueError("recovery='ef' needs ef_state= (the stacked "
                         "residual; wire.init_ef_state(tree) to start)")
    if use_ef and corruption is not None:
        raise ValueError(
            "corruption with recovery='ef' is unsupported: the EF "
            "residual telescopes an *honest* sender's codec error — an "
            "adversarial wire breaks the feedback loop; use a robust "
            "recovery (median/trimmed/clip)")
    rs, ag = _resolve_masks(gen, n, p, plan, masks)
    cmasks = _resolve_corruption(
        corruption, corrupt_masks, gen, n, plan.s,
        n_buckets=plan.n_buckets if plan.per_bucket_masks else None)
    if late is not None:
        _check_late(late, rs, ag)
    if taps.active() is not None:
        _tap_step(rs, ag, late, cmasks, n, plan, codec, rec, mode, engine)
    if mode not in ("model", "grad", "grad_renorm"):
        raise ValueError(mode)
    if engine in (None, "auto"):
        engine = "xla"
    elif engine not in ("xla", "ring"):
        raise ValueError(f"engine={engine!r}")
    if rec.needs_table:
        if mode == "grad":
            raise ValueError(
                f"recovery={rec.kind!r} needs the renormalising modes "
                "(model/grad_renorm); the naive 'grad' mode has no "
                "per-contribution table semantics")
        if engine == "ring":
            raise ValueError(
                f"recovery={rec.kind!r} needs the pre-reduce per-worker "
                "table; the ring engine reduces on the hops and never "
                "materialises it — use engine='xla' (the 'auto' default "
                "falls back to xla automatically)")
    corrupt_bits = gen if corrupt_bits is None else corrupt_bits
    if codec.quantized and not use_ef:
        wire_noise = gen if wire_noise is None else wire_noise
        if wire_noise is None:
            raise ValueError("the int8 wire rounds stochastically: give "
                             "wire_noise= (a generator, or a hook "
                             "(g_idx, shape) -> uniforms) or gen")
    s = plan.s
    renorm = mode in ("model", "grad_renorm")
    # the masked-average kernel renormalises by the received count
    # internally; the scale divisor takes the einsum path, the robust
    # kinds their table aggregate
    use_kernel = engine == "xla" and renorm and rec.kind != "scale" \
        and not rec.needs_table

    tables = plan.gather(tree, lead=1)               # each (n, s, blk, m)
    ef_tables = plan.gather(ef_state, lead=1) if use_ef else None
    outs: list = [None] * len(tables)
    ef_outs: list = [None] * len(tables)
    for g_idx, ((blk, m, _dt), idxs) in \
            enumerate(_global_groups(plan).items()):
        G, d = len(idxs), blk * m
        stack = _group_stack(tables, idxs, n, s, d)
        pairs = [_bucket_masks(rs, ag, j) for j in idxs]
        rs_g = torch.stack([pair[0] for pair in pairs])         # (G, n, s)
        ag_g = torch.stack([pair[1] for pair in pairs])
        # what the senders offer: the stack, or its corrupted copy (the
        # stack itself stays every worker's honest local copy)
        offer = stack
        if cmasks is not None:
            cm_g = torch.stack([cmasks[j] for j in idxs]) \
                if cmasks.dim() == 3 else cmasks.expand(G, n, s)
            offer = corruption.apply(
                stack, cm_g[..., None],
                **_group_bits(corruption, corrupt_bits, g_idx,
                              tuple(stack.shape)))
            del cm_g
        # the contributions: ``send`` decoded in the payload dtype (the
        # xla engine's), ``enc`` / ``scale`` encoded (the ring engine's)
        send = enc = scale = None
        if use_ef:
            ef_stack = _group_stack(ef_tables, idxs, n, s, d).to(stack.dtype)
            intent = stack + ef_stack
            if codec.quantized:     # deterministic: the feedback unbiases
                enc, scale = codec.encode(intent, lead=2)
                send = codec.decode(enc, scale).to(stack.dtype)
            else:
                send = enc = codec.fake_quant(intent)
            # intent − send, in place unless the f32 codec's send is the
            # intent itself; a dropped block's residual stays outstanding
            err = intent - send if send is intent else intent.sub_(send)
            resid = torch.where(rs_g[..., None] != 0, err, ef_stack)
            if taps.active() is not None:
                taps.emit("ef_resid_sq", torch.linalg.vector_norm(
                    ef_stack, dtype=torch.float32).square())
            del intent, err, ef_stack
            for pos, j in enumerate(idxs):
                ef_outs[j] = resid[pos].reshape(n, s, blk, m)
        elif codec.quantized:
            enc, scale = codec.encode(
                offer, lead=2,
                **_group_noise(wire_noise, g_idx, tuple(stack.shape)))
        div_g = None
        if taps.active() is not None:
            div_g = _divisor(rec, mode, rs_g, n)                 # (G, s)
            taps.emit("divisor", div_g)
        if rec.needs_table:
            if send is None:
                send = codec.to_wire(offer) if enc is None \
                    else codec.decode(enc, scale).to(stack.dtype)
            del offer, enc, scale
            # (G, s, n, d) views of the send and (G, s, n) masks: the
            # aggregate copies one column chunk at a time
            tilde = robust_lib.robust_aggregate(
                send.transpose(1, 2), rs_g.transpose(1, 2) != 0, rec,
                dtype=torch.float32)
            del send
            gathered = tilde.to(stack.dtype)[:, None]
            out = torch.where(ag_g.to(torch.bool)[..., None], gathered,
                              stack)
        elif engine == "ring":
            del send
            if enc is None and offer is not stack:
                # a corrupted linear offer, in the stack's dtype
                enc = offer.contiguous()
            del offer
            if div_g is None:
                div_g = _divisor(rec, mode, rs_g, n)             # (G, s)
            out = ops.ring_round(
                stack.contiguous(), rs_g, ag_g, div_g, mode=mode,
                rs_dtype=codec.accum_dtype, enc=enc,
                scale=None if scale is None else scale[..., 0],
                levels=codec.levels)
        else:
            if send is None:
                send = codec.to_wire(offer) if enc is None \
                    else codec.decode(enc, scale).to(stack.dtype)
            del offer
            if use_kernel:
                # (G·s, n, d) per-block stacks and the raw mask: the
                # kernel casts the mask itself
                tilde = masked_avg_lib.masked_avg_grid(
                    send.transpose(1, 2).reshape(G * s, n, d).contiguous(),
                    rs_g.transpose(1, 2).reshape(G * s, n).contiguous()
                ).reshape(G, s, d)
            else:
                sums = torch.einsum("gij,gijd->gjd", rs_g.to(torch.float32),
                                    send.to(torch.float32))
                tilde = sums / _divisor(rec, mode, rs_g, n)[..., None]
            gathered = tilde.to(stack.dtype)[:, None]    # the AG payload
            keep = ag_g.to(torch.bool)[..., None]
            if renorm:
                out = torch.where(keep, gathered, stack)  # own block
            else:
                out = gathered * keep.to(stack.dtype)     # no update
        for pos, j in enumerate(idxs):
            outs[j] = out[pos].reshape(n, s, blk, m)
    if use_ef:
        return plan.scatter(outs, lead=1), plan.scatter(ef_outs, lead=1)
    return plan.scatter(outs, lead=1)
