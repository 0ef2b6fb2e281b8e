"""Static layout of one RPS round (port of :mod:`repro.core.plan`).

An :class:`ExchangePlan` assigns every leaf of a parameter tree (a tensor,
or a dict / list / tuple of them, flattened in ``jax.tree`` order by
:mod:`repro_torch.tree`) to one bucket, and lays each bucket out as an
``(s, blk, m)`` block table — s server blocks of ``blk`` rows — with the
padding computed once at setup:

- :func:`per_leaf_plan`: one bucket per leaf, one shared mask draw (the
  simulator's and the trainer's default);
- :func:`single_bucket_plan`: every leaf ravelled into one bucket;
- :func:`make_plan` with ``bucket_bytes`` or ``n_buckets``: leaves
  coalesced in tree order into fixed-byte or size-balanced buckets, each
  bucket its own wire packet (per-bucket masks);
- :func:`decode_plan`: the tensor-parallel serving path's one
  ``(d_model, batch)`` leaf.

``schedule="async"`` (with ``compute_ms``) ships the buckets in reverse
plan order as the backward pass makes their gradients ready: the plan
carries each bucket's readiness time (:func:`bucket_ready_ms`, or measured
times through :meth:`ExchangePlan.with_ready_ms`) and
:meth:`ExchangePlan.slack_ms` turns a deadline into per-bucket budgets.
Model-dim (tensor-parallel) buckets are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import wire as wire_lib


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One exchange unit laid out as an (s, blk, m) block table. Fields
    mirror the JAX package's ``Bucket`` (dtypes by numpy-style name)."""
    leaf_ids: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]     # per-member per-worker shapes
    dtypes: Tuple[str, ...]                 # per-member dtypes
    sizes: Tuple[int, ...]                  # per-member free-element counts
    model_dim: Optional[int]
    m: int                                  # model-dim width (1 = flat)
    free: int                               # Σ sizes (rows before padding)
    blk: int                                # block width: ceil(free / s)
    pad: int                                # s·blk − free padding rows
    dtype: str                              # payload dtype (promoted)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static layout of one RPS round over an n-worker axis with s server
    blocks, built once at setup. ``per_bucket_masks``: every bucket draws
    its own ``(n, s)`` mask pair (the fixed-byte plans), else one shared
    draw per round."""
    n: int
    s: int
    buckets: Tuple[Bucket, ...]
    n_leaves: int
    per_bucket_masks: bool
    treedef: Any = dataclasses.field(hash=False, compare=False)
    engine: str = "xla"
    wire: str = "f32"
    recovery: str = "renorm"
    # "sync": every bucket ships at the iteration barrier; "async": in
    # reverse plan order as its gradients become ready
    schedule: str = "sync"
    # per-bucket readiness times (ms into the backward pass); set iff
    # schedule == "async"
    ready_ms: Optional[Tuple[float, ...]] = None

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def packets_per_block(self) -> int:
        return self.n_buckets if self.per_bucket_masks else 1

    @property
    def model_packets(self) -> int:
        return self.s * self.packets_per_block

    def payload_elems(self) -> int:
        return sum(self.s * b.blk * b.m for b in self.buckets)

    @property
    def ship_order(self) -> Tuple[int, ...]:
        """Bucket dispatch order: plan order under sync, reversed under
        async (the tree is layer-ordered and the backward pass finishes
        the last layers first)."""
        if self.schedule == "async":
            return tuple(range(self.n_buckets - 1, -1, -1))
        return tuple(range(self.n_buckets))

    def with_ready_ms(self, ready_ms: Sequence[float]) -> "ExchangePlan":
        """The same async plan with measured readiness times in place of
        the cost model's (``compute_ms="auto"``)."""
        if self.schedule != "async":
            raise ValueError("ready_ms only applies to schedule='async'")
        ready = tuple(float(r) for r in ready_ms)
        if len(ready) != self.n_buckets:
            raise ValueError(f"got {len(ready)} readiness times for "
                             f"{self.n_buckets} buckets")
        if any(r < 0 for r in ready):
            raise ValueError(f"negative readiness time in {ready}")
        return dataclasses.replace(self, ready_ms=ready)

    def slack_ms(self, deadline_ms: float) -> np.ndarray:
        """Per-bucket deadline budget under async, ``max(deadline −
        ready, 0)`` in plan order (``(n_buckets,)`` f64)."""
        if self.ready_ms is None:
            raise ValueError("slack_ms needs an async plan with ready_ms "
                             "(build with schedule='async')")
        return np.maximum(float(deadline_ms)
                          - np.asarray(self.ready_ms, np.float64), 0.0)

    def rs_leg_bytes(self, wire=None) -> int:
        """Bytes one device moves on the RS leg per round (every bucket's
        scatter-padded (S, blk, m) table in the wire dtype; the int8
        codec's f32 row scales are counted apart, as ``scale_bytes``)."""
        wire = self.wire if wire is None else wire
        S = _ceil_div(self.s, self.n) * self.n
        rs_b = wire_lib.canon_wire_dtype(wire).itemsize
        return sum(S * b.blk * b.m * rs_b for b in self.buckets)

    def wire_bytes(self, rs_dtype=None) -> int:
        """RS leg in the wire dtype plus AG leg in the payload dtype."""
        S = _ceil_div(self.s, self.n) * self.n
        return self.rs_leg_bytes(rs_dtype) + sum(
            S * b.blk * b.m * _itemsize(b.dtype) for b in self.buckets)

    def describe(self, rs_dtype=None) -> dict:
        """The same dict as the JAX package's ``ExchangePlan.describe``."""
        elems = self.payload_elems()
        free = sum(b.free * b.m for b in self.buckets)
        wire = self.wire if rs_dtype is None else \
            wire_lib.canon_wire_name(rs_dtype)
        S = _ceil_div(self.s, self.n) * self.n
        quantized = wire_lib.make_codec(wire).quantized
        return {"n": self.n, "s": self.s, "n_buckets": self.n_buckets,
                "collectives_per_round": 2 * self.n_buckets,
                "engine": self.engine,
                "wire": wire,
                "recovery": self.recovery,
                "schedule": self.schedule,
                **({"ready_ms": [float(r) for r in self.ready_ms]}
                   if self.ready_ms is not None else {}),
                "per_bucket_masks": self.per_bucket_masks,
                "model_packets": self.model_packets,
                "payload_bytes": int(sum(
                    self.s * b.blk * b.m * _itemsize(b.dtype)
                    for b in self.buckets)),
                "rs_leg_bytes": int(self.rs_leg_bytes(wire)),
                "rs_bytes_ratio": float(self.rs_leg_bytes(wire)
                                        / max(self.rs_leg_bytes("f32"), 1)),
                # the int8 codec's f32 scale per block row, apart
                "scale_bytes": int(4 * S * self.n_buckets) if quantized
                else 0,
                "wire_bytes_per_round": int(self.wire_bytes(wire)),
                "pad_frac": float(1.0 - free / elems) if elems else 0.0}

    # ---- gather / scatter ------------------------------------------------
    def check_leaves(self, tree: Any, lead: int = 0) -> list:
        """Flatten ``tree`` and check it against the plan's shapes."""
        leaves = tree_lib.leaves(tree)
        if len(leaves) != self.n_leaves:
            raise ValueError(f"plan built for {self.n_leaves} leaves, "
                             f"tree has {len(leaves)}")
        for b in self.buckets:
            for lid, shp in zip(b.leaf_ids, b.shapes):
                got = tuple(leaves[lid].shape[lead:])
                if got != shp:
                    raise ValueError(
                        f"leaf {lid} shape {got} != plan shape {shp} "
                        f"(lead={lead}) — rebuild the plan for this tree")
        return leaves

    def gather_bucket(self, leaves: Sequence[torch.Tensor], b: int,
                      lead: int = 0) -> torch.Tensor:
        """Bucket ``b``'s (lead…, s, blk, m) block table; members are
        promoted to the bucket dtype. A one-leaf bucket without padding
        is a view of its leaf."""
        bk = self.buckets[b]
        lshape = tuple(leaves[bk.leaf_ids[0]].shape[:lead])
        dt = getattr(torch, bk.dtype)
        parts = [leaves[i].reshape(lshape + (-1,)).to(dt)
                 for i in bk.leaf_ids]
        seg = parts[0] if len(parts) == 1 else torch.cat(parts, dim=lead)
        if bk.pad:
            seg = torch.nn.functional.pad(seg, (0, bk.pad))
        return seg.reshape(lshape + (self.s, bk.blk, bk.m))

    def gather(self, tree: Any, lead: int = 0) -> list:
        """Tree -> list of (lead…, s, blk, m) block tables, one per
        bucket; ``lead`` leading dims (e.g. the stacked worker dim) are
        kept."""
        leaves = self.check_leaves(tree, lead)
        return [self.gather_bucket(leaves, b, lead)
                for b in range(self.n_buckets)]

    def scatter(self, tables: Sequence[torch.Tensor], lead: int = 0) -> Any:
        """Inverse of :meth:`gather` (members restored to their own
        shapes and dtypes)."""
        new_leaves: list = [None] * self.n_leaves
        for b, tbl in zip(self.buckets, tables):
            lshape = tuple(tbl.shape[:lead])
            seg = tbl.reshape(lshape + (self.s * b.blk,))
            off = 0
            for lid, sz, shp, dt in zip(b.leaf_ids, b.sizes, b.shapes,
                                        b.dtypes):
                piece = seg[..., off:off + sz]
                new_leaves[lid] = piece.reshape(lshape + shp).to(
                    getattr(torch, dt))
                off += sz
        return tree_lib.unflatten(self.treedef, new_leaves)


def _leaf_meta(leaves) -> Tuple[list, list, list]:
    shapes = [tuple(int(d) for d in x.shape) for x in leaves]
    dtypes = [wire_lib.dtype_name(x.dtype) for x in leaves]
    sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes]
    return shapes, dtypes, sizes


def _flat_bucket(ids, shapes, dtypes, sizes, s: int) -> Bucket:
    free = sum(sizes[i] for i in ids)
    blk = max(_ceil_div(free, s), 1)
    dt = getattr(torch, dtypes[ids[0]])
    for i in ids[1:]:
        dt = torch.promote_types(dt, getattr(torch, dtypes[i]))
    return Bucket(leaf_ids=tuple(ids),
                  shapes=tuple(shapes[i] for i in ids),
                  dtypes=tuple(dtypes[i] for i in ids),
                  sizes=tuple(sizes[i] for i in ids),
                  model_dim=None, m=1, free=free, blk=blk,
                  pad=s * blk - free, dtype=wire_lib.dtype_name(dt))


def bucket_ready_ms(buckets: Sequence[Bucket],
                    compute_ms: float) -> Tuple[float, ...]:
    """Per-bucket gradient readiness times of the backward-pass cost
    model: bucket b is ready once the backward has covered buckets
    b..B−1, the cost proportional to their payload; ``ready[0] ==
    compute_ms``."""
    if compute_ms <= 0:
        raise ValueError(f"compute_ms={compute_ms} must be > 0")
    sizes = np.array([b.free * b.m for b in buckets], np.float64)
    rev_cum = np.cumsum(sizes[::-1])[::-1]          # Σ sizes[b:]
    return tuple(float(compute_ms) * rev_cum / rev_cum[0])


def _canon_pipeline(wire, recovery) -> Tuple[str, str]:
    """(wire, recovery) plan fields; a parameterised robust spec
    ("trimmed:beta=0.3") keeps its canonical spelling."""
    wire = wire_lib.canon_wire_name("f32" if wire is None else wire)
    recovery = "renorm" if recovery is None else str(recovery)
    return wire, wire_lib.make_recovery(recovery).spec


def _schedule(schedule, compute_ms, buckets):
    """(schedule, ready_ms) of a plan from the schedule knobs."""
    schedule = "sync" if schedule is None else str(schedule)
    if schedule not in ("sync", "async"):
        raise ValueError(f"schedule={schedule!r}, want 'sync' or 'async'")
    if schedule == "async":
        if compute_ms is None:
            raise ValueError("schedule='async' needs compute_ms (the "
                             "modelled backward-pass duration readiness "
                             "times are derived from)")
        return schedule, bucket_ready_ms(buckets, float(compute_ms))
    if compute_ms is not None:
        raise ValueError("compute_ms only applies to schedule='async'")
    return schedule, None


def _check_ns(n: int, s: Optional[int]) -> int:
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    s = n if s is None else int(s)
    if s < 1:
        raise ValueError(f"need s >= 1 server blocks, got {s}")
    return s


def _not_ported(model_dims) -> None:
    if model_dims is not None:
        raise NotImplementedError("model_dims (tensor-parallel buckets) "
                                  "are not ported yet")


def make_plan(tree: Any, n: int, s: Optional[int] = None, *,
              bucket_bytes: Optional[float] = None,
              n_buckets: Optional[int] = None,
              model_dims: Any = None,
              per_bucket_masks: Optional[bool] = None,
              engine: str = "xla", wire: str = "f32",
              recovery: str = "renorm", schedule: str = "sync",
              compute_ms: Optional[float] = None) -> ExchangePlan:
    """The plan of ``tree`` (real or ``meta`` tensors: only shapes and
    dtypes are read). ``bucket_bytes``: greedy fixed-byte coalescing in
    tree order (a leaf larger than the budget gets its own bucket; leaves
    are never split). ``n_buckets``: that many size-balanced contiguous
    groups. Neither: one bucket. ``per_bucket_masks`` defaults to True
    exactly when a bucketing knob is given. ``schedule="async"`` needs
    ``compute_ms``, the modelled backward duration."""
    s = _check_ns(n, s)
    _not_ported(model_dims)
    if bucket_bytes is not None and n_buckets is not None:
        raise ValueError("give bucket_bytes or n_buckets, not both")
    if n_buckets is not None and int(n_buckets) < 1:
        raise ValueError(f"need n_buckets >= 1, got {n_buckets}")
    if bucket_bytes is not None and float(bucket_bytes) <= 0:
        raise ValueError(f"need bucket_bytes > 0, got {bucket_bytes}")
    leaves, treedef = tree_lib.flatten(tree)
    if not leaves:
        raise ValueError("cannot plan an empty tree")
    shapes, dtypes, sizes = _leaf_meta(leaves)
    ids = list(range(len(leaves)))
    groups: list = []
    if n_buckets is not None:
        k = max(1, min(int(n_buckets), len(ids)))
        total = sum(sizes)
        cur: list = []
        acc = 0
        for idx, i in enumerate(ids):
            cur.append(i)
            acc += sizes[i]
            left = len(ids) - idx - 1          # leaves still unassigned
            need = k - len(groups) - 1         # groups still to fill
            if len(groups) < k - 1 and (
                    acc >= total * (len(groups) + 1) / k or left == need):
                groups.append(cur)
                cur = []
        if cur:
            groups.append(cur)
    elif bucket_bytes is not None:
        cap = max(float(bucket_bytes), 1.0)
        cur, acc_b = [], 0.0
        for i in ids:
            nbytes = sizes[i] * _itemsize(dtypes[i])
            if cur and acc_b + nbytes > cap:
                groups.append(cur)
                cur, acc_b = [], 0.0
            cur.append(i)
            acc_b += nbytes
        if cur:
            groups.append(cur)
    else:
        groups.append(ids)
    buckets = tuple(_flat_bucket(g, shapes, dtypes, sizes, s)
                    for g in groups)
    if per_bucket_masks is None:
        per_bucket_masks = bucket_bytes is not None or n_buckets is not None
    wire, recovery = _canon_pipeline(wire, recovery)
    schedule, ready = _schedule(schedule, compute_ms, buckets)
    return ExchangePlan(n=int(n), s=s, buckets=buckets,
                        n_leaves=len(leaves),
                        per_bucket_masks=bool(per_bucket_masks),
                        treedef=treedef, engine=str(engine), wire=wire,
                        recovery=recovery, schedule=schedule,
                        ready_ms=ready)


def per_leaf_plan(tree: Any, n: int, s: Optional[int] = None, *,
                  engine: str = "xla", wire: str = "f32",
                  recovery: str = "renorm", schedule: str = "sync",
                  compute_ms: Optional[float] = None) -> ExchangePlan:
    """One bucket per leaf (each leaf fully flattened), one shared mask
    draw per round."""
    s = _check_ns(n, s)
    leaves, treedef = tree_lib.flatten(tree)
    if not leaves:
        raise ValueError("cannot plan an empty tree")
    shapes, dtypes, sizes = _leaf_meta(leaves)
    buckets = tuple(_flat_bucket([i], shapes, dtypes, sizes, s)
                    for i in range(len(leaves)))
    wire, recovery = _canon_pipeline(wire, recovery)
    schedule, ready = _schedule(schedule, compute_ms, buckets)
    return ExchangePlan(n=int(n), s=s, buckets=buckets,
                        n_leaves=len(leaves), per_bucket_masks=False,
                        treedef=treedef, engine=str(engine), wire=wire,
                        recovery=recovery, schedule=schedule,
                        ready_ms=ready)


def single_bucket_plan(tree: Any, n: int, s: Optional[int] = None, *,
                       engine: str = "xla", wire: str = "f32",
                       recovery: str = "renorm") -> ExchangePlan:
    """Every leaf ravelled into one bucket, one shared mask draw."""
    return make_plan(tree, n, s, engine=engine, wire=wire,
                     recovery=recovery)


def plan_from_config(tree: Any, n: int, s: Optional[int] = None, *,
                     bucket_mb: Optional[float] = None,
                     n_buckets: Optional[int] = None,
                     engine: str = "xla", wire: str = "f32",
                     recovery: str = "renorm", schedule: str = "sync",
                     compute_ms: Optional[float] = None) -> ExchangePlan:
    """The config-knob → plan policy of the simulator: ``bucket_mb`` MiB
    fixed-byte buckets or ``n_buckets`` size-balanced ones (per-bucket
    masks), both unset → the per-leaf plan; ``schedule`` / ``compute_ms``
    the async schedule."""
    if bucket_mb is not None or n_buckets is not None:
        return make_plan(tree, n, s,
                         bucket_bytes=(bucket_mb * 2 ** 20
                                       if bucket_mb is not None else None),
                         n_buckets=n_buckets, engine=engine, wire=wire,
                         recovery=recovery, schedule=schedule,
                         compute_ms=compute_ms)
    return per_leaf_plan(tree, n, s, engine=engine, wire=wire,
                         recovery=recovery, schedule=schedule,
                         compute_ms=compute_ms)


def decode_plan(d_model: int, batch: int, n: int,
                s: Optional[int] = None, *, dtype=torch.float32,
                engine: str = "xla", wire: str = "f32",
                recovery: str = "renorm") -> ExchangePlan:
    """Decode-shaped plan for serving-time activation collectives: one
    bucket over a single ``(d_model, batch)`` leaf — one decode token's
    layer output for the whole in-flight batch, model-dim major, so the s
    server blocks slice ``d_model`` and every wire packet carries a
    contiguous d-slice shared across requests."""
    leaf = torch.empty((int(d_model), int(batch)), dtype=dtype,
                       device="meta")
    return make_plan(leaf, n, s, engine=engine, wire=wire,
                     recovery=recovery)
