"""Static layout of one RPS round (port of :mod:`repro.core.plan`).

An :class:`ExchangePlan` lays a payload out as ``(s, blk, m)`` block
tables — s server blocks of ``blk`` rows — with the padding computed once
at setup. Ported so far: the single-leaf, single-bucket plan
(:func:`make_plan` with no bucketing knob) and the decode-shaped plan of
the tensor-parallel serving path (:func:`decode_plan`). The fixed-byte and
per-leaf bucketings, model-dim buckets and the async schedule raise or are
absent until the training path needs them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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
    dtype: str                              # payload dtype


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static layout of one RPS round over an n-worker axis with s server
    blocks, built once at setup. The payload is one tensor (the
    single-leaf plan), so there is one bucket and one shared mask draw
    per round."""
    n: int
    s: int
    buckets: Tuple[Bucket, ...]
    engine: str = "xla"
    wire: str = "f32"
    recovery: str = "renorm"

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def payload_elems(self) -> int:
        return sum(self.s * b.blk * b.m for b in self.buckets)

    def rs_leg_bytes(self, wire=None) -> int:
        """Bytes one device moves on the RS leg per round (every bucket's
        scatter-padded (S, blk, m) table in the wire dtype)."""
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
        return {"n": self.n, "s": self.s, "n_buckets": self.n_buckets,
                "collectives_per_round": 2 * self.n_buckets,
                "engine": self.engine,
                "wire": wire,
                "recovery": self.recovery,
                "schedule": "sync",
                "per_bucket_masks": False,
                "model_packets": self.s,         # one packet per block
                "payload_bytes": int(sum(
                    self.s * b.blk * b.m * _itemsize(b.dtype)
                    for b in self.buckets)),
                "rs_leg_bytes": int(self.rs_leg_bytes(wire)),
                "rs_bytes_ratio": float(self.rs_leg_bytes(wire)
                                        / max(self.rs_leg_bytes("f32"), 1)),
                "scale_bytes": 0,            # no quantised codec yet
                "wire_bytes_per_round": int(self.wire_bytes(wire)),
                "pad_frac": float(1.0 - free / elems) if elems else 0.0}

    # ---- gather / scatter ------------------------------------------------
    def gather(self, tree: torch.Tensor, lead: int = 0) -> list:
        """Payload -> list of (lead…, s, blk, m) block tables, one per
        bucket; ``lead`` leading dims (e.g. the stacked worker dim) are
        kept."""
        (bk,) = self.buckets
        got = tuple(tree.shape[lead:])
        if got != bk.shapes[0]:
            raise ValueError(f"leaf shape {got} != plan shape {bk.shapes[0]} "
                             f"(lead={lead}) — rebuild the plan")
        lshape = tuple(tree.shape[:lead])
        seg = tree.reshape(lshape + (-1,)).to(getattr(torch, bk.dtype))
        seg = seg[..., None]
        if bk.pad:
            seg = torch.nn.functional.pad(seg, (0, 0, 0, bk.pad))
        return [seg.reshape(lshape + (self.s, bk.blk, bk.m))]

    def scatter(self, tables: Sequence[torch.Tensor],
                lead: int = 0) -> torch.Tensor:
        """Inverse of :meth:`gather` (restored to the leaf's plan dtype)."""
        (bk,), (tbl,) = self.buckets, tables
        lshape = tuple(tbl.shape[:lead])
        seg = tbl.reshape(lshape + (self.s * bk.blk, bk.m))
        if bk.pad:
            seg = seg[..., :bk.free, :]
        return seg[..., 0].reshape(lshape + bk.shapes[0]).to(
            getattr(torch, bk.dtypes[0]))


def make_plan(tree: torch.Tensor, n: int, s: Optional[int] = None, *,
              engine: str = "xla", wire: str = "f32",
              recovery: str = "renorm") -> ExchangePlan:
    """The single-bucket plan of one tensor (a real tensor or a ``meta``
    one — only its shape and dtype are read)."""
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    s = n if s is None else int(s)
    if s < 1:
        raise ValueError(f"need s >= 1 server blocks, got {s}")
    if not isinstance(tree, torch.Tensor):
        raise NotImplementedError("multi-leaf plans are not ported yet; "
                                  "pass one tensor")
    shape = tuple(int(d) for d in tree.shape)
    dtype = wire_lib.dtype_name(tree.dtype)
    free = int(np.prod(shape, dtype=np.int64)) if shape else 1
    blk = max(_ceil_div(free, s), 1)
    bucket = Bucket(leaf_ids=(0,), shapes=(shape,), dtypes=(dtype,),
                    sizes=(free,), model_dim=None, m=1, free=free, blk=blk,
                    pad=s * blk - free, dtype=dtype)
    wire = wire_lib.canon_wire_name("f32" if wire is None else wire)
    recovery = wire_lib.make_recovery(recovery).kind
    return ExchangePlan(n=int(n), s=s, buckets=(bucket,),
                        engine=str(engine), wire=wire, recovery=recovery)


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
