"""The meta-device count of one step (the port's stand-in for XLA's
``cost_analysis`` and ``memory_analysis`` of a compiled program).

:class:`Counter` is a ``TorchDispatchMode``: run a step on meta tensors
(shapes and dtypes, no data, no device) under it and it gathers, for the
eager program the step would run on the card:

- FLOPs by kind (bf16 / f16 / TF32 / f32 …): the products, convolutions
  and attention that ``torch.utils.flop_counter``'s formulas price (that
  module is PyTorch's counting utility; XLA's count also holds the
  elementwise ops, this one does not);
- HBM bytes: every aten op's inputs read once and its outputs written
  once (a broadcast operand by the memory it spans); views and metadata
  ops move none, and an in-place op counts its mutated operand once. This
  is the eager program's unfused traffic;
- each hand-written kernel's :func:`repro_torch.roofline.analysis.
  kernel_cost`, which its wrapper records (:func:`record_kernel`) when it
  meets a meta tensor, in place of the aten ops of a plain version;
- the collectives ``core/comm.py`` recorded meanwhile (the counter
  opens a ``comm.recording()`` scope);
- the peak of live bytes: each new storage counts from the op that makes
  it until it is freed, on top of the step's ``resident`` arguments.

An op whose signature (:func:`_signature`: the op, its tensors' shapes,
strides and dtypes, its other arguments) the counter has met before is
not run again: its fresh outputs are made again as empty meta tensors of
the same layout and its counts are repeated, which is what running it
would give (``tests/test_torch_roofline.py`` holds the two equal); the
model's Python still runs every layer. :func:`iterations` lets a loop
over identical parts whose backward runs inside the loop (the trainer's
microbatches) run its first part once with every count scaled by their
number.
:class:`MetaGenerator` is a generator that reports the meta device, so
that the models' init draws and the samplers' masks run there (a CPU
generator, which meta draws ignore).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import analysis

aten = torch.ops.aten

# ops that move no bytes: allocations and metadata (views are found by
# their schema, OpOverload.is_view)
_FREE_OPS = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._unsafe_view.default,
             aten.lift_fresh.default, aten.detach.default,
             aten.set_.source_Storage_storage_offset,
             aten.resize_.default, aten.sym_size.int,
             aten.sym_stride.int, aten.sym_numel.default,
             aten.sym_storage_offset.default}


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: ``model.init(gen)``
    and the samplers draw with ``device=gen.device``, so they make meta
    tensors of the right shapes and dtypes (a meta draw reads nothing
    from the generator)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


_ACTIVE: List["Counter"] = []


def active() -> Optional["Counter"]:
    return _ACTIVE[-1] if _ACTIVE else None


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span in its storage (its numel
    unless it broadcasts with a zero stride)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


def _leaves(x, out: list) -> list:
    """The leaves of an op's arguments or outputs (nested tuples, lists
    and dicts), in order; ``tree_flatten``'s without its spec."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _signature(func, n_args: int, kw: tuple, leaves: list):
    """What an op's outputs and counts are a function of on the meta
    device: the op, its arguments' layout, each tensor's shape, strides,
    dtype and offset and which leaves are the same tensor, the other
    leaves' values. None where a leaf is off the meta device or has no
    hash."""
    key = [func, n_args, kw]
    first: Dict[int, int] = {}
    for i, t in enumerate(leaves):
        if isinstance(t, torch.Tensor):
            if t.device.type != "meta":
                return None
            key.append((first.setdefault(id(t), i), t.shape, t.stride(),
                        t.dtype, t.storage_offset()))
        else:
            try:
                hash(t)
            except TypeError:
                return None
            key.append((type(t), t))
    return tuple(key)


def counting(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper given ``t`` is being counted: a meta
    tensor under an active counter (a meta tensor outside one has no
    kernel, and the wrapper raises as for any other device)."""
    return t.device.type == "meta" and active() is not None


def record_kernel(name: str, *args, **kwargs) -> None:
    """A wrapper's call of kernel ``name`` on meta tensors: its
    :func:`analysis.kernel_cost` on the same arguments goes to the active
    counter (nothing without one)."""
    c = active()
    if c is not None:
        c.add_kernel(name, *analysis.kernel_cost(name, *args, **kwargs))


class Counter(TorchDispatchMode):
    """Counts what the ops run under it would move and compute (see the
    module's docstring). ``resident``: the bytes live when the count
    starts (the step's parameters, state and batch)."""

    def __init__(self, resident: int = 0):
        super().__init__()
        self.flops_by_kind: Dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.records: List[Tuple[str, int, int]] = []
        self.resident = int(resident)
        self.live = 0
        self.peak_live = 0
        self.live_end = 0
        self._storages: Dict[int, int] = {}
        self._scale = 1
        self._scope = None
        self._seen: Dict[tuple, tuple] = {}

    # ---- bookkeeping ----------------------------------------------------
    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += self._scale
        k["flops"] += flops * self._scale
        k["bytes"] += nbytes * self._scale
        kind = analysis.KERNEL_FLOP_KIND[name]
        self.flops_by_kind[kind] = (self.flops_by_kind.get(kind, 0.0)
                                    + flops * self._scale)
        self.bytes += nbytes * self._scale

    @contextlib.contextmanager
    def scaled(self, k: int):
        """Every count made inside counts ``k`` times (the peak of live
        bytes does not: one part runs at a time)."""
        saved = self._scale
        self._scale = saved * int(k)
        try:
            yield
        finally:
            self._scale = saved

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        self.live += nbytes
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(st, self._free, key)

    # ---- the mode -------------------------------------------------------
    def __enter__(self):
        from repro_torch.core import comm
        _ACTIVE.append(self)
        self._scope = comm.recording()
        self.records = self._scope.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.live_end = self.live
        self._scope.__exit__(*exc)
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func in _FREE_OPS:
            out = func(*args, **kwargs)
            if func in _FREE_OPS:
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self._track(t)
            return out
        self.ops += self._scale
        leaves = _leaves((args, kwargs), [])
        key = _signature(func, len(args), tuple(kwargs), leaves)
        hit = self._seen.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            hit = self._price(func, args, kwargs, leaves, out)
            if key is not None and hit[3] is not None:
                self._seen[key] = hit
        else:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in hit[3][0]]
            for t in outs:
                self._track(t)
            out = outs[0] if hit[3][1] is None else hit[3][1](outs)
        nbytes, kind, flops, _ = hit
        self.bytes += nbytes * self._scale
        if kind is not None:
            self.flops_by_kind[kind] = (self.flops_by_kind.get(kind, 0.0)
                                        + flops * self._scale)
        return out

    def _price(self, func, args, kwargs, leaves, out) -> tuple:
        """``(bytes, FLOP kind, FLOPs, outputs)`` of one op: ``outputs``
        the (shapes, strides, dtypes) and tree of its outputs where each
        is a fresh meta tensor of its own storage (so that the same
        signature can make them again), else None. Tracks the fresh
        outputs."""
        ins = {}
        for t in leaves:
            if isinstance(t, torch.Tensor):
                ins[id(t)] = t
        nbytes = sum(_span_bytes(t) for t in ins.values())
        outs = out if isinstance(out, (tuple, list)) else (out,)
        fresh, keys = [], set()
        for r, t in zip(func._schema.returns, outs):
            if not isinstance(t, torch.Tensor):
                continue
            if r.alias_info is None and id(t) not in ins:
                nbytes += _span_bytes(t)
                fresh.append(t)
                keys.add(id(t.untyped_storage()))
        kind, flops = None, 0
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            first = next(t for t in ins.values()
                         if t.is_floating_point() or t.dtype == torch.int8)
            kind = analysis.flop_kind(first.dtype)
            flops = formula(*args, **kwargs, out_val=out)
        flat = _leaves(out, [])
        tensors = [t for t in flat if isinstance(t, torch.Tensor)]
        again, spec = None, None
        if not isinstance(out, torch.Tensor):
            spec = type(out)
            if spec not in (tuple, list) or len(flat) != len(out):
                flat = ()           # nested outputs: not made again
        if tensors and len(tensors) == len(flat) == len(fresh) == len(keys) \
                and all(t.device.type == "meta" and t.storage_offset() == 0
                        and t.untyped_storage().nbytes() == _span_bytes(t)
                        for t in tensors):
            again = ([(t.shape, t.stride(), t.dtype) for t in tensors],
                     spec)
        for t in fresh:
            self._track(t)
        return nbytes, kind, flops, again

    # ---- results --------------------------------------------------------
    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_kind.values()))

    def totals(self) -> dict:
        """The JAX package's ``measure`` keys, per device: ``flops``,
        ``bytes``, ``coll`` (link bytes), ``coll_by_op``, ``hbm`` (the
        resident bytes plus the peak of live ones), and ``resident``,
        ``peak_live``, ``live_end`` (the live bytes when the count
        ended: what the step left alive), ``flops_by_kind``, ``kernels``,
        ``collective_counts``, ``ops``."""
        coll = analysis.collective_bytes(self.records)
        counts: Dict[str, int] = {}
        for op, _, _ in self.records:
            counts[op] = counts.get(op, 0) + 1
        return {"flops": self.flops, "bytes": float(self.bytes),
                "coll": coll["total"], "coll_by_op": coll,
                "hbm": float(self.resident + self.peak_live),
                "resident": float(self.resident),
                "peak_live": float(self.peak_live),
                "live_end": float(self.live_end),
                "flops_by_kind": dict(self.flops_by_kind),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collective_counts": counts, "ops": self.ops}


def iterations(n: int, device: torch.device) -> Iterator[int]:
    """``range(n)`` — except on the meta device under a counter, where
    the parts are identical and each runs whole, its backward included,
    inside the loop's body (the trainer's microbatches): part 0 alone,
    counted ``n`` times (nothing of a part runs after the loop)."""
    c = active()
    if c is None or torch.device(device).type != "meta" or n <= 1:
        yield from range(n)
        return
    with c.scaled(n):
        yield 0

