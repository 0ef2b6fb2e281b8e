"""Wire pipeline: codecs × loss recovery (port of :mod:`repro.core.wire`).

Ported so far: the linear codecs (``f32`` passthrough, the paper's wire,
and ``bf16``, which the tensor-parallel decode config accepts) and the
stateless recoveries ``renorm`` (divide by the received count, Algorithm 1)
and ``scale`` (divide by the expected count n(1−p), the simulator takes p
from its channel's ``effective_p``). A linear codec's sums accumulate in
its wire dtype (:attr:`WireCodec.accum_dtype`). The int8 codec, the
error-feedback recovery and the robust aggregators raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

WIRES = ("f32", "bf16")
RECOVERIES = ("renorm", "scale")
_NOT_PORTED_WIRES = ("int8",)
_NOT_PORTED_RECOVERIES = ("ef", "median", "trimmed", "clip")

_ALIASES = {"f32": torch.float32, "fp32": torch.float32,
            "float32": torch.float32, "bf16": torch.bfloat16,
            "bfloat16": torch.bfloat16}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """A linear codec: the RS-leg contributions are rounded to
    ``wire_dtype`` (a cast; decoding is the identity)."""
    name: str
    wire_dtype: torch.dtype

    @property
    def accum_dtype(self) -> torch.dtype:
        """Dtype the RS sums accumulate in: the wire dtype itself."""
        return self.wire_dtype

    def to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A contribution's wire representation: rounded to the wire grid
        only when that narrows it (widening is exact, so ``x`` itself is
        kept and no copy is made)."""
        if self.wire_dtype.itemsize < x.dtype.itemsize:
            return x.to(self.wire_dtype)
        return x


_CODECS = {name: WireCodec(name, dt) for dt, name in _NAMES.items()}


def canon_wire_dtype(wire: Any) -> torch.dtype:
    """Wire dtype of any spelling: short names, dtype names, torch dtypes,
    codecs; ``None`` is the f32 default."""
    if wire is None:
        return torch.float32
    if isinstance(wire, WireCodec):
        return wire.wire_dtype
    if isinstance(wire, torch.dtype):
        return wire
    name = str(wire).lower()
    if name in _NOT_PORTED_WIRES:
        raise NotImplementedError(f"wire={wire!r} is not ported yet; "
                                  f"ported: {WIRES}")
    if name not in _ALIASES:
        raise ValueError(f"wire={wire!r}: unknown (known: {WIRES})")
    return _ALIASES[name]


def canon_wire_name(wire: Any) -> str:
    """Canonical short name ("f32" | "bf16") of any wire spelling."""
    if isinstance(wire, WireCodec):
        return wire.name
    dt = canon_wire_dtype(wire)
    if dt not in _NAMES:
        raise NotImplementedError(f"wire dtype {dt} is not ported yet")
    return _NAMES[dt]


def make_codec(wire: Any) -> WireCodec:
    if isinstance(wire, WireCodec):
        return wire
    return _CODECS[canon_wire_name(wire)]


def resolve_codec(wire: Any, rs_dtype: Any = torch.float32) -> WireCodec:
    """A non-f32 ``wire=`` wins; the f32 default (and ``None``) defers to
    a linear codec of the legacy ``rs_dtype`` knob."""
    if wire is not None:
        codec = make_codec(wire)
        if codec.name != "f32":
            return codec
    return make_codec(rs_dtype)


def config_wire(wire: Any, exchange_dtype: Any = "float32") -> str:
    """The effective codec of a config's (``wire``, ``exchange_dtype``)
    pair: an explicit non-f32 ``wire`` wins; otherwise the legacy
    ``exchange_dtype`` knob selects the matching linear codec. A codec
    that is not ported yet is returned by name, for the caller to
    refuse."""
    if str(wire).lower() in _NOT_PORTED_WIRES:
        return str(wire).lower()
    name = canon_wire_name(wire)
    if name != "f32":
        return name
    return canon_wire_name(exchange_dtype)


@dataclasses.dataclass(frozen=True)
class Recovery:
    """Receiver-side loss recovery. ``p`` is the expected drop rate the
    ``scale`` divisor needs; unused by ``renorm``."""
    kind: str = "renorm"
    p: Optional[float] = None

    def __post_init__(self):
        if self.kind in _NOT_PORTED_RECOVERIES:
            raise NotImplementedError(
                f"recovery={self.kind!r} is not ported yet; ported: "
                f"{RECOVERIES}")
        if self.kind not in RECOVERIES:
            raise ValueError(
                f"recovery={self.kind!r}, want one of {RECOVERIES}")

    def expected_count(self, n: int) -> float:
        """The static ``scale`` divisor n(1−p), clamped to ≥ 1."""
        if self.p is None:
            raise ValueError("recovery='scale' needs the expected drop "
                             "rate p")
        return max(float(n) * (1.0 - float(self.p)), 1.0)


def make_recovery(recovery: Any, p: Optional[float] = None) -> Recovery:
    """Recovery from a kind name or instance, binding ``p`` for ``scale``
    when the instance carries none. ``None`` is renorm."""
    if recovery is None:
        return Recovery("renorm")
    if isinstance(recovery, Recovery):
        if recovery.kind == "scale" and recovery.p is None:
            return dataclasses.replace(recovery, p=p)
        return recovery
    return Recovery(str(recovery), p=p)
