"""Wire pipeline: codecs × loss recovery (port of :mod:`repro.core.wire`).

Codecs — how a contribution is represented on the reduce-scatter leg:

  ``f32``   passthrough, the paper's wire;
  ``bf16``  a linear downcast; a linear codec's sums accumulate in its
            wire dtype (:attr:`WireCodec.accum_dtype`); any other float
            dtype is a linear codec too, as in the reference
            (``"float16"`` / ``"f16"``: the masked-average kernel takes
            it; the ring kernels refuse it, ``kernels/ring.py::
            check_wire``);
  ``int8``  the quantised codec: each block row onto the grid
            {−127, …, 127} with one f32 scale (:mod:`repro_torch.core.quant`),
            stochastic rounding when noise is given, round-to-nearest-even
            otherwise; the decoded values accumulate in f32.

Recoveries — what the receiver does about missing contributions:
``renorm`` (divide by the received count, Algorithm 1), ``scale`` (divide
by the expected count n(1−p); the simulator takes p from its channel's
``effective_p``) and ``ef``, renorm plus an error-feedback residual
e' = (x + e) − decode(encode(x + e)) carried per worker across rounds
(:func:`init_ef_state`); and the Byzantine-robust aggregators
(:mod:`repro_torch.core.robust`) over the pre-reduce table: ``median``,
``trimmed`` (β-trimmed mean, ``"trimmed:beta=0.2"``) and ``clip``
(norm-clip at ``clip_mult`` × the median delivered norm).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import quant as quant_lib

WIRES = ("f32", "bf16", "int8")
RECOVERIES = ("renorm", "scale", "ef", "median", "trimmed", "clip")
#: the Byzantine-robust kinds: they aggregate the per-worker table
ROBUST_RECOVERIES = ("median", "trimmed", "clip")

_ALIASES = {"f32": torch.float32, "fp32": torch.float32,
            "float32": torch.float32, "bf16": torch.bfloat16,
            "bfloat16": torch.bfloat16, "int8": torch.int8,
            "f16": torch.float16, "fp16": torch.float16,
            "float16": torch.float16}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Encode / decode of the RS leg. ``levels == 0``: a linear codec,
    the contributions rounded to ``wire_dtype`` (a cast; decoding is the
    identity). ``levels > 0``: a quantised codec, one f32 scale per block
    row (every dim after ``lead``) and a payload on the integer grid in
    ``wire_dtype``."""
    name: str
    wire_dtype: torch.dtype
    levels: int = 0

    @property
    def quantized(self) -> bool:
        return self.levels > 0

    @property
    def accum_dtype(self) -> torch.dtype:
        """Dtype the RS sums accumulate in: the wire dtype itself for a
        linear codec, f32 for a quantised one."""
        return torch.float32 if self.quantized else self.wire_dtype

    def to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A linear codec's wire representation of a contribution: rounded
        to the wire grid only when that narrows it (widening is exact, so
        ``x`` itself is kept and no copy is made)."""
        if self.wire_dtype.itemsize < x.dtype.itemsize:
            return x.to(self.wire_dtype)
        return x

    def encode(self, x: torch.Tensor, uniforms=None, lead: int = 0,
               gen: Optional[torch.Generator] = None):
        """x → (wire payload, scales): a cast and no scales for a linear
        codec; per-row f32 scales over dims > ``lead`` and the int8 grid
        for a quantised one, rounded stochastically with ``uniforms`` (or
        uniforms drawn from ``gen``), to nearest-even without."""
        if not self.quantized:
            return x.to(self.wire_dtype), None
        return quant_lib.quantize(x, self.levels, self.wire_dtype,
                                  uniforms=uniforms, gen=gen, lead=lead)

    def decode(self, enc: torch.Tensor, scale) -> torch.Tensor:
        """Payload back to accumulation values (f32 × scale for a
        quantised codec, the identity for a linear one)."""
        if not self.quantized:
            return enc
        return quant_lib.dequantize(enc, scale)

    def fake_quant(self, x: torch.Tensor, uniforms=None, lead: int = 0,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """decode(encode(x)) in ``x``'s dtype — what the wire delivers;
        the EF residual is x − fake_quant(x)."""
        if not self.quantized:
            return x.to(self.wire_dtype).to(x.dtype)
        return self.decode(*self.encode(x, uniforms, lead, gen)).to(x.dtype)


_CODECS = {"f32": WireCodec("f32", torch.float32),
           "bf16": WireCodec("bf16", torch.bfloat16),
           "int8": WireCodec("int8", torch.int8, levels=127)}


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
    if name not in _ALIASES:
        raise ValueError(f"wire={wire!r}: unknown (known: {WIRES})")
    return _ALIASES[name]


def canon_wire_name(wire: Any) -> str:
    """Canonical short name ("f32" | "bf16" | "int8", else the dtype's
    name: "float16") of any wire spelling."""
    if isinstance(wire, WireCodec):
        return wire.name
    dt = canon_wire_dtype(wire)
    return _NAMES.get(dt, dtype_name(dt))


def make_codec(wire: Any) -> WireCodec:
    """The codec of any wire spelling; a float dtype without a codec of
    its own is a linear one (a cast), as in the reference."""
    if isinstance(wire, WireCodec):
        return wire
    name = canon_wire_name(wire)
    if name in _CODECS:
        return _CODECS[name]
    dt = canon_wire_dtype(wire)
    if not dt.is_floating_point:
        raise ValueError(f"wire={wire!r}: no codec for dtype {dt} "
                         f"(known: {WIRES})")
    return WireCodec(name, dt)


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
    ``exchange_dtype`` knob selects the matching linear codec."""
    name = canon_wire_name(wire)
    if name != "f32":
        return name
    return canon_wire_name(exchange_dtype)


@dataclasses.dataclass(frozen=True)
class Recovery:
    """Receiver-side loss recovery. ``p`` is the expected drop rate the
    ``scale`` divisor needs; ``beta`` the per-side trim fraction of
    ``trimmed``, ``clip_mult`` the clip threshold multiple of ``clip``
    (both inert for the other kinds)."""
    kind: str = "renorm"
    p: Optional[float] = None
    beta: float = 0.1
    clip_mult: float = 2.0

    def __post_init__(self):
        if self.kind not in RECOVERIES:
            raise ValueError(
                f"recovery={self.kind!r}, want one of {RECOVERIES}")
        if not 0.0 <= float(self.beta) < 0.5:
            raise ValueError(f"recovery beta={self.beta} not in [0, 0.5)")
        if not float(self.clip_mult) > 0.0:
            raise ValueError(
                f"recovery clip_mult={self.clip_mult} must be > 0")

    @property
    def needs_state(self) -> bool:
        """EF carries a params-shaped residual across rounds."""
        return self.kind == "ef"

    @property
    def needs_table(self) -> bool:
        """The robust kinds aggregate the per-worker contribution table
        before any reduce, so the exchange materialises it."""
        return self.kind in ROBUST_RECOVERIES

    @property
    def spec(self) -> str:
        """Canonical spec string, round-trippable through
        :func:`make_recovery` ("trimmed:beta=0.2"; the bare kind when
        every knob is at its default)."""
        d = Recovery(self.kind)
        args = [f"{f}={getattr(self, f):g}" for f in ("beta", "clip_mult")
                if getattr(self, f) != getattr(d, f)]
        return self.kind if not args else f"{self.kind}:{','.join(args)}"

    def expected_count(self, n: int) -> float:
        """The static ``scale`` divisor n(1−p), clamped to ≥ 1."""
        if self.p is None:
            raise ValueError("recovery='scale' needs the expected drop "
                             "rate p (pass p= or a channel effective_p)")
        return max(float(n) * (1.0 - float(self.p)), 1.0)

    def breakdown_point(self) -> float:
        """Largest corrupted fraction the aggregate tolerates: median and
        clip 1/2, trimmed β, the averaging kinds 0."""
        return {"median": 0.5, "trimmed": float(self.beta),
                "clip": 0.5}.get(self.kind, 0.0)


def make_recovery(recovery: Any, p: Optional[float] = None) -> Recovery:
    """Recovery from a spec string (``"kind"`` or
    ``"kind:beta=0.2,clip_mult=3,p=0.1"``) or an instance, binding ``p``
    for ``scale`` when the instance carries none. ``None`` is renorm."""
    if recovery is None:
        return Recovery("renorm")
    if isinstance(recovery, Recovery):
        if recovery.kind == "scale" and recovery.p is None:
            return dataclasses.replace(recovery, p=p)
        return recovery
    spec = str(recovery)
    kind, _, argstr = spec.partition(":")
    kw = {}
    if argstr:
        for item in argstr.split(","):
            if not item:
                continue
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(f"recovery spec {spec!r}: want k=v args")
            if k not in ("beta", "clip_mult", "p"):
                raise ValueError(f"recovery spec {spec!r}: unknown arg "
                                 f"{k!r} (want beta, clip_mult, p)")
            kw[k] = float(v)
    kw.setdefault("p", p)
    return Recovery(kind, **kw)


def init_ef_state(tree: Any) -> Any:
    """Zero EF residual matching an exchanged tree (same shapes, dtypes
    and devices; per-worker for a stacked simulator tree)."""
    return tree_lib.map(torch.zeros_like, tree)


# ---- theory constants (core.theory reads them) ----------------------------

#: Nominal relative second moment ω = E‖decode(encode(x)) − x‖² / ‖x‖² of
#: one codec pass: bf16 round-to-nearest at 8 mantissa bits (the
#: conservative 2⁻¹⁷), int8 stochastic rounding at Δ = max|x|/127 against
#: E x² ≈ max²/3, f32 exact.
WIRE_OMEGA = {
    "f32": 0.0,
    "bf16": 2.0 ** -17,
    "int8": 3.0 / (4.0 * 127.0 ** 2),
}


def codec_omega(wire: Any) -> float:
    """ω of any wire spelling; a float dtype without an entry gets the
    round-to-nearest figure ε²/4, ε its unit roundoff."""
    dt = canon_wire_dtype(wire)
    name = _NAMES.get(dt)
    if name in WIRE_OMEGA:
        return WIRE_OMEGA[name]
    eps = float(torch.finfo(dt).eps) / 2.0
    return eps * eps / 4.0


def effective_omega(wire: Any, recovery: Any = "renorm") -> float:
    """Codec variance after recovery: EF leaves the higher-order ω²,
    renorm, scale and the robust kinds pass ω through."""
    w = codec_omega(wire)
    return w * w if make_recovery(recovery).kind == "ef" else w


#: Asymptotic relative efficiency of each robust aggregator against the
#: plain mean on clean Gaussian data (median π/2, clip 1; trimmed
#: 1/(1−2β), computed from its β).
ROBUST_EFFICIENCY = {"median": 3.14159265 / 2.0, "clip": 1.0}


def recovery_alpha2_extra(recovery: Any, n: int, p: float) -> float:
    """Extra α₂-style variance of the recovery step: 0 for renorm and ef
    (the paper's bounds price the realised count in), the count's
    relative variance p/((1−p)n) for ``scale``, which divides by the
    expected count, and (eff − 1)/n for the robust kinds, eff their
    clean-data efficiency loss."""
    rec = make_recovery(recovery)
    if rec.kind == "scale":
        if p >= 1.0:
            return 1.0
        return float(p / ((1.0 - p) * n))
    if rec.kind in ROBUST_RECOVERIES:
        eff = ROBUST_EFFICIENCY.get(rec.kind,
                                    1.0 / max(1.0 - 2.0 * rec.beta, 1e-9))
        return float((eff - 1.0) / max(n, 1))
    return 0.0
