"""Roofline terms on one NVIDIA H100 (port of
:mod:`repro.roofline.analysis`).

Three terms per (arch × shape × mesh), in seconds, per device::

  compute    = Σ over dtypes of FLOPs_dtype / the card's peak for it
  memory     = HBM bytes / 3.35 TB/s
  collective = link bytes / 450 GB/s (NVLink, each way)

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit,
dense rates: 989 TFLOP/s in bf16 and fp16 on the tensor cores, 495 in
TF32, 67 in f32 outside the tensor cores, 1,979 in fp8 and int8, 80 GB of
HBM. The port turns TF32 off (``launch/train.py``, ``chip_smoke.py``), so
an f32 product counts at the f32 rate unless
``torch.backends.cuda.matmul.allow_tf32`` is on when it is counted
(:mod:`repro_torch.roofline.count`).

The totals come from the meta-device count of one step
(:mod:`repro_torch.roofline.count`): it visits every layer and every
microbatch, so the JAX package's probe compiles and their linear solve
(``corrected_totals``: XLA's ``cost_analysis`` counts a scan body once)
and its HLO regexes have no counterpart here. The collective bytes come
from the records ``core/comm.py`` keeps, priced by the JAX package's
per-op link formulas (:func:`collective_bytes`).

:func:`kernel_cost` gives each hand-written kernel's work, ``(flops,
bytes)``: each input byte read once and each output byte written once,
the data-dependent part (the dropped blocks' fallback) counted from the
masks given. ``chip_smoke.py`` states every kernel's bound from it, and
each wrapper records it when it meets a meta tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's peaks. ``peak_flops`` prices a total given without its
    dtypes (the JAX package's single-rate arithmetic)."""
    peak_flops: float = 989e12       # bf16 / fp16, tensor cores
    hbm_bw: float = 3.35e12          # bytes/s
    link_bw: float = 450e9           # bytes/s, NVLink each way
    hbm_bytes: float = 80e9
    peak_tf32: float = 495e12
    peak_f32: float = 67e12          # outside the tensor cores
    peak_8bit: float = 1979e12       # fp8, int8

    def peak(self, kind: str) -> float:
        """FLOP/s for one of :data:`FLOP_KINDS`; f64 has no row in the
        data sheet's table the port uses, so it is priced at the f32
        rate."""
        return {"bf16": self.peak_flops, "f16": self.peak_flops,
                "tf32": self.peak_tf32, "f32": self.peak_f32,
                "f64": self.peak_f32, "f8": self.peak_8bit,
                "i8": self.peak_8bit}[kind]


FLOP_KINDS = ("bf16", "f16", "tf32", "f32", "f64", "f8", "i8")


def flop_kind(dtype: torch.dtype, tf32: Optional[bool] = None) -> str:
    """The peak a product of ``dtype`` operands runs at: f32 takes TF32
    only when ``tf32`` (default: torch's matmul flag) is on."""
    if dtype == torch.float32:
        if tf32 is None:
            tf32 = torch.backends.cuda.matmul.allow_tf32
        return "tf32" if tf32 else "f32"
    return {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float64: "f64", torch.int8: "i8", torch.uint8: "i8",
            torch.float8_e4m3fn: "f8", torch.float8_e5m2: "f8"
            }.get(dtype, "f32")


def _hlo_name(op: str) -> str:
    return op.replace("_", "-")


def collective_bytes(records: Iterable[Tuple[str, int, int]]
                     ) -> Dict[str, float]:
    """Per-device bytes moved over links, by collective type, from
    ``core/comm.py``'s records ``(op, result bytes, group size k)``: the
    JAX package's ``collective_bytes_from_hlo`` formulas — all-gather
    (k−1)/k × result, all-reduce 2(k−1)/k × size (a ring), reduce-scatter
    (k−1) × result (its input ≈ result × k), all-to-all and
    collective-permute their size. Keys in the HLO spelling, and
    ``total``."""
    out: Dict[str, float] = {}
    for op, size, k in records:
        op = _hlo_name(op)
        size = float(size)
        if op == "all-gather":
            moved = size * (k - 1) / k
        elif op == "all-reduce":
            moved = 2.0 * size * (k - 1) / k
        elif op == "reduce-scatter":
            moved = size * (k - 1)
        else:
            moved = size
        out[op] = out.get(op, 0.0) + moved
    out["total"] = sum(v for kk, v in out.items() if kk != "total")
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per device
    bytes_hbm: float             # per device
    coll_bytes: float            # per device
    coll_by_op: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / (flops × chips)
    hbm_per_device: float        # the count's peak of live bytes
    fits: bool
    raw: Dict[str, float]

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} "
                f"| {self.t_collective*1e3:.2f} | {self.bottleneck} "
                f"| {self.useful_ratio:.2f} "
                f"| {self.hbm_per_device/1e9:.1f} "
                f"| {'yes' if self.fits else 'NO'} |")


def compute_seconds(totals: Dict, hw: HW = HW()) -> float:
    """Σ FLOPs_dtype / peak_dtype over ``totals["flops_by_kind"]``, or
    ``totals["flops"]`` at ``hw.peak_flops`` when the kinds are not
    given."""
    by = totals.get("flops_by_kind")
    if by:
        return sum(f / hw.peak(k) for k, f in by.items())
    return totals["flops"] / hw.peak_flops


def analyze(arch: str, shape: str, mesh_desc: str, chips: int,
            totals: Dict, model_flops_global: float,
            hw: HW = HW()) -> RooflineReport:
    """The JAX package's ``analyze_compiled`` arithmetic on per-device
    ``totals`` (``flops``, ``bytes``, ``coll``, ``hbm``, optional
    ``coll_by_op`` and ``flops_by_kind``)."""
    t_c = compute_seconds(totals, hw)
    t_m = totals["bytes"] / hw.hbm_bw
    t_l = totals["coll"] / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_global / max(totals["flops"] * chips, 1.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops=totals["flops"], bytes_hbm=totals["bytes"],
        coll_bytes=totals["coll"], coll_by_op=totals.get("coll_by_op", {}),
        t_compute=t_c, t_memory=t_m, t_collective=t_l,
        bottleneck=bottleneck,
        model_flops_global=model_flops_global,
        useful_ratio=useful,
        hbm_per_device=totals["hbm"],
        fits=totals["hbm"] <= hw.hbm_bytes,
        raw=dict(totals))


# ---- the hand-written kernels' work ----------------------------------------

def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _zeros(mask: torch.Tensor, meta_count: int) -> int:
    """The entries of ``mask`` that are zero (packets dropped); on the
    meta device, whose tensors hold no values, ``meta_count``: every
    entry that can drop."""
    if mask.device.type == "meta":
        return meta_count
    return int((mask == 0).sum())


def _masked_avg_grid(blocks, mask):
    B, n, d = blocks.shape
    return (2 * B * n * d,
            _nbytes(blocks) + _nbytes(mask) + B * d * blocks.element_size())


def _tp_combine(partials, rs, ag, site, *, n, receiver, plan_geometry,
                wire_dtype=None):
    """The partials, the site's n rs rows and the receiver's ag row read
    once; the (B, 1, d) f32 consensus written once; n products, the mask
    product and the add an element."""
    _, B, _, d = partials.shape
    return (3 * n * B * d,
            _nbytes(partials) + (n + 1) * plan_geometry.s * rs.element_size()
            + B * d * 4)


def _rwkv6(r, k, v, w, u):
    """r, k, w, v, u read; the output and the f32 final state written;
    6·B·S·h·dk·dv operations (the kernel's products, on TF32 tensor
    cores)."""
    B, S, h, dk = r.shape
    dv = v.shape[-1]
    return (6 * B * S * h * dk * dv,
            _nbytes(r) + _nbytes(k) + _nbytes(w) + _nbytes(v) + _nbytes(u)
            + B * S * h * dv * r.element_size() + B * h * dk * dv * 4)


def _rglru(x, a):
    B, S, d = x.shape
    return 5 * B * S * d, (2 * _nbytes(x) + _nbytes(a) + B * d * 4)


def _ring_round(stack, rs, ag, div, *, mode="model", rs_dtype=None):
    """The stack read and the round written once, the masks and the
    divisor read; a gate and an add an element."""
    return (2 * stack.numel(),
            2 * _nbytes(stack) + _nbytes(rs) + _nbytes(ag) + _nbytes(div))


def _ring_round_enc(stack, enc, scale, rs, ag, div, *, mode="model",
                    rs_dtype=None, levels=0):
    """The encoded table and its scales read, the round written, the
    stack read only at the blocks whose all-gather packet dropped (the
    fallback, none in "grad" mode), the masks and the divisor read; per
    element a decode, a gate and an add, and with ``levels > 0`` per
    partial element and hop after the first a divide, a rounding and a
    multiply."""
    G, n, s, d = stack.shape
    dropped = 0 if mode == "grad" else _zeros(ag, G * (n - 1) * s)
    flops = 3 * stack.numel()
    if levels:
        flops += 3 * (n - 1) * G * s * d
    return (flops,
            _nbytes(enc) + _nbytes(scale) + _nbytes(stack)
            + dropped * d * stack.element_size()
            + _nbytes(rs) + _nbytes(ag) + _nbytes(div))


def _ring_rank_hop(src, src_scale, rs_row, recv, recv_scale, div, *,
                   chunk, k, acc_dtype=torch.float32,
                   out_dtype=torch.float32, levels=0, last=False):
    """One hop on one rank: the chunk's k rows of ``src`` (and their
    scales), the received partial (and its scales) read; the hop's output
    written (the owner's divided chunk, a middle hop's partial, or its
    int8 re-encoding with a scale a row). The (S,) mask row and divisor
    (k + 4k bytes beside k·W) are left out. Per element a gate and an add;
    a decode per int8 operand; the divide on the last hop; a re-encode's
    divide, rounding and multiply."""
    W = src.shape[1]
    el_src = src.element_size()
    nbytes = k * W * el_src + (k * 4 if src_scale is not None else 0)
    if recv is not None:
        nbytes += _nbytes(recv) + _nbytes(recv_scale)
    if last:
        out_el = torch.empty((), dtype=out_dtype).element_size()
        nbytes += k * W * out_el
    elif levels:
        nbytes += k * W + k * 4
    else:
        nbytes += k * W * torch.empty((), dtype=acc_dtype).element_size()
    flops = 2 * k * W
    flops += k * W * ((src_scale is not None)
                      + (recv_scale is not None))
    if last:
        flops += k * W
    elif levels:
        flops += 3 * k * W
    return flops, nbytes


def _ring_rank_land(out, cur, ag_row, blocks, *, chunk, k, renorm):
    """One landing: the (k, W) chunk read and written into ``out``; this
    rank's rows of ``blocks`` read where the chunk's packets dropped
    (``renorm``). The mask row (k bytes) is left out. A select an
    element."""
    W = cur.shape[1]
    el = out.element_size()
    dropped = 0
    if renorm:
        rows = ag_row[chunk * k:(chunk + 1) * k]
        dropped = _zeros(rows, k)
    return k * W, k * W * cur.element_size() + k * W * el + dropped * W * el


_COSTS = {"masked_avg_grid": _masked_avg_grid, "tp_combine": _tp_combine,
          "rwkv6": _rwkv6, "rglru": _rglru, "ring_round": _ring_round,
          "ring_round_enc": _ring_round_enc,
          "ring_rank_hop": _ring_rank_hop,
          "ring_rank_land": _ring_rank_land}

#: the kernels' FLOP kinds: RWKV-6's products run on TF32 tensor cores
#: (split TF32 ``mma.sync``), every other kernel's arithmetic on the f32
#: cores
KERNEL_FLOP_KIND = {name: "f32" for name in _COSTS}
KERNEL_FLOP_KIND["rwkv6"] = "tf32"

KERNELS = tuple(_COSTS)


def kernel_cost(name: str, *args, **kwargs) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call of the hand-written kernel ``name``
    (one of :data:`KERNELS`, the wrappers' names; ``chip_smoke.py``'s
    ``ring_rank`` is ``ring_rank_hop`` and ``ring_rank_land``) on the
    wrapper's own arguments."""
    if name not in _COSTS:
        raise KeyError(f"no cost function for {name!r}; known: {KERNELS}")
    flops, nbytes = _COSTS[name](*args, **kwargs)
    return int(flops), int(nbytes)


def kernel_bound(name: str, flops: float, nbytes: float,
                 hw: HW = HW()) -> Tuple[float, str]:
    """The least seconds the card could take for a kernel's work — the
    larger of its bytes over HBM's rate and its operations over the peak
    of its kind — and which of the two bounds it ("bytes" or
    "operations")."""
    t_bytes = nbytes / hw.hbm_bw
    t_ops = flops / hw.peak(KERNEL_FLOP_KIND[name])
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
