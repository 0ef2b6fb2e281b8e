"""Packed trainer state: quantised optimizer moments and EF residuals
(port of :mod:`repro.optim.statepack`).

Everything the step carries besides the parameters can be stored packed
at rest and decoded, updated and re-encoded inside the step:

  pack    momentum        second moments (v)       EF residual
  ------  --------------  -----------------------  -----------------------
  f32     f32 (identity)  f32 (identity)           f32 (identity)
  bf16    bf16            bf16                     bf16
  i8      bf16            int8 + per-row f32 Δ     int8 + per-row f32 Δ

Parameters are never packed. The int8 grid is the wire codec's
(:mod:`repro_torch.core.quant`): one scale per trailing-dim row
(``quant.row_lead``), stochastic rounding on every write so the packed
EMA stays unbiased (with round-to-nearest the small (1 − b2)·g² steps
would vanish below the grid step).

An i8-packed tree is two parallel trees ``{"q": tree, "scale": tree}``
with the unpacked tree's structure; the scales keep the reduced dims.
The f32 pack is a literal identity: ``pack_tree(t, "f32") is t``.

Torch cannot reproduce JAX's threefry stream, so the rounding noise is an
input: ``noise`` is a ``torch.Generator`` or a hook ``(leaf_idx, shape)
-> uniforms`` (the parity tests hand in the reference's
``uniform(fold_in(key, i), shape)``); ``None`` rounds to nearest-even,
as the reference does without a key. Eager PyTorch already runs leaf by
leaf, so the reference's leaf-sequencing conds (``leaf_pred``,
``sequenced_call``) have no counterpart here: the packed optimizers
decode, update and re-encode one leaf at a time, in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import quant as quant_lib
from repro_torch.telemetry import taps as taps_lib

I8_LEVELS = 127          # symmetric int8 grid {-127..127}, as the wire's

PACKS = ("f32", "bf16", "i8")

#: a ``torch.Generator`` or a ``(leaf_idx, shape) -> uniforms`` hook
Noise = Union[None, torch.Generator, Callable]


@dataclasses.dataclass(frozen=True)
class StatePack:
    """Per-component at-rest formats: ``m_format`` for first moments
    (momentum, Adam m), ``v_format`` for Adam's second moments,
    ``ef_format`` for the error-feedback residual; each "f32"
    (identity), "bf16" or "i8" (int8 payload + per-row f32 scales,
    stochastic rounding on write)."""
    name: str
    m_format: str = "f32"
    v_format: str = "f32"
    ef_format: str = "f32"

    @property
    def is_identity(self) -> bool:
        return self.m_format == self.v_format == self.ef_format == "f32"

    def describe(self) -> str:
        return (f"pack={self.name} m={self.m_format} v={self.v_format} "
                f"ef={self.ef_format}")


_PACKS = {
    "f32": StatePack("f32"),
    "bf16": StatePack("bf16", "bf16", "bf16", "bf16"),
    "i8": StatePack("i8", m_format="bf16", v_format="i8", ef_format="i8"),
}
_ALIASES = {"int8": "i8", "float32": "f32", "none": "f32",
            "bfloat16": "bf16"}


def canon_pack(name: Optional[str]) -> str:
    n = str(name or "f32").lower()
    n = _ALIASES.get(n, n)
    if n not in _PACKS:
        raise ValueError(f"unknown state pack {name!r} (have {PACKS})")
    return n


def make_state_pack(name: Optional[str] = None) -> StatePack:
    return _PACKS[canon_pack(name)]


def is_packed_i8(tree: Any) -> bool:
    """True iff ``tree`` is the {"q": ..., "scale": ...} i8 wrapper."""
    return isinstance(tree, dict) and set(tree) == {"q", "scale"}


def component_noise(noise, which: str) -> Noise:
    """A state-wide noise source narrowed to one component's: a hook
    ``(which, leaf_idx, shape) -> uniforms`` becomes ``(leaf_idx, shape)
    -> uniforms`` for ``which`` ("m", "v" or "ef"); a generator (or
    None) passes through."""
    if noise is None or isinstance(noise, torch.Generator):
        return noise
    return lambda i, shape: noise(which, i, shape)


def _leaf_noise(noise: Noise, i: int, shape: tuple) -> dict:
    """Leaf ``i``'s rounding source as ``quantize`` keywords."""
    if noise is None:
        return {}
    if isinstance(noise, torch.Generator):
        return {"gen": noise}
    return {"uniforms": noise(i, shape)}


def pack_leaf(x: torch.Tensor, fmt: str, uniforms=None,
              gen: Optional[torch.Generator] = None,
              consume: bool = False) -> tuple:
    """One leaf's at-rest representation as a tuple: ``(x,)`` for f32 and
    bf16, ``(q, scale)`` for i8 (stochastic rounding with ``uniforms`` or
    uniforms from ``gen``, nearest-even with neither). ``consume``: an
    f32 ``x`` may be overwritten by the i8 encode."""
    if fmt == "f32":
        return (x,)
    if fmt == "bf16":
        return (x.to(torch.bfloat16),)
    if fmt == "i8":
        return quant_lib.quantize(x, I8_LEVELS, torch.int8,
                                  uniforms=uniforms, gen=gen,
                                  lead=quant_lib.row_lead(x.dim()),
                                  consume=consume)
    raise ValueError(f"unknown pack format {fmt!r}")


def unpack_leaf(rep: tuple, fmt: str) -> torch.Tensor:
    """Inverse of :func:`pack_leaf`, back to f32 working precision (a new
    tensor except for the f32 format's identity)."""
    if fmt == "f32":
        return rep[0]
    if fmt == "bf16":
        return rep[0].to(torch.float32)
    if fmt == "i8":
        return rep[0].to(torch.float32).mul_(rep[1])
    raise ValueError(f"unknown pack format {fmt!r}")


def store_leaf(rep: tuple, x: torch.Tensor, fmt: str, noise: Noise = None,
               i: int = 0, consume: bool = False) -> None:
    """Encode ``x`` into the storage of the at-rest ``rep`` in place (so
    the old representation is not held beside the new one); leaf ``i``'s
    rounding comes from ``noise``."""
    new = pack_leaf(x, fmt, consume=consume,
                    **_leaf_noise(noise, i, tuple(x.shape)))
    for old, val in zip(rep, new):
        if old is not val:
            old.copy_(val)


def pack_tree(tree: Any, fmt: str, noise: Noise = None,
              tap: Optional[str] = None) -> Any:
    """Encode a tree of f32 buffers into its at-rest format, leaf by leaf
    (leaf i's uniforms from ``noise``). "f32" returns ``tree`` itself.
    With ``tap`` set and a tap collector installed, the write's
    quantisation-error norm ‖tree − unpack(pack(tree))‖ is tapped as
    ``quant_err_<tap>``; without a collector nothing is computed."""
    if fmt == "f32":
        return tree
    if fmt not in ("bf16", "i8"):
        raise ValueError(f"unknown pack format {fmt!r}")
    leaves, treedef = tree_lib.flatten(tree)
    reps = [pack_leaf(x, fmt, **_leaf_noise(noise, i, tuple(x.shape)))
            for i, x in enumerate(leaves)]
    packed = tree_from_reps(reps, fmt, treedef)
    if tap is not None and taps_lib.active() is not None:
        taps_lib.emit(f"quant_err_{tap}", quant_error_norm(tree, packed, fmt))
    return packed


def leaf_reps(packed: Any, fmt: str) -> list:
    """A packed tree as a list of per-leaf :func:`pack_leaf` tuples."""
    if fmt == "i8":
        return list(zip(tree_lib.leaves(packed["q"]),
                        tree_lib.leaves(packed["scale"])))
    return [(x,) for x in tree_lib.leaves(packed)]


def tree_from_reps(reps: list, fmt: str, treedef) -> Any:
    """The at-rest tree :func:`pack_tree` builds, from per-leaf tuples."""
    if fmt == "i8":
        return {"q": tree_lib.unflatten(treedef, [r[0] for r in reps]),
                "scale": tree_lib.unflatten(treedef, [r[1] for r in reps])}
    return tree_lib.unflatten(treedef, [r[0] for r in reps])


def unpack_tree(packed: Any, fmt: str) -> Any:
    """Decode an at-rest tree to f32 ("f32": the same tree object)."""
    if fmt == "f32":
        return packed
    if fmt not in ("bf16", "i8"):
        raise ValueError(f"unknown pack format {fmt!r}")
    if fmt == "i8":
        treedef = tree_lib.flatten(packed["q"])[1]
    else:
        treedef = tree_lib.flatten(packed)[1]
    return tree_lib.unflatten(treedef, [unpack_leaf(r, fmt)
                                        for r in leaf_reps(packed, fmt)])


def quant_error_norm(tree: Any, packed: Any, fmt: str) -> torch.Tensor:
    """‖tree − unpack(packed)‖ over all leaves, in f32, decoding one leaf
    at a time."""
    total = None
    for a, rep in zip(tree_lib.leaves(tree), leaf_reps(packed, fmt)):
        sq = leaf_error_sq(a, rep, fmt)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def leaf_error_sq(x: torch.Tensor, rep: tuple, fmt: str) -> torch.Tensor:
    """Σ (x − unpack(rep))² in f32: one leaf's squared encode error."""
    d = x.to(torch.float32) - unpack_leaf(rep, fmt).to(torch.float32)
    return torch.sum(d * d)


def tree_bytes(tree: Any) -> int:
    """At-rest bytes of a tree of tensors (``meta`` tensors included)."""
    return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))


def state_bytes_breakdown(params: Any = None, opt_state: Any = None,
                          ef_state: Any = None) -> dict:
    """Per-component at-rest byte counts, the reference's keys: packed i8
    components split payload (``opt_v``, ``ef``) from scales
    (``opt_v_scales``, ``ef_scales``)."""
    out: dict = {}
    if params is not None:
        out["params"] = tree_bytes(params)
    if opt_state is not None:
        if isinstance(opt_state, dict) and "m" in opt_state:
            # adam bundle {"m", "v", "t"}
            for comp in ("m", "v"):
                sub = opt_state[comp]
                if is_packed_i8(sub):
                    out[f"opt_{comp}"] = tree_bytes(sub["q"])
                    out[f"opt_{comp}_scales"] = tree_bytes(sub["scale"])
                else:
                    out[f"opt_{comp}"] = tree_bytes(sub)
            out["opt_t"] = tree_bytes(opt_state["t"])
        elif is_packed_i8(opt_state):
            out["opt_m"] = tree_bytes(opt_state["q"])
            out["opt_m_scales"] = tree_bytes(opt_state["scale"])
        else:
            out["opt_m"] = tree_bytes(opt_state)
    if ef_state is not None:
        if is_packed_i8(ef_state):
            out["ef"] = tree_bytes(ef_state["q"])
            out["ef_scales"] = tree_bytes(ef_state["scale"])
        else:
            out["ef"] = tree_bytes(ef_state)
    out["total"] = sum(out.values())
    return out
