"""Optimizers as (init, update) pairs over trees of tensors (port of
:mod:`repro.optim.optimizers`).

The paper trains with plain SGD, no momentum, no weight decay, so ``sgd``
is the default everywhere; ``momentum`` and ``adam`` are the substrate of
the beyond-paper experiments. Their state lives packed at rest
(:mod:`repro_torch.optim.statepack`): under a bf16 or i8 pack ``update``
decodes one leaf, updates it and re-encodes it in place before the next
leaf, so no whole-tree f32 copy of the moments ever exists. The f32 pack
is the identity and runs the unpacked update unchanged.

``update(grads, state, params, lr, noise=None)`` returns ``(new_params,
new_state)`` as the reference does, but it updates ``params`` and the
state **in place** (the reference donates both into its jitted step), so
a 16-replica model is never held twice. ``noise`` feeds the i8 pack's
stochastic rounding: a ``torch.Generator``, or a hook ``(which, leaf_idx,
shape) -> uniforms`` with ``which`` "m" or "v" (the reference's
``uniform(fold_in(fold_in(key, 0x6d or 0x76), i), shape)``); ``None``
rounds to nearest-even. With a tap collector installed, a packed update
taps its write's quantisation-error norm as ``quant_err_opt_m`` /
``quant_err_opt_v``, as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import quant as quant_lib
from repro_torch.optim import statepack as statepack_lib
from repro_torch.telemetry import taps as taps_lib


def _emit_quant_err(tap: str, err_sq: list) -> None:
    """The per-leaf squared encode errors as the ``quant_err_<tap>``
    counter ``statepack.pack_tree`` taps."""
    if err_sq:
        taps_lib.emit(f"quant_err_{tap}", torch.sqrt(sum(err_sq)))


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]   # (grads, state, params, lr,
                                             #  noise=None)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def _sgd_update(grads, state, params, lr, noise=None):
    # dtype-preserving, as the reference: p − (lr·g in f32) cast to p's
    # dtype, so bf16 params update in bf16
    for p, g in zip(tree_lib.leaves(params), tree_lib.leaves(grads)):
        p.sub_((lr * g.to(torch.float32)).to(p.dtype))
    return params, state


def sgd(pack: Optional[statepack_lib.StatePack] = None) -> Optimizer:
    del pack  # stateless: nothing to store, nothing to pack
    return Optimizer(lambda params: (), _sgd_update)


def _init_packed(params, fmt: str) -> Any:
    """A zero tree in the at-rest format ``fmt``, built leaf by leaf so
    only one leaf's f32 zeros exist at a time."""
    leaves, treedef = tree_lib.flatten(params)
    reps = [statepack_lib.pack_leaf(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device), fmt)
        for p in leaves]
    return statepack_lib.tree_from_reps(reps, fmt, treedef)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, in place. CUDA's ``sqrtf``
    is IEEE; PyTorch's vectorised CPU sqrt can be one ulp off, so on the
    CPU it runs in f64 (exact after rounding back to f32: f64 carries
    more than 2·24 + 2 bits)."""
    if x.device.type == "cuda":
        return x.sqrt_()
    return x.copy_(x.double().sqrt_())


def _apply_step(p: torch.Tensor, step: torch.Tensor) -> None:
    """p ← (p in f32 − step) in p's dtype, in place."""
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_((p.to(torch.float32) - step).to(p.dtype))


def momentum(beta: float = 0.9,
             pack: Optional[statepack_lib.StatePack] = None) -> Optimizer:
    pk = pack or statepack_lib.make_state_pack()
    fmt = pk.m_format

    def init(params):
        return _init_packed(params, fmt)

    @torch.no_grad()
    def update(grads, state, params, lr, noise=None):
        if pk.is_identity:
            for p, m, g in zip(tree_lib.leaves(params),
                               tree_lib.leaves(state),
                               tree_lib.leaves(grads)):
                m.mul_(beta).add_(g.to(torch.float32))
                p.copy_((p.to(torch.float32) - lr * m).to(p.dtype))
            return params, state
        # packed: decode -> update -> encode, one leaf at a time
        m_noise = statepack_lib.component_noise(noise, "m")
        collect = taps_lib.active() is not None and fmt != "f32"
        err_sq = []
        for i, (p, rep, g) in enumerate(zip(
                tree_lib.leaves(params),
                statepack_lib.leaf_reps(state, fmt),
                tree_lib.leaves(grads))):
            m = statepack_lib.unpack_leaf(rep, fmt)
            m.mul_(beta).add_(g.to(torch.float32))
            _apply_step(p, lr * m)
            statepack_lib.store_leaf(rep, m, fmt, m_noise, i,
                                     consume=not collect)
            if collect:
                err_sq.append(statepack_lib.leaf_error_sq(m, rep, fmt))
            del m
        _emit_quant_err("opt_m", err_sq)
        return params, state

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         pack: Optional[statepack_lib.StatePack] = None) -> Optimizer:
    pk = pack or statepack_lib.make_state_pack()
    m_fmt, v_fmt = pk.m_format, pk.v_format

    def init(params):
        # two distinct zero trees, and the step count an int32 scalar as
        # the reference stores it
        return {"m": _init_packed(params, m_fmt),
                "v": _init_packed(params, v_fmt),
                "t": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, lr, noise=None):
        t = state["t"] + 1
        # the bias corrections in f32, as the reference computes them
        bc1 = 1 - _f32(b1) ** _f32(t)
        bc2 = 1 - _f32(b2) ** _f32(t)
        state["t"] = t
        if pk.is_identity:
            for p, m, v, g in zip(tree_lib.leaves(params),
                                  tree_lib.leaves(state["m"]),
                                  tree_lib.leaves(state["v"]),
                                  tree_lib.leaves(grads)):
                gf = g.to(torch.float32)
                m.mul_(b1).add_((1 - b1) * gf)
                v.mul_(b2).add_((1 - b2) * (gf * gf))
                step = lr * (m / bc1.to(m.device)) \
                    / (torch.sqrt(v / bc2.to(v.device)) + eps)
                p.copy_((p.to(torch.float32) - step).to(p.dtype))
            return params, state
        # packed: decode -> update -> encode, one leaf at a time, the
        # working set one leaf's m, v and denominator
        m_noise = statepack_lib.component_noise(noise, "m")
        v_noise = statepack_lib.component_noise(noise, "v")
        collect = taps_lib.active() is not None
        collect_m = collect and m_fmt != "f32"
        collect_v = collect and v_fmt != "f32"
        m_err, v_err = [], []
        for i, (p, mrep, vrep, g) in enumerate(zip(
                tree_lib.leaves(params),
                statepack_lib.leaf_reps(state["m"], m_fmt),
                statepack_lib.leaf_reps(state["v"], v_fmt),
                tree_lib.leaves(grads))):
            gf = g.to(torch.float32)
            m = statepack_lib.unpack_leaf(mrep, m_fmt)
            if m is mrep[0]:            # the f32 format: update a copy
                m = m.clone()
            m.mul_(b1).add_((1 - b1) * gf)
            statepack_lib.store_leaf(mrep, m, m_fmt, m_noise, i)
            if collect_m:
                m_err.append(statepack_lib.leaf_error_sq(m, mrep, m_fmt))
            v = statepack_lib.unpack_leaf(vrep, v_fmt)
            if v is vrep[0]:
                v = v.clone()
            v.mul_(b2).add_((1 - b2) * (gf * gf))
            den = v
            if v_fmt == "i8":
                # resolution floor, as the reference: the denominator is
                # trusted down to one grid step of the stored v (its new
                # scale); the stored EMA stays unfloored
                den = torch.maximum(v, quant_lib.block_delta(
                    v, statepack_lib.I8_LEVELS, quant_lib.row_lead(v.dim())))
            den = _sqrt_(den / bc2.to(v.device)).add_(eps)
            m.div_(bc1.to(m.device)).mul_(lr).div_(den)
            del den
            _apply_step(p, m)
            del m
            statepack_lib.store_leaf(vrep, v, v_fmt, v_noise, i,
                                     consume=not collect_v)
            if collect_v:
                v_err.append(statepack_lib.leaf_error_sq(v, vrep, v_fmt))
            del v
        _emit_quant_err("opt_m", m_err)
        _emit_quant_err("opt_v", v_err)
        return params, state

    return Optimizer(init, update)


_OPTS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make_optimizer(name: str, state_pack: Optional[str] = None,
                   **kw) -> Optimizer:
    """Build an optimizer; ``state_pack`` names the at-rest format of its
    state ("f32" default, "bf16", "i8")."""
    pack = statepack_lib.make_state_pack(state_pack)
    if name not in _OPTS:
        raise ValueError(f"optimizer {name!r}, want one of {sorted(_OPTS)}")
    return _OPTS[name](pack=pack, **kw)
