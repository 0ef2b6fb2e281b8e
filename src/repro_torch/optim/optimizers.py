"""Optimizers as (init, update) pairs over trees of tensors (port of
:mod:`repro.optim.optimizers`).

The paper trains with plain SGD, no momentum, no weight decay, so ``sgd``
is the default everywhere; ``momentum`` and ``adam`` are ported with
their state unpacked in f32 (the JAX package's ``state_pack="f32"``).
The packed formats (bf16, i8) are not ported yet and raise.

``update(grads, state, params, lr)`` returns ``(new_params, new_state)``
as the reference does, but it updates ``params`` and the state **in
place** (the reference donates both into its jitted step), so a 16-replica
model is never held twice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib

PACKS = ("f32",)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]   # (grads, state, params, lr)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def _sgd_update(grads, state, params, lr):
    # dtype-preserving, as the reference: p − (lr·g in f32) cast to p's
    # dtype, so bf16 params update in bf16
    for p, g in zip(tree_lib.leaves(params), tree_lib.leaves(grads)):
        p.sub_((lr * g.to(torch.float32)).to(p.dtype))
    return params, state


def sgd() -> Optimizer:
    return Optimizer(lambda params: (), _sgd_update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_lib.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        for p, m, g in zip(tree_lib.leaves(params), tree_lib.leaves(state),
                           tree_lib.leaves(grads)):
            m.mul_(beta).add_(g.to(torch.float32))
            p.copy_((p.to(torch.float32) - lr * m).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return {"m": tree_lib.map(z, params), "v": tree_lib.map(z, params),
                "t": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"] + 1
        # the bias corrections in f32, as the reference computes them
        bc1 = 1 - _f32(b1) ** _f32(t)
        bc2 = 1 - _f32(b2) ** _f32(t)
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
        state["t"] = t
        return params, state

    return Optimizer(init, update)


_OPTS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make_optimizer(name: str, state_pack: Optional[str] = None,
                   **kw) -> Optimizer:
    """Build an optimizer; ``state_pack`` other than "f32" (None) is not
    ported yet and raises."""
    if state_pack not in (None, "f32"):
        raise NotImplementedError(f"state_pack={state_pack!r} is not "
                                  f"ported yet; ported: {PACKS}")
    if name not in _OPTS:
        raise ValueError(f"optimizer {name!r}, want one of {sorted(_OPTS)}")
    return _OPTS[name](**kw)
