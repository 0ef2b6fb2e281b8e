"""Parameters of the JAX package, as numpy arrays, to the port's layout.

The JAX package stacks each layer kind's parameters along a leading axis
(``{"embed": {tok, head, final_norm}, "layers": {kind: stacked}}``); the
port keeps one dict per layer, in faithful order. :func:`params_from_jax`
scatters every kind's group back to its layer indices by the same
first-appearance rule the JAX package stacks them by (``group_layout``).
The tests use it to run both packages on the same weights, for every
ported family (the dense kinds, the MoE kinds, RWKV-6's rwkv kind,
RecurrentGemma's rec and attn kinds; nested dicts such as a layer's
``mlp`` or ``moe`` — the f32 (d, E) ``router`` and the expert-first
``wi`` / ``wg`` / ``wo`` — and f32 leaves such as ``lam`` carry across as
they are).

The train path keeps the JAX package's stacked layout, and
:func:`stacked_params_from_jax` carries any tree across in it, leaf for
leaf (one worker's parameters or an n-worker stack alike).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import kind_sequence
from repro_torch.models.stack import group_layout


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # numpy has no bf16: go by bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The port's parameters from the JAX package's tree of numpy arrays."""
    device = resolve_device(device)
    layout = group_layout(kind_sequence(cfg))
    layers = [None] * cfg.n_layers
    for kind, idxs in layout.items():
        stacked = np_params["layers"][kind]
        for j, li in enumerate(idxs):
            layers[li] = _map(lambda a, j=j: _tensor(np.asarray(a)[j], device),
                              stacked)
    embed = _map(lambda a: _tensor(a, device), np_params["embed"])
    return {"embed": embed, "layers": layers}


def stacked_params_from_jax(np_params, device="cuda"):
    """Any tree of the JAX package's numpy arrays (nested dicts, e.g. the
    stacked train-layout parameters) as tensors in the same layout."""
    device = resolve_device(device)
    return _map(lambda a: _tensor(a, device), np_params)
