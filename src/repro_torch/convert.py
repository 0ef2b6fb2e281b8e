"""Parameters of the JAX package, as numpy arrays, to the port's layout.

The JAX package stacks each layer kind's parameters along a leading axis
(``{"embed": {tok, head, final_norm}, "layers": {kind: stacked}}``); the
port keeps one dict per layer, in faithful order. :func:`params_from_jax`
scatters every kind's group back to its layer indices by the same
first-appearance rule the JAX package stacks them by (``group_layout``).
The tests use it to run both packages on the same weights, for every
family (the dense kinds, the MoE kinds, RWKV-6's rwkv kind,
RecurrentGemma's rec and attn kinds, Whisper's ``enc_layers`` stack and
its xattn kind with ``lnx`` and the ``xattn`` projections; nested dicts
such as a layer's ``mlp`` or ``moe`` — the f32 (d, E) ``router`` and the
expert-first ``wi`` / ``wg`` / ``wo`` — and f32 leaves such as ``lam``
carry across as they are).

The train path keeps the JAX package's stacked layout, and
:func:`stacked_params_from_jax` carries any tree across in it, leaf for
leaf (one worker's parameters or an n-worker stack alike). On a mesh
with a "model" axis > 1 or with FSDP, :func:`shards_from_jax` carries
one replica into one rank's shards and :func:`replica_to_numpy` gathers
a world's shards back into the replica, to be held against the
reference's global arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding
from repro_torch.models.registry import enc_kind_sequence, kind_sequence
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


def _unstack(groups: dict, kinds, device) -> list:
    """{kind: stacked leaves} -> one dict per layer, in faithful order."""
    layers = [None] * len(kinds)
    for kind, idxs in group_layout(kinds).items():
        for j, li in enumerate(idxs):
            layers[li] = _map(lambda a, j=j: _tensor(np.asarray(a)[j], device),
                              groups[kind])
    return layers


def params_from_jax(np_params: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The port's parameters from the JAX package's tree of numpy arrays
    (with the audio model's encoder stack, ``enc_layers``)."""
    device = resolve_device(device)
    out = {"embed": _map(lambda a: _tensor(a, device), np_params["embed"]),
           "layers": _unstack(np_params["layers"], kind_sequence(cfg),
                              device)}
    enc = enc_kind_sequence(cfg)
    if enc:
        out["enc_layers"] = _unstack(np_params["enc_layers"], enc, device)
    return out


def stacked_params_from_jax(np_params, device="cuda"):
    """Any tree of the JAX package's numpy arrays (nested dicts, e.g. the
    stacked train-layout parameters) as tensors in the same layout."""
    device = resolve_device(device)
    return _map(lambda a: _tensor(a, device), np_params)


def shards_from_jax(np_params, cfg: ArchConfig, mesh, device="cuda",
                    fsdp_axis=None):
    """One replica of the JAX package's stacked train-layout parameters
    (global arrays) as this rank's shards on ``mesh``, over "model" and
    over ``fsdp_axis`` (``sharding.shard_replica``)."""
    full = stacked_params_from_jax(np_params, "cpu")
    device = resolve_device(device)
    return tree_lib.map(lambda x: x.to(device),
                        sharding.shard_replica(full, cfg, mesh, fsdp_axis))


def replica_to_numpy(params, dims, mesh, fsdp=None):
    """This rank's shards gathered over its data group (``fsdp``: the
    trainer's ``train_step.fsdp``) and its model group (``dims``:
    ``train_step.model_dims``) into the whole replica
    (``sharding.gather_replica``), as numpy arrays (bf16 as f32).
    Collective: every rank of the world calls it."""
    def arr(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()

    return tree_lib.map(arr, sharding.gather_replica(params, dims, mesh,
                                                     fsdp))
