"""Layout rules per parameter leaf (port of :mod:`repro.launch.sharding`).

The JAX package turns these rules into ``PartitionSpec``s for its
compiler. The port runs one process per RPS worker, each holding its whole
replica, so here they are layout functions: a spec is a tuple with one
entry per dim (None, an axis name, or a tuple of names), and
:func:`model_dims` says which dim of a leaf is tensor-parallel — the dim
the exchange plan keeps intact (``plan.make_plan(model_dims=)``).
Tensor parallelism inside a replica ("model" > 1) runs on the port's
trainer for the dense family without experts: :func:`shard_replica`
cuts one rank's slice of every leaf along its model dim,
:func:`gather_replica` joins the slices back, and
:func:`local_model_dims` tells the model which leaves arrive sharded.
FSDP is not run; its rules are kept so that the plan and the specs match
the reference's.

Rules are name-based over the parameter tree's paths ("embed/tok",
"layers/attn/wq", …). Two strategies (``ArchConfig.shard_strategy``):
"tp" — tensor-parallel over "model"; "fsdp" — tp plus a second large dim
over "data".

:func:`batch_spec` is the batch's layout (worker dim over the RPS axes,
rows over the data axes); :func:`local_batch` picks this rank's rows by
it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig

MODEL = "model"


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (the
    path: the keys and indices from the root)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _rule(path: str, shape: Tuple[int, ...], cfg: ArchConfig
          ) -> Tuple[Optional[int], Optional[int]]:
    """(model_dim, fsdp_dim) of a leaf (indices into ``shape``, without
    any stacked worker dim)."""
    nd = len(shape)
    last, last2 = nd - 1, nd - 2

    def fits(dim, axis=16):
        return shape[dim] % axis == 0

    # --- embeddings -------------------------------------------------------
    if path.endswith("embed/tok"):
        return (0 if fits(0) else None), None
    if path.endswith("embed/head"):
        return (last if fits(last) else None), None
    if "final_norm" in path or "/ln" in path or path.endswith("lam") \
            or "/mu" in path or path.endswith("w0") or path.endswith("/u"):
        return None, None
    # --- attention: (L, d, h, hd) / (L, h, hd, d) --------------------------
    if "attn/wq" in path or "attn/wk" in path or "attn/wv" in path:
        return (last2 if fits(last2) else None), (1 if nd >= 3 else None)
    if "attn/wo" in path:
        return (1 if nd >= 3 and fits(1) else None), (last if nd >= 3 else None)
    # --- MoE: router (L,d,E), experts (L,E,d,ff)/(L,E,ff,d) ----------------
    if "moe/router" in path:
        return None, None
    if "moe/" in path:
        e_dim = 1 if nd == 4 else 0
        if fits(e_dim):
            return e_dim, (e_dim + 1 if nd >= 3 else None)
        return (last if fits(last) else None), (last2 if nd >= 3 else None)
    # --- dense MLP: wi/wg (L,d,ff), wo (L,ff,d) ----------------------------
    if "mlp/wi" in path or "mlp/wg" in path:
        return (last if fits(last) else None), last2
    if "mlp/wo" in path:
        return (last2 if fits(last2) else None), last
    # --- rwkv (L,d,d) projections / lora ----------------------------------
    if "lora" in path:
        return None, None
    if any(path.endswith(s) for s in ("wr", "wk", "wv", "wg", "wo",
                                      "ck", "cv", "cr")):
        return (last if fits(last) else None), last2
    # --- hybrid rec block: wy/wx (L,d,dr), wa/wi (L,dr,dr), conv (L,4,dr) --
    if any(f"/{s}" in path for s in ("wy", "wx", "wa", "wi")):
        return (last if fits(last) else None), last2
    if path.endswith("conv"):
        return (last if fits(last) else None), None
    return None, None


def leaf_pin_spec(pstr: str, shape: Tuple[int, ...], cfg: ArchConfig
                  ) -> tuple:
    """One layer's (unstacked, worker-dim-free) spec of a leaf."""
    mdim, fdim = _rule(pstr, shape, cfg)
    entries: list = [None] * len(shape)
    if mdim is not None:
        entries[mdim] = MODEL
    if cfg.shard_strategy == "fsdp" and fdim is not None and fdim != mdim \
            and shape[fdim] % 16 == 0:
        entries[fdim] = "data"
    return tuple(entries)


def _lead(axes: Tuple[str, ...]):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def param_specs(params_shape: Any, cfg: ArchConfig, *,
                worker_axes: Tuple[str, ...] = (),
                fsdp_axis: Optional[str] = None,
                stacked: Optional[bool] = None) -> Any:
    """The spec tree of a (possibly worker-stacked) parameter tree (any
    leaves with a ``shape``: tensors, meta tensors). ``worker_axes``: the
    axes of the leading stacked-replica dim; a stacked tree whose worker
    dim is not split passes ``stacked=True`` with ``worker_axes=()``."""
    if stacked is None:
        stacked = bool(worker_axes)
    offset = 1 if stacked else 0

    def spec(path, leaf):
        shape = tuple(leaf.shape[offset:])
        mdim, fdim = _rule(_path_str(path), shape, cfg)
        entries: list = [None] * len(shape)
        if mdim is not None:
            entries[mdim] = MODEL
        if fsdp_axis and fdim is not None and fdim != mdim \
                and shape[fdim] % 16 == 0:
            entries[fdim] = fsdp_axis
        if stacked:
            entries = [_lead(tuple(worker_axes))] + entries
        return tuple(entries)

    return _map_with_path(spec, params_shape)


def model_dims(params_shape: Any, cfg: ArchConfig, *,
               stacked: bool = False) -> Any:
    """The tensor-parallel dim of every leaf in the per-worker view (the
    stacked dim excluded), None where it has none."""
    offset = 1 if stacked else 0
    return _map_with_path(
        lambda path, leaf: _rule(_path_str(path), tuple(leaf.shape[offset:]),
                                 cfg)[0], params_shape)


def batch_spec(batch_shape: Any, worker_axes: Tuple[str, ...],
               data_axes: Tuple[str, ...] = ()) -> Any:
    """The layout of a worker-stacked batch (n_rps, B_local, …): the
    worker dim over ``worker_axes`` (None when n_rps == 1), the
    per-worker rows over ``data_axes``."""
    def spec(path, leaf):
        entries: list = [_lead(tuple(worker_axes))]
        if data_axes:
            entries.append(_lead(tuple(data_axes)))
        entries += [None] * (len(leaf.shape) - len(entries))
        return tuple(entries[:len(leaf.shape)])

    return _map_with_path(spec, batch_shape)


def local_batch(batch: Any, mesh, worker_axes: Tuple[str, ...],
                data_axes: Tuple[str, ...] = ()) -> Any:
    """This rank's rows of a worker-stacked batch (n_rps, B_local, …) by
    :func:`batch_spec`: its worker's row of dim 0 (its index over
    ``worker_axes``), then its share of the B_local rows (its index over
    ``data_axes``, B_local split evenly)."""
    w = mesh.axis_index(worker_axes) if worker_axes else 0
    parts = mesh.axis_size(data_axes) if data_axes else 1
    d = mesh.axis_index(data_axes) if data_axes else 0

    def pick(leaf):
        rows = leaf[w]
        if parts == 1:
            return rows
        if rows.shape[0] % parts:
            raise ValueError(f"{rows.shape[0]} rows over {parts} ranks")
        per = rows.shape[0] // parts
        return rows[d * per:(d + 1) * per]

    return _map_with_path(lambda path, leaf: pick(leaf), batch)


def local_model_dims(params_shape: Any, cfg: ArchConfig, mesh) -> Any:
    """The dim of every leaf (a tree at its global, unstacked shapes) that
    is split over ``mesh``'s "model" axis, None where the leaf stays
    whole: :func:`model_dims`, all None when the axis is 1 or absent. A
    dim the rule shards must divide by the axis."""
    m = mesh.shape.get(MODEL, 1)

    def dim(path, leaf):
        d = _rule(_path_str(path), tuple(leaf.shape), cfg)[0]
        if d is None or m == 1:
            return None
        if leaf.shape[d] % m:
            raise ValueError(f"{_path_str(path)}: dim {d} of "
                             f"{tuple(leaf.shape)} over a model axis of {m}")
        return d

    return _map_with_path(dim, params_shape)


def _zip_dims(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _zip_dims(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_dims(fn, v, d) for v, d in zip(tree, dims))
    return fn(tree, dims)


def shard_replica(tree: Any, cfg: ArchConfig, mesh) -> Any:
    """This rank's slice of every leaf of one replica (global, unstacked
    shapes) along the model dim :func:`local_model_dims` gives it: the
    rank's contiguous part of that dim, by its index over "model" (as
    GSPMD lays a dim over an axis), copied; a leaf that stays whole is
    the leaf itself."""
    m = mesh.shape.get(MODEL, 1)
    if m == 1:
        return tree
    j = mesh.axis_index(MODEL)

    def cut(x, d):
        if d is None:
            return x
        size = x.shape[d] // m
        return x.narrow(d, j * size, size).clone(
            memory_format=torch.contiguous_format)

    return _zip_dims(cut, tree, local_model_dims(tree, cfg, mesh))


def gather_replica(tree: Any, dims: Any, mesh) -> Any:
    """The inverse of :func:`shard_replica`: every sharded leaf of this
    rank's ``tree`` gathered over the model group along its dim in
    ``dims`` (:func:`local_model_dims` of the replica), in the ranks'
    order; a whole leaf is the leaf itself. Collective: every rank of the
    world calls it."""
    from repro_torch.core import comm
    if mesh.shape.get(MODEL, 1) == 1:
        return tree
    group = mesh.group((MODEL,))

    def join(x, d):
        if d is None:
            return x
        moved = x.movedim(d, 0)
        full = comm.all_gather(moved, group)
        return full.movedim(0, d).contiguous()

    return _zip_dims(join, tree, dims)
