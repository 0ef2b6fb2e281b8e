"""Layout rules per parameter leaf (port of :mod:`repro.launch.sharding`).

The JAX package turns these rules into ``PartitionSpec``s for its
compiler. The port runs one process per rank, so here they are layout
functions: a spec is a tuple with one entry per dim (None, an axis name,
or a tuple of names), and :func:`model_dims` says which dim of a leaf is
tensor-parallel — the dim the exchange plan keeps intact
(``plan.make_plan(model_dims=)``). On the port's trainer, tensor
parallelism inside a replica ("model" > 1) and FSDP (``fsdp_axis``) run
for every family:
:func:`shard_replica` cuts one rank's slice of every leaf along its
model dim and its FSDP dim, :func:`gather_replica` joins the slices
back, and :func:`local_model_dims` / :func:`local_fsdp_dims` tell the
model which leaves arrive sharded, along which dim.

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


def _fsdp_dim(path: str, shape: Tuple[int, ...], cfg: ArchConfig
              ) -> Optional[int]:
    """The dim of a leaf that FSDP lays over the data axis: the rule's
    second large dim, where it is not the model dim and divides by 16."""
    mdim, fdim = _rule(path, shape, cfg)
    if fdim is not None and fdim != mdim and shape[fdim] % 16 == 0:
        return fdim
    return None


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
        mdim = _rule(_path_str(path), shape, cfg)[0]
        fdim = _fsdp_dim(_path_str(path), shape, cfg) if fsdp_axis else None
        entries: list = [None] * len(shape)
        if mdim is not None:
            entries[mdim] = MODEL
        if fdim is not None:
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
                data_axes: Tuple[str, ...] = (), microbatch: int = 1) -> Any:
    """This rank's rows of a worker-stacked batch (n_rps, B_local, …) by
    :func:`batch_spec`: its worker's row of dim 0 (its index over
    ``worker_axes``), then its share of the B_local rows (its index over
    ``data_axes``, B_local split evenly). With ``microbatch`` > 1 (the
    trainer's) the share is taken microbatch by microbatch: the j-th
    ``microbatch`` part of the rank's rows is its share of the j-th
    contiguous part of B_local, the reference's microbatch j (whose rows
    the MoE's batch statistics span)."""
    w = mesh.axis_index(worker_axes) if worker_axes else 0
    parts = mesh.axis_size(data_axes) if data_axes else 1
    d = mesh.axis_index(data_axes) if data_axes else 0

    def pick(leaf):
        rows = leaf[w]
        if parts == 1:
            return rows
        if rows.shape[0] % (parts * microbatch):
            raise ValueError(f"{rows.shape[0]} rows over {parts} ranks "
                             f"and {microbatch} microbatches")
        per = rows.shape[0] // (parts * microbatch)
        rest = tuple(rows.shape[1:])
        return rows.reshape((microbatch, parts, per) + rest)[:, d] \
            .reshape((microbatch * per,) + rest)

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


def local_fsdp_dims(params_shape: Any, cfg: ArchConfig, mesh,
                    fsdp_axis: Optional[str] = "data") -> Any:
    """The dim of every leaf (a tree at its global, unstacked shapes) that
    :func:`param_specs` lays over ``fsdp_axis``, None where the leaf stays
    whole on every rank of the data group: all None without an
    ``fsdp_axis`` or when its extent is 1. A dim FSDP shards must divide
    by the axis (a ValueError naming the leaf)."""
    f = mesh.shape.get(fsdp_axis, 1) if fsdp_axis else 1

    def dim(path, leaf):
        if f == 1:
            return None
        d = _fsdp_dim(_path_str(path), tuple(leaf.shape), cfg)
        if d is not None and leaf.shape[d] % f:
            raise ValueError(f"{_path_str(path)}: FSDP dim {d} of "
                             f"{tuple(leaf.shape)} does not divide over "
                             f"the {fsdp_axis!r} axis of {f}")
        return d

    return _map_with_path(dim, params_shape)


def _zip_trees(fn, tree, *others):
    """``fn(leaf, *others' entries)`` over ``tree``'s leaves; the others
    are trees of its structure whose leaves may be None."""
    if isinstance(tree, dict):
        return {k: _zip_trees(fn, v, *[o[k] for o in others])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_trees(fn, v, *os)
                          for v, *os in zip(tree, *others))
    return fn(tree, *others)


def shard_replica(tree: Any, cfg: ArchConfig, mesh,
                  fsdp_axis: Optional[str] = None) -> Any:
    """This rank's slice of every leaf of one replica (global, unstacked
    shapes) along the model dim :func:`local_model_dims` gives it and the
    FSDP dim :func:`local_fsdp_dims` gives it: along each, the rank's
    contiguous part by its index over that axis (as GSPMD lays a dim over
    an axis), copied; a leaf that stays whole is the leaf itself."""
    cuts = [(mesh.shape[axis], mesh.axis_index(axis), dims)
            for axis, dims in ((MODEL, local_model_dims(tree, cfg, mesh)),
                               (fsdp_axis, local_fsdp_dims(tree, cfg, mesh,
                                                           fsdp_axis)))
            if axis is not None and mesh.shape.get(axis, 1) > 1]
    if not cuts:
        return tree

    def cut(x, *ds):
        y = x
        for (n, j, _), d in zip(cuts, ds):
            if d is not None:
                size = y.shape[d] // n
                y = y.narrow(d, j * size, size)
        return x if y is x else y.clone(memory_format=torch.contiguous_format)

    return _zip_trees(cut, tree, *[dims for _, _, dims in cuts])


def gather_replica(tree: Any, dims: Any, mesh, fsdp: Any = None) -> Any:
    """The inverse of :func:`shard_replica`: every sharded leaf of this
    rank's ``tree`` gathered over the data group along its FSDP dim
    (``fsdp``: the trainer's :class:`repro_torch.models.parallel.FSDP`,
    its group and its dims; None: no FSDP) and over the model group
    along its dim in ``dims`` (:func:`local_model_dims`), in the ranks'
    order; a whole leaf is the leaf itself. Collective: every rank of the
    world calls it."""
    from repro_torch.core import comm
    joins = []
    if fsdp is not None:
        joins.append((fsdp.group, fsdp.dims))
    if mesh.shape.get(MODEL, 1) > 1:
        joins.append((mesh.group((MODEL,)), dims))
    for group, ds in joins:
        tree = _zip_trees(lambda x, d, g=group: x if d is None else
                         comm.all_gather_dim(x, g, d).contiguous(), tree, ds)
    return tree
