"""Serving on a mesh: one rank's prefill and decode steps on its shards of
a replica, for every family (dense with and without experts, ssm,
hybrid, audio, vlm).

The counterpart is the JAX package's dry-run serving layout
(``src/repro/launch/dryrun.py:195–280``: ``_cache_spec_tree``,
``_serve_fsdp``, ``build_decode_lowered``, ``build_prefill_lowered``).
There ``model.prefill`` / ``model.decode_step`` are jitted with the
weights laid out by ``param_specs(worker_axes=(), fsdp_axis=
_serve_fsdp(cfg))`` and the batch's rows over ("pod", "data") (the whole
batch on every rank where B does not divide: ``P()``), and GSPMD derives
the partitioned step; the logits come back replicated. Here each rank
holds its shards (:meth:`MeshServe.shard`, ``sharding.shard_replica``)
and its rows (:meth:`MeshServe.local_rows`), and the model's serving
entry points run its part (``tp=``, ``fsdp=``, ``rows=``,
``models/registry.py``): Megatron's column- and row-parallel products
over the "model" group (:class:`repro_torch.models.parallel.TP`), each
layer's FSDP shards gathered over "data" for the layer
(:class:`repro_torch.models.parallel.FSDP`), the MoE's batch statistics
over the rows' group, the logits gathered whole on every rank.

One departure by design: the reference lays each cache leaf's last
dimension that divides by "model" over it (``hd`` for a K/V leaf,
``dv`` for RWKV-6's state, ``d`` for its token shifts, ``dr`` for the
RG-LRU's states); a rank here holds what its share of the layer
computes: the KV heads its query heads read (Megatron's layout, so with
fewer KV heads than model ranks a head is held on several ranks),
RWKV-6's state of its heads beside whole token shifts, the RG-LRU's
states of its dr channels (ROADMAP C). The values are the same.

The layout rules read a leading layer dim (``launch/sharding.py``), so
the serving tree (one dict a layer, in ``params["layers"]`` and the
audio model's ``params["enc_layers"]``) is laid out with a leading dim
of 1 on each layer's leaves (:func:`lead1`): a layer's dims are those of
the stacked layout, and its FSDP shards gather with ``lead=1``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm
from repro_torch.launch import sharding as shlib
from repro_torch.models import parallel as P


def serve_fsdp(cfg: ArchConfig) -> Optional[str]:
    """Serving param sharding: FSDP over "data" when the config asks for
    it, or when its bf16 params exceed a 16-way-TP HBM budget of 8e9 B
    (the reference's ``_serve_fsdp``)."""
    if cfg.shard_strategy == "fsdp":
        return "data"
    return "data" if cfg.param_count() * 2 / 16 > 8e9 else None


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch's rows lie over: ("pod", "data") where the mesh
    has them."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


STACKS = ("layers", "enc_layers")      # the serving tree's layer lists


def lead1(params) -> dict:
    """The serving tree with a leading dim of 1 on each layer's leaves
    (views) of every stack, the shapes the layout rules read."""
    return dict(params, **{k: [tree_lib.map(lambda t: t[None], layer)
                               for layer in params[k]]
                           for k in STACKS if k in params})


def _drop_lead(params) -> dict:
    """:func:`lead1` undone."""
    return dict(params, **{k: [tree_lib.map(lambda t: t[0], layer)
                               for layer in params[k]]
                           for k in STACKS if k in params})


def _by_kind(tree, model) -> dict:
    """A tree of the serving layout with each stack's layers keyed by
    their kinds (every layer of a kind is laid out alike): the names
    :class:`repro_torch.models.parallel.TP` reads ("rwkv/wr",
    "attn/wq", …)."""
    kinds = {"layers": model.kinds, "enc_layers": model.enc_kinds}
    return dict(tree, **{k: dict(zip(kinds[k], tree[k]))
                         for k in STACKS if k in tree})


def param_specs(params_shape, cfg: ArchConfig) -> Any:
    """The reference's serving spec tree of a stacked parameter tree
    (``Model.init_stacked``'s layout): TP over "model", FSDP over
    :func:`serve_fsdp`'s axis."""
    return shlib.param_specs(params_shape, cfg, worker_axes=(),
                             fsdp_axis=serve_fsdp(cfg))


@dataclasses.dataclass
class MeshServe:
    """One rank's serving contexts on ``mesh`` (:func:`make_serve`):
    ``tp`` over ("model",) (None on a model axis of 1), ``fsdp`` over
    "data" (None without FSDP; its dims those of :func:`lead1`'s view),
    ``data_group`` the group of the data axes (None where they are 1)."""
    model: Any
    mesh: Any
    fsdp_axis: Optional[str]
    tp: Optional[P.TP]
    fsdp: Optional[P.FSDP]
    data_group: Optional[comm.Group]

    @property
    def cfg(self) -> ArchConfig:
        return self.model.cfg

    def shard(self, params) -> dict:
        """This rank's shards of a serving replica (one dict a layer, at
        its global shapes): ``sharding.shard_replica`` on :func:`lead1`'s
        view, the leading dim dropped again."""
        return _drop_lead(shlib.shard_replica(lead1(params), self.cfg,
                                              self.mesh, self.fsdp_axis))

    def split(self, B: int) -> bool:
        """Whether a batch of ``B`` rows is split over the data axes (the
        reference's ``P(data_axes)``; else ``P()``: every rank the
        whole batch)."""
        n = self.mesh.axis_size(data_axes(self.mesh)) \
            if data_axes(self.mesh) else 1
        return n > 1 and B > 1 and B % n == 0

    def local_rows(self, B: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a batch of ``B``: its contiguous
        part by its index over the data axes, or all of them."""
        if not self.split(B):
            return 0, B
        axes = data_axes(self.mesh)
        per = B // self.mesh.axis_size(axes)
        lo = self.mesh.axis_index(axes) * per
        return lo, lo + per

    def local_inputs(self, inputs: dict) -> dict:
        """This rank's rows of every input (B leading: the tokens, the
        audio model's frames, the vlm's patches)."""
        B = next(iter(inputs.values())).shape[0]
        lo, hi = self.local_rows(B)
        return {k: v[lo:hi] for k, v in inputs.items()}

    def rows(self, B: int) -> Optional[comm.Group]:
        """The group a batch of ``B`` rows is split over (the MoE's
        ``rows``), None where every rank holds it whole."""
        return self.data_group if self.split(B) else None

    def init_cache(self, B: int, max_len: int) -> list:
        """This rank's empty decode cache for a batch of ``B`` rows: its
        rows, its share of each layer's (``Model.init_cache(tp=)``)."""
        lo, hi = self.local_rows(B)
        return self.model.init_cache(hi - lo, max_len, tp=self.tp)

    def prefill_step(self, shards, inputs, max_len=None):
        """The model's prefill on this rank's shards and its rows of the
        batch ``inputs`` (every rank passes the whole batch, as the
        reference's jitted step takes the global arrays): (the whole last
        logits of its rows, its cache)."""
        B = next(iter(inputs.values())).shape[0]
        return self.model.prefill(shards, self.local_inputs(inputs),
                                  max_len, tp=self.tp, fsdp=self.fsdp,
                                  rows=self.rows(B))

    def decode_step(self, shards, cache, inputs, pos):
        """The model's decode step on this rank's shards, its cache and
        its rows of ``inputs`` (the whole batch's {"token": (B, 1)}):
        (the whole logits of its rows, its cache)."""
        B = inputs["token"].shape[0]
        return self.model.decode_step(shards, cache,
                                      self.local_inputs(inputs), pos,
                                      tp=self.tp, fsdp=self.fsdp,
                                      rows=self.rows(B))


def make_serve(model, mesh) -> MeshServe:
    """This rank's serving contexts on ``mesh`` (a world's mesh, or a
    shape's through ``Mesh.as_rank``): the model's config laid out by
    :func:`param_specs`. The groups are built in one order on every rank
    (("model",), then the FSDP axis, then the data axes)."""
    from repro_torch.roofline.count import MetaGenerator
    cfg = model.cfg
    fsdp_axis = serve_fsdp(cfg)
    if fsdp_axis is not None and mesh.shape.get(fsdp_axis, 1) == 1:
        fsdp_axis = None
    meta = dataclasses.replace(model, device=torch.device("meta"))
    replica = lead1(meta.init(MetaGenerator()))
    tp = fsdp = None
    if mesh.shape.get(shlib.MODEL, 1) > 1:
        tp = P.TP.from_dims(mesh.group((shlib.MODEL,)), _by_kind(
            shlib.local_model_dims(replica, cfg, mesh), model))
    if fsdp_axis is not None:
        fsdp = P.FSDP(mesh.group((fsdp_axis,)), shlib.local_fsdp_dims(
            replica, cfg, mesh, fsdp_axis))
    axes = data_axes(mesh)
    group = mesh.group(axes) if axes and mesh.axis_size(axes) > 1 else None
    return MeshServe(model, mesh, fsdp_axis, tp, fsdp, group)
