"""Tensor parallelism inside a replica: the train path's sharded
products for every family (the mesh trainer on a "model" axis > 1); and
FSDP's context (:class:`FSDP`, the mesh trainer with ``fsdp_axis``).

The JAX package has no counterpart to this module: it lays each leaf
over the "model" mesh axis (``launch/sharding.py``'s rules) and GSPMD
derives the partitioned forward and backward. Here each rank of the
model group holds its slice of every sharded leaf
(``launch/sharding.py::shard_replica``) and the layers
(``models/layers.py``, ``rwkv6.py``, ``hybrid.py``, ``whisper.py``:
``tp=``) compute their part, Megatron-style: a column-parallel product
takes its replicated input through
:func:`repro_torch.core.comm.copy_to` (its gradient summed over the
group backward), a row-parallel product sends its partial output through
:func:`repro_torch.core.comm.reduce_from` (summed forward), and an
output split along a dim leaves through
:func:`repro_torch.core.comm.gather_from`. A product whose weight the
rule splits along its output dim but whose input arrives split too (the
MoE's width branch, RWKV-6's ``wo`` / ``cv``, RG-LRU's ``wa`` / ``wi`` /
``wo``) joins the input with :func:`repro_torch.core.comm.gather_shard`
(:func:`join`): each rank's output columns give it a partial gradient of
the whole input, which the backward's reduce-scatter sums. Everything
outside those regions is computed alike on every rank of the group, so
a replicated leaf's gradient, and so its value, is the same on every
rank bit for bit (every all-reduce hands each rank the same sum); a
replicated tensor that a rank's share reads (a whole leaf sliced to the
rank's channels among them: RWKV-6's decay and bonus, RG-LRU's ``lam``)
enters the region through ``copy_to``.

:class:`TP` carries the group and which leaves arrive sharded; the
vocab-parallel embedding (:func:`embed`), head's padding
(:func:`mask_vocab`) and
cross-entropy (:func:`softmax_xent`), and the local heads of a sharded
attention (:func:`local_kv`) live here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import comm

NEG_INF = -1e30


def check_family(cfg, size: int) -> None:
    """Raise unless ``cfg`` runs with tensor parallelism inside a
    replica over a model group of ``size`` ranks. Every family runs;
    refused by name is what the layout rule cannot give a rank whole:
    an RWKV-6 head split across ranks (the rule splits the time-mix's
    channels over "model", and a rank's channels must be whole heads)."""
    if cfg.family == "ssm" and cfg.d_model % 16 == 0 \
            and cfg.n_heads % size:
        raise ValueError(
            f"{cfg.name}: {cfg.n_heads} RWKV-6 heads over a 'model' axis "
            f"of {size} split a head across ranks (the rule lays the "
            "time-mix's channels over 'model'; each rank's channels must "
            "be whole heads)")


@dataclasses.dataclass(frozen=True)
class TP:
    """One rank's tensor-parallel context: ``group`` the model group (the
    ranks that share every other coordinate), ``dims`` the model dim of
    each sharded leaf by the last two names of its path ("embed/tok",
    "attn/wq", "mlp/wi", …; a whole leaf is absent)."""
    group: comm.Group
    dims: Dict[str, int]

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    def sharded(self, name: str) -> bool:
        return name in self.dims

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return comm.copy_to(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return comm.reduce_from(x, self.group)

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return comm.gather_from(x, self.group, dim)

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part of ``x``'s ``dim`` (a whole tensor
        that entered the region through :meth:`copy_to`)."""
        size = x.shape[dim] // self.size
        return x.narrow(dim, self.index * size, size)

    @classmethod
    def from_dims(cls, group: comm.Group, dims) -> "TP":
        """The context of a replica whose leaves' model dims are ``dims``
        (``sharding.local_model_dims``: a tree, None for a whole leaf).
        Every layer kind must shard a name alike."""
        flat: Dict[str, Optional[int]] = {}

        def walk(t, path):
            if isinstance(t, (dict, list, tuple)):
                items = t.items() if isinstance(t, dict) else enumerate(t)
                for k, v in items:
                    walk(v, path + (str(k),))
                return
            name = "/".join(path[-2:])
            if name in flat and flat[name] != t:
                raise ValueError(f"{name}: sharded on dims {flat[name]} and "
                                 f"{t} in different layers")
            flat[name] = t

        walk(dims, ())
        return cls(group, {k: d for k, d in flat.items() if d is not None})


def _any_leaf(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_leaf(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_leaf(v) for v in tree)
    return tree is not None


@dataclasses.dataclass(frozen=True)
class FSDP:
    """One rank's data-group context (the JAX package lays these leaves
    and the batch's rows over "data"; GSPMD gathers and reduce-scatters
    around each use). ``group``: the FSDP group (the ranks that share
    every coordinate but ``fsdp_axis``); ``dims``: the FSDP dim of every
    leaf of the parameter tree in the train layout
    (``sharding.local_fsdp_dims``; None where a leaf stays whole, or None
    for no sharded leaf)."""
    group: comm.Group
    dims: Any

    def at(self, key) -> "FSDP":
        """The context of the subtree under ``key`` (a stack)."""
        return dataclasses.replace(
            self, dims=None if self.dims is None else self.dims[key])

    def sub(self, key) -> Any:
        """The dims under ``key``, None where none of them is sharded."""
        if self.dims is None:
            return None
        dims = self.dims[key]
        return dims if _any_leaf(dims) else None

    def gather(self, tree, dims, lead: int = 0):
        """``tree`` with each sharded leaf's shards joined over the group
        (:func:`repro_torch.core.comm.gather_shard`, its gradient
        reduce-scattered back) along its dim in ``dims`` less ``lead``
        (the dims of a stacked tree, for one layer's slice of it)."""
        if isinstance(tree, dict):
            return {k: self.gather(v, dims[k], lead) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather(v, d, lead)
                              for v, d in zip(tree, dims))
        if dims is None:
            return tree
        return comm.gather_shard(tree, self.group, dims - lead)


def embed(tp: TP, tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup: ``tok`` this rank's rows [lo, lo + V/n)
    of the table; an id outside them reads a zero row, and the group's
    sum gives every rank the whole embedding."""
    Vl = tok.shape[0]
    local = tokens.long() - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    rows = tok[torch.where(inside, local, 0)]
    return tp.reduce_from(rows.masked_fill(~inside[..., None], 0))


def mask_vocab(tp: TP, logits_local: torch.Tensor,
               vocab_size: Optional[int]) -> torch.Tensor:
    """This rank's columns [lo, lo + V/n) of the logits with the padding
    past ``vocab_size`` masked to -1e30 by its global index."""
    Vl = logits_local.shape[-1]
    if vocab_size is None or vocab_size >= tp.size * Vl:
        return logits_local
    gidx = tp.index * Vl + torch.arange(Vl, device=logits_local.device)
    return logits_local.masked_fill(gidx >= vocab_size, NEG_INF)


def softmax_xent(tp: TP, logits_local: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean next-token cross-entropy in f32 over vocab-parallel
    logits (B, S, V/n): the shift is the group's max (no gradient), the
    normaliser the group's sum of exponentials, the gold logit the one
    rank's that holds the label; the same scalar on every rank."""
    lg = logits_local.to(torch.float32)
    Vl = lg.shape[-1]
    shift = comm.all_reduce_max(lg.amax(-1), tp.group)
    sumexp = tp.reduce_from(torch.exp(lg - shift[..., None]).sum(-1))
    local = labels.long() - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    gold = torch.gather(lg, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = tp.reduce_from(gold.masked_fill(~inside, 0.0))
    nll = torch.log(sumexp) + shift - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def kv_range(tp: TP, n_kv: int, n_heads: int):
    """The KV heads [lo, hi) this rank's query heads read: query head i
    reads KV head i // (h / kvh), and the rank holds query heads
    [j·h/n, (j+1)·h/n). A sharded ``wk`` / ``wv`` gives the rank just
    these heads; a whole one is cut to them (:func:`local_kv`)."""
    g = n_heads // n_kv
    h_loc = n_heads // tp.size
    if h_loc % g and g % h_loc:
        raise ValueError(f"{n_heads} query heads over {n_kv} KV heads: "
                         f"{h_loc} a rank straddle a KV head's group of {g}")
    first = tp.index * h_loc
    return first // g, (first + h_loc - 1) // g + 1


def local_kv(tp: TP, kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The KV heads this rank's query heads read (:func:`kv_range`), of a
    whole (B, S, kvh, hd) projection (GQA whose KV heads the rule keeps
    whole). The projection enters the region here, so the heads'
    gradients from every rank are summed into it."""
    lo, hi = kv_range(tp, kv.shape[2], n_heads)
    return tp.copy_to(kv)[:, :, lo:hi]


def join(tp: Optional[TP], h: torch.Tensor, split_in: bool,
         split_out: bool) -> torch.Tensor:
    """The input ``h`` (..., k) of a product whose weight (k, m) the rule
    splits along m where ``split_out``, made whole for it: ``split_in``,
    ``h`` is this rank's part of k (the last dim), joined over the group
    by :func:`repro_torch.core.comm.gather_shard` when the product's
    output columns are split (its gradient partial on every rank, summed
    by the backward's reduce-scatter) or by
    :func:`repro_torch.core.comm.gather_from` when they are not (the
    gradient whole and alike on every rank); not ``split_in``, ``h`` is
    whole and enters the region through ``copy_to`` when the output is
    split. ``h`` as it is without ``tp``."""
    if tp is None:
        return h
    if split_in:
        fn = comm.gather_shard if split_out else comm.gather_from
        return fn(h, tp.group, h.dim() - 1)
    return tp.copy_to(h) if split_out else h
