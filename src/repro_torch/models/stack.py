"""Layer-stack machinery (port of :mod:`repro.models.stack`), faithful
layer order only.

An architecture is a *kind sequence*, one entry per layer: dense kinds
(``"attn"``, ``"attn@<window>"``, and with an MoE FFN ``"moe_attn"``,
``"moe_attn@<window>"``; :mod:`repro_torch.models.transformer`),
the RWKV-6 kind (``"rwkv"``, :mod:`repro_torch.models.rwkv6`), the
RG-LRU kind (``"rec"``, :mod:`repro_torch.models.hybrid`) and Whisper's
encoder and cross-attention decoder kinds (``"enc"``, ``"xattn"``,
:mod:`repro_torch.models.whisper`). The JAX
package can also run the layers grouped by kind (one scan per group);
for gemma3's 5:1 pattern that runs all local layers before the global
ones, which is not the model's order. The port follows the ungrouped,
faithful path (``build_model(cfg, grouped=False)``). For serving,
parameters and caches are plain lists with one entry per layer, in order.
The train path keeps the JAX package's stacked layout instead
(``{kind: leaves with a leading per-kind layer dim}``,
:func:`stack_layers`): the exchange partitions each leaf into server
blocks, so only that layout puts the blocks, the buckets and the drop
masks on the same elements as the reference. :func:`apply_stack_train`
reads layer l's weights as views into the stacked leaves (each leaf
unbound once, so that its backward stacks the layers' gradients in one
op); it runs every
kind (rwkv and rec on the reference's XLA-route recurrences,
:mod:`repro_torch.kernels.ops`), each with tensor parallelism inside a
replica too (``tp``, :mod:`repro_torch.models.parallel`), and sums the
MoE layers' aux losses.
``aux`` carries the side inputs of the kinds that read them: the
encoder output ``enc_out`` for ``xattn``. Under FSDP
(:class:`repro_torch.models.parallel.FSDP`) each layer whose leaves
arrive as shards runs checkpointed: its shards are all-gathered over the
data group as the loop takes it, the gathered weights and the layer's
activations are freed after its forward, and its backward gathers them
again and reduce-scatters the whole weights' gradient to the shards (the
reference's per-layer ``jax.checkpoint`` recomputes the layer's forward
in its backward too).

Which kinds serve on which cache:

- the contiguous cache (``prefill(paged=False)``, ``decode``, the
  static-batch engine): every kind — the dense kinds' ring-buffer or
  ``max_len`` KV cache, rwkv's state and token shifts, rec's conv state
  and f32 carry, xattn's self K/V padded to ``max_len`` and its cross
  K/V (the encoder's ``enc`` layers run in prefill only);
- the paged pool (``decode_paged``, the continuous engine): the dense
  kinds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid as H
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W

RECURRENT = {"rwkv": R, "rec": H}     # kinds with no KV cache


def group_layout(kinds: Sequence[str]) -> Dict[str, List[int]]:
    """kind name -> faithful layer indices, in first-appearance order (the
    rule the JAX package stacks its parameter groups by)."""
    out: Dict[str, List[int]] = {}
    for i, k in enumerate(kinds):
        out.setdefault(k, []).append(i)
    return out


def _no_paged(kind: str, what: str) -> None:
    if kind in RECURRENT or kind in W.KINDS:
        raise ValueError(f"kind {kind!r} has no paged {what}")


def init_stack(gen: torch.Generator, cfg: ArchConfig,
               kinds: Sequence[str]) -> list:
    """Per-layer parameter dicts, drawn in layer order from ``gen``."""
    init = {"rwkv": R.init_rwkv, "rec": H.init_rec, "enc": W.init_enc,
            "xattn": W.init_xattn}
    return [init[k](gen, cfg) if k in init
            else T.init_layer(gen, cfg, moe=T.is_moe(k)) for k in kinds]


def stack_layers(layers: Sequence[dict], kinds: Sequence[str]) -> dict:
    """Per-layer parameter dicts -> {kind: stacked leaves}, each kind's
    layers stacked along a new leading dim in faithful order (the JAX
    package's ``init_stack`` layout)."""
    return {kind: tree_lib.map(lambda *xs: torch.stack(xs),
                               *[layers[i] for i in idxs])
            for kind, idxs in group_layout(kinds).items()}


def _train_layer(kind: str, p, x, cfg: ArchConfig, aux, tp, rows):
    """One layer of the train pass: (x, its aux loss or None)."""
    if kind in RECURRENT:
        return RECURRENT[kind].train(p, x, cfg, tp), None
    if kind == "enc":
        return W.enc_train(p, x, cfg, tp), None
    if kind == "xattn":
        return W.xattn_train(p, x, aux["enc_out"], cfg, tp), None
    return T.train(p, x, cfg, T.window_of(kind), tp, rows)


def apply_stack_train(params: dict, x, cfg: ArchConfig,
                      kinds: Sequence[str], aux: Optional[dict] = None,
                      tp=None, fsdp=None, rows=None):
    """The train-mode pass over the stacked layout, in faithful order
    (the JAX package's ``apply_stack(mode="train", grouped=False)``);
    ``aux["enc_out"]`` is the encoder output the ``xattn`` layers attend
    to; ``tp`` runs this rank's share of every kind's sharded layers
    (the dense kinds' attention, MLP and MoE FFN; rwkv's time-mix and
    channel-mix, rec's recurrent block, the Whisper kinds' self- and
    cross-attention); ``fsdp`` (its ``dims``
    those of ``params``) gathers each layer's FSDP shards and checkpoints
    the layer (see the module's docstring); ``rows`` spans the MoE's
    batch statistics over a group (``models/layers.py::moe_route``).
    Returns (x, the summed per-layer aux loss, f32)."""
    pos = {kind: 0 for kind in params}
    # each stacked leaf split into its layers once: the backward stacks
    # the layers' gradients in one op (a slice a layer would write a
    # zero-filled stack per layer)
    split = {}
    for kind, tree in params.items():
        leaves, treedef = tree_lib.flatten(tree)
        split[kind] = (treedef, [torch.unbind(a) for a in leaves])
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind in kinds:
        i = pos[kind]
        pos[kind] += 1
        treedef, layers = split[kind]
        p = tree_lib.unflatten(treedef, [ls[i] for ls in layers])
        dims = None if fsdp is None else fsdp.sub(kind)
        if dims is not None:
            # after the slice, a stacked leaf's FSDP dim d is d - 1
            def run(x, p=p, kind=kind, dims=dims):
                full = fsdp.gather(p, dims, lead=1)
                return _train_layer(kind, full, x, cfg, aux, tp, rows)
            x, al = checkpoint(run, x, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, al = _train_layer(kind, p, x, cfg, aux, tp, rows)
        if al is not None:
            aux_loss = aux_loss + al
    return x, aux_loss


def _serve_layer(fsdp, i: int, p):
    """Layer ``i``'s weights for a serving pass: its FSDP shards gathered
    over the data group (``fsdp.dims[i]``, ``fsdp`` the stack's context:
    the dims of the layer's leaves with a leading layer dim of 1), else
    ``p``."""
    dims = None if fsdp is None else fsdp.sub(i)
    return p if dims is None else fsdp.gather(p, dims, lead=1)


def apply_stack(params: list, x, cfg: ArchConfig, kinds: Sequence[str], *,
                mode: str, cache=None, pos=None, paged=None,
                max_len: Optional[int] = None, aux: Optional[dict] = None,
                tp=None, fsdp=None, rows=None):
    """Run every layer in faithful order (``aux["enc_out"]``: the encoder
    output that ``xattn`` prefills attend to; its decode reads the cross
    K/V from the cache).

    prefill:      returns (x, per-layer caches); ``paged`` truthy keeps
                  every position's K/V for the slot pool (dense kinds),
                  falsy gives the contiguous decode cache (``max_len``
                  sizes the global layers' KV cache);
    decode:       one step at position ``pos`` against the contiguous
                  cache; returns (x, per-layer caches), the dense kinds'
                  K/V written in place;
    decode_paged: one step against the paged pool; returns (x, pool),
                  the pool written in place.

    On a mesh (prefill and decode, every kind): ``tp`` runs this rank's
    share of each layer (its caches hold the KV heads its query heads
    read, rwkv's state its heads, rec's states its dr channels);
    ``fsdp`` (its ``dims`` those of ``params`` with a
    leading layer dim of 1 a leaf) gathers each layer's shards over the
    data group before the layer and drops them after it (no checkpoint:
    the pass has no gradient); ``rows`` spans the MoE's batch statistics
    over the group the batch's rows are split over.
    """
    if mode == "prefill":
        caches = []
        for i, (p, kind) in enumerate(zip(params, kinds)):
            full = _serve_layer(fsdp, i, p)
            if kind in RECURRENT:
                x, c = RECURRENT[kind].prefill(full, x, cfg, tp)
            elif kind == "enc":
                x, c = W.enc_train(full, x, cfg, tp), {}
            elif kind == "xattn":
                x, c = W.xattn_prefill(full, x, aux["enc_out"], cfg,
                                       max_len=max_len, tp=tp)
            else:
                x, c = T.prefill(full, x, cfg, T.window_of(kind),
                                 paged=bool(paged), max_len=max_len, tp=tp,
                                 rows=rows)
            del full
            caches.append(c)
        return x, caches
    if mode == "decode":
        caches = []
        for i, (p, kind, cache_l) in enumerate(zip(params, kinds, cache)):
            if kind == "enc":
                raise ValueError("kind 'enc' never decodes")
            full = _serve_layer(fsdp, i, p)
            if kind in RECURRENT:
                x, c = RECURRENT[kind].decode(full, x, cache_l, cfg, tp)
            elif kind == "xattn":
                x, c = W.xattn_decode(full, x, cache_l, pos, cfg, tp)
            else:
                x, c = T.decode(full, x, cache_l, pos, cfg,
                                T.window_of(kind), tp, rows)
            del full
            caches.append(c)
        return x, caches
    if mode == "decode_paged":
        for p, kind, cache_l in zip(params, kinds, cache):
            _no_paged(kind, "decode path")
            x = T.decode_paged(p, x, cache_l, pos, paged, cfg,
                               T.window_of(kind))
        return x, cache
    raise ValueError(f"mode={mode!r}, want prefill, decode or decode_paged")


def init_cache(cfg: ArchConfig, kinds: Sequence[str], batch: int,
               max_len: int, device, tp=None) -> list:
    """Per-layer empty contiguous decode caches (``tp``: a rank's share,
    as each kind's prefill leaves it — the KV heads its query heads
    read, rwkv's heads, rec's dr channels)."""
    out = []
    for kind in kinds:
        if kind in RECURRENT:
            out.append(RECURRENT[kind].cache_spec(cfg, batch, device, tp))
        elif kind == "xattn":
            out.append(W.xattn_cache_spec(cfg, batch, max_len, device, tp))
        elif kind == "enc":
            out.append({})
        else:
            out.append(T.cache_spec(cfg, batch, max_len, T.window_of(kind),
                                    device, tp))
    return out


def init_paged(cfg: ArchConfig, kinds: Sequence[str], n_slots: int,
               device) -> list:
    """The paged slot pool: per layer {"k", "v": (n_slots, kvh, hd),
    "layer_id": faithful index} — the layer id picks the layer's
    collective sites' drop masks."""
    shape = (n_slots, cfg.n_kv_heads, cfg.hd)
    for kind in kinds:
        _no_paged(kind, "cache spec")
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "layer_id": i}
            for i in range(len(kinds))]
