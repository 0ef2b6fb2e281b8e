"""Mesh trainer: one process per RPS worker (port of
:mod:`repro.train.trainer`).

The JAX package stacks the n_rps replicas on a leading dim sharded over
the RPS mesh axes and runs the exchange inside ``shard_map``. Here each
rank of a ``torch.distributed`` world (:class:`repro_torch.launch.mesh.
Mesh`) holds its own replica and its own rows of the batch, and the
exchange is the collective path (:func:`repro_torch.core.rps.
rps_exchange_plan`) over the RPS axes' process group. Every rank starts
from the same replica (the paper sets every x_1^(i) equal).

  rps_model — local step on each replica, then the drop-masked RS+AG
    *model* exchange over ("data",) / ("pod", "data").
  rps_grad — replicas across pods only: the ranks of one pod take a
    reliable mean of their gradients (the pod's gradient over its whole
    batch, the reference's ICI direction), the pods exchange them
    drop-tolerantly (grad_renorm over ("pod",)), then every rank updates.
    On a single pod n_rps = 1 and the exchange is local. The pod's batch
    rows are split over its ranks microbatch by microbatch
    (``sharding.local_batch`` with the config's ``microbatch``); the
    MoE's batch statistics span each microbatch's rows over the ranks
    (``models/layers.py::moe_route``), as the reference's loss spans the
    pod's microbatch.
  allreduce_model / allreduce_grad — the exact mean over the RPS axes;
  none — no communication.

The exchange executes an :class:`repro_torch.core.plan.ExchangePlan`
built once, from the shapes of the first replica :func:`init_state`
makes (or the first step sees): the per-leaf plan by default; with
``bucket_mb`` / ``n_buckets`` the coalesced plan, tensor-parallel leaves
(``launch/sharding.py::model_dims``) in buckets of their own, per-bucket
masks.

Random draws: ``train_step`` takes ``gen``, a generator seeded alike on
every rank (the reference's replicated step key): the channel's masks,
the corruption masks and the packed state's rounding noise come from it
identically everywhere; the int8 wire's and the bitflip's per-rank noise
from generators with the rank folded in. The parity tests inject the
reference's draws (``masks=``, ``corrupt_masks=``, ``wire_noise=``,
``corrupt_bits=``, ``pack_noise=``, ``late=``).

Tensor parallelism inside a replica (a "model" axis > 1), for every
family (dense with or without experts, ssm, hybrid, audio, vlm): each
rank holds its slice of every sharded leaf (``launch/sharding.py::shard_replica``; the leaves ``_rule``
keeps whole are whole on every rank of the model group) and runs its
share of the
forward and backward (``models/parallel.py``, the model group's
all-reduces through ``core/comm.py``). The exchange runs over the RPS
axes' group, the ranks that share this rank's model coordinate, on this
rank's shards: the plan is built over one rank's shapes, as the
reference's over one device's, and every model shard consumes the same
masks. The optimizer state and the EF residual are per shard.

FSDP (``fsdp_axis``, the reference's rps_grad layout of llama3-405b and
kimi-k2), for every family, with a "model" axis > 1 too: each rank holds its contiguous part, by its index over the FSDP
axis, of every leaf's FSDP dim (``sharding.local_fsdp_dims``; the leaves
without one stay whole on every rank of the data group). Each layer's
shards are all-gathered as the layer loop takes it, in a checkpointed
layer whose backward gathers them again and reduce-scatters the whole
weights' gradient to the shards (``models/stack.py``); the sum is then
divided by the data group's size (the pod's mean, as
``comm.all_reduce_mean`` sums then divides), while a whole leaf's
gradient takes the all-reduce mean. The pods then exchange each rank's
shards over the RPS axes with the same masks on every data and model
coordinate (the plan over one rank's shapes), and the update runs on the
shards; the optimizer state and the EF residual are per shard.

Refused by name, each with a ValueError: an RWKV-6 head split across
the model group (``models/parallel.py::check_family``), an FSDP axis
among the RPS axes (the replicas' axis) or absent from the mesh, and an
FSDP or model dim that does not divide by its axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.channels import make_channel, make_corruption
from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm
from repro_torch.core import plan as plan_lib
from repro_torch.core import rps as rps_lib
from repro_torch.core import wire as wire_lib
from repro_torch.kernels import ring as ring_lib
from repro_torch.launch import sharding as shlib
from repro_torch.models import parallel as parallel_lib
from repro_torch.models.registry import Model
from repro_torch.optim import make_optimizer
from repro_torch.optim import statepack as statepack_lib
from repro_torch.roofline import count as count_lib
from repro_torch.telemetry import counters as counters_lib

#: the reference's key-domain tag of the packed state's rounding noise
PACK_TAG = 0x70616b


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields and defaults (see its comments)."""
    optimizer: str = "sgd"
    lr: float = 0.05
    drop_rate: float = 0.0
    aggregator: str = "rps_model"   # rps_model | rps_grad | allreduce_model
                                    # | allreduce_grad | none
    microbatch: int = 1
    exchange_dtype: str = "float32"
    exchange_every: int = 1
    channel: Optional[str] = None
    corruption: Optional[str] = None
    byzantine_frac: float = 0.0
    n_servers: Optional[int] = None
    bucket_mb: Optional[float] = None
    n_buckets: Optional[int] = None
    engine: str = "auto"            # "auto" = "xla"; "ring" by name
    wire: str = "f32"
    recovery: str = "renorm"
    schedule: str = "sync"
    compute_ms: Any = None
    state_pack: str = "f32"
    telemetry: bool = False


def _is_model_mode(agg: str) -> bool:
    return agg.endswith("_model")


def _meta(tree):
    return tree_lib.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), tree)


def local_shapes(tree: Any, specs: Any, mesh) -> Any:
    """One rank's shapes of a spec'd tree, on the meta device: each
    spec'd dim divided by its mesh axes' extent (the reference's
    ``_local_struct``; an axis the mesh lacks has extent 1)."""
    def loc(x, spec):
        dims = []
        for d, ent in zip(x.shape, tuple(spec) + (None,) * x.dim()):
            if ent is None:
                dims.append(int(d))
                continue
            axes = ent if isinstance(ent, tuple) else (ent,)
            # an axis the mesh lacks (a sim mesh's "model") has extent 1
            div = 1
            for a in axes:
                div *= mesh.shape.get(a, 1)
            if int(d) % div:
                raise ValueError(f"dim of {int(d)} over {axes} of {div}: "
                                 "it does not divide")
            dims.append(int(d) // div)
        return torch.empty(dims, dtype=x.dtype, device="meta")

    def walk(x, spec):            # the tree's nodes decide; specs are tuples
        if isinstance(x, dict):
            return {k: walk(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, sp) for v, sp in zip(x, spec))
        return loc(x, spec)

    return walk(tree, specs)


def train_plan(cfg: ArchConfig, tcfg: TrainConfig, mesh, replica, *,
               rps_axes: Tuple[str, ...], fsdp_axis: Optional[str] = None,
               channel=None) -> Optional[plan_lib.ExchangePlan]:
    """The exchange plan of ``replica`` (one replica's tree at its global
    shapes, any device) on ``mesh``, as the reference's
    ``make_train_setup`` derives it: over one rank's shapes (the specs'
    axes divided out, :func:`local_shapes`), its TP buckets from the
    global shapes' model dims; None for the allreduce and none
    aggregators. Any mesh, the production ones included: the static part
    of a setup, which the trainer and the dry-run share."""
    if not tcfg.aggregator.startswith("rps"):
        return None
    rps_axes = tuple(rps_axes)
    n_rps = mesh.axis_size(rps_axes) if rps_axes else 1
    n_servers = n_rps if tcfg.n_servers is None else int(tcfg.n_servers)
    meta = _meta(replica)
    local = local_shapes(meta, shlib.param_specs(
        meta, cfg, fsdp_axis=fsdp_axis, stacked=False), mesh)
    if channel is None:
        channel = make_channel(tcfg.channel, n_rps, tcfg.drop_rate,
                               s=tcfg.n_servers)
    bucketing = tcfg.bucket_mb is not None or tcfg.n_buckets is not None
    mdims = shlib.model_dims(meta, cfg) if bucketing else None
    from repro_torch.train.simulator import resolve_compute_ms
    return plan_lib.plan_from_config(
        local, n_rps, n_servers, bucket_mb=tcfg.bucket_mb,
        n_buckets=tcfg.n_buckets, model_dims=mdims, engine=tcfg.engine,
        wire=wire_lib.config_wire(tcfg.wire, tcfg.exchange_dtype),
        recovery=tcfg.recovery, schedule=tcfg.schedule,
        compute_ms=resolve_compute_ms(tcfg, channel))


def make_train_setup(model: Model, cfg: ArchConfig, tcfg: TrainConfig, mesh,
                     *, rps_axes: Tuple[str, ...],
                     fsdp_axis: Optional[str] = None):
    """Returns ``(init_state, train_step, state_shardings)`` for this
    rank of ``mesh``.

    ``init_state(gen=None, *, init_params=None) -> (params, opt_state)``:
    this rank's replica (``model.init_stacked(gen)``, or ``init_params``
    — one replica's tree, copied to the model's device), the same on every
    rank; on a "model" axis > 1 its shards (``sharding.shard_replica``).

    ``train_step(params, opt_state, batch, step, gen, ch_state=None,
    ef_state=None, *, masks=None, late=None, corrupt_masks=None,
    wire_noise=None, corrupt_bits=None, pack_noise=None) ->
    (params, opt_state, metrics[, ch_state][, ef_state])``: ``batch`` is
    this rank's rows (``sharding.local_batch`` with ``tcfg.microbatch``);
    ``ch_state`` is carried (and returned) with a channel spec and an
    rps aggregator, ``ef_state``
    (this rank's residual, in the state pack's EF format) under
    ``recovery="ef"``. Params and the optimizer state are updated in
    place. ``metrics``: the mean over the data-parallel ranks (every axis
    but "model") of the loss (and the model's ``nll`` / ``aux_loss``),
    ``lr``, and under ``telemetry`` the step's counters (the mask bundle,
    ``grad_norm`` over the RPS workers — a sharded leaf's squares summed
    over the model group, a whole leaf's counted once —, the lateness
    and corruption bundles), zero on a round that does not exchange.

    ``state_shardings(params_shape) -> (specs, specs)``: the layout of
    the worker-stacked tree (``sharding.param_specs``; the port has no
    sharding objects, so both are the spec tree).

    ``train_step.plan`` (built by the first :func:`init_state`; at setup
    on a "model" axis > 1 or with FSDP), ``.channel``,
    ``.init_channel_state(gen)``, ``.init_ef_state(params)``,
    ``.state_pack`` and ``.recovery`` as the reference's; ``.tp`` the
    tensor-parallel context and ``.model_dims`` the sharded dim of every
    leaf (``sharding.local_model_dims``; None without a "model" axis >
    1); ``.fsdp`` the data-group context and ``.fsdp_dims`` every leaf's
    FSDP dim (``sharding.local_fsdp_dims``; None without FSDP);
    ``sharding.gather_replica`` takes ``.fsdp``. ``.rows`` the group a
    replica's batch rows are split over (None when a rank has them all)
    and ``.reliable_mean(grads)`` the step's mean of a gradient tree over
    it.
    """
    if fsdp_axis is not None:
        if fsdp_axis not in mesh.axis_names or fsdp_axis == "model":
            raise ValueError(f"fsdp_axis={fsdp_axis!r}: FSDP needs a data "
                             f"axis of the mesh {mesh.axis_names} other "
                             "than 'model'")
        if fsdp_axis in tuple(rps_axes):
            raise ValueError(
                f"fsdp_axis={fsdp_axis!r} is among rps_axes="
                f"{tuple(rps_axes)}: FSDP over the axis that holds the "
                "replicas (the reference's PartitionSpec would name the "
                "axis twice)")
    tp_size = mesh.shape.get("model", 1)
    if tp_size > 1:
        parallel_lib.check_family(cfg, tp_size)
    codec = wire_lib.make_codec(wire_lib.config_wire(tcfg.wire,
                                                     tcfg.exchange_dtype))
    if tcfg.engine == "ring" and not codec.quantized:
        ring_lib.check_wire(codec.accum_dtype)   # at setup, not mid-step
    rps_axes = tuple(rps_axes)
    n_rps = mesh.axis_size(rps_axes) if rps_axes else 1
    n_servers = n_rps if tcfg.n_servers is None else int(tcfg.n_servers)
    pack = statepack_lib.make_state_pack(tcfg.state_pack)
    opt = make_optimizer(tcfg.optimizer, state_pack=pack.name)
    channel = make_channel(tcfg.channel, n_rps, tcfg.drop_rate,
                           s=tcfg.n_servers,
                           corruption=make_corruption(
                               tcfg.corruption, tcfg.byzantine_frac or None))
    rps_agg = tcfg.aggregator.startswith("rps")
    stateful = tcfg.channel is not None and rps_agg
    use_ef = rps_agg and tcfg.recovery == "ef"
    async_mode = rps_agg and tcfg.schedule == "async"
    corruption = getattr(channel, "corruption", None) if rps_agg else None
    if use_ef and corruption is not None:
        raise ValueError(
            "corruption with recovery='ef' is unsupported: the EF residual "
            "telescopes an *honest* sender's codec error; use a robust "
            "recovery (median/trimmed/clip) instead")
    recovery = wire_lib.make_recovery(tcfg.recovery,
                                      p=channel.effective_p()) \
        if rps_agg else None
    # the axes a replica spans (rps_grad's pod members): they split its
    # batch's rows, and their gradients are averaged reliably before the
    # exchange
    rep_axes = tuple(a for a in mesh.axis_names
                     if a not in rps_axes and a != "model")
    world = mesh.group(mesh.axis_names)
    rps_group = mesh.group(rps_axes) if rps_axes else None
    rep_group = mesh.group(rep_axes) if rep_axes else None
    state = {"plan": None, "slack": None}
    tp = dims = fdims = fsdp = replica = None
    loss_group = world
    if tp_size > 1 or fsdp_axis is not None:
        replica = _meta(dataclasses.replace(
            model, device=torch.device("meta")).init_stacked(
                count_lib.MetaGenerator()))
    if tp_size > 1:
        # the loss is the same on every rank of a model group: its mean
        # is over the data-parallel ranks
        loss_group = mesh.group(tuple(a for a in mesh.axis_names
                                      if a != "model"))
        dims = shlib.local_model_dims(replica, cfg, mesh)
        tp = parallel_lib.TP.from_dims(mesh.group(("model",)), dims)
    fsdp_group = rest_group = None
    if fsdp_axis is not None:
        fdims = shlib.local_fsdp_dims(replica, cfg, mesh, fsdp_axis)
        fsdp_group = mesh.group((fsdp_axis,))
        # the rest of a replica's axes, over which an FSDP leaf's
        # gradient is averaged whole after its reduce-scatter
        rest = tuple(a for a in rep_axes if a != fsdp_axis)
        rest_group = mesh.group(rest) if rest else None
        fsdp = parallel_lib.FSDP(fsdp_group, fdims)
    # the group a replica's batch rows are split over (the MoE's batch
    # statistics span it)
    rows = rep_group if rep_group is not None and rep_group.size > 1 \
        else None
    # telemetry: each gradient leaf's squares are summed over the axes
    # it is sharded over
    leaf_axes = []
    if replica is not None:
        nones = [None] * len(tree_lib.leaves(replica))
        for f, m in zip(nones if fdims is None else tree_lib.leaves(fdims),
                        nones if dims is None else tree_lib.leaves(dims)):
            leaf_axes.append(tuple(a for a, d in ((fsdp_axis, f),
                                                  ("model", m))
                                   if d is not None))
    sq_groups = {axes: mesh.group(axes) for axes in sorted(set(leaf_axes))
                 if axes and tcfg.telemetry}

    def build_plan(params):
        """The exchange plan over this rank's tree (shapes only), with the
        async schedule's per-bucket slack."""
        if not rps_agg or state["plan"] is not None:
            return
        plan = train_plan(cfg, tcfg, mesh, params, rps_axes=rps_axes,
                          fsdp_axis=fsdp_axis, channel=channel)
        state["plan"] = plan
        train_step.plan = plan
        if async_mode:
            deadline = getattr(channel, "deadline_ms", None)
            state["slack"] = plan.slack_ms(float(deadline)) \
                if deadline is not None \
                else np.zeros(plan.n_buckets, np.float64)

    def init_state(gen: Optional[torch.Generator] = None, *,
                   init_params=None):
        if init_params is None:
            params = model.init_stacked(gen)
            build_plan(params)
            params = shlib.shard_replica(params, cfg, mesh, fsdp_axis)
        else:
            build_plan(init_params)
            params = tree_lib.map(
                lambda x: x.to(model.device).clone(),
                shlib.shard_replica(init_params, cfg, mesh, fsdp_axis))
        return params, opt.init(params)

    def state_shardings(params_shape):
        specs = shlib.param_specs(params_shape, cfg, worker_axes=rps_axes,
                                  fsdp_axis=fsdp_axis, stacked=True)
        return specs, specs

    def loss_and_grads(params, batch):
        """This rank's loss, the model's metrics and the gradient, the
        batch's rows split into ``microbatch`` parts whose gradients
        accumulate in the parameters' dtype."""
        leaves, treedef = tree_lib.flatten(params)
        b_leaves, b_def = tree_lib.flatten(batch)
        mb = tcfg.microbatch
        grads = [torch.zeros_like(p) for p in leaves] if mb > 1 else None
        losses, metrics = [], {}
        # on the meta device (the dry-run's count) the identical
        # microbatches run once, counted mb times
        for j in count_lib.iterations(mb, leaves[0].device):
            part = b_leaves if mb == 1 else [
                b.reshape((mb, b.shape[0] // mb) + tuple(b.shape[1:]))[j]
                for b in b_leaves]
            mine = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                loss, met = model.loss(tree_lib.unflatten(treedef, mine),
                                       tree_lib.unflatten(b_def, part), tp,
                                       fsdp, rows)
                got = torch.autograd.grad(loss, mine, allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)]
            losses.append(loss.detach().to(torch.float32))
            if mb == 1:
                grads = got
                metrics = {k: v.detach().to(torch.float32)
                           for k, v in (met or {}).items()}
            else:
                for a, g in zip(grads, got):
                    a.add_(g)
        if mb > 1:
            grads = [g / mb for g in grads]
        loss = losses[0] if mb == 1 else torch.stack(losses).mean()
        return loss, metrics, tree_lib.unflatten(treedef, grads)

    def leaf_mean(g, fdim=None):
        if fdim is None:
            return comm.all_reduce_mean(g, rep_group)
        g = g / fsdp_group.size
        return g if rest_group is None else comm.all_reduce_mean(g,
                                                                 rest_group)

    def reliable_mean(grads):
        """The mean over a replica's ranks of this rank's gradient tree:
        an FSDP leaf's shard, already the data group's sum by its
        reduce-scatter, divided by its size (then averaged over any other
        axis of the replica); a whole leaf's all-reduce mean."""
        if rows is None:
            return grads
        return tree_lib.map(leaf_mean, grads,
                            *(() if fdims is None else (fdims,)))

    def exchange(tree, mode, *, masks, late, cmask, ef, wire_noise,
                 corrupt_bits, gen):
        """The aggregator's exchange over the RPS axes: ``(tree, ef)``
        when a residual is given."""
        if tcfg.aggregator == "none" or n_rps == 1:
            return tree if ef is None else (tree, ef)
        if tcfg.aggregator.startswith("allreduce"):
            # the mean over the stacked workers, summed in f32 as jnp.mean
            out = tree_lib.map(
                lambda x: comm.all_reduce_mean(x.to(torch.float32),
                                               rps_group).to(x.dtype), tree)
            return out if ef is None else (out, ef)
        return rps_lib.rps_exchange_plan(
            tree, gen, tcfg.drop_rate, rps_axes, plan=state["plan"],
            mesh=mesh, mode=mode, masks=masks,
            rs_dtype=getattr(torch, tcfg.exchange_dtype),
            engine=tcfg.engine, recovery=recovery, ef_state=ef, late=late,
            corruption=corruption, corrupt_masks=cmask,
            wire_noise=wire_noise, corrupt_bits=corrupt_bits)

    def telemetry_stats(grads, masks, late, cmask, step):
        rs_t, ag_t = masks
        stats = counters_lib.mask_step_stats(rs_t, ag_t)

        def sq_of(gs):
            return sum(torch.sum(torch.square(g.to(torch.float32)))
                       for g in gs)

        # a sharded leaf's squares over the axes it is sharded over, a
        # whole one's counted once
        by_axes = {}
        for g, axes in zip(tree_lib.leaves(grads),
                           leaf_axes or [()] * len(tree_lib.leaves(grads))):
            by_axes.setdefault(axes, []).append(g)
        sq = 0
        for axes in sorted(by_axes, key=lambda a: (not a, a)):
            part = sq_of(by_axes[axes])
            sq = sq + (comm.all_reduce_sum(part, sq_groups[axes])
                       if axes else part)
        stats["grad_norm"] = torch.sqrt(comm.all_reduce_sum(sq, rps_group))
        if late is not None:
            stats.update(counters_lib.staleness_stats(late["rs"],
                                                      late["ag"]))
        if cmask is not None:
            stats.update(counters_lib.corruption_stats(cmask, rs_t))
        if tcfg.exchange_every > 1:
            live = int(step % tcfg.exchange_every == 0)
            for k in ("rs_link_delivered", "ag_link_delivered",
                      "link_offered", "rs_link_late", "ag_link_late",
                      "late_frac", "rs_link_corrupt", "corrupt_frac"):
                if k in stats:
                    stats[k] = stats[k] * live
        return stats

    def train_step(params, opt_state, batch, step: int, gen, ch_state=None,
                   ef_state=None, *, masks=None, late=None,
                   corrupt_masks=None, wire_noise=None, corrupt_bits=None,
                   pack_noise=None):
        if use_ef and ef_state is None:
            raise ValueError("recovery='ef' carries a residual: pass "
                             "ef_state (train_step.init_ef_state(params) "
                             "for the zero start)")
        build_plan(params)
        plan = state["plan"]
        loss, metrics, grads = loss_and_grads(params, batch)
        grads = reliable_mean(grads)
        if masks is None and rps_agg and (stateful or async_mode):
            # channel time advances every step, exchanged or not
            if async_mode:
                rs, ag, late, ch_state = channel.sample_async(
                    gen, ch_state, state["slack"])
            elif plan.per_bucket_masks:
                rs, ag, ch_state = channel.sample_packets(
                    gen, ch_state, plan.n_buckets)
            else:
                rs, ag, ch_state = channel.sample(gen, ch_state)
            masks = (rs, ag)
        if masks is None and rps_agg and n_rps > 1:
            # the plan's own draw, made here so that the corruption draw
            # and the taps see the masks the exchange consumes
            masks = rps_lib.sample_masks(
                gen, n_rps, tcfg.drop_rate, plan.s,
                n_buckets=plan.n_buckets if plan.per_bucket_masks else None)
        cmask = corrupt_masks
        if corruption is not None and cmask is None:
            nb = None
            if masks is not None and masks[0].dim() == 3:
                nb = int(masks[0].shape[0])
            elif plan is not None and plan.per_bucket_masks:
                nb = plan.n_buckets
            cmask = channel.sample_corruption(gen, n_buckets=nb)
        stats = None
        if tcfg.telemetry and rps_agg and n_rps > 1:
            stats = telemetry_stats(grads, masks, late, cmask, step)
        lr = float(tcfg.lr)
        noise = pack_noise
        if noise is None and not pack.is_identity:
            noise = rps_lib.fold_in(gen, PACK_TAG)
        live = step % tcfg.exchange_every == 0
        kw = dict(masks=masks, late=late, cmask=cmask,
                  wire_noise=wire_noise, corrupt_bits=corrupt_bits, gen=gen)

        def swap(tree, mode):
            nonlocal ef_state
            if not use_ef:
                return exchange(tree, mode, ef=None, **kw)
            e = statepack_lib.unpack_tree(ef_state, pack.ef_format)
            out, e_new = exchange(tree, mode, ef=e, **kw)
            ef_state = statepack_lib.pack_tree(
                e_new, pack.ef_format,
                noise=statepack_lib.component_noise(noise, "ef"), tap="ef")
            return out

        if _is_model_mode(tcfg.aggregator) or tcfg.aggregator == "none":
            params, opt_state = opt.update(grads, opt_state, params, lr,
                                           noise=noise)
            if live:
                new = swap(params, "model")
                if new is not params:
                    with torch.no_grad():
                        for p, x in zip(tree_lib.leaves(params),
                                        tree_lib.leaves(new)):
                            p.copy_(x)
        else:            # the gradients are exchanged every step
            grads = swap(grads, "grad_renorm")
            params, opt_state = opt.update(grads, opt_state, params, lr,
                                           noise=noise)
        vals = torch.stack([loss] + [metrics[k] for k in sorted(metrics)])
        vals = comm.all_reduce_mean(vals, loss_group)
        out_metrics = {"loss": vals[0], "lr": lr,
                       **{k: vals[1 + j] for j, k in
                          enumerate(sorted(metrics))}}
        if stats is not None:
            out_metrics["telemetry"] = stats
        out = (params, opt_state, out_metrics)
        if stateful:
            out = out + (ch_state,)
        if use_ef:
            out = out + (ef_state,)
        return out

    train_step.plan = None
    train_step.tp = tp
    train_step.model_dims = dims
    train_step.fsdp = fsdp
    train_step.fsdp_dims = fdims
    train_step.rows = rows
    train_step.reliable_mean = reliable_mean
    if replica is not None:     # the global shapes: this rank's are cut
        build_plan(replica)
    train_step.channel = channel
    train_step.init_channel_state = channel.init_state
    train_step.recovery = recovery
    train_step.state_pack = pack
    train_step.init_ef_state = (
        lambda params: statepack_lib.pack_tree(
            wire_lib.init_ef_state(params), pack.ef_format)) \
        if use_ef else None
    return init_state, train_step, state_shardings
