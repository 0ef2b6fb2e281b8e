"""Dry-run: every (architecture × input shape) counted on the meta device,
with the roofline of one H100 (port of :mod:`repro.launch.dryrun`).

Run::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k                       # the production mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --mesh sim1 \\
      --out results/dryrun.json              # one H100 a replica

The JAX package lowers and compiles each step for the production meshes
and reads XLA's cost and memory analyses. Here one rank's step runs on
meta tensors (shapes and dtypes, no data, no device) under
:class:`repro_torch.roofline.count.Counter`: every layer and every
microbatch, the optimizer, the exchange as the plan prescribes (its
collectives recorded by ``core/comm.py``, its kernels priced by their
cost functions), the peak of live bytes. A prefill or a decode step of a
deep stack is counted at two and three periods of its layer kinds and
extended to the whole (:func:`by_periods`, equal to a count of every
layer). Nothing needs a card, so the dry-run runs on the CPU.

Meshes:

- the production meshes (16x16, 2x16x16; ``launch/mesh.py``) give the
  static layout — specs, one rank's shapes, the exchange plan, the state
  bytes — on every row; their train rows, every family's, are counted
  too (one rank's step on its shards, its "model" axis of 16 tensor
  parallelism inside a replica, the model group's collectives
  recorded), llama3-405b's and kimi-k2's with FSDP over "data" too (its
  rows over "data", each layer's shards gathered and its gradient
  reduce-scattered over the 16 data ranks; every layer counted: a train
  step's peak of live bytes does not grow alike with each layer, so two
  and three layers do not extend to the whole); every family's prefill
  and decode rows are counted as one rank's serving step on its shards
  (``serve/mesh.py``: TP over "model", FSDP over "data" where the
  config serves with it, the batch's rows over the data axes;
  :func:`count_serve_step`, extended by :func:`by_periods`);
- ``sim1`` / ``sim4`` (``make_sim_mesh(1)`` / ``(4)``: one H100 a
  replica, the collective path's data mesh) count every term: the rows a
  benchmark's cells are sized from.

``--no-probes`` is accepted and does nothing: the count visits every
layer, so the JAX package's probe compiles have no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from contextlib import nullcontext
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_sim_mesh, rps_axes_for)
from repro_torch.models import build_model
from repro_torch.models.inputs import train_specs
from repro_torch.models.stack import stack_layers
from repro_torch.roofline import HW, analyze
from repro_torch.roofline.count import Counter, MetaGenerator
from repro_torch.serve import mesh as serve_mesh

_serve_fsdp = serve_mesh.serve_fsdp

DROP_RATE = 0.1          # the paper's headline tolerance

# the CLI's knobs (None = the paper-faithful baseline), as the reference's
OVERRIDES = {"exchange_dtype": "float32", "exchange_every": 1,
             "capacity_factor": None, "remat_budget": None,
             "bucket_mb": None, "n_buckets": None, "engine": "xla",
             "wire": "f32", "recovery": "renorm",
             "optimizer": "sgd", "state_pack": "f32"}

MESHES = {"16x16": dict(multi_pod=False), "2x16x16": dict(multi_pod=True),
          "sim1": dict(sim=1), "sim4": dict(sim=4)}


def pick_microbatch(cfg: ArchConfig, b_local: int, seq: int,
                    budget_bytes: float = 128e6,
                    min_b_micro: int = 1) -> int:
    """Split the per-worker batch so the per-layer remat carry
    (B_micro · S · d · 2B) stays under budget. For FSDP archs the
    per-microbatch batch must stay divisible by the data axis (16)."""
    per_ex = seq * cfg.d_model * 2
    b_micro = max(min_b_micro, int(budget_bytes // max(per_ex, 1)))
    m = max(1, b_local // b_micro)
    while b_local % m or (b_local // m) % min_b_micro:
        m -= 1
        if m == 1:
            break
    return max(m, 1)


def _stack_specs(specs: Dict, n_rps: int) -> Dict:
    """Worker-stacked (n_rps, B / n_rps, …) meta specs of a batch."""
    out = {}
    for k, s in specs.items():
        assert s.shape[0] % n_rps == 0, (k, tuple(s.shape), n_rps)
        out[k] = torch.empty((n_rps, s.shape[0] // n_rps)
                             + tuple(s.shape[1:]), dtype=s.dtype,
                             device="meta")
    return out


def _cache_spec_tree(cache_shape, cfg: ArchConfig, mesh: Mesh, data_axes):
    """The decode cache's layout: dim 1 (the batch of a layer-stacked
    leaf) over the data axes when it divides, the last dim past 1 that
    divides by "model" over it; spec tuples."""
    n_data = int(np.prod([mesh.shape[a] for a in data_axes]))
    n_model = mesh.shape.get("model", 1)
    dax = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes
                                                else None)

    def spec(path, leaf):
        entries = [None] * leaf.dim()
        if leaf.dim() >= 2 and dax is not None \
                and leaf.shape[1] % max(n_data, 1) == 0 and leaf.shape[1] > 1:
            entries[1] = dax
        for d in range(leaf.dim() - 1, 1, -1):
            if leaf.shape[d] % n_model == 0 and leaf.shape[d] >= n_model:
                entries[d] = "model"
                break
        return tuple(entries)

    return shlib._map_with_path(spec, cache_shape)


def model_flops_global(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token


def _tree_bytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_lib.leaves(t) if isinstance(x, torch.Tensor))


def _on_mesh(mesh: Mesh, fsdp_axis: Optional[str]) -> bool:
    """Whether a serving step on ``mesh`` is split: a "model" axis > 1,
    or FSDP over an axis > 1 (else each rank serves the whole batch on
    the whole replica, as on ``sim1`` / ``sim4``)."""
    return mesh.shape.get("model", 1) > 1 or (
        fsdp_axis is not None and mesh.shape.get(fsdp_axis, 1) > 1)


def _meta_model(cfg: ArchConfig):
    return build_model(cfg, device="meta")


def train_config(cfg: ArchConfig, agg: str, mb: int, **kw):
    """The dry-run's TrainConfig: the OVERRIDES, the paper's drop rate,
    ``kw`` on top."""
    from repro_torch.train.trainer import TrainConfig
    base = dict(optimizer=OVERRIDES["optimizer"], lr=0.05,
                drop_rate=DROP_RATE, aggregator=agg, microbatch=mb,
                exchange_dtype=OVERRIDES["exchange_dtype"],
                exchange_every=OVERRIDES["exchange_every"],
                bucket_mb=OVERRIDES["bucket_mb"],
                n_buckets=OVERRIDES["n_buckets"],
                engine=OVERRIDES["engine"], wire=OVERRIDES["wire"],
                recovery=OVERRIDES["recovery"],
                state_pack=OVERRIDES["state_pack"])
    base.update(kw)
    return TrainConfig(**base)


def count_train_step(cfg: ArchConfig, tcfg, mesh: Mesh, batch: Dict, *,
                     rps_axes: Tuple[str, ...], rank: int = 0,
                     fsdp_axis: Optional[str] = None) -> dict:
    """One rank's training step of ``make_train_setup`` on meta tensors
    (``batch``: the rank's rows, meta), counted: the totals of
    :meth:`Counter.totals`, with the step's collective ``records``.
    ``mesh`` needs no world (its ``as_rank`` view answers for ``rank``).
    Every layer runs; the microbatches, identical, run once, counted
    ``microbatch`` times."""
    from repro_torch.train.trainer import make_train_setup
    model = _meta_model(cfg)
    init_state, step, _ = make_train_setup(model, cfg, tcfg,
                                           mesh.as_rank(rank),
                                           rps_axes=rps_axes,
                                           fsdp_axis=fsdp_axis)
    params, opt_state = init_state(MetaGenerator())
    extra = ()
    if step.init_ef_state is not None:
        extra = (None, step.init_ef_state(params))
    elif tcfg.channel is not None:
        extra = (step.init_channel_state(MetaGenerator()),)
    with Counter(resident=_tree_bytes(params, opt_state, batch,
                                      *extra)) as c:
        step(params, opt_state, batch, 0, MetaGenerator(), *extra)
    return dict(c.totals(), records=c.records)


def build_train_counted(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                        microbatch: Optional[int] = None):
    """``(counted totals, info)`` of one train step on ``mesh``: ``info``
    the reference's keys (the static layout)."""
    from repro_torch.optim import make_optimizer
    from repro_torch.optim import statepack as statepack_lib
    from repro_torch.train.trainer import train_plan
    from repro_torch.core import wire as wire_lib
    if OVERRIDES["capacity_factor"] is not None and cfg.is_moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=OVERRIDES["capacity_factor"])
    rps_axes = rps_axes_for(cfg.rps_mode, mesh)
    n_rps = mesh.axis_size(rps_axes) if rps_axes else 1
    fsdp_axis = "data" if cfg.shard_strategy == "fsdp" else None
    b_local = shape.global_batch // max(n_rps, 1)
    budget = OVERRIDES.get("remat_budget") or 128e6
    min_bm = mesh.shape["data"] if cfg.shard_strategy == "fsdp" else 1
    mb = microbatch if microbatch is not None else pick_microbatch(
        cfg, b_local, shape.seq_len, budget_bytes=budget,
        min_b_micro=min_bm)
    agg = cfg.rps_mode if rps_axes else "none"
    tcfg = train_config(cfg, agg, mb)

    replica = _meta_model(cfg).init_stacked(MetaGenerator())
    plan = train_plan(cfg, tcfg, mesh, replica, rps_axes=rps_axes,
                      fsdp_axis=fsdp_axis)
    pack = statepack_lib.make_state_pack(tcfg.state_pack)
    opt = make_optimizer(tcfg.optimizer, state_pack=pack.name)
    stacked = tree_lib.map(lambda x: torch.empty(
        (n_rps,) + tuple(x.shape), dtype=x.dtype, device="meta"), replica)
    opt_shape = opt.init(stacked)
    ef_shape = None
    if agg.startswith("rps") and tcfg.recovery == "ef":
        ef_shape = statepack_lib.pack_tree(wire_lib.init_ef_state(stacked),
                                           pack.ef_format)
    info = {"n_rps": n_rps, "microbatch": mb, "aggregator": agg,
            "state_pack": pack.name,
            "state_bytes": statepack_lib.state_bytes_breakdown(
                params=stacked, opt_state=opt_shape, ef_state=ef_shape),
            "exchange_plan": plan.describe() if plan is not None else None}
    del stacked, opt_shape, ef_shape
    # the rank's rows: its worker's, split over "data" under FSDP (the
    # reference's batch_spec)
    batch = shlib.local_batch(
        _stack_specs(train_specs(cfg, shape.global_batch, shape.seq_len),
                     max(n_rps, 1)), mesh.as_rank(0), rps_axes,
        ("data",) if fsdp_axis else (), mb)
    return count_train_step(cfg, tcfg, mesh, batch, rps_axes=rps_axes,
                            fsdp_axis=fsdp_axis), info


def build_decode_counted(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh):
    """``(counted totals, info)`` of one decode step against a cache of
    ``shape.seq_len`` rows (the reference's ``cache_seq``);
    ``info["cache_specs"]``: the layer-stacked cache's layout (the
    reference's); ``info["rank_cache"]``: one rank's cache shapes on a
    mesh, a layer's leaves as its share of the layer leaves them (a
    K/V leaf the KV heads its query heads read, rwkv's state its heads,
    rec's states its dr channels; ``serve/mesh.py``)."""
    model = _meta_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S)
    info = {"cache_seq": S,
            "cache_specs": _cache_spec_tree(stack_layers(cache, model.kinds),
                                            cfg, mesh,
                                            serve_mesh.data_axes(mesh))}
    if not _on_mesh(mesh, _serve_fsdp(cfg)):
        return count_decode(cfg, B, S), info
    serve = serve_mesh.make_serve(model, mesh.as_rank(0))
    info["rank_cache"] = [tree_lib.map(lambda x: tuple(x.shape), c)
                          for c in serve.init_cache(B, S)]
    return count_serve(cfg, "decode", B, S, mesh), info


def _decode_whole(cfg: ArchConfig, B: int, S: int) -> dict:
    model = _meta_model(cfg)
    params = model.init(MetaGenerator())
    cache = model.init_cache(B, S)
    tok = {"token": torch.empty((B, 1), dtype=torch.int32, device="meta")}
    with torch.no_grad(), Counter(resident=_tree_bytes(params, cache,
                                                       tok)) as c:
        out = model.decode_step(params, cache, tok, S - 1)
    del out
    return c.totals()


def count_decode(cfg: ArchConfig, B: int, S: int) -> dict:
    """One decode step of ``B`` lanes at position S − 1 against a
    contiguous cache of ``S`` rows, counted on meta tensors
    (:func:`by_periods`)."""
    return by_periods(cfg, lambda c: _decode_whole(c, B, S))


def build_prefill_counted(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh):
    """``(counted totals, {})`` of one prefill of the global batch."""
    B, S = shape.global_batch, shape.seq_len
    if not _on_mesh(mesh, _serve_fsdp(cfg)):
        return count_prefill(cfg, B, S), {}
    return count_serve(cfg, "prefill", B, S, mesh), {}


def _prefill_whole(cfg: ArchConfig, B: int, S: int) -> dict:
    model = _meta_model(cfg)
    params = model.init(MetaGenerator())
    specs = train_specs(cfg, B, S)
    specs.pop("labels")
    with torch.no_grad(), Counter(resident=_tree_bytes(params,
                                                       specs)) as c:
        out = model.prefill(params, specs)
    del out
    return c.totals()


def count_prefill(cfg: ArchConfig, B: int, S: int) -> dict:
    """One prefill of a (B, S) batch (the contiguous decode cache made),
    counted on meta tensors (:func:`by_periods`)."""
    return by_periods(cfg, lambda c: _prefill_whole(c, B, S))


def count_serve_step(cfg: ArchConfig, kind: str, B: int, S: int,
                     mesh: Mesh, rank: int = 0) -> dict:
    """One rank's serving step on ``mesh`` (``serve/mesh.py``; the mesh
    needs no world: its ``as_rank`` view answers for ``rank``), every
    layer counted on meta tensors on the rank's shards: a prefill of the
    (B, S) batch (its rows; the cache of S rows made) or a decode step of
    B lanes at position S − 1 against a cache of S rows. The totals of
    :meth:`Counter.totals` with the step's collective ``records``."""
    model = _meta_model(cfg)
    serve = serve_mesh.make_serve(model, mesh.as_rank(rank))
    shards = serve.shard(model.init(MetaGenerator()))
    if kind == "prefill":
        specs = train_specs(cfg, B, S)
        specs.pop("labels")
        args = (shards, specs)
        resident = _tree_bytes(shards, serve.local_inputs(specs))
        step = serve.prefill_step
    else:
        cache = serve.init_cache(B, S)
        tok = {"token": torch.empty((B, 1), dtype=torch.int32,
                                    device="meta")}
        args = (shards, cache, tok, S - 1)
        resident = _tree_bytes(shards, cache, serve.local_inputs(tok))
        step = serve.decode_step
    with torch.no_grad(), Counter(resident=resident) as c:
        out = step(*args)
    del out
    return dict(c.totals(), records=c.records)


def count_serve(cfg: ArchConfig, kind: str, B: int, S: int,
                mesh: Mesh) -> dict:
    """Rank 0's serving step on ``mesh`` (:func:`count_serve_step`),
    counted by :func:`by_periods`; the ``records`` only where every layer
    was counted."""
    return by_periods(cfg, lambda c: count_serve_step(c, kind, B, S, mesh))


def _period(kinds) -> int:
    """The shortest period of a stack's sequence of layer kinds."""
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if all(kinds[i] == kinds[i - p] for i in range(p, n)))


def _extend(a, b, k: int):
    """``a + k (b − a)`` over the numbers of two totals alike in keys."""
    if isinstance(a, dict):
        return {key: _extend(a[key], b[key], k) for key in a
                if key != "records"}
    return a + k * (b - a)


def by_periods(cfg: ArchConfig, count) -> dict:
    """``count(cfg)`` of a pass without gradients (a prefill, a decode
    step), from ``count`` at the stacks cut to two and to three periods
    of their layer kinds (each stack keeps its remainder; an encoder's
    stack and a decoder's lose periods together).

    Every period after the first runs the same ops on the same shapes,
    so each adds the same FLOPs, bytes, kernel calls, collectives and
    resident bytes: those extend exactly. In such a pass a period's
    storages die inside the pass or live to its end, so no moment's live
    bytes grow by more per period than what the pass leaves alive at its
    end (``live_end``); when the peak grows by just that from two periods
    to three, it lies on a moment that grows so and stays the peak, and
    extends exactly too. Otherwise, and where the two counts would visit
    as many layers as the whole stack, every layer is counted
    (``tests/test_torch_roofline.py`` holds the two equal)."""
    full = _meta_model(cfg)
    stacks = [("n_layers", full.kinds)]
    if full.enc_kinds:
        stacks.append(("enc_layers", full.enc_kinds))
    k = min(len(kinds) // _period(kinds) for _, kinds in stacks)

    def cut(j):
        return dataclasses.replace(cfg, **{
            f: len(kinds) - (k - j) * _period(kinds) for f, kinds in stacks})
    if k < 3 or sum(getattr(cut(2), f) + getattr(cut(3), f)
                    for f, _ in stacks) >= sum(len(kinds)
                                               for _, kinds in stacks):
        return count(cfg)
    for j in (2, 3):
        m = _meta_model(cut(j))
        if m.kinds != full.kinds[:len(m.kinds)] \
                or m.enc_kinds != full.enc_kinds[:len(m.enc_kinds)]:
            return count(cfg)
    a, b = count(cut(2)), count(cut(3))
    if b["peak_live"] - a["peak_live"] != b["live_end"] - a["live_end"]:
        return count(cfg)
    return _extend(a, b, k - 2)


def builder_for(shape: ShapeConfig):
    return {"train": build_train_counted,
            "prefill": build_prefill_counted,
            "decode": build_decode_counted}[shape.kind]


def make_mesh(name: str) -> Mesh:
    kw = MESHES[name]
    if "sim" in kw:
        return make_sim_mesh(kw["sim"])
    return make_production_mesh(multi_pod=kw["multi_pod"])


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            probes: bool = True, verbose: bool = True, *,
            mesh: Optional[str] = None, hw: HW = HW()) -> Dict:
    """One row: ``mesh`` a name of :data:`MESHES` (default the production
    mesh ``multi_pod`` picks). ``probes`` is accepted and unused."""
    mesh_desc = mesh or ("2x16x16" if multi_pod else "16x16")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not cfg.runs_shape(shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_desc,
                "status": "skipped (full attention, see DESIGN.md §5)"}
    m = make_mesh(mesh_desc)
    from repro_torch.telemetry import get_current
    reg = get_current()

    def span(name):
        return reg.span(name, arch=arch, shape=shape_name,
                        mesh=mesh_desc) if reg is not None else nullcontext()

    t0 = time.time()
    with span("dryrun.count"):
        totals, info = builder_for(shape)(cfg, shape, m)
    t_count = time.time() - t0
    report = analyze(arch, shape_name, mesh_desc, m.size, totals,
                     model_flops_global(cfg, shape), hw=hw)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_desc,
           "status": "ok", "compile_s": round(t_count, 1), "info": info,
           "memory_analysis": {
               "args_gb": (totals["hbm"] - totals["peak_live"]) / 1e9,
               "temp_gb": totals["peak_live"] / 1e9,
               "output_gb": 0.0, "alias_gb": 0.0},
           "roofline": dataclasses.asdict(report)}
    if verbose and info.get("state_bytes"):
        sb = info["state_bytes"]
        comps = ", ".join(f"{k}={v/1e9:.2f}GB" for k, v in sb.items()
                          if k != "total" and v)
        print(f"  state bytes [{info.get('state_pack', 'f32')}]: "
              f"total {sb['total']/1e9:.2f} GB ({comps})")
    if verbose and info.get("exchange_plan"):
        ep = info["exchange_plan"]
        print(f"  exchange plan: {ep['n_buckets']} buckets × s={ep['s']} -> "
              f"{ep['collectives_per_round']} RPS collectives/round, "
              f"{ep['wire_bytes_per_round']/1e6:.1f} MB wire/round "
              f"(pad {ep['pad_frac']*100:.1f}%, "
              f"model_packets={ep['model_packets']}, "
              f"wire={ep['wire']}/{ep['recovery']}, "
              f"rs_bytes_ratio={ep['rs_bytes_ratio']:.2f})")
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_desc}] count {t_count:.1f}s"
              f" | hbm/dev {report.hbm_per_device/1e9:.2f} GB"
              f" (fits={report.fits})"
              f" | t_comp {report.t_compute*1e3:.2f} ms"
              f" | t_mem {report.t_memory*1e3:.2f} ms"
              f" | t_coll {report.t_collective*1e3:.2f} ms"
              f" -> {report.bottleneck}"
              f" | useful {report.useful_ratio:.2f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"] + list(MESHES),
                    help="single = 16x16, multi = 2x16x16 (layout rows); "
                         "sim1 / sim4 = one H100 a replica, 1 or 4 "
                         "replicas (counted rows)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "count visits every layer")
    ap.add_argument("--out", default=None)
    ap.add_argument("--exchange-dtype", default="float32")
    ap.add_argument("--exchange-every", type=int, default=1)
    ap.add_argument("--capacity", type=float, default=None)
    ap.add_argument("--remat-budget", type=float, default=None)
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="coalesce the exchange into fixed-byte buckets of "
                         "this many MiB; default: per-leaf")
    ap.add_argument("--buckets", type=int, default=None,
                    help="… or exactly this many size-balanced buckets")
    ap.add_argument("--engine", default="xla",
                    choices=["auto", "xla", "ring"],
                    help="RS+AG route: xla = a reduce-scatter and an "
                         "all-gather a bucket; ring = the hop schedule "
                         "with ring_rank.cu between transfers")
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--recovery", default="renorm",
                    choices=["renorm", "scale", "ef"])
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--state-pack", default="f32",
                    choices=["f32", "bf16", "i8", "int8"])
    ap.add_argument("--telemetry", action="store_true",
                    help="record a span per (arch × shape × mesh) count "
                         "into a Chrome trace")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write summary.json / trace.json here (implies "
                         "--telemetry)")
    args = ap.parse_args(argv)
    OVERRIDES.update(exchange_dtype=args.exchange_dtype,
                     exchange_every=args.exchange_every,
                     capacity_factor=args.capacity,
                     remat_budget=args.remat_budget,
                     bucket_mb=args.bucket_mb,
                     n_buckets=args.buckets,
                     engine=args.engine,
                     wire=args.wire,
                     recovery=args.recovery,
                     optimizer=args.optimizer,
                     state_pack=args.state_pack)

    reg = None
    if args.telemetry or args.telemetry_dir:
        from repro_torch import telemetry as telemetry_lib
        reg = telemetry_lib.Telemetry(out_dir=args.telemetry_dir)
        telemetry_lib.set_current(reg)

    archs = ARCH_IDS if (args.sweep or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.sweep or args.shape is None) \
        else [args.shape]
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}.get(args.mesh, [args.mesh])

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    results.append(run_one(arch, shape, mesh=mesh))
                except Exception as e:
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": mesh, "status": f"ERROR: {e}"})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print("wrote", args.out)
    if reg is not None:
        reg.finalize(print_summary=True)
        if args.telemetry_dir:
            print("telemetry ->", args.telemetry_dir)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum("skipped" in str(r.get("status")) for r in results)
    print(f"== {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)} total ==")
    return results


if __name__ == "__main__":
    main()
