"""Harness of the collective-path tests: one world of ranks per test file.

A test module builds its cases in the parent (numpy inputs, the
reference's masks and rounding noise), runs them all in one world of
spawned ranks on the CPU over gloo, one torch thread a rank
(:func:`run_cases`), and each parametrised test then reads its own
case's outputs, so each case counts and a file pays for one spawn.

This module imports no JAX: the ranks import it by name.
"""
import contextlib
import os

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib

WORLD = 4


def t_(a):
    """A numpy array (or a tree of them) as CPU tensors; None stays."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: t_(v) for k, v in a.items()}
    return torch.from_numpy(np.ascontiguousarray(a))


def np_(x):
    """A tensor (or a tree of them) as numpy arrays, bf16 as f32."""
    if isinstance(x, dict):
        return {k: np_(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_(v) for v in x)
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.detach().cpu().numpy()


def _mesh(spec: dict):
    shape = spec.get("mesh", (WORLD,))
    names = spec.get("axes", ("data",))
    return mesh_lib.Mesh(shape, names)


def _run_case(rank: int, spec: dict):
    """One case on this rank: the port's entry point ``spec["fn"]`` (a
    dotted name) called with this rank's inputs."""
    import importlib
    mod, name = spec["fn"].rsplit(".", 1)
    fn = getattr(importlib.import_module(mod), name)
    mesh = _mesh(spec)
    return fn(rank, mesh, spec)


def _cases_main(rank: int, world: int, cases: dict) -> dict:
    out = {}
    for name, spec in cases.items():
        out[name] = _run_case(rank, spec)
    return out


def run_cases(cases: dict, world: int = WORLD, path=None) -> dict:
    """Run every case in one world of ``world`` CPU ranks (gloo, one
    thread a rank); returns ``{case: [rank outputs]}``. With ``path``
    the outputs are also written there as an npz (``case/rank/key``)."""
    by_rank = mesh_lib.run_world(_cases_main, world, cases, device="cpu",
                                 threads=1)
    res = {name: [by_rank[r][name] for r in range(world)] for name in cases}
    if path is not None:
        flat = {}
        for name, ranks in res.items():
            for r, o in enumerate(ranks):
                for k, v in (o or {}).items():
                    flat[f"{name}/{r}/{k}"] = np.asarray(v)
        np.savez(os.fspath(path), **flat)
    return res


# ---- the entry points the cases call ---------------------------------------

def exchange_case(rank: int, mesh, spec: dict) -> dict:
    """One collective exchange: ``spec["entry"]`` in "flat", "tree",
    "plan", "leaf", "reliable"; this rank's inputs at ``spec["x"][rank]``
    (a tree for "tree" / "plan"); the masks, corruption masks, lateness,
    EF residual and int8 uniforms as the spec gives them. Returns the
    output (and the new residual), with the taps when asked."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import rps
    from repro_torch.telemetry import taps
    entry = spec["entry"]
    x = t_(_pick(spec["x"], rank))
    axes = spec.get("rps_axes", "data")
    masks = None if spec.get("rs") is None else (t_(spec["rs"]),
                                                 t_(spec["ag"]))
    kw = dict(mesh=mesh)
    for k in ("mode", "engine", "wire", "recovery"):
        if k in spec:
            kw[k] = spec[k]
    if spec.get("rs_dtype"):
        kw["rs_dtype"] = getattr(torch, spec["rs_dtype"])
    if spec.get("corruption"):
        from repro_torch.channels import make_corruption
        kw["corruption"] = make_corruption(spec["corruption"])
        kw["corrupt_masks"] = t_(spec["cmask"])
    noise = _pick(spec.get("noise"), rank)
    out = {}
    ctx = taps.tap_collector() if spec.get("taps") else \
        contextlib.nullcontext()
    with ctx as tap:
        if entry == "flat":
            y = rps.rps_exchange_flat(x, None, spec["p"], axes, masks=masks,
                                      wire_noise=t_(noise), **kw)
        elif entry == "tree":
            y = rps.rps_exchange(x, None, spec["p"], axes, masks=masks,
                                 wire_noise=t_(noise), **kw)
        elif entry == "plan":
            meta = tree_lib.map(lambda v: torch.empty(v.shape, dtype=v.dtype,
                                                      device="meta"), x)
            plan = plan_lib.make_plan(meta, mesh.axis_size(axes),
                                      **spec.get("plan_kw", {}))
            ef = t_(_pick(spec.get("ef"), rank))
            late = None if spec.get("late") is None else t_(spec["late"])
            hook = None
            if noise is not None:
                hook = (lambda b, shape, nz=noise: t_(nz[b]))
            y = rps.rps_exchange_plan(x, None, spec["p"], axes, plan=plan,
                                      masks=masks, ef_state=ef, late=late,
                                      wire_noise=hook, **kw)
            if ef is not None:
                y, out["ef"] = y
        elif entry == "leaf":
            for k in ("wire", "recovery"):
                kw.pop(k, None)
            y = rps.rps_exchange_leaf(x, masks[0], masks[1], axes,
                                      model_dim=spec.get("model_dim"), **kw)
        elif entry == "reliable":
            y = rps.reliable_average(x, axes, mesh=mesh)
        else:
            raise ValueError(entry)
    out["y"] = y
    if spec.get("taps"):
        out["taps"] = {k: torch.stack(v) if isinstance(v, list) else v
                       for k, v in tap.tree().items()}
    return np_(out)


def _pick(x, rank):
    """Rank ``rank``'s slice of a per-rank input (a stacked array, or a
    tree of them); None stays."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _pick(v, rank) for k, v in x.items()}
    if isinstance(x, list):
        return x[rank]
    return x[rank]


def trainer_case(rank: int, mesh, spec: dict) -> dict:
    """The port's mesh trainer on rps-paper-mlp (reduced) from the
    reference's initial replica ``spec["p1"]``, ``spec["steps"]`` steps
    on this rank's rows of the worker-stacked batch ``spec["batch"]``
    with the masks ``spec["masks"][t]``; the losses and the final
    parameters (and carries)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import stacked_params_from_jax
    from repro_torch.launch import sharding
    from repro_torch.models import build_model
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    cfg = get_config("rps-paper-mlp").reduced()
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(**spec["tcfg"])
    rps_axes = tuple(spec["rps_axes"])
    init_state, step, _ = make_train_setup(model, cfg, tcfg, mesh,
                                           rps_axes=rps_axes)
    params, opt_state = init_state(
        init_params=stacked_params_from_jax(spec["p1"], "cpu"))
    data_axes = tuple(a for a in mesh.axis_names if a not in rps_axes)
    batch = sharding.local_batch(t_(spec["batch"]), mesh, rps_axes,
                                 data_axes)
    ch_state = step.init_channel_state() if tcfg.channel else None
    ef = step.init_ef_state(params) if tcfg.recovery == "ef" else None
    losses, tel = [], []
    for t in range(spec["steps"]):
        masks = spec["masks"][t]
        gen = None
        if masks is None:          # the step's generator, alike on every rank
            gen = torch.Generator()
            gen.manual_seed(1000 + t)
        out = step(params, opt_state, batch, t, gen, ch_state, ef,
                   masks=None if masks is None else (t_(masks[0]),
                                                     t_(masks[1])))
        params, opt_state, met = out[:3]
        if "telemetry" in met:
            tel.append(sorted(met["telemetry"]))
        if tcfg.channel:
            ch_state = out[3]
        if ef is not None:
            ef = out[-1]
        losses.append(float(met["loss"]))
    return {"loss": np.array(losses), "params": np_(params), "tel": tel,
            "n_buckets": 0 if step.plan is None else step.plan.n_buckets}


def count_case(rank: int, mesh, spec: dict) -> dict:
    """One ``rps_exchange_plan`` over ``spec["n_buckets"]`` buckets on
    ``spec["engine"]``, its collectives recorded (``core/comm.py``):
    returns the records, their counts under ``check_hlo``'s keys, and
    this rank's output."""
    from repro_torch.core import comm
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import rps
    from repro_torch.launch import launches
    x = t_(_pick(spec["x"], rank))
    meta = tree_lib.map(lambda v: torch.empty(v.shape, dtype=v.dtype,
                                              device="meta"), x)
    plan = plan_lib.make_plan(meta, mesh.axis_size("data"),
                              n_buckets=spec["n_buckets"])
    comm.reset_stats()
    with comm.recording() as records:
        y = rps.rps_exchange_plan(x, None, spec["p"], "data", plan=plan,
                                  mesh=mesh, masks=(t_(spec["rs"]),
                                                    t_(spec["ag"])),
                                  engine=spec["engine"])
    return {"records": records,
            "counts": launches.collective_counts(records),
            "transfers": comm.STATS["transfers"], "out": np_(y)}


# ---- tensor parallelism inside a replica -----------------------------------

def _tp_config(fields: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**fields)


def trainer_tp_case(rank: int, mesh, spec: dict) -> dict:
    """The port's mesh trainer on a (data, model) or (pod, data, model)
    mesh with a "model" axis > 1, or with FSDP (``spec["fsdp_axis"]``):
    the config ``spec["cfg"]`` (fields of an ``ArchConfig``; or
    ``spec["arch"]``, a registry name, reduced) from the reference's
    initial replica ``spec["p1"]``, ``spec["steps"]`` steps on this rank's
    rows with the masks ``spec["masks"][t]``. Returns the losses, the
    replica gathered over the data and model groups (numpy), this rank's
    whole leaves, the sharded dims and the collectives of the first
    step."""
    from repro_torch.configs import get_config
    from repro_torch.convert import (replica_to_numpy, shards_from_jax,
                                     stacked_params_from_jax)
    from repro_torch.core import comm
    from repro_torch.launch import sharding
    from repro_torch.models import build_model
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    cfg = _tp_config(spec["cfg"]) if "cfg" in spec \
        else get_config(spec["arch"]).reduced()
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(**spec["tcfg"])
    rps_axes = tuple(spec["rps_axes"])
    fsdp_axis = spec.get("fsdp_axis")
    init_state, step, _ = make_train_setup(model, cfg, tcfg, mesh,
                                           rps_axes=rps_axes,
                                           fsdp_axis=fsdp_axis)
    params, opt_state = init_state(
        init_params=stacked_params_from_jax(spec["p1"], "cpu"))
    init_equal = all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(params),
        tree_lib.leaves(shards_from_jax(spec["p1"], cfg, mesh, "cpu",
                                        fsdp_axis))))
    data_axes = tuple(a for a in mesh.axis_names
                      if a not in rps_axes and a != "model")
    batch = sharding.local_batch(t_(spec["batch"]), mesh, rps_axes,
                                 data_axes, tcfg.microbatch)
    ef = step.init_ef_state(params) if tcfg.recovery == "ef" else None
    losses, records, norms = [], None, []
    for t in range(spec["steps"]):
        masks = spec["masks"][t]
        with comm.recording() as rec:
            out = step(params, opt_state, batch, t, None, None, ef,
                       masks=None if masks is None else
                       (t_(masks[0]), t_(masks[1])))
        if records is None:
            records = list(rec)
        params, opt_state, met = out[:3]
        if "telemetry" in met:
            norms.append(float(met["telemetry"]["grad_norm"]))
        if ef is not None:
            ef = out[-1]
        losses.append(float(met["loss"]))
    n = len(tree_lib.leaves(params))
    mdims = [None] * n if step.model_dims is None \
        else tree_lib.leaves(step.model_dims)
    fdims = [None] * n if step.fsdp_dims is None \
        else tree_lib.leaves(step.fsdp_dims)
    whole = [np_(x) for x, d, f in zip(tree_lib.leaves(params), mdims,
                                       fdims) if d is None and f is None]
    return {"loss": np.array(losses),
            "params": replica_to_numpy(params, step.model_dims, mesh,
                                       step.fsdp),
            "whole": whole, "dims": mdims, "fsdp_dims": fdims,
            "shapes": [tuple(x.shape) for x in tree_lib.leaves(params)],
            "records": records,
            "n_buckets": 0 if step.plan is None else step.plan.n_buckets,
            "grad_norm": np.array(norms), "init_equal": init_equal}


def fsdp_roundtrip_case(rank: int, mesh, spec: dict) -> dict:
    """``sharding.shard_replica`` over "model" and "data" of a random
    replica of ``spec["arch"]`` (reduced), each shard against its
    contiguous part of the replica, and ``gather_replica`` of the shards
    against the replica, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import build_model, parallel
    cfg = get_config(spec["arch"]).reduced()
    gen = torch.Generator()
    gen.manual_seed(spec["seed"])
    full = build_model(cfg, device="cpu").init_stacked(gen)
    mdims = sharding.local_model_dims(full, cfg, mesh)
    fdims = sharding.local_fsdp_dims(full, cfg, mesh, "data")
    shards = sharding.shard_replica(full, cfg, mesh, "data")
    equal, both, fsdp_only = True, 0, 0
    for x, y, m, f in zip(*(tree_lib.leaves(t)
                            for t in (full, shards, mdims, fdims))):
        want = x
        for d, axis in ((m, "model"), (f, "data")):
            if d is not None:
                n = mesh.shape[axis]
                size = x.shape[d] // n
                want = want.narrow(d, mesh.axis_index(axis) * size, size)
        equal &= torch.equal(want, y)
        both += m is not None and f is not None
        fsdp_only += m is None and f is not None
    back = sharding.gather_replica(
        shards, mdims, mesh, parallel.FSDP(mesh.group(("data",)), fdims))
    equal &= all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(full),
                                                   tree_lib.leaves(back)))
    return {"equal": bool(equal), "both": both, "fsdp_only": fsdp_only}


def _vs_whole(mesh, cfg, full, fn) -> dict:
    """``fn(params, tp)`` -> (output, inputs to differentiate) on the full
    weights ``full`` (a tree at its global shapes) and on this rank's
    shards of them over ``mesh``'s "model" axis: the largest forward and
    gradient differences (the shards' gradients gathered back), the
    output's and the gradients' scales and the names the context
    shards."""
    from repro_torch.launch import sharding
    from repro_torch.models import parallel as P
    dims = sharding.local_model_dims(full, cfg, mesh)
    tp = P.TP.from_dims(mesh.group(("model",)), dims)
    res = []
    for params, ctx in ((full, None), (sharding.shard_replica(
            full, cfg, mesh), tp)):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_lib.leaves(params)]
        p = tree_lib.unflatten(tree_lib.flatten(params)[1], leaves)
        y, xs = fn(p, ctx)
        gy = torch.ones_like(y) if y.dim() == 0 else torch.cos(y)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves + xs, torch.autograd.grad(
                     y, leaves + xs, gy, allow_unused=True))]
        res.append((y, grads[:len(leaves)], grads[len(leaves):]))
    (y0, g0, gx0), (y1, g1, gx1) = res
    g1 = tree_lib.leaves(sharding.gather_replica(
        tree_lib.unflatten(tree_lib.flatten(full)[1], list(g1)),
        dims, mesh))
    fwd = float((y0 - y1).detach().abs().max())
    grad = max(float((a - b).abs().max())
               for a, b in zip(list(g0) + list(gx0), list(g1) + list(gx1)))
    return {"fwd": fwd, "grad": grad,
            "scale": float(y0.detach().abs().max()),
            "grad_scale": max(float(a.abs().max())
                              for a in list(g0) + list(gx0)),
            "sharded": sorted(tp.dims)}


def tp_layers_case(rank: int, mesh, spec: dict) -> dict:
    """The sharded layers against ``tp=None`` on the full weights, on
    every rank of a (data, model) mesh: the vocab-parallel embedding, the
    head and cross-entropy (``spec["vocab"]`` below the padded vocab,
    labels on every shard), the attention (``spec["attn"]``: configs of
    ``ArchConfig`` fields, GQA with whole KV heads and MHA with sharded
    ones), the MLP and, for each config of ``spec.get("moe", {})``, an
    MoE FFN (its output plus its aux term). Returns each one's largest
    forward and gradient differences (the sharded leaves' gradients
    gathered)."""
    from repro_torch.models import layers as L
    out = {}
    gen = torch.Generator()
    gen.manual_seed(spec["seed"])

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    B, S = spec["B"], spec["S"]
    base = _tp_config(spec["cfg"])
    cfg = base
    V = cfg.padded_vocab
    x = randn(B, S, cfg.d_model)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    embed = {"embed": {"tok": randn(V, cfg.d_model),
                       "head": randn(cfg.d_model, V, scale=0.2),
                       "final_norm": randn(cfg.d_model, scale=0.1)}}

    def emb(p, tp):
        return L.embed(p["embed"], tokens, tp), []

    def head(p, tp):
        xx = x.clone().requires_grad_(True)
        lg = L.lm_head(p["embed"], xx, cfg.vocab_size, tp)
        return L.softmax_xent(lg, tokens, tp=tp), [xx]

    out["embed"] = _vs_whole(mesh, cfg, embed, emb)
    out["xent"] = _vs_whole(mesh, cfg, embed, head)
    for name, fields in spec["attn"].items():
        acfg = _tp_config(fields)
        h, kv, hd, d = acfg.n_heads, acfg.n_kv_heads, acfg.hd, acfg.d_model
        # one layer of the stacked layout (the rules read a leading
        # layer dim)
        attn = {"layers": {"attn": {"attn": {
            "wq": randn(1, d, h, hd, scale=d ** -0.5),
            "wk": randn(1, d, kv, hd, scale=d ** -0.5),
            "wv": randn(1, d, kv, hd, scale=d ** -0.5),
            "wo": randn(1, h, hd, d, scale=(h * hd) ** -0.5)}}}}

        def att(p, tp, acfg=acfg):
            xx = x.clone().requires_grad_(True)
            w = {k: v[0] for k, v in p["layers"]["attn"]["attn"].items()}
            y, _ = L.attention_fwd(w, xx, cfg=acfg, window=None,
                                   blocked=True, tp=tp)
            return y, [xx]

        out["attn-" + name] = _vs_whole(mesh, acfg, attn, att)
    d, ff = cfg.d_model, cfg.d_ff
    mlp = {"layers": {"attn": {"mlp": {
        "wi": randn(1, d, ff, scale=d ** -0.5),
        "wg": randn(1, d, ff, scale=d ** -0.5),
        "wo": randn(1, ff, d, scale=ff ** -0.5)}}}}

    def ffn(p, tp):
        xx = x.clone().requires_grad_(True)
        w = {k: v[0] for k, v in p["layers"]["attn"]["mlp"].items()}
        return L.mlp(w, xx, tp), [xx]

    out["mlp"] = _vs_whole(mesh, cfg, mlp, ffn)
    for name, fields in spec.get("moe", {}).items():
        mcfg = _tp_config(fields)
        E, d, ff = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
        xm = randn(B, S, d)
        moe = {"layers": {"moe_attn": {"moe": {
            "router": randn(1, d, E, scale=d ** -0.5),
            "wi": randn(1, E, d, ff, scale=d ** -0.5),
            "wg": randn(1, E, d, ff, scale=d ** -0.5),
            "wo": randn(1, E, ff, d, scale=ff ** -0.5)}}}}

        def moe_ffn(p, tp, mcfg=mcfg, xm=xm):
            xx = xm.clone().requires_grad_(True)
            w = {k: v[0] for k, v in p["layers"]["moe_attn"]["moe"].items()}
            y, aux = L.moe(w, xx, mcfg, tp=tp)
            return y + aux, [xx]

        out["moe-" + name] = _vs_whole(mesh, mcfg, moe, moe_ffn)
    return out


def tp_kinds_case(rank: int, mesh, spec: dict) -> dict:
    """One layer of each kind of ``spec["kinds"]`` ({label: (config
    fields, kind)}: rwkv, rec, a dense kind, enc, xattn) through
    ``models/stack.py``'s train pass with ``tp`` against ``tp=None`` on
    the full weights (the layer's weights drawn by the port's init, a
    leading layer dim of 1 for the rules), on every rank of a (data,
    model) mesh: the input and, for xattn, the encoder output
    differentiated too. Returns each one's differences as
    :func:`tp_layers_case`'s."""
    from repro_torch.models import stack as St
    gen = torch.Generator()
    gen.manual_seed(spec["seed"])
    out = {}
    for label, (fields, kind) in spec["kinds"].items():
        cfg = _tp_config(fields)
        layer = St.init_stack(gen, cfg, [kind])[0]
        full = {"layers": {kind: tree_lib.map(lambda t: t[None], layer)}}
        x = torch.randn((spec["B"], spec["S"], cfg.d_model), generator=gen)
        enc = torch.randn((spec["B"], spec["S"] // 2, cfg.d_model),
                          generator=gen)

        def fn(p, tp, cfg=cfg, kind=kind, x=x, enc=enc):
            xx = x.clone().requires_grad_(True)
            ee = enc.clone().requires_grad_(True)
            w = tree_lib.map(lambda t: t[0], p["layers"][kind])
            y, _ = St._train_layer(kind, w, xx, cfg, {"enc_out": ee}, tp,
                                   None)
            return y, [xx] + ([ee] if kind == "xattn" else [])

        out[label] = _vs_whole(mesh, cfg, full, fn)
    return out


# ---- serving on a mesh -------------------------------------------------------

def serve_mesh_case(rank: int, mesh, spec: dict) -> dict:
    """The port's mesh serving steps (``serve/mesh.py``) on the config
    ``spec["cfg"]`` from the reference's replica ``spec["p1"]``: a
    prefill of the prompts ``spec["tokens"]`` (B, P) (with the audio
    model's ``spec["frames"]`` or the vlm's ``spec["patches"]`` where
    given) with a decode cache of ``spec["max_len"]`` rows, then one
    decode step a row of ``spec["steps"]`` (T, B) at positions P', P' +
    1, … (P' the prompt's rows, the vlm's patch rows among them); beside
    each, the unsharded step (``tp=None``, ``fsdp=None``) on the same
    rows. Returns this rank's rows, its logits, the unsharded logits,
    its final cache, the KV heads it holds, its index and size over
    "model", the names the context shards and the collectives of the
    prefill and of the first decode step."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core import comm
    from repro_torch.models import build_model
    from repro_torch.models import parallel as P
    from repro_torch.serve.mesh import make_serve
    cfg = _tp_config(spec["cfg"])
    model = build_model(cfg, device="cpu")
    full = params_from_jax(spec["p1"], cfg, "cpu")
    serve = make_serve(model, mesh)
    shards = serve.shard(full)
    inputs = {k: t_(spec[k]) for k in ("tokens", "frames", "patches")
              if k in spec}
    B = inputs["tokens"].shape[0]
    Pn = inputs["tokens"].shape[1] + model.prefix_len
    S = spec["max_len"]
    lo, hi = serve.local_rows(B)
    rows = serve.rows(B)
    out = {"rows": (lo, hi), "logits": [], "whole": [], "records": []}
    with torch.no_grad():
        with comm.recording() as rec:
            lg, cache = serve.prefill_step(shards, inputs, S)
        out["records"].append(list(rec))
        lw, cache_w = model.prefill(full, {k: v[lo:hi]
                                           for k, v in inputs.items()}, S,
                                    rows=rows)
        out["logits"].append(np_(lg))
        out["whole"].append(np_(lw))
        for t, step in enumerate(spec["steps"]):
            tok = {"token": t_(step[:, None])}
            with comm.recording() as rec:
                lg, cache = serve.decode_step(shards, cache, tok, Pn + t)
            if t == 0:
                out["records"].append(list(rec))
            lw, cache_w = model.decode_step(
                full, cache_w, {"token": tok["token"][lo:hi]}, Pn + t,
                rows=rows)
            out["logits"].append(np_(lg))
            out["whole"].append(np_(lw))
    out["cache"] = [np_(c) for c in cache]
    out["kv"] = (0, cfg.n_kv_heads)
    if serve.tp is not None and serve.tp.sharded("attn/wq"):
        out["kv"] = P.kv_range(serve.tp, cfg.n_kv_heads, cfg.n_heads)
    out["model"] = ((serve.tp.index, serve.tp.size) if serve.tp is not None
                    else (0, 1))
    out["fsdp"] = serve.fsdp is not None
    out["sharded"] = sorted(serve.tp.dims) if serve.tp is not None else []
    return out
