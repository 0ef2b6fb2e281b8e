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
