"""Tensor parallelism inside a replica on the port's mesh trainer
(``repro_torch.train.trainer`` on a "model" axis > 1, gloo on the CPU)
against the reference's ``make_train_setup`` under GSPMD on forced host
devices.

A dense config built here (2 layers, d 64, 16 query and 4 KV heads of 8,
d_ff 128, vocab 256, f32): the rules shard ``wq``, ``wo``, the MLP,
``tok`` and ``head`` over "model" and keep ``wk`` / ``wv`` and the norms
whole. From the reference's initial replica, on the same rows and the
reference's masks (its in-step draw, replayed here), SGD, 3 steps each:

- ``rps_model`` on a (2, 2) ("data", "model") mesh on the xla engine;
- ``rps_model`` on the ring engine with 2 buckets (the TP buckets);
- ``rps_grad`` on (2, 1, 2) ("pod", "data", "model");
- ``rps_model`` on the ring engine, the int8 wire and ``recovery="ef"``.

Every step's loss and every parameter of the replica gathered over the
model group within 1e-5 (GSPMD sums the sharded contractions in an order
of its own; on the int8 wire, where the jitted encode multiplies by the
reciprocal of 127, at most a 1e-3 share of the parameters within one
grid step); the leaves the rules keep whole bit for bit equal on the
ranks of a model group.

In the same world: the sharded layers against ``tp=None`` (forward 1e-6
of the output's scale, gradients 1e-5), the xla run's ``grad_norm``
telemetry against the reference's, and the first step's collectives on
every rank equal to the dry-run's count of that rank's step on meta
tensors. In this process: ``models/parallel.py`` on meta tensors
through ``Mesh.as_rank`` (the families still refused under TP:
``tests/test_torch_trainer.py``). Measured against the reference on
the CPU: losses within 9.5e-7 and parameters within 2.4e-7 on the f32
wire; on the int8 wire with EF losses within 1.9e-6, parameters
within 1.9e-3 (one grid step).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import rps as jrps
from repro.models import build_model as jbuild_model
from repro.configs.base import ArchConfig as JArchConfig

import _torch_dist as td

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
TOL = 1e-5
FWD_TOL, GRAD_TOL = 1e-6, 1e-5
INT8_STEP, INT8_SHARE = 4e-3, 1e-3
CFG = dict(name="tp-dense", family="dense", n_layers=2, d_model=64,
           n_heads=16, n_kv_heads=4, head_dim=8, d_ff=128, vocab_size=256,
           max_seq=4096, dtype="float32")
B, S = 8, 16

CONFIGS = {
    "rps_model-xla": dict(aggregator="rps_model", engine="xla",
                          telemetry=True),
    "rps_model-ring-buckets": dict(aggregator="rps_model", engine="ring",
                                   n_buckets=2),
    "rps_grad-pods": dict(aggregator="rps_grad", engine="xla"),
    "rps_model-ring-ef-int8": dict(aggregator="rps_model", engine="ring",
                                   wire="int8", recovery="ef"),
}
LAYERS = dict(
    fn="_torch_dist.tp_layers_case", mesh=(2, 2), axes=("data", "model"),
    seed=7, B=2, S=12, cfg=dict(CFG, vocab_size=200),
    attn={"gqa": dict(CFG),
          "mha": dict(CFG, n_kv_heads=16)})


def _port_config():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**CFG)


def _n_buckets(tcfg: dict, mesh_shape, axes, rps_axes) -> int:
    """The port's plan's bucket count on the (shape-only) mesh, which the
    reference's in-step draw sizes its per-bucket masks by."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.train.trainer import TrainConfig, train_plan
    cfg = _port_config()
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    plan = train_plan(cfg, TrainConfig(**tcfg), Mesh(mesh_shape, axes),
                      replica, rps_axes=rps_axes)
    return plan.n_buckets if plan.per_bucket_masks else 0


def _inputs():
    """The reference's initial replica, the worker-stacked batch and every
    config's per-step masks, made in process."""
    cfg = JArchConfig(**CFG)
    p1 = jax.tree.map(np.asarray, jbuild_model(cfg, grouped=False).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CFG["vocab_size"], (B, S), dtype=np.int32)
    labels = rng.integers(0, CFG["vocab_size"], (B, S), dtype=np.int32)
    specs = {}
    for name, kw in CONFIGS.items():
        pods = name == "rps_grad-pods"
        shape = (2, 1, 2) if pods else (2, 2)
        axes = ("pod", "data", "model") if pods else ("data", "model")
        rps_axes = ("pod",) if pods else ("data",)
        tcfg = dict(optimizer="sgd", lr=0.1, drop_rate=0.3, **kw)
        nb = _n_buckets(tcfg, shape, axes, rps_axes)
        masks = []
        for t in range(STEPS):
            rs, ag = jrps.sample_masks(jax.random.PRNGKey(100 + t), 2, 0.3,
                                       2, n_buckets=nb or None)
            masks.append((np.asarray(rs), np.asarray(ag)))
        batch = {"tokens": tokens, "labels": labels}
        specs[name] = dict(
            fn="_torch_dist.trainer_tp_case", cfg=CFG, tcfg=tcfg, p1=p1,
            steps=STEPS, masks=masks, mesh=shape, axes=axes,
            rps_axes=rps_axes, n_buckets=nb,
            batch={k: v.reshape((2, -1) + v.shape[1:])
                   for k, v in batch.items()})
    return specs


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.models import build_model
    from repro.train.trainer import TrainConfig, make_train_setup

    specs = pickle.load(open(sys.argv[1], "rb"))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    specs = {k: specs[k] for k in sorted(specs)[part::parts]}
    auto = jax.sharding.AxisType.Auto
    out = {}
    for name, c in specs.items():
        cfg = ArchConfig(**c["cfg"])
        model = build_model(cfg, grouped=False)
        mesh = jax.make_mesh(c["mesh"], c["axes"],
                             axis_types=(auto,) * len(c["axes"]))
        tcfg = TrainConfig(**c["tcfg"])
        init_state, train_step, state_shardings = make_train_setup(
            model, cfg, tcfg, mesh, rps_axes=tuple(c["rps_axes"]))
        plan = train_step.plan
        assert plan.n_buckets == c["n_buckets"] or not plan.per_bucket_masks
        n = 2
        params = jax.tree.map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + x.shape),
            c["p1"])
        p_sh, _ = state_shardings(jax.eval_shape(lambda t: t, params))
        params = jax.device_put(params, p_sh)
        opt_state = ()
        batch = jax.tree.map(jnp.asarray, c["batch"])
        extra = []
        if tcfg.recovery == "ef":
            extra = [None, train_step.init_ef_state(params)]
        losses, norms = [], []
        with jax.set_mesh(mesh):
            step = jax.jit(train_step)
            for t in range(%d):
                res = step(params, opt_state, batch, jnp.int32(t),
                           jax.random.PRNGKey(100 + t), *extra)
                params, opt_state, met = res[:3]
                if tcfg.recovery == "ef":
                    extra[-1] = res[-1]
                losses.append(float(met["loss"]))
                if "telemetry" in met:
                    norms.append(float(met["telemetry"]["grad_norm"]))
        out[name] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                     "params": jax.tree.map(np.asarray, params)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % (SRC, STEPS)
PARTS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_tp")
    specs = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(specs, f)
    env = dict(os.environ)
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_backend_optimization_level=0 "
                             "--xla_llvm_disable_expensive_passes=true"})
    procs = [subprocess.Popen([sys.executable, "-c", _REF,
                               str(tmp / "in.pkl"), str(tmp / f"out{j}.pkl"),
                               str(j), str(PARTS)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for j in range(PARTS)]
    try:
        port = td.run_cases(dict(specs, layers=LAYERS))
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    ref = {}
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    for j in range(PARTS):
        with open(tmp / f"out{j}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return specs, port, ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_tp_equals_reference(runs, name):
    """Losses and the gathered replica against the reference's (2, 2) /
    (2, 1, 2) run: the data (pod) rank's replica row."""
    specs, port, ref = runs
    want = ref[name]
    int8 = specs[name]["tcfg"].get("wire") == "int8"
    for r, got in enumerate(port[name]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r} losses")
        w = r // 2                       # the rank's RPS worker
        flat_got = jax.tree.leaves(got["params"])
        flat_want = jax.tree.leaves(jax.tree.map(lambda x: x[w],
                                                 want["params"]))
        assert len(flat_got) == len(flat_want)
        off = total = 0
        for a, b in zip(flat_got, flat_want):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape
            if int8:
                off += int(np.sum(np.abs(a - b) > TOL))
                total += a.size
                np.testing.assert_allclose(a, b, rtol=0, atol=INT8_STEP)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                           err_msg=f"rank {r} params")
        assert off <= INT8_SHARE * max(total, 1), (r, off, total)


def test_trainer_tp_telemetry_and_shards_equal_reference(runs):
    """The xla run's telemetry: every step's ``grad_norm`` (a sharded
    leaf's squares summed over the model group, a whole one's counted
    once, then over the RPS workers) within 1e-5 relative of the
    reference's; and the trainer's initial shards are
    ``convert.shards_from_jax`` of the reference's replica."""
    _, port, ref = runs
    want = ref["rps_model-xla"]["grad_norm"]
    assert len(want) == STEPS
    for got in port["rps_model-xla"]:
        np.testing.assert_allclose(got["grad_norm"], want, rtol=1e-5,
                                   atol=0)
    for name in CONFIGS:
        assert all(got["init_equal"] for got in port[name]), name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_tp_whole_leaves_bitwise_across_model_group(runs, name):
    """The leaves the rules keep whole (the norms, ``wk`` / ``wv``) are
    the same bits on both ranks of each model group, and the shards of
    the sharded ones gather into the same replica there."""
    _, port, _ = runs
    ranks = port[name]
    assert ranks[0]["dims"].count(None) == len(ranks[0]["whole"]) > 0
    for a_rank, b_rank in ((0, 1), (2, 3)):
        a, b = ranks[a_rank], ranks[b_rank]
        for x, y in zip(a["whole"], b["whole"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["params"]),
                        jax.tree.leaves(b["params"])):
            np.testing.assert_array_equal(x, y)


def test_trainer_tp_shards_the_rules_leaves(runs):
    """``wq``, ``wo``, the MLP, ``tok`` and ``head`` arrive sharded; the
    norms and ``wk`` / ``wv`` whole (16 query heads shard, 4 KV heads do
    not)."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    cfg = _port_config()
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    dims = sharding.local_model_dims(replica, cfg,
                                     Mesh((2, 2), ("data", "model")))
    attn = dims["layers"]["attn"]
    assert dims["embed"] == {"tok": 0, "head": 1, "final_norm": None}
    assert attn["attn"] == {"wq": 2, "wk": None, "wv": None, "wo": 1}
    assert attn["mlp"] == {"wi": 2, "wg": 2, "wo": 1}
    assert attn["ln1"] is None and attn["ln2"] is None
    one = sharding.local_model_dims(replica, cfg, Mesh((4,), ("data",)))
    assert all(d is None for d in jax.tree.leaves(
        one, is_leaf=lambda x: x is None))


@pytest.mark.parametrize("part", ["embed", "xent", "attn-gqa", "attn-mha",
                                  "mlp"])
def test_tp_layers_equal_unsharded(runs, part):
    """Each sharded layer on every rank against ``tp=None`` on the full
    weights: forward within 1e-6 of the output's largest magnitude (at
    least 1: the partial sums add in another order), the gradients (the
    shards' gathered) within 1e-5; what the context shards."""
    _, port, _ = runs
    want_sharded = {"embed": ["embed/head", "embed/tok"],
                    "xent": ["embed/head", "embed/tok"],
                    "attn-gqa": ["attn/wo", "attn/wq"],
                    "attn-mha": ["attn/wk", "attn/wo", "attn/wq",
                                 "attn/wv"],
                    "mlp": ["mlp/wg", "mlp/wi", "mlp/wo"]}[part]
    for r, got in enumerate(port["layers"]):
        res = got[part]
        assert res["sharded"] == want_sharded, (r, res)
        assert res["fwd"] <= FWD_TOL * max(1.0, res["scale"]), (r, res)
        assert res["grad"] <= GRAD_TOL, (r, res)


@pytest.mark.parametrize("name", ["rps_model-xla", "rps_model-ring-buckets"])
def test_trainer_tp_collectives_equal_dry_run(runs, name):
    """One rank's first step: the collectives the world recorded, record
    for record, equal the dry-run's count of that rank's step on meta
    tensors (``launch/dryrun.py::count_train_step`` through
    ``Mesh.as_rank``); the model group's all-reduces among them."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import TrainConfig
    specs, port, _ = runs
    spec = specs[name]
    mesh = Mesh(spec["mesh"], spec["axes"])
    batch = {k: torch.empty((B // 2, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    for r, got in enumerate(port[name]):
        tot = D.count_train_step(_port_config(), TrainConfig(**spec["tcfg"]),
                                 mesh, batch, rps_axes=spec["rps_axes"],
                                 rank=r)
        assert [tuple(x) for x in tot["records"]] == \
            [tuple(x) for x in got["records"]], r
        # forward and backward: an embedding, 2 MLPs, 2 attentions, the
        # head, the loss's max / sum / gold, and 2 whole KV projections a
        # layer entering the region
        assert sum(1 for op, _, n in got["records"]
                   if op == "all_reduce") >= 2 * 2 * 2 + 2 + 3


def test_parallel_on_meta_through_as_rank():
    """``models/parallel.py`` on meta tensors on a shape-only mesh's
    rank: shapes, and the model group's all-reduces recorded (nothing
    sent)."""
    from repro_torch.core import comm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import parallel as P
    mesh = Mesh((2, 4), ("data", "model")).as_rank(5)
    group = mesh.group(("model",))
    assert (group.size, group.index, group.pg) == (4, 1, None)
    tp = P.TP(group, {"embed/tok": 0, "embed/head": 1, "attn/wq": 2,
                      "attn/wo": 1})
    meta = dict(device="meta")
    tok = torch.empty((64, 32), **meta)
    tokens = torch.empty((2, 5), dtype=torch.int32, **meta)
    head = torch.empty((32, 64), **meta)
    x = torch.empty((2, 5, 32), **meta)
    with comm.recording() as rec:
        emb = P.embed(tp, tok, tokens)
        lg = P.mask_vocab(tp, L.einsum("bsd,dv->bsv", tp.copy_to(x), head),
                          200)
        loss = P.softmax_xent(tp, lg, tokens)
        kv = P.local_kv(tp, torch.empty((2, 5, 4, 8), **meta), 16)
    assert emb.shape == (2, 5, 32) and emb.device.type == "meta"
    assert lg.shape == (2, 5, 64) and loss.shape == ()
    assert kv.shape == (2, 5, 1, 8)
    assert rec == [("all_reduce", 2 * 5 * 32 * 4, 4),
                   ("all_reduce", 2 * 5 * 4, 4),
                   ("all_reduce", 2 * 5 * 4, 4),
                   ("all_reduce", 2 * 5 * 4, 4)]
