"""FSDP on the port's mesh trainer (``repro_torch.train.trainer`` with
``fsdp_axis="data"``, gloo on the CPU) against the reference's
``make_train_setup(..., fsdp_axis="data")`` under GSPMD on forced host
devices.

rps_grad, the reference's layout of llama3-405b and kimi-k2: the pods
exchange their gradients drop-tolerantly, and inside a pod every leaf's
FSDP dim is laid over "data" with the batch's rows. From the reference's
initial replica, on the same rows and the reference's masks (its in-step
draw, replayed here), 3 steps each:

- llama3-405b reduced (d 256, 2 layers) on (2, 2, 1) ("pod", "data",
  "model"), SGD on the xla engine, with telemetry;
- the same on the ring engine with 2 buckets;
- the same with ``microbatch=2`` (a reduce-scatter per microbatch, the
  gradients accumulated on the shards);
- the same with Adam and ``microbatch=2`` (the optimizer state per
  shard), lr 1e-4, and beside it the port's FSDP-free run of it;
- the TP test's dense config (16 query heads) on (1, 2, 2): TP × FSDP on
  one pod, llama3-405b's 16x16 layout in miniature;
- kimi-k2 reduced on (2, 2, 1): FSDP over the expert leaves on a
  "model" axis of 1, the MoE's capacity and load-balance term over the
  pod's rows; and with ``microbatch=2``, each rank's rows handed out
  microbatch by microbatch (``sharding.local_batch``), so that the
  MoE's statistics span the reference's microbatch.

Every step's loss and every parameter of the replica gathered over the
data and model groups within 1e-5 (under Adam, all but a 1e-4 share of
the parameters, the rest within its steps' bound 2 · steps · lr: Adam's
step lr · m / (√v + ε) is ill-conditioned where a gradient element is
within a few ε of 0, and there the last bits of XLA's and torch's sums
move it by up to a third of lr — measured with and without FSDP alike,
2.86e-5 at lr 1e-4 on the port's FSDP-free run; the FSDP run within
1e-6 of the port's FSDP-free one); the leaves FSDP keeps whole, and the
gathered replica, bit for bit equal on the ranks of each data group; the
xla run's ``grad_norm`` within 1e-5 relative; the first step's
collectives on every rank equal to the dry-run's count of that rank's
step on meta tensors. In the same world: ``shard_replica`` /
``gather_replica`` round trips over data and model. In this process:
the FSDP dims of the rules and each refusal's ValueError. The
reference runs with ``check_vma=False`` (its ``_shard_map``'s
``check_rep=False`` of jax < 0.6: jax 0.9's replication check refuses
its exchange over the pods when the whole leaves are replicated over
"data"). Measured against the reference on the CPU: losses within
1.9e-6 (kimi-k2; llama3-405b 4.8e-7, both at microbatch 2 4.8e-7),
parameters within 2.4e-7 (SGD); under Adam 4.22e-5 at most.
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

from repro.configs import get_config as jget_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import rps as jrps
from repro.models import build_model as jbuild_model

import _torch_dist as td

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
TOL = 1e-5
B, S = 8, 16
POD_MESH = dict(mesh=(2, 2, 1), axes=("pod", "data", "model"))
# tests/test_torch_trainer_tp.py's dense config: its 16 query heads and
# MLP split over "model", every projection's d over "data"
TP_CFG = dict(name="tp-dense", family="dense", n_layers=2, d_model=64,
              n_heads=16, n_kv_heads=4, head_dim=8, d_ff=128,
              vocab_size=256, max_seq=4096, dtype="float32")
SGD = dict(optimizer="sgd", lr=0.1, drop_rate=0.3, aggregator="rps_grad")

CONFIGS = {
    "llama-xla": dict(arch="llama3-405b", **POD_MESH,
                      tcfg=dict(SGD, engine="xla", telemetry=True)),
    "llama-ring-buckets": dict(arch="llama3-405b", **POD_MESH,
                               tcfg=dict(SGD, engine="ring", n_buckets=2)),
    "llama-sgd-mb2": dict(arch="llama3-405b", **POD_MESH,
                          tcfg=dict(SGD, microbatch=2, engine="xla")),
    "llama-adam-mb2": dict(arch="llama3-405b", **POD_MESH,
                           tcfg=dict(SGD, optimizer="adam", lr=1e-4,
                                     microbatch=2, engine="xla")),
    "llama-adam-mb2-plain": dict(arch="llama3-405b", **POD_MESH,
                                 fsdp_axis=None,
                                 tcfg=dict(SGD, optimizer="adam", lr=1e-4,
                                           microbatch=2, engine="xla")),
    "dense-tp": dict(cfg=TP_CFG, mesh=(1, 2, 2),
                     axes=("pod", "data", "model"),
                     tcfg=dict(SGD, engine="xla")),
    "kimi-xla": dict(arch="kimi-k2-1t-a32b", **POD_MESH,
                     tcfg=dict(SGD, engine="xla")),
    "kimi-sgd-mb2": dict(arch="kimi-k2-1t-a32b", **POD_MESH,
                         tcfg=dict(SGD, microbatch=2, engine="xla")),
}
ROUNDTRIP = dict(fn="_torch_dist.fsdp_roundtrip_case", mesh=(2, 2),
                 axes=("data", "model"), arch="llama3-405b", seed=5)


def _port_config(spec):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    if "cfg" in spec:
        return ArchConfig(**spec["cfg"])
    return get_config(spec["arch"]).reduced()


def _n_buckets(spec) -> int:
    """The port's plan's bucket count on the (shape-only) mesh, which the
    reference's in-step draw sizes its per-bucket masks by."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.train.trainer import TrainConfig, train_plan
    cfg = _port_config(spec)
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    plan = train_plan(cfg, TrainConfig(**spec["tcfg"]),
                      Mesh(spec["mesh"], spec["axes"]), replica,
                      rps_axes=("pod",), fsdp_axis="data")
    return plan.n_buckets if plan is not None and plan.per_bucket_masks \
        else 0


def _inputs():
    """Every case's reference initial replica, worker-stacked batch and
    per-step masks, made in process."""
    specs = {}
    for name, c in CONFIGS.items():
        jcfg = JArchConfig(**c["cfg"]) if "cfg" in c \
            else jget_config(c["arch"]).reduced()
        p1 = jax.tree.map(np.asarray, jbuild_model(
            jcfg, grouped=False).init(jax.random.PRNGKey(0)))
        n_rps = c["mesh"][0]
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, jcfg.vocab_size, (n_rps, B // n_rps, S),
                                 dtype=np.int32)
                 for k in ("tokens", "labels")}
        nb = _n_buckets(c)
        masks = [None] * STEPS
        if n_rps > 1:
            masks = []
            for t in range(STEPS):
                rs, ag = jrps.sample_masks(jax.random.PRNGKey(100 + t),
                                           n_rps, 0.3, n_rps,
                                           n_buckets=nb or None)
                masks.append((np.asarray(rs), np.asarray(ag)))
        specs[name] = dict(dict(fsdp_axis="data"), **c,
                           fn="_torch_dist.trainer_tp_case", p1=p1,
                           steps=STEPS, masks=masks, rps_axes=("pod",),
                           n_buckets=nb, batch=batch)
    return specs


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import functools
    import numpy as np, jax, jax.numpy as jnp
    # the reference's _shard_map passes check_rep=False on jax < 0.6 and
    # nothing on later jax, whose replication check refuses its exchange
    # over ("pod",) when the whole leaves are replicated over "data":
    # its jax < 0.6 setting, here
    jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
    from repro.configs import get_config
    from repro.configs.base import ArchConfig
    from repro.models import build_model
    from repro.optim import make_optimizer
    from repro.train.trainer import TrainConfig, make_train_setup

    specs = pickle.load(open(sys.argv[1], "rb"))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    specs = {k: specs[k] for k in sorted(specs)[part::parts]
             if specs[k]["fsdp_axis"] is not None}
    auto = jax.sharding.AxisType.Auto
    out = {}
    for name, c in specs.items():
        cfg = ArchConfig(**c["cfg"]) if "cfg" in c \\
            else get_config(c["arch"]).reduced()
        model = build_model(cfg, grouped=False)
        mesh = jax.make_mesh(c["mesh"], c["axes"],
                             axis_types=(auto,) * len(c["axes"]))
        tcfg = TrainConfig(**c["tcfg"])
        init_state, train_step, state_shardings = make_train_setup(
            model, cfg, tcfg, mesh, rps_axes=tuple(c["rps_axes"]),
            fsdp_axis=c["fsdp_axis"])
        plan = train_step.plan
        assert plan.n_buckets == c["n_buckets"] or not plan.per_bucket_masks
        n = c["mesh"][0]
        params = jax.tree.map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + x.shape),
            c["p1"])
        p_sh, _ = state_shardings(jax.eval_shape(lambda t: t, params))
        params = jax.device_put(params, p_sh)
        opt_state = make_optimizer(tcfg.optimizer,
                                   state_pack="f32").init(params)
        batch = jax.tree.map(jnp.asarray, c["batch"])
        losses, norms = [], []
        with jax.set_mesh(mesh):
            step = jax.jit(train_step)
            for t in range(%d):
                params, opt_state, met = step(
                    params, opt_state, batch, jnp.int32(t),
                    jax.random.PRNGKey(100 + t))[:3]
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
    tmp = tmp_path_factory.mktemp("trainer_fsdp")
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
        port = td.run_cases(dict(specs, roundtrip=ROUNDTRIP))
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    ref = {}
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    for j in range(PARTS):
        with open(tmp / f"out{j}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return specs, port, ref


def _data_pairs(spec):
    """The pairs of ranks that make up each data group of the case's
    mesh (row-major: the last axis fastest)."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(spec["mesh"], spec["axes"])
    groups = {tuple(mesh.group_ranks(("data",), r)) for r in range(4)}
    return sorted(groups)


FSDP_CASES = [k for k, c in CONFIGS.items()
              if c.get("fsdp_axis", "data") is not None]
ADAM_SHARE = 1e-4


@pytest.mark.parametrize("name", FSDP_CASES)
def test_trainer_fsdp_equals_reference(runs, name):
    """Losses and the replica gathered over the data and model groups
    against the reference's run: the pod's replica row."""
    specs, port, ref = runs
    want = ref[name]
    tcfg = specs[name]["tcfg"]
    adam = tcfg["optimizer"] == "adam"
    n_rps = specs[name]["mesh"][0]
    for r, got in enumerate(port[name]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r} losses")
        w = r // (4 // n_rps)                  # the rank's pod
        flat_got = jax.tree.leaves(got["params"])
        flat_want = jax.tree.leaves(jax.tree.map(lambda x: x[w],
                                                 want["params"]))
        assert len(flat_got) == len(flat_want)
        off = total = 0
        for a, b in zip(flat_got, flat_want):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape
            if adam:
                off += int(np.sum(np.abs(a - b) > TOL))
                total += a.size
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=2 * STEPS * tcfg["lr"])
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                           err_msg=f"rank {r} params")
        assert off <= ADAM_SHARE * max(total, 1), (r, off, total)
        assert got["init_equal"]
    if adam:
        for got, plain in zip(port[name], port[name + "-plain"]):
            for a, b in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(plain["params"])):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", FSDP_CASES)
def test_trainer_fsdp_whole_leaves_bitwise_across_data_group(runs, name):
    """The leaves FSDP keeps whole (the embeddings, the norms, the
    router) are the same bits on both ranks of each data group, and the
    shards gather into the same replica there; the FSDP leaves arrive as
    halves of their FSDP dim."""
    specs, port, _ = runs
    ranks = port[name]
    fd = ranks[0]["fsdp_dims"]
    assert any(d is not None for d in fd) and fd.count(None) > 0
    for a_rank, b_rank in _data_pairs(specs[name]):
        a, b = ranks[a_rank], ranks[b_rank]
        assert len(a["whole"]) == len(b["whole"]) > 0
        for x, y in zip(a["whole"], b["whole"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["params"]),
                        jax.tree.leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    full = [x.shape for x in jax.tree.leaves(ranks[0]["params"])]
    for shape, whole, d in zip(ranks[0]["shapes"], full, fd):
        if d is not None:
            assert shape[d] * 2 == whole[d]


def test_trainer_fsdp_grad_norm_equals_reference(runs):
    """The xla run's telemetry: every step's ``grad_norm`` (an FSDP
    leaf's squares summed over the data group, a whole one's counted
    once, then over the pods) within 1e-5 relative of the reference's."""
    _, port, ref = runs
    want = ref["llama-xla"]["grad_norm"]
    assert len(want) == STEPS
    for got in port["llama-xla"]:
        np.testing.assert_allclose(got["grad_norm"], want, rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("name", FSDP_CASES)
def test_trainer_fsdp_collectives_equal_dry_run(runs, name):
    """One rank's first step: the collectives the world recorded, record
    for record, equal the dry-run's count of that rank's step on meta
    tensors (``launch/dryrun.py::count_train_step`` with ``fsdp_axis``);
    two all-gathers and a reduce-scatter of each FSDP leaf a layer and a
    microbatch among them, over the data group."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import TrainConfig
    specs, port, _ = runs
    spec = specs[name]
    mesh = Mesh(spec["mesh"], spec["axes"])
    tcfg = TrainConfig(**spec["tcfg"])
    rows = B // spec["mesh"][0] // 2
    batch = {k: torch.empty((rows, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    for r, got in enumerate(port[name]):
        tot = D.count_train_step(_port_config(spec), tcfg, mesh, batch,
                                 rps_axes=("pod",), rank=r,
                                 fsdp_axis="data")
        assert [tuple(x) for x in tot["records"]] == \
            [tuple(x) for x in got["records"]], r
        n_fsdp = sum(d is not None for d in got["fsdp_dims"])
        per = n_fsdp * _port_config(spec).n_layers * tcfg.microbatch
        counts = tot["collective_counts"]
        data_rs = sum(1 for op, _, n in got["records"]
                      if op == "reduce_scatter" and n == 2)
        assert data_rs >= per and counts["all_gather"] >= 2 * per


def test_fsdp_roundtrip_shard_gather(runs):
    """``shard_replica`` then ``gather_replica`` over data and model on a
    (2, 2) mesh gives the replica back bit for bit on every rank; each
    rank's shard is its contiguous part of each dim, by its index over
    the axis."""
    _, port, _ = runs
    for got in port["roundtrip"]:
        assert got["equal"] and got["both"] > 0 and got["fsdp_only"] > 0


def test_fsdp_dims_follow_the_rules():
    """llama3-405b reduced: every projection's FSDP dim is its second
    large dim (``wq`` / ``wk`` / ``wv`` d, the output projections their
    output d, the MLP's d); the embeddings and norms stay whole; a data
    axis of 1 shards nothing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    cfg = get_config("llama3-405b").reduced()
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    dims = sharding.local_fsdp_dims(replica, cfg, Mesh((2, 2),
                                                       ("pod", "data")))
    layer = dims["layers"]["attn"]
    assert dims["embed"] == {"tok": None, "head": None, "final_norm": None}
    assert layer["attn"] == {"wq": 1, "wk": 1, "wv": 1, "wo": 3}
    assert layer["mlp"] == {"wi": 1, "wg": 1, "wo": 2}
    assert layer["ln1"] is None and layer["ln2"] is None
    one = sharding.local_fsdp_dims(replica, cfg, Mesh((4, 1),
                                                      ("pod", "data")))
    assert all(d is None for d in jax.tree.leaves(
        one, is_leaf=lambda x: x is None))


@pytest.mark.parametrize("case", ["replica-axis", "no-axis", "model-axis",
                                  "divide", "moe-tp"])
def test_trainer_fsdp_refusals(case):
    """Each refusal is a ValueError that names its reason: FSDP over the
    replicas' axis, an FSDP axis the mesh lacks or the "model" axis, an
    FSDP dim that does not divide by its axis. The MoE on a "model" axis
    > 1 with FSDP runs: kimi-k2 reduced builds under TP x FSDP on (2, 2)
    ("data", "model"), its experts split over "model" (E 4: the width
    branch) and laid over "data" along their other dim."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    arch = "kimi-k2-1t-a32b" if case == "moe-tp" else "llama3-405b"
    cfg = get_config(arch).reduced()
    mesh, rps, fsdp, want = Mesh((2, 2), ("pod", "data")), ("pod",), \
        "data", None
    if case == "replica-axis":
        rps, want = ("pod", "data"), r"among rps_axes.*FSDP over the axis " \
            r"that holds the replicas"
    elif case == "no-axis":
        fsdp, want = "fsdp", r"FSDP needs a data axis"
    elif case == "model-axis":
        mesh, fsdp = Mesh((2, 2), ("data", "model")), "model"
        rps, want = ("data",), r"FSDP needs a data axis"
    elif case == "divide":
        # d 48: a multiple of 16 (the rule shards it), not of 32
        cfg = dataclasses.replace(cfg, d_model=48)
        mesh = Mesh((1, 32), ("pod", "data"))
        want = r"FSDP dim \d of \(2, 48, .*\) does not divide over the " \
            r"'data' axis of 32"
        with pytest.raises(ValueError, match=want):
            sharding.local_fsdp_dims(build_model(
                cfg, device="meta").init_stacked(MetaGenerator()), cfg, mesh)
    else:
        mesh, rps = Mesh((2, 2), ("data", "model")), ()
        _, step, _ = make_train_setup(
            build_model(cfg, device="meta"), cfg,
            TrainConfig(aggregator="rps_grad"), mesh.as_rank(0),
            rps_axes=rps, fsdp_axis=fsdp)
        layer, = step.model_dims["layers"].values()
        assert layer["moe"] == {"router": None, "wi": 3, "wg": 3, "wo": 3}
        layer, = step.fsdp_dims["layers"].values()
        assert layer["moe"] == {"router": None, "wi": 2, "wg": 2, "wo": 2}
        assert step.tp.size == step.fsdp.group.size == 2
        return
    model = build_model(cfg, device="meta")
    with pytest.raises(ValueError, match=want):
        make_train_setup(model, cfg, TrainConfig(aggregator="rps_grad"),
                         mesh.as_rank(0), rps_axes=rps, fsdp_axis=fsdp)


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_local_batch_hands_out_rows_by_microbatch(mb):
    """``sharding.local_batch`` on a (2, 2) ("pod", "data") mesh: a
    rank's j-th microbatch is its share, by its index over "data", of
    the j-th contiguous microbatch of its pod's rows (the reference's
    microbatch j), and the ranks of a pod hold every row once."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    rows = 16
    batch = {"tokens": torch.arange(2 * rows * 3).reshape(2, rows, 3)}
    mesh = Mesh((2, 2), ("pod", "data"))
    for pod in range(2):
        seen = []
        for d in range(2):
            got = sharding.local_batch(batch, mesh.as_rank(2 * pod + d),
                                       ("pod",), ("data",), mb)["tokens"]
            per = rows // mb
            for j, part in enumerate(got.reshape((mb, per // 2, 3))):
                want = batch["tokens"][pod, j * per:(j + 1) * per]
                assert torch.equal(part, want[d * per // 2:
                                              (d + 1) * per // 2])
            seen.append(got)
        assert sorted(torch.cat(seen)[:, 0].tolist()) == \
            batch["tokens"][pod, :, 0].tolist()
