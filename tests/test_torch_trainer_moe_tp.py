"""The MoE's tensor parallelism on the port's mesh trainer
(``repro_torch.train.trainer`` on a "model" axis > 1 with experts, gloo on
the CPU) against the reference's ``make_train_setup`` under GSPMD on
forced host devices.

``launch/sharding.py::_rule`` lays the MoE's expert leaves over "model"
in one of two branches, and the router stays whole in both:

- the expert branch, where E divides by 16 (kimi-k2's 384): the expert
  dim of ``wi`` / ``wg`` / ``wo``; each rank runs its experts' share of
  the dispatch and the combine's partial output is summed over the group;
- the width branch otherwise (mixtral-8x22b's 8, every reduced config's
  4): ``wi`` / ``wg`` split d_ff, ``wo`` splits d, its last dim; the
  hidden activation is joined over d_ff and the output over d
  (``core/comm.py::gather_from``).

A config built here as the dense TP test's (2 layers, d 64, 16 query
and 4 KV heads of 8, d_ff 128, vocab 256, f32) with 16 experts (the
expert branch) or 4 (the width branch), top 2. From the reference's
initial replica, on the same rows and the reference's masks, SGD, 3
steps each:

- (a) the expert branch, ``rps_model`` on (2, 2) ("data", "model"), the
  xla engine;
- (b) the expert branch on the ring engine with 2 buckets (the TP
  buckets of a 4-D expert leaf whose model dim is 1);
- (c) the width branch, ``rps_model`` on (2, 2), the xla engine;
- (d) kimi-k2's layout in small: the expert branch at top 8,
  ``rps_grad`` on (1, 2, 2) ("pod", "data", "model"), FSDP over "data",
  microbatch 2.

Every step's loss and every parameter of the replica gathered over the
model (and data) group within 1e-5; the leaves the rule keeps whole (the
router among them) bit for bit equal on the ranks of a model group. In
the same world: each branch's sharded MoE layer against ``tp=None``
(forward within 1e-6 of the output's scale, gradients within 1e-5), and
the first step's collectives on every rank equal to the dry-run's count
of that rank's step on meta tensors. The reference's FSDP run takes
``check_vma=False`` (``tests/test_torch_trainer_fsdp.py``). Measured
against the reference on the CPU: losses within 9.5e-7, parameters
within 2.4e-7; the expert branch's layer equals ``tp=None`` bit for bit
at top 2, the width branch's gradients within 3.4e-6.
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

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import rps as jrps
from repro.models import build_model as jbuild_model

import _torch_dist as td

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
TOL = 1e-5
FWD_TOL, GRAD_TOL = 1e-6, 1e-5
B, S = 8, 16
BASE = dict(name="tp-moe", family="dense", n_layers=2, d_model=64,
            n_heads=16, n_kv_heads=4, head_dim=8, d_ff=128, vocab_size=256,
            max_seq=4096, dtype="float32")
EXPERT = dict(BASE, n_experts=16, top_k=2)
WIDTH = dict(BASE, n_experts=4, top_k=2)
KIMI = dict(BASE, n_experts=16, top_k=8)
SGD = dict(optimizer="sgd", lr=0.1, drop_rate=0.3)
DM = dict(mesh=(2, 2), axes=("data", "model"), rps_axes=("data",))

CONFIGS = {
    "expert-xla": dict(cfg=EXPERT, **DM,
                       tcfg=dict(SGD, aggregator="rps_model", engine="xla")),
    "expert-ring-buckets": dict(cfg=EXPERT, **DM,
                                tcfg=dict(SGD, aggregator="rps_model",
                                          engine="ring", n_buckets=2)),
    "width-xla": dict(cfg=WIDTH, **DM,
                      tcfg=dict(SGD, aggregator="rps_model", engine="xla")),
    "kimi-fsdp-mb2": dict(cfg=KIMI, mesh=(1, 2, 2),
                          axes=("pod", "data", "model"), rps_axes=("pod",),
                          fsdp_axis="data",
                          tcfg=dict(SGD, aggregator="rps_grad", engine="xla",
                                    microbatch=2)),
}
LAYERS = dict(fn="_torch_dist.tp_layers_case", mesh=(2, 2),
              axes=("data", "model"), seed=11, B=2, S=12,
              cfg=dict(BASE, vocab_size=200), attn={},
              moe={"expert": EXPERT, "width": WIDTH,
                   # the width branch where the rule splits one side:
                   # d_ff over "model" but not d (72), and d but not
                   # d_ff (120)
                   "width-in": dict(WIDTH, d_model=72),
                   "width-out": dict(WIDTH, d_ff=120)})


def _port_config(fields):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**fields)


def _n_buckets(spec) -> int:
    """The port's plan's bucket count on the (shape-only) mesh, which the
    reference's in-step draw sizes its per-bucket masks by."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.train.trainer import TrainConfig, train_plan
    cfg = _port_config(spec["cfg"])
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    plan = train_plan(cfg, TrainConfig(**spec["tcfg"]),
                      Mesh(spec["mesh"], spec["axes"]), replica,
                      rps_axes=spec["rps_axes"],
                      fsdp_axis=spec.get("fsdp_axis"))
    return plan.n_buckets if plan is not None and plan.per_bucket_masks \
        else 0


def _inputs():
    """Every case's reference initial replica, worker-stacked batch and
    per-step masks, made in process."""
    specs = {}
    for name, c in CONFIGS.items():
        p1 = jax.tree.map(np.asarray, jbuild_model(
            JArchConfig(**c["cfg"]), grouped=False).init(
                jax.random.PRNGKey(0)))
        n_rps = c["mesh"][0]
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, BASE["vocab_size"],
                                 (n_rps, B // n_rps, S), dtype=np.int32)
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
        specs[name] = dict(c, fn="_torch_dist.trainer_tp_case", p1=p1,
                           steps=STEPS, masks=masks, n_buckets=nb,
                           batch=batch)
    return specs


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import functools
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.models import build_model
    from repro.train.trainer import TrainConfig, make_train_setup

    specs = pickle.load(open(sys.argv[1], "rb"))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    specs = {k: specs[k] for k in sorted(specs)[part::parts]}
    auto = jax.sharding.AxisType.Auto
    shard_map = jax.shard_map
    out = {}
    for name, c in specs.items():
        fsdp_axis = c.get("fsdp_axis")
        # under FSDP, the reference's _shard_map's check_rep=False of
        # jax < 0.6 (tests/test_torch_trainer_fsdp.py)
        jax.shard_map = functools.partial(shard_map, check_vma=False) \\
            if fsdp_axis else shard_map
        cfg = ArchConfig(**c["cfg"])
        model = build_model(cfg, grouped=False)
        mesh = jax.make_mesh(c["mesh"], c["axes"],
                             axis_types=(auto,) * len(c["axes"]))
        tcfg = TrainConfig(**c["tcfg"])
        init_state, train_step, state_shardings = make_train_setup(
            model, cfg, tcfg, mesh, rps_axes=tuple(c["rps_axes"]),
            fsdp_axis=fsdp_axis)
        plan = train_step.plan
        assert plan.n_buckets == c["n_buckets"] or not plan.per_bucket_masks
        n = c["mesh"][0]
        params = jax.tree.map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + x.shape),
            c["p1"])
        p_sh, _ = state_shardings(jax.eval_shape(lambda t: t, params))
        params = jax.device_put(params, p_sh)
        opt_state = ()
        batch = jax.tree.map(jnp.asarray, c["batch"])
        losses = []
        with jax.set_mesh(mesh):
            step = jax.jit(train_step)
            for t in range(%d):
                params, opt_state, met = step(
                    params, opt_state, batch, jnp.int32(t),
                    jax.random.PRNGKey(100 + t))[:3]
                losses.append(float(met["loss"]))
        out[name] = {"loss": np.array(losses),
                     "params": jax.tree.map(np.asarray, params)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % (SRC, STEPS)
PARTS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_moe_tp")
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


def _model_pairs(spec):
    """The ranks of each model group of the case's mesh."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(spec["mesh"], spec["axes"])
    return sorted({tuple(mesh.group_ranks(("model",), r)) for r in range(4)})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_moe_tp_equals_reference(runs, name):
    """Losses and the replica gathered over the model (and data) group
    against the reference's run: the rank's RPS worker's replica row; the
    trainer's initial shards are ``convert.shards_from_jax`` of the
    reference's replica."""
    specs, port, ref = runs
    want = ref[name]
    n_rps = specs[name]["mesh"][0]
    for r, got in enumerate(port[name]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r} losses")
        w = r // (4 // n_rps)
        flat_got = jax.tree.leaves(got["params"])
        flat_want = jax.tree.leaves(jax.tree.map(lambda x: x[w],
                                                 want["params"]))
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                       err_msg=f"rank {r} params")
        assert got["init_equal"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_moe_tp_whole_leaves_bitwise_across_model_group(runs,
                                                                 name):
    """The leaves the rule keeps whole (the router, the norms, ``wk`` /
    ``wv``) are the same bits on both ranks of each model group, and the
    shards gather into the same replica there; the expert leaves arrive
    cut along the branch's dims."""
    specs, port, _ = runs
    ranks = port[name]
    dims = ranks[0]["dims"]
    for a_rank, b_rank in _model_pairs(specs[name]):
        a, b = ranks[a_rank], ranks[b_rank]
        assert len(a["whole"]) == len(b["whole"]) > 0
        for x, y in zip(a["whole"], b["whole"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["params"]),
                        jax.tree.leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    from repro_torch import tree as tree_lib
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    cfg = _port_config(specs[name]["cfg"])
    replica = build_model(cfg, device="meta").init_stacked(MetaGenerator())
    want = sharding.local_model_dims(
        replica, cfg, Mesh(specs[name]["mesh"], specs[name]["axes"]))
    assert tree_lib.leaves(want) == dims
    expert = cfg.n_experts % 16 == 0
    assert want["layers"]["moe_attn"]["moe"] == (
        {"router": None, "wi": 1, "wg": 1, "wo": 1} if expert else
        {"router": None, "wi": 3, "wg": 3, "wo": 3})


@pytest.mark.parametrize("branch", ["expert", "width", "width-in",
                                    "width-out"])
def test_moe_tp_layer_equals_unsharded(runs, branch):
    """Each branch's sharded MoE layer (its output plus its aux term) on
    every rank against ``tp=None`` on the full weights: forward within
    1e-6 of the output's largest magnitude (at least 1), the gradients
    (the shards' gathered, the router's and the input's) within 1e-5;
    the width branch also where the rule splits ``wi`` / ``wg`` alone
    (d 72 does not divide by 16) or ``wo`` alone (d_ff 120)."""
    _, port, _ = runs
    want = {"width-in": ["moe/wg", "moe/wi"],
            "width-out": ["moe/wo"]}.get(branch,
                                          ["moe/wg", "moe/wi", "moe/wo"])
    for r, got in enumerate(port["layers"]):
        res = got["moe-" + branch]
        assert res["sharded"] == want, (r, res)
        assert res["fwd"] <= FWD_TOL * max(1.0, res["scale"]), (r, res)
        assert res["grad"] <= GRAD_TOL, (r, res)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_moe_tp_collectives_equal_dry_run(runs, name):
    """One rank's first step: the collectives the world recorded, record
    for record, equal the dry-run's count of that rank's step on meta
    tensors (``launch/dryrun.py::count_train_step``); the MoE's own
    among them: the expert branch's combine all-reduced over the model
    group, the width branch's hidden and output all-gathered."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import TrainConfig
    specs, port, _ = runs
    spec = specs[name]
    mesh = Mesh(spec["mesh"], spec["axes"])
    tcfg = TrainConfig(**spec["tcfg"])
    fsdp = spec.get("fsdp_axis")
    rows = B // spec["mesh"][0] // (2 if fsdp else 1)
    batch = {k: torch.empty((rows, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    cfg = _port_config(spec["cfg"])
    tokens = rows // tcfg.microbatch * S
    for r, got in enumerate(port[name]):
        tot = D.count_train_step(cfg, tcfg, mesh, batch,
                                 rps_axes=spec["rps_axes"], rank=r,
                                 fsdp_axis=fsdp)
        assert [tuple(x) for x in tot["records"]] == \
            [tuple(x) for x in got["records"]], r
        combine = sum(1 for op, nb, n in got["records"]
                      if op == "all_reduce" and n == 2
                      and nb == tokens * cfg.d_model * 4)
        gathers = sum(1 for op, _, n in got["records"]
                      if op == "all_gather" and n == 2)
        per = cfg.n_layers * tcfg.microbatch
        if cfg.n_experts % 16 == 0:
            # each layer's combine, and its tokens' and the attention's
            # gradients entering the region, of (T, d)
            assert combine >= 2 * per, (r, combine)
        else:
            assert gathers >= 2 * per, (r, gathers)


def test_gather_from_on_meta_through_as_rank():
    """``comm.gather_from`` on a shape-only mesh's rank: the group's
    parts joined along the dim (recorded as one ``all_gather``, nothing
    sent); backward this rank's part of the gradient, nothing
    recorded."""
    from repro_torch.core import comm
    from repro_torch.launch.mesh import Mesh
    group = Mesh((2, 4), ("data", "model")).as_rank(6).group(("model",))
    x = torch.empty((3, 5, 2), device="meta", requires_grad=True)
    with comm.recording() as rec:
        y = comm.gather_from(x, group, 2)
        g, = torch.autograd.grad(y, x, torch.empty_like(y))
    assert y.shape == (3, 5, 8) and g.shape == (3, 5, 2)
    assert rec == [("all_gather", 3 * 5 * 8 * 4, 4)]
    assert comm.gather_from(x, Mesh((4, 1), ("data", "model")).as_rank(
        0).group(("model",)), 2) is x
