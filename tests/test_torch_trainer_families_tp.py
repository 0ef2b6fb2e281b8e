"""Tensor parallelism inside a replica for the ssm, hybrid, audio and vlm
families on the port's mesh trainer (``repro_torch.train.trainer`` on a
"model" axis > 1, gloo on the CPU) against the reference's
``make_train_setup`` under GSPMD on forced host devices.

``launch/sharding.py::_rule`` lays these leaves over "model":

- ssm (RWKV-6): every projection's last dim. ``wr`` / ``wk`` / ``wv`` /
  ``wg`` / ``ck`` are column-parallel (each rank its heads of r, k, v);
  ``wo`` / ``cr`` / ``cv`` split their output dim, so their input is
  joined over the group (``comm.gather_shard``) and their output leaves
  through ``comm.gather_from``; the decay LoRA, ``w0`` and ``u`` stay
  whole and enter the region through ``copy_to`` before they are cut;
- hybrid (RG-LRU): ``wy`` / ``wx`` / ``conv`` over dr (the recurrence on
  the rank's channels), ``wa`` / ``wi`` over their output dr (the conv's
  output joined), ``wo`` over d; ``lam`` whole, through ``copy_to``; the
  local attention and the MLPs as the dense family's;
- audio (Whisper): the encoder's and the decoder's attention and MLPs as
  the dense family's; the cross-attention's query heads, its K/V heads
  whole here (4 do not divide by 16: ``parallel.local_kv``);
- vlm: the dense backbone, the patch rows after the vocab-parallel
  lookup.

One small f32 config a family, every sharded dim divisible by 16: ssm 2
layers, d 64, 4 heads of 16, d_ff 128, vocab 256; hybrid 3 layers (rec,
rec, attn), d_state 64, 16 query heads and 1 KV head of 8, window 8 at S
32 (the blocked local route); audio 2 encoder and 2 decoder layers, 16
heads, 4 KV heads of 8; vlm 2 layers, 16 heads, 4 KV heads, 4 patches,
window 8 at S 20. From the reference's initial replica, on the same rows
and the reference's masks, SGD, 3 steps each:

- each family's ``rps_model`` on (2, 2) ("data", "model"): ssm and
  audio on the xla engine, hybrid and vlm on the ring engine with 2
  buckets;
- ssm on (1, 2, 2) ("pod", "data", "model") with ``rps_grad`` and FSDP
  over "data" (the rule gives the RWKV-6 projections an FSDP dim).

Every step's loss and every parameter of the replica gathered over the
model (and data) group within 1e-5; the leaves the rule keeps whole bit
for bit equal on the ranks of a model group. In the same world: one
layer of each kind (and of the rule's mixed cases: a whole d_ff or dr
beside a split d, and the reverse; the cross-attention with its KV heads
split) through ``models/stack.py``'s train pass against ``tp=None``
(forward within 1e-6 of the output's scale, gradients within 1e-5 of
theirs), and the first step's collectives on every rank equal to the
dry-run's count of that rank's step on meta tensors. The reference's
FSDP run takes ``check_vma=False`` (``tests/test_torch_trainer_fsdp.py``).
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
B = 8
BASE = dict(max_seq=4096, dtype="float32", vocab_size=256, d_model=64,
            d_ff=128)
SSM = dict(BASE, name="tp-ssm", family="ssm", n_layers=2, n_heads=4,
           n_kv_heads=4, head_dim=16)
HYBRID = dict(BASE, name="tp-hybrid", family="hybrid", n_layers=3,
              n_heads=16, n_kv_heads=1, head_dim=8, window=8,
              block_pattern=("rec", "rec", "attn"), d_state=64)
AUDIO = dict(BASE, name="tp-audio", family="audio", n_layers=2,
             enc_layers=2, n_heads=16, n_kv_heads=4, head_dim=8)
VLM = dict(BASE, name="tp-vlm", family="vlm", n_layers=2, n_heads=16,
           n_kv_heads=4, head_dim=8, window=8, n_patches=4)
# each config's sequence (the vlm's: 4 patch rows and 16 tokens)
SEQ = {"tp-ssm": 16, "tp-hybrid": 32, "tp-audio": 16, "tp-vlm": 20}
SGD = dict(optimizer="sgd", lr=0.1, drop_rate=0.3)
DM = dict(mesh=(2, 2), axes=("data", "model"), rps_axes=("data",))
XLA = dict(SGD, aggregator="rps_model", engine="xla")
RING = dict(SGD, aggregator="rps_model", engine="ring", n_buckets=2)

CONFIGS = {
    "ssm-xla": dict(cfg=SSM, **DM, tcfg=XLA),
    "hybrid-ring-buckets": dict(cfg=HYBRID, **DM, tcfg=RING),
    "audio-xla": dict(cfg=AUDIO, **DM, tcfg=XLA),
    "vlm-ring-buckets": dict(cfg=VLM, **DM, tcfg=RING),
    "ssm-fsdp": dict(cfg=SSM, mesh=(1, 2, 2), axes=("pod", "data", "model"),
                     rps_axes=("pod",), fsdp_axis="data",
                     tcfg=dict(SGD, aggregator="rps_grad", engine="xla")),
}
# one layer of each kind: (config fields, kind), and what the rule
# shards of it
KINDS = {
    "rwkv": (SSM, "rwkv"),
    # d_ff 120: ck whole, cv (its last dim d) split
    "rwkv-ff-whole": (dict(SSM, d_ff=120), "rwkv"),
    # d 72: the time-mix and cr / cv whole, ck split
    "rwkv-d-whole": (dict(SSM, d_model=72, head_dim=18), "rwkv"),
    "rec": (HYBRID, "rec"),
    # dr 72: the recurrent width whole, wo (its last dim d) split
    "rec-dr-whole": (dict(HYBRID, d_state=72), "rec"),
    # d 72: wo whole, the recurrent width split
    "rec-d-whole": (dict(HYBRID, d_model=72), "rec"),
    "hybrid-attn": (HYBRID, "attn@8"),
    "enc": (AUDIO, "enc"),
    "xattn": (AUDIO, "xattn"),
    "xattn-kv-split": (dict(AUDIO, n_kv_heads=16), "xattn"),
    "vlm-attn": (VLM, "attn@8"),
}
_RWKV = ["rwkv/ck", "rwkv/cr", "rwkv/cv", "rwkv/wg", "rwkv/wk", "rwkv/wo",
         "rwkv/wr", "rwkv/wv"]
_MLP = ["mlp/wg", "mlp/wi", "mlp/wo"]
_REC = ["rec/conv", "rec/wa", "rec/wi", "rec/wo", "rec/wx", "rec/wy"]
_ATTN = ["attn/wo", "attn/wq"]
SHARDED = {
    "rwkv": _RWKV,
    "rwkv-ff-whole": [n for n in _RWKV if n != "rwkv/ck"],
    "rwkv-d-whole": ["rwkv/ck"],
    "rec": sorted(_MLP + _REC),
    "rec-dr-whole": sorted(_MLP + ["rec/wo"]),
    "rec-d-whole": sorted(_MLP + [n for n in _REC if n != "rec/wo"]),
    "hybrid-attn": sorted(_ATTN + _MLP),
    "enc": sorted(_ATTN + _MLP),
    "xattn": sorted(_ATTN + _MLP + ["xattn/wo", "xattn/wq"]),
    "xattn-kv-split": sorted(_ATTN + ["attn/wk", "attn/wv"] + _MLP
                             + ["xattn/wk", "xattn/wo", "xattn/wq",
                                "xattn/wv"]),
    "vlm-attn": sorted(_ATTN + _MLP),
}
LAYERS = dict(fn="_torch_dist.tp_kinds_case", mesh=(2, 2),
              axes=("data", "model"), seed=11, B=2, S=32, kinds=KINDS)


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


def _batch(cfg_fields, n_rps: int, rng) -> dict:
    """A worker-stacked batch (n_rps, B / n_rps, ...) of the family's
    inputs (``models/inputs.py::train_specs``): token ids below the
    vocab, normal frames and patches."""
    from repro_torch.models.inputs import train_specs
    cfg = _port_config(cfg_fields)
    out = {}
    for k, spec in train_specs(cfg, B // n_rps, SEQ[cfg.name]).items():
        shape = (n_rps,) + tuple(spec.shape)
        out[k] = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32) \
            if spec.dtype == torch.int32 \
            else rng.standard_normal(shape).astype(np.float32)
    return out


def _inputs():
    """Every case's reference initial replica, worker-stacked batch and
    per-step masks, made in process."""
    specs = {}
    for name, c in CONFIGS.items():
        p1 = jax.tree.map(np.asarray, jbuild_model(
            JArchConfig(**c["cfg"]), grouped=False).init(
                jax.random.PRNGKey(0)))
        n_rps = c["mesh"][0]
        batch = _batch(c["cfg"], n_rps, np.random.default_rng(3))
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
PARTS = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_families_tp")
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
def test_trainer_families_tp_equals_reference(runs, name):
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
def test_trainer_families_tp_whole_leaves_bitwise_across_model_group(
        runs, name):
    """The leaves the rule keeps whole (the norms, RWKV-6's lerp
    coefficients, decay LoRA, ``w0`` and ``u``, RG-LRU's ``lam``, the
    whole KV heads) are the same bits on both ranks of each model group,
    and the shards gather into the same replica there; the sharded dims
    are the rule's (``sharding.local_model_dims``)."""
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
    assert any(d is not None for d in dims)


@pytest.mark.parametrize("label", list(KINDS))
def test_families_tp_layer_equals_unsharded(runs, label):
    """One layer of each kind through the stack's train pass on every
    rank's shards against ``tp=None`` on the full weights: forward within
    1e-6 of the output's largest magnitude (at least 1), the gradients
    (the shards' gathered, the whole leaves', the input's and the
    encoder output's) within 1e-5 of the largest gradient (at least 1);
    the leaves the rule splits as listed."""
    _, port, _ = runs
    for r, got in enumerate(port["layers"]):
        res = got[label]
        assert res["sharded"] == SHARDED[label], (r, res)
        assert res["fwd"] <= FWD_TOL * max(1.0, res["scale"]), (r, res)
        assert res["grad"] <= GRAD_TOL * max(1.0, res["grad_scale"]), \
            (r, res)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_families_tp_collectives_equal_dry_run(runs, name):
    """One rank's first step: the collectives the world recorded, record
    for record, equal the dry-run's count of that rank's step on meta
    tensors (``launch/dryrun.py::count_train_step``); the joins of the
    split-output products among them (all-gathers over the model group,
    and for the ssm and the hybrid reduce-scatters over it, the
    backward of ``gather_shard``)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.inputs import train_specs
    from repro_torch.train.trainer import TrainConfig
    specs, port, _ = runs
    spec = specs[name]
    mesh = Mesh(spec["mesh"], spec["axes"])
    tcfg = TrainConfig(**spec["tcfg"])
    fsdp = spec.get("fsdp_axis")
    cfg = _port_config(spec["cfg"])
    rows = B // spec["mesh"][0] // (2 if fsdp else 1)
    batch = train_specs(cfg, rows, SEQ[cfg.name])
    for r, got in enumerate(port[name]):
        tot = D.count_train_step(cfg, tcfg, mesh, batch,
                                 rps_axes=spec["rps_axes"], rank=r,
                                 fsdp_axis=fsdp)
        assert [tuple(x) for x in tot["records"]] == \
            [tuple(x) for x in got["records"]], r
        ops = {}
        for op, _, n in got["records"]:
            ops[(op, n)] = ops.get((op, n), 0) + 1
        assert ops.get(("all_reduce", 2), 0) > 0
        if cfg.family in ("ssm", "hybrid"):
            assert ops.get(("reduce_scatter", 2), 0) > 0
            assert ops.get(("all_gather", 2), 0) > 0


def test_check_family_refuses_a_split_rwkv_head():
    """The rule lays RWKV-6's time-mix channels over "model"; a model
    group that would split a head across ranks is refused by name (every
    family otherwise runs, whatever its width)."""
    from repro_torch.models import parallel
    cfg = _port_config(SSM)
    for size in (1, 2, 4):
        parallel.check_family(cfg, size)
    with pytest.raises(ValueError, match="split a head across ranks"):
        parallel.check_family(cfg, 8)
    for fields in (HYBRID, AUDIO, VLM, dict(SSM, d_model=72)):
        parallel.check_family(_port_config(fields), 8)
