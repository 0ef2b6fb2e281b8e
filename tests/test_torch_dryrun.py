"""The port's dry-run (``launch/dryrun.py``) against the JAX package's.

The reference's ``repro.launch.dryrun`` forces 512 host devices when it
is imported, so its side runs in one subprocess: the static layout of a
``train_4k`` step for every architecture on both production meshes (its
``make_train_setup`` on ``jax.eval_shape``, no lowering: the exchange
plan's ``describe()``, the state bytes, ``pick_microbatch``,
``rps_axes_for``), the decode caches' spec trees, ``_serve_fsdp``,
``model_flops_global``, and ``measure(compiled)["flops"]`` of three
reduced configs compiled unrolled (``grouped=False``).

- the layout and the helpers: exactly equal;
- counted FLOPs (dense, MoE): the port counts the products, convolutions
  and attention; XLA's count also holds the elementwise ops, so the port
  reads at most the reference's and at least 97 % of it;
- rwkv6: the port's train route takes each 64-step chunk in closed form
  (products), the reference's scans it step by step (elementwise outer
  products, its scan body counted once): the port counts more, and
  ROADMAP C logs the values;
- the reference at microbatch 2 counts its microbatch scan's body once
  (half the step's FLOPs; ROADMAP C); the port counts both microbatches.
"""
import json
import os
import pickle
import subprocess
import sys

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
XLA_QUICK = ("--xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
MESHES = ("16x16", "2x16x16")
FLOP_ARCHS = ("deepseek-7b", "mixtral-8x22b", "rwkv6-1.6b")
DECODE = ("decode_32k", "long_500k")

CACHE_CASES = [(a, sh, m) for a in ARCH_IDS for sh in DECODE for m in MESHES
               if get_config(a).runs_shape(SHAPES[sh])]


def _spec_items(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_items(v, path + (k,)))
        return out
    return {path: tree}


def _cache_rows(arch, shape, mesh):
    """The port's decode row: its totals (None: layout only) and the
    layer-stacked cache's {path: (shape, spec)}."""
    from repro_torch.models.stack import stack_layers
    cfg = get_config(arch)
    totals, info = D.build_decode_counted(cfg, SHAPES[shape],
                                          D.make_mesh(mesh))
    model = D._meta_model(cfg)
    cache = stack_layers(model.init_cache(SHAPES[shape].global_batch,
                                          SHAPES[shape].seq_len),
                         model.kinds)
    shapes = {p: tuple(t.shape) for p, t in _spec_items(cache).items()}
    specs = _spec_items(info["cache_specs"])
    return totals, {p: (shapes[p], specs[p]) for p in shapes}


_REF = r'''
import dataclasses as dc, pickle, sys
sys.path.insert(0, sys.argv[2])
from repro.launch import dryrun as D          # forces 512 host devices
import jax, numpy as np
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch.mesh import make_production_mesh, rps_axes_for
from repro.models import build_model
from repro.optim import statepack
from repro.roofline.analysis import measure
from repro.train.trainer import TrainConfig, make_train_setup


def keystr(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def info_of(cfg, shape, mesh):
    """build_train_lowered's setup, without the lowering."""
    cfg = dc.replace(cfg, shard_acts=True, act_batch_axis="data"
                     if cfg.shard_strategy == "fsdp" else None)
    model = build_model(cfg, grouped=True)
    rps_axes = rps_axes_for(cfg.rps_mode, mesh)
    n_rps = int(np.prod([mesh.shape[a] for a in rps_axes])) if rps_axes else 1
    fsdp_axis = "data" if cfg.shard_strategy == "fsdp" else None
    b_local = shape.global_batch // max(n_rps, 1)
    min_bm = mesh.shape["data"] if cfg.shard_strategy == "fsdp" else 1
    mb = D.pick_microbatch(cfg, b_local, shape.seq_len, budget_bytes=128e6,
                           min_b_micro=min_bm)
    agg = cfg.rps_mode if rps_axes else "none"
    O = D.OVERRIDES
    tcfg = TrainConfig(optimizer=O["optimizer"], lr=0.05,
                       drop_rate=D.DROP_RATE, aggregator=agg, microbatch=mb,
                       exchange_dtype=O["exchange_dtype"],
                       exchange_every=O["exchange_every"],
                       bucket_mb=O["bucket_mb"], n_buckets=O["n_buckets"],
                       engine=O["engine"], wire=O["wire"],
                       recovery=O["recovery"], state_pack=O["state_pack"])
    init_state, train_step, _ = make_train_setup(
        model, cfg, tcfg, mesh, rps_axes=rps_axes, fsdp_axis=fsdp_axis)
    params_shape, opt_shape = jax.eval_shape(init_state,
                                             jax.random.PRNGKey(0))
    return {"n_rps": n_rps, "microbatch": mb, "aggregator": agg,
            "state_pack": train_step.state_pack.name,
            "state_bytes": statepack.state_bytes_breakdown(
                params=params_shape, opt_state=opt_shape, ef_state=None),
            "exchange_plan": train_step.plan.describe()
            if train_step.plan is not None else None,
            "rps_axes": tuple(rps_axes)}


def cache_specs(cfg, shape, mesh):
    model = build_model(cfg, grouped=True)
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    specs = D._cache_spec_tree(cache, cfg, mesh, data_axes)
    leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
    sp = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {keystr(p): (tuple(l.shape), tuple(s))
            for (p, l), (_, s) in zip(leaves, sp)}


out = {"layout": {}, "cache": {}, "serve_fsdp": {}, "mflops": {},
       "flops": {}}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    name = "2x16x16" if multi else "16x16"
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        out["layout"][(arch, name)] = info_of(cfg, SHAPES["train_4k"], mesh)
        for sh in ("decode_32k", "long_500k"):
            if cfg.runs_shape(SHAPES[sh]):
                out["cache"][(arch, sh, name)] = cache_specs(
                    cfg, SHAPES[sh], mesh)
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["serve_fsdp"][arch] = D._serve_fsdp(cfg)
    for sh, shape in SHAPES.items():
        out["mflops"][(arch, sh)] = D.model_flops_global(cfg, shape)
mesh1 = jax.make_mesh((1, 1), ("data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch, B, S, mb in [(a, 2, 64, 1) for a in sys.argv[3].split(",")] \
        + [("deepseek-7b", 4, 64, 2)]:
    cfg = get_config(arch + "-reduced")
    lowered, _ = D.build_train_lowered(cfg, D.ShapeConfig("t", S, B, "train"),
                                       mesh1, microbatch=mb, grouped=False)
    out["flops"][(arch, B, mb)] = measure(lowered.compile())["flops"]
pickle.dump(out, open(sys.argv[1], "wb"))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, and meanwhile the port's train_4k rows
    on both production meshes."""
    path = tmp_path_factory.mktemp("dryrun") / "ref.pkl"
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "XLA_FLAGS": XLA_QUICK,
                "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(path), SRC,
                             ",".join(FLOP_ARCHS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        layouts, caches = {}, {}
        for name in MESHES:
            mesh = D.make_mesh(name)
            for arch in ARCH_IDS:
                layouts[(arch, name)] = D.build_train_counted(
                    get_config(arch), SHAPES["train_4k"], mesh)
        for arch, shape, name in CACHE_CASES:
            caches[(arch, shape, name)] = _cache_rows(arch, shape, name)
    finally:
        out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, out + err
    with open(path, "rb") as f:
        return pickle.load(f), layouts, caches


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def layouts(runs):
    return runs[1]


@pytest.fixture(scope="module")
def caches(runs):
    return runs[2]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_layout_equals_reference(ref, layouts, arch, mesh):
    """n_rps, microbatch, aggregator, state pack, state bytes and the
    exchange plan's describe(); the counted terms not run (TP inside a
    replica on a "model" axis of 16)."""
    totals, info = layouts[(arch, mesh)]
    want = ref["layout"][(arch, mesh)]
    assert totals is None and "TP inside a replica" in info["not_run"]
    for key in ("n_rps", "microbatch", "aggregator", "state_pack",
                "state_bytes", "exchange_plan"):
        assert info[key] == want[key], key
    from repro_torch.launch.mesh import rps_axes_for
    assert rps_axes_for(get_config(arch).rps_mode,
                        D.make_mesh(mesh)) == want["rps_axes"]


@pytest.mark.parametrize("arch,shape,mesh", CACHE_CASES)
def test_cache_spec_trees_equal_reference(ref, caches, arch, shape, mesh):
    """The layer-stacked decode cache's shapes and spec tree; the counted
    terms not run."""
    totals, got = caches[(arch, shape, mesh)]
    assert got == ref["cache"][(arch, shape, mesh)]
    assert totals is None


def test_helpers_equal_reference(ref):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert D._serve_fsdp(cfg) == ref["serve_fsdp"][arch]
        for sh, shape in SHAPES.items():
            assert D.model_flops_global(cfg, shape) == \
                ref["mflops"][(arch, sh)]


def _counted(arch, B, mb):
    cfg = get_config(arch + "-reduced")
    totals, info = D.build_train_counted(
        cfg, ShapeConfig("t", 64, B, "train"), D.make_mesh("sim1"),
        microbatch=mb)
    assert info["microbatch"] == mb
    return totals["flops"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "mixtral-8x22b"])
def test_counted_flops_within_xla_count(ref, arch):
    """Products, attention and the MoE's expert products counted: at most
    XLA's count (which adds the elementwise ops), at least 97 % of it
    (measured: 98.86 % and 98.84 %)."""
    want = ref["flops"][(arch, 2, 1)]
    got = _counted(arch, 2, 1)
    assert 0.97 * want <= got <= want


def test_rwkv6_counts_its_closed_form_chunks(ref):
    """rwkv6-1.6b reduced at (2, 64): the port's chunk in closed form
    counts 2,868,903,936 FLOPs, the reference's step-by-step scan
    1,181,518,464 (ROADMAP C)."""
    got = _counted("rwkv6-1.6b", 2, 1)
    want = ref["flops"][("rwkv6-1.6b", 2, 1)]
    assert got == 2_868_903_936 and want == 1_181_518_464


def test_reference_counts_the_microbatch_scan_once(ref):
    """deepseek-7b reduced at (4, 64): the reference's count at
    microbatch 2 is half its count at 1 (twice its count at (2, 64), the
    count being linear in the batch; within 1 %: XLA's count of the
    accumulation); the port's counts are equal and within 97–100 % of the
    reference's at microbatch 1."""
    r1 = 2 * ref["flops"][("deepseek-7b", 2, 1)]
    r2 = ref["flops"][("deepseek-7b", 4, 2)]
    assert abs(r2 / (r1 / 2) - 1) < 0.01
    p1, p2 = _counted("deepseek-7b", 4, 1), _counted("deepseek-7b", 4, 2)
    assert p1 == p2 and 0.97 * r1 <= p1 <= r1


def test_cli_rows(tmp_path):
    """``main`` with the reference's flags (``--no-probes`` accepted): a
    counted row on sim1 with its roofline, a layout row on 16x16, a
    skipped row, and the JSON written."""
    out = tmp_path / "rows.json"
    rows = D.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                   "--mesh", "sim1", "--no-probes", "--out", str(out)])
    assert len(rows) == 1
    assert json.loads(out.read_text())[0]["status"] == "ok"
    row = rows[0]
    assert row["status"] == "ok" and row["info"]["cache_seq"] == 32_768
    rl = row["roofline"]
    assert rl["chips"] == 1 and rl["bottleneck"] == "memory"
    assert rl["t_memory"] == rl["bytes_hbm"] / 3.35e12
    assert rl["fits"] == (rl["hbm_per_device"] <= 80e9)
    layout = D.run_one("gemma3-1b", "train_4k", verbose=False)
    assert layout["status"].startswith("layout only")
    assert layout["info"]["exchange_plan"]["n"] == 16
    assert not get_config("deepseek-7b").runs_shape(SHAPES["long_500k"])
    skipped = D.run_one("deepseek-7b", "long_500k", verbose=False,
                        mesh="sim1")
    assert skipped["status"] == "skipped (full attention, see DESIGN.md §5)"


def test_sim4_row_prices_the_exchange():
    """On the (4,) data mesh one rank's train step holds its exchange: a
    reduce-scatter and an all-gather a bucket (the xla engine) and the
    metrics' all-reduce, priced by the link formulas."""
    cfg = get_config("gemma3-1b-reduced")
    totals, info = D.build_train_counted(
        cfg, ShapeConfig("t", 64, 8, "train"), D.make_mesh("sim4"))
    nb = info["exchange_plan"]["n_buckets"]
    assert info["n_rps"] == 4
    assert totals["collective_counts"] == {"reduce_scatter": nb,
                                           "all_gather": nb,
                                           "all_reduce": 1}
    assert totals["coll"] > 0 and totals["coll_by_op"]["total"] == \
        totals["coll"]
