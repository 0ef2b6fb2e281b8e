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
from contextlib import nullcontext
from unittest import mock

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
# the counted FSDP train rows (llama3-405b's 126 layers, ~36 s each): each
# in a process of its own, beside the reference's
FSDP_ROWS = [(a, m) for a in ARCH_IDS for m in MESHES
             if get_config(a).shard_strategy == "fsdp"
             and not get_config(a).is_moe]
# the MoE train rows, counted by tests/test_torch_dryrun_moe.py: here
# their layout alone (the count replaced by None)
MOE_ROWS = [(a, m) for a in ARCH_IDS for m in MESHES
            if get_config(a).is_moe]
# the ssm, hybrid, audio and vlm train rows, counted on 16x16 by
# tests/test_torch_dryrun_families.py: here their layout alone
FAMILY_ROWS = [(a, m) for a in ARCH_IDS for m in MESHES
               if get_config(a).family != "dense"]


def _spec_items(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_items(v, path + (k,)))
        return out
    return {path: tree}


def _cache_rows(arch, shape, mesh):
    """The port's decode row, its count left out (the dense family's
    serving rows are counted by tests/test_torch_dryrun_serve.py): its
    totals (None), its info and the layer-stacked cache's {path: (shape,
    spec)}."""
    from repro_torch.models.stack import stack_layers
    cfg = get_config(arch)
    with mock.patch.object(D, "count_serve", return_value=None):
        totals, info = D.build_decode_counted(cfg, SHAPES[shape],
                                              D.make_mesh(mesh))
    model = D._meta_model(cfg)
    cache = stack_layers(model.init_cache(SHAPES[shape].global_batch,
                                          SHAPES[shape].seq_len),
                         model.kinds)
    shapes = {p: tuple(t.shape) for p, t in _spec_items(cache).items()}
    specs = _spec_items(info["cache_specs"])
    return totals, info, {p: (shapes[p], specs[p]) for p in shapes}


# the reference's setup of a train_4k step without the lowering, and its
# decode caches' specs (tests/test_torch_dryrun_moe.py runs it too)
_REF_HEAD = r'''
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

'''

_REF = _REF_HEAD + r'''

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


_PORT_ROW = r'''
import pickle, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
row = D.build_train_counted(get_config(sys.argv[3]), SHAPES["train_4k"],
                            D.make_mesh(sys.argv[4]))
pickle.dump(row, open(sys.argv[1], "wb"))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's FSDP train rows' (one
    each), and meanwhile the port's other train_4k rows on both
    production meshes."""
    tmp = tmp_path_factory.mktemp("dryrun")
    path = tmp / "ref.pkl"
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "XLA_FLAGS": XLA_QUICK,
                "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    procs = [subprocess.Popen([sys.executable, "-c", _REF, str(path), SRC,
                               ",".join(FLOP_ARCHS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    rows = {}
    for arch, name in FSDP_ROWS:
        rows[(arch, name)] = tmp / f"{arch}-{name}.pkl"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PORT_ROW, str(rows[(arch, name)]), SRC,
             arch, name], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        layouts, caches = {}, {}
        for name in MESHES:
            mesh = D.make_mesh(name)
            for arch in ARCH_IDS:
                if (arch, name) in rows:
                    continue
                with mock.patch.object(D, "count_train_step",
                                       return_value=None) \
                        if (arch, name) in MOE_ROWS + FAMILY_ROWS \
                        else nullcontext():
                    layouts[(arch, name)] = D.build_train_counted(
                        get_config(arch), SHAPES["train_4k"], mesh)
        for arch, shape, name in CACHE_CASES:
            caches[(arch, shape, name)] = _cache_rows(arch, shape, name)
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    for key, row in rows.items():
        with open(row, "rb") as f:
            layouts[key] = pickle.load(f)
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
    exchange plan's describe(); every row's counted terms run, none
    "layout only" (one rank's step with TP inside a replica on a "model"
    axis of 16, llama3-405b's and kimi-k2's with FSDP over the 16 data
    ranks too): the dense architectures' counted here, the MoE rows'
    (mixtral-8x22b's and kimi-k2's) by tests/test_torch_dryrun_moe.py
    and the other families' by tests/test_torch_dryrun_families.py."""
    totals, info = layouts[(arch, mesh)]
    want = ref["layout"][(arch, mesh)]
    assert "not_run" not in info
    if (arch, mesh) in MOE_ROWS + FAMILY_ROWS:
        assert totals is None
    else:
        assert totals["flops"] > 0 and any(
            op == "all_reduce" and n == 16
            for op, _, n in totals["records"])
    for key in ("n_rps", "microbatch", "aggregator", "state_pack",
                "state_bytes", "exchange_plan"):
        assert info[key] == want[key], key
    from repro_torch.launch.mesh import rps_axes_for
    assert rps_axes_for(get_config(arch).rps_mode,
                        D.make_mesh(mesh)) == want["rps_axes"]


@pytest.mark.parametrize("arch,shape,mesh", CACHE_CASES)
def test_cache_spec_trees_equal_reference(ref, caches, arch, shape, mesh):
    """The layer-stacked decode cache's shapes and spec tree; the counted
    terms run for every family (serving on a mesh; counted by
    tests/test_torch_dryrun_serve.py, left out here): no "layout only",
    one rank's cache a layer beside the reference's layout."""
    totals, info, got = caches[(arch, shape, mesh)]
    assert got == ref["cache"][(arch, shape, mesh)]
    assert totals is None
    assert "not_run" not in info
    assert len(info["rank_cache"]) == get_config(arch).n_layers


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
    counted row on sim1 with its roofline, a counted ssm serving row on
    16x16 (one rank's decode step on a mesh), a skipped row, and the JSON
    written."""
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
    ssm = D.run_one("rwkv6-1.6b", "decode_32k", verbose=False)
    assert ssm["status"] == "ok" and "not_run" not in ssm["info"]
    assert len(ssm["info"]["rank_cache"]) == 24
    assert ssm["info"]["cache_seq"] == 32_768
    assert not get_config("deepseek-7b").runs_shape(SHAPES["long_500k"])
    skipped = D.run_one("deepseek-7b", "long_500k", verbose=False,
                        mesh="sim1")
    assert skipped["status"] == "skipped (full attention, see DESIGN.md §5)"


def test_gemma3_train_row_on_16x16_is_counted():
    """gemma3-1b's train_4k row on the production 16x16 mesh: counted (not
    "layout only") as one rank's step with TP inside a replica: its d_ff
    and vocab over the 16 model ranks, its 4 heads whole; the model
    group's all-reduces and the data ranks' exchange priced."""
    row = D.run_one("gemma3-1b", "train_4k", verbose=False)
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    rl = row["roofline"]
    assert rl["chips"] == 256 and rl["t_collective"] > 0
    assert row["info"]["exchange_plan"]["n"] == 16


@pytest.mark.parametrize("mesh", MESHES)
def test_llama3_405b_train_row_counts_fsdp(layouts, mesh):
    """llama3-405b's train_4k rows: one rank's step with TP 16 × FSDP 16
    (and on 2x16x16 the pods' gradient exchange), counted: every FSDP
    leaf all-gathered twice (the forward and the checkpointed layer's
    backward) and reduce-scattered once over the 16 data ranks, a layer
    and a microbatch; the model group's all-reduces over 16; the device's
    peak (the resident shards and state plus the peak of live bytes)
    within one H100's 80 GB."""
    totals, info = layouts[("llama3-405b", mesh)]
    cfg = get_config("llama3-405b")
    per = 7 * cfg.n_layers * info["microbatch"]   # wq wk wv wo wi wg wo
    ops = {}
    for op, _, n in totals["records"]:
        ops[(op, n)] = ops.get((op, n), 0) + 1
    assert ops[("all_gather", 16)] == 2 * per
    assert ops[("reduce_scatter", 16)] == per
    assert ops[("all_reduce", 16)] > 0
    assert info["n_rps"] == (2 if mesh == "2x16x16" else 1)
    if mesh == "2x16x16":
        nb = info["exchange_plan"]["n_buckets"]
        assert ops[("reduce_scatter", 2)] == ops[("all_gather", 2)] == nb
    assert 0 < totals["hbm"] <= 80e9


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


def test_train_peak_does_not_extend_from_two_layers():
    """Why a train row counts every layer where ``by_periods`` extends a
    prefill or a decode step: llama3-405b reduced, with FSDP and TP on a
    (2, 4, 2) ("pod", "data", "model") mesh, counted at 2, 3, 4 and 6
    layers. Its FLOPs, bytes, collectives and resident bytes grow by the
    same amount with each layer; its peak of live bytes does not: another
    moment of the step overtakes the peak between 4 and 6 layers
    (1,382,400 bytes a layer, then 1,763,294 on torch 2.13), so two and
    three layers do not give the whole."""
    import dataclasses
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.inputs import train_specs
    base = get_config("llama3-405b").reduced()
    mesh = Mesh((2, 4, 2), ("pod", "data", "model"))
    got = {}
    for n in (2, 3, 4, 6):
        cfg = dataclasses.replace(base, n_layers=n)
        batch = sharding.local_batch(
            D._stack_specs(train_specs(cfg, 16, 64), 2), mesh.as_rank(0),
            ("pod",), ("data",))
        tot = D.count_train_step(cfg, D.train_config(cfg, "rps_grad", 2),
                                 mesh, batch, rps_axes=("pod",),
                                 fsdp_axis="data")
        got[n] = (tot["flops"], tot["bytes"], len(tot["records"]),
                  tot["coll"], tot["resident"], tot["peak_live"])
    for k in range(5):
        step = got[3][k] - got[2][k]
        assert got[4][k] - got[3][k] == step
        assert got[6][k] - got[4][k] == 2 * step, k
    peak = [got[n][5] for n in (2, 3, 4, 6)]
    assert peak[2] - peak[1] == peak[1] - peak[0]
    assert peak[3] - peak[2] > 2 * (peak[1] - peak[0])
