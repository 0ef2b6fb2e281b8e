"""The dry-run's MoE train rows (``launch/dryrun.py``): mixtral-8x22b's and
kimi-k2's ``train_4k`` steps on the production meshes, counted, against
the JAX package's static layout of the same steps.

Each row is one rank's step on meta tensors with its "model" axis of 16
tensor parallelism inside a replica (``models/layers.py::moe``,
``tp=``), every layer counted (a train step's peak does not extend from
two and three layers: ``tests/test_torch_dryrun.py``):

- mixtral-8x22b (E 8, the rule's width branch: ``wi`` / ``wg`` split
  d_ff, ``wo`` splits d), ``rps_model`` over the data ranks;
- kimi-k2 (E 384, the expert branch: 24 experts a rank) with FSDP over
  the 16 data ranks, ``rps_grad`` over the pods (kimi-k2's own layout,
  TP 16 x FSDP 16).

Each row counts in a process of its own (15-30 s on this CPU), beside
the reference's layout of the same rows (``tests/test_torch_dryrun.py``'s
reference setup, without the lowering), so that this file runs on
another worker than ``tests/test_torch_dryrun.py``.
"""
import os
import pickle
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.launch.mesh import rps_axes_for

import test_torch_dryrun as TD

_REF = TD._REF_HEAD + r'''
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    name = "2x16x16" if multi else "16x16"
    for arch in sys.argv[3].split(","):
        out[(arch, name)] = info_of(get_config(arch), SHAPES["train_4k"],
                                    mesh)
pickle.dump(out, open(sys.argv[1], "wb"))
'''

_PORT_ROW = r'''
import dataclasses, pickle, sys, time
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
t0 = time.perf_counter()
arch, name = sys.argv[3], sys.argv[4]
cfg, mesh = get_config(arch), D.make_mesh(name)
totals, info = D.build_train_counted(cfg, SHAPES["train_4k"], mesh)
report = D.analyze(arch, "train_4k", name, mesh.size, totals,
                   D.model_flops_global(cfg, SHAPES["train_4k"]))
pickle.dump((totals, info, dataclasses.asdict(report),
             time.perf_counter() - t0), open(sys.argv[1], "wb"))
'''

ROWS = TD.MOE_ROWS
# the leaves FSDP lays over "data" a layer: wq wk wv wo, and the
# experts' wi wg wo
FSDP_LEAVES = 7


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{(arch, mesh): (totals, info, roofline, seconds)} of the port, and
    the reference's layout of each row."""
    tmp = tmp_path_factory.mktemp("dryrun_moe")
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "XLA_FLAGS": TD.XLA_QUICK,
                "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    archs = sorted({a for a, _ in ROWS})
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "ref.pkl"), TD.SRC,
         ",".join(archs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    for arch, name in ROWS:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PORT_ROW, str(tmp / f"{arch}-{name}.pkl"),
             TD.SRC, arch, name], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    port = {}
    for arch, name in ROWS:
        with open(tmp / f"{arch}-{name}.pkl", "rb") as f:
            port[(arch, name)] = pickle.load(f)
    with open(tmp / "ref.pkl", "rb") as f:
        return port, pickle.load(f)


@pytest.mark.parametrize("arch,mesh", ROWS)
def test_moe_train_row_layout_equals_reference(rows, arch, mesh):
    """n_rps, microbatch, aggregator, state pack, state bytes and the
    exchange plan's describe() equal the reference's; the row is counted
    (no "layout only")."""
    port, ref = rows
    totals, info, _, _ = port[(arch, mesh)]
    want = ref[(arch, mesh)]
    assert "not_run" not in info and totals["flops"] > 0
    for key in ("n_rps", "microbatch", "aggregator", "state_pack",
                "state_bytes", "exchange_plan"):
        assert info[key] == want[key], key
    from repro_torch.launch import dryrun as D
    assert rps_axes_for(get_config(arch).rps_mode,
                        D.make_mesh(mesh)) == want["rps_axes"]


@pytest.mark.parametrize("arch,mesh", ROWS)
def test_moe_train_row_counts_the_moe_collectives(rows, arch, mesh):
    """The MoE's collectives over the 16 model ranks, a layer and a
    microbatch: mixtral-8x22b's width branch all-gathers the hidden
    activation over d_ff and the output over d and reduce-scatters the
    hidden's gradient (beside the exchange's reduce-scatter and
    all-gather a bucket on 16x16, where its 16 data ranks are the
    replicas); kimi-k2's FSDP gathers each of its 7 FSDP leaves twice
    and reduce-scatters it once over the 16 data ranks, and its routing
    all-gathers the expert counts over them once in the forward and once
    in the checkpointed layer's backward, and its expert branch
    all-reduces over the model ranks. Each row reports its HBM a device
    and ``fits`` (one H100's 80 GB), whatever they read."""
    port, _ = rows
    totals, info, roofline, _ = port[(arch, mesh)]
    cfg = get_config(arch)
    per = cfg.n_layers * info["microbatch"]
    ops = {}
    for op, _, n in totals["records"]:
        ops[(op, n)] = ops.get((op, n), 0) + 1
    nb = (info["exchange_plan"] or {}).get("n_buckets", 0)
    if cfg.shard_strategy == "fsdp":
        assert ops[("all_gather", 16)] == (2 * FSDP_LEAVES + 2) * per
        assert ops[("reduce_scatter", 16)] == FSDP_LEAVES * per
        if info["n_rps"] == 2:
            assert ops[("reduce_scatter", 2)] == ops[("all_gather", 2)] \
                == nb
    else:
        ex = nb if info["n_rps"] == 16 else 0
        assert ops[("all_gather", 16)] == 2 * per + ex
        assert ops[("reduce_scatter", 16)] == per + ex
    assert ops[("all_reduce", 16)] > 0
    assert roofline["hbm_per_device"] == totals["hbm"] > totals["resident"]
    assert roofline["fits"] == (totals["hbm"] <= 80e9)
