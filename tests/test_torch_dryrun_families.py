"""The dry-run's train rows of the ssm, hybrid, audio and vlm families
(``launch/dryrun.py``): rwkv6-1.6b's, recurrentgemma-9b's,
whisper-large-v3's and llava-next-mistral-7b's ``train_4k`` steps on the
single-pod production mesh (16x16), counted, against the JAX package's
static layout of the same steps.

Each row is one rank's step on meta tensors with its "model" axis of 16
tensor parallelism inside a replica (``train(tp=)`` of
``models/rwkv6.py``, ``hybrid.py``, ``whisper.py``), ``rps_model`` over
the 16 data ranks, every layer counted. The rule splits RWKV-6's
projections and RG-LRU's recurrent width over "model": their
split-output products join their input over the model group (an
all-gather forward, a reduce-scatter backward) and their outputs leave
through an all-gather. Whisper-large-v3's 20 heads and llava-next's 8
KV heads do not divide by 16, so those leaves stay whole and only the
MLPs, the vocabulary and llava-next's query heads split: their model
group's collectives are all-reduces.

Each row counts in a process of its own (10-50 s on this CPU), beside
the reference's layout of the same rows (``tests/test_torch_dryrun.py``'s
reference setup, without the lowering). The two-pod rows (2x16x16)
differ only in the exchange; ``python -m repro_torch.launch.dryrun
--arch A --shape train_4k --mesh multi`` counts them.
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
mesh = make_production_mesh(multi_pod=False)
out = {arch: info_of(get_config(arch), SHAPES["train_4k"], mesh)
       for arch in sys.argv[3].split(",")}
pickle.dump(out, open(sys.argv[1], "wb"))
'''

_PORT_ROW = r'''
import dataclasses, pickle, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
arch = sys.argv[3]
cfg, mesh = get_config(arch), D.make_mesh("16x16")
totals, info = D.build_train_counted(cfg, SHAPES["train_4k"], mesh)
report = D.analyze(arch, "train_4k", "16x16", mesh.size, totals,
                   D.model_flops_global(cfg, SHAPES["train_4k"]))
pickle.dump((totals, info, dataclasses.asdict(report)),
            open(sys.argv[1], "wb"))
'''

ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-large-v3",
         "llava-next-mistral-7b")


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{arch: (totals, info, roofline)} of the port's 16x16 rows, and the
    reference's layout of each."""
    tmp = tmp_path_factory.mktemp("dryrun_families")
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "XLA_FLAGS": TD.XLA_QUICK,
                "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "ref.pkl"), TD.SRC,
         ",".join(ARCHS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    for arch in ARCHS:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PORT_ROW, str(tmp / f"{arch}.pkl"),
             TD.SRC, arch], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    port = {}
    for arch in ARCHS:
        with open(tmp / f"{arch}.pkl", "rb") as f:
            port[arch] = pickle.load(f)
    with open(tmp / "ref.pkl", "rb") as f:
        return port, pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_row_layout_equals_reference(rows, arch):
    """n_rps, microbatch, aggregator, state pack, state bytes and the
    exchange plan's describe() equal the reference's; the row is counted
    (no "layout only")."""
    port, ref = rows
    totals, info, _ = port[arch]
    want = ref[arch]
    assert "not_run" not in info and totals["flops"] > 0
    for key in ("n_rps", "microbatch", "aggregator", "state_pack",
                "state_bytes", "exchange_plan"):
        assert info[key] == want[key], key
    from repro_torch.launch import dryrun as D
    assert rps_axes_for(get_config(arch).rps_mode,
                        D.make_mesh("16x16")) == want["rps_axes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_row_counts_the_tp_collectives(rows, arch):
    """The model group's collectives over the 16 model ranks, a layer and
    a microbatch, beside the exchange's reduce-scatter and all-gather a
    bucket over the 16 data ranks (the replicas): rwkv6's time-mix joins
    o ⊙ g before ``wo`` and its channel-mix the key before ``cv``
    (2 all-gathers, 2 reduce-scatters), and both outputs leave through
    an all-gather; recurrentgemma's rec layers join the conv's output
    before ``wa`` / ``wi`` and h ⊙ y before ``wo`` and gather the output
    (3 all-gathers, 2 reduce-scatters), its attention layers none;
    whisper-large-v3's and llava-next's split leaves reduce with
    all-reduces only. Each row reports its HBM a device and ``fits``
    (one H100's 80 GB), whatever they read."""
    port, _ = rows
    totals, info, roofline = port[arch]
    cfg = get_config(arch)
    from repro_torch.models.registry import kind_sequence
    joined = {"ssm": (4, 2), "hybrid": (3, 2)}.get(cfg.family, (0, 0))
    layers = sum(k in ("rwkv", "rec") for k in kind_sequence(cfg))
    per = layers * info["microbatch"]
    ops = {}
    for op, _, n in totals["records"]:
        ops[(op, n)] = ops.get((op, n), 0) + 1
    nb = info["exchange_plan"]["n_buckets"]
    assert info["n_rps"] == 16
    assert ops[("all_gather", 16)] == joined[0] * per + nb
    assert ops[("reduce_scatter", 16)] == joined[1] * per + nb
    assert ops[("all_reduce", 16)] > 0
    assert roofline["hbm_per_device"] == totals["hbm"] > totals["resident"]
    assert roofline["fits"] == (totals["hbm"] <= 80e9)
