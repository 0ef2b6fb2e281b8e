"""The dry-run's serving rows on the production meshes
(``launch/dryrun.py``): one rank's prefill or decode step on its shards
(``serve/mesh.py``), counted on meta tensors, for the dense family with
and without experts.

Each row counts in a process of its own (a few seconds each), as
``tests/test_torch_dryrun_moe.py`` runs its rows:

- gemma3-1b ``decode_32k`` on 16x16 (its 4 heads whole on every model
  rank, its MLP and vocab split);
- llama3-405b ``decode_32k`` on 16x16 (FSDP over the 16 data ranks);
- kimi-k2 ``prefill_32k`` on 2x16x16 (the expert branch, FSDP);
- starcoder2-15b ``long_500k`` on 16x16 (B = 1, whole on every rank;
  every layer windowed).

Each reads ``ok`` with its collectives priced and an HBM figure a
device. In this process: ``by_periods`` against a count of every layer
with FSDP on, and an ssm serving row still "layout only".
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROWS = [("gemma3-1b", "decode_32k", "16x16"),
        ("llama3-405b", "decode_32k", "16x16"),
        ("kimi-k2-1t-a32b", "prefill_32k", "2x16x16"),
        ("starcoder2-15b", "long_500k", "16x16")]

_PORT_ROW = r'''
import pickle, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.launch import dryrun as D
row = D.run_one(sys.argv[3], sys.argv[4], mesh=sys.argv[5], verbose=False)
pickle.dump(row, open(sys.argv[1], "wb"))
'''


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_serve")
    env = dict(os.environ)
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT_ROW, str(tmp / f"{i}.pkl"), SRC,
         arch, shape, mesh], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, (arch, shape, mesh) in enumerate(ROWS)]
    logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    out = {}
    for i, row in enumerate(ROWS):
        with open(tmp / f"{i}.pkl", "rb") as f:
            out[row] = pickle.load(f)
    return out


@pytest.mark.parametrize("row", ROWS, ids=["-".join(r) for r in ROWS])
def test_serving_row_is_counted(rows, row):
    """The row reads ``ok`` (no "layout only"): one rank's step counted
    with its collectives priced (``t_collective`` > 0), its HBM a device
    (the rank's shards, cache and inputs plus its peak of live bytes) and
    ``fits`` against one H100's 80 GB, whatever they read; a decode
    row's per-rank cache beside the reference's layout."""
    arch, shape, mesh = row
    got = rows[row]
    assert got["status"] == "ok" and "not_run" not in got["info"]
    rl = got["roofline"]
    assert rl["chips"] == (512 if mesh == "2x16x16" else 256)
    assert rl["t_collective"] > 0 and rl["hbm_per_device"] > 0
    assert rl["fits"] == (rl["hbm_per_device"] <= 80e9)
    if SHAPES[shape].kind == "decode":
        info = got["info"]
        cfg = get_config(arch)
        assert len(info["rank_cache"]) == cfg.n_layers
        B = SHAPES[shape].global_batch
        b = B // 16 if B > 1 else 1
        k = info["rank_cache"][0]["k"]
        assert k[0] == b and k[2] <= cfg.n_kv_heads and k[3] == cfg.hd


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3-405b", "kimi-k2-1t-a32b"])
def test_by_periods_equals_every_layer_with_fsdp(arch, kind, mesh_shape,
                                                 axes):
    """A serving step with FSDP on (the reduced config at 6 layers: its
    leaves over "data", the MLP's or the experts' over "model"):
    ``by_periods``' extension from two and three layers equals the count
    of every layer in every total, the peak of live bytes included (each
    layer's gathered weights are dropped after it; the pass has no
    gradient)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=6)
    mesh = Mesh(mesh_shape, axes)
    whole = D.count_serve_step(cfg, kind, 8, 64, mesh)
    records = whole.pop("records")
    got = D.by_periods(
        cfg, lambda c: D.count_serve_step(c, kind, 8, 64, mesh))
    assert "records" not in got          # extended, not counted
    assert got == whole
    # FSDP gathers every layer's leaves over the data ranks
    assert sum(op == "all_gather" and n == 2 for op, _, n in records) > 6


def test_ssm_serving_row_stays_layout_only():
    """rwkv6-1.6b's decode row on 16x16: the ssm family's serving on a
    mesh is the next slice."""
    row = D.run_one("rwkv6-1.6b", "decode_32k", verbose=False)
    assert row["status"] == ("layout only: the counted terms are not run "
                             "(ROADMAP A: serving on a mesh for the ssm "
                             "family)")
    assert "rank_cache" not in row["info"]
