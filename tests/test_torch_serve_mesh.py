"""Serving on a mesh (``serve/mesh.py``, the dense family with and without
experts) in a 4-rank gloo world on the CPU, against the reference's own
mesh serving steps: ``repro.launch.dryrun.build_prefill_lowered`` /
``build_decode_lowered`` compiled and called on real arrays on forced
host devices (``grouped=False``: grouped mode reorders the layers; f32).

Configs built here (2 layers, d 64, head_dim 8, vocab 256, f32, the
reference's initial weights), on a (2, 2) ("data", "model") mesh unless
named:

- 16 query and 4 KV heads (``wq`` split, ``wk`` / ``wv`` whole: each
  rank cuts the KV heads its query heads read);
- 16 and 16 (MHA: all split);
- 4 query heads and 1 KV head (the attention whole, the MLP and the
  vocab split: gemma3-1b's case at 16-way);
- a windowed layer (window 8, the ring buffer) next to a global one;
- experts on both of the rule's branches: E 16 (experts over "model")
  and E 8 (``wi`` / ``wg`` over d_ff, ``wo`` over d);
- ``shard_strategy="fsdp"`` on (2, 2) and, with 16 experts (kimi-k2's
  layout), on (2, 1, 2) ("pod", "data", "model");
- B = 1, whole on every data rank (the reference's ``P()``).

For each case, within 1e-5 of the reference: the prefill's last logits,
four decode steps' logits, and each rank's cache (its rows, its KV heads)
against the reference's at the same positions. In the same world: the
sharded steps against the unsharded ones (``tp=None``) on the same rows
(1e-6 of the output's scale), and each rank's collectives of the prefill
and of a decode step equal to the dry-run's count of that rank's step
(``launch/dryrun.py::count_serve_step``). In this process: the serving
spec tree of the six dense archs (``serve/mesh.py::param_specs``)
against the reference's ``param_specs(worker_axes=(), fsdp_axis=
_serve_fsdp(cfg))``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import build_model as jbuild_model

import _torch_dist as td

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
WHOLE_TOL = 1e-6
BASE = dict(name="serve-mesh", family="dense", n_layers=2, d_model=64,
            n_heads=16, n_kv_heads=4, head_dim=8, d_ff=128, vocab_size=256,
            max_seq=4096, dtype="float32")
MOE = dict(n_experts=16, top_k=2)
DM = ((2, 2), ("data", "model"))
PDM = ((2, 1, 2), ("pod", "data", "model"))
B, PROMPT, STEPS = 4, 24, 4
MAX_LEN = PROMPT + STEPS
CASES = {
    "gqa": (dict(BASE), DM, B),
    "mha": (dict(BASE, n_kv_heads=16), DM, B),
    "heads4": (dict(BASE, n_heads=4, n_kv_heads=1), DM, B),
    "window": (dict(BASE, window=8, global_every=2), DM, B),
    "moe-experts": (dict(BASE, **MOE), DM, B),
    "moe-width": (dict(BASE, n_experts=8, top_k=2), DM, B),
    "fsdp": (dict(BASE, shard_strategy="fsdp"), DM, B),
    "fsdp-pods-moe": (dict(BASE, shard_strategy="fsdp", **MOE), PDM, B),
    "b1": (dict(BASE), DM, 1),
}


def _inputs():
    specs = {}
    rng = np.random.default_rng(11)
    for name, (cfg, (shape, axes), b) in CASES.items():
        p1 = jax.tree.map(np.asarray, jbuild_model(
            JArchConfig(**cfg), grouped=False).init(jax.random.PRNGKey(0)))
        specs[name] = dict(
            fn="_torch_dist.serve_mesh_case", cfg=cfg, p1=p1, mesh=shape,
            axes=axes, max_len=MAX_LEN,
            tokens=rng.integers(0, cfg["vocab_size"], (b, PROMPT),
                                dtype=np.int32),
            steps=rng.integers(0, cfg["vocab_size"], (STEPS, b),
                               dtype=np.int32))
    return specs


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    jax.devices()          # before the import below forces 512 devices
    from repro.launch import dryrun as D
    from repro.configs.base import ArchConfig, ShapeConfig

    specs = pickle.load(open(sys.argv[1], "rb"))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    specs = {k: specs[k] for k in sorted(specs)[part::parts]}
    auto = jax.sharding.AxisType.Auto
    out = {}
    for name, c in specs.items():
        cfg = ArchConfig(**c["cfg"])
        mesh = jax.make_mesh(c["mesh"], c["axes"],
                             axis_types=(auto,) * len(c["axes"]))
        b, p = c["tokens"].shape
        S = c["max_len"]
        prefill, _ = D.build_prefill_lowered(
            cfg, ShapeConfig("p", p, b, "prefill"), mesh, grouped=False)
        decode, _ = D.build_decode_lowered(
            cfg, ShapeConfig("d", S, b, "decode"), mesh, grouped=False)
        prefill, decode = prefill.compile(), decode.compile()
        logits, cache = prefill(c["p1"], {"tokens": c["tokens"]})
        got = [np.asarray(logits)]
        # the decode cache of S rows: a global layer's padded (the
        # port's prefill(max_len=S))
        cache = {kind: {k: np.pad(np.asarray(v), [(0, 0), (0, 0),
                                                  (0, S - v.shape[2]),
                                                  (0, 0), (0, 0)])
                        if "@" not in kind else np.asarray(v)
                        for k, v in leaves.items()}
                 for kind, leaves in cache.items()}
        for t, tok in enumerate(c["steps"]):
            logits, cache = decode(c["p1"], cache,
                                   {"token": tok[:, None]},
                                   jnp.int32(p + t))
            got.append(np.asarray(logits))
        out[name] = {"logits": got,
                     "cache": jax.tree.map(np.asarray, cache)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % SRC
PARTS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
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
        port = td.run_cases(specs)
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    ref = {}
    for j in range(PARTS):
        with open(tmp / f"out{j}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return specs, port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_equal_reference(runs, name):
    """The prefill's last logits of each rank's rows (whole over the
    vocab: gathered over the model group) against the reference's."""
    _, port, ref = runs
    want = ref[name]["logits"][0]
    for r, got in enumerate(port[name]):
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["logits"][0], want[lo:hi], rtol=0,
                                   atol=TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_logits_equal_reference(runs, name):
    """Four decode steps' logits of each rank's rows."""
    _, port, ref = runs
    want = ref[name]["logits"][1:]
    assert len(want) == STEPS
    for r, got in enumerate(port[name]):
        lo, hi = got["rows"]
        for t in range(STEPS):
            np.testing.assert_allclose(got["logits"][1 + t], want[t][lo:hi],
                                       rtol=0, atol=TOL,
                                       err_msg=f"rank {r} step {t}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_equals_reference(runs, name):
    """Each rank's cache after the decode steps, a layer's K and V: its
    rows and the KV heads its query heads read, against the reference's
    layer-stacked cache at the same positions (the ring's slots and a
    global layer's rows)."""
    from repro_torch.models.registry import kind_sequence
    from repro_torch.models.stack import group_layout
    specs, port, ref = runs
    cfg = td._tp_config(specs[name]["cfg"])
    kinds = kind_sequence(cfg)
    where = {}
    for kind, idxs in group_layout(kinds).items():
        for j, i in enumerate(idxs):
            where[i] = (kind, j)
    for r, got in enumerate(port[name]):
        lo, hi = got["rows"]
        k0, k1 = got["kv"]
        assert len(got["cache"]) == len(kinds)
        for i, layer in enumerate(got["cache"]):
            kind, j = where[i]
            for leaf in ("k", "v"):
                want = ref[name]["cache"][kind][leaf][j, lo:hi, :, k0:k1]
                assert layer[leaf].shape == want.shape, (r, i, leaf)
                np.testing.assert_allclose(layer[leaf], want, rtol=0,
                                           atol=TOL,
                                           err_msg=f"rank {r} layer {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_equal_unsharded(runs, name):
    """The sharded prefill and decode steps against the unsharded ones on
    the full weights and the same rows (the MoE's statistics over the
    same row group): within 1e-6 of the logits' scale; what the context
    shards and which FSDP runs."""
    specs, port, _ = runs
    cfg = specs[name]["cfg"]
    for r, got in enumerate(port[name]):
        for a, b in zip(got["logits"], got["whole"]):
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a - b).max()) <= WHOLE_TOL * scale, (r,)
        assert got["fsdp"] == (cfg.get("shard_strategy") == "fsdp"
                               and specs[name]["mesh"][0] == 2
                               and len(specs[name]["mesh"]) == 2)
        assert {"embed/tok", "embed/head"} <= set(got["sharded"])
        assert ("attn/wq" in got["sharded"]) == (cfg["n_heads"] == 16)


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_dry_run(runs, name):
    """Each rank's collectives of the prefill and of the first decode
    step, record for record, equal the dry-run's count of that rank's
    step on meta tensors (``count_serve_step`` through ``Mesh.as_rank``):
    the model group's all-reduces and the logits' all-gather among
    them, FSDP's all-gathers over the data ranks."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh
    specs, port, _ = runs
    spec = specs[name]
    cfg = td._tp_config(spec["cfg"])
    mesh = Mesh(spec["mesh"], spec["axes"])
    b = spec["tokens"].shape[0]
    for r, got in enumerate(port[name]):
        for rec, (kind, S) in zip(got["records"], (("prefill", PROMPT),
                                                   ("decode", MAX_LEN))):
            want = D.count_serve_step(cfg, kind, b, S, mesh, rank=r)
            assert [tuple(x) for x in want["records"]] == \
                [tuple(x) for x in rec], (r, kind)
            ops = {(op, n) for op, _, n in rec}
            assert ("all_reduce", 2) in ops and ("all_gather", 2) in ops
            if got["fsdp"]:
                assert sum(op == "all_gather" for op, _, _ in rec) > 2


DENSE_ARCHS = ("gemma3-1b", "deepseek-7b", "starcoder2-15b", "llama3-405b",
               "mixtral-8x22b", "kimi-k2-1t-a32b")


def _spec_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_serving_specs_equal_reference(arch):
    """The serving layout of a full config: every leaf's spec (its model
    dim over "model", its FSDP dim over "data" where ``serve_fsdp`` gives
    FSDP: llama3-405b, mixtral-8x22b, kimi-k2) equals the reference's
    spec tree for its serving steps."""
    from repro.configs import get_config as jget_config
    from repro.launch import sharding as jsharding
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.serve import mesh as serve_mesh
    cfg = get_config(arch)
    axis = serve_mesh.serve_fsdp(cfg)
    jcfg = jget_config(arch)
    shape = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = _spec_paths(jsharding.param_specs(shape, jcfg, worker_axes=(),
                                             fsdp_axis=axis))
    got = _spec_paths(serve_mesh.param_specs(
        build_model(cfg, device="meta").init_stacked(MetaGenerator()), cfg))
    assert got == want
    assert (axis == "data") == (arch in ("llama3-405b", "mixtral-8x22b",
                                         "kimi-k2-1t-a32b"))
    assert any("data" in spec for spec in got.values()) == (axis == "data")
