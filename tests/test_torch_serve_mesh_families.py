"""Serving on a mesh for the ssm, hybrid, audio and vlm families
(``serve/mesh.py``) in a 4-rank gloo world on the CPU, against the
reference's own mesh serving steps: ``repro.launch.dryrun.
build_prefill_lowered`` / ``build_decode_lowered`` compiled and called on
real arrays on forced host devices (``grouped=False``, f32), as
``tests/test_torch_serve_mesh.py`` holds the dense family.

One small f32 config a family (the reference's initial weights), every
dim the rule shards divisible by 16:

- ssm (RWKV-6): 2 layers, d 64, 4 heads of 16, d_ff 128: each model rank
  runs the time-mix on its 2 heads (the RWKV-6 recurrence on them), the
  channel-mix on its d_ff columns; its cache the state of its heads
  beside whole token shifts;
- hybrid (RecurrentGemma): 3 layers (rec, rec, attn@8), d_state 64, 16
  query heads and 1 KV head of 8: the RG-LRU on the rank's 32 channels
  (its conv state and carry hold them), the local attention's query
  heads split, its one KV head whole on both ranks;
- audio (Whisper): 2 encoder and 2 decoder layers, 16 heads, 4 KV heads
  of 8, a frame every 6 tokens (so that the prompt's 24 tokens and the
  decode cache's 28 rows give the same 4 cross rows, as the compiled
  decode step's cache needs); the encoder, the self- and the
  cross-attention split by heads;
- vlm (LLaVA-NeXT): 2 layers, 16 heads, 4 KV heads, window 8, 4 patch
  rows before 20 tokens; decoding starts at 24 on every rank.

Cases on (2, 2) ("data", "model"): each family; the ssm, hybrid and audio
ones with ``shard_strategy="fsdp"`` too (each layer's FSDP shards
gathered over "data", the encoder's among them); on (2, 1, 2) ("pod",
"data", "model"): the hybrid and the vlm; B = 1 (whole on every data
rank, the reference's ``P()``): the audio model.

For each case, within 1e-5 of the reference: the prefill's last logits,
four decode steps' logits, and each rank's cache against the reference's
layer-stacked cache through the rank-layout map (its rows; rwkv: its
heads of the state, the whole token shifts; rec: its dr channels; a K/V
leaf: the KV heads its query heads read — the reference splits each
leaf's last dim that divides by "model" instead; ROADMAP C). In the same
world: the sharded steps against the unsharded ones on the same rows
(1e-6 of the logits' scale), and each rank's collectives of the prefill
and of a decode step equal to the dry-run's count of that rank's step
(``launch/dryrun.py::count_serve_step``). In this process: the serving
spec tree of the four full archs against the reference's.
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
BASE = dict(max_seq=4096, dtype="float32", vocab_size=256, d_model=64,
            d_ff=128)
SSM = dict(BASE, name="serve-ssm", family="ssm", n_layers=2, n_heads=4,
           n_kv_heads=4, head_dim=16)
HYBRID = dict(BASE, name="serve-hybrid", family="hybrid", n_layers=3,
              n_heads=16, n_kv_heads=1, head_dim=8, window=8,
              block_pattern=("rec", "rec", "attn"), d_state=64)
AUDIO = dict(BASE, name="serve-audio", family="audio", n_layers=2,
             enc_layers=2, n_heads=16, n_kv_heads=4, head_dim=8,
             enc_frames_ratio=6)
VLM = dict(BASE, name="serve-vlm", family="vlm", n_layers=2, n_heads=16,
           n_kv_heads=4, head_dim=8, window=8, n_patches=4)
FSDP = dict(shard_strategy="fsdp")
DM = ((2, 2), ("data", "model"))
PDM = ((2, 1, 2), ("pod", "data", "model"))
B, PROMPT, STEPS = 4, 24, 4
MAX_LEN = PROMPT + STEPS
CASES = {
    "ssm": (SSM, DM, B),
    "hybrid": (HYBRID, DM, B),
    "audio": (AUDIO, DM, B),
    "vlm": (VLM, DM, B),
    "ssm-fsdp": (dict(SSM, **FSDP), DM, B),
    "hybrid-fsdp": (dict(HYBRID, **FSDP), DM, B),
    "audio-fsdp": (dict(AUDIO, **FSDP), DM, B),
    "hybrid-pods": (HYBRID, PDM, B),
    "vlm-pods": (VLM, PDM, B),
    "audio-b1": (AUDIO, DM, 1),
}


def _inputs():
    specs = {}
    rng = np.random.default_rng(31)
    for name, (cfg, (shape, axes), b) in CASES.items():
        jcfg = JArchConfig(**cfg)
        p1 = jax.tree.map(np.asarray, jbuild_model(
            jcfg, grouped=False).init(jax.random.PRNGKey(0)))
        n_tok = PROMPT - jcfg.n_patches
        spec = dict(
            fn="_torch_dist.serve_mesh_case", cfg=cfg, p1=p1, mesh=shape,
            axes=axes, max_len=MAX_LEN,
            tokens=rng.integers(0, cfg["vocab_size"], (b, n_tok),
                                dtype=np.int32),
            steps=rng.integers(0, cfg["vocab_size"], (STEPS, b),
                               dtype=np.int32))
        if jcfg.family == "audio":
            spec["frames"] = rng.standard_normal(
                (b, PROMPT // jcfg.enc_frames_ratio, jcfg.d_model),
                dtype=np.float32)
        if jcfg.family == "vlm":
            spec["patches"] = rng.standard_normal(
                (b, jcfg.n_patches, jcfg.d_model), dtype=np.float32)
        specs[name] = spec
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
        b = c["tokens"].shape[0]
        p = c["tokens"].shape[1] + cfg.n_patches
        S = c["max_len"]
        prefill, _ = D.build_prefill_lowered(
            cfg, ShapeConfig("p", p, b, "prefill"), mesh, grouped=False)
        decode, _ = D.build_decode_lowered(
            cfg, ShapeConfig("d", S, b, "decode"), mesh, grouped=False)
        prefill, decode = prefill.compile(), decode.compile()
        inputs = {k: c[k] for k in ("tokens", "frames", "patches")
                  if k in c}
        logits, cache = prefill(c["p1"], inputs)
        got = [np.asarray(logits)]
        # the decode cache of S rows: a global layer's self K/V padded
        # (the port's prefill(max_len=S)); the recurrent states, a
        # ring buffer and the cross K/V as prefill leaves them
        cache = {kind: {k: np.pad(np.asarray(v), [(0, 0), (0, 0),
                                                  (0, S - v.shape[2]),
                                                  (0, 0), (0, 0)])
                        if k in ("k", "v") and "@" not in kind
                        else np.asarray(v)
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
    tmp = tmp_path_factory.mktemp("serve_mesh_families")
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
    """Four decode steps' logits of each rank's rows, from the prompt's
    rows on (the vlm's patch rows counted)."""
    _, port, ref = runs
    want = ref[name]["logits"][1:]
    assert len(want) == STEPS
    for r, got in enumerate(port[name]):
        lo, hi = got["rows"]
        for t in range(STEPS):
            np.testing.assert_allclose(got["logits"][1 + t], want[t][lo:hi],
                                       rtol=0, atol=TOL,
                                       err_msg=f"rank {r} step {t}")


def _kv_range(idx, size, n_kv, n_heads):
    """The KV heads rank ``idx`` of ``size`` reads (the port's
    ``parallel.kv_range``, reckoned here)."""
    g = n_heads // n_kv
    h_loc = n_heads // size
    first = idx * h_loc
    return first // g, (first + h_loc - 1) // g + 1


def _rank_part(cfg, got, leaf: str, want):
    """The part of the reference's leaf ``want`` (B, …) of one layer that
    the rank holds: its rows and, where its share of the layer is split,
    its heads or channels (the rank-layout map)."""
    lo, hi = got["rows"]
    idx, size = got["model"]
    want = want[lo:hi]
    sharded = set(got["sharded"])
    if leaf == "state" and "rwkv/wr" in sharded:
        h = cfg["n_heads"] // size
        return want[:, idx * h:(idx + 1) * h]
    if leaf in ("conv", "h") and "rec/wx" in sharded:
        dr = cfg["d_state"] // size
        return want[..., idx * dr:(idx + 1) * dr]
    split = {"k": "attn/wq", "v": "attn/wq", "xk": "xattn/wq",
             "xv": "xattn/wq"}.get(leaf)
    if split in sharded:
        k0, k1 = _kv_range(idx, size, cfg["n_kv_heads"], cfg["n_heads"])
        return want[:, :, k0:k1]
    return want


@pytest.mark.parametrize("name", list(CASES))
def test_cache_equals_reference(runs, name):
    """Each rank's cache after the decode steps, every leaf of every
    layer, against the reference's layer-stacked cache at the same
    positions through the rank-layout map (:func:`_rank_part`): each
    leaf's shape and values."""
    from repro_torch.models.registry import kind_sequence
    from repro_torch.models.stack import group_layout
    specs, port, ref = runs
    cfg = specs[name]["cfg"]
    kinds = kind_sequence(td._tp_config(cfg))
    where = {}
    for kind, idxs in group_layout(kinds).items():
        for j, i in enumerate(idxs):
            where[i] = (kind, j)
    for r, got in enumerate(port[name]):
        assert len(got["cache"]) == len(kinds)
        for i, layer in enumerate(got["cache"]):
            kind, j = where[i]
            leaves = ref[name]["cache"][kind]
            assert set(layer) == set(leaves), (r, i)
            for leaf, a in layer.items():
                want = _rank_part(cfg, got, leaf, leaves[leaf][j])
                assert a.shape == want.shape, (r, i, leaf)
                np.testing.assert_allclose(
                    a, want, rtol=0, atol=TOL,
                    err_msg=f"rank {r} layer {i} {leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_equal_unsharded(runs, name):
    """The sharded prefill and decode steps against the unsharded ones on
    the full weights and the same rows: within 1e-6 of the logits'
    scale; what the context shards (each family's split leaves, the
    vocabulary) and which FSDP runs."""
    specs, port, _ = runs
    cfg = specs[name]["cfg"]
    split = {"ssm": {"rwkv/wr", "rwkv/wo", "rwkv/ck", "rwkv/cv"},
             "hybrid": {"rec/wx", "rec/wa", "rec/wo", "rec/conv",
                        "attn/wq", "mlp/wi"},
             "audio": {"attn/wq", "xattn/wq", "mlp/wi"},
             "vlm": {"attn/wq", "mlp/wi"}}[cfg["family"]]
    for r, got in enumerate(port[name]):
        for a, b in zip(got["logits"], got["whole"]):
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a - b).max()) <= WHOLE_TOL * scale, (r,)
        assert got["fsdp"] == (cfg.get("shard_strategy") == "fsdp"
                               and specs[name]["mesh"] == DM[0])
        assert {"embed/tok", "embed/head"} | split <= set(got["sharded"])


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_dry_run(runs, name):
    """Each rank's collectives of the prefill and of the first decode
    step, record for record, equal the dry-run's count of that rank's
    step on meta tensors (``count_serve_step`` through ``Mesh.as_rank``):
    the model group's all-reduces and all-gathers, FSDP's all-gathers
    over the data ranks (the encoder's layers among them)."""
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
                n_layers = cfg.n_layers + (cfg.enc_layers
                                           if kind == "prefill" else 0)
                assert sum(op == "all_gather" for op, _, _ in rec) \
                    > n_layers


FAMILY_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-large-v3",
                "llava-next-mistral-7b")


def _spec_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serving_specs_equal_reference(arch):
    """The serving layout of a full config: every leaf's spec equals the
    reference's spec tree for its serving steps (no FSDP: each arch's
    bf16 replica fits a 16-way budget of 8 GB a device)."""
    from repro.configs import get_config as jget_config
    from repro.launch import sharding as jsharding
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.serve import mesh as serve_mesh
    cfg = get_config(arch)
    axis = serve_mesh.serve_fsdp(cfg)
    assert axis is None
    jcfg = jget_config(arch)
    shape = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = _spec_paths(jsharding.param_specs(shape, jcfg, worker_axes=(),
                                             fsdp_axis=axis))
    got = _spec_paths(serve_mesh.param_specs(
        build_model(cfg, device="meta").init_stacked(MetaGenerator()), cfg))
    assert got == want
    assert any("model" in spec for spec in got.values())
