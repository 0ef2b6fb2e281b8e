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
with FSDP on, an ssm serving row counted, and a 16x16 decode row of each
of the ssm, hybrid, audio and vlm archs against a hand reckoning of its
shards, cache and collectives.
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


def test_ssm_serving_row_is_counted():
    """rwkv6-1.6b's decode row on 16x16: counted (no "layout only"), one
    rank's decode step on its shards with its collectives priced and
    its cache of the rank's heads beside the reference's layout."""
    row = D.run_one("rwkv6-1.6b", "decode_32k", verbose=False)
    assert row["status"] == "ok" and "not_run" not in row["info"]
    assert row["roofline"]["t_collective"] > 0
    cache = row["info"]["rank_cache"]
    assert len(cache) == 24
    assert cache[0] == {"state": (8, 2, 64, 64), "shift_t": (8, 2048),
                        "shift_c": (8, 2048)}


# ---- a counted 16x16 decode row a family, against a hand reckoning ----------
#
# decode_32k: B = 128 over the 16 data ranks (b = 8 rows a rank), a cache
# of S = 32,768 rows, bf16 weights and caches, one int32 token a row. On
# the "model" axis of m = 16 the rule splits a dim that divides by 16:
# the vocabulary (the embedding's lookup all-reduced over the group, the
# head's logits all-gathered), and per family what the comments say.

M, DEC_B, DEC_S = 16, 8, 32_768


def _embed_bytes(cfg) -> int:
    """tok (V, d) and head (d, V) split over the vocabulary, final_norm
    whole."""
    return 2 * (2 * cfg.padded_vocab * cfg.d_model // M + cfg.d_model)


def _mlp_bytes(cfg) -> int:
    return 2 * 3 * cfg.d_model * cfg.d_ff // M        # wi, wg, wo split


def _attn_bytes(cfg, split: bool) -> int:
    """wq / wo split by heads (or whole), wk / wv whole where the KV heads
    do not divide by 16."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if not split:
        return 2 * d * hd * (2 * h + 2 * kv)
    kv_split = kv % M == 0
    return 2 * d * hd * (2 * h // M + 2 * (kv // M if kv_split else kv))


def _rwkv6_row(cfg):
    """32 heads of 64: 2 a rank. Every projection's last dim split (wr,
    wk, wv, wg, wo, cr over d; ck over d_ff; cv over d); the norms, the
    lerps, the decay LoRA, w0 whole, u f32 whole. A layer's decode
    gathers the time-mix's output (joined for wo, then wo's columns),
    the channel-mix's key (joined over d_ff for cv) and its output."""
    d, ff, h = cfg.d_model, cfg.d_ff, cfg.n_heads
    layer = (2 * (2 * d + 5 * d + 2 * 64 * d + d + 2 * d
                  + 6 * d * d // M + 2 * d * ff // M) + 4 * d)
    cache = DEC_B * (h // M) * 64 * 64 * 4 + 2 * 2 * DEC_B * d
    row = 2 * DEC_B * d                           # a (b, 1, d) bf16 row
    gathers = [row, row, 2 * DEC_B * ff, row] * cfg.n_layers
    return layer * cfg.n_layers, cache * cfg.n_layers, [row], gathers


def _recurrentgemma_row(cfg):
    """26 rec layers and 12 local-attention ones (rec, rec, attn). rec:
    wy, wx, conv, wa, wi over dr (256 channels a rank), wo over d, lam
    f32 whole; its decode joins the conv's output for wa / wi and h ⊙ y
    for wo, gathers wo's columns, and all-reduces its MLP. attn: 16 query
    heads (1 a rank), its 1 KV head whole; the attention and the MLP
    each all-reduced. The ring buffers keep the window's 2,048 rows."""
    d, dr, ff, w, hd = (cfg.d_model, cfg.d_state, cfg.d_ff, cfg.window,
                        cfg.hd)
    n_attn = cfg.n_layers // 3
    n_rec = cfg.n_layers - n_attn
    rec = (2 * (2 * d + 2 * d * dr // M + 4 * dr // M + 2 * dr * dr // M
                + dr * d // M) + _mlp_bytes(cfg) + 4 * dr)
    attn = 2 * 2 * d + _attn_bytes(cfg, True) + _mlp_bytes(cfg)
    cache = (n_rec * DEC_B * (dr // M) * (3 * 2 + 4)
             + n_attn * 2 * DEC_B * w * cfg.n_kv_heads * hd * 2)
    row = 2 * DEC_B * d
    reduces = [row] + [row] * n_rec + [row, row] * n_attn
    return (n_rec * rec + n_attn * attn, cache, reduces,
            [row, row, row] * n_rec)


def _whisper_row(cfg):
    """20 heads do not divide by 16: the self- and the cross-attention
    whole on every rank (their caches every head), the MLPs split over
    d_ff and all-reduced, one a decoder layer; the encoder's layers held
    (its attention whole, its MLP split) but not run by a decode step."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    dec = 2 * 3 * d + 2 * _attn_bytes(cfg, False) + _mlp_bytes(cfg)
    enc = 2 * 2 * d + _attn_bytes(cfg, False) + _mlp_bytes(cfg)
    src = DEC_S // cfg.enc_frames_ratio
    cache = cfg.n_layers * 2 * DEC_B * (DEC_S + src) * h * hd * 2
    row = 2 * DEC_B * d
    return (cfg.n_layers * dec + cfg.enc_layers * enc, cache,
            [row] + [row] * cfg.n_layers, [])


def _llava_row(cfg):
    """The dense Mistral backbone: 32 query heads (2 a rank) and 8 KV
    heads whole (a rank reads 1), the MLP over d_ff; the attention and
    the MLP each all-reduced; every layer a 4,096-row ring buffer."""
    d, hd = cfg.d_model, cfg.hd
    layer = 2 * 2 * d + _attn_bytes(cfg, True) + _mlp_bytes(cfg)
    cache = cfg.n_layers * 2 * DEC_B * cfg.window * 1 * hd * 2
    row = 2 * DEC_B * d
    return (cfg.n_layers * layer, cache,
            [row] + [row, row] * cfg.n_layers, [])


HAND = {"rwkv6-1.6b": _rwkv6_row, "recurrentgemma-9b": _recurrentgemma_row,
        "whisper-large-v3": _whisper_row,
        "llava-next-mistral-7b": _llava_row}


@pytest.mark.parametrize("arch", list(HAND))
def test_family_decode_row_equals_hand_reckoning(arch):
    """A family's counted decode_32k row on 16x16 against the hand
    reckoning of one rank's step: its resident bytes (its shards of the
    weights, its cache, its tokens) exactly, its HBM those plus the
    counted peak of live bytes (at least its whole logits, gathered) and
    ``fits`` by 80 GB; its all-reduces and all-gathers over the 16 model
    ranks, in number and in link bytes (the logits' all-gather of the
    padded vocabulary among them)."""
    from repro_torch.roofline.analysis import collective_bytes
    cfg = get_config(arch)
    totals, info = D.build_decode_counted(cfg, SHAPES["decode_32k"],
                                          D.make_mesh("16x16"))
    weights, cache, reduces, gathers = HAND[arch](cfg)
    gathers = gathers + [2 * DEC_B * cfg.padded_vocab]       # the logits
    resident = _embed_bytes(cfg) + weights + cache + 4 * DEC_B
    assert totals["resident"] == resident
    assert totals["hbm"] == resident + totals["peak_live"]
    assert totals["peak_live"] >= 2 * DEC_B * cfg.padded_vocab
    row = D.run_one(arch, "decode_32k", verbose=False)
    assert row["roofline"]["hbm_per_device"] == totals["hbm"]
    assert row["roofline"]["fits"] == (totals["hbm"] <= 80e9)
    assert totals["collective_counts"] == dict(
        {"all_reduce": len(reduces)},
        **({"all_gather": len(gathers)} if gathers else {}))
    want = collective_bytes([("all_reduce", b, M) for b in reduces]
                            + [("all_gather", b, M) for b in gathers])
    assert totals["coll_by_op"] == pytest.approx(want, rel=1e-12)
