"""The roofline on one H100 (``roofline/``) against the JAX package's
(``repro/roofline/analysis.py``, which imports no JAX), and each
hand-written kernel's cost function against PERF.md §6's bytes.

- ``analyze`` on the reference's ``HW`` and identical totals returns
  ``analyze_compiled``'s fields, equal in f64;
- ``collective_bytes`` on comm records equal to an HLO text's
  collectives equals ``collective_bytes_from_hlo`` on that text;
- ``kernel_cost`` reproduces the bytes PERF.md §6 states: exactly where
  it gives bytes, within its last stated digit elsewhere;
- the meta-device counter: the kernel wrappers record their cost on meta
  tensors (no launch counted); each period of a model's layer kinds adds
  alike, the peak of live bytes included, and the dry-run's count from
  two and three periods equals the count of every layer; a dense model's
  counted product FLOPs equal an analytic count.
"""
import dataclasses

import pytest
import torch

from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import masked_avg, rglru, ring, rwkv6
from repro_torch.kernels.masked_avg import CombineGeometry
from repro_torch.launch import dryrun
from repro_torch.roofline import HW, analyze, collective_bytes, kernel_cost
from repro_torch.roofline import analysis
from repro_torch.roofline.count import Counter
from repro_torch.serve.tp import TPDecodeConfig, make_tp_context

REF_HW = HW(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, hbm_bytes=16e9)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---- analyze / collective bytes against the reference ---------------------

TOTALS = [
    {"flops": 3.1e15, "bytes": 2.2e12, "coll": 4.0e9, "hbm": 12e9,
     "coll_by_op": {"all-gather": 1e9, "total": 4e9}},
    {"flops": 1.0e12, "bytes": 9.9e12, "coll": 1.0e6, "hbm": 17e9},
    {"flops": 5.0e11, "bytes": 1.0e9, "coll": 8.0e11, "hbm": 16e9},
]


@pytest.mark.parametrize("i", range(len(TOTALS)))
def test_analyze_equals_reference(i):
    totals = TOTALS[i]
    mf = 2.7e15 * (i + 1)
    got = analyze("a", "s", "16x16", 256, dict(totals), mf, hw=REF_HW)
    want = janalysis.analyze_compiled("a", "s", "16x16", 256, dict(totals),
                                      mf, hw=janalysis.HW())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_analyze_prices_each_flop_kind_at_its_peak():
    hw = HW()
    totals = {"flops": 3e12, "bytes": 1.0, "coll": 0.0, "hbm": 1.0,
              "flops_by_kind": {"bf16": 1e12, "tf32": 1e12, "f32": 1e12}}
    r = analyze("a", "s", "sim1", 1, totals, 1e12)
    assert r.t_compute == 1e12 / 989e12 + 1e12 / 495e12 + 1e12 / 67e12
    assert r.bottleneck == "compute" and r.fits
    assert (hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (3.35e12, 450e9, 80e9)
    assert analysis.flop_kind(torch.float32, tf32=False) == "f32"
    assert analysis.flop_kind(torch.float32, tf32=True) == "tf32"
    assert analysis.flop_kind(torch.bfloat16) == "bf16"


HLO = """
  %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = f32[512]{0} all-reduce(f32[512]{0} %y), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %z), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %cp = f32[8,40]{1,0} collective-permute(f32[8,40]{1,0} %w), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
  %a2a = bf16[4,64]{1,0} all-to-all(bf16[4,64]{1,0} %v), replica_groups={{0,1,2,3}}, dimensions={0}
"""
RECORDS = [("all_gather", 16 * 1024 * 2, 16), ("all_reduce", 512 * 4, 4),
           ("reduce_scatter", 64 * 4, 16),
           ("collective_permute", 8 * 40 * 4, 2),
           ("all_to_all", 4 * 64 * 2, 4)]


def test_collective_bytes_equal_reference_parser():
    """tests/test_substrates.py's HLO (and a permute and an all-to-all):
    the records of the same collectives give the same bytes by op. The
    permute's group size does not enter (its pairs carry none)."""
    got = collective_bytes(RECORDS)
    want = janalysis.collective_bytes_from_hlo(HLO)
    assert got == want
    assert got["total"] > 0


# ---- kernel_cost against PERF.md §6 ---------------------------------------

def test_masked_avg_grid_bytes_exact():
    """78,592 B at the quickstart's (16, 16, 72) f32, bool mask."""
    blocks, mask = _meta((16, 16, 72)), _meta((16, 16), torch.bool)
    assert kernel_cost("masked_avg_grid", blocks, mask) == \
        (2 * 16 * 16 * 72, 78_592)


@pytest.mark.parametrize("arch,want", [
    ("gemma3-1b", 184_340), ("deepseek-7b", 655_380),
    ("starcoder2-15b", 983_060), ("kimi-k2-1t-a32b", 1_146_900),
    ("llama3-405b", 2_621_460)])
def test_tp_combine_bytes_exact(arch, want):
    """A TP decode site at n 4, (8, 1, d) f32 partials, the decode plan's
    geometry: PERF.md §6 rows 1′ and 1″."""
    cfg = get_config(arch)
    tp = make_tp_context(TPDecodeConfig(n_shards=4, p=0.1), cfg, 8)
    d = cfg.d_model
    x = _meta((4, 8, 1, d))
    rs = _meta((2 * cfg.n_layers, 4, tp.geometry.s), torch.bool)
    flops, nbytes = kernel_cost("tp_combine", x, rs, rs, 1, n=4,
                                receiver=tp.receiver,
                                plan_geometry=tp.geometry,
                                wire_dtype=torch.float32)
    assert nbytes == want and flops == 3 * 4 * 8 * d


def _round(x, digits):
    return round(x / 10 ** digits)


def test_rwkv6_bytes_and_flops():
    """88.1 MB and 3.22 GFLOP at (8, 512, 32, 64) bf16, u f32."""
    r = _meta((8, 512, 32, 64), torch.bfloat16)
    flops, nbytes = kernel_cost("rwkv6", r, r, r, r, _meta((32, 64)))
    assert _round(nbytes, 5) == 881 and _round(flops, 7) == 322
    assert analysis.KERNEL_FLOP_KIND["rwkv6"] == "tf32"


def test_rglru_bytes():
    """537.0 MB at (8, 2048, 4096), bf16 x, f32 a."""
    x = _meta((8, 2048, 4096), torch.bfloat16)
    _, nbytes = kernel_cost("rglru", x, _meta((8, 2048, 4096)))
    assert _round(nbytes, 5) == 5370


@pytest.mark.parametrize("shape,want", [((3, 16, 16, 1_769_472), 1087),
                                        ((1, 16, 16, 409_600), 8389)])
def test_ring_round_bytes(shape, want):
    """10.87 GB at rps-100m's largest group, 838.9 MB at a 25 MiB bucket
    (f32, bool masks, f32 divisor)."""
    G, n, s, _ = shape
    m = _meta((G, n, s), torch.bool)
    _, nbytes = kernel_cost("ring_round", _meta(shape), m, m,
                            _meta((G, s)))
    assert _round(nbytes, 7 if want == 1087 else 5) == want


def _enc_masks(G, n, s, dropped):
    """ag with ``dropped`` zeros off the owners (block j's owner j % n)."""
    ag = torch.ones((G, n, s), dtype=torch.bool)
    off = [(g, i, j) for g in range(G) for i in range(n) for j in range(s)
           if i != j % n]
    for g, i, j in off[:dropped]:
        ag[g, i, j] = False
    return ag


@pytest.mark.parametrize("shape,dropped,want", [
    ((1, 16, 16, 409_600), 70, 6390), ((1, 4, 4, 3_200_000), 5, 3200)])
def test_ring_round_enc_bytes(shape, dropped, want):
    """The re-encoding variant: 639.0 MB at the 25 MiB bucket and 320.0
    MB at the wide path's (1, 4, 4, 3,200,000): the int8 table and its
    scales, the f32 output, the fallback read at the blocks whose
    all-gather packet dropped (70 and 5 of them in PERF.md's draws), the
    masks and the divisor. On meta masks the fallback is every block
    that can drop."""
    G, n, s, d = shape
    stack = torch.empty(shape)
    enc = torch.empty(shape, dtype=torch.int8)
    scale = torch.empty((G, n, s))
    rs = torch.ones((G, n, s), dtype=torch.bool)
    ag = _enc_masks(G, n, s, dropped)
    div = torch.empty((G, s))
    flops, nbytes = kernel_cost("ring_round_enc", stack, enc, scale, rs, ag,
                                div, levels=127)
    assert _round(nbytes, 5) == want
    assert flops == 3 * G * n * s * d + 3 * (n - 1) * G * s * d
    meta = [t.to("meta") for t in (stack, enc, scale, rs, ag, div)]
    _, worst = kernel_cost("ring_round_enc", *meta, levels=127)
    assert worst == nbytes + (G * (n - 1) * s - dropped) * d * 4


def test_ring_rank_bytes():
    """At (1, 7,077,888) on four ranks: the hop 84.9 MB, the landing
    (ag all on) 56.6 MB, the int8 re-encoding hop 21.2 MB — PERF.md §6
    row 4″ — each exactly the smoke's reckoning."""
    k, W, n = 1, 7_077_888, 4
    S = n * k
    src, recv = _meta((S, W)), _meta((k, W))
    rs, div = _meta((S,), torch.bool), _meta((S,))
    _, hop = kernel_cost("ring_rank_hop", src, None, rs, recv, None, div,
                         chunk=1, k=k)
    assert hop == 3 * k * W * 4 and _round(hop, 5) == 849
    ag = torch.ones(S, dtype=torch.bool)
    _, land = kernel_cost("ring_rank_land", torch.empty((S, W)),
                          torch.empty((k, W)), ag, torch.empty((S, W)),
                          chunk=1, k=k, renorm=True)
    assert land == 2 * k * W * 4 and _round(land, 5) == 566
    ag[1] = False                     # the chunk's row dropped: fallback
    _, land_dropped = kernel_cost("ring_rank_land", torch.empty((S, W)),
                                  torch.empty((k, W)), ag,
                                  torch.empty((S, W)), chunk=1, k=k,
                                  renorm=True)
    assert land_dropped == land + W * 4
    q, sc = _meta((S, W), torch.int8), _meta((S,))
    _, requant = kernel_cost("ring_rank_hop", q, sc, rs, _meta(
        (k, W), torch.int8), _meta((k,)), div, chunk=1, k=k, levels=127)
    assert requant == 3 * k * W + 3 * k * 4 and _round(requant, 5) == 212
    t, by = analysis.kernel_bound("ring_rank_hop", 0, hop)
    assert by == "bytes" and t == hop / 3.35e12


# ---- the wrappers on meta tensors -------------------------------------------

def test_wrappers_record_their_cost_on_meta():
    """Under the counter each wrapper meets a meta tensor with its cost
    recorded and an empty result of the right shape; no launch is
    counted. Outside a counter a meta tensor has no kernel."""
    before = (masked_avg.masked_avg_grid.launches, rwkv6.rwkv6.launches,
              rglru.rglru.launches, ring.ring_round.launches,
              ring.ring_round_enc.launches, ring.ring_rank_hop.launches,
              ring.ring_rank_land.launches, masked_avg.tp_combine.launches)
    G, n, s, d = 2, 4, 4, 16
    x, m = _meta((G, n, s, d)), _meta((G, n, s), torch.bool)
    div = _meta((G, s))
    r = _meta((2, 8, 3, 16), torch.bfloat16)
    with Counter() as c:
        assert masked_avg.masked_avg_grid(_meta((3, 4, 5)),
                                          _meta((3, 4))).shape == (3, 5)
        o, st = rwkv6.rwkv6(r, r, r, r, _meta((3, 16)))
        assert o.shape == r.shape and st.shape == (2, 3, 16, 16)
        h, last = rglru.rglru(_meta((2, 8, 6)), _meta((2, 8, 6)))
        assert h.shape == (2, 8, 6) and last.dtype == torch.float32
        assert ring.ring_round(x, m, m, div, mode="model").shape == x.shape
        q = _meta((G, n, s, d), torch.int8)
        assert ring.ring_round_enc(x, q, _meta((G, n, s)), m, m, div,
                                   mode="model", levels=127).shape == x.shape
        part, scale = ring.ring_rank_hop(
            _meta((8, 16), torch.int8), _meta((8,)), _meta((8,), torch.bool),
            None, None, _meta((8,)), chunk=1, k=2, levels=127)
        assert part.shape == (2, 16) and scale.shape == (2,)
        ring.ring_rank_land(_meta((8, 16)), _meta((2, 16)),
                            _meta((8,), torch.bool), _meta((8, 16)),
                            chunk=1, k=2, renorm=True)
        geom = CombineGeometry(s=4, blk=8, pad=0)
        out = masked_avg.tp_combine(_meta((4, 8, 1, 4)),
                                    _meta((2, 4, 4), torch.bool),
                                    _meta((2, 4, 4), torch.bool), 1, n=4,
                                    receiver=0, plan_geometry=geom,
                                    wire_dtype=torch.float32)
        assert out.shape == (8, 1, 4) and out.dtype == torch.float32
    assert set(c.kernels) == set(analysis.KERNELS)
    assert all(v["calls"] == 1 for v in c.kernels.values())
    want = kernel_cost("ring_round", x, m, m, div)
    assert (c.kernels["ring_round"]["flops"],
            c.kernels["ring_round"]["bytes"]) == want
    assert c.flops_by_kind["tf32"] == kernel_cost(
        "rwkv6", r, r, r, r, _meta((3, 16)))[0]
    with pytest.raises(ValueError, match="no kernel"):
        ring.ring_round(x, m, m, div, mode="model")
    with pytest.raises(ValueError, match="no kernel"):
        rglru.rglru(_meta((2, 8, 6)), _meta((2, 8, 6)))
    after = (masked_avg.masked_avg_grid.launches, rwkv6.rwkv6.launches,
             rglru.rglru.launches, ring.ring_round.launches,
             ring.ring_round_enc.launches, ring.ring_rank_hop.launches,
             ring.ring_rank_land.launches, masked_avg.tp_combine.launches)
    assert after == before


def test_counter_bytes_follow_the_rules():
    """Inputs read once and outputs written once; views move nothing; an
    in-place op counts its mutated operand once; a broadcast operand by
    the memory it spans; products by kind."""
    a, b = _meta((64, 32)), _meta((32, 16))
    with Counter() as c:
        y = a @ b                         # 64·32 + 32·16 read, 64·16 out
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c.flops_by_kind == {"f32": 2 * 64 * 32 * 16}
    with Counter() as c:
        v = y.t().reshape(-1)             # a copy: read and written
        y.view(16, 64)                    # a view: nothing
        y.add_(1.0)                       # read-modify-write once
        y + _meta((16,)).expand(64, 16)   # the broadcast row spans 64 B
    assert c.bytes == (2 * 64 * 16 + 64 * 16 + 64 * 16 + 16 + 64 * 16) * 4
    assert v.shape == (1024,)
    assert c.peak_live >= 64 * 16 * 4


# ---- every layer counted -------------------------------------------------

# forward-only passes of reduced configs deepened by whole periods of their
# layer kinds (gemma3's 5 local : 1 global, recurrentgemma's rec, rec,
# attention; deepseek two layers, as at one the peak of live bytes lies
# elsewhere in the step): (arch, kind, B, S, decoder layers a period,
# encoder layers a
# period)
DEPTH_CASES = [("gemma3-1b-reduced", "prefill", 2, 128, 6, 0),
               ("gemma3-1b-reduced", "decode", 2, 128, 6, 0),
               ("deepseek-7b-reduced", "prefill", 1, 4096, 2, 0),
               ("mixtral-8x22b-reduced", "prefill", 2, 64, 2, 0),
               ("rwkv6-1.6b-reduced", "prefill", 2, 384, 2, 0),
               ("recurrentgemma-9b-reduced", "prefill", 2, 128, 3, 0),
               ("whisper-large-v3-reduced", "prefill", 2, 64, 2, 2),
               ("llava-next-mistral-7b-reduced", "decode", 2, 64, 2, 0)]


def _count_depth(arch, kind, B, S, layers, enc):
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              enc_layers=enc)
    shape = ShapeConfig("t", S, B, kind)
    totals, _ = dryrun.builder_for(shape)(cfg, shape,
                                          dryrun.make_mesh("sim1"))
    return totals


@pytest.mark.parametrize("arch,kind,B,S,layers,enc", DEPTH_CASES)
def test_each_period_of_layers_adds_alike(arch, kind, B, S, layers, enc):
    """Every layer is counted: at one, two and three periods of layers
    the third period adds exactly what the second did — FLOPs by kind,
    bytes, each kernel's calls, FLOPs and bytes, the collectives, the
    resident bytes and the peak of live ones (gemma3's local and global
    layers, recurrentgemma's rec and attention kinds, whisper's encoder
    stack, the chunked attention at 4,096 tokens, RWKV-6's kernel)."""
    t1, t2, t3 = (_count_depth(arch, kind, B, S, k * layers, k * enc)
                  for k in (1, 2, 3))

    def step(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            return {k: step(a[k], b[k]) for k in a}
        return b - a
    for key in ("flops_by_kind", "bytes", "kernels", "coll", "resident",
                "peak_live", "hbm"):
        assert step(t2[key], t3[key]) == step(t1[key], t2[key]), key
    assert t2["flops"] > t1["flops"] and t2["bytes"] > t1["bytes"]
    assert t2["hbm"] > t1["hbm"]


@pytest.mark.parametrize("arch,kind,B,S,layers,enc", DEPTH_CASES)
def test_by_periods_equals_every_layer(arch, kind, B, S, layers, enc):
    """The dry-run's count of a deep stack from its stack cut to two and
    three periods (``dryrun.by_periods``) equals the count of every layer
    in every total — FLOPs, bytes, kernels, the peak of live bytes and
    so ``hbm`` — at six periods, and visits neither the whole stack nor
    more layers than it."""
    cfg = dataclasses.replace(get_config(arch), n_layers=6 * layers,
                              enc_layers=6 * enc)
    depths = []

    def count(c):
        depths.append(c.n_layers + c.enc_layers)
        return (dryrun._prefill_whole if kind == "prefill"
                else dryrun._decode_whole)(c, B, S)
    got = dryrun.by_periods(cfg, count)
    assert len(depths) == 2 and depths[0] < depths[1]
    assert sum(depths) < cfg.n_layers + cfg.enc_layers
    assert got == count(cfg)


# (arch, shape kind, B, S): a train step (its backward and exchange), a
# prefill and a decode step
SIGNATURE_CASES = [("mixtral-8x22b-reduced", "train", 2, 64),
                   ("rwkv6-1.6b-reduced", "train", 2, 64),
                   ("whisper-large-v3-reduced", "prefill", 2, 64),
                   ("recurrentgemma-9b-reduced", "decode", 2, 128)]


@pytest.mark.parametrize("arch,kind,B,S", SIGNATURE_CASES)
def test_ops_made_again_from_their_signature_count_alike(arch, kind, B, S,
                                                         monkeypatch):
    """The counter makes an op's outputs again from an earlier op of the
    same signature instead of running it: every total equals a count
    that runs every op."""
    import repro_torch.roofline.count as count_lib
    shape = ShapeConfig("t", S, B, kind)
    build = dryrun.builder_for(shape)
    cfg = get_config(arch)
    got, _ = build(cfg, shape, dryrun.make_mesh("sim1"))
    monkeypatch.setattr(count_lib, "_signature", lambda *a: None)
    want, _ = build(cfg, shape, dryrun.make_mesh("sim1"))
    assert got == want


def test_dense_product_flops_equal_the_analytic_count():
    """deepseek-7b reduced (dense, full attention at S = 64): the counted
    product FLOPs of one train step are 3 × the forward's products (each
    product's two operands take gradients): per layer q, k, v, o, the
    (S × S) scores and their product with v, the three MLP matrices;
    then the head."""
    cfg = get_config("deepseek-7b-reduced")
    B, S = 2, 64
    shape = ShapeConfig("t", S, B, "train")
    totals, info = dryrun.build_train_counted(cfg, shape,
                                              dryrun.make_mesh("sim1"))
    assert info["microbatch"] == 1
    T, d, h, kv, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = (2 * T * d * h * hd * 2 + 2 * T * d * kv * hd * 2
             + 2 * B * h * S * S * hd * 2 + 3 * 2 * T * d * cfg.d_ff)
    head = 2 * T * d * cfg.padded_vocab
    fwd = cfg.n_layers * layer + head
    assert totals["flops"] == 3 * fwd
