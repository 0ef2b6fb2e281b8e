"""Launch and collective counting (``launch/launches.py``, the port's
counterpart of ``tools/check_hlo.py``) and ``core/comm.py``'s records.

On a 4-rank gloo world (``_torch_dist.run_cases``) one
``rps_exchange_plan`` of ``tests/test_ring.py``'s tree at 1 and 2
buckets: the records' counts equal that test's expectations of the
reference's lowered program (the ring engine 2(n−1) collective-permutes
a bucket and no reduce-scatter or all-gather; the xla engine one of each
a bucket), and the dry-run's count of the same exchange on the meta
device (a virtual rank of the same mesh) records the same collectives,
so its collective bytes equal the bytes the world's records sum.
"""
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro_torch.core import comm
from repro_torch.core import plan as plan_lib
from repro_torch.core import rps
from repro_torch.launch import launches
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.roofline import collective_bytes
from repro_torch.roofline.count import Counter

N = td.WORLD
P_DROP = 0.2
TREE = {"a": (40,), "b": (24,)}          # tests/test_ring.py's per worker
CASES = [(engine, nb) for engine in ("ring", "xla") for nb in (1, 2)]


def _masks(s, seed):
    rng = np.random.default_rng(seed)
    own = np.zeros((N, s), bool)
    own[np.arange(s) % N, np.arange(s)] = True
    rs = (rng.random((N, s)) > 0.3) | own
    ag = (rng.random((N, s)) > 0.3) | own
    return rs, ag


def _spec(engine, nb):
    rng = np.random.default_rng(7)
    x = {k: rng.integers(-8, 9, (N,) + shape).astype(np.float32)
         for k, shape in TREE.items()}
    meta = {k: torch.empty(shape, device="meta")
            for k, shape in TREE.items()}
    s = plan_lib.make_plan(meta, N, n_buckets=nb).s
    rs, ag = _masks(s, nb)
    return {"fn": "_torch_dist.count_case", "x": x, "engine": engine,
            "n_buckets": nb, "p": P_DROP, "rs": rs, "ag": ag}


@pytest.fixture(scope="module")
def world():
    specs = {f"{e}-{nb}": _spec(e, nb) for e, nb in CASES}
    return specs, td.run_cases(specs)


def _want(engine, n_buckets):
    """tests/test_ring.py::test_ring_cpu_lowering_is_ppermute_schedule's
    expectations (at n = 4)."""
    if engine == "ring":
        return {"collective_permute": 2 * (N - 1) * n_buckets,
                "reduce_scatter": 0, "all_gather": 0}
    return {"collective_permute": 0, "reduce_scatter": n_buckets,
            "all_gather": n_buckets}


@pytest.mark.parametrize("engine,nb", CASES)
def test_collective_counts_equal_check_hlo_expectations(world, engine, nb):
    specs, res = world
    for r, got in enumerate(res[f"{engine}-{nb}"]):
        launches.assert_counts(got["records"], **_want(engine, nb))
        assert got["counts"] == launches.collective_counts(got["records"])
        # one record a tensor moved: the transfers comm.STATS counts
        assert len(got["records"]) == got["transfers"], r


@pytest.mark.parametrize("engine,nb", CASES)
def test_dry_run_collective_bytes_equal_the_records(world, engine, nb):
    """The same exchange on meta tensors, rank by rank on a virtual mesh,
    under the dry-run's counter: the same records, the same link bytes."""
    specs, res = world
    spec = specs[f"{engine}-{nb}"]
    mesh = make_sim_mesh(N)
    for r, got in enumerate(res[f"{engine}-{nb}"]):
        meta = {k: torch.empty(v.shape[1:], device="meta")
                for k, v in spec["x"].items()}
        plan = plan_lib.make_plan(meta, N, n_buckets=nb)
        masks = tuple(torch.empty(spec[k].shape, dtype=torch.bool,
                                  device="meta") for k in ("rs", "ag"))
        with Counter() as c:
            out = rps.rps_exchange_plan(meta, None, P_DROP, "data",
                                        plan=plan, mesh=mesh.as_rank(r),
                                        masks=masks, engine=engine)
        assert [tuple(x) for x in c.records] == \
            [tuple(x) for x in got["records"]], r
        totals = c.totals()
        want = collective_bytes(got["records"])
        assert totals["coll_by_op"] == want
        assert totals["coll"] == want["total"] > 0
        assert {k: tuple(v.shape) for k, v in out.items()} == TREE
        if engine == "ring":      # the hops and landings priced, not run
            assert c.kernels["ring_rank_hop"]["calls"] == N * nb
            assert c.kernels["ring_rank_land"]["calls"] == N * nb


def test_outputs_are_the_exchange(world):
    """The counted run is the real exchange: the ring and xla engines
    agree bit for bit on integer-valued inputs (renorm, f32)."""
    specs, res = world
    for nb in (1, 2):
        for r in range(N):
            a, b = res[f"ring-{nb}"][r]["out"], res[f"xla-{nb}"][r]["out"]
            for k in TREE:
                np.testing.assert_array_equal(a[k], b[k])


def test_meta_collectives_send_nothing():
    """On a virtual rank comm records the collective and returns an empty
    result of the right shape; STATS counts no transfer. Records are kept
    inside a recording scope only, in every scope open."""
    mesh = make_sim_mesh(4).as_rank(2)
    g = mesh.group(("data",))
    assert g.pg is None and g.size == 4 and g.index == 2
    comm.reset_stats()
    x = torch.empty((8, 3), device="meta")
    with comm.recording() as outer:
        assert comm.reduce_scatter(x, g).shape == (2, 3)
        with comm.recording() as inner:
            assert comm.all_gather(x, g).shape == (32, 3)
            assert comm.all_reduce_sum(x, g).shape == (8, 3)
            got = comm.ring_shift([x, x[:, 0]], g, g.ranks)
    assert [tuple(t.shape) for t in got] == [(8, 3), (8,)]
    assert outer == [("reduce_scatter", 2 * 3 * 4, 4),
                     ("all_gather", 32 * 3 * 4, 4),
                     ("all_reduce", 8 * 3 * 4, 4),
                     ("collective_permute", 8 * 3 * 4, 4),
                     ("collective_permute", 8 * 4, 4)]
    assert inner == outer[1:]
    assert comm.STATS == {"staged_bytes": 0, "transfers": 0}
    assert launches.collective_counts(outer) == {
        "reduce_scatter": 1, "all_gather": 1, "collective_permute": 2,
        "all_reduce": 1, "all_to_all": 0}
    comm.all_gather(x, g)                 # no scope open: nothing kept
    assert not comm._SCOPES and outer[-1] == ("collective_permute", 32, 4)


def test_launch_counts_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        launches.launch_counts(lambda: None)


# profiler symbols as the card names them (demangled templates)
PROFILE = {
    "void ring_round_kernel<float, float, float, 4, true>(float const*, "
    "float const*, ...)": 6,
    "void tp_combine_kernel<float, float>(TpSite)": 52,
    "void ring_rank_requant_kernel<4, true, 1>(signed char const*, ...)": 2,
    "void ring_rank_hop_kernel<float, float, float, float>(...)": 3,
    "void at::native::vectorized_elementwise_kernel<4, ...>(...)": 100,
    "ampere_sgemm_128x64_nn": 7,
}


def test_kernel_launches_by_wrapper():
    got = launches.kernel_launches(PROFILE)
    assert got == {"masked_avg_grid": 0, "tp_combine": 52, "rwkv6": 0,
                   "rglru": 0, "ring_round": 6, "ring_round_enc": 0,
                   "ring_rank_hop": 5, "ring_rank_land": 0}
    summary = launches.summarize([], PROFILE)
    assert summary["kernels"] == sum(PROFILE.values())
    assert summary["tp_combine"] == 52 and summary["reduce_scatter"] == 0


def test_assert_counts_and_fused_per_bucket():
    recs = [("reduce_scatter", 16, 4), ("all_gather", 64, 4)]
    got = launches.assert_counts(recs, PROFILE, reduce_scatter=1,
                                 all_gather=1, ring_round=6)
    assert got["collective_permute"] == 0
    with pytest.raises(AssertionError, match="mismatch"):
        launches.assert_counts(recs, reduce_scatter=2)
    assert launches.assert_fused_per_bucket(PROFILE, 3, per_bucket=2) == 6
    with pytest.raises(AssertionError, match="want 3"):
        launches.assert_fused_per_bucket(PROFILE, 3)
    with pytest.raises(AssertionError, match="collectives"):
        launches.assert_fused_per_bucket(PROFILE, 6, records=recs)


@pytest.mark.cuda
def test_launch_counts_see_the_hand_written_kernels():
    """On the card: the profiler's launches of ring.cu's kernel and the
    TP combine equal their wrappers' counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build, ring
    build.load_kernels()
    G, n, s, d = 2, 4, 4, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((G, n, s, d), generator=gen, device="cuda")
    rs = torch.ones((G, n, s), dtype=torch.bool, device="cuda")
    div = torch.full((G, s), float(n), device="cuda")
    ring.ring_round.launches = 0

    def three():
        for _ in range(3):
            ring.ring_round(x, rs, rs, div, mode="model")
    counts = launches.launch_counts(three)
    assert launches.kernel_launches(counts)["ring_round"] == 3 \
        == ring.ring_round.launches
