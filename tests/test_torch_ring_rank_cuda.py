"""On the card: ``csrc/ring_rank.cu`` (one rank's hop and landing of the
ring round) against its plain versions (``kernels/ref.py::
ring_rank_hop_ref``, ``ring_rank_land_ref``), bit for bit (NaN equal to
NaN), at f32 / bf16 payloads and accumulation and on the int8 wire,
including rows of non-finite values, and the int8 wire's re-encoding hop
with its rows split over many blocks. The ``cuda``-marked tests need a
CUDA device and skip without one; two tests run anywhere: the transport
refuses NCCL, and a world of ranks runs on the card unless asked for the
CPU. This file imports no JAX.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring_rank_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels import ring as RG

N = 4


def _same(a, b):
    if a.dtype == torch.int8:
        return bool(torch.equal(a, b))
    a, b = a.float(), b.float()
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,W", [(1, 1), (1, 33), (3, 4097), (2, 70001)])
@pytest.mark.parametrize("payload,acc,levels", [
    (torch.float32, torch.float32, 0), (torch.float32, torch.bfloat16, 0),
    (torch.bfloat16, torch.bfloat16, 0), (torch.bfloat16, torch.float32, 0),
    (torch.float32, torch.float32, 127), (torch.bfloat16, torch.float32, 127),
])
def test_cuda_ring_rank_hop_and_land_equal_plain(k, W, payload, acc, levels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k * W + levels)
    S = N * k
    rs = (torch.rand(S, generator=gen, device="cuda") < 0.7).to(torch.uint8)
    div = torch.randint(1, N + 1, (S,), generator=gen, device="cuda").float()
    if levels:
        src = torch.randint(-127, 128, (S, W), generator=gen, device="cuda",
                            dtype=torch.int8)
        ssc = torch.rand(S, generator=gen, device="cuda")
        ssc[0] = float("inf")                  # a non-finite row
        recv = torch.randint(-127, 128, (k, W), generator=gen,
                             device="cuda", dtype=torch.int8)
        rsc = torch.rand(k, generator=gen, device="cuda")
        rsc[-1] = float("nan")
    else:
        src = torch.randn((S, W), generator=gen, device="cuda").to(payload)
        src[0] = float("nan")
        src[-1, 0] = float("inf")
        ssc = rsc = None
        recv = torch.randn((k, W), generator=gen, device="cuda").to(acc)
    for chunk in range(N):
        for rv, rc, last in ((None, None, False), (recv, rsc, False),
                             (recv, rsc, True)):
            kw = dict(chunk=chunk, k=k, acc_dtype=acc, out_dtype=payload,
                      levels=levels, last=last)
            got = RG.ring_rank_hop(src, ssc, rs, rv, rc, div, **kw)
            want = R.ring_rank_hop_ref(src, ssc, rs, rv, rc, div, **kw)
            if isinstance(want, tuple):
                assert _same(got[0], want[0]) and _same(got[1], want[1])
            else:
                assert _same(got, want), (chunk, last)
    cur = torch.randn((k, W), generator=gen, device="cuda").to(payload)
    blocks = torch.randn((S, W), generator=gen, device="cuda").to(payload)
    ag = torch.rand(S, generator=gen, device="cuda") < 0.6
    for renorm in (True, False):
        got = torch.full_like(blocks, 3.0)
        want = got.clone()
        for chunk in range(N):
            RG.ring_rank_land(got, cur, ag, blocks, chunk=chunk, k=k,
                              renorm=renorm)
            R.ring_rank_land_ref(want, cur, ag, blocks, chunk=chunk, k=k,
                                 renorm=renorm)
        assert _same(got, want)


def _requant_inputs(gen, kind, k, W):
    """(src, src_scale, rs, recv, recv_scale) of a re-encoding hop at
    chunk 0 of an (N k, W) int8 table. ``random``: int8 values, a row of
    inf scales beside normal ones and a NaN received scale; ``tail_inf``
    / ``tail_nan``: rows scaled so that |q| <= 50 stays finite and 127
    overflows, one overflowing column -- the row's last, in its last
    block -- in the chunk (and its opposite in the received partial:
    inf - inf); ``zero``: all-zero chunk rows and partial."""
    S = N * k
    if kind == "random":
        src = torch.randint(-127, 128, (S, W), generator=gen, device="cuda",
                            dtype=torch.int8)
        ssc = torch.rand(S, generator=gen, device="cuda")
        ssc[S - 1] = float("inf")
        recv = torch.randint(-127, 128, (k, W), generator=gen,
                             device="cuda", dtype=torch.int8)
        rsc = torch.rand(k, generator=gen, device="cuda")
        if k > 1:
            rsc[-1] = float("nan")
        rs = (torch.rand(S, generator=gen, device="cuda") < 0.7).to(
            torch.uint8)
        return src, ssc, rs, recv, rsc
    huge = 3.4e36                      # 100 * huge < FLT_MAX < 127 * huge
    src = torch.randint(-50, 51, (S, W), generator=gen, device="cuda",
                        dtype=torch.int8)
    recv = torch.randint(-50, 51, (k, W), generator=gen, device="cuda",
                         dtype=torch.int8)
    if kind == "zero":
        src[:k] = 0
        recv.zero_()
    else:
        src[:k, -1] = 127
        if kind == "tail_nan":
            recv[:, -1] = -127
    return (src, torch.full((S,), huge, device="cuda"),
            torch.ones(S, dtype=torch.uint8, device="cuda"), recv,
            torch.full((k,), huge, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("k,W", [(2, 65536), (1, 589824), (1, 1000003),
                                 (3, 300001)])
@pytest.mark.parametrize("kind", ["random", "tail_inf", "tail_nan", "zero"])
def test_cuda_ring_rank_requant_split_rows_equal_plain(k, W, kind):
    """The re-encoding hop with each row split over many blocks (two
    launches: the blocks' maxima, then the encode) against its plain
    version, bit for bit, the first hop (no received partial) and a
    middle one: 16 columns a thread, and one (W not a multiple of 16;
    k > 1 with odd W, rows off 16-byte alignment); random inputs with
    non-finite rows, an inf or a NaN only in the row's last block,
    all-zero rows (D = 1 / levels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert RG.rank_requant_plan(k, W, sms)[0] > 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(k * W)
    src, ssc, rs, recv, rsc = _requant_inputs(gen, kind, k, W)
    div = torch.full((N * k,), float(N), device="cuda")
    for chunk in range(N):
        if kind != "random" and chunk:
            break                      # the edge rows are chunk 0's
        for rv, rc in ((None, None), (recv, rsc)):
            kw = dict(chunk=chunk, k=k, levels=127)
            before = RG.ring_rank_hop.launches
            got = RG.ring_rank_hop(src, ssc, rs, rv, rc, div, **kw)
            want = R.ring_rank_hop_ref(src, ssc, rs, rv, rc, div, **kw)
            assert RG.ring_rank_hop.launches == before + 1
            assert _same(got[0], want[0]), (kind, chunk, rv is None)
            assert _same(got[1], want[1]), (kind, chunk, rv is None)


def test_transport_refuses_nccl():
    """NCCL is refused before any process starts (two ranks on one card
    cannot use it; the route of a host with a card a rank is not
    written): the transport is never switched quietly."""
    from repro_torch.core import comm
    from repro_torch.launch.mesh import run_world
    with pytest.raises(ValueError, match="nccl"):
        comm.check_backend("nccl")
    with pytest.raises(ValueError, match="nccl"):
        run_world(print, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="gloo"):
        comm.check_backend("mpi")


def test_world_runs_on_the_card_unless_asked():
    """``run_world``'s ranks run on the card unless the caller asks for
    the CPU: without CUDA the default raises before any process starts
    instead of moving the world to the CPU."""
    import inspect
    from repro_torch.launch.mesh import run_world
    assert inspect.signature(run_world).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_world(print, 2)
