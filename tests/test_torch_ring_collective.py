"""The collective ring: one rank's share of the round (the plain versions
of ``csrc/ring_rank.cu``, ``kernels/ref.py::ring_rank_hop_ref`` and
``ring_rank_land_ref``) and the port's ring order.

- Hop by hop against the reference's interpret ring
  (``repro.kernels.rps_ring._ring_schedule_jax``), run op by op on one
  device under ``jax.vmap`` with a named axis, in a subprocess beside
  the world (``ppermute`` and
  ``axis_index`` have batching rules there), its ``ppermute`` spied on so
  that every partial it sends is an output: each port hop of each rank,
  fed the partial the reference's left neighbour sent, gives what the
  reference sends next, bit for bit, and the landings give its output.
- In one world of four CPU ranks: the collective ring engine equal bit
  for bit to the xla engine on integer tables, and to the port's stacked
  ``ring_round_ref`` at every rank (the int8 wire on the same uniforms).
- The ring order over two axes of a (2, 2, 2) mesh against the
  reference's ``logical_ring_ids``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rps_ring

import _torch_dist as td
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ring import logical_ring_ids
from repro_torch.launch.mesh import Mesh

N = td.WORLD
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---- hop by hop against _ring_schedule_jax ---------------------------------

HOP_CASES = [
    # (payload, acc, wire, mode, k, linear send): every mode, the three
    # wires, both payload dtypes, an EF-style separate send; two chunk
    # rows (k = 1 is held through the world cases below)
    ("float32", "float32", "f32", "model", 2, True),
    ("float32", "bfloat16", "bf16", "grad", 2, False),
    ("bfloat16", "bfloat16", "bf16", "grad_renorm", 2, False),
    ("bfloat16", "float32", "int8", "model", 2, False),
]


# the reference's interpret ring on every rank of each case, vmapped over
# a named axis with its ppermute spied on (every value it sends becomes an
# output), in a subprocess beside the port's world: op by op, since
# jitted, XLA:CPU turns the owner's division into a product by the
# reciprocal, elides the bf16 roundings, and the int8 encode divides by
# 127 as a product by its reciprocal
_HOPS = textwrap.dedent("""
    import sys, pickle
    from unittest import mock
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    from jax import lax
    from repro.core import wire as jwire
    from repro.kernels import rps_ring

    cases, N = pickle.load(open(sys.argv[1], "rb"))
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)) \\
        if jnp.asarray(x).dtype != jnp.int8 else np.asarray(x)
    out = []
    for pt, at, wire, mode, k, linear_send in cases:
        S, W = N * k, 37
        rng = np.random.default_rng(S + W + len(mode))
        blocks = jnp.asarray(rng.normal(size=(N, S, W)), jnp.dtype(pt))
        rs = jnp.asarray(rng.random((N, S)) < 0.7)
        ag = jnp.asarray(rng.random((N, S)) < 0.7)
        counts = np.maximum(np.asarray(rs).sum(0), 1).astype(np.float32)
        div = jnp.asarray(counts if mode != "grad"
                          else np.full(S, N, np.float32))
        codec = jwire.make_codec(wire)
        q = sc = None
        if codec.quantized:
            q, sc = codec.encode(blocks.astype(jnp.float32), None, lead=1)
            send = codec.decode(q, sc)
        elif linear_send:
            send = jnp.asarray(rng.normal(size=(N, S, W)), jnp.dtype(pt))
        else:
            send = blocks
        orig, sent = lax.ppermute, []

        def spy(x, axis_name, perm):
            sent.append(x)
            return orig(x, axis_name, perm)

        def rank(b, snd):
            sent.clear()
            with mock.patch.object(lax, "ppermute", spy):
                res = rps_ring._ring_schedule_jax(
                    b, rs, ag, names=("data",), n=N,
                    i=lax.axis_index("data"), k=k, mode=mode,
                    rs_dtype=jnp.dtype(at), codec=codec, send=snd, div=div)
            return res, tuple(sent)

        with jax.disable_jit():
            res, hops = jax.vmap(rank, axis_name="data")(blocks, send)
        out.append({"blocks": f32(blocks), "rs": np.asarray(rs),
                    "ag": np.asarray(ag), "div": np.asarray(div),
                    "q": None if q is None else np.asarray(q),
                    "sc": None if sc is None else np.asarray(sc),
                    "send": f32(send), "out": f32(res),
                    "sent": [f32(h) for h in hops]})
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % SRC


def _tt(a, dtype):
    """A numpy array as a CPU tensor of the dtype named (f32 values of a
    bf16 tensor convert exactly)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("c", range(len(HOP_CASES)),
                         ids=["-".join(map(str, c)) for c in HOP_CASES])
def test_rank_hops_equal_reference_ring_hop_by_hop(results, c):
    """Each rank's hops, fed the partial the reference's left neighbour
    sent, give what the reference sends next (the owner's last hop: the
    averaged chunk it broadcasts), bit for bit; the landings give the
    reference's output."""
    pt, at, wire, mode, k, _ = HOP_CASES[c]
    r = results["hops"][c]
    levels = 127 if wire == "int8" else 0
    per = 2 if levels else 1
    sent = r["sent"]
    rs_hops = [sent[per * t: per * t + per] for t in range(N - 1)]
    ag_hops = sent[per * (N - 1):]
    tacc, tout = getattr(torch, at), getattr(torch, pt)
    div_t = torch.from_numpy(r["div"])
    for i in range(N):
        rs_t = torch.from_numpy(r["rs"][i])
        if levels:
            src = torch.from_numpy(r["q"][i])
            ssc = torch.from_numpy(r["sc"][i][:, 0])
        else:
            src, ssc = _tt(r["send"][i], pt), None
        for t in range(N):
            recv = rsc = None
            if t:
                left = rs_hops[t - 1]
                recv = torch.from_numpy(left[0][(i - 1) % N]) if levels \
                    else _tt(left[0][(i - 1) % N], at)
                if levels:
                    rsc = torch.from_numpy(left[1][(i - 1) % N][:, 0])
            res = tref.ring_rank_hop_ref(
                src, ssc, rs_t, recv, rsc, div_t, chunk=(i - 1 - t) % N, k=k,
                acc_dtype=tacc, out_dtype=tout, levels=levels,
                last=t == N - 1)
            want = [ag_hops[0][i]] if t == N - 1 \
                else [w[i] for w in rs_hops[t]]
            got = list(res) if isinstance(res, tuple) else [res]
            if levels and t < N - 1:
                got[1] = got[1][:, None]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(
                    a.float().numpy() if a.dtype != torch.int8
                    else a.numpy(), b, err_msg=f"rank {i} hop {t}")
        # the landings: this rank's own chunk, then the left neighbour's
        blocks = _tt(r["blocks"][i], pt)
        ag_t = torch.from_numpy(r["ag"][i])
        final = torch.empty_like(blocks)
        tref.ring_rank_land_ref(final, _tt(ag_hops[0][i], pt), ag_t, blocks,
                                chunk=i, k=k, renorm=mode != "grad")
        for t in range(N - 1):
            tref.ring_rank_land_ref(final, _tt(ag_hops[t][(i - 1) % N], pt),
                                    ag_t, blocks, chunk=(i - 1 - t) % N,
                                    k=k, renorm=mode != "grad")
        np.testing.assert_array_equal(final.float().numpy(), r["out"][i])


# ---- the ring order ---------------------------------------------------------

def test_ring_order_equals_logical_ring_ids():
    """Every rank's ring position and neighbours over ("pod", "data") of
    a (2, 2, 2) mesh equal the reference's logical ids (its
    logical_ring_ids under three nested named vmaps)."""
    def ids(_):
        return jnp.stack(rps_ring.logical_ring_ids(
            ("pod", "data"), mesh_axis_names=("pod", "data", "model"),
            mesh_shape={"pod": 2, "data": 2, "model": 2}))

    want = jax.vmap(jax.vmap(jax.vmap(ids, axis_name="model"),
                             axis_name="data"), axis_name="pod")(
        jnp.zeros((2, 2, 2)))
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    got = np.array([logical_ring_ids(("pod", "data"), mesh, r)
                    for r in range(8)])
    np.testing.assert_array_equal(got, np.asarray(want).reshape(8, 3))


# ---- the collective ring in a world of four ranks ---------------------------

WORLD_CASES = {}


def _world_cases():
    rng = np.random.default_rng(7)
    for s in (3, 4, 8):
        for wire in ("f32", "bf16", "int8"):
            for mode in ("model", "grad"):
                if wire == "int8" and mode == "grad":
                    continue
                D = 45
                own = np.zeros((N, s), bool)
                own[np.arange(s) % N, np.arange(s)] = True
                rs = (rng.random((N, s)) < 0.6) | own
                ag = (rng.random((N, s)) < 0.6) | own
                x = rng.integers(-8, 9, (N, D)).astype(np.float32)
                blk = -(-D // s)
                u = rng.random((N, s, blk)).astype(np.float32)
                k = -(-s // N)
                S = k * N
                up = np.concatenate([u, np.zeros((N, S - s, blk),
                                                 np.float32)], 1)
                if k > 1:
                    r = np.arange(S)
                    up = up[:, (r % k) * N + r // k]
                for eng in ("ring", "xla"):
                    WORLD_CASES[f"s{s}-{wire}-{mode}-{eng}"] = dict(
                        fn="_torch_dist.exchange_case", entry="flat", x=x,
                        rs=rs, ag=ag, p=0.3, mode=mode, engine=eng,
                        wire=wire, noise=up if wire == "int8" else None,
                        u_block=u)


_world_cases()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's world and, beside it, the reference's ring replays."""
    tmp = tmp_path_factory.mktemp("ring_collective")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((HOP_CASES, N), f)
    env = dict(os.environ)
    # op by op, each primitive compiled at the CPU backend's lowest
    # optimisation level (one HLO op each: the same roundings)
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_backend_optimization_level=0 "
                             "--xla_llvm_disable_expensive_passes=true"})
    proc = subprocess.Popen([sys.executable, "-c", _HOPS, str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        world = td.run_cases(WORLD_CASES)
    finally:
        out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, out + err
    with open(tmp / "out.pkl", "rb") as f:
        hops = pickle.load(f)
    return {"world": world, "hops": hops}


def _stacked_ring(c):
    """The port's stacked ring round (``ring_round_ref``) on the ranks'
    block tables."""
    from repro_torch.core import quant as quant_lib
    x = torch.from_numpy(c["x"])
    n, D = x.shape
    s = c["rs"].shape[1]
    blk = -(-D // s)
    tbl = torch.nn.functional.pad(x, (0, s * blk - D)).reshape(1, n, s, blk)
    rs = torch.from_numpy(c["rs"])[None]
    ag = torch.from_numpy(c["ag"])[None]
    if c["mode"] == "grad":
        div = torch.full((1, s), float(n))
    else:
        div = rs.float().sum(1).clamp_min(1.0)
    kw = {}
    acc = torch.bfloat16 if c["wire"] == "bf16" else torch.float32
    if c["wire"] == "int8":
        q, sc = quant_lib.quantize(tbl, 127, torch.int8,
                                   uniforms=torch.from_numpy(c["u_block"])
                                   [None], lead=2)
        kw = dict(enc=q, scale=sc[..., 0], levels=127)
    out = tref.ring_round_ref(tbl, rs, ag, div, mode=c["mode"],
                              rs_dtype=acc, **kw)
    return out[0].reshape(n, s * blk)[:, :D].float().numpy()


RING_NAMES = [k for k in WORLD_CASES if k.endswith("-ring")]


@pytest.mark.parametrize("name", RING_NAMES)
def test_collective_ring_equals_stacked_round_and_xla(results, name):
    """The collective ring at every rank equals the port's stacked ring
    round on the same tables (and uniforms), bit for bit; on the linear
    wires it equals the collective xla engine bit for bit too (integer
    tables: every sum exact)."""
    c = WORLD_CASES[name]
    world = results["world"]
    got = np.stack([r["y"] for r in world[name]])
    np.testing.assert_array_equal(got, _stacked_ring(c))
    if c["wire"] != "int8":
        xla = np.stack([r["y"] for r in world[name[:-4] + "xla"]])
        np.testing.assert_array_equal(got, xla)
