"""The int8 wire and the error-feedback recovery on the port's exchange,
against the JAX package's, on the same numpy-seeded inputs; the
stochastic rounding takes the reference's own uniforms
(``jax.random.uniform`` of the key the reference folds per exchange
group), handed to the port as an input.

- ``ring_global_sums(codec=int8)`` (the partial re-encoded before every
  hop's add) and the ring round's encoded variant's plain version
  (``ring_round_ref(enc=, scale=, levels=)``) against the reference's
  global ring replay, divide and select;
- ``rps_exchange_global(wire="int8")`` and ``(recovery="ef")`` on f32,
  bf16 and int8 wires, both engines, every mode, s below / at / above n,
  single / per-leaf / two-bucket plans, against the reference's;
- the plain variant against the reference's collective interpret ring
  with the int8 codec (``ring_exchange_scatter_table(use_kernel=False)``
  on 4 forced host devices), at an f32 payload;
- the kernel against its plain version on the card (``cuda``-marked).

Bitwise against the reference run op by op (``jax.disable_jit()``). The
jitted reference fuses the scan and computes the scale as a product by
1/127, so its roundings differ: against it the results agree within
rel 1e-5 of each row's magnitude (about 80 f32 ulps; measured at most
8.8e-6).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.core import wire as jwire
from repro.kernels import rps_ring as jring
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.core import wire as twire
from repro_torch.kernels import ops, ring
from repro_torch.kernels.ref import ring_global_sums, ring_round_ref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 8
JIT_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
WIRE_TAG = 0x77697265          # the reference's per-exchange noise tag
JC, TC = jwire.make_codec("int8"), twire.make_codec("int8")


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_rows_close(got, want, rtol=JIT_RTOL, of=None):
    """|got − want| ≤ rtol · max|row| over each row (the last dim) of
    ``want``, or of ``of`` (the EF residual is a difference of two values
    of the exchanged rows' magnitude)."""
    g, w = _np32(got), _np32(want)
    scale = np.abs(_np32(w if of is None else of)).max(axis=-1,
                                                       keepdims=True)
    assert (np.abs(g - w) <= rtol * scale).all(), np.abs(g - w).max()


def _masks(key, n, s, nb=None):
    return jrps.sample_masks(jax.random.PRNGKey(key), n, 0.3, s,
                             n_buckets=nb)


def _stack(G, s, seed, zero=True):
    x = np.random.default_rng(seed).normal(size=(G, N, s, 37)
                                           ).astype(np.float32)
    if zero:
        x[0, :, 0] = 0.0        # a block that is zero in every rank
    return x


def _reference_round(x, rs, ag, mode, levels=True, codec=JC, send=None):
    """The reference global path's ring round: the RNE encode, the
    decoded send in x's dtype, ring_global_sums, divide, cast, select."""
    div = jrps._divisor(jwire.make_recovery("renorm"), mode,
                        rs.astype(jnp.float32), N)
    s = x.shape[2]
    if send is None:
        q, sc = codec.encode(x, None, lead=2)
        send = codec.decode(q, sc).astype(x.dtype)
    else:
        q = sc = None
    acc = codec.accum_dtype
    sums = jring.ring_global_sums(send, rs.astype(jnp.float32),
                                  jrps.owners(N, s), rs_dtype=acc,
                                  codec=codec if levels else None)
    tilde = (sums / div[..., None].astype(acc)).astype(x.dtype)
    keep = ag[..., None]
    fb = jnp.zeros_like(x) if mode == "grad" else x
    return jnp.where(keep, tilde[:, None], fb), q, sc, div


# ---- the plain versions against the reference's global ring ---------------

@pytest.mark.parametrize("s", [1, N // 2, N, 2 * N])
@pytest.mark.parametrize("codec", [None, "int8"])
def test_ring_global_sums_int8_equals_reference(s, codec):
    x = _stack(2, s, seed=s)
    rs, _ = _masks(s + 1, N, s, nb=2)
    send = np.asarray(JC.fake_quant(jnp.asarray(x), None, lead=2))
    jcodec = None if codec is None else JC
    with jax.disable_jit():
        want = jring.ring_global_sums(jnp.asarray(send),
                                      rs.astype(jnp.float32),
                                      jrps.owners(N, s), codec=jcodec)
    got = ring_global_sums(_t(send), _t(rs).float(), trps.owners(N, s),
                           codec=None if codec is None else TC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jitted = jax.jit(lambda a, m: jring.ring_global_sums(
        a, m, jrps.owners(N, s), codec=jcodec))(send,
                                                rs.astype(jnp.float32))
    _assert_rows_close(got, jitted)


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("s", [1, N // 2, N, 2 * N])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_round_ref_int8_equals_reference_global_ring(mode, s, dtype):
    x = jnp.asarray(_stack(3, s, seed=s + len(mode))).astype(dtype)
    rs, ag = _masks(s + 2, N, s, nb=3)
    with jax.disable_jit():
        want, q, sc, div = _reference_round(x, rs, ag, mode)
    got = ring_round_ref(_t(x), _t(rs), _t(ag), _t(div), mode=mode,
                         enc=_t(q), scale=_t(sc)[..., 0], levels=JC.levels)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np32(got), _np32(want))
    # the router's plain route and the wrapper's CPU route agree
    args = (_t(x), _t(rs), _t(ag), _t(div))
    enc = dict(enc=_t(q), scale=_t(sc)[..., 0], levels=JC.levels)
    assert torch.equal(ops.ring_round(*args, mode=mode, backend="ref", **enc),
                       got)
    assert torch.equal(ops.ring_round(*args, mode=mode, **enc), got)


@pytest.mark.parametrize("mode", ["model", "grad"])
@pytest.mark.parametrize("s", [N // 2, 2 * N])
def test_ring_round_ref_int8_without_requant(mode, s):
    """levels = 0: the decoded contributions summed in ring order in f32,
    no re-encode (the reference's replay with a linear f32 accumulation
    of the decoded send)."""
    x = jnp.asarray(_stack(2, s, seed=3 * s))
    rs, ag = _masks(s + 3, N, s, nb=2)
    with jax.disable_jit():
        want, q, sc, div = _reference_round(x, rs, ag, mode, levels=False)
    got = ring_round_ref(_t(x), _t(rs), _t(ag), _t(div), mode=mode,
                         enc=_t(q), scale=_t(sc)[..., 0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("s", [1, N, 2 * N])
def test_ring_round_ref_linear_send_equals_reference(mode, wire, s):
    """The EF send on a linear wire: a payload-dtype table replaces the
    stack as the contribution source, summed in the wire dtype; the
    stack stays the fallback. Bitwise at f32, within one bf16 ulp at a
    bf16 wire (tests/test_torch_ring.py's allowance)."""
    x = jnp.asarray(_stack(2, s, seed=s + 7, zero=False))
    rng = np.random.default_rng(s)
    codec = jwire.make_codec(wire)
    send = codec.fake_quant(x + jnp.asarray(
        0.1 * rng.normal(size=x.shape).astype(np.float32)))
    rs, ag = _masks(s + 4, N, s, nb=2)
    with jax.disable_jit():
        want, _, _, div = _reference_round(x, rs, ag, mode, codec=codec,
                                           send=send)
    got = ring_round_ref(_t(x), _t(rs), _t(ag), _t(div), mode=mode,
                         rs_dtype=twire.make_codec(wire).accum_dtype,
                         enc=_t(send))
    if wire == "f32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BF16_ULP, atol=0)


# ---- the exchange ---------------------------------------------------------

def _tree(rng):
    """Two f32 leaves and a bf16 one, normal data, stacked for n = 8."""
    return {"a": rng.normal(size=(N, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(N, 33)).astype(np.float32),
            "c": jnp.asarray(rng.normal(size=(N, 5, 5)), jnp.bfloat16)}


def _plans(kind, s, wire, recovery):
    shapes = {"a": ((6, 4), "float32"), "b": ((33,), "float32"),
              "c": ((5, 5), "bfloat16")}
    jtree = {k: jax.ShapeDtypeStruct(v[0], jnp.dtype(v[1]))
             for k, v in shapes.items()}
    ttree = {k: torch.empty(v[0], dtype=getattr(torch, v[1]), device="meta")
             for k, v in shapes.items()}
    kw = dict(wire=wire, recovery=recovery)
    if kind == "single":
        return (jplan.single_bucket_plan(jtree, N, s, **kw),
                tplan.single_bucket_plan(ttree, N, s, **kw))
    if kind == "per_leaf":
        return (jplan.per_leaf_plan(jtree, N, s, **kw),
                tplan.per_leaf_plan(ttree, N, s, **kw))
    return (jplan.make_plan(jtree, N, s, n_buckets=2, **kw),
            tplan.make_plan(ttree, N, s, n_buckets=2, **kw))


def _noise_hook(key):
    """The reference's per-group uniforms (rps.py: fold_in(fold_in(key,
    'wire'), g_idx), uniform over the group's stack shape)."""
    def hook(g_idx, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, WIRE_TAG), g_idx)
        return _t(jax.random.uniform(k, shape))
    return hook


def _exchange_pair(kind, s, mode, engine, wire="int8", recovery="renorm",
                   seed=0, jit=False):
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    jp, tp = _plans(kind, s, wire, recovery)
    assert tp.describe() == jp.describe()
    nb = jp.n_buckets if jp.per_bucket_masks else None
    rs, ag = _masks(seed + s, N, s, nb=nb)
    key = jax.random.PRNGKey(seed + 100)
    ef = None
    if recovery == "ef":
        ef = {k: 0.05 * rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in tree.items()}
        ef["c"] = jnp.asarray(ef["c"], jnp.bfloat16)

    def ref(t, e):
        return jrps.rps_exchange_global(
            t, key, 0.3, N, mode=mode, masks=(rs, ag), plan=jp,
            engine=engine, ef_state=e)

    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jef = None if ef is None else {k: jnp.asarray(v) for k, v in ef.items()}
    if jit:
        want = jax.jit(ref)(jtree, jef)
    else:
        with jax.disable_jit():
            want = ref(jtree, jef)
    got = trps.rps_exchange_global(
        {k: _t(v) for k, v in tree.items()}, None, 0.3, N, mode=mode,
        masks=(_t(rs), _t(ag)), plan=tp, engine=engine,
        ef_state=None if ef is None else {k: _t(v) for k, v in ef.items()},
        wire_noise=_noise_hook(key))
    return got, want, tree


def _assert_trees_equal(got, want):
    for k in want:
        assert got[k].dtype == getattr(torch, jnp.dtype(want[k].dtype).name)
        np.testing.assert_array_equal(_np32(got[k]), _np32(want[k]))


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("kind", ["single", "per_leaf", "bucketed2"])
@pytest.mark.parametrize("s", [N // 2, N, 2 * N])
def test_int8_exchange_equals_reference(engine, mode, kind, s):
    got, want, _ = _exchange_pair(kind, s, mode, engine, seed=s)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("mode", ["model", "grad"])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["per_leaf", "bucketed2"])
def test_ef_exchange_equals_reference(engine, mode, wire, kind):
    """recovery="ef" with a nonzero residual: the exchanged tree and the
    new residual (intent − send where delivered, the old residual where
    dropped)."""
    (got, got_ef), (want, want_ef), _ = _exchange_pair(
        kind, N, mode, engine, wire=wire, recovery="ef", seed=1)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got_ef, want_ef)


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("recovery", ["renorm", "ef"])
def test_int8_exchange_within_tolerance_of_jitted_reference(engine,
                                                            recovery):
    """The f32 leaves within rel 1e-5 of each row's magnitude (the EF
    residual, a difference of two values of the input's magnitude, of the
    input's rows). The bf16 leaf within one bf16 ulp plus one int8 grid
    step (1/127) of the leaf's magnitude: XLA:CPU elides the bf16
    roundings of the fused intent and average, and a bf16 value can sit
    on an exact rounding tie of x / Δ, which the jitted product by 1/127
    moves off it (a payload one step apart)."""
    got, want, tree = _exchange_pair("bucketed2", N, "model", engine,
                                     recovery=recovery, seed=2, jit=True)
    pairs = [(got, want, None)]
    if recovery == "ef":
        (got, got_ef), (want, want_ef) = (got, want)
        pairs = [(got, want, None), (got_ef, want_ef, tree)]
    for g, w, of in pairs:
        for k in w:
            if k == "c":
                err = np.abs(_np32(g[k]) - _np32(w[k])).max()
                top = np.abs(_np32(tree[k])).max()
                assert err <= (BF16_ULP + 1.0 / 127) * top, err
            else:
                _assert_rows_close(g[k], w[k],
                                   of=None if of is None else of[k])


def test_f32_ef_equals_renorm_and_keeps_a_zero_residual():
    """The f32 codec is exact: ef sends the intent x + 0 and its residual
    stays zero, so f32 + ef is f32 + renorm bitwise."""
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(N, 40)).astype(np.float32))
    rs, ag = _masks(9, N, N)
    masks = (_t(rs), _t(ag))
    for engine in ("xla", "ring"):
        out, ef = trps.rps_exchange_global(
            x, None, 0.3, N, masks=masks, engine=engine, recovery="ef",
            ef_state=twire.init_ef_state(x))
        plain = trps.rps_exchange_global(x, None, 0.3, N, masks=masks,
                                         engine=engine)
        assert torch.equal(out, plain) and not ef.any()


def test_int8_exchange_noise_sources():
    x = torch.randn((N, 40), generator=torch.Generator().manual_seed(0))
    rs, ag = _masks(3, N, N)
    masks = (_t(rs), _t(ag))
    with pytest.raises(ValueError, match="wire_noise"):
        trps.rps_exchange_global(x, None, 0.3, N, masks=masks, wire="int8")
    with pytest.raises(ValueError, match="ef_state"):
        trps.rps_exchange_global(x, None, 0.3, N, masks=masks,
                                 recovery="ef")
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(1)
        outs.append(trps.rps_exchange_global(
            x, None, 0.3, N, masks=masks, wire="int8", engine="ring",
            wire_noise=gen))
    assert torch.equal(outs[0], outs[1])        # one seed, one draw
    gen = torch.Generator()
    gen.manual_seed(2)
    other = trps.rps_exchange_global(x, None, 0.3, N, masks=masks,
                                     wire="int8", engine="ring",
                                     wire_noise=gen)
    assert torch.isfinite(other).all() and not torch.equal(other, outs[0])
    exact = trps.rps_exchange_global(x, None, 0.3, N, masks=masks,
                                     engine="ring")
    assert (other - exact).abs().max() < 0.1    # the int8 grid's error


# ---- the plain version against the collective interpret ring ------------

def test_ring_round_ref_int8_equals_interpret_ring_4dev():
    """ring_exchange_scatter_table(use_kernel=False, codec=int8) under
    shard_map on 4 forced host devices — the hop-for-hop collective ring,
    the partial re-encoded on every hop — against ring_round_ref with the
    same int8 table, at an f32 payload (where the collective ring's f32
    decode and the global path's payload rounding agree), every mode, s
    in {1, 2, 4, 8}: bitwise against the ring run op by op (one case;
    eager shard_map takes about 30 s a case), within rel 1e-5 of each
    row's magnitude against the jitted ring, which divides by 127 as a
    product by its reciprocal."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys; sys.path.insert(0, %r)
        import numpy as np, jax, jax.numpy as jnp, torch
        from jax import lax
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.core import rps, wire
        from repro.kernels import rps_ring
        from repro.train.trainer import _shard_map
        from repro_torch.kernels.ref import ring_round_ref

        n = 4
        codec = wire.make_codec("int8")
        mesh = Mesh(np.array(jax.devices()).reshape(n), ("data",))
        rng = np.random.default_rng(2)
        checks = bitwise = 0
        for s in (1, 2, 4, 8):
            k, S, order, inv = rps._scatter_layout(n, s)
            for mode in ("model", "grad", "grad_renorm"):
                x = rng.normal(size=(n, s, 6)).astype(np.float32)
                x[:, 0] = 0.0
                q, sc = codec.encode(jnp.asarray(x), None, lead=1)
                q, sc = np.asarray(q), np.asarray(sc)
                rs, ag = rps.sample_masks(
                    jax.random.PRNGKey(s + checks), n, 0.35, s)
                rs_sc, ag_sc = rps._masks_to_scatter(rs, ag, S, order)
                div = rps._divisor(wire.make_recovery(None), mode,
                                   rs_sc, n)

                def body(b, qb, sb, r_sc, a_sc, dv):
                    blk, qt, st = b[0], qb[0], sb[0]
                    if S != s:
                        pad = ((0, S - s), (0, 0))
                        blk, qt = jnp.pad(blk, pad), jnp.pad(qt, pad)
                        st = jnp.pad(st, pad, constant_values=1.0)
                    if order is not None:
                        blk, qt, st = blk[order], qt[order], st[order]
                    out = rps_ring.ring_exchange_scatter_table(
                        blk, r_sc, a_sc, names=("data",), n=n,
                        i=lax.axis_index("data"), k=k, mode=mode,
                        rs_dtype=jnp.float32, use_kernel=False,
                        codec=codec, enc=(qt, st), div=dv)
                    if inv is not None:
                        out = out[inv]
                    return out[:s][None]

                f = _shard_map(body, mesh, (P("data"),) * 3 + (P(),) * 3,
                               P("data"), {"data"})
                args = (jnp.asarray(x), q, sc, rs_sc, ag_sc, div)
                eager = (s, mode) == (2, "model")
                if eager:       # op by op: slow, so one case
                    with jax.disable_jit():
                        want = np.asarray(f(*args))
                else:
                    want = np.asarray(jax.jit(f)(*args))
                tdiv = torch.from_numpy(np.array(
                    rps._divisor(wire.make_recovery(None), mode,
                                 rs.astype(jnp.float32), n)))
                got = ring_round_ref(
                    torch.from_numpy(x)[None],
                    torch.from_numpy(np.array(rs))[None],
                    torch.from_numpy(np.array(ag))[None], tdiv[None],
                    mode=mode, enc=torch.from_numpy(q)[None],
                    scale=torch.from_numpy(sc)[None, ..., 0],
                    levels=codec.levels)[0]
                err = np.abs(got.numpy() - want)
                if eager:
                    assert np.array_equal(got.numpy(), want), (s, mode)
                else:           # rel 1e-5 of each row's magnitude
                    tol = 1e-5 * np.abs(want).max(-1, keepdims=True)
                    assert (err <= tol).all(), (s, mode, err.max())
                checks += 1
                bitwise += int(np.array_equal(got.numpy(), want))
        print("INTERPRET_RING_INT8_OK", checks, "bitwise", bitwise)
    """) % SRC
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=570)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "INTERPRET_RING_INT8_OK 12 bitwise" in r.stdout, r.stdout


# ---- the re-encoding kernel's algebra: the int8 carry -------------------

def _int8_carry_replay(stack, enc, scale, rs, ag, div, mode, levels):
    """The ring round with the partial carried between hops as the int8 q
    of its re-encode and one step D per (g, block) row, acc recomputed at
    each hop from the carry and the contribution table -- the algebra of
    ``csrc/ring_q.cu``'s cluster path, hop for hop in torch."""
    G, n, s, d = stack.shape
    f32 = torch.float32
    own = torch.arange(s) % n
    cols = torch.arange(s)
    lv = torch.full((), float(levels))
    rs_f = rs.to(f32)

    def contrib(t):  # (G, s, d): rank own + 1 + t's decoded, gated send
        r = (own + 1 + t) % n
        dec = (enc[:, r, cols].to(f32) * scale[:, r, cols][..., None]
               ).to(stack.dtype).to(f32)
        return dec * rs_f[:, r, cols][..., None]

    q = delta = None
    for t in range(n):
        acc = contrib(t) if t == 0 else q.to(f32) * delta + contrib(t)
        if t < n - 1:
            amax = acc.abs().amax(-1, keepdim=True)
            delta = torch.where(amax > 0, amax, torch.ones(())) / lv
            q = torch.round(acc / delta).clamp(-levels, levels).to(torch.int8)
    mine = (acc / div[..., None].to(f32)).to(stack.dtype)
    fallback = torch.zeros_like(stack) if mode == "grad" else stack
    return torch.where((ag != 0)[..., None], mine[:, None], fallback)


def _carry_case(n, s, dtype, seed):
    """A (3, n, s, 40) stack with a row zero in every rank, a row with one
    dominant column (its partials sit on the clip), a row whose rank 0
    sends small negatives and whose other ranks send one large value (the
    partials' encodes round the negatives to -0), the int8 encode and
    Bernoulli(0.7) masks (dropped negative sends give -0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n, s, 40)).astype(np.float32)
    x[0, :, 0] = 0.0
    if s > 1:
        x[1, :, 1, 0] = 50.0
    x[2, 0, 0, :] = -0.02
    x[2, 0, 0, 0] = 0.5
    x[2, 1:, 0, :] = 0.0
    x[2, 1:, 0, 0] = 50.0
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    own = trps.owner_mask(n, s)
    rs = torch.from_numpy(rng.random((3, n, s)) < 0.7) | own
    ag = torch.from_numpy(rng.random((3, n, s)) < 0.7) | own
    q, sc = TC.encode(xt, lead=2)
    return xt, q, sc[..., 0], rs, ag


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_carry_replay_equals_ring_round_ref(mode, n, dtype):
    """Carrying q and D instead of the f32 partial gives the plain
    version's bits: requant(acc) = q * D exactly, so acc recomputed from
    the carry and the table is the partial the plain version adds to."""
    for s in sorted({1, max(n // 2, 1), n, 2 * n}):
        x, q, sc, rs, ag = _carry_case(n, s, dtype, seed=100 * n + s)
        div = trps._divisor(twire.make_recovery("renorm"), mode, rs, n)
        want = ring_round_ref(x, rs, ag, div, mode=mode, enc=q, scale=sc,
                              levels=TC.levels)
        got = _int8_carry_replay(x, q, sc, rs, ag, div, mode, TC.levels)
        assert got.dtype == x.dtype
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits)), (n, s)


def test_int8_carry_replay_reaches_the_clip_and_negative_zero():
    """The cases the replay is built to hold: a partial on the clip
    (|q| = levels), an all-zero row (D = 1 / levels, q = 0) and
    encodes of small negatives that round to -0 and carry as +0."""
    n, s = 4, 4
    x, q, sc, rs, ag = _carry_case(n, s, "float32", seed=7)
    rs = torch.ones_like(rs)
    dec = q.to(torch.float32) * sc[..., None]

    def encode(acc):
        amax = acc.abs().amax(-1, keepdim=True)
        delta = torch.where(amax > 0, amax, torch.ones(())) / TC.levels
        return torch.round(acc / delta).clamp(-TC.levels, TC.levels)

    assert int(encode(dec[1, 1, 1]).abs().max()) == TC.levels   # the clip
    assert bool((encode(dec[0, 1, 0]) == 0).all())              # zero row
    two = encode(dec[2, 0, 0] + dec[2, 1, 0])      # two hops' partial
    assert bool(torch.signbit(two[1:]).all())                   # -0 ...
    assert bool((two[1:].to(torch.int8) == 0).all())            # ... as 0
    div = trps._divisor(twire.make_recovery("renorm"), "model", rs, n)
    got = _int8_carry_replay(x, q, sc, rs, ag, div, "model", TC.levels)
    want = ring_round_ref(x, rs, ag, div, mode="model", enc=q, scale=sc,
                          levels=TC.levels)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _rn32(x):
    """The f32 nearest to the rational x (ties to even), as a Fraction."""
    from fractions import Fraction
    if x == 0:
        return Fraction(0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    unit = Fraction(2) ** (max(e, -126) - 23)
    m = x / unit
    mi = m.numerator // m.denominator
    rest = m - mi
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and mi % 2):
        mi += 1
    return sign * mi * unit


def test_fma_quotient_is_the_rounded_division():
    """The re-encoding kernel's encode: with inv = rn(1 / D), q0 = rn(a *
    inv), r = rn(a - q0 * D) and q1 = rn(q0 + r * inv) (two fused
    multiply-adds) equal rn(a / D), emulated exactly with rationals, for
    steps D = amax / 127 over a wide range and a near the grid's
    half-integers (where rint would expose a wrong last bit) or uniform
    in the row."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    n = 4000
    amax = (rng.uniform(1e-3, 1e3, n)
            * np.exp2(rng.integers(-60, 60, n))).astype(np.float32)
    delta = (amax / np.float32(127)).astype(np.float32)
    inv = (np.float32(1) / delta).astype(np.float32)
    k = rng.integers(-127, 128, n)
    a = ((k + 0.5) * delta.astype(np.float64)).astype(np.float32)
    a = np.nextafter(a, np.inf * rng.choice([-1, 1], n)).astype(np.float32)
    a[::3] = (rng.uniform(-1, 1, n)[::3] * amax[::3]).astype(np.float32)
    want = (a / delta).astype(np.float32)   # IEEE f32 division
    for ai, di, ii, wi in zip(a, delta, inv, want):
        fa, fd, fi = Fraction(float(ai)), Fraction(float(di)), \
            Fraction(float(ii))
        q0 = _rn32(fa * fi)
        r = _rn32(fa - q0 * fd)
        assert _rn32(q0 + r * fi) == Fraction(float(wi)), (ai, di)


@pytest.mark.parametrize("rows,d,sms,want", [
    (48, 1769472, 132, (16, 110592)),   # rps-100m's largest group
    (16, 409600, 132, (16, 25600)),     # one 25 MiB f32 bucket at n = 16
    (2, 1, 132, (1, 16)),
    (2, 4104, 132, (1, 4112)),
    (2, 16384, 132, (2, 8192)),
    (2, 32768, 132, (4, 8192)),
    (2, 65536, 132, (8, 8192)),
    (4, 131072, 132, (16, 8192)),
    (1, 2000000, 132, (16, 125008)),    # one block per SM
    (1, 3145728, 132, (16, 196608)),    # the widest row a cluster holds
    (1, 3145729, 132, (0, 0)),          # the wide path
])
def test_requant_plan(rows, d, sms, want):
    cluster, chunk = ring.requant_plan(rows, d, sms)
    assert (cluster, chunk) == want
    if cluster:
        assert chunk % 16 == 0 and chunk * cluster >= d
        assert chunk <= ring.MAX_CHUNK and cluster <= ring.MAX_CLUSTER
        assert chunk * (cluster - 1) < d          # no block left empty


# ---- the wrapper ----------------------------------------------------------

def test_ring_round_enc_routes_and_checks():
    G, n, s, d = 2, 4, 4, 3
    x = torch.randn((G, n, s, d), generator=torch.Generator().manual_seed(2))
    rs = torch.ones((G, n, s), dtype=torch.bool)
    div = torch.full((G, s), float(n))
    q, sc = TC.encode(x, lead=2)
    sc = sc[..., 0]
    before = ring.ring_round_enc.launches
    before_requant = ring.ring_round_enc.requant_launches
    out = ops.ring_round(x, rs, rs, div, mode="model", enc=q, scale=sc,
                         levels=127)
    assert ring.ring_round_enc.launches == before  # the CPU runs the ref
    assert ring.ring_round_enc.requant_launches == before_requant
    assert out.shape == x.shape and out.dtype == x.dtype
    with pytest.raises(ValueError, match="needs an int8 enc"):
        ops.ring_round(x, rs, rs, div, mode="model", levels=127)
    with pytest.raises(ValueError, match="scale"):
        ops.ring_round(x, rs, rs, div, mode="model", enc=q)
    with pytest.raises(TypeError, match="sums in f32"):
        ops.ring_round(x, rs, rs, div, mode="model", enc=q, scale=sc,
                       rs_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="enc must be"):
        ops.ring_round(x, rs, rs, div, mode="model",
                       enc=x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="re-encodes an int8 wire"):
        ops.ring_round(x, rs, rs, div, mode="model", enc=x, levels=127)
    with pytest.raises(ValueError, match="levels"):
        ops.ring_round(x, rs, rs, div, mode="model", enc=q, scale=sc,
                       levels=200)
    with pytest.raises(ValueError, match="enc shape"):
        ops.ring_round(x, rs, rs, div, mode="model", enc=q[0], scale=sc)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(1, 2), (4, 2), (8, 16), (16, 16),
                                 (16, 40)])
@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
def test_ring_round_enc_kernel_bitwise_on_card(n, s, payload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n * s)
    for d in (1, 33, 64, 4096, 4097, 4104):    # scalar and vector loads
        for mode in ring.MODES:
            x = torch.randn((3, n, s, d), generator=gen,
                            device="cuda").to(payload)
            x[0, :, 0] = 0
            own = trps.owner_mask(n, s, device="cuda")
            rs = (torch.rand((3, n, s), generator=gen, device="cuda")
                  < 0.7) | own
            ag = (torch.rand((3, n, s), generator=gen, device="cuda")
                  < 0.7) | own
            div = trps._divisor(twire.make_recovery("renorm"), mode, rs, n)
            q, sc = TC.encode(x, lead=2, gen=gen)
            send = (x.float() * 1.01).to(payload)
            for enc, levels, acc in (
                    (dict(enc=q, scale=sc[..., 0]), 127, torch.float32),
                    (dict(enc=q, scale=sc[..., 0]), 0, torch.float32),
                    (dict(enc=send), 0, torch.float32),
                    (dict(enc=send), 0, torch.bfloat16)):
                got = ops.ring_round(x, rs, ag, div, mode=mode,
                                     rs_dtype=acc, levels=levels, **enc)
                want = ops.ring_round(x, rs, ag, div, mode=mode,
                                      rs_dtype=acc, levels=levels,
                                      backend="ref", **enc)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (d, mode, levels, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16384, 65536, 131072, 2000000, 3145729])
def test_ring_round_enc_kernel_cluster_sizes_on_card(d):
    """The re-encoding kernel at the widths where its cluster grows (2, 8,
    16 blocks; one block per SM) and at a row wider than the largest
    cluster holds (the cooperative path): bitwise against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    n, s = 4, 1
    x = torch.randn((1, n, s, d), generator=gen, device="cuda")
    own = trps.owner_mask(n, s, device="cuda")
    rs = (torch.rand((1, n, s), generator=gen, device="cuda") < 0.7) | own
    ag = (torch.rand((1, n, s), generator=gen, device="cuda") < 0.7) | own
    div = trps._divisor(twire.make_recovery("renorm"), "model", rs, n)
    q, sc = TC.encode(x, lead=2, gen=gen)
    before = ring.ring_round_enc.launches
    before_requant = ring.ring_round_enc.requant_launches
    got = ops.ring_round(x, rs, ag, div, mode="model", levels=127, enc=q,
                         scale=sc[..., 0])
    want = ops.ring_round(x, rs, ag, div, mode="model", levels=127, enc=q,
                          scale=sc[..., 0], backend="ref")
    torch.cuda.synchronize()
    assert ring.ring_round_enc.launches == before + 1
    assert ring.ring_round_enc.requant_launches == before_requant + 1
    assert torch.equal(got, want)
