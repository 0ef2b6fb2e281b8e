"""The port's ring round against the JAX package's ring, on the same
numpy-seeded inputs.

- ``ring_round_ref`` (the ring-round kernel's plain version, the ring run
  hop for hop on stacked ranks) and the port's
  ``rps_exchange_global(engine="ring")`` against the reference's global
  ring replay (``rps_ring.ring_global_sums``, divide, select, and its
  ``rps_exchange_global(engine="ring")``) over the reference's parity
  matrix at n = 8 (tests/test_ring.py): s in {1, n/2, n, 2n} x single /
  per-leaf / bucketed-2 plans x the three modes x f32 / bf16 wires, and
  the scale recovery. Bitwise on integer-valued data; at a bf16 wire
  within one bf16 ulp, where XLA:CPU may elide an intermediate bf16
  rounding that torch does (the reference's own allowance,
  tests/test_ring.py:148-162).
- ``ring_round_ref`` against the reference's collective interpret ring
  (``ring_exchange_scatter_table(use_kernel=False)`` under shard_map on 4
  forced host devices), bitwise.
- The kernel against its plain version on the card (``cuda``-marked).
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
BF16_ULP = 2.0 ** -7


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_match(got, want, bf16_wire: bool):
    g, w = _np32(got), _np32(want)
    if bf16_wire:
        np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def _masks(key, n, s, nb=None):
    return jrps.sample_masks(jax.random.PRNGKey(key), n, 0.3, s,
                             n_buckets=nb)


# ---- the plain version against the reference's global ring replay --------

@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("s", [1, N // 2, N, 2 * N])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ring_round_ref_equals_reference_global_ring(mode, s, wire):
    G, d = 3, 7
    rng = np.random.default_rng(s + 10 * len(mode))
    x = rng.integers(-8, 9, (G, N, s, d)).astype(np.float32)
    rs, ag = _masks(s, N, s, nb=G)
    acc = jnp.float32 if wire == "f32" else jnp.bfloat16
    rec = jwire.make_recovery("renorm")
    div = jrps._divisor(rec, mode, rs.astype(jnp.float32), N)
    sums = jring.ring_global_sums(jnp.asarray(x).astype(acc),
                                  rs.astype(jnp.float32),
                                  jrps.owners(N, s), rs_dtype=acc)
    tilde = (sums / div[..., None].astype(acc)).astype(jnp.float32)
    keep = ag[..., None]
    if mode == "grad":
        want = jnp.where(keep, tilde[:, None], 0.0)
    else:
        want = jnp.where(keep, tilde[:, None], jnp.asarray(x))
    tacc = torch.float32 if wire == "f32" else torch.bfloat16
    got = ring_round_ref(_t(x), _t(rs), _t(ag), _t(div), mode=mode,
                         rs_dtype=tacc)
    assert got.dtype == torch.float32
    _assert_match(got, want, wire == "bf16")


@pytest.mark.parametrize("s", [1, N // 2, N, 2 * N])
@pytest.mark.parametrize("rs_dtype", [torch.float32, torch.bfloat16])
def test_ring_global_sums_copy_equals_reference(s, rs_dtype):
    G, d = 2, 5
    rng = np.random.default_rng(s)
    x = rng.normal(size=(G, N, s, d)).astype(np.float32)
    rs, _ = _masks(s + 1, N, s, nb=G)
    jdt = jnp.float32 if rs_dtype == torch.float32 else jnp.bfloat16
    want = jring.ring_global_sums(jnp.asarray(x), rs.astype(jnp.float32),
                                  jrps.owners(N, s), rs_dtype=jdt)
    got = ring_global_sums(_t(x), _t(rs).to(torch.float32),
                           trps.owners(N, s), rs_dtype=rs_dtype)
    assert got.dtype == rs_dtype
    _assert_match(got, want, rs_dtype == torch.bfloat16)


def test_ring_round_ref_first_term_and_continuous_data():
    """Continuous data at an f32 wire: the plain version adds in ring
    order from the first term, the reference's replay from a zero start;
    the two are bitwise equal (0 + x = x)."""
    G, s, d = 2, N, 11
    rng = np.random.default_rng(3)
    x = rng.normal(size=(G, N, s, d)).astype(np.float32)
    rs, ag = _masks(7, N, s, nb=G)
    div = jrps._divisor(jwire.make_recovery("renorm"), "model",
                        rs.astype(jnp.float32), N)
    sums = jring.ring_global_sums(jnp.asarray(x), rs.astype(jnp.float32),
                                  jrps.owners(N, s))
    want = jnp.where(ag[..., None], (sums / div[..., None])[:, None],
                     jnp.asarray(x))
    got = ring_round_ref(_t(x), _t(rs), _t(ag), _t(div), mode="model")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the port's global exchange against the reference's, the matrix ------

def _tree(rng):
    """The reference matrix's tree (tests/test_ring.py): two f32 leaves
    and a bf16 one, integer-valued, stacked for n = 8."""
    return {"a": rng.integers(-4, 5, (N, 6, 4)).astype(np.float32),
            "b": rng.integers(-4, 5, (N, 33)).astype(np.float32),
            "c": jnp.asarray(rng.integers(-4, 5, (N, 5, 5)), jnp.bfloat16)}


def _plans(kind, s, recovery):
    shapes = {"a": ((6, 4), "float32"), "b": ((33,), "float32"),
              "c": ((5, 5), "bfloat16")}
    jtree = {k: jax.ShapeDtypeStruct(v[0], jnp.dtype(v[1]))
             for k, v in shapes.items()}
    ttree = {k: torch.empty(v[0], dtype=getattr(torch, v[1]), device="meta")
             for k, v in shapes.items()}
    if kind == "single":
        return (jplan.single_bucket_plan(jtree, N, s, recovery=recovery),
                tplan.single_bucket_plan(ttree, N, s, recovery=recovery))
    if kind == "per_leaf":
        return (jplan.per_leaf_plan(jtree, N, s, recovery=recovery),
                tplan.per_leaf_plan(ttree, N, s, recovery=recovery))
    return (jplan.make_plan(jtree, N, s, n_buckets=2, recovery=recovery),
            tplan.make_plan(ttree, N, s, n_buckets=2, recovery=recovery))


def _exchange_pair(kind, s, mode, wire, recovery="renorm", seed=0):
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    jp, tp = _plans(kind, s, recovery)
    assert tp.describe() == jp.describe()
    nb = jp.n_buckets if jp.per_bucket_masks else None
    rs, ag = _masks(seed + s, N, s, nb=nb)
    rs_dtype = jnp.float32 if wire == "f32" else jnp.bfloat16
    want = jrps.rps_exchange_global(
        {k: jnp.asarray(v) for k, v in tree.items()},
        jax.random.PRNGKey(0), 0.3, N, mode=mode, masks=(rs, ag), plan=jp,
        engine="ring", rs_dtype=rs_dtype)
    got = trps.rps_exchange_global(
        {k: _t(v) for k, v in tree.items()}, None, 0.3, N, mode=mode,
        masks=(_t(rs), _t(ag)), plan=tp, engine="ring",
        rs_dtype=getattr(torch, jnp.dtype(rs_dtype).name))
    return got, want


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("kind", ["single", "per_leaf", "bucketed2"])
@pytest.mark.parametrize("s", [1, N // 2, N, 2 * N])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ring_exchange_global_equals_reference(mode, kind, s, wire):
    got, want = _exchange_pair(kind, s, mode, wire, seed=s)
    for k in want:
        assert got[k].dtype == getattr(torch, jnp.dtype(want[k].dtype).name)
        _assert_match(got[k], want[k], wire == "bf16")


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("kind", ["single", "per_leaf", "bucketed2"])
def test_ring_exchange_global_scale_recovery_equals_reference(mode, kind):
    """The scale divisor n(1−p) is not an integer, so the quotients
    round: the port's IEEE f32 division equals the reference's."""
    got, want = _exchange_pair(kind, N, mode, "f32", recovery="scale",
                               seed=4)
    for k in want:
        np.testing.assert_array_equal(_np32(got[k]), _np32(want[k]))


def test_exchange_ring_engine_runs_parity_case():
    """engine="ring" on one stacked tensor (the case the first slice's
    exchange refused): equal to the reference's ring and, on integer
    data, to its own xla engine."""
    n, s = 4, 4
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (n, 8)).astype(np.float32)
    rs, ag = _masks(6, n, s)
    want = jrps.rps_exchange_global(jnp.asarray(x), jax.random.PRNGKey(0),
                                    0.1, n, masks=(rs, ag), engine="ring")
    got = trps.rps_exchange_global(_t(x), None, 0.1, n, engine="ring",
                                   masks=(_t(rs), _t(ag)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xla = trps.rps_exchange_global(_t(x), None, 0.1, n, engine="xla",
                                   masks=(_t(rs), _t(ag)))
    np.testing.assert_array_equal(got.numpy(), xla.numpy())
    # drawn masks on a generator run too
    gen = torch.Generator()
    gen.manual_seed(0)
    out = trps.rps_exchange_global(_t(x), gen, 0.1, n, engine="ring")
    assert out.shape == (n, 8) and torch.isfinite(out).all()


# ---- the scatter layout -----------------------------------------------------

@pytest.mark.parametrize("n,s", [(4, 2), (4, 4), (4, 8), (3, 7), (8, 16),
                                 (1, 3), (5, 11)])
def test_scatter_layout_and_masks_equal_reference(n, s):
    k, S, order, inv = trps._scatter_layout(n, s)
    jk, jS, jorder, jinv = jrps._scatter_layout(n, s)
    assert (k, S) == (jk, jS)
    if jorder is None:
        assert order is None and inv is None
    else:
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    rs, ag = _masks(n + s, n, s)
    want = jrps._masks_to_scatter(rs, ag, S, jorder)
    got = trps._masks_to_scatter(_t(rs), _t(ag), S, order)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        trps._pad_mask_blocks(_t(rs), S).numpy(),
        np.asarray(jrps._pad_mask_blocks(rs, S)))


# ---- the plain version against the collective interpret ring -------------

def test_ring_round_ref_equals_interpret_ring_4dev():
    """ring_exchange_scatter_table(use_kernel=False) under shard_map on 4
    forced host devices — the hop-for-hop collective ring — against
    ring_round_ref on the same stacked inputs: bitwise at an f32 wire on
    continuous data; at a bf16 wire on integer-valued data (exact sums)
    within one bf16 ulp, because XLA:CPU elides the bf16 rounding of the
    quotient that torch performs (the reference's own allowance between
    its two ring programs, tests/test_ring.py:148-162); every mode, s in
    {1, 2, 4, 8}."""
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
        mesh = Mesh(np.array(jax.devices()).reshape(n), ("data",))
        rng = np.random.default_rng(2)
        checks = 0
        for s in (1, 2, 4, 8):
            k, S, order, inv = rps._scatter_layout(n, s)
            for mode in ("model", "grad", "grad_renorm"):
                for acc, integer in ((jnp.float32, False),
                                     (jnp.bfloat16, True)):
                    if integer:
                        x = rng.integers(-8, 9, (n, s, 6)).astype(np.float32)
                    else:
                        x = rng.normal(size=(n, s, 6)).astype(np.float32)
                    rs, ag = rps.sample_masks(
                        jax.random.PRNGKey(s + checks), n, 0.35, s)
                    rs_sc, ag_sc = rps._masks_to_scatter(rs, ag, S, order)
                    div = rps._divisor(wire.make_recovery(None), mode,
                                       rs_sc, n)

                    def body(b, r_sc, a_sc, dv):
                        blk = b[0]
                        if S != s:
                            blk = jnp.pad(blk, ((0, S - s), (0, 0)))
                        if order is not None:
                            blk = blk[order]
                        out = rps_ring.ring_exchange_scatter_table(
                            blk, r_sc, a_sc, names=("data",), n=n,
                            i=lax.axis_index("data"), k=k, mode=mode,
                            rs_dtype=acc, use_kernel=False, div=dv)
                        if inv is not None:
                            out = out[inv]
                        return out[:s][None]

                    # masks and divisor as arguments, not closed-over
                    # constants, so XLA divides as the ring does
                    f = _shard_map(body, mesh, (P("data"), P(), P(), P()),
                                   P("data"), {"data"})
                    want = np.asarray(jax.jit(f)(jnp.asarray(x), rs_sc,
                                                 ag_sc, div))
                    tdiv = torch.from_numpy(np.array(
                        rps._divisor(wire.make_recovery(None), mode,
                                     rs.astype(jnp.float32), n)))
                    got = ring_round_ref(
                        torch.from_numpy(x.copy())[None],
                        torch.from_numpy(np.array(rs))[None],
                        torch.from_numpy(np.array(ag))[None],
                        tdiv[None], mode=mode,
                        rs_dtype=getattr(torch, jnp.dtype(acc).name))[0]
                    if acc == jnp.float32:
                        ok = np.array_equal(got.numpy(), want)
                    else:
                        ok = np.allclose(got.numpy(), want, rtol=2.0 ** -7,
                                         atol=0)
                    assert ok, (s, mode, acc,
                                np.abs(got.numpy() - want).max())
                    checks += 1
        print("INTERPRET_RING_OK", checks)
    """) % SRC
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=570)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "INTERPRET_RING_OK 24" in r.stdout, r.stdout


# ---- the wrapper ----------------------------------------------------------

def test_ring_round_routes_and_checks():
    G, n, s, d = 2, 4, 4, 3
    x = torch.randint(-4, 5, (G, n, s, d)).float()
    rs = torch.ones((G, n, s), dtype=torch.bool)
    div = torch.full((G, s), float(n))
    before = ring.ring_round.launches
    out = ops.ring_round(x, rs, rs, div, mode="model")
    assert ring.ring_round.launches == before     # the CPU runs the ref
    torch.testing.assert_close(out, x.mean(1, keepdim=True).expand_as(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.ring_round(x, rs, rs, div, mode="model", backend="ref"), out)
    with pytest.raises(ValueError, match="rs shape"):
        ops.ring_round(x, rs[0], rs, div, mode="model")
    with pytest.raises(ValueError, match="div shape"):
        ops.ring_round(x, rs, rs, div[0], mode="model")
    with pytest.raises(ValueError, match="mode"):
        ops.ring_round(x, rs, rs, div, mode="median")
    with pytest.raises(ValueError, match="backend"):
        ops.ring_round(x, rs, rs, div, mode="model", backend="triton")
    assert twire.make_codec("bf16").accum_dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(1, 2), (4, 2), (8, 16), (16, 16),
                                 (20, 40)])
@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
def test_ring_round_kernel_bitwise_on_card(n, s, payload, acc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n * s)
    for d in (1, 33, 64, 4096, 4097, 4104):    # scalar and 16-byte loads
        for mode in ring.MODES:
            x = torch.randn((3, n, s, d), generator=gen,
                            device="cuda").to(payload)
            own = trps.owner_mask(n, s, device="cuda")
            rs = (torch.rand((3, n, s), generator=gen, device="cuda")
                  < 0.7) | own
            ag = (torch.rand((3, n, s), generator=gen, device="cuda")
                  < 0.7) | own
            div = trps._divisor(twire.make_recovery("renorm"), mode, rs, n)
            got = ops.ring_round(x, rs, ag, div, mode=mode, rs_dtype=acc)
            want = ops.ring_round(x, rs, ag, div, mode=mode, rs_dtype=acc,
                                  backend="ref")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (d, mode)
