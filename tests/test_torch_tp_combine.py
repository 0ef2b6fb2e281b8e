"""The port's TP-combine kernel module (one drop-masked decode site in one
launch) against the exchange route it replaces and against the JAX
package's ``repro.serve.tp``.

On the CPU the wrapper computes its plain version, ``tp_combine_ref``:
it is held **bitwise** to the port's exchange route at the same site (the
same ops on the same layouts) and, through ``TPContext._exchange``, to
the JAX package's TP combine on the JAX package's own per-site masks:
bitwise on integer partials (every sum exact, one IEEE division), within
1e-6 on normal f32 partials (the reference's jnp route sums in its own
order). At a bf16 wire the port returns the average rounded to bf16, as
the reference's kernel route does; the reference's default jnp route
returns it unrounded, so there the port equals the reference's value
rounded to bf16, and equals the kernel route bitwise. The CUDA kernel
itself is compared on the card (marked ``cuda``; skips here) and by
chip_smoke.py phase 3c.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rps as jrps
from repro.serve import tp as jtp
from repro_torch.channels.base import Channel
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.kernels import masked_avg as K
from repro_torch.kernels.ref import tp_combine_ref
from repro_torch.serve import tp as ttp

RNG = np.random.default_rng(0)
TOL_F32 = 1e-6       # the kernel tests' f32 tolerance
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}    # by wire (card test)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _masks(n: int, s: int, sites: int, p: float = 0.3):
    """A (sites, n, s) bool mask pair drawn by the JAX package (owners
    forced), as numpy-backed tensors."""
    rs, ag = jrps.sample_masks(jax.random.PRNGKey(n * 100 + s), n, p, s,
                               n_buckets=sites)
    return _t(rs), _t(ag)


def _partials(n, B, d, dtype, integer=True):
    if integer:
        x = RNG.integers(-6, 7, size=(n, B, 1, d)).astype(np.float32)
    else:
        x = RNG.normal(size=(n, B, 1, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _exchange_route(partials, masks, site, plan, n, receiver):
    """The site code of the exchange route: ``n · partials`` transposed
    into the plan's (d, B) leaf, the exchange, the receiver's row."""
    y = torch.permute(partials[:, :, 0, :] * n, (0, 2, 1))
    out = trps.rps_exchange_global(
        y, None, 0.3, n, mode="model", masks=(masks[0][site],
                                              masks[1][site]),
        plan=plan, engine="xla")
    return out[receiver].transpose(0, 1)[:, None, :]


def _geometry(plan) -> K.CombineGeometry:
    (b,) = plan.buckets
    return K.CombineGeometry(s=plan.s, blk=b.blk * b.m, pad=b.pad)


# ---- (a) the plain version against the exchange route, bit for bit -------

@pytest.mark.parametrize("n,s_mult", [(2, 0.5), (4, 1), (4, 2), (8, 0.5),
                                      (8, 2)])
@pytest.mark.parametrize("d,B", [(1152, 8), (24, 3), (1000, 7), (37, 5)])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ref_bitwise_equals_exchange_route(n, s_mult, d, B, pdtype, wire):
    """(1152, 8) is gemma3-1b's serving leaf (no pad); the others pad the
    plan at most of these s. Normal partials: the two compute the same
    ops on the same layouts, so every bit agrees."""
    s = max(int(n * s_mult), 1)
    plan = tplan.decode_plan(d, B, n, s, wire=wire)
    geom = _geometry(plan)
    masks = _masks(n, s, sites=3)
    wdt = torch.bfloat16 if wire == "bf16" else torch.float32
    x = _partials(n, B, d, getattr(torch, pdtype), integer=False)
    for receiver in (0, n - 1):
        for site in (0, 2):
            want = _exchange_route(x, masks, site, plan, n, receiver)
            got = tp_combine_ref(x, masks[0], masks[1], site, n=n,
                                 receiver=receiver, s=geom.s, blk=geom.blk,
                                 pad=geom.pad, wire_dtype=wdt)
            assert got.shape == (B, 1, d) and got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got), _bits(want))
            wrapped = K.tp_combine(x, masks[0], masks[1], site, n=n,
                                   receiver=receiver, plan_geometry=geom,
                                   wire_dtype=wdt)
            np.testing.assert_array_equal(_bits(wrapped), _bits(want))


@pytest.mark.parametrize("kind", ["delivered", "owner"])
def test_ref_bitwise_all_delivered_and_all_dropped_but_owner(kind):
    n, s, d, B = 4, 4, 24, 3
    plan = tplan.decode_plan(d, B, n, s)
    rs, ag = _masks(n, s, sites=2)
    own = trps.owner_mask(n, s)
    rs[1], ag[1] = (True, True) if kind == "delivered" else (own, own)
    x = _partials(n, B, d, torch.float32, integer=False)
    for receiver in range(n):
        want = _exchange_route(x, (rs, ag), 1, plan, n, receiver)
        got = K.tp_combine(x, rs, ag, 1, n=n, receiver=receiver,
                           plan_geometry=_geometry(plan),
                           wire_dtype=torch.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    if kind == "owner":
        # a receiver keeps its own n·partial wherever it does not own the
        # block, and an owner's average is its own contribution
        np.testing.assert_array_equal(
            _bits(got), _bits((x[n - 1] * n).to(torch.float32)))


# ---- (b) TPContext._exchange against the JAX package's ---------------------

def _contexts(d, B, n, wire="f32", receiver=1, **kw):
    cfg_j = jtp.TPDecodeConfig(n_shards=n, p=0.3, receiver=receiver,
                               wire=wire, **kw)
    cfg_t = ttp.TPDecodeConfig(n_shards=n, p=0.3, receiver=receiver,
                               wire=wire, **kw)
    ctx_j = jtp.TPContext(cfg_j, d_model=d, batch=B, n_heads=4, d_ff=8,
                          n_layers=2)
    ctx_t = ttp.TPContext(cfg_t, d_model=d, batch=B, n_heads=4, d_ff=8,
                          n_layers=2)
    return ctx_j, ctx_t


@pytest.mark.parametrize("d,B,s", [(24, 3, None), (1152, 8, None),
                                   (37, 5, 8), (10, 7, 2)])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_tp_exchange_equals_reference_integer(d, B, s, pdtype):
    """Every site of a 2-layer stack, the JAX package's own draw:
    bitwise on integer partials."""
    n = 4
    ctx_j, ctx_t = _contexts(d, B, n, s=s)
    assert ctx_t.fused
    (rs, ag), _ = ctx_j.sample_site_masks(jax.random.PRNGKey(d + B), None)
    masks_t = (_t(rs), _t(ag))
    x = _partials(n, B, d, getattr(torch, pdtype))
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(pdtype)
    for site in range(ctx_j.n_sites):
        want = ctx_j._exchange(xj, (rs, ag), site, jax.random.PRNGKey(2))
        got = ctx_t._exchange(x, masks_t, site)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,B", [(24, 3), (1152, 8)])
def test_tp_exchange_equals_reference_normal_f32(d, B):
    """Normal f32 partials: within 1e-6 (the reference's jnp route sums
    in its own order)."""
    n = 4
    ctx_j, ctx_t = _contexts(d, B, n, receiver=0)
    (rs, ag), _ = ctx_j.sample_site_masks(jax.random.PRNGKey(7), None)
    masks_t = (_t(rs), _t(ag))
    x = _partials(n, B, d, torch.float32, integer=False)
    for site in range(ctx_j.n_sites):
        want = ctx_j._exchange(jnp.asarray(x.numpy()), (rs, ag), site,
                               jax.random.PRNGKey(2))
        got = ctx_t._exchange(x, masks_t, site)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("d,B,s", [(24, 3, None), (37, 5, 8)])
def test_tp_exchange_bf16_wire_equals_reference(d, B, s):
    """A bf16 wire, every site, integer partials: the port's consensus is
    the reference TPContext's (its jnp route, the average unrounded)
    rounded to bf16, and the reference exchange's kernel route (the
    average in bf16) bit for bit."""
    n = 4
    ctx_j, ctx_t = _contexts(d, B, n, wire="bf16", s=s)
    assert ctx_t.fused
    (rs, ag), _ = ctx_j.sample_site_masks(jax.random.PRNGKey(3), None)
    masks_t = (_t(rs), _t(ag))
    x = _partials(n, B, d, torch.float32)
    xj = jnp.asarray(x.numpy())
    for site in range(ctx_j.n_sites):
        got = ctx_t._exchange(x, masks_t, site)
        want = ctx_j._exchange(xj, (rs, ag), site, jax.random.PRNGKey(2))
        rounded = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.numpy(), rounded)
        y = jnp.transpose(xj[:, :, 0, :] * n, (0, 2, 1))
        out = jrps.rps_exchange_global(
            y, jax.random.PRNGKey(2), ctx_j.p_eff, n, mode="model",
            masks=(rs[site], ag[site]), plan=ctx_j.plan, engine="xla",
            backend="pallas")
        pallas = np.asarray(jnp.transpose(out[ctx_j.receiver],
                                          (1, 0))[:, None, :])
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_tp_context_routes_by_configuration():
    """The kernel's route for the xla engine, renorm and a linear wire;
    the exchange for the others. The fused route never calls the
    exchange, on the CPU as on the card."""
    d, B, n = 24, 3, 4
    kw = dict(d_model=d, batch=B, n_heads=4, d_ff=8, n_layers=1)
    fused = [ttp.TPContext(ttp.TPDecodeConfig(n_shards=n, p=0.1, **c), **kw)
             for c in ({}, {"wire": "bf16"}, {"engine": "auto"})]
    unfused = [ttp.TPContext(ttp.TPDecodeConfig(n_shards=n, p=0.1, **c),
                             **kw)
               for c in ({"recovery": "scale"}, {"engine": "ring"},
                         {"wire": "int8"})]
    assert all(c.fused for c in fused)
    assert not any(c.fused for c in unfused)
    assert fused[0].geometry == K.CombineGeometry(s=4, blk=18, pad=0)
    gen = torch.Generator()
    gen.manual_seed(0)
    masks, _ = fused[0].sample_site_masks(gen, None)
    x = _partials(n, B, d, torch.float32, integer=False)

    def refuse(*a, **k):
        raise AssertionError("the fused route called the exchange")

    real = trps.rps_exchange_global
    trps.rps_exchange_global = refuse
    try:
        for ctx in fused:
            for site in range(ctx.n_sites):
                assert ctx._exchange(x, masks, site).shape == (B, 1, d)
    finally:
        trps.rps_exchange_global = real
    ctx = unfused[0]
    got = ctx._exchange(x, masks, 1)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(ctx._exchange_global(x, masks, 1)))


class _LinkChannel(Channel):
    """A channel on the base class's ``sample_packets``: one draw of the
    link fates broadcast over the sites, a stride-0 (n_sites, n, s)
    stack."""

    def sample(self, gen, state=None):
        rs, ag = trps.sample_masks(gen, self.n, 0.3, self.s)
        return rs, ag, state

    def effective_p(self):
        return 0.3


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_tp_exchange_takes_a_broadcast_mask_stack(wire):
    """A channel on the base class gives every site the same (n, s) rows
    through a stride-0 view; the kernel's route reads them through their
    strides, bit for bit with the exchange route at every site."""
    d, B, n = 24, 3, 4
    ctx = ttp.TPContext(
        ttp.TPDecodeConfig(n_shards=n, p=0.1, wire=wire,
                           channel=_LinkChannel(n)),
        d_model=d, batch=B, n_heads=4, d_ff=8, n_layers=2)
    assert ctx.fused
    gen = torch.Generator()
    gen.manual_seed(5)
    masks, _ = ctx.sample_site_masks(gen, None)
    assert masks[0].stride(0) == 0 and not masks[0].is_contiguous()
    x = _partials(n, B, d, torch.float32, integer=False)
    for site in range(ctx.n_sites):
        np.testing.assert_array_equal(
            _bits(ctx._exchange(x, masks, site)),
            _bits(ctx._exchange_global(x, masks, site)))


# ---- (c) the wrapper's checks ---------------------------------------------

def _call(partials=None, rs=None, ag=None, site=0, n=4, receiver=0,
          geom=K.CombineGeometry(4, 18, 0), wire=torch.float32):
    x = _partials(4, 3, 24, torch.float32) if partials is None else partials
    m_rs, m_ag = _masks(4, 4, sites=2)
    return K.tp_combine(x, m_rs if rs is None else rs,
                        m_ag if ag is None else ag, site, n=n,
                        receiver=receiver, plan_geometry=geom,
                        wire_dtype=wire)


@pytest.mark.parametrize("bad,exc,match", [
    (dict(partials=torch.zeros((4, 3, 2, 24))), ValueError, "partials"),
    (dict(partials=torch.zeros((4, 3, 24))), ValueError, "partials"),
    (dict(n=2), ValueError, "partials"),
    (dict(rs=torch.ones((2, 4, 3), dtype=torch.bool)), ValueError, "rs"),
    (dict(ag=torch.ones((3, 4, 4), dtype=torch.bool)), ValueError, "rs"),
    (dict(site=2), ValueError, "site"),
    (dict(site=-1), ValueError, "site"),
    (dict(receiver=4), ValueError, "receiver"),
    (dict(geom=K.CombineGeometry(4, 17, 0)), ValueError, "lay out"),
    (dict(geom=K.CombineGeometry(4, 19, 3)), ValueError, "lay out"),
    (dict(partials=torch.zeros((4, 3, 1, 24), dtype=torch.float16)),
     TypeError, "partials dtype"),
    (dict(wire=torch.int8), TypeError, "wire"),
    (dict(rs=torch.ones((2, 4, 4), dtype=torch.complex64)), TypeError,
     "must be bool"),
    (dict(ag=torch.ones((2, 4, 4), dtype=torch.float32)), TypeError,
     "must be bool"),
    (dict(rs=torch.ones((2, 4, 4), dtype=torch.uint8),
          ag=torch.ones((2, 4, 4), dtype=torch.uint8)), TypeError,
     "must be bool"),
    (dict(rs=torch.ones((2, 4, 4), dtype=torch.bool, device="meta")),
     ValueError, "on meta"),
    (dict(partials=torch.zeros((4, 3, 1, 24), device="meta"),
          rs=torch.ones((2, 4, 4), dtype=torch.bool, device="meta"),
          ag=torch.ones((2, 4, 4), dtype=torch.bool, device="meta")),
     ValueError, "no kernel"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, exc, match):
    with pytest.raises(exc, match=match):
        _call(**bad)


def test_cpu_route_does_not_count_launches():
    before = K.tp_combine.launches
    out = _call()
    assert out.shape == (3, 1, 24) and out.dtype == torch.float32
    assert K.tp_combine.launches == before


# ---- (d) the kernel on the card --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_cuda_kernel_matches_plain_version_and_exchange_route(wire):
    """On the card: the kernel against its plain version (bitwise on
    integer partials, the wire's tolerance on unit-normal n·partials) and
    bitwise against the exchange route on the masked-average kernel, at
    the serving shape, at a padded one and at a wide one; with strided
    partials and with a broadcast (stride-0) mask stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wdt = torch.bfloat16 if wire == "bf16" else torch.float32
    for d, B, n, s in [(1152, 8, 4, 4), (37, 5, 8, 16), (2304, 128, 4, 4)]:
        plan = tplan.decode_plan(d, B, n, s, wire=wire)
        geom = _geometry(plan)
        stacks = [tuple(m.cuda() for m in _masks(n, s, sites=52, p=0.1)),
                  tuple(m.cuda()[:1].expand(52, n, s)
                        for m in _masks(n, s, sites=1, p=0.1))]
        for pdt in (torch.float32, torch.bfloat16):
            for integer, strided, (rs, ag) in (
                    (True, False, stacks[0]), (False, False, stacks[0]),
                    (False, True, stacks[0]), (False, False, stacks[1])):
                x = _partials(n, B, d, pdt, integer)
                if not integer:
                    x = x / n
                if strided:
                    x = x.permute(0, 3, 2, 1).contiguous().permute(
                        0, 3, 2, 1)
                x = x.cuda()
                for receiver in (0, n - 1):
                    for site in (0, 51):
                        before = K.tp_combine.launches
                        got = K.tp_combine(x, rs, ag, site, n=n,
                                           receiver=receiver,
                                           plan_geometry=geom,
                                           wire_dtype=wdt)
                        torch.cuda.synchronize()
                        assert K.tp_combine.launches == before + 1
                        want = tp_combine_ref(
                            x, rs, ag, site, n=n, receiver=receiver,
                            s=geom.s, blk=geom.blk, pad=geom.pad,
                            wire_dtype=wdt)
                        route = _exchange_route(x, (rs, ag), site, plan, n,
                                                receiver)
                        np.testing.assert_array_equal(_bits(got.cpu()),
                                                      _bits(route.cpu()))
                        if integer:
                            np.testing.assert_array_equal(
                                _bits(got.cpu()), _bits(want.cpu()))
                        else:
                            torch.testing.assert_close(
                                got, want, atol=TOL[wdt], rtol=TOL[wdt])
