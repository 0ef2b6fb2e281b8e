"""The port's masks, exchange plan and RPS exchange against the JAX
package's, on the same numpy-seeded inputs.

The exchange is held **bitwise** on integer-valued f32 stacks (every sum
is exact, so the only rounding is the one division both sides do in
IEEE f32), with the drop masks drawn by the JAX package and injected into
the port. The port's own mask draws are held to the same owner forcing
and the same 1−p marginal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels import force_diag as jax_force_diag
from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.core import wire as jwire
from repro.serve import tp as jtp
from repro_torch.channels import (BernoulliChannel, force_diag, make_channel,
                                  parse_spec)
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.core import wire as twire
from repro_torch.serve import tp as ttp

RNG = np.random.default_rng(0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,s", [(4, 2), (4, 4), (4, 8), (3, 7), (1, 1)])
def test_owners_and_owner_mask_equal_reference(n, s):
    np.testing.assert_array_equal(trps.owners(n, s).numpy(),
                                  np.asarray(jrps.owners(n, s)))
    np.testing.assert_array_equal(trps.owner_mask(n, s).numpy(),
                                  np.asarray(jrps.owner_mask(n, s)))


@pytest.mark.parametrize("n,s", [(4, 4), (4, 8), (3, 2)])
def test_force_diag_equals_reference(n, s):
    rs = RNG.integers(0, 2, size=(n, s)).astype(bool)
    ag = RNG.integers(0, 2, size=(n, s)).astype(bool)
    want = jax_force_diag(jnp.asarray(rs), jnp.asarray(ag))
    got = force_diag(_t(rs), _t(ag))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("recovery", ["renorm", "scale"])
def test_divisor_equals_reference(mode, recovery):
    rs = RNG.integers(0, 2, size=(3, 4, 6)).astype(bool)
    jrec = jwire.make_recovery(recovery, p=0.3)
    trec = twire.make_recovery(recovery, p=0.3)
    want = jrps._divisor(jrec, mode, jnp.asarray(rs), 4)
    got = trps._divisor(trec, mode, _t(rs), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_model,batch,n,s,wire,recovery", [
    (1152, 8, 4, None, "f32", "renorm"),     # gemma3-1b serving shape
    (64, 4, 4, None, "f32", "renorm"),
    (24, 3, 4, 3, "bf16", "renorm"),
    (256, 2, 4, 8, "f32", "scale"),
    (10, 1, 2, 4, "f32", "renorm"),
])
def test_decode_plan_equals_reference(d_model, batch, n, s, wire, recovery):
    jp = jplan.decode_plan(d_model, batch, n, s, wire=wire,
                           recovery=recovery)
    tp_ = tplan.decode_plan(d_model, batch, n, s, wire=wire,
                            recovery=recovery)
    assert tp_.describe() == jp.describe()
    assert tp_.describe("bf16") == jp.describe("bf16")
    assert dataclasses.asdict(tp_.buckets[0]) \
        == dataclasses.asdict(jp.buckets[0])


def test_serving_decode_plan_is_one_bucket_of_2304():
    p = tplan.decode_plan(1152, 8, 4)
    (b,) = p.buckets
    assert (p.s, b.blk, b.m, b.pad) == (4, 2304, 1, 0)


@pytest.mark.parametrize("shape,s", [((1152, 8), 4), ((7, 5), 4),
                                     ((3, 4, 5), 8), ((13,), 2)])
def test_gather_scatter_round_trip(shape, s):
    n = 4
    x = torch.from_numpy(RNG.normal(size=(n,) + shape).astype(np.float32))
    plan = tplan.make_plan(torch.empty(shape, device="meta"), n, s)
    (table,) = plan.gather(x, lead=1)
    b = plan.buckets[0]
    assert tuple(table.shape) == (n, s, b.blk, b.m)
    want = jplan.make_plan(jax.ShapeDtypeStruct(shape, jnp.float32), n,
                           s).gather(jnp.asarray(x.numpy()), lead=1)[0]
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    back = plan.scatter([table], lead=1)
    torch.testing.assert_close(back, x, rtol=0, atol=0)


def _exchange_case(n, s, shape, mode, recovery, wire, jax_backend, seed):
    """The port's exchange and the JAX package's through ``jax_backend``
    ("jnp": its einsum; "pallas": its masked-average kernel in interpret
    mode, the route a TPU takes)."""
    x = RNG.integers(-8, 9, size=(n,) + shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    rs, ag = jrps.sample_masks(key, n, 0.3, s)
    jplan_ = jplan.make_plan(jax.ShapeDtypeStruct(shape, jnp.float32), n, s,
                             wire=wire, recovery=recovery)
    want = jrps.rps_exchange_global(jnp.asarray(x), key, 0.3, n, mode=mode,
                                    masks=(rs, ag), plan=jplan_,
                                    backend=jax_backend)
    tplan_ = tplan.make_plan(torch.empty(shape, device="meta"), n, s,
                             wire=wire, recovery=recovery)
    got = trps.rps_exchange_global(_t(x), None, 0.3, n, mode=mode,
                                   masks=(_t(rs), _t(ag)), plan=tplan_)
    return got, np.asarray(want)


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("recovery", ["renorm", "scale"])
@pytest.mark.parametrize("s_mult", [0.5, 1, 2])
@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
def test_exchange_bitwise_on_integer_stacks(mode, recovery, s_mult,
                                            jax_backend):
    n = 4
    s = int(n * s_mult)
    got, want = _exchange_case(n, s, (9, 5), mode, recovery, "f32",
                               jax_backend, seed=s + len(mode))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
def test_exchange_bitwise_decode_leaf(jax_backend):
    """The (1152, 8) decode leaf of gemma3-1b's TP serving path."""
    got, want = _exchange_case(4, 4, (1152, 8), "model", "renorm", "f32",
                               jax_backend, seed=11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_bitwise_bf16_wire():
    """A bf16 wire: the renorm average comes back in bf16, as from the
    reference's kernel route."""
    got, want = _exchange_case(4, 4, (16, 3), "model", "renorm", "bf16",
                               "pallas", seed=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_default_plan_and_per_bucket_masks():
    """plan=None (s from the masks) and (1, n, s) per-bucket masks."""
    n, s = 4, 8
    x = RNG.integers(-8, 9, size=(n, 33)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rs, ag = jrps.sample_masks(key, n, 0.3, s)
    want = jrps.rps_exchange_global(jnp.asarray(x), key, 0.3, n,
                                    masks=(rs, ag))
    got = trps.rps_exchange_global(_t(x), None, 0.3, n,
                                   masks=(_t(rs), _t(ag)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = trps.rps_exchange_global(_t(x), None, 0.3, n,
                                   masks=(_t(rs)[None], _t(ag)[None]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exchange_not_ported_options_raise():
    x = torch.zeros((4, 8))
    with pytest.raises(NotImplementedError):
        trps.rps_exchange_global(x, None, 0.1, 4, engine="ring",
                                 masks=trps.sample_masks(
                                     torch.Generator(), 4, 0.1))
    with pytest.raises(NotImplementedError, match="not ported"):
        trps.rps_exchange_global(x, None, 0.1, 4, corruption="collude")
    with pytest.raises(NotImplementedError):
        twire.make_recovery("ef")
    with pytest.raises(NotImplementedError):
        twire.make_codec("int8")


def test_sample_masks_owner_forcing_and_marginal():
    n, s, p, draws = 4, 8, 0.1, 10_000
    gen = torch.Generator()
    gen.manual_seed(0)
    rs, ag = trps.sample_masks(gen, n, p, s, n_buckets=draws)
    assert rs.shape == (draws, n, s) and rs.dtype == torch.bool
    own = trps.owner_mask(n, s)
    for m in (rs, ag):
        assert bool(m[:, own].all())
        off = m[:, ~own].to(torch.float64)
        sigma = np.sqrt(p * (1 - p) / off.numel())
        assert abs(off.mean().item() - (1 - p)) < 3 * sigma
    # the two legs are independent draws
    assert not torch.equal(rs, ag)


def test_bernoulli_channel_and_registry():
    ch = make_channel("bernoulli:p=0.2,s=8", 4)
    assert isinstance(ch, BernoulliChannel)
    assert (ch.n, ch.s, ch.effective_p()) == (4, 8, 0.2)
    assert make_channel(None, 4, 0.3).p == 0.3
    assert make_channel("iid", 4, 0.3).p == 0.3
    assert parse_spec("bern:p=0.1,s=2") == ("bernoulli", {"p": 0.1, "s": 2})
    gen = torch.Generator()
    rs, ag, state = ch.sample_packets(gen, None, n_buckets=5)
    assert rs.shape == (5, 4, 8) and state is None
    p0 = make_channel("bernoulli:p=0", 4)
    rs, ag = p0.sample_masks(gen)
    assert bool(rs.all()) and bool(ag.all())
    with pytest.raises(NotImplementedError, match="not ported"):
        make_channel("ge:p_bad=0.3,burst=8", 4)
    with pytest.raises(ValueError, match="unknown channel"):
        make_channel("nonsense", 4)


def test_tp_exchange_equals_reference_on_injected_masks():
    """TPContext._exchange: the port against the JAX package on integer
    partials and the JAX package's own per-site draw."""
    d, B, n = 24, 3, 4
    cfg_j = jtp.TPDecodeConfig(n_shards=n, p=0.3, receiver=1)
    cfg_t = ttp.TPDecodeConfig(n_shards=n, p=0.3, receiver=1)
    ctx_j = jtp.TPContext(cfg_j, d_model=d, batch=B, n_heads=4, d_ff=8,
                          n_layers=2)
    ctx_t = ttp.TPContext(cfg_t, d_model=d, batch=B, n_heads=4, d_ff=8,
                          n_layers=2)
    (rs, ag), _ = ctx_j.sample_site_masks(jax.random.PRNGKey(1), None)
    masks_t = (_t(rs), _t(ag))
    partials = RNG.integers(-6, 7, size=(n, B, 1, d)).astype(np.float32)
    for site in range(ctx_j.n_sites):
        want = ctx_j._exchange(jnp.asarray(partials), (rs, ag), site,
                               jax.random.PRNGKey(2))
        got = ctx_t._exchange(_t(partials), masks_t, site)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
