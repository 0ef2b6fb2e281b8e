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
    """Corruption, the robust recoveries and the lateness masks, once
    refused, now run: on an integer-valued stack with the reference's
    masks each output equals the reference's bit for bit (the full sweep
    is in tests/test_torch_robust.py). ``late`` moves no value, and a
    wrong-shaped one raises."""
    from repro.channels.corruption import Corruption as JCorruption
    from repro_torch.channels import Corruption as TCorruption
    x = RNG.integers(-8, 9, size=(4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    rs, ag = jrps.sample_masks(key, 4, 0.3)
    cm = JCorruption("collude", byzantine_frac=0.25).sample(key, 4, 4)
    for kw in (dict(corruption=True), dict(recovery="median"),
               dict(recovery="trimmed:beta=0.3"), dict(recovery="clip")):
        jkw, tkw = dict(kw), dict(kw)
        if kw.pop("corruption", False):
            jkw = dict(corruption=JCorruption("collude", byzantine_frac=0.25),
                       corrupt_masks=cm)
            tkw = dict(corruption=TCorruption("collude", byzantine_frac=0.25),
                       corrupt_masks=_t(cm))
        want = jrps.rps_exchange_global(jnp.asarray(x), key, 0.3, 4,
                                        masks=(rs, ag), **jkw)
        got = trps.rps_exchange_global(_t(x), None, 0.3, 4,
                                       masks=(_t(rs), _t(ag)), **tkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    late = {"rs": torch.zeros((4, 4), dtype=torch.bool),
            "ag": torch.zeros((4, 4), dtype=torch.bool)}
    plain = trps.rps_exchange_global(_t(x), None, 0.3, 4,
                                     masks=(_t(rs), _t(ag)))
    with_late = trps.rps_exchange_global(_t(x), None, 0.3, 4,
                                         masks=(_t(rs), _t(ag)), late=late)
    assert torch.equal(plain, with_late)
    with pytest.raises(ValueError, match="late"):
        trps.rps_exchange_global(_t(x), None, 0.3, 4,
                                 masks=(_t(rs), _t(ag)),
                                 late={"rs": late["rs"][None],
                                       "ag": late["ag"]})


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
    # the other families are ported (tests/test_torch_channels.py)
    assert make_channel("ge:p_bad=0.3,burst=8", 4).name == "ge"
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


# ---- the multi-leaf plans (the training path's layouts) --------------------

_TREE_SHAPES = {"p0": (6, 4), "p1": (17,), "p2": (3, 5), "p3": (8, 2),
                "p4": (9,)}


def _trees(shapes, dtypes=None):
    """The same per-worker tree as JAX shape structs and meta tensors."""
    dtypes = dtypes or {k: "float32" for k in shapes}
    j = {k: jax.ShapeDtypeStruct(v, jnp.dtype(dtypes[k]))
         for k, v in shapes.items()}
    t = {k: torch.empty(v, dtype=getattr(torch, dtypes[k]), device="meta")
         for k, v in shapes.items()}
    return j, t


def _bucket_fields(plan):
    return [dataclasses.asdict(b) for b in plan.buckets]


@pytest.mark.parametrize("n,s", [(2, 1), (4, 3), (8, 8), (4, 13)])
@pytest.mark.parametrize("knob", [None, ("n_buckets", 1), ("n_buckets", 2),
                                  ("n_buckets", 3), ("n_buckets", 99),
                                  ("bucket_bytes", 64),
                                  ("bucket_bytes", 200)])
def test_make_plan_equals_reference(n, s, knob):
    jt, tt = _trees(_TREE_SHAPES, {"p0": "float32", "p1": "bfloat16",
                                   "p2": "float32", "p3": "float32",
                                   "p4": "bfloat16"})
    kw = {} if knob is None else {knob[0]: knob[1]}
    jp = jplan.make_plan(jt, n, s, **kw)
    tp_ = tplan.make_plan(tt, n, s, **kw)
    assert tp_.describe() == jp.describe()
    assert tp_.describe("bf16") == jp.describe("bf16")
    assert _bucket_fields(tp_) == _bucket_fields(jp)


@pytest.mark.parametrize("s", [None, 2, 8])
def test_per_leaf_and_single_plans_equal_reference(s):
    jt, tt = _trees(_TREE_SHAPES)
    for jfn, tfn in ((jplan.per_leaf_plan, tplan.per_leaf_plan),
                     (jplan.single_bucket_plan, tplan.single_bucket_plan)):
        jp, tp_ = jfn(jt, 4, s), tfn(tt, 4, s)
        assert tp_.describe() == jp.describe()
        assert _bucket_fields(tp_) == _bucket_fields(jp)
    jp = jplan.plan_from_config(jt, 4, s, bucket_mb=1e-4, engine="ring")
    tp_ = tplan.plan_from_config(tt, 4, s, bucket_mb=1e-4, engine="ring")
    assert tp_.describe() == jp.describe()


@pytest.mark.parametrize("s", [1, 2, 5, 8])
@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("knob", [None, ("n_buckets", 2),
                                  ("bucket_bytes", 128)])
def test_multi_leaf_gather_scatter_equal_reference(s, lead, knob):
    """tests/test_plan.py's roundtrip layout (flat leaves of both dtypes;
    its model-dim leaf is flattened here, model dims are not ported):
    the gathered tables equal the reference's, and scatter inverts."""
    rng = np.random.default_rng(s + 10 * lead)
    shapes = {"a": (6, 4), "b": (17,), "tp": (3, 8), "c": (5,)}
    dtypes = {"a": "float32", "b": "float32", "tp": "float32",
              "c": "bfloat16"}
    tree = {k: rng.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}
    if lead:
        tree = {k: np.stack([v, 2 * v, -v]) for k, v in tree.items()}
    jt = {k: jnp.asarray(v, jnp.dtype(dtypes[k])) for k, v in tree.items()}
    tt = {k: torch.from_numpy(np.array(jt[k], np.float32)).to(
        getattr(torch, dtypes[k])) for k in tree}
    kw = {} if knob is None else {knob[0]: knob[1]}
    js, ts = _trees(shapes, dtypes)
    jp, tp_ = jplan.make_plan(js, 4, s, **kw), tplan.make_plan(ts, 4, s,
                                                                **kw)
    want = jp.gather(jt, lead=lead)
    got = tp_.gather(tt, lead=lead)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    back = tp_.scatter(got, lead=lead)
    for k in tt:
        assert back[k].dtype == tt[k].dtype
        torch.testing.assert_close(back[k], tt[k], rtol=0, atol=0)


def test_plan_leaf_order_is_jax_tree_order():
    """Nested dicts flatten with sorted keys, depth first, as
    jax.tree.flatten does: the leaf ids (and so the buckets) agree."""
    shapes = {"z": {"b": (3,), "a": (2, 2)}, "a": (5,), "m": {"q": (1,)}}

    def build(fn):
        return {k: ({kk: fn(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else fn(v))
                for k, v in shapes.items()}
    jt = build(lambda v: jax.ShapeDtypeStruct(v, jnp.float32))
    tt = build(lambda v: torch.empty(v, device="meta"))
    jp, tp_ = jplan.make_plan(jt, 2, n_buckets=2), tplan.make_plan(
        tt, 2, n_buckets=2)
    assert _bucket_fields(tp_) == _bucket_fields(jp)


def test_plan_not_ported_knobs_raise():
    """model_dims still raises; the async schedule is ported: its plan
    (readiness times, ship order, describe) equals the reference's."""
    jt, tt = _trees(_TREE_SHAPES)
    with pytest.raises(NotImplementedError, match="model_dims"):
        tplan.make_plan(tt, 4, model_dims={k: None for k in tt})
    tp_ = tplan.per_leaf_plan(tt, 4, schedule="async", compute_ms=8.0)
    jp = jplan.per_leaf_plan(jt, 4, schedule="async", compute_ms=8.0)
    assert tp_.ready_ms == jp.ready_ms and tp_.ship_order == jp.ship_order
    assert tp_.describe() == jp.describe()
    with pytest.raises(ValueError, match="not both"):
        tplan.make_plan(tt, 4, n_buckets=2, bucket_bytes=64)
    with pytest.raises(ValueError, match="n_buckets"):
        tplan.make_plan(tt, 4, n_buckets=0)


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("mode", ["model", "grad"])
@pytest.mark.parametrize("knob", [None, ("n_buckets", 3)])
def test_multi_leaf_exchange_xla_and_ring_equal_reference(engine, mode,
                                                          knob):
    """A bucketed or per-leaf exchange of a mixed-dtype tree, shared or
    per-bucket masks, bitwise on integer-valued stacks."""
    n, s = 4, 4
    rng = np.random.default_rng(len(mode) + (knob is None))
    dtypes = {"p0": "float32", "p1": "bfloat16", "p2": "float32",
              "p3": "float32", "p4": "float32"}
    jt, tt = _trees(_TREE_SHAPES, dtypes)
    kw = {} if knob is None else {knob[0]: knob[1]}
    jp = jplan.make_plan(jt, n, s, **kw) if knob else \
        jplan.per_leaf_plan(jt, n, s)
    tp_ = tplan.make_plan(tt, n, s, **kw) if knob else \
        tplan.per_leaf_plan(tt, n, s)
    nb = jp.n_buckets if jp.per_bucket_masks else None
    rs, ag = jrps.sample_masks(jax.random.PRNGKey(9), n, 0.3, s,
                               n_buckets=nb)
    x = {k: rng.integers(-6, 7, (n,) + v).astype(np.float32)
         for k, v in _TREE_SHAPES.items()}
    want = jrps.rps_exchange_global(
        {k: jnp.asarray(v, jnp.dtype(dtypes[k])) for k, v in x.items()},
        jax.random.PRNGKey(0), 0.3, n, mode=mode, masks=(rs, ag), plan=jp,
        engine=engine)
    got = trps.rps_exchange_global(
        {k: _t(v).to(getattr(torch, dtypes[k])) for k, v in x.items()},
        None, 0.3, n, mode=mode, masks=(_t(rs), _t(ag)), plan=tp_,
        engine=engine)
    for k in x:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
