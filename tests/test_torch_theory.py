"""The port's numpy copies of the theory and the W-matrix oracle against
the JAX package's: every public function of ``repro_torch.core.theory``
and ``repro_torch.core.wmatrix`` equals the reference's on a grid of n in
{2, 4, 16, 64}, p in {0, 0.05, 0.1, 0.3, 0.9} and s in {n/2, n, 2n}, with
plans of every ported wire and recovery and the channels of every family.
The scalar functions are the same numpy ops, so they match with ``==``;
the Monte-Carlo estimator and the round functions match bitwise from one
numpy seed. The port's exchange (model mode, f32, renorm) is then held to
the oracle: ``apply_w(V, build_w(...))`` within 1e-5 at square and
s != n layouts, and per-bucket masks to ``bucketed_round``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jchannels
from repro.core import plan as jplan
from repro.core import theory as jtheory
from repro.core import wire as jwire
from repro.core import wmatrix as jw
from repro_torch import channels as tchannels
from repro_torch import tree as tree_lib
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.core import theory as ttheory
from repro_torch.core import wire as twire
from repro_torch.core import wmatrix as tw

NS = (2, 4, 16, 64)
PS = (0.0, 0.05, 0.1, 0.3, 0.9)


def _servers(n):
    return sorted({max(n // 2, 1), n, 2 * n})


def _same(a, b):
    """Equal as the reference computes it: floats with ==, arrays bit
    for bit (NaN where the reference has NaN)."""
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        return
    assert type(a) is type(b), (type(a), type(b))
    assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def _public(mod):
    return sorted(k for k, v in vars(mod).items()
                  if callable(v) and not k.startswith("_")
                  and getattr(v, "__module__", None) == mod.__name__)


def test_public_functions_are_the_references():
    """Every public function of the reference's theory has a copy, the
    robust trio included; wmatrix is copied whole."""
    assert _public(ttheory) == _public(jtheory)
    assert _public(tw) == _public(jw)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("p", PS)
def test_scalar_bounds_equal_reference(n, p):
    for f in (ttheory.t1, ttheory.t2, ttheory.t3):
        if n == 1:
            continue
        _same(f(n, p), getattr(jtheory, f.__name__)(n, p))
    for s in [None] + _servers(n):
        for mp in (None, n, 3 * n):
            kw = dict(s=s, model_packets=mp)
            for name in ("alpha1_bound", "alpha2_bound", "beta"):
                _same(getattr(ttheory, name)(n, p, **kw),
                      getattr(jtheory, name)(n, p, **kw))
            if p < 0.9:
                for T in (10, 1000):
                    _same(ttheory.corollary2_lr(n, p, T, L=2.0, sigma=0.5,
                                                zeta=0.1, **kw),
                          jtheory.corollary2_lr(n, p, T, L=2.0, sigma=0.5,
                                                zeta=0.1, **kw))
                    for extra in (0.0, 1e-3):
                        _same(ttheory.corollary2_rate(
                            n, p, T, sigma=0.7, zeta=0.2, a2_extra=extra,
                            **kw),
                            jtheory.corollary2_rate(
                                n, p, T, sigma=0.7, zeta=0.2,
                                a2_extra=extra, **kw))
        for k in (1, 2, 5):
            if s is not None:
                _same(ttheory.packets_per_block(s, k * n),
                      jtheory.packets_per_block(s, k * n))
            _same(ttheory.block_drop_rate(p, k),
                  jtheory.block_drop_rate(p, k))
    _same(ttheory.effective_p(p), jtheory.effective_p(p))
    _same(ttheory.staleness_alpha2_extra(min(p + 0.1, 1.0), p, n),
          jtheory.staleness_alpha2_extra(min(p + 0.1, 1.0), p, n))
    _same(ttheory.alpha_bounds_channel(p, n),
          jtheory.alpha_bounds_channel(p, n))


def test_scalar_errors_equal_reference():
    for f in ("packets_per_block", "block_drop_rate", "effective_p"):
        args = {"packets_per_block": (0, 4), "block_drop_rate": (1.5, 2),
                "effective_p": (-0.1,)}[f]
        with pytest.raises(ValueError) as want:
            getattr(jtheory, f)(*args)
        with pytest.raises(ValueError) as got:
            getattr(ttheory, f)(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n is required"):
        ttheory.alpha_bounds_channel(0.1)


def _plans(n, s, wire, recovery, n_buckets):
    shapes = {"a": (24,), "b": (8, 2), "c": (5,)}
    tt = {k: torch.zeros(v) for k, v in shapes.items()}
    jt = {k: jnp.zeros(v) for k, v in shapes.items()}
    kw = dict(n_buckets=n_buckets, wire=wire, recovery=recovery)
    return tplan.make_plan(tt, n, s, **kw), jplan.make_plan(jt, n, s, **kw)


@pytest.mark.parametrize("wire", twire.WIRES)
@pytest.mark.parametrize("recovery", twire.RECOVERIES)
def test_plan_bounds_equal_reference(wire, recovery):
    """plan_packets, plan_wire_alpha2_extra, alpha_bounds_plan and
    corollary2_rate_plan on the port's and the reference's plans of every
    wire and recovery, shared and per-bucket masks, s below, at and above
    n: equal, and so are the wire constants they read."""
    for n in NS:
        for s in _servers(n):
            for nb in (None, 2, 3):
                tp, jp = _plans(n, s, wire, recovery, nb)
                assert tp.model_packets == jp.model_packets
                for p in PS:
                    if p == 0.9 and recovery == "scale":
                        continue
                    _same(ttheory.plan_packets(tp), jtheory.plan_packets(jp))
                    _same(ttheory.plan_wire_alpha2_extra(tp, n, p),
                          jtheory.plan_wire_alpha2_extra(jp, n, p))
                    _same(ttheory.alpha_bounds_plan(tp, n, p),
                          jtheory.alpha_bounds_plan(jp, n, p))
                    _same(ttheory.corollary2_rate_plan(tp, n, p, 100),
                          jtheory.corollary2_rate_plan(jp, n, p, 100))
    for n in NS:
        for p in PS:
            _same(twire.recovery_alpha2_extra(recovery, n, p),
                  jwire.recovery_alpha2_extra(recovery, n, p))


def test_robust_constants_equal_reference():
    """The robust kinds' efficiency constants and their α₂ term (once
    refused) equal the reference's."""
    assert twire.ROBUST_EFFICIENCY == jwire.ROBUST_EFFICIENCY
    for rec in ("median", "trimmed", "trimmed:beta=0.3", "clip"):
        for n in NS:
            for p in PS:
                _same(twire.recovery_alpha2_extra(rec, n, p),
                      jwire.recovery_alpha2_extra(rec, n, p))


CHANNELS = ("bernoulli:p=0.1", "ge:p_bad=1.0,burst=8,p=0.1",
            "ge:p_bad=0.5,burst=3,p_gb=0.1,p_good=0.05",
            "hetero:n_pods=2,p_cross=0.3", "pods:n_pods=4,p_intra=0.02",
            "deadline:deadline_ms=8,straggler_frac=0.2",
            "straggler:deadline_ms=3,base_ms=1,jitter_ms=4")


@pytest.mark.parametrize("spec", CHANNELS)
def test_channel_bounds_equal_reference(spec):
    """The *_channel helpers and the async sync-path helpers on the
    port's and the reference's channels of every family."""
    for n in (4, 16):
        for s in (None, n // 2, 2 * n):
            tc = tchannels.make_channel(spec, n, s=s)
            jc = jchannels.make_channel(spec, n, s=s)
            _same(ttheory.effective_p(tc), jtheory.effective_p(jc))
            _same(ttheory.alpha_bounds_channel(tc),
                  jtheory.alpha_bounds_channel(jc))
            for T in (10, 500):
                _same(ttheory.corollary2_lr_channel(tc, T),
                      jtheory.corollary2_lr_channel(jc, T))
                _same(ttheory.corollary2_rate_channel(tc, T, sigma=0.3),
                      jtheory.corollary2_rate_channel(jc, T, sigma=0.3))
            tp, jp = _plans(n, s, "int8", "ef", 2)
            _same(ttheory.async_bucket_drop_rates(tp, tc),
                  jtheory.async_bucket_drop_rates(jp, jc))
            _same(ttheory.async_alpha_bounds(tp, n, tc),
                  jtheory.async_alpha_bounds(jp, n, jc))


# ---- the W-matrix oracle --------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_wmatrix_draws_and_rounds_equal_reference(n):
    """sample_masks, build_w, rps_round (and its W stack), apply_w and
    bucketed_round from one numpy seed: bit for bit."""
    for s in _servers(n):
        for p in PS:
            for perm in (True, False):
                seed = 7 * n + s
                a = tw.sample_masks(np.random.default_rng(seed), n, p, perm,
                                    s=s)
                b = jw.sample_masks(np.random.default_rng(seed), n, p, perm,
                                    s=s)
                _same(a, b)
                _same(tw.build_w(n, *a), jw.build_w(n, *b))
            V = np.random.default_rng(n).normal(size=(n, 3 * s))
            xa, wa = tw.rps_round(V, np.random.default_rng(s), p,
                                  return_w=True, s=s)
            xb, wb = jw.rps_round(V, np.random.default_rng(s), p,
                                  return_w=True, s=s)
            _same(xa, xb)
            _same(wa, wb)
            _same(tw.apply_w(V, wa), jw.apply_w(V, wb))
    rng = np.random.default_rng(n)
    bufs = [rng.normal(size=(n, k * n)) for k in (1, 3)]
    rs = rng.random((2, n, n)) > 0.3
    ag = rng.random((2, n, n)) > 0.3
    for m in ((rs, ag), (rs[0], ag[0])):
        _same(tuple(tw.bucketed_round(bufs, *m)),
              tuple(jw.bucketed_round(bufs, *m)))


@pytest.mark.parametrize("n,p", [(2, 0.3), (4, 0.1), (16, 0.05),
                                 (16, 0.3), (4, 0.9), (4, 0.0)])
def test_monte_carlo_alphas_equal_reference(n, p):
    _same(tw.monte_carlo_alphas(n, p, trials=60, seed=n),
          jw.monte_carlo_alphas(n, p, trials=60, seed=n))


@pytest.mark.parametrize("kind", ["median", "trimmed", "clip"])
def test_robust_oracle_equals_reference(kind):
    """sample_corrupt_mask, np_robust_aggregate and robust_round: the
    oracle of the robust recoveries' port, bit for bit now."""
    for n, s in ((4, 4), (8, 4), (4, 8)):
        own = np.arange(s) % n
        a = tw.sample_corrupt_mask(np.random.default_rng(n), n, s, 0.2,
                                   0.25, owners=own)
        b = jw.sample_corrupt_mask(np.random.default_rng(n), n, s, 0.2,
                                   0.25, owners=own)
        _same(a, b)
        rows = np.random.default_rng(s).normal(size=(n, 6))
        _same(tw.np_robust_aggregate(rows, kind, beta=0.2),
              jw.np_robust_aggregate(rows, kind, beta=0.2))
        V = np.random.default_rng(s + 1).normal(size=(n, 2 * s))
        rs = np.random.default_rng(1).random((n, s)) > 0.2
        ag = np.random.default_rng(2).random((n, s)) > 0.2
        rs[own, np.arange(s)] = True
        ag[own, np.arange(s)] = True
        _same(tw.robust_round(V, own, rs, ag, a, lambda x: -10 * x, kind),
              jw.robust_round(V, own, rs, ag, b, lambda x: -10 * x, kind))
    with pytest.raises(ValueError, match="not a robust kind"):
        tw.np_robust_aggregate(rows, "mean")


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("n", [2, 4, 16])
def test_exchange_equals_w_matrix_oracle(engine, n):
    """rps_exchange_global (model mode, f32 wire, renorm) on a stacked
    (n, s·blk) buffer against apply_w(V, build_w(n, owners, rs, ag)) with
    the port's owners (block j to worker j % n): within 1e-5, at s below,
    at and above n, p in {0.05, 0.3, 0.9}."""
    for s in _servers(n):
        for p in (0.05, 0.3, 0.9):
            rng = np.random.default_rng(n * 100 + s)
            V = rng.normal(size=(n, 5 * s)).astype(np.float32)
            gen = torch.Generator().manual_seed(s)
            rs, ag = trps.sample_masks(gen, n, p, s)
            out = trps.rps_exchange_global(
                torch.from_numpy(V), None, p, n, masks=(rs, ag), s=s,
                engine=engine)
            W = tw.build_w(n, np.arange(s) % n, rs.numpy(), ag.numpy())
            want = tw.apply_w(V.astype(np.float64), W)
            np.testing.assert_allclose(out.numpy(), want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("n,s", [(4, 4), (4, 2), (4, 8), (8, 8)])
def test_bucketed_exchange_equals_bucketed_round(engine, n, s):
    """A two-bucket plan with per-bucket masks: each bucket's flat table
    after the exchange equals bucketed_round's transform of it, with its
    own mask pair, within 1e-5."""
    rng = np.random.default_rng(n + s)
    tree = {"a": torch.from_numpy(rng.normal(size=(n, 24)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(n, 8, 2))
                                            .astype(np.float32)),
        "c": torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))}
    plan = tplan.make_plan(tree_lib.map(lambda x: x[0], tree), n, s,
                           n_buckets=2)
    gen = torch.Generator().manual_seed(3)
    rs, ag = trps.sample_masks(gen, n, 0.3, s, n_buckets=plan.n_buckets)
    out = trps.rps_exchange_global(tree, None, 0.3, n, masks=(rs, ag),
                                   plan=plan, engine=engine)
    before = [t.reshape(n, -1).numpy() for t in plan.gather(tree, lead=1)]
    after = [t.reshape(n, -1).numpy() for t in plan.gather(out, lead=1)]
    want = tw.bucketed_round(before, rs.numpy(), ag.numpy())
    assert len(want) == plan.n_buckets == 2
    for got, w in zip(after, want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
