"""The Byzantine axis of the port against the JAX package's, on the same
numpy-seeded inputs: the masked robust estimators, the recovery grammar
and breakdown points, the theory's robust rates, the corruption
processes (masks from the reference's uniforms, the bitflip transform on
the reference's bit positions), the registry, ``rps_exchange_global``
with corruption on both engines and every wire and with the robust
recoveries, its gate errors, and the simulator on
``benchmarks/robust_bench.py``'s task with the reference's draws
injected.

Median is bitwise; the trimmed and clip means sum in another order than
XLA's reduction, so they hold 1e-6 of the data's largest magnitude. The
exchange is bitwise on integer-valued stacks against the reference run op
by op (``jax.disable_jit()``; its masked-average kernel in interpret
mode, the route the port's kernel follows), except where it sums
non-integers: under ``bitflip`` on the xla engine, and the trimmed and
clip aggregates, hold 1e-6 of the output's largest finite magnitude, NaN
and ±inf equal to themselves. XLA:CPU flushes subnormal results to zero
and PyTorch does not (nor does the card), so where a bitflip makes
subnormals both sides are compared with those flushed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as J
from repro.channels import corruption as jcorr
from repro.core import plan as jplan
from repro.core import robust as jrobust
from repro.core import rps as jrps
from repro.core import theory as jtheory
from repro.core import wire as jwire
from repro.train import simulator as jsim
from repro_torch import channels as T
from repro_torch.channels import corruption as tcorr
from repro_torch.core import plan as tplan
from repro_torch.core import robust as trobust
from repro_torch.core import rps as trps
from repro_torch.core import theory as ttheory
from repro_torch.core import wire as twire
from repro_torch.kernels import ops
from repro_torch.train import simulator as tsim
from _torch_sim import (CORRUPT_TAG, WIRE_TAG, np_tree, reference_bits,
                        reference_draws, reference_noise, t_, to_torch)

N = 8
MASK_TAG = 0x63727074          # the reference's corruption-mask tag
KINDS = ("bitflip", "scale", "signflip", "collude")


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _sites(n: int, d: int, seed: int):
    """x (n, n, d) and masks (n, n): site c−1 delivers exactly c rows
    (c = 1..n), chosen at random; continuous data."""
    rng = np.random.default_rng(seed + n)
    x = rng.normal(size=(n, n, d)).astype(np.float32)
    mask = np.zeros((n, n), bool)
    for c in range(1, n + 1):
        mask[c - 1, rng.permutation(n)[:c]] = True
    return x, mask


# ---- the estimators -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("kind", ["median", "trimmed", "clip"])
def test_estimators_equal_reference_at_every_count(n, kind):
    """Every delivered count 1..n at n workers: median bitwise, trimmed
    (β 0.1 and 0.4) and clip (clip_mult 2 and 0.5) within 1e-6; the
    chunked aggregate (a column at a time) as the whole."""
    x, mask = _sites(n, 37, seed=1)
    x[0, :, :3] = 0.0                       # ties, and zero-norm rows
    args = {"median": [{}], "trimmed": [{"beta": 0.1}, {"beta": 0.4}],
            "clip": [{"clip_mult": 2.0}, {"clip_mult": 0.5}]}[kind]
    for kw in args:
        jfn = {"median": jrobust.masked_median,
               "trimmed": jrobust.masked_trimmed_mean,
               "clip": jrobust.masked_clip_mean}[kind]
        tfn = {"median": trobust.masked_median,
               "trimmed": trobust.masked_trimmed_mean,
               "clip": trobust.masked_clip_mean}[kind]
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(mask), **kw))
        got = tfn(torch.from_numpy(x), torch.from_numpy(mask), **kw).numpy()
        rec = twire.Recovery(kind, **kw)
        whole = trobust.robust_aggregate(torch.from_numpy(x),
                                         torch.from_numpy(mask), rec)
        chunked = trobust.robust_aggregate(torch.from_numpy(x),
                                           torch.from_numpy(mask), rec,
                                           max_elems=n * n)
        if kind == "median":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(chunked.numpy(), want)
        else:
            tol = 1e-6 * np.abs(x).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                                       rtol=0, atol=tol)
        np.testing.assert_array_equal(whole.numpy(), got)


def test_estimators_bf16_and_errors_equal_reference():
    """A bf16 input comes back bf16 (computed in f32); bad β and clip
    multiples raise the reference's errors."""
    x, mask = _sites(8, 16, seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = t_(np.asarray(xb, np.float32)).to(torch.bfloat16)
    for jfn, tfn in ((jrobust.masked_median, trobust.masked_median),
                     (jrobust.masked_trimmed_mean,
                      trobust.masked_trimmed_mean)):
        got = tfn(tb, torch.from_numpy(mask))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np32(got),
                                      _np32(jfn(xb, jnp.asarray(mask))))
    for fn, kw in (("masked_trimmed_mean", {"beta": 0.5}),
                   ("masked_clip_mean", {"clip_mult": 0.0})):
        with pytest.raises(ValueError) as want:
            getattr(jrobust, fn)(jnp.asarray(x), jnp.asarray(mask), **kw)
        with pytest.raises(ValueError) as got:
            getattr(trobust, fn)(torch.from_numpy(x),
                                 torch.from_numpy(mask), **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not a robust"):
        trobust.robust_aggregate(torch.from_numpy(x),
                                 torch.from_numpy(mask), "renorm")


def test_median_resists_half_minus_one_outliers():
    """At n = 16 with 7 rows at 1e30 the median stays in the honest
    range (the breakdown point 1/2)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 9)).astype(np.float32)
    x[:7] = 1e30
    mask = np.ones(16, bool)
    got = trobust.masked_median(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.abs(got.numpy()).max() < 10
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrobust.masked_median(jnp.asarray(x),
                                                      jnp.asarray(mask))))


# ---- the recovery grammar, breakdown points, theory ---------------------------

SPECS = ("median", "trimmed", "clip", "renorm", "scale", "ef",
         "trimmed:beta=0.4", "trimmed:beta=0", "clip:clip_mult=3",
         "median:p=0.2", "scale:p=0.25", "trimmed:beta=0.25,clip_mult=4,")


@pytest.mark.parametrize("spec", SPECS)
def test_recovery_spec_grammar_equals_reference(spec):
    t, j = twire.make_recovery(spec, p=0.1), jwire.make_recovery(spec, p=0.1)
    assert (t.kind, t.p, t.beta, t.clip_mult) == \
        (j.kind, j.p, j.beta, j.clip_mult)
    assert t.spec == j.spec and t.needs_table == j.needs_table
    assert t.breakdown_point() == j.breakdown_point()
    assert twire.make_recovery(t.spec).spec == t.spec
    assert ttheory.robust_breakdown_point(spec) == \
        jtheory.robust_breakdown_point(spec)
    for n in (2, 8, 16):
        assert twire.recovery_alpha2_extra(spec, n, 0.2) == \
            jwire.recovery_alpha2_extra(spec, n, 0.2)


@pytest.mark.parametrize("spec", ["median:beta", "median:foo=1",
                                  "trimmed:beta=0.5", "clip:clip_mult=0",
                                  "mean", "trimmed:beta=-0.1"])
def test_recovery_spec_errors_equal_reference(spec):
    with pytest.raises(ValueError) as want:
        jwire.make_recovery(spec)
    with pytest.raises(ValueError) as got:
        twire.make_recovery(spec)
    assert str(got.value) == str(want.value)


def test_plan_keeps_parameterised_robust_specs():
    tree_t = {"a": torch.empty((40,), device="meta")}
    tree_j = {"a": jax.ShapeDtypeStruct((40,), jnp.float32)}
    for rec in ("trimmed:beta=0.3", "clip:clip_mult=3", "median"):
        tp = tplan.make_plan(tree_t, 4, n_buckets=1, recovery=rec)
        jp = jplan.make_plan(tree_j, 4, n_buckets=1, recovery=rec)
        assert tp.recovery == jp.recovery and tp.describe() == jp.describe()


def test_theory_robust_rates_equal_reference():
    recs = ("renorm", "median", "trimmed", "trimmed:beta=0.4", "clip",
            "scale")
    for n in (2, 8, 16, 64):
        for T_ in (10, 200):
            for b in (0.0, 0.125, 0.25, 0.45):
                assert ttheory.byzantine_rate(n, T_, b) == \
                    jtheory.byzantine_rate(n, T_, b)
                for p in (0.0, 0.2):
                    for rec in recs:
                        assert ttheory.robust_rate(
                            n, p, T_, byz_frac=b, recovery=rec) == \
                            jtheory.robust_rate(n, p, T_, byz_frac=b,
                                                recovery=rec)
    with pytest.raises(ValueError):
        ttheory.byzantine_rate(8, 10, 1.0)


# ---- the corruption processes -------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("frac,byz", [(0.0, 0.25), (0.3, 0.0), (0.2, 0.4),
                                      (1.0, 0.0)])
@pytest.mark.parametrize("n,s,nb", [(8, 8, None), (4, 6, 3), (3, 2, None),
                                    (16, 16, 2)])
def test_corruption_masks_equal_reference(kind, frac, byz, n, s, nb):
    """from_draws on the reference's uniforms (bernoulli of the tag-folded
    key) gives the reference's mask: owners never, colluders always."""
    jc = jcorr.Corruption(kind, frac=frac, byzantine_frac=byz)
    tc = tcorr.Corruption(kind, frac=frac, byzantine_frac=byz)
    key = jax.random.PRNGKey(n * 10 + s)
    want = np.asarray(jc.sample(key, n, s, n_buckets=nb))
    shape = (n, s) if nb is None else (nb, n, s)
    u = t_(jax.random.uniform(jax.random.fold_in(key, MASK_TAG), shape)) \
        if frac > 0 else None
    got = tc.from_draws(u, n, s, nb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tc.n_colluders(n) == jc.n_colluders(n)
    assert tc.expected_frac(n) == jc.expected_frac(n)
    assert tc.spec == jc.spec
    gen = torch.Generator().manual_seed(0)
    own = tc.sample(gen, n, s, nb)
    assert own.shape == shape and not (own & trps.owner_mask(n, s)).any()
    f = tc.n_colluders(n)
    colluding = own[..., :f, :] | trps.owner_mask(n, s)[:f]
    assert bool(colluding.all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corruption_apply_equals_reference(kind, dtype):
    """The sender transform on continuous values, with large and tiny
    magnitudes and zeros; bitflip on the reference's bits (clamped to
    ±FLT_MAX where the flip gives inf or NaN): bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 6, 40)).astype(np.float32)
    x[0, 0, 0, :4] = [0.0, -0.0, 3e38, -1e-40]
    x[1, 1, 1, :] = 2.0 ** 127
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = t_(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    cm = rng.random(size=(3, 5, 6, 1)) < 0.5
    jc, tc = jcorr.Corruption(kind, gamma=7.5), tcorr.Corruption(kind,
                                                                 gamma=7.5)
    key = jax.random.PRNGKey(9)
    want = jc.apply(jx, jnp.asarray(cm), key)
    bits = t_(np.array(jax.random.randint(key, x.shape, 0, 32, jnp.uint32)
                       ).astype(np.int32))
    got = tc.apply(tx, torch.from_numpy(cm), bits=bits)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(
        _np32(got).view(np.int32), _np32(want).view(np.int32))
    if kind == "bitflip" and dtype == "float32":
        assert np.isfinite(_np32(got)).all()    # FLT_MAX is inf in bf16


def test_corruption_channel_delegates_and_wrap():
    inner = T.make_channel("deadline:deadline_ms=8,straggler_frac=0.2", 4)
    c = tcorr.Corruption("signflip", frac=0.1)
    ch = tcorr.wrap(inner, c)
    assert isinstance(ch, T.CorruptionChannel) and ch.corruption is c
    assert ch.effective_p() == inner.effective_p()
    assert ch.deadline_ms == inner.deadline_ms          # forwarded
    assert (ch.expected_link_p() == inner.expected_link_p()).all()
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = ch.sample_async(g1, None, np.array([5.0, 2.0]))
    b = inner.sample_async(g2, None, np.array([5.0, 2.0]))
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
    assert tcorr.wrap(inner, None) is inner
    assert tcorr.wrap(inner, tcorr.Corruption("scale")) is inner
    assert repr(ch) == ("CorruptionChannel(" + repr(inner)
                        + ", 'signflip:frac=0.1')")
    with pytest.raises(ValueError, match="want one of"):
        tcorr.Corruption("nope")


@pytest.mark.parametrize("spec,byz", [
    ("collude:gamma=10", None), ("signflip:frac=0.1", None),
    ("bitflip:frac=0.05,byzantine_frac=0.25", None), ("scale:gamma=-3", 0.5),
    (None, 0.25), ("", 0.0), (None, None), ("collude", 0.125)])
def test_make_corruption_equals_reference(spec, byz):
    t, j = T.make_corruption(spec, byz), J.make_corruption(spec, byz)
    assert (t is None) == (j is None)
    if t is not None:
        assert (t.kind, t.frac, t.byzantine_frac, t.gamma, t.spec) == \
            (j.kind, j.frac, j.byzantine_frac, j.gamma, j.spec)
        tb = T.make_corruption(t, 0.125)
        jb = J.make_corruption(j, 0.125)
        assert tb.spec == jb.spec
    tch = T.make_channel("ge", 8, corruption=spec)
    jch = J.make_channel("ge", 8, corruption=spec)
    assert type(tch).__name__ == type(jch).__name__


@pytest.mark.parametrize("spec", ["nope", "collude:gamma", "collude:foo=1",
                                  "signflip:frac=2", "scale:byzantine_frac=1"])
def test_make_corruption_errors_equal_reference(spec):
    with pytest.raises(ValueError) as want:
        J.make_corruption(spec)
    with pytest.raises(ValueError) as got:
        T.make_corruption(spec)
    assert str(got.value) == str(want.value)


# ---- the exchange -------------------------------------------------------------

def _int_tree(rng):
    """Integer-valued leaves stacked for n = 8: two f32 and one bf16."""
    return {"a": rng.integers(-6, 7, size=(N, 6, 4)).astype(np.float32),
            "b": rng.integers(-6, 7, size=(N, 33)).astype(np.float32),
            "c": jnp.asarray(rng.integers(-6, 7, size=(N, 5, 5)),
                             jnp.bfloat16)}


def _plans(kind, wire, recovery):
    shapes = {"a": ((6, 4), "float32"), "b": ((33,), "float32"),
              "c": ((5, 5), "bfloat16")}
    jt = {k: jax.ShapeDtypeStruct(v[0], jnp.dtype(v[1]))
          for k, v in shapes.items()}
    tt = {k: torch.empty(v[0], dtype=getattr(torch, v[1]), device="meta")
          for k, v in shapes.items()}
    kw = dict(wire=wire, recovery=recovery)
    if kind == "per_leaf":
        return jplan.per_leaf_plan(jt, N, **kw), \
            tplan.per_leaf_plan(tt, N, **kw)
    return jplan.make_plan(jt, N, n_buckets=2, **kw), \
        tplan.make_plan(tt, N, n_buckets=2, **kw)


def _hooks(key):
    def noise(g_idx, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, WIRE_TAG), g_idx)
        return t_(jax.random.uniform(k, shape))

    def bits(g_idx, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, CORRUPT_TAG), g_idx)
        return t_(np.array(jax.random.randint(k, shape, 0, 32, jnp.uint32)
                           ).astype(np.int32))
    return noise, bits


def _exchange(plan_kind, wire, engine, mode="model", recovery="renorm",
              corruption=None, seed=0, tree=None, masks=None):
    rng = np.random.default_rng(seed)
    tree = _int_tree(rng) if tree is None else tree
    jp, tp = _plans(plan_kind, wire, recovery)
    assert tp.describe() == jp.describe()
    nb = jp.n_buckets if jp.per_bucket_masks else None
    key = jax.random.PRNGKey(seed + 50)
    if masks is None:
        rs, ag = jrps.sample_masks(key, N, 0.3, N, n_buckets=nb)
    else:
        rs, ag = masks
    jc = tc = cm = None
    if corruption is not None:
        jc = J.make_corruption(corruption)
        tc = T.make_corruption(corruption)
        cm = jc.sample(jax.random.fold_in(key, 1), N, N, n_buckets=nb)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    with jax.disable_jit():
        # the reference's masked-average kernel (interpret mode), the
        # route the port's kernel follows: its average comes back in the
        # wire dtype
        want = jrps.rps_exchange_global(
            jtree, key, 0.3, N, mode=mode, masks=(rs, ag), plan=jp,
            engine=engine, corruption=jc, corrupt_masks=cm,
            backend="pallas")
    noise, bits = _hooks(key)
    got = trps.rps_exchange_global(
        {k: t_(np.asarray(v, np.float32)).to(
            getattr(torch, jnp.dtype(jtree[k].dtype).name))
         for k, v in tree.items()},
        None, 0.3, N, mode=mode, masks=(t_(rs), t_(ag)), plan=tp,
        engine=engine, corruption=tc,
        corrupt_masks=None if cm is None else t_(cm), wire_noise=noise,
        corrupt_bits=bits)
    return got, want


def _ftz(a: np.ndarray) -> np.ndarray:
    """Subnormals flushed to (signed) zero, as XLA:CPU computes them."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny,
                    np.copysign(np.float32(0.0), a), a)


def _assert_same(got, want, close=False, ftz=False):
    for k in want:
        assert got[k].dtype == getattr(torch, jnp.dtype(want[k].dtype).name)
        g, w = _np32(got[k]), _np32(want[k])
        if ftz:
            g, w = _ftz(g), _ftz(w)
        if not close:
            np.testing.assert_array_equal(g, w)
            continue
        both = np.isfinite(g) & np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_array_equal(g[~both], w[~both])
        scale = np.abs(w[both]).max(initial=0.0)
        np.testing.assert_allclose(g[both], w[both], rtol=0,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("plan_kind", ["per_leaf", "bucketed2"])
def test_corrupted_exchange_equals_reference(kind, wire, engine, plan_kind):
    """Every kind (frac 0.2, a quarter of the workers colluding) on every
    wire and both engines (the ring's plain version), shared and
    per-bucket masks, renorm, model mode."""
    got, want = _exchange(plan_kind, wire, engine,
                          corruption=f"{kind}:frac=0.2,byzantine_frac=0.25",
                          seed=KINDS.index(kind))
    _assert_same(got, want, close=kind == "bitflip" and engine == "xla",
                 ftz=kind == "bitflip")


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("mode", ["grad", "grad_renorm"])
def test_corrupted_exchange_grad_modes_equal_reference(engine, mode):
    got, want = _exchange("bucketed2", "f32", engine, mode=mode,
                          corruption="collude:byzantine_frac=0.25", seed=7)
    _assert_same(got, want)


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_dropped_broadcast_keeps_the_honest_block(engine, wire):
    """Worker 0 colludes (signflip) and its AG leg drops every block: its
    output is its own honest copy, not the flipped offer; the others
    receive averages the flipped offer entered. Handing the ring round
    the corrupted offer as its stack (no encoded variant) would make the
    fallback the flipped copy."""
    rng = np.random.default_rng(11)
    tree = {"a": rng.integers(1, 7, size=(N, 64)).astype(np.float32)}
    jt = {"a": jax.ShapeDtypeStruct((64,), jnp.float32)}
    tt = {"a": torch.empty((64,), device="meta")}
    jp = jplan.per_leaf_plan(jt, N, wire=wire)
    tp = tplan.per_leaf_plan(tt, N, wire=wire)
    rs = np.ones((N, N), bool)
    ag = np.ones((N, N), bool)
    ag[0] = False
    ag[0, 0] = True                                 # the owner entry
    jc = J.make_corruption("signflip:byzantine_frac=0.125")
    tc = T.make_corruption("signflip:byzantine_frac=0.125")
    key = jax.random.PRNGKey(0)
    cm = jc.sample(key, N, N)
    with jax.disable_jit():
        want = jrps.rps_exchange_global(
            {"a": jnp.asarray(tree["a"])}, key, 0.0, N, masks=(rs, ag),
            plan=jp, engine=engine, corruption=jc, corrupt_masks=cm)
    noise, _ = _hooks(key)
    x = torch.from_numpy(tree["a"])
    got = trps.rps_exchange_global(
        {"a": x}, None, 0.0, N, masks=(t_(rs), t_(ag)), plan=tp,
        engine=engine, corruption=tc, corrupt_masks=t_(cm),
        wire_noise=noise)["a"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["a"]))
    blk = 64 // N
    assert torch.equal(got[0, blk:], x[0, blk:])        # honest, kept
    assert (got[0, blk:] > 0).all()
    assert not torch.equal(got[1], x[1])                # averaged
    if engine == "ring" and wire == "f32":
        offer = tc.apply(x.reshape(1, N, N, blk), t_(cm)[None, ..., None])
        rs_t, ag_t = t_(rs)[None], t_(ag)[None]
        div = rs_t.float().sum(-2)
        wrong = ops.ring_round(offer, rs_t, ag_t, div, mode="model")
        assert (wrong[0, 0, 1:] < 0).all()              # the flipped copy
        right = ops.ring_round(x.reshape(1, N, N, blk), rs_t, ag_t, div,
                               mode="model", enc=offer)
        assert torch.equal(right.reshape(N, 64), got)


@pytest.mark.parametrize("recovery", ["median", "trimmed:beta=0.3", "clip",
                                      "clip:clip_mult=0.5"])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["model", "grad_renorm"])
@pytest.mark.parametrize("attack", [None, "collude:byzantine_frac=0.25",
                                    "bitflip:frac=0.3"])
def test_robust_exchange_equals_reference(recovery, wire, mode, attack):
    """The robust global path (the (G, s, n, d) table of the send over the
    RS masks, xla engine), with and without an attack: median bitwise,
    trimmed and clip within 1e-6."""
    got, want = _exchange("bucketed2", wire, "xla", mode=mode,
                          recovery=recovery, corruption=attack, seed=3)
    _assert_same(got, want, close=not recovery.startswith("median"),
                 ftz=attack is not None and attack.startswith("bitflip"))


def test_robust_exchange_on_continuous_data_and_auto_engine():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(N, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(N, 33)).astype(np.float32),
            "c": jnp.asarray(rng.normal(size=(N, 5, 5)), jnp.bfloat16)}
    got, want = _exchange("per_leaf", "f32", "auto", recovery="median",
                          tree=tree, corruption="collude:byzantine_frac=0.25")
    _assert_same(got, want)


def test_exchange_gate_errors_equal_reference():
    """grad mode or the ring engine with a robust recovery, ef with
    corruption, corrupt masks without a process, per-bucket corrupt masks
    of the wrong count: the reference's errors."""
    x = np.ones((4, 8), np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(0)
    rs, ag = jrps.sample_masks(key, 4, 0.2)
    ef = np.zeros_like(x)
    cases = [
        (dict(recovery="median", mode="grad"), {}),
        (dict(recovery="trimmed", engine="ring"), {}),
        (dict(recovery="ef"), dict(ef=True, corruption="signflip:frac=0.5")),
        ({}, dict(cm=np.zeros((4, 4), bool))),
    ]
    for kw, extra in cases:
        jkw, tkw = dict(kw), dict(kw)
        if extra.get("ef"):
            jkw["ef_state"], tkw["ef_state"] = jnp.asarray(ef), \
                torch.from_numpy(ef)
        if "corruption" in extra:
            jkw["corruption"] = J.make_corruption(extra["corruption"])
            tkw["corruption"] = T.make_corruption(extra["corruption"])
        if "cm" in extra:
            jkw["corrupt_masks"] = jnp.asarray(extra["cm"])
            tkw["corrupt_masks"] = torch.from_numpy(extra["cm"])
        with pytest.raises(ValueError) as want:
            jrps.rps_exchange_global(jx, key, 0.2, 4, masks=(rs, ag), **jkw)
        with pytest.raises(ValueError) as got:
            trps.rps_exchange_global(tx, None, 0.2, 4,
                                     masks=(t_(rs), t_(ag)), **tkw)
        assert str(got.value) == str(want.value)
    tree = {"a": torch.zeros((4, 8)), "b": torch.zeros((4, 3))}
    plan = tplan.make_plan({k: v[0] for k, v in tree.items()}, 4,
                           n_buckets=2)
    with pytest.raises(ValueError, match="buckets"):
        trps.rps_exchange_global(
            tree, None, 0.0, 4, plan=plan,
            masks=(torch.ones((2, 4, 4), dtype=torch.bool),) * 2,
            corruption=T.make_corruption("signflip:frac=0.1"),
            corrupt_masks=torch.zeros((3, 4, 4), dtype=torch.bool))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ["xla", "ring"])
def test_corruption_off_is_bit_identical(kind, engine):
    """A process that corrupts nothing (an all-False mask) leaves the
    exchange bit for bit as without one, on continuous data."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(N, 40)).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    masks = trps.sample_masks(gen, N, 0.3)
    plain = trps.rps_exchange_global(x, None, 0.3, N, masks=masks,
                                     engine=engine)
    off = trps.rps_exchange_global(
        x, gen, 0.3, N, masks=masks, engine=engine,
        corruption=tcorr.Corruption(kind),
        corrupt_masks=torch.zeros((N, N), dtype=torch.bool))
    assert torch.equal(plain, off)
    assert isinstance(T.make_channel(None, N, 0.3,
                                     corruption=tcorr.Corruption(kind)),
                      T.BernoulliChannel)


# ---- the simulator on robust_bench.py's task -------------------------------

def _bench_task(n):
    """benchmarks/robust_bench.py's task: per-worker linear regressions,
    ys computed by the reference and shared."""
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(n, 16, 6)), jnp.float32)
    w_true = jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)
    ys = xs @ w_true

    def init_fn(key):
        return {"w": jax.random.normal(key, (6, 4)) * 0.1}

    def jloss(p, b):
        x, y = b
        return jnp.mean((x @ p["w"] - y) ** 2)

    def tloss(p, b):
        x, y = b
        return torch.mean((x @ p["w"] - y) ** 2)

    tx, ty = t_(xs), t_(ys)
    return jloss, init_fn, (lambda t: (xs, ys)), tloss, (lambda t: (tx, ty))


@pytest.mark.parametrize("recovery", ["renorm", "median", "trimmed:beta=0.4",
                                      "clip"])
@pytest.mark.parametrize("p,byz", [(0.2, 0.25), (0.0, 0.25), (0.2, 0.0)])
def test_simulator_on_robust_bench_task_equals_reference(recovery, p, byz):
    """robust_bench.py's recipe (n = 8, lr 0.2, warm-up 5, 2 buckets,
    collude:gamma=10) for 6 steps, the reference's init, masks and
    corruption masks injected: per-step loss, consensus and corrupt_frac
    within 1e-4."""
    jloss, jinit, jbatch, tloss, tbatch = _bench_task(N)
    kw = dict(n_workers=N, drop_rate=p, aggregator="rps_model", steps=6,
              lr=0.2, warmup=5, n_buckets=2, seed=0, eval_every=1,
              recovery=recovery, corruption="collude:gamma=10" if byz
              else None, byzantine_frac=byz)
    jscfg = jsim.SimulatorConfig(**kw)
    jh = jsim.run_simulation(jloss, jinit, jbatch, jscfg)
    p1, masks, cmasks = reference_draws(jinit, jscfg)
    th = tsim.run_simulation(
        tloss, None, tbatch, tsim.SimulatorConfig(**kw), device="cpu",
        init_params=to_torch(np_tree(p1)), masks_fn=lambda t: masks[t],
        corrupt_masks_fn=None if cmasks is None else (lambda t: cmasks[t]),
        wire_noise_fn=reference_noise(jscfg),
        corrupt_bits_fn=reference_bits(jscfg))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_allclose(th["consensus"], jh["consensus"], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(th["corrupt_frac"], jh["corrupt_frac"],
                               rtol=1e-4)
    assert th["channel"] == jh["channel"]
    if byz:
        assert len(th["corrupt_frac"]) == 6
        assert abs(np.mean(th["corrupt_frac"]) - 0.25) < 0.1
    else:
        assert th["corrupt_frac"] == []


def test_simulator_ef_with_corruption_raises_and_own_draws_run():
    jloss, jinit, jbatch, tloss, tbatch = _bench_task(4)
    with pytest.raises(ValueError, match="corruption with recovery='ef'"):
        tsim.run_simulation(tloss, None, tbatch, tsim.SimulatorConfig(
            n_workers=4, steps=1, recovery="ef", byzantine_frac=0.25),
            device="cpu", init_params={"w": torch.zeros((6, 4))})
    runs = [tsim.run_simulation(
        tloss, None, tbatch, tsim.SimulatorConfig(
            n_workers=4, steps=3, eval_every=1, drop_rate=0.2,
            recovery="median", corruption="bitflip:frac=0.3"),
        device="cpu", init_params={"w": torch.full((6, 4), 0.1)})
        for _ in range(2)]
    assert runs[0]["loss"] == runs[1]["loss"]
    assert len(runs[0]["corrupt_frac"]) == 3
    assert 0.0 < np.mean(runs[0]["corrupt_frac"]) < 0.7


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 64, 4097, 65536, 3145729])
def test_int8_ring_kernel_non_finite_rows_on_card(d):
    """The re-encoding kernel on rows a corrupted offer makes non-finite
    (±FLT_MAX contributions summing to ±inf, an inf beside a NaN in one
    row, NaN rows), every cluster size and the wide path: the plain
    version's values, NaN equal to NaN (a NaN max makes the step
    1/levels, a NaN quotient encodes as 0, an inf one clips)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    n, s = 8, 8
    x = torch.randint(-8, 9, (2, n, s, d), generator=gen,
                      device="cuda").float()
    x[0, 1, :, : (d + 1) // 2] = torch.finfo(torch.float32).max  # overflows
    x[0, 2, :, 0] = float("inf")
    x[1, 3, :, -1] = float("nan")
    x[1, 4, :, 0] = float("inf")                     # inf beside a NaN
    codec = twire.make_codec("int8")
    q, sc = codec.encode(x, lead=2, gen=gen)
    own = trps.owner_mask(n, s, device="cuda")
    rs = (torch.rand((2, n, s), generator=gen, device="cuda") < 0.8) | own
    ag = (torch.rand((2, n, s), generator=gen, device="cuda") < 0.8) | own
    div = rs.float().sum(1)
    got = ops.ring_round(x, rs, ag, div, mode="model", enc=q,
                         scale=sc[..., 0], levels=127)
    want = ops.ring_round(x, rs, ag, div, mode="model", enc=q,
                          scale=sc[..., 0], levels=127, backend="ref")
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    assert bool(same.all()), int((~same).sum())
