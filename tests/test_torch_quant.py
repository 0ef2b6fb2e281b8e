"""The port's quantisation core and int8 wire codec against the JAX
package's, on the same numpy-seeded inputs and, for stochastic rounding,
the reference's own uniforms (``jax.random.uniform`` of the key it would
use), handed to the port as an input.

Bitwise against the reference run op by op (``jax.disable_jit()``). The
jitted reference computes the scale ``amax / 127`` as ``amax * (1/127)``
(XLA:CPU), which differs from the IEEE quotient in the last bit on some
rows: against it the payload is equal and the scales and decoded values
agree within rel 1e-5 (one f32 ulp is 1.2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import quant as jquant
from repro.core import wire as jwire
from repro_torch.core import plan as tplan
from repro_torch.core import quant as tquant
from repro_torch.core import wire as twire

JIT_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _x(shape, seed=0, zero_row=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_row:
        x.reshape(-1, shape[-1])[0] = 0.0     # an all-zero block
    return x


@pytest.mark.parametrize("lead", [2, 1, 0, -1])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_equals_reference(lead, stochastic):
    x = _x((2, 4, 3, 37), seed=lead + 5)
    key = jax.random.PRNGKey(lead + 11) if stochastic else None
    u = _t(jax.random.uniform(key, x.shape)) if stochastic else None
    with jax.disable_jit():
        jq, js = jquant.quantize(jnp.asarray(x), 127, jnp.int8, key, lead)
    tq, ts = tquant.quantize(_t(x), 127, torch.int8, uniforms=u, lead=lead)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jquant.dequantize(jq, js)
    np.testing.assert_array_equal(tquant.dequantize(tq, ts).numpy(),
                                  np.asarray(jd))
    # the jitted reference: the same payload, scales within rel 1e-5
    jjq, jjs = jax.jit(lambda a: jquant.quantize(a, 127, jnp.int8, key,
                                                 lead))(x)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jjq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jjs), rtol=JIT_RTOL,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_and_block_delta_equal_reference(dtype):
    x = _x((3, 5, 64), seed=2)
    key = jax.random.PRNGKey(3)
    u = _t(jax.random.uniform(key, x.shape))
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    with jax.disable_jit():
        want = jquant.fake_quant(jx, 127, jnp.int8, key, lead=1)
        delta = jquant.block_delta(jx.astype(jnp.float32), 127, lead=1)
    got = tquant.fake_quant(tx, 127, torch.int8, uniforms=u, lead=1)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(
        tquant.block_delta(tx.float(), 127, lead=1).numpy(),
        np.asarray(delta))


@pytest.mark.parametrize("ndim", [0, 1, 2, 3, 4])
def test_row_lead_equals_reference(ndim):
    assert tquant.row_lead(ndim) == jquant.row_lead(ndim)


def test_stochastic_rounding_from_a_generator():
    """Uniforms drawn from a torch.Generator: repeatable per seed, on the
    grid, and unbiased in the mean."""
    x = _t(_x((4, 4096), seed=9, zero_row=False))
    draws = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(4)
        draws.append(tquant.quantize(x, 127, torch.int8, gen=gen, lead=0))
    assert torch.equal(draws[0][0], draws[1][0])
    q, scale = draws[0]
    assert int(q.abs().max()) <= 127
    y = x / scale
    assert ((q.float() - torch.floor(y)).abs() <= 1).all()
    # the mean of 16,384 errors of std <= Δ/2 has std <= Δ/256
    err = (tquant.dequantize(q, scale) - x).mean().abs().item()
    assert err < 0.02 * float(scale.max())


# ---- the int8 codec -----------------------------------------------------

def test_int8_codec_fields_and_names_equal_reference():
    tc, jc = twire.make_codec("int8"), jwire.make_codec("int8")
    assert (tc.name, tc.levels, tc.quantized) == (jc.name, jc.levels,
                                                  jc.quantized)
    assert tc.wire_dtype == torch.int8
    assert tc.accum_dtype == torch.float32
    assert not twire.make_codec("f32").quantized
    assert twire.make_codec("bf16").accum_dtype == torch.bfloat16
    for w in ("int8", "f32", "bf16", "fp32", "bfloat16"):
        assert twire.canon_wire_name(w) == jwire.canon_wire_name(w)
    assert twire.canon_wire_dtype("int8") == torch.int8
    for wire, xd in (("int8", "float32"), ("f32", "bfloat16"),
                     ("f32", "float32"), ("bf16", "float32")):
        assert twire.config_wire(wire, xd) == jwire.config_wire(wire, xd)
    assert twire.resolve_codec("int8", torch.bfloat16).name == "int8"
    assert twire.resolve_codec("f32", torch.bfloat16).name == "bf16"
    assert twire.WIRES == jwire.WIRES


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("lead", [2, 1])
def test_int8_codec_encode_decode_equal_reference(stochastic, lead):
    x = _x((2, 8, 4, 33), seed=lead)
    key = jax.random.PRNGKey(7) if stochastic else None
    u = _t(jax.random.uniform(key, x.shape)) if stochastic else None
    jc, tc = jwire.make_codec("int8"), twire.make_codec("int8")
    with jax.disable_jit():
        jq, js = jc.encode(jnp.asarray(x), key, lead=lead)
        jf = jc.fake_quant(jnp.asarray(x), key, lead=lead)
    tq, ts = tc.encode(_t(x), u, lead=lead)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.decode(tq, ts).numpy(),
                                  np.asarray(jc.decode(jq, js)))
    np.testing.assert_array_equal(tc.fake_quant(_t(x), u, lead=lead).numpy(),
                                  np.asarray(jf))
    jjf = jax.jit(lambda a: jc.fake_quant(a, key, lead=lead))(x)
    np.testing.assert_allclose(tc.fake_quant(_t(x), u, lead=lead).numpy(),
                               np.asarray(jjf), rtol=JIT_RTOL, atol=0)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_linear_codec_encode_and_fake_quant(wire):
    x = _x((3, 9), seed=1, zero_row=False)
    jc, tc = jwire.make_codec(wire), twire.make_codec(wire)
    enc, scale = tc.encode(_t(x))
    assert scale is None and enc.dtype == tc.wire_dtype
    assert tc.decode(enc, None) is enc
    np.testing.assert_array_equal(tc.fake_quant(_t(x)).numpy(),
                                  np.asarray(jc.fake_quant(jnp.asarray(x))))


# ---- recoveries and the theory constants --------------------------------

def test_ef_recovery_and_initial_state():
    rec = twire.make_recovery("ef")
    assert rec.kind == "ef" and rec.needs_state
    assert not twire.make_recovery("renorm").needs_state
    assert twire.RECOVERIES == jwire.RECOVERIES
    tree = {"a": torch.ones((4, 3)), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    ef = twire.init_ef_state(tree)
    assert ef["a"].shape == (4, 3) and not ef["a"].any()
    assert ef["b"][0].dtype == torch.bfloat16 and not ef["b"][0].any()


@pytest.mark.parametrize("kind", ["median", "trimmed", "clip"])
def test_robust_recoveries_still_raise(kind):
    """The robust recoveries, once refused, are ported: each kind's
    Recovery (its knobs, spec, table need and breakdown point) equals the
    reference's, bare and with knobs (the grammar's full sweep is in
    tests/test_torch_robust.py)."""
    for spec in (kind, f"{kind}:beta=0.3,clip_mult=3"):
        t, j = twire.make_recovery(spec), jwire.make_recovery(spec)
        assert (t.kind, t.p, t.beta, t.clip_mult) == \
            (j.kind, j.p, j.beta, j.clip_mult)
        assert t.spec == j.spec and t.needs_table and j.needs_table
        assert t.breakdown_point() == j.breakdown_point()
        assert not t.needs_state


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("recovery", ["renorm", "scale", "ef"])
def test_omega_constants_equal_reference(wire, recovery):
    assert twire.WIRE_OMEGA == jwire.WIRE_OMEGA
    assert twire.codec_omega(wire) == jwire.codec_omega(wire)
    assert twire.effective_omega(wire, recovery) == \
        jwire.effective_omega(wire, recovery)
    assert twire.codec_omega(torch.float16) == jwire.codec_omega(jnp.float16)


# ---- the plan's byte counts at the int8 wire ----------------------------

@pytest.mark.parametrize("kind", ["single", "per_leaf", "n_buckets",
                                  "bucket_mb"])
@pytest.mark.parametrize("s", [4, 6])
@pytest.mark.parametrize("recovery", ["renorm", "ef"])
def test_describe_at_int8_equals_reference(kind, s, recovery):
    n = 4
    shapes = {"a": ((6, 4), "float32"), "b": ((33,), "float32"),
              "c": ((5, 5), "bfloat16")}
    jtree = {k: jax.ShapeDtypeStruct(v[0], jnp.dtype(v[1]))
             for k, v in shapes.items()}
    ttree = {k: torch.empty(v[0], dtype=getattr(torch, v[1]), device="meta")
             for k, v in shapes.items()}
    kw = dict(wire="int8", recovery=recovery)
    if kind == "single":
        jp = jplan.single_bucket_plan(jtree, n, s, **kw)
        tp = tplan.single_bucket_plan(ttree, n, s, **kw)
    elif kind == "per_leaf":
        jp = jplan.per_leaf_plan(jtree, n, s, **kw)
        tp = tplan.per_leaf_plan(ttree, n, s, **kw)
    elif kind == "n_buckets":
        jp = jplan.make_plan(jtree, n, s, n_buckets=2, **kw)
        tp = tplan.make_plan(ttree, n, s, n_buckets=2, **kw)
    else:
        jp = jplan.make_plan(jtree, n, s, bucket_bytes=200, **kw)
        tp = tplan.make_plan(ttree, n, s, bucket_bytes=200, **kw)
    got, want = tp.describe(), jp.describe()
    assert got == want
    assert got["scale_bytes"] > 0 and got["rs_bytes_ratio"] == 0.25
    assert tp.describe("f32") == jp.describe("f32")
    assert tp.wire_bytes("int8") == jp.wire_bytes("int8")
