"""The float16 wire (a linear codec, as every float dtype is in the
reference's ``core/wire.py``) against the JAX package's: its spellings,
its codec and ω, and the global exchange bit for bit on integer-valued
stacks with the reference's masks. The ring kernels refuse it by name
(``kernels/ring.py::check_wire``), on the CPU as on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.core import wire as jwire
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.core import wire as twire

RNG = np.random.default_rng(16)


@pytest.mark.parametrize("spelling", ["float16", "f16", "fp16",
                                      torch.float16])
def test_f16_spellings(spelling):
    assert twire.canon_wire_dtype(spelling) == torch.float16
    assert twire.canon_wire_name(spelling) == "float16"
    assert twire.config_wire("f32", spelling) == "float16"


def test_f16_codec_and_omega_equal_reference():
    got, want = twire.make_codec("float16"), jwire.make_codec("float16")
    assert (got.name, got.levels, got.quantized) == \
        (want.name, want.levels, want.quantized) == ("float16", 0, False)
    assert got.wire_dtype == torch.float16
    assert got.accum_dtype == torch.float16
    assert twire.codec_omega("float16") == jwire.codec_omega("float16") \
        == 2.0 ** -24
    assert abs(twire.codec_omega("float16") - 5.96e-8) < 1e-10
    assert twire.effective_omega("float16", "ef") == 2.0 ** -48
    with pytest.raises(ValueError, match="no codec"):
        twire.make_codec(torch.int32)


@pytest.mark.parametrize("mode", ["model", "grad", "grad_renorm"])
@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
def test_f16_global_exchange_equals_reference(mode, jax_backend):
    """Integer-valued f32 stacks over the float16 wire: every sum exact,
    the one division rounded to float16; bit for bit against the
    reference's kernel route, and against its einsum route rounded to
    float16 in the renormalising modes (that route returns the average
    unrounded, as at a bf16 wire)."""
    n, s, shape = 4, 4, (12, 5)
    x = RNG.integers(-8, 9, size=(n,) + shape).astype(np.float32)
    key = jax.random.PRNGKey(23)
    rs, ag = (np.array(m) for m in jrps.sample_masks(key, n, 0.3, s))
    plan_j = jplan.make_plan(jax.ShapeDtypeStruct(shape, jnp.float32), n, s,
                             wire="float16")
    want = jrps.rps_exchange_global(jnp.asarray(x), key, 0.3, n, mode=mode,
                                    masks=(rs, ag), plan=plan_j,
                                    backend=jax_backend)
    plan_t = tplan.make_plan(torch.empty(shape, device="meta"), n, s,
                             wire="float16")
    assert plan_t.wire == plan_j.wire == "float16"
    got = trps.rps_exchange_global(
        torch.from_numpy(x), None, 0.3, n, mode=mode,
        masks=(torch.from_numpy(rs), torch.from_numpy(ag)), plan=plan_t)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    if jax_backend == "jnp" and mode != "grad":
        want = want.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_engine_refuses_f16_by_name():
    """The ring engine's global round, and the trainer at setup."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    n, s = 4, 4
    x = torch.from_numpy(RNG.integers(-8, 9, size=(n, 8)).astype(np.float32))
    plan = tplan.make_plan(torch.empty((8,), device="meta"), n, s,
                           wire="float16", engine="ring")
    rs = torch.ones((n, s), dtype=torch.bool)
    with pytest.raises(ValueError, match="float16 wire on the ring engine"):
        trps.rps_exchange_global(x, None, 0.0, n, masks=(rs, rs), plan=plan,
                                 engine="ring")
    cfg = get_config("rps-paper-mlp").reduced()
    with pytest.raises(ValueError, match="float16 wire on the ring engine"):
        make_train_setup(build_model(cfg, device="cpu"), cfg,
                         TrainConfig(engine="ring", wire="float16"),
                         Mesh((4,), ("data",)), rps_axes=("data",))
