"""The port's input specs, random batches and config arithmetic against
the JAX package's (``repro.models.inputs``, ``repro.configs.base``).

- ``make_batch`` bit for bit against the reference's, for every family
  (dense, ssm, hybrid, audio, vlm) reduced (f32) and at full width
  (bf16: a few hundred thousand normal draws per float leaf), and
  ``float_leaf`` on float64 values just past a bf16 rounding midpoint,
  where rounding through f32 and rounding once differ.
- ``train_specs`` / ``input_specs`` shapes and dtypes equal to the
  reference's ``ShapeDtypeStruct``s for every arch x shape, and
  ``cache_specs`` (on the meta device) equal to its ``eval_shape`` of the
  cache, layer by layer.
- ``param_count`` (all and active), ``model_flops``,
  ``supports_long_context``, ``has_decode`` and ``runs_shape`` equal for
  every config, whole and reduced. No tolerance: all exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import inputs as jinputs
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import inputs as tinputs
from repro_torch.models.stack import group_layout

ALL = ARCH_IDS + ["rps-paper-mlp"]
# one arch of each family, with (B, S) for the reduced and the full config
FAMILIES = {"gemma3-1b": (2, 24), "rwkv6-1.6b": (2, 24),
            "recurrentgemma-9b": (2, 24), "whisper-large-v3": (2, 256),
            "llava-next-mistral-7b": (1, 600)}


def _bits(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_registries_agree():
    assert T_ARCH_IDS == ARCH_IDS
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in T_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()}


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_make_batch_bitwise_equals_reference(arch, reduced):
    cj, ct = jget_config(arch), tget_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
        B, S = 2, 40
    else:
        B, S = FAMILIES[arch]
    for seed in (0, 7):
        want = jinputs.make_batch(cj, B, S, seed=seed)
        got = tinputs.make_batch(ct, B, S, seed=seed, device="cpu")
        assert list(got) == list(want)
        for k, w in want.items():
            assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name
            assert tuple(got[k].shape) == w.shape
            np.testing.assert_array_equal(_tbits(got[k]), _bits(w))
    if not reduced and ct.family in ("audio", "vlm"):
        leaf = "frames" if ct.family == "audio" else "patches"
        assert got[leaf].dtype == torch.bfloat16
        assert got[leaf].numel() >= 300_000


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_leaf_rounds_as_reference(dtype):
    """Values a hair past a bf16 midpoint: once rounded they go up,
    through f32 they land on the midpoint and round to even; the port
    takes the reference's route. Then a few hundred thousand draws."""
    eps = 2.0 ** -40
    mids = np.array([1 + 2 ** -8, 0.02 * (1 + 2 ** -8), 3 * 2 ** -9,
                     1.5 + 2 ** -9])
    a = np.concatenate([mids + eps, -(mids + eps), mids - eps,
                        np.random.default_rng(0).normal(size=400_000)
                        * 0.02])
    want = jnp.asarray(a, jnp.dtype(dtype))
    got = tinputs.float_leaf(a, getattr(torch, dtype), "cpu")
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    for cj, ct in ((jget_config(arch), tget_config(arch)),
                   (jget_config(arch).reduced(),
                    tget_config(arch).reduced())):
        want = jinputs.input_specs(cj, shape)
        got = tinputs.input_specs(ct, shape)
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape
            assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name
        want = jinputs.train_specs(cj, 3, 640)
        got = tinputs.train_specs(ct, 3, 640)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in want.items()}


@pytest.mark.parametrize("arch", ALL)
def test_param_count_and_flops_equal_reference(arch):
    for cj, ct in ((jget_config(arch), tget_config(arch)),
                   (jget_config(arch).reduced(),
                    tget_config(arch).reduced())):
        for active in (False, True):
            assert ct.param_count(active_only=active) == \
                cj.param_count(active_only=active)
        assert ct.model_flops(4096) == cj.model_flops(4096)
        assert ct.supports_long_context() == cj.supports_long_context()
        assert ct.has_decode() == cj.has_decode()
        for name, shape in SHAPES.items():
            assert ct.runs_shape(name) == cj.runs_shape(name)
            assert ct.runs_shape(T_SHAPES[name]) == cj.runs_shape(shape)


@pytest.mark.parametrize("arch", ALL)
def test_cache_specs_equal_reference(arch):
    """The contiguous cache on the meta device, layer by layer, against
    the reference's ``eval_shape`` of its stacked cache."""
    cj, ct = jget_config(arch).reduced(), tget_config(arch).reduced()
    model_j = jbuild_model(cj, grouped=False)
    model_t = tbuild_model(ct, device="cpu")
    B, max_len = 2, 96
    want = jinputs.cache_specs(model_j, B, max_len)
    got = tinputs.cache_specs(model_t, B, max_len)
    assert len(got) == ct.n_layers
    for kind, idxs in group_layout(model_t.kinds).items():
        for j, li in enumerate(idxs):
            layer = got[li]
            assert sorted(layer) == sorted(want[kind])
            for leaf, w in want[kind].items():
                assert layer[leaf].device.type == "meta"
                assert tuple(layer[leaf].shape) == w.shape[1:], (kind, leaf)
                assert str(layer[leaf].dtype).removeprefix("torch.") == \
                    w.dtype.name
