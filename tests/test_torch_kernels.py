"""The port's masked-average kernel module against the JAX package's.

On the CPU the port's wrapper computes its plain version; both are held
to ``masked_avg_grid_pallas`` run in interpret mode, with the JAX kernel
tests' tolerances (1e-6 f32, 2e-2 bf16), on the same numpy-seeded
inputs. The CUDA kernel itself is compared on the card (marked ``cuda``;
skips here) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_avg import (masked_avg_grid_pallas,
                                      masked_avg_pallas)
from repro.kernels.masked_avg import pick_tile_d as jax_pick_tile_d
from repro_torch.kernels import masked_avg as K
from repro_torch.kernels import ops
from repro_torch.kernels.ref import masked_avg_ref

RNG = np.random.default_rng(0)
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds from f32 identically in both)."""
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n", [2, 8, 16, 32])
@pytest.mark.parametrize("d", [7, 512, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_avg_ref_matches_pallas(n, d, dtype):
    x = RNG.normal(size=(n, d)).astype(np.float32)
    m = RNG.integers(0, 2, size=n).astype(np.float32)
    m[0] = 1
    xj, xt = _both(x, dtype)
    want = masked_avg_pallas(xj, jnp.asarray(m), interpret=True)
    _close(masked_avg_ref(xt, torch.from_numpy(m)), want, TOL[dtype])
    _close(ops.masked_avg(xt, torch.from_numpy(m)), want, TOL[dtype])
    _close(K.masked_avg(xt, torch.from_numpy(m)), want, TOL[dtype])


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("n,d", [(2, 7), (8, 512), (16, 1000), (4, 2304)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_avg_grid_cpu_route_matches_pallas(B, n, d, dtype):
    """The wrapper's CPU route and the ``ref`` backend, with raw bool
    masks, against the grid Pallas kernel; (4, 2304) at B = 4 is the
    serving shape."""
    x = RNG.normal(size=(B, n, d)).astype(np.float32)
    m = RNG.integers(0, 2, size=(B, n)).astype(bool)
    m[:, 0] = True
    xj, xt = _both(x, dtype)
    want = masked_avg_grid_pallas(xj, jnp.asarray(m), interpret=True)
    mt = torch.from_numpy(m)
    _close(K.masked_avg_grid(xt, mt), want, TOL[dtype])
    _close(ops.masked_avg_grid(xt, mt, backend="ref"), want, TOL[dtype])
    assert K.masked_avg_grid(xt, mt).dtype == xt.dtype


def test_masked_avg_all_dropped_but_owner():
    x = RNG.normal(size=(4, 64)).astype(np.float32)
    m = np.zeros(4, np.float32)
    m[2] = 1.0
    want = masked_avg_pallas(jnp.asarray(x), jnp.asarray(m), interpret=True)
    got = ops.masked_avg(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), x[2], rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_masked_avg_grid_all_mask_dtypes_agree():
    """Raw masks of any dtype give the same average (the kernel casts)."""
    x = torch.from_numpy(RNG.normal(size=(3, 8, 40)).astype(np.float32))
    m = torch.from_numpy(RNG.integers(0, 2, size=(3, 8)).astype(bool))
    want = K.masked_avg_grid(x, m.to(torch.float32))
    for dt in K.MASK_DTYPES:
        torch.testing.assert_close(K.masked_avg_grid(x, m.to(dt)), want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("d", [1, 40, 512, 513, 1000, 1021, 1024, 2304,
                               4096, 6912])
def test_pick_tile_d_equals_reference(d):
    assert K.pick_tile_d(d) == jax_pick_tile_d(d)


def test_pick_tile_d_reference_cases():
    assert K.pick_tile_d(40) == 40
    assert K.pick_tile_d(512) == 512
    assert K.pick_tile_d(1) == 1
    assert K.pick_tile_d(1000) == 500
    assert K.pick_tile_d(1024) == 512
    assert K.pick_tile_d(513) == 171
    assert K.pick_tile_d(1021) == 512
    assert K.pick_tile_d(2304) == 384          # the serving shape's tile
    for d in (40, 1000, 513):
        t = K.pick_tile_d(d)
        assert d % t == 0 and t <= 512


def test_wrapper_rejects_bad_shapes_and_backend():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="mask shape"):
        K.masked_avg_grid(x, torch.zeros(4))
    with pytest.raises(ValueError, match="mask shape"):
        ops.masked_avg_grid(x, torch.zeros(4), backend="ref")
    with pytest.raises(ValueError, match="backend"):
        ops.masked_avg_grid(x, torch.zeros(2, 4), backend="pallas")


def test_cpu_route_does_not_count_launches():
    before = K.masked_avg_grid.launches
    K.masked_avg_grid(torch.zeros((2, 4, 8)), torch.ones((2, 4)))
    assert K.masked_avg_grid.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for B, n, d in [(4, 4, 2304), (1, 2, 7), (16, 32, 1000), (2, 4, 1021)]:
        x = torch.from_numpy(RNG.normal(size=(B, n, d)).astype(np.float32))
        x = x.to(getattr(torch, dtype)).cuda()
        m = torch.from_numpy(RNG.integers(0, 2, size=(B, n)).astype(bool))
        m[:, 0] = True
        m = m.cuda()
        before = K.masked_avg_grid.launches
        got = K.masked_avg_grid(x, m)
        torch.cuda.synchronize()
        assert K.masked_avg_grid.launches == before + 1
        want = masked_avg_ref(x, m)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
