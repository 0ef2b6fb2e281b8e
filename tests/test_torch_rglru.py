"""The port's RG-LRU kernel module against the JAX package's.

The plain version and the wrapper's CPU route against ``rglru_pallas``
run in interpret mode over the JAX kernel tests' sweep and tolerance
(1e-5), the final carry against the reference's ``rglru_ref``, bf16 x
with f32 a against the Pallas kernel's bf16 output (within one bf16
ulp), and the decode step against the reference step. The CUDA kernel
itself is compared on the card (marked ``cuda``; skips here) and by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as K
from repro_torch.kernels.ref import rglru_ref, rglru_step_ref

RNG = np.random.default_rng(0)
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0 ** -7


def _inputs(B, S, d):
    """The JAX kernel tests' input distribution: x normal, a uniform in
    (0.1, 0.999), as numpy f32."""
    x = RNG.normal(size=(B, S, d)).astype(np.float32)
    a = RNG.uniform(0.1, 0.999, size=(B, S, d)).astype(np.float32)
    return x, a


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("S,d,chunk,tile", [(1, 8, 16, 64), (64, 64, 16, 32),
                                            (130, 70, 32, 64)])
def test_rglru_cpu_route_matches_pallas(S, d, chunk, tile):
    """The plain version, the wrapper's CPU route and the ``ref`` backend
    against the Pallas kernel (the JAX kernel tests' sweep, f32)."""
    x, a = _inputs(2, S, d)
    want = rglru_pallas(jnp.asarray(x), jnp.asarray(a), chunk=chunk,
                        tile_d=tile, interpret=True)
    _, want_last = jref.rglru_ref(jnp.asarray(x), jnp.asarray(a))
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    for h, h_last in (rglru_ref(xt, at), K.rglru(xt, at),
                      ops.rglru(xt, at, backend="ref")):
        assert h.dtype == torch.float32 and h.shape == (2, S, d)
        assert h_last.dtype == torch.float32 and h_last.shape == (2, d)
        _close(h, want, **TOL)
        _close(h_last, want_last, **TOL)
        torch.testing.assert_close(h_last, h[:, -1], atol=0.0, rtol=0.0)


@pytest.mark.parametrize("S,d", [(33, 70), (130, 256)])
def test_rglru_bf16_x_f32_a_matches_pallas(S, d):
    """The model's dtypes: bf16 x, f32 a. h comes back in bf16, within one
    bf16 ulp of the Pallas kernel's bf16 output; the carry stays f32."""
    x, a = _inputs(2, S, d)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = rglru_pallas(xj, jnp.asarray(a), chunk=32, tile_d=64,
                        interpret=True)
    assert want.dtype == jnp.bfloat16
    _, want_last = jref.rglru_ref(xj, jnp.asarray(a))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    h, h_last = K.rglru(xt, torch.from_numpy(a))
    assert h.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    _close(h, want, atol=1e-6, rtol=BF16_ULP)
    _close(h_last, want_last, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_matches_reference(dtype):
    x, a = (v[:, 0] for v in _inputs(3, 1, 40))
    state = RNG.normal(size=(3, 40)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = jops.rglru_step(xj, jnp.asarray(a), jnp.asarray(state))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.rglru_step(xt, torch.from_numpy(a), torch.from_numpy(state))
    assert got.dtype == torch.float32
    _close(got, want, **TOL)


def test_step_folds_to_the_sequence():
    """Stepping the decode recurrence S times gives the sequence's h at
    every step and its final carry; from a carry h0 the sequence
    continues where the steps left off."""
    x, a = (torch.from_numpy(v) for v in _inputs(2, 9, 16))
    h_full, last = K.rglru(x, a)
    h = torch.zeros((2, 16))
    for t in range(9):
        h = ops.rglru_step(x[:, t], a[:, t], h)
        torch.testing.assert_close(h, h_full[:, t], **TOL)
    torch.testing.assert_close(h, last, **TOL)
    h_tail, last_tail = rglru_ref(x[:, 5:], a[:, 5:], h0=h_full[:, 4])
    torch.testing.assert_close(h_tail, h_full[:, 5:], **TOL)
    torch.testing.assert_close(last_tail, last, **TOL)
    torch.testing.assert_close(rglru_step_ref(x[:, 0], a[:, 0],
                                              torch.zeros(2, 16)),
                               h_full[:, 0], **TOL)


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="must equal x"):
        K.rglru(x, torch.zeros((1, 4, 7)))
    with pytest.raises(ValueError, match=r"\(B, S, d\)"):
        K.rglru(torch.zeros((4, 8)), torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="at least one step"):
        K.rglru(torch.zeros((1, 0, 8)), torch.zeros((1, 0, 8)))
    with pytest.raises(ValueError, match="backend"):
        ops.rglru(x, x, backend="pallas")
    # the kernel route's checks, applied to the tensors a CUDA call
    # would get
    with pytest.raises(TypeError, match="x dtype"):
        K._check_cuda(x.to(torch.int32), x)
    with pytest.raises(TypeError, match="a must be float32"):
        K._check_cuda(x.to(torch.bfloat16), x.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        K._check_cuda(x.transpose(1, 2), x.transpose(1, 2))
    K._check_cuda(x.to(torch.bfloat16), x)
    K._check_cuda(x.to(torch.bfloat16), x.to(torch.bfloat16))


def test_cpu_route_does_not_count_launches():
    before = K.rglru.launches
    x, a = (torch.from_numpy(v) for v in _inputs(1, 3, 8))
    K.rglru(x, a)
    ops.rglru(x, a)
    assert K.rglru.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(x_dtype):
    """On the card: the CUDA kernel's h and final carry against its plain
    version, f32 within 1e-5, bf16 h within one bf16 ulp of the plain
    version's f32 h rounded to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for B, S, d in [(2, 1, 8), (2, 16, 70), (3, 33, 33), (2, 130, 4096)]:
        x, a = (torch.from_numpy(v).cuda() for v in _inputs(B, S, d))
        x = x.to(getattr(torch, x_dtype))
        before = K.rglru.launches
        h, h_last = K.rglru(x, a)
        torch.cuda.synchronize()
        assert K.rglru.launches == before + 1
        assert h.dtype == x.dtype
        h_ref, last_ref = rglru_ref(x.float(), a)
        tol = TOL if x_dtype == "float32" else dict(atol=1e-6,
                                                     rtol=BF16_ULP)
        torch.testing.assert_close(h.float(), h_ref.to(x.dtype).float(),
                                   **tol)
        torch.testing.assert_close(h_last, last_ref, **TOL)
