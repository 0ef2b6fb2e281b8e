"""The train modes of every decoder family against the JAX package's:
rwkv6-1.6b-reduced (the rwkv kind), recurrentgemma-9b-reduced (rec and
local attention) and mixtral-8x22b-reduced (the MoE kind, its aux loss),
f32, on the reference's weights.

- The XLA routes the train kinds take (``ops.rwkv6`` / ``ops.rglru`` with
  ``backend="xla"``): against the reference's ``_rwkv6_scan_of_scans`` and
  ``_rglru_assoc`` and the sequential plain versions, forward 1e-5 and
  gradients 1e-4 (other summation orders: the chunk's closed form, the
  log-step scan), finite gradients at the decay clip.
- ``Model.loss`` against ``jax.value_and_grad`` of the reference's loss:
  loss within 1e-5, each gradient leaf within 1e-4 of its largest
  entry. The train path reaches no CUDA kernel wrapper.
- The simulator, 3 steps at n = 4 on the char-LM task, rps_model on the
  ring engine, with the reference's initial parameters and masks
  injected: per-step losses within 1e-5, consensus within 1e-4
  (``_torch_sim.run_both`` holds the consensus, the plan and the
  channel's effective p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jdata
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import stacked_params_from_jax
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rglru as rglru_kernel
from repro_torch.kernels import rwkv6 as rwkv6_kernel
from repro_torch.kernels.ref import rglru_ref, rwkv6_ref
from repro_torch.models import build_model as tbuild_model
from _torch_sim import one_thread, run_both  # noqa: F401

# one intra-op thread (tests/_torch_sim.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b", "mixtral-8x22b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fwd_and_vjp(fn, ct, *args):
    """The reference's output and the gradients of <output, ct> (one
    compiled function under ``jax.jit``)."""
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(jnp.asarray(ct))


def _rwkv_inputs(S, seed, w_const=None):
    rng = np.random.default_rng(seed)
    B, h, dk = 2, 2, 16
    r, k, v = (rng.normal(size=(B, S, h, dk)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.05, 0.995, size=(B, S, h, dk)).astype(np.float32)
    if w_const is not None:
        w[:, S // 3:S // 2] = w_const
    u = rng.normal(size=(h, dk)).astype(np.float32) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("S,w_const", [(64, None), (100, None), (7, None),
                                       (150, 1e-30), (130, 0.9999)])
def test_rwkv6_xla_route_equals_reference(S, w_const):
    """The chunked scan of scans (64-step chunks: one whole, a padded
    last chunk, one short chunk) against the reference's, and its
    gradients against ``jax.grad`` of it; at w = 1e-30 (the clip) the
    masked exponent keeps the backward finite."""
    r, k, v, w, u = _rwkv_inputs(S, S, w_const)
    ct = np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
    want, jg = jax.jit(lambda *a: _fwd_and_vjp(
        lambda *b: jops.rwkv6(*b, backend="xla"), ct, *a))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (r, k, v, w, u)]
    got, state = tops.rwkv6(*tin, backend="xla")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    o_ref, s_ref = rwkv6_ref(*(t.detach() for t in tin))
    np.testing.assert_allclose(state.detach().numpy(), s_ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), o_ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    tg = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), tin)
    for g, want_g in zip(tg, jg):
        assert torch.isfinite(g).all()
        want_g = np.asarray(want_g)
        scale = max(np.abs(want_g).max(), 1e-12)
        assert np.abs(g.numpy() - want_g).max() / scale < 1e-4


@pytest.mark.parametrize("S", [1, 5, 64, 200])
def test_rglru_xla_route_equals_reference(S):
    """The log-step scan against the reference's associative scan (f32 h)
    and the sequential plain version, with gradients."""
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 24)).astype(np.float32)
    a = rng.uniform(0.0, 0.999, size=(2, S, 24)).astype(np.float32)
    ct = rng.normal(size=(2, S, 24)).astype(np.float32)
    want, jg = jax.jit(lambda *b: _fwd_and_vjp(
        lambda x, a: jops.rglru(x, a, backend="xla")[0], ct, *b))(
        jnp.asarray(x), jnp.asarray(a))
    tx, ta = (torch.from_numpy(t).requires_grad_(True) for t in (x, a))
    h, h_last = tops.rglru(tx, ta, backend="xla")
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(h_last.detach().numpy(),
                                  h[:, -1].detach().numpy())
    ref, _ = rglru_ref(tx.detach(), ta.detach())
    np.testing.assert_allclose(h.detach().numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    tg = torch.autograd.grad((h * torch.from_numpy(ct)).sum(), (tx, ta))
    for g, want_g in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=1e-4,
                                   rtol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg_j, cfg_t = jget_config(arch).reduced(), tget_config(arch).reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    model_t = tbuild_model(cfg_t, device="cpu")
    assert model_t.kinds == model_j.kinds
    return cfg_j, model_j, cfg_t, model_t


def test_model_loss_and_grads_equal_reference(pair, monkeypatch):
    cfg_j, model_j, cfg_t, model_t = pair
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(3))
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: model_j.loss(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
        has_aux=True))(params_j)

    def refuse(*a, **k):
        raise AssertionError("the train path reached a kernel wrapper")

    monkeypatch.setattr(rwkv6_kernel, "rwkv6", refuse)
    monkeypatch.setattr(rglru_kernel, "rglru", refuse)
    leaves, td = tree_lib.flatten(stacked_params_from_jax(_np(params_j),
                                                          "cpu"))
    for x in leaves:
        x.requires_grad_(True)
    tl, taux = model_t.loss(tree_lib.unflatten(td, leaves),
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(taux["aux_loss"].item(),
                               float(jaux["aux_loss"]), rtol=1e-5,
                               atol=1e-7)
    assert (float(jaux["aux_loss"]) > 0) == cfg_t.is_moe
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / max(np.abs(w).max(),
                                                 1e-12) < 1e-4


def test_simulator_three_steps_equal_reference(pair):
    """rps_model on the ring engine at p = 0.3, n = 4, the char-LM task
    (seq 16, batch 2), the reference's init and masks injected."""
    cfg_j, model_j, cfg_t, model_t = pair
    jtask = jdata.CharLMTask(vocab=cfg_j.vocab_size, seq_len=16, seed=0)
    ttask = tdata.CharLMTask(vocab=cfg_t.vocab_size, seq_len=16, seed=0,
                             device="cpu")
    th, jh = run_both(dict(aggregator="rps_model", drop_rate=0.3,
                           engine="ring", lr=0.05),
                      lambda p, b: model_j.loss(p, b)[0], model_j.init,
                      jdata.make_worker_streams(jtask, 4, 2),
                      lambda p, b: model_t.loss(p, b)[0],
                      tdata.make_worker_streams(ttask, 4, 2), steps=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert all(c > 0 for c in th["consensus"][1:])
