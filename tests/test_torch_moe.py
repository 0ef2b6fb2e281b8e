"""The port's sort-based top-k MoE and the ``moe_attn`` kind against the
JAX package's, on mixtral-8x22b-reduced and kimi-k2-1t-a32b-reduced (4
experts, top 2, f32) with the reference's weights:

- the routing: the top-k experts (``gate_idx``), the kept set and the
  buffer slots equal the reference's (its routing lines repeated on its
  own arrays, below); in one case the capacity drops assignments
  (``capacity_factor=0.5``), so the stable order of the drops counts.
  ``torch.topk`` and ``lax.top_k`` could order equal probabilities
  differently; with continuous random inputs no tie occurs, and the test
  asserts there is none rather than re-seeding;
- ``moe``'s output within 1e-5 and its aux loss within 1e-6;
- ``Model.loss`` and its gradients (1e-5 / 1e-4);
- prefill and paged decode logits within 1e-4, the continuous engine's
  greedy tokens equal the reference engine's;
- lossy 4-shard TP decode with the reference's masks within 1e-4 of the
  reference, and the TP-combine route's logits bit for bit equal to the
  exchange route's (the attention sites combine; the MoE FFN keeps the
  dense expert path, as the reference's does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve.kvcache import PagedCache as JaxPagedCache
from repro.serve.tp import TPDecodeConfig as JaxTPConfig
from repro.serve.tp import make_tp_context as jax_make_tp
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, stacked_params_from_jax
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as L
from repro_torch.serve import (ContinuousEngine, PagedCache, Request,
                               TPDecodeConfig, make_tp_context)
from _torch_sim import one_thread  # noqa: F401

# one intra-op thread (tests/_torch_sim.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["mixtral-8x22b", "kimi-k2-1t-a32b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _jax_route(p, x, cfg):
    """The reference's routing (``repro.models.layers.moe``, its lines up
    to the slots) on its own arrays: gate_idx, keep, slot and the
    probabilities."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    probs = jax.nn.softmax(x.reshape(T, d).astype(jnp.float32)
                           @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    cap = max(int(np.ceil(T * K / E * cfg.capacity_factor)), 4)
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E))
    rank = jnp.zeros((T * K,), jnp.int32).at[order].set(
        (jnp.arange(T * K) - starts[sorted_e]).astype(jnp.int32))
    keep = rank < cap
    slot = flat_e * cap + jnp.where(keep, rank, 0)
    return {"gate_idx": gate_idx, "keep": keep, "slot": slot,
            "probs": probs}


def _no_ties(probs: np.ndarray, K: int) -> None:
    """The K-th and (K+1)-th largest probabilities differ in every row,
    so the top-k set is unambiguous."""
    srt = -np.sort(-probs, axis=-1)
    assert np.all(srt[:, K - 1] > srt[:, K]), "a routing tie"


@pytest.mark.parametrize("capacity", [None, 0.5], ids=["cap1.25", "cap0.5"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_output_and_aux_equal_reference(arch, capacity):
    cfg_j = jget_config(arch).reduced()
    cfg_t = tget_config(arch).reduced()
    if capacity is not None:
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=capacity)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=capacity)
    pj = jL.init_moe(jax.random.PRNGKey(1), cfg_j)
    pt = stacked_params_from_jax(_np(pj), "cpu")
    x = np.random.default_rng(2).normal(
        size=(2, 24, cfg_t.d_model)).astype(np.float32)
    # the routing and the layer in one compiled function
    want, (out_j, aux_j) = jax.jit(lambda p, x: (
        _jax_route(p, x, cfg_j), jL.moe(p, x, cfg_j)))(pj, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in want.items()}
    _no_ties(want["probs"], cfg_t.top_k)
    got = L.moe_route(pt, torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(got["gate_idx"].numpy(), want["gate_idx"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    dropped = int((~got["keep"]).sum())
    assert (dropped > 0) == (capacity is not None)
    out_t, aux_t = L.moe(pt, torch.from_numpy(x), cfg_t)
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_shapes_and_kinds(arch):
    cfg = tget_config(arch).reduced()
    model = tbuild_model(cfg, device="cpu")
    jm = jbuild_model(jget_config(arch).reduced(), grouped=False)
    assert model.kinds == jm.kinds
    assert all(k.startswith("moe_attn") for k in model.kinds)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = model.init(gen)["layers"][0]["moe"]
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (d, E)
    assert p["wi"].shape == p["wg"].shape == (E, d, ff)
    assert p["wo"].shape == (E, ff, d)
    assert abs(p["wi"].std().item() * d ** 0.5 - 1.0) < 0.05


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg_j, cfg_t = jget_config(arch).reduced(), tget_config(arch).reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = tbuild_model(cfg_t, device="cpu")
    # one compiled reference prefill per config, shared by the cases
    prefill_j = jax.jit(lambda p, t: model_j.prefill(p, {"tokens": t},
                                                     paged=True))
    return cfg_j, model_j, params_j, cfg_t, model_t, prefill_j


def test_model_loss_and_grads_equal_reference(pair):
    cfg_j, model_j, params_j, cfg_t, model_t, _ = pair
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: model_j.loss(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
        has_aux=True))(params_j)
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
                               float(jaux["aux_loss"]), rtol=1e-5)
    assert float(jaux["aux_loss"]) > 0
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / max(np.abs(w).max(),
                                                 1e-12) < 1e-4


PAGE, STEPS, LENS = 8, 4, (20, 37)


@pytest.mark.parametrize("tp", [False, True], ids=["dense", "tp4"])
def test_prefill_and_paged_decode_logits_equal_reference(pair, tp):
    """Both requests prefilled into identical pools, then four decode
    steps fed the same tokens; with ``tp`` the attention sites go
    through the 4-shard drop-masked combine with the reference's masks
    (p = 0.3)."""
    cfg_j, model_j, params_j, cfg_t, model_t, prefill_j = pair
    params_t = params_from_jax(_np(params_j), cfg_t, device="cpu")
    rng = np.random.default_rng(3)
    pc_j, pc_t = JaxPagedCache(model_j, PAGE, 20), PagedCache(model_t, PAGE,
                                                              20)
    bt = np.zeros((len(LENS), -(-(max(LENS) + STEPS) // PAGE)), np.int64)
    for b, S in enumerate(LENS):
        toks = rng.integers(0, cfg_t.vocab_size, size=(1, S))
        lj, cj = prefill_j(params_j, jnp.asarray(toks))
        lt, ct = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                                 paged=True)
        _close(lt, lj)
        blocks = pc_j.alloc.alloc(-(-(S + STEPS) // PAGE))
        assert pc_t.alloc.alloc(len(blocks)) == blocks
        pc_j.write_prefill(cj, blocks, S)
        pc_t.write_prefill(ct, blocks, S)
        bt[b, :len(blocks)] = blocks
    pool_j, pool_t = pc_j.pool, pc_t.pool
    B = len(LENS)
    decode_j = jax.jit(lambda p, pool, tok, pos, bt, masks, key:
                       model_j.decode_paged(p, pool, {"token": tok}, pos, bt,
                                            page=PAGE, masks=masks,
                                            tp=ctx_j, key=key))
    ctx_j = ctx_t = None
    if tp:
        ctx_j = jax_make_tp(JaxTPConfig(n_shards=4, p=0.3), cfg_j, B)
        ctx_t = make_tp_context(TPDecodeConfig(n_shards=4, p=0.3), cfg_t, B)
        assert ctx_t.fused
    pos = np.asarray(LENS)
    key = jax.random.PRNGKey(7)
    for _ in range(STEPS):
        tok = rng.integers(0, cfg_t.vocab_size, size=(B, 1))
        masks_j = masks_t = None
        if tp:
            key, k_m = jax.random.split(key)
            masks_j, _ = ctx_j.sample_site_masks(k_m, None)
            masks_t = tuple(torch.from_numpy(np.array(m)) for m in masks_j)
        lj, pool_j = decode_j(params_j, pool_j, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32),
                              jnp.asarray(bt, jnp.int32), masks_j, key)
        args = ({"token": torch.from_numpy(tok)}, torch.from_numpy(pos),
                torch.from_numpy(bt))
        if tp:
            # the exchange route on a copy of the pool, before the
            # kernel's route writes the pool in place
            copy = [dict(lay, k=lay["k"].clone(), v=lay["v"].clone())
                    for lay in pool_t]
            ctx_t.fused = False
            unfused, _ = model_t.decode_paged(params_t, copy, *args,
                                              page=PAGE, masks=masks_t,
                                              tp=ctx_t)
            ctx_t.fused = True
        lt, pool_t = model_t.decode_paged(params_t, pool_t, *args, page=PAGE,
                                          masks=masks_t, tp=ctx_t)
        _close(lt, lj)
        if tp:
            np.testing.assert_array_equal(lt.numpy(), unfused.numpy())
        pos = pos + 1


def test_engine_greedy_tokens_equal_reference():
    """The continuous engines on the same three requests (one joins when
    a lane frees): the same greedy tokens, on mixtral-8x22b-reduced (its
    window kept; kimi's reduced config is the same model without one)."""
    cfg_j = jget_config("mixtral-8x22b").reduced()
    cfg_t = tget_config("mixtral-8x22b").reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = tbuild_model(cfg_t, device="cpu")
    params_t = params_from_jax(_np(params_j), cfg_t, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg_t.vocab_size, size=S),
                    max_new=m) for i, (S, m) in enumerate(((12, 6), (30, 9),
                                                           (9, 5)))]
    kw = dict(page=4, n_blocks=40, max_batch=2, chunk=4, max_len=48)
    want = JaxEngine(model_j, params_j, **kw).run(
        [JaxRequest(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
         for r in reqs], drain=True)
    got = ContinuousEngine(model_t, params_t, **kw).run(reqs, drain=True)
    assert got.outputs() == want.outputs()
