"""The port's gemma3 model against the JAX package's faithful-order model
(``build_model(cfg, grouped=False)``) on the same weights.

gemma3-1b reduced to 6 layers (5 local layers at window 64, then 1
global), f32, weights converted with ``params_from_jax``. Tolerance:
atol = rtol = 1e-4 on logits — the two frameworks sum the einsums in
different orders, and the JAX package's prefill above 2·window runs its
blocked local attention, which computes the same function by another
route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jL
from repro.serve.kvcache import PagedCache as JaxPagedCache
from repro.serve.tp import TPDecodeConfig as JaxTPConfig
from repro.serve.tp import make_tp_context as jax_make_tp
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.serve import PagedCache, TPDecodeConfig, make_tp_context

TOL = dict(atol=1e-4, rtol=1e-4)
RNG = np.random.default_rng(0)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def gemma():
    cfg_j = dataclasses.replace(jax_get_config("gemma3-1b").reduced(),
                                n_layers=6)
    cfg_t = dataclasses.replace(get_config("gemma3-1b").reduced(),
                                n_layers=6)
    model_j = jax_build_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params_j)
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_jax(np_params, cfg_t, device="cpu")
    return cfg_j, model_j, params_j, cfg_t, model_t, params_t


def _jax_prefill(model_j, params_j, toks):
    """The JAX package's paged prefill, jitted (faster than op by op)."""
    fn = jax.jit(lambda p, t: model_j.prefill(p, {"tokens": t}, paged=True))
    return fn(params_j, jnp.asarray(toks, jnp.int32))


def test_configs_agree():
    for name in ("gemma3-1b", "rps-paper-mlp"):
        for reduce in (False, True):
            cj, ct = jax_get_config(name), get_config(name)
            if reduce:
                cj, ct = cj.reduced(), ct.reduced()
            for f in dataclasses.fields(ct):
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
            assert (ct.hd, ct.padded_vocab) == (cj.hd, cj.padded_vocab)
            assert ct.torch_dtype == getattr(torch, cj.jnp_dtype.name)
    # the vlm and audio families are ported too: their configs equal the
    # reference's and build with its kinds
    for name in ("whisper-large-v3", "llava-next-mistral-7b"):
        for reduce in (False, True):
            cj, ct = jax_get_config(name), get_config(name)
            if reduce:
                cj, ct = cj.reduced(), ct.reduced()
            for f in dataclasses.fields(ct):
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert build_model(ct, device="cpu").kinds == \
            jax_build_model(cj, grouped=False).kinds


def test_kind_sequence_is_faithful(gemma):
    _, model_j, _, cfg_t, model_t, _ = gemma
    assert model_t.kinds == model_j.kinds
    assert model_t.kinds == ["attn@64"] * 5 + ["attn"]


def test_rms_norm_and_rope():
    x = RNG.normal(size=(2, 5, 3, 64)).astype(np.float32)
    g = RNG.normal(size=(64,)).astype(np.float32) * 0.1
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jL.rms_norm(jnp.asarray(x), jnp.asarray(g)), atol=1e-6,
           rtol=1e-6)
    pos = np.array([[0, 1, 7, 100, 4095]])
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), atol=1e-5,
           rtol=1e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_decode_attention_per_request_positions(window):
    B, C, kvh, h, hd = 3, 48, 1, 4, 64
    q = RNG.normal(size=(B, 1, h, hd)).astype(np.float32)
    k = RNG.normal(size=(B, C, kvh, hd)).astype(np.float32)
    v = RNG.normal(size=(B, C, kvh, hd)).astype(np.float32)
    pos = np.array([3, 20, 47])
    want = jL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pos),
                               window=window)
    got = L.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(pos), window=window)
    _close(got, want, atol=1e-5, rtol=1e-5)


def test_paged_write_and_gather():
    n_slots, kvh, hd, page = 64, 1, 8, 4
    pool = RNG.normal(size=(n_slots, kvh, hd)).astype(np.float32)
    new = RNG.normal(size=(2, 1, kvh, hd)).astype(np.float32)
    bt = np.array([[3, 5, 0], [7, 2, 9]])
    pos = np.array([5, 10])
    want = jL.paged_write(jnp.asarray(pool), jnp.asarray(new),
                          jnp.asarray(bt), jnp.asarray(pos), page)
    got = L.paged_write(torch.from_numpy(pool.copy()), torch.from_numpy(new),
                        torch.from_numpy(bt), torch.from_numpy(pos), page)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        L.paged_gather(got, torch.from_numpy(bt), page).numpy(),
        np.asarray(jL.paged_gather(want, jnp.asarray(bt), page)))


@pytest.mark.parametrize("S", [40, 160])
def test_prefill_logits_and_cache(gemma, S):
    """S = 160 > 2·window takes the JAX package's blocked local path."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = gemma
    toks = RNG.integers(0, cfg_t.vocab_size, size=(1, S))
    last_j, cache_j = _jax_prefill(model_j, params_j, toks)
    last_t, cache_t = model_t.prefill(params_t,
                                      {"tokens": torch.from_numpy(toks)},
                                      paged=True)
    _close(last_t, last_j)
    for li, kind in enumerate(model_t.kinds):
        j = model_j.kinds[:li].count(kind)
        for leaf in ("k", "v"):
            _close(cache_t[li][leaf], cache_j[kind][leaf][j])


PAGE, STEPS, LENS = 8, 6, (40, 160)


@pytest.fixture(scope="module")
def prefilled(gemma):
    """Both packages' pools after prefilling two requests (the second one
    past the window), on identical block tables."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = gemma
    pc_j = JaxPagedCache(model_j, PAGE, 40)
    pc_t = PagedCache(model_t, PAGE, 40)
    bt = np.zeros((len(LENS), -(-(max(LENS) + STEPS) // PAGE)), np.int64)
    for b, S in enumerate(LENS):
        toks = RNG.integers(0, cfg_t.vocab_size, size=(1, S))
        _, cj = _jax_prefill(model_j, params_j, toks)
        _, ct = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                                paged=True)
        blocks = pc_j.alloc.alloc(-(-(S + STEPS) // PAGE))
        assert pc_t.alloc.alloc(len(blocks)) == blocks
        pc_j.write_prefill(cj, blocks, S)
        pc_t.write_prefill(ct, blocks, S)
        bt[b, :len(blocks)] = blocks
    return bt, pc_j.pool, pc_t.pool


@pytest.mark.parametrize("tp", [False, True], ids=["dense", "tp4"])
def test_decode_paged_logits_over_steps(gemma, prefilled, tp):
    """Six decode steps fed the same tokens after the prefill; with
    ``tp`` every output projection goes through the 4-shard drop-masked
    exchange with the JAX package's masks (p = 0.3) injected into the
    port."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = gemma
    bt, pool_j, pool_t = prefilled
    pool_t = [dict(layer, k=layer["k"].clone(), v=layer["v"].clone())
              for layer in pool_t]             # the port writes in place
    B = len(LENS)
    ctx_j = ctx_t = None
    if tp:
        ctx_j = jax_make_tp(JaxTPConfig(n_shards=4, p=0.3), cfg_j, B)
        ctx_t = make_tp_context(TPDecodeConfig(n_shards=4, p=0.3), cfg_t, B)
    decode_j = jax.jit(lambda p, pool, tok, pos, bt, masks, key:
                       model_j.decode_paged(p, pool, {"token": tok}, pos, bt,
                                            page=PAGE, masks=masks, tp=ctx_j,
                                            key=key))
    pos = np.asarray(LENS)
    key = jax.random.PRNGKey(7)
    for _ in range(STEPS):
        tok = RNG.integers(0, cfg_t.vocab_size, size=(B, 1))
        masks_j = masks_t = None
        if tp:
            key, k_m = jax.random.split(key)
            masks_j, _ = ctx_j.sample_site_masks(k_m, None)
            masks_t = tuple(torch.from_numpy(np.array(m)) for m in masks_j)
        lj, pool_j = decode_j(params_j, pool_j, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32),
                              jnp.asarray(bt, jnp.int32), masks_j, key)
        lt, pool_t = model_t.decode_paged(
            params_t, pool_t, {"token": torch.from_numpy(tok)},
            torch.from_numpy(pos), torch.from_numpy(bt), page=PAGE,
            masks=masks_t, tp=ctx_t)
        _close(lt, lj)
        pos = pos + 1


def test_init_draws_reference_scales():
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), n_layers=2)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = model.init(gen)
    d, V = cfg.d_model, cfg.padded_vocab
    assert p["embed"]["tok"].shape == (V, d)
    assert abs(p["embed"]["tok"].std().item() - 1.0) < 0.02
    assert abs(p["embed"]["head"].std().item() - d ** -0.5) < 0.02 * d ** -.5
    a = p["layers"][0]["attn"]
    assert a["wq"].shape == (d, cfg.n_heads, cfg.hd)
    assert a["wo"].shape == (cfg.n_heads, cfg.hd, d)
    assert float(p["layers"][1]["ln1"].abs().sum()) == 0.0
    gen.manual_seed(0)
    again = model.init(gen)
    assert torch.equal(again["layers"][1]["mlp"]["wo"],
                       p["layers"][1]["mlp"]["wo"])
