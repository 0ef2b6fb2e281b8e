"""The port's recurrentgemma slice and the dense kinds' contiguous
ring-buffer decode against the JAX package's.

Model: recurrentgemma-9b reduced (3 layers rec, rec, attn@64; d 256,
d_state 64, f32) and gemma3-1b reduced (with 6 layers, so that a global
layer pads its cache to ``max_len``), on weights carried across by
``params_from_jax``. Prefill logits and every cache leaf, and
teacher-forced decode steps, within 1e-4 of ``build_model(cfg,
grouped=False)`` — at a prompt length that is a multiple of the window
and at one that is not, where both packages evict the same wrong ring
slots. Engine: the port's ``ServeEngine`` gives the JAX ``ServeEngine``'s
greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.registry import kind_sequence as jax_kind_sequence
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.registry import kind_sequence
from repro_torch.models.stack import group_layout
from repro_torch.serve import PagedCache, ServeEngine

RNG = np.random.default_rng(0)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = {"recurrentgemma": ("recurrentgemma-9b", {}),
         # 6 layers: five attn@w and one global layer
         "gemma3": ("gemma3-1b", {"n_layers": 6})}


def _pair(arch: str, **overrides):
    """Both packages' models of the reduced ``arch`` on the same
    weights."""
    name, base = ARCHS[arch]
    over = {**base, **overrides}
    cfg_j = dataclasses.replace(jax_get_config(name).reduced(), **over)
    cfg_t = dataclasses.replace(get_config(name).reduced(), **over)
    model_j = jax_build_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return model_j, params_j, model_t, params_t


@pytest.fixture(scope="module")
def rg():
    return _pair("recurrentgemma")


@pytest.fixture(scope="module")
def rg16():
    """recurrentgemma reduced at window 16: prompt lengths on both sides
    of a window multiple stay small."""
    return _pair("recurrentgemma", window=16)


@pytest.fixture(scope="module")
def gemma16():
    return _pair("gemma3", window=16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _check_cache(model_t, cache_t, cache_j):
    """Every leaf of every layer's cache, the port's per-layer list
    against the reference's per-kind stacks."""
    for kind, idxs in group_layout(model_t.kinds).items():
        for j, li in enumerate(idxs):
            assert set(cache_t[li]) == set(cache_j[kind]), kind
            for leaf, val in cache_t[li].items():
                want = np.asarray(cache_j[kind][leaf][j], np.float32)
                assert tuple(val.shape) == want.shape, (kind, leaf)
                np.testing.assert_allclose(_np(val), want, **MODEL_TOL)


def _jax_prefill(model_j, params_j, toks, max_len):
    fn = jax.jit(lambda p, t: model_j.prefill(p, {"tokens": t},
                                              max_len=max_len))
    return fn(params_j, jnp.asarray(toks, jnp.int32))


# ---------------------------------------------------------------------------
# Config, kinds, weights
# ---------------------------------------------------------------------------

def test_configs_agree():
    for reduce in (False, True):
        cj = jax_get_config("recurrentgemma-9b")
        ct = get_config("recurrentgemma-9b")
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert (ct.hd, ct.padded_vocab) == (cj.hd, cj.padded_vocab)
        assert ct.torch_dtype == getattr(torch, cj.jnp_dtype.name)
    full = get_config("recurrentgemma-9b")
    assert (full.n_layers, full.d_model, full.d_state, full.window,
            full.d_ff, full.vocab_size) == (38, 4096, 4096, 2048, 12288,
                                            256000)
    red = full.reduced()
    assert (red.n_layers, red.d_model, red.d_state, red.window, red.dtype) \
        == (3, 256, 64, 64, "float32")


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "gemma3-1b"])
def test_kind_sequence_equals_reference(name):
    for cfg_t, cfg_j in ((get_config(name), jax_get_config(name)),
                         (get_config(name).reduced(),
                          jax_get_config(name).reduced())):
        assert kind_sequence(cfg_t) == jax_kind_sequence(cfg_j)
    kinds = kind_sequence(get_config("recurrentgemma-9b"))
    assert kinds.count("rec") == 26 and kinds.count("attn@2048") == 12
    assert kinds[:3] == ["rec", "rec", "attn@2048"]


def test_params_from_jax_carries_rec_params(rg):
    _, params_j, model_t, params_t = rg
    cfg = model_t.cfg
    rec = params_j["layers"]["rec"]
    for j, li in enumerate(group_layout(model_t.kinds)["rec"]):
        layer = params_t["layers"][li]
        assert layer["lam"].dtype == torch.float32
        assert tuple(layer["conv"].shape) == (4, cfg.d_state)
        assert tuple(layer["wa"].shape) == (cfg.d_state, cfg.d_state)
        for leaf in ("ln1", "ln2", "wy", "wx", "conv", "wa", "wi", "lam",
                     "wo"):
            np.testing.assert_array_equal(_np(layer[leaf]),
                                          np.asarray(rec[leaf][j]))
        for leaf in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(_np(layer["mlp"][leaf]),
                                          np.asarray(rec["mlp"][leaf][j]))


def test_port_init_has_the_reference_shapes(rg):
    """The port's own init draws every leaf at the reference's shape and
    dtype."""
    _, params_j, model_t, _ = rg
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model_t.init(gen)
    for kind, idxs in group_layout(model_t.kinds).items():
        want = jax.tree.map(lambda a: (a.shape[1:], a.dtype.name),
                            params_j["layers"][kind])
        for li in idxs:
            got = jax.tree.map(lambda t: (tuple(t.shape),
                                          str(t.dtype).split(".")[1]),
                               params["layers"][li])
            assert got == want


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 64, 100])
def test_prefill_logits_and_cache(rg, S):
    """S below, at and above the 64-token window: the ring keeps the last
    min(S, 64) rows in both packages."""
    model_j, params_j, model_t, params_t = rg
    toks = RNG.integers(0, model_t.cfg.vocab_size, size=(2, S))
    last_j, cache_j = _jax_prefill(model_j, params_j, toks, S + 8)
    last_t, cache_t = model_t.prefill(params_t,
                                      {"tokens": torch.from_numpy(toks)},
                                      max_len=S + 8)
    np.testing.assert_allclose(_np(last_t), np.asarray(last_j), **MODEL_TOL)
    _check_cache(model_t, cache_t, cache_j)
    assert cache_t[2]["k"].shape[1] == min(S, 64)
    assert cache_t[0]["h"].dtype == torch.float32


def _decode_against_reference(pair, S0: int, K_: int = 4):
    """Prefill S0 tokens, then K_ teacher-forced decode steps in both
    packages: logits and cache at every step. Returns the port's last
    logits and the tokens."""
    model_j, params_j, model_t, params_t = pair
    toks = RNG.integers(0, model_t.cfg.vocab_size, size=(2, S0 + K_))
    _, cache_j = _jax_prefill(model_j, params_j, toks[:, :S0], S0 + K_)
    _, cache_t = model_t.prefill(params_t,
                                 {"tokens": torch.from_numpy(toks[:, :S0])},
                                 max_len=S0 + K_)
    step_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    for t in range(K_):
        tok = toks[:, S0 + t:S0 + t + 1]
        got, cache_t = model_t.decode_step(
            params_t, cache_t, {"token": torch.from_numpy(tok)}, S0 + t)
        want, cache_j = step_j(params_j, cache_j, jnp.asarray(tok, jnp.int32),
                               jnp.int32(S0 + t))
        np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
        _check_cache(model_t, cache_t, cache_j)
    return got, toks


@pytest.mark.parametrize("arch", ["recurrentgemma", "gemma3"])
def test_decode_steps_match_reference_at_a_window_multiple(arch, rg16,
                                                           gemma16):
    """S0 = 32 = 2 × window 16: the ring holds the right rows, so the
    port's decode also equals its own prefill of the whole sequence (the
    reference's decode-matches-forward check)."""
    pair = {"recurrentgemma": rg16, "gemma3": gemma16}[arch]
    got, toks = _decode_against_reference(pair, 32)
    _, _, model_t, params_t = pair
    full, _ = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(got, full, **MODEL_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma", "gemma3"])
def test_decode_steps_match_reference_off_a_window_multiple(arch, rg16,
                                                            gemma16):
    """S0 = 40, window 16: the reference's ring evicts the wrong slots and
    its decode drifts from a full prefill; the port reproduces it step
    for step."""
    pair = {"recurrentgemma": rg16, "gemma3": gemma16}[arch]
    got, toks = _decode_against_reference(pair, 40)
    _, _, model_t, params_t = pair
    full, _ = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)})
    assert (got - full).abs().max().item() > 1e-2


def test_init_cache_is_the_empty_decode_cache(rg):
    """Decoding from ``init_cache`` equals prefilling one token, and the
    cache has the reference's shapes."""
    model_j, _, model_t, params_t = rg
    cache = model_t.init_cache(2, 8)
    want = model_j.init_cache(2, 8)
    for kind, idxs in group_layout(model_t.kinds).items():
        for li in idxs:
            for leaf, val in cache[li].items():
                assert tuple(val.shape) == want[kind][leaf].shape[1:]
                assert str(val.dtype).split(".")[1] \
                    == want[kind][leaf].dtype.name
    tok = torch.tensor([[3], [7]])
    got, _ = model_t.decode_step(params_t, cache, {"token": tok}, 0)
    ref, _ = model_t.prefill(params_t, {"tokens": tok})
    torch.testing.assert_close(got, ref, **MODEL_TOL)


def test_rec_has_no_paged_path(rg):
    _, _, model_t, params_t = rg
    with pytest.raises(ValueError, match="no paged cache spec"):
        PagedCache(model_t, 4, 9)
    with pytest.raises(ValueError, match="no paged decode path"):
        model_t.decode_paged(params_t, [None] * 3,
                             {"token": torch.zeros((1, 1), dtype=torch.long)},
                             torch.zeros(1, dtype=torch.long),
                             torch.zeros((1, 1), dtype=torch.long), page=4)


# ---------------------------------------------------------------------------
# Static-batch engine and launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S", [("recurrentgemma", 16),
                                    ("recurrentgemma", 20),
                                    ("gemma3", 16)])
def test_engine_greedy_tokens_equal_jax_engine(arch, S, rg16, gemma16):
    model_j, params_j, model_t, params_t = {"recurrentgemma": rg16,
                                            "gemma3": gemma16}[arch]
    prompts = RNG.integers(0, model_t.cfg.vocab_size, size=(3, S))
    want = JaxServeEngine(model_j, params_j, max_len=S + 8).generate(
        jnp.asarray(prompts, jnp.int32), 8)
    got = ServeEngine(model_t, params_t, max_len=S + 8).generate(
        torch.from_numpy(prompts), 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_serves_recurrentgemma_on_cpu():
    out = launch_serve.main(["--serve", "legacy", "--arch",
                             "recurrentgemma-9b", "--device", "cpu",
                             "--prompt-len", "64", "--new-tokens", "4"])
    assert out.shape == (4, 4)
    assert int(out.min()) >= 0 and int(out.max()) < 512
