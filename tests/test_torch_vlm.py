"""The port's vlm family (the dense Mistral backbone with patch embeddings
before the tokens, ``registry.py``'s ``_embed`` and the patch rows
dropped before the head) against the JAX package's, on
llava-next-mistral-7b-reduced (d 256, 4 heads, 2 layers at window 64, 16
patches, f32) with the reference's weights and ``make_batch`` inputs.

- ``Model.loss`` within 1e-5 (relative), each gradient leaf within 1e-4
  of its largest entry against ``jax.value_and_grad``;
- prefill logits and every layer's ring-buffer K/V within 1e-4, then 4
  decode steps from position S + P within 1e-4;
- the reference's decode-position fault, on the reference alone: its
  ``ServeEngine`` decodes the first token at position S (the prompt's
  length) where prefill wrote S + P rows, so its first decode logits
  differ from its own prefill over [patches; prompt; token]; decoding
  at S + P agrees (window 16 here, S + P = 32, a multiple of it);
- the port's ``ServeEngine``, which starts at S + P: its greedy tokens
  equal those of the reference's ``prefill`` / ``decode_step`` driven
  from S + P, with S + P = 64 the window (where the contiguous ring
  buffer is right);
- the simulator, 3 steps at n = 4 on a ``make_batch`` stream, against
  ``repro.train.simulator.run_simulation`` with the reference's masks
  and initial parameters: losses within 1e-5, consensus within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import inputs as jinputs
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, stacked_params_from_jax
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import inputs as tinputs
from repro_torch.serve import ServeEngine
from _torch_sim import one_thread, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch: dict) -> dict:
    return stacked_params_from_jax(_np(batch), "cpu")


@pytest.fixture(scope="module")
def vlm():
    cfg_j, cfg_t = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    model_t = tbuild_model(cfg_t, device="cpu")
    assert model_t.kinds == model_j.kinds == ["attn@64"] * 2
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    params_t = params_from_jax(_np(params_j), cfg_t, device="cpu")
    return cfg_j, model_j, params_j, cfg_t, model_t, params_t


def test_model_loss_and_grads_equal_reference(vlm):
    cfg_j, model_j, params_j, cfg_t, model_t, _ = vlm
    batch = jinputs.make_batch(cfg_j, 2, 40, seed=1)
    assert batch["tokens"].shape == (2, 40 - cfg_j.n_patches)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: model_j.loss(p, batch), has_aux=True))(params_j)
    leaves, td = tree_lib.flatten(stacked_params_from_jax(_np(params_j),
                                                          "cpu"))
    for x in leaves:
        x.requires_grad_(True)
    tl, _ = model_t.loss(tree_lib.unflatten(td, leaves), _t(batch))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / max(np.abs(w).max(),
                                                 1e-12) < 1e-4


def test_prefill_and_decode_equal_reference(vlm):
    """A 48-token prompt after the 16 patches: 64 rows, the window."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = vlm
    S, P, steps = 48, cfg_t.n_patches, 4
    batch = jinputs.make_batch(cfg_j, 2, S + P, seed=2)
    inputs_j = {"tokens": batch["tokens"], "patches": batch["patches"]}
    lj, cache_j = jax.jit(lambda p, x: model_j.prefill(
        p, x, max_len=S + P + steps))(params_j, inputs_j)
    lt, cache_t = model_t.prefill(params_t, _t(inputs_j),
                                  max_len=S + P + steps)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    decode_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    rng = np.random.default_rng(3)
    for pos in range(S + P, S + P + steps):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1))
        lj, cache_j = decode_j(params_j, cache_j, jnp.asarray(tok, jnp.int32),
                               pos)
        lt, cache_t = model_t.decode_step(
            params_t, cache_t, {"token": torch.from_numpy(tok)}, pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for i, layer in enumerate(cache_t):
        for leaf in ("k", "v"):
            assert layer[leaf].shape[1] == cfg_t.window
            np.testing.assert_allclose(
                layer[leaf].numpy(), np.asarray(cache_j["attn@64"][leaf][i]),
                **TOL)


def test_reference_engine_decodes_at_the_wrong_position():
    """The fault, on the reference alone: window 16, 16 patches, a
    16-token prompt. Its engine's first decode (at pos = S) against its
    prefill over the prompt plus the engine's first token differs by
    far more than a decode at pos = S + P does."""
    cfg = dataclasses.replace(jget_config(ARCH).reduced(), window=16)
    model = jbuild_model(cfg, grouped=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    S, P = 16, cfg.n_patches
    batch = jinputs.make_batch(cfg, 2, S + P, seed=5)
    eng = JServeEngine(model, params, max_len=S + 4)
    seen = []
    decode = eng._decode

    def spy(p, cache, token, pos):
        seen.append((int(pos), np.asarray(token)))
        out = decode(p, cache, token, pos)
        seen[-1] += (np.asarray(out[0]),)
        return out

    eng._decode = spy
    eng.generate(batch["tokens"], 1, extra_inputs={"patches":
                                                   batch["patches"]})
    pos, tok0, engine_logits = seen[0]
    assert pos == S                       # prefill wrote S + P rows
    ext = {"tokens": jnp.concatenate([batch["tokens"], tok0], axis=1),
           "patches": batch["patches"]}
    want, _ = jax.jit(model.prefill)(params, ext)
    want = np.asarray(want)
    # decoding at S + P, the position prefill's rows lead to
    _, cache = jax.jit(lambda p, x: model.prefill(p, x, max_len=S + P + 4))(
        params, {"tokens": batch["tokens"], "patches": batch["patches"]})
    right, _ = jax.jit(lambda p, c, t, q: model.decode_step(
        p, c, {"token": t}, q))(params, cache, jnp.asarray(tok0), S + P)
    wrong_err = np.abs(engine_logits - want).max()
    right_err = np.abs(np.asarray(right) - want).max()
    assert right_err < 1e-4
    assert wrong_err > 0.1 and wrong_err > 1e3 * right_err


def test_port_engine_tokens_equal_reference_driven_at_s_plus_p(vlm):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = vlm
    P, n_new = cfg_t.n_patches, 6
    S = cfg_t.window - P                     # S + P = the window
    batch = jinputs.make_batch(cfg_j, 3, S + P, seed=6)
    max_len = S + P + n_new
    last, cache = jax.jit(lambda p, x: model_j.prefill(
        p, x, max_len=max_len))(params_j, {"tokens": batch["tokens"],
                                           "patches": batch["patches"]})
    decode_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    want = []
    for i in range(n_new):
        want.append(np.asarray(tok))
        logits, cache = decode_j(params_j, cache, tok, S + P + i)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    eng = ServeEngine(model_t, params_t, max_len=max_len)
    tb = _t(batch)
    got = eng.generate(tb["tokens"], n_new,
                       extra_inputs={"patches": tb["patches"]})
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))
    with pytest.raises(ValueError, match=f"{P} patches"):
        ServeEngine(model_t, params_t, max_len=max_len - 1).generate(
            tb["tokens"], n_new, extra_inputs={"patches": tb["patches"]})


def _stream(make_batch, cfg, n, B, S, stack):
    def batch_fn(t):
        parts = [make_batch(cfg, B, S, t * n + i) for i in range(n)]
        return {k: stack([p[k] for p in parts]) for k in parts[0]}
    return batch_fn


def test_simulator_three_steps_equal_reference(vlm):
    """rps_model on the ring engine at p = 0.3, n = 4, batch 2, S = 32
    (16 patches + 16 tokens), the reference's init and masks injected."""
    cfg_j, model_j, _, cfg_t, model_t, _ = vlm
    n = 4
    th, jh = run_both(
        dict(aggregator="rps_model", drop_rate=0.3, engine="ring", lr=0.05),
        lambda p, b: model_j.loss(p, b)[0], model_j.init,
        _stream(jinputs.make_batch, cfg_j, n, 2, 32, jnp.stack),
        lambda p, b: model_t.loss(p, b)[0],
        _stream(lambda c, B, S, s: tinputs.make_batch(c, B, S, s,
                                                      device="cpu"),
                cfg_t, n, 2, 32, torch.stack), n=n, steps=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert all(c > 0 for c in th["consensus"][1:])
