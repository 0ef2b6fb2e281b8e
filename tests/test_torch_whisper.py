"""The port's audio family (``models/whisper.py``'s ``enc`` and ``xattn``
kinds, the encoder stack in ``registry.py``) against the JAX package's,
on whisper-large-v3-reduced (d 256, 4 heads, 2 decoder and 2 encoder
layers, f32) with the reference's weights (``convert.params_from_jax``)
and ``make_batch`` inputs.

- ``Model.loss`` within 1e-5 of the reference's (relative), each
  gradient leaf within 1e-4 of its largest entry against
  ``jax.value_and_grad`` (the encoder stack's included);
- prefill logits and the four cache leaves of every layer (self K/V
  padded to ``max_len``, cross K/V) within 1e-4; then 4 decode steps,
  logits and caches within 1e-4 (the frameworks sum the einsums in
  different orders);
- ``ServeEngine``'s greedy tokens equal to the reference engine's, the
  encoder run once per ``generate`` (decode reads the cross K/V from the
  cache);
- the simulator, 3 steps at n = 4 on a ``make_batch`` stream (seed =
  step · n + worker), rps_model on the ring engine at p = 0.3, against
  ``repro.train.simulator.run_simulation`` with the reference's masks
  and initial parameters: losses within 1e-5, consensus within 1e-4;
- the paths the reference does not have refuse: the paged pool, the
  continuous engine, the training launcher's char-LM task.
"""
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
from repro_torch.serve import ContinuousEngine, ServeEngine
from _torch_sim import one_thread, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "whisper-large-v3"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch: dict) -> dict:
    return stacked_params_from_jax(_np(batch), "cpu")


@pytest.fixture(scope="module")
def whisper():
    cfg_j, cfg_t = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    model_t = tbuild_model(cfg_t, device="cpu")
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    params_t = params_from_jax(_np(params_j), cfg_t, device="cpu")
    return cfg_j, model_j, params_j, cfg_t, model_t, params_t


def test_layout_equals_reference(whisper):
    """The kinds, and the train layout leaf for leaf (the exchange's
    blocks fall on the same elements): init_stacked's shapes and dtypes
    in flatten order against the reference's init."""
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = whisper
    assert model_t.kinds == model_j.kinds == ["xattn"] * 2
    assert model_t.enc_kinds == ["enc"] * 2
    assert len(params_t["enc_layers"]) == 2
    assert sorted(params_t["layers"][0]) == ["attn", "ln1", "ln2", "lnx",
                                             "mlp", "xattn"]
    gen = torch.Generator()
    gen.manual_seed(0)
    tl = tree_lib.leaves(model_t.init_stacked(gen))
    jl = jax.tree.leaves(params_j)
    assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
    assert [str(x.dtype).removeprefix("torch.") for x in tl] == \
        [x.dtype.name for x in jl]


def test_model_loss_and_grads_equal_reference(whisper):
    cfg_j, model_j, params_j, cfg_t, model_t, _ = whisper
    batch = jinputs.make_batch(cfg_j, 2, 32, seed=1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: model_j.loss(p, batch), has_aux=True))(params_j)
    leaves, td = tree_lib.flatten(stacked_params_from_jax(_np(params_j),
                                                          "cpu"))
    for x in leaves:
        x.requires_grad_(True)
    tl, taux = model_t.loss(tree_lib.unflatten(td, leaves), _t(batch))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert taux["aux_loss"].item() == float(jaux["aux_loss"]) == 0.0
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < 1e-4


def _cache_close(cache_t: list, cache_j: dict):
    for i, layer in enumerate(cache_t):
        assert sorted(layer) == ["k", "v", "xk", "xv"]
        for leaf, got in layer.items():
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(cache_j["xattn"][leaf][i]),
                                       **TOL)


def test_prefill_and_decode_equal_reference(whisper):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = whisper
    S, steps = 24, 4
    max_len = S + steps
    batch = jinputs.make_batch(cfg_j, 2, S, seed=2)
    inputs_j = {"tokens": batch["tokens"], "frames": batch["frames"]}
    lj, cache_j = jax.jit(lambda p, x: model_j.prefill(
        p, x, max_len=max_len))(params_j, inputs_j)
    lt, cache_t = model_t.prefill(params_t, _t(inputs_j), max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert cache_t[0]["k"].shape[1] == max_len
    assert cache_t[0]["xk"].shape[1] == S // cfg_t.enc_frames_ratio
    _cache_close(cache_t, cache_j)
    decode_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    rng = np.random.default_rng(3)
    for pos in range(S, S + steps):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1))
        lj, cache_j = decode_j(params_j, cache_j, jnp.asarray(tok, jnp.int32),
                               pos)
        lt, cache_t = model_t.decode_step(
            params_t, cache_t, {"token": torch.from_numpy(tok)}, pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _cache_close(cache_t, cache_j)


def test_serve_engine_tokens_equal_reference_encoder_once(whisper):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = whisper
    S, n_new = 16, 6
    batch = jinputs.make_batch(cfg_j, 3, S, seed=4)
    want = JServeEngine(model_j, params_j, max_len=S + n_new).generate(
        batch["tokens"], n_new, extra_inputs={"frames": batch["frames"]})
    calls = []
    encode = model_t.encode

    def counted(*args, **kwargs):
        calls.append(1)
        return encode(*args, **kwargs)

    model_t.encode = counted
    try:
        eng = ServeEngine(model_t, params_t, max_len=S + n_new)
        extra = {"frames": _t(batch)["frames"]}
        toks = _t(batch)["tokens"]
        got = eng.generate(toks, n_new, extra_inputs=extra)
        assert len(calls) == 1
        again = eng.generate(toks, n_new, extra_inputs=extra)
        assert len(calls) == 2
    finally:
        model_t.encode = encode
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_paths_the_reference_lacks_refuse(whisper):
    cfg_j, model_j, params_j, cfg_t, model_t, params_t = whisper
    with pytest.raises(ValueError, match="no paged"):
        model_t.init_paged(64)
    with pytest.raises(ValueError, match="--serve legacy"):
        ContinuousEngine(model_t, params_t)
    from repro_torch.launch import train as train_launcher
    with pytest.raises(ValueError, match="frames"):
        train_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def _stream(make_batch, cfg, n, B, S, stack):
    def batch_fn(t):
        parts = [make_batch(cfg, B, S, t * n + i) for i in range(n)]
        return {k: stack([p[k] for p in parts]) for k in parts[0]}
    return batch_fn


def test_simulator_three_steps_equal_reference(whisper):
    """rps_model on the ring engine at p = 0.3, n = 4, batch 2, seq 16
    (8 frames), the reference's init and masks injected."""
    cfg_j, model_j, _, cfg_t, model_t, _ = whisper
    n = 4
    th, jh = run_both(
        dict(aggregator="rps_model", drop_rate=0.3, engine="ring", lr=0.05),
        lambda p, b: model_j.loss(p, b)[0], model_j.init,
        _stream(jinputs.make_batch, cfg_j, n, 2, 16, jnp.stack),
        lambda p, b: model_t.loss(p, b)[0],
        _stream(lambda c, B, S, s: tinputs.make_batch(c, B, S, s,
                                                      device="cpu"),
                cfg_t, n, 2, 16, torch.stack), n=n, steps=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert all(c > 0 for c in th["consensus"][1:])
