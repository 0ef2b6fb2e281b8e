"""The port's config registry against the JAX package's: every ported
config's fields equal the reference's ``CONFIG`` and its ``reduced()``;
the vlm and audio families are the ones not ported. Then the dense
configs this slice adds (deepseek-7b, starcoder2-15b, llama3-405b, each
reduced, f32) on the reference's weights: prefill logits and three
contiguous-cache decode steps within 1e-4 of the reference (the two
frameworks sum the einsums in different orders). starcoder2's window is
64 when reduced, and its prompt a multiple of it, where the reference's
ring buffer is right. Last, the launchers in process on the CPU: the
serving launcher on each new config, the training launcher on each new
train family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import NOT_PORTED
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild_model
from _torch_sim import one_thread  # noqa: F401

# one intra-op thread (tests/_torch_sim.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

PORTED = [a for a in ARCH_IDS + ["rps-paper-mlp"] if a not in NOT_PORTED]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_equal_reference(arch):
    for reduce in (False, True):
        cj, ct = jget_config(arch), tget_config(arch)
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert (ct.hd, ct.padded_vocab, ct.is_moe) == \
            (cj.hd, cj.padded_vocab, cj.is_moe)
        assert ct.torch_dtype == getattr(torch, cj.jnp_dtype.name)


def test_registry_covers_all_but_vlm_and_audio():
    assert sorted(NOT_PORTED) == sorted(
        a for a in ARCH_IDS if jget_config(a).family in ("vlm", "audio"))
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="not ported"):
            tget_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        tget_config("gpt-2")


@pytest.mark.parametrize("arch,S", [("deepseek-7b", 40),
                                    ("starcoder2-15b", 64),
                                    ("llama3-405b", 40)])
def test_prefill_and_decode_logits_equal_reference(arch, S):
    cfg_j, cfg_t = jget_config(arch).reduced(), tget_config(arch).reduced()
    model_j = jbuild_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = tbuild_model(cfg_t, device="cpu")
    assert model_t.kinds == model_j.kinds
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    steps = 3
    max_len = S + steps
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_t.vocab_size, size=(2, S))
    lj, cache_j = jax.jit(lambda p, t: model_j.prefill(
        p, {"tokens": t}, max_len=max_len))(params_j, jnp.asarray(toks))
    lt, cache_t = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)},
                                  max_len=max_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    decode_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    for pos in range(S, S + steps):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1))
        lj, cache_j = decode_j(params_j, cache_j, jnp.asarray(tok, jnp.int32),
                               pos)
        lt, cache_t = model_t.decode_step(params_t, cache_t,
                                          {"token": torch.from_numpy(tok)},
                                          pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-7b", "starcoder2-15b",
                                  "llama3-405b", "mixtral-8x22b",
                                  "kimi-k2-1t-a32b"])
def test_serve_launcher_runs_each_new_arch_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <id>`` (reduced, the
    launcher's default) on the CPU: continuous with lossy TP decode, and
    the static batch."""
    from repro_torch.launch import serve as serve_launcher
    rep = serve_launcher.main(
        ["--arch", arch, "--serve", "continuous", "--tp-shards", "4", "-p",
         "0.1", "--drain", "--requests", "3", "--new-tokens", "4",
         "--device", "cpu"])
    assert rep.tokens > 0 and len(rep.requests) == 3
    out = serve_launcher.main(["--arch", arch, "--batch", "2",
                               "--new-tokens", "3", "--device", "cpu",
                               "--layers", "1"])
    assert tuple(out.shape) == (2, 3)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "mixtral-8x22b"])
def test_train_launcher_trains_each_family_on_cpu(arch):
    """``python -m repro_torch.launch.train --arch <id> --reduced`` on the
    CPU, ring engine: finite losses, the history's plan."""
    from repro_torch.launch import train as train_launcher
    h = train_launcher.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--workers", "2", "--batch-size", "2",
                             "--seq-len", "16", "--engine", "ring",
                             "--device", "cpu", "--task-vocab", "64"])
    assert np.isfinite(h["loss"]).all() and h["exchange_plan"] is not None
