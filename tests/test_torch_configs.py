"""The port's config registry against the JAX package's: every config's
fields equal the reference's ``CONFIG`` and its ``reduced()``, and the
registry builds every architecture. Then deepseek-7b, starcoder2-15b,
llama3-405b, whisper-large-v3 and llava-next-mistral-7b (each reduced,
f32) on the reference's weights: prefill logits and three
contiguous-cache decode steps within 1e-4 of the reference (the two
frameworks sum the einsums in different orders), the audio model's
frames and the vlm's patches from the reference's ``make_batch``.
starcoder2's window is 64 when reduced, and its prompt a multiple of
it, where the reference's ring buffer is right (llava's too: 48 tokens
after 16 patches). Last, the launchers in process on the CPU: the
serving launcher on each config these slices added (the vlm and audio
families on the static batch, their only path; the continuous engine
refuses them), the training launcher on each new train family.
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
from repro.models import inputs as jinputs
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild_model
from repro_torch.models.inputs import make_batch
from _torch_sim import one_thread  # noqa: F401

# one intra-op thread (tests/_torch_sim.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

PORTED = ARCH_IDS + ["rps-paper-mlp"]
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


@pytest.mark.parametrize("arch", PORTED)
def test_prefix_len_is_the_vlm_patch_rows(arch):
    """``Model.prefix_len``, where the engines start decoding after the
    prompt, is the vlm's ``n_patches`` and 0 in every other family, full
    and reduced (the reference's ``_embed_train`` puts patches before
    the tokens in the vlm alone)."""
    for cfg in (tget_config(arch), tget_config(arch).reduced()):
        want = cfg.n_patches if cfg.family == "vlm" else 0
        assert tbuild_model(cfg, device="cpu").prefix_len == want


def test_registry_covers_all_but_vlm_and_audio():
    """The registry now covers the vlm and audio families too: every
    architecture builds, with the reference's kinds, and runs one
    prefill."""
    assert T_ARCH_IDS == ARCH_IDS
    fams = {a: jget_config(a).family for a in ARCH_IDS}
    assert {"vlm", "audio"} <= set(fams.values())
    for arch in ARCH_IDS:
        cfg = tget_config(arch).reduced()
        model = tbuild_model(cfg, device="cpu")
        assert model.kinds == jbuild_model(jget_config(arch).reduced(),
                                           grouped=False).kinds
        if fams[arch] not in ("vlm", "audio"):
            continue
        gen = torch.Generator().manual_seed(0)
        params = model.init(gen)
        batch = make_batch(cfg, 2, 40, device="cpu")
        batch.pop("labels")
        last, _ = model.prefill(params, batch)
        assert last.shape == (2, cfg.vocab_size)
        assert torch.isfinite(last).all()
    with pytest.raises(KeyError, match="unknown arch"):
        tget_config("gpt-2")


@pytest.mark.parametrize("arch,S", [("deepseek-7b", 40),
                                    ("starcoder2-15b", 64),
                                    ("llama3-405b", 40),
                                    ("whisper-large-v3", 40),
                                    ("llava-next-mistral-7b", 64)])
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
    # S rows: the vlm's P patches before S - P tokens; the audio model's
    # S // 2 frames beside them
    P = cfg_t.n_patches if cfg_t.family == "vlm" else 0
    inputs = {"tokens": rng.integers(0, cfg_t.vocab_size, size=(2, S - P))}
    extra = jinputs.make_batch(cfg_j, 2, S, seed=0)
    inputs.update({k: v for k, v in extra.items()
                   if k in ("patches", "frames")})
    lj, cache_j = jax.jit(lambda p, x: model_j.prefill(
        p, x, max_len=max_len))(params_j, inputs)
    lt, cache_t = model_t.prefill(
        params_t, {k: torch.from_numpy(np.array(v))
                   for k, v in inputs.items()}, max_len=max_len)
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
                                  "kimi-k2-1t-a32b", "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_serve_launcher_runs_each_new_arch_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <id>`` (reduced, the
    launcher's default) on the CPU: continuous with lossy TP decode, and
    the static batch (the vlm and audio families: the static batch
    alone, at its default depth and cut to one decoder layer; the
    continuous engine refuses them, naming the legacy path)."""
    from repro_torch.launch import serve as serve_launcher
    if jget_config(arch).family in ("vlm", "audio"):
        with pytest.raises(ValueError, match="--serve legacy"):
            serve_launcher.main(["--arch", arch, "--serve", "continuous",
                                 "--drain", "--device", "cpu"])
        out = serve_launcher.main(["--arch", arch, "--serve", "legacy",
                                   "--device", "cpu"])
        assert tuple(out.shape) == (4, 16)
        out = serve_launcher.main(["--arch", arch, "--batch", "2",
                                   "--new-tokens", "3", "--device", "cpu",
                                   "--layers", "1"])
        assert tuple(out.shape) == (2, 3)
        return
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
