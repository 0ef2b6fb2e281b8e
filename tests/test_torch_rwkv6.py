"""The port's RWKV-6 slice against the JAX package's.

Kernel: the plain version and the wrapper's CPU route against
``rwkv6_pallas`` run in interpret mode over the JAX kernel tests' sweep
and tolerances (2e-4 f32, 0.1 bf16), and the final state against the
reference step folded over the sequence. Model: rwkv6-1.6b reduced
(2 layers, d 256, 4 heads of 64, f32) on weights carried across by
``params_from_jax``; prefill logits and cache and teacher-forced decode
steps within 1e-4 of ``build_model(cfg, grouped=False)``. Engine: the
port's ``ServeEngine`` gives the JAX ``ServeEngine``'s greedy tokens.
The CUDA kernel itself is compared on the card (marked ``cuda``; skips
here) and by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_pallas
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as K
from repro_torch.kernels.ref import rwkv6_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.registry import kind_sequence
from repro_torch.serve import PagedCache, ServeEngine

RNG = np.random.default_rng(0)
TOL = {"float32": 2e-4, "bfloat16": 0.1}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, S, h, dk, dv):
    """The JAX kernel tests' input distribution, as numpy f32."""
    r = RNG.normal(size=(B, S, h, dk)) * 0.5
    k = RNG.normal(size=(B, S, h, dk)) * 0.5
    v = RNG.normal(size=(B, S, h, dv)) * 0.5
    w = RNG.uniform(0.05, 0.995, size=(B, S, h, dk))
    u = RNG.normal(size=(h, dk)) * 0.1
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _both(arrays, dtype: str):
    """r, k, v, w in ``dtype`` and u in f32, as JAX arrays and as torch
    tensors (bf16 rounds from f32 identically in both)."""
    *rkvw, u = arrays
    js = [jnp.asarray(a, getattr(jnp, dtype)) for a in rkvw]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in rkvw]
    return js + [jnp.asarray(u)], ts + [torch.from_numpy(u)]


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _jax_fold(r, k, v, w, u):
    """The reference's final state: its decode step folded over S."""
    B, S, h, dk = r.shape
    state = jnp.zeros((B, h, dk, v.shape[-1]), jnp.float32)
    for t in range(S):
        _, state = jref.rwkv6_step_ref(r[:, t], k[:, t], v[:, t], w[:, t],
                                       u, state)
    return state


# ---------------------------------------------------------------------------
# Kernel module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(1, 16), (16, 16), (33, 16), (130, 32)])
@pytest.mark.parametrize("dk,dv", [(8, 8), (16, 32)])
def test_rwkv6_cpu_route_matches_pallas(S, chunk, dk, dv):
    """The plain version, the wrapper's CPU route and the ``ref`` backend
    against the Pallas kernel (the JAX kernel tests' sweep, f32)."""
    js, ts = _both(_inputs(2, S, 2, dk, dv), "float32")
    want = rwkv6_pallas(*js, chunk=chunk, interpret=True)
    for o, state in (rwkv6_ref(*ts), K.rwkv6(*ts),
                     ops.rwkv6(*ts, backend="ref")):
        assert o.dtype == torch.float32 and o.shape == (2, S, 2, dv)
        assert state.dtype == torch.float32 and state.shape == (2, 2, dk, dv)
        _close(o, want, TOL["float32"])


@pytest.mark.parametrize("S,dk,dv", [(32, 16, 16), (130, 64, 64)])
def test_rwkv6_bf16_matches_pallas(S, dk, dv):
    """bf16 inputs, output in bf16; (130, 64, 64) is the slice's head
    width."""
    js, ts = _both(_inputs(1, S, 2, dk, dv), "bfloat16")
    want = rwkv6_pallas(*js, chunk=16, interpret=True)
    o, _ = K.rwkv6(*ts)
    assert o.dtype == torch.bfloat16
    _close(o, want, TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,dk,dv", [(1, 8, 8), (33, 16, 32), (70, 64, 64)])
def test_final_state_equals_reference_fold(dtype, S, dk, dv):
    """The state the port returns beside o is the reference's fold of
    its decode step over the sequence (f32 either way)."""
    js, ts = _both(_inputs(2, S, 3, dk, dv), dtype)
    _, state = K.rwkv6(*ts)
    _close(state, _jax_fold(*js), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_step_matches_reference(dtype):
    r, k, v, w, u = (a[:, 0] if a.ndim == 4 else a
                     for a in _inputs(3, 1, 4, 16, 16))
    state = RNG.normal(size=(3, 4, 16, 16)).astype(np.float32)
    js, ts = _both([r, k, v, w, u], dtype)
    o_j, s_j = jops.rwkv6_step(*js, jnp.asarray(state))
    o_t, s_t = ops.rwkv6_step(*ts, torch.from_numpy(state))
    assert o_t.dtype == ts[0].dtype and s_t.dtype == torch.float32
    _close(o_t, o_j, 1e-5)
    _close(s_t, s_j, 1e-5)


def test_step_folds_to_the_sequence():
    """Stepping the decode recurrence S times gives the sequence's
    outputs and final state."""
    _, ts = _both(_inputs(1, 7, 2, 8, 8), "float32")
    r, k, v, w, u = ts
    o_full, s_full = K.rwkv6(*ts)
    state = torch.zeros((1, 2, 8, 8))
    for t in range(7):
        o, state = ops.rwkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u,
                                  state)
        torch.testing.assert_close(o, o_full[:, t], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, s_full, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_bad_inputs():
    r = torch.zeros((1, 4, 2, 8))
    v = torch.zeros((1, 4, 2, 8))
    u = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="k"):
        K.rwkv6(r, torch.zeros((1, 4, 2, 4)), v, r, u)
    with pytest.raises(ValueError, match="v must be"):
        K.rwkv6(r, r, torch.zeros((1, 3, 2, 8)), r, u)
    with pytest.raises(ValueError, match="u must be"):
        K.rwkv6(r, r, v, r, torch.zeros((8,)))
    with pytest.raises(ValueError, match="at least one step"):
        z = torch.zeros((1, 0, 2, 8))
        K.rwkv6(z, z, z, z, u)
    with pytest.raises(ValueError, match="backend"):
        ops.rwkv6(r, r, v, r, u, backend="pallas")


def test_cpu_route_does_not_count_launches():
    before = K.rwkv6.launches
    _, ts = _both(_inputs(1, 3, 2, 8, 8), "float32")
    K.rwkv6(*ts)
    assert K.rwkv6.launches == before


def _chunked_replay(r, k, v, w, u, chunk=64):
    """The chunked form of ``csrc/rwkv6.cu`` in plain torch, in f32:
    chunks of 64 tokens (S padded with r = k = v = 0, w = 1), la the
    inclusive sum of log2(clip(w, 1e-30, 1)) in a chunk; the pairwise decay
    inside blocks of 8 tokens, factored at the token before each 16-token
    sub-chunk for the earlier sub-chunks and at the 8th token within one
    (every exponent <= 0); the chunk states U_c and their scan; o = scores
    @ v + (r . exp2(la_prev)) @ S_in. Returns (o in r's dtype, state)."""
    f32 = torch.float32
    B, S, h, dk = r.shape
    dv = v.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def blocks(x, fill=0.0):   # (B, S, h, d) -> (B, h, nc, chunk, d)
        x = x.to(f32)
        if pad:
            x = torch.cat([x, torch.full((B, pad, h, x.shape[-1]), fill)], 1)
        return x.reshape(B, nc, chunk, h, -1).permute(0, 3, 1, 2, 4)

    rr, kk, vv = blocks(r), blocks(k), blocks(v)
    lw = torch.log2(blocks(w, 1.0).clamp(1e-30, 1.0))
    la = torch.cumsum(lw, dim=-2)                       # la[t]
    la_prev = torch.cat([torch.zeros_like(la[..., :1, :]),
                         la[..., :-1, :]], dim=-2)      # la[t - 1]
    la_c = la[..., -1:, :]
    U = (kk * torch.exp2(la_c - la)).transpose(-1, -2) @ vv
    state = torch.zeros((B, h, dk, dv))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp2(la_c[:, :, c, 0])[..., None] + U[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    scores = torch.zeros(rr.shape[:-1] + (chunk,))
    for t0 in range(16, chunk, 16):        # earlier sub-chunks
        ref = la[..., t0 - 1:t0, :]
        a = rr[..., t0:t0 + 16, :] * torch.exp2(la_prev[..., t0:t0 + 16, :]
                                                - ref)
        b = kk[..., :t0, :] * torch.exp2(ref - la[..., :t0, :])
        scores[..., t0:t0 + 16, :t0] = a @ b.transpose(-1, -2)
    for t0 in range(0, chunk, 16):         # the 8 x 8 block of a sub-chunk
        ref = la[..., t0 + 7:t0 + 8, :]
        a = rr[..., t0 + 8:t0 + 16, :] * torch.exp2(
            la_prev[..., t0 + 8:t0 + 16, :] - ref)
        b = kk[..., t0:t0 + 8, :] * torch.exp2(ref - la[..., t0:t0 + 8, :])
        scores[..., t0 + 8:t0 + 16, t0:t0 + 8] = a @ b.transpose(-1, -2)
    lower = torch.tril(torch.ones(8, 8, dtype=torch.bool), -1)
    for t0 in range(0, chunk, 8):          # pairwise, then the bonus
        sl = slice(t0, t0 + 8)
        diff = la_prev[..., sl, None, :] - la[..., None, sl, :]
        diff = torch.where(lower[..., None], diff, torch.tensor(-torch.inf))
        pair = (rr[..., sl, None, :] * kk[..., None, sl, :]
                * torch.exp2(diff)).sum(-1)
        bonus = (rr[..., sl, :] * u.to(f32)[None, :, None, None, :]
                 * kk[..., sl, :]).sum(-1)
        scores[..., sl, sl] = pair + torch.diag_embed(bonus)
    o = scores @ vv + (rr * torch.exp2(la_prev)) @ s_in
    o = o.permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, h, dv)[:, :S]
    return o.to(r.dtype), state


def _decays(arrays, kind):
    """The inputs with w replaced: the kernel tests' uniform (0.05, 0.995),
    or every w at 1e-30, 0.999 or 0."""
    r, k, v, w, u = arrays
    if kind != "uniform":
        w = np.full_like(w, {"tiny": 1e-30, "slow": 0.999, "zero": 0.0}[kind])
    return [r, k, v, w, u]


@pytest.mark.parametrize("S", [1, 33, 130])
@pytest.mark.parametrize("dk,dv", [(16, 32), (64, 64)])
@pytest.mark.parametrize("decay", ["uniform", "tiny", "slow"])
def test_chunked_replay_matches_reference_and_pallas(S, dk, dv, decay):
    """The kernel's chunked, sub-chunk-factored algebra against the
    sequential recurrence (o and state within 2e-4), f32, at extreme
    decays too, and against the Pallas kernel run in interpret mode (o
    within 2e-4) where that kernel is finite: at w = 1e-30 its (C, C, dk)
    decay tensor overflows above the diagonal before the mask (inf * 0),
    and its o is NaN."""
    js, ts = _both(_decays(_inputs(2, S, 2, dk, dv), decay), "float32")
    o, state = _chunked_replay(*ts)
    o_ref, s_ref = rwkv6_ref(*ts)
    assert o.shape == (2, S, 2, dv) and state.shape == (2, 2, dk, dv)
    torch.testing.assert_close(o, o_ref, atol=TOL["float32"],
                               rtol=TOL["float32"])
    torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=2e-4)
    want = np.asarray(rwkv6_pallas(*js, chunk=32, interpret=True))
    if decay == "tiny" and S > 1:
        assert np.isnan(want).any()     # the reference's overflow
    else:
        _close(o, want, TOL["float32"])


@pytest.mark.parametrize("S,dk,dv", [(33, 16, 32), (130, 64, 64)])
@pytest.mark.parametrize("decay", ["zero", "tiny", "uniform"])
def test_chunked_replay_bf16(S, dk, dv, decay):
    """bf16 inputs, w = 0 among them (clipped to 1e-30 before the log, as
    the TPU kernel does): o within 0.1 of the sequential recurrence, the
    f32 state within 2e-4; o within 0.1 of the Pallas kernel at the
    uniform decays, where that kernel is finite."""
    js, ts = _both(_decays(_inputs(1, S, 2, dk, dv), decay), "bfloat16")
    o, state = _chunked_replay(*ts)
    o_ref, s_ref = rwkv6_ref(*ts)
    assert o.dtype == torch.bfloat16
    _close(o, o_ref.float().numpy(), TOL["bfloat16"])
    torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=2e-4)
    if decay == "uniform":
        _close(o, rwkv6_pallas(*js, chunk=16, interpret=True),
               TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the CUDA kernel, its output and final state, against
    its plain version, at extreme decays too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [(2, 1, 2, 8, 8, "uniform"), (2, 33, 2, 16, 32, "uniform"),
             (2, 130, 4, 64, 64, "uniform"), (1, 17, 3, 20, 12, "uniform"),
             (2, 130, 2, 64, 64, "tiny"), (2, 130, 2, 64, 64, "slow"),
             (2, 70, 2, 16, 32, "zero")]
    for B, S, h, dk, dv, decay in cases:
        ts = [t.cuda() for t in _both(_decays(_inputs(B, S, h, dk, dv),
                                              decay), dtype)[1]]
        before = K.rwkv6.launches
        o, state = K.rwkv6(*ts)
        torch.cuda.synchronize()
        assert K.rwkv6.launches == before + 1
        o_ref, s_ref = rwkv6_ref(*ts)
        torch.testing.assert_close(o.float(), o_ref.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# Model: rwkv6-1.6b reduced, both packages on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv():
    cfg_j = jax_get_config("rwkv6-1.6b").reduced()
    cfg_t = get_config("rwkv6-1.6b").reduced()
    model_j = jax_build_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return model_j, params_j, model_t, params_t


def test_configs_agree():
    for reduce in (False, True):
        cj, ct = jax_get_config("rwkv6-1.6b"), get_config("rwkv6-1.6b")
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert ct.torch_dtype == getattr(torch, cj.jnp_dtype.name)
    red = get_config("rwkv6-1.6b").reduced()
    assert (red.n_layers, red.d_model, red.n_heads, red.hd, red.d_state) \
        == (2, 256, 4, 64, 64)


def test_kind_sequence_equals_reference(rwkv):
    model_j, _, model_t, _ = rwkv
    assert model_t.kinds == model_j.kinds == ["rwkv", "rwkv"]
    assert kind_sequence(get_config("rwkv6-1.6b")) == ["rwkv"] * 24


def _jax_prefill(model_j, params_j, toks):
    fn = jax.jit(lambda p, t: model_j.prefill(p, {"tokens": t}))
    return fn(params_j, jnp.asarray(toks, jnp.int32))


def _check_cache(cache_t, cache_j):
    for li, layer in enumerate(cache_t):
        for leaf in ("state", "shift_t", "shift_c"):
            _close(layer[leaf], cache_j["rwkv"][leaf][li],
                   MODEL_TOL["atol"])


@pytest.mark.parametrize("S", [1, 40])
def test_prefill_logits_and_cache(rwkv, S):
    model_j, params_j, model_t, params_t = rwkv
    toks = RNG.integers(0, model_t.cfg.vocab_size, size=(2, S))
    last_j, cache_j = _jax_prefill(model_j, params_j, toks)
    last_t, cache_t = model_t.prefill(params_t,
                                      {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               **MODEL_TOL)
    _check_cache(cache_t, cache_j)


def test_decode_steps_match_reference(rwkv):
    """Prefill 24 tokens, then 4 teacher-forced decode steps in both
    packages: logits and cache at every step; the port's last logits
    also equal its own prefill of the whole sequence (the reference's
    decode-matches-forward check)."""
    model_j, params_j, model_t, params_t = rwkv
    S0, K_ = 24, 4
    toks = RNG.integers(0, model_t.cfg.vocab_size, size=(2, S0 + K_))
    _, cache_j = _jax_prefill(model_j, params_j, toks[:, :S0])
    _, cache_t = model_t.prefill(params_t,
                                 {"tokens": torch.from_numpy(toks[:, :S0])})
    step_j = jax.jit(lambda p, c, t, pos: model_j.decode_step(
        p, c, {"token": t}, pos))
    for t in range(K_):
        tok = toks[:, S0 + t:S0 + t + 1]
        got, cache_t = model_t.decode_step(
            params_t, cache_t, {"token": torch.from_numpy(tok)}, S0 + t)
        want, cache_j = step_j(params_j, cache_j, jnp.asarray(tok, jnp.int32),
                               jnp.int32(S0 + t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        _check_cache(cache_t, cache_j)
    full, _ = model_t.prefill(params_t, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(got, full, **MODEL_TOL)


def test_init_cache_is_the_empty_decode_cache(rwkv):
    """Decoding from ``init_cache`` equals prefilling one token."""
    _, _, model_t, params_t = rwkv
    cache = model_t.init_cache(2, 8)
    assert cache[0]["state"].shape == (2, 4, 64, 64)
    tok = torch.tensor([[3], [7]])
    got, _ = model_t.decode_step(params_t, cache, {"token": tok}, 0)
    want, _ = model_t.prefill(params_t, {"tokens": tok})
    torch.testing.assert_close(got, want, **MODEL_TOL)


def test_rwkv_has_no_paged_path(rwkv):
    _, _, model_t, params_t = rwkv
    with pytest.raises(ValueError, match="no paged cache spec"):
        PagedCache(model_t, 4, 9)
    with pytest.raises(ValueError, match="no paged decode path"):
        model_t.decode_paged(params_t, [None, None],
                             {"token": torch.zeros((1, 1), dtype=torch.long)},
                             torch.zeros(1, dtype=torch.long),
                             torch.zeros((1, 1), dtype=torch.long), page=4)


# ---------------------------------------------------------------------------
# Static-batch engine and launcher
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_equal_jax_engine(rwkv):
    model_j, params_j, model_t, params_t = rwkv
    prompts = RNG.integers(0, model_t.cfg.vocab_size, size=(3, 12))
    want = JaxServeEngine(model_j, params_j, max_len=32).generate(
        jnp.asarray(prompts, jnp.int32), 8)
    got = ServeEngine(model_t, params_t, max_len=32).generate(
        torch.from_numpy(prompts), 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_is_deterministic(rwkv):
    """Greedy decoding repeats; sampling repeats for one generator seed
    and stays within the vocabulary."""
    _, _, model_t, params_t = rwkv
    prompts = torch.from_numpy(RNG.integers(0, model_t.cfg.vocab_size,
                                            size=(2, 10)))
    greedy = ServeEngine(model_t, params_t, max_len=24)
    torch.testing.assert_close(greedy.generate(prompts, 6),
                               greedy.generate(prompts, 6))
    hot = ServeEngine(model_t, params_t, max_len=24, temperature=1.5)
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        runs.append(hot.generate(prompts, 6, gen=gen))
    torch.testing.assert_close(runs[0], runs[1])
    assert int(runs[0].min()) >= 0
    assert int(runs[0].max()) < model_t.cfg.vocab_size


def test_engine_rejects_overflow(rwkv):
    _, _, model_t, params_t = rwkv
    eng = ServeEngine(model_t, params_t, max_len=32)
    with pytest.raises(ValueError, match=r"prompt_len 30 \+ n_new 8 = 38 "
                                         r"exceeds ServeEngine.max_len 32"):
        eng.generate(torch.zeros((1, 30), dtype=torch.long), 8)


def test_launcher_serves_legacy_on_cpu():
    out = launch_serve.main(["--serve", "legacy", "--arch", "rwkv6-1.6b",
                             "--device", "cpu"])
    assert out.shape == (4, 16)
    assert int(out.min()) >= 0 and int(out.max()) < 512
    # the dense kinds serve on the contiguous ring-buffer cache too
    dense = launch_serve.main(["--serve", "legacy", "--arch", "gemma3-1b",
                               "--device", "cpu"])
    assert dense.shape == (4, 16)
