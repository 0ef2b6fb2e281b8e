"""The port's long-sequence attention routes against the JAX package's on
the same numpy inputs (4 heads, head_dim 64): ``blocked_local_attention``
around its 2·window threshold (window 64 at S in {128, 129, 200, 256}),
``chunked_attention`` above the 2048-token threshold (S in {2049, 2100})
and at small chunk sizes, with and without a window, MHA and GQA. Forward
within 1e-5; gradients (of a random cotangent's inner product) against
``jax.grad`` within 1e-4 — the two frameworks sum in different orders,
and the online softmax rescales by other maxima. ``attention_fwd`` takes
the reference's route at every sequence length tested.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as L
from _torch_sim import one_thread  # noqa: F401

# one intra-op thread (tests/_torch_sim.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
H, HD = 4, 64


def _qkv(S, kvh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, S, H, HD)).astype(np.float32)
    k = rng.normal(size=(1, S, kvh, HD)).astype(np.float32)
    v = rng.normal(size=(1, S, kvh, HD)).astype(np.float32)
    ct = rng.normal(size=(1, S, H, HD)).astype(np.float32)
    return q, k, v, ct


def _both(jfn, tfn, S, kvh, seed, grads: bool):
    """Forward (and with ``grads`` the q, k, v gradients of <out, ct>)
    of the reference's ``jfn`` and the port's ``tfn``."""
    q, k, v, ct = _qkv(S, kvh, seed)

    def ref(q, k, v):
        # forward and gradients in one compiled function
        out, vjp = jax.vjp(jfn, q, k, v)
        return out, (vjp(jnp.asarray(ct)) if grads else None)

    want, jg = jax.jit(ref)(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(grads)
                  for a in (q, k, v))
    got = tfn(tq, tk, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD)
    if not grads:
        return
    tg = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                             (tq, tk, tv))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("S", [128, 129, 200, 256])
def test_blocked_local_equals_reference(S, kvh):
    """At S = 128 = 2·window the reference falls back to the quadratic
    form; above it, blocks of 64 (S = 129 and 200 padded)."""
    _both(functools.partial(jL.blocked_local_attention, window=64),
          functools.partial(L.blocked_local_attention, window=64), S, kvh,
          S + kvh, grads=True)


@pytest.mark.parametrize("S,window,kvh,grads", [
    (2049, None, 4, False), (2049, 700, 2, False), (2049, 700, 4, True),
    (2100, None, 2, True), (2100, 700, 4, False), (2100, None, 4, False)],
    ids=["2049-full-mha", "2049-window-gqa", "2049-window-mha-grad",
         "2100-full-gqa-grad", "2100-window-mha", "2100-full-mha"])
def test_chunked_equals_reference(S, window, kvh, grads):
    """The reference's chunks (q 512, k 1024): a padded last q chunk and a
    padded last KV chunk at both lengths, with and without a window
    (which skips the KV chunks below it), MHA and GQA; gradients at one
    case per length (the small-chunk cases below take them at every
    configuration)."""
    _both(functools.partial(jL.chunked_attention, causal=True,
                            window=window),
          functools.partial(L.chunked_attention, causal=True,
                            window=window), S, kvh, S + kvh, grads=grads)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_chunked_small_chunks_equals_reference(causal, window):
    """Many chunks at a small size: q 16, k 32 over S = 100 (the last of
    each padded), causal with and without a window, and non-causal (the
    padded keys masked by position)."""
    kw = dict(causal=causal, window=window, q_chunk=16, k_chunk=32)
    _both(functools.partial(jL.chunked_attention, **kw),
          functools.partial(L.chunked_attention, **kw), 100, 2, 7,
          grads=True)


def test_chunked_and_blocked_equal_full_attention():
    """Both routes compute the quadratic form's function."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(300, 2, 11))
    full = L.full_attention(q, k, v, causal=True, window=64)
    torch.testing.assert_close(
        L.blocked_local_attention(q, k, v, window=64), full, **FWD)
    torch.testing.assert_close(
        L.chunked_attention(q, k, v, window=64, q_chunk=64, k_chunk=128),
        full, **FWD)


def _routes(monkeypatch, module, zeros):
    """Replace ``module``'s three attention bodies by recorders that
    return zeros; returns the list of routes taken."""
    taken = []
    for name, route in (("full_attention", "full"),
                        ("chunked_attention", "chunked"),
                        ("blocked_local_attention", "blocked")):
        def rec(q, k, v, *a, _route=route, **kw):
            taken.append(_route)
            return zeros(q)
        monkeypatch.setattr(module, name, rec)
    return taken


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("window", [None, 64])
def test_attention_fwd_route_equals_reference(monkeypatch, window, blocked):
    jcfg = jget_config("gemma3-1b").reduced()
    tcfg = tget_config("gemma3-1b").reduced()
    p = jL.init_attention(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    jtaken = _routes(monkeypatch, jL, jnp.zeros_like)
    ttaken = _routes(monkeypatch, L, torch.zeros_like)
    rng = np.random.default_rng(0)
    for S in (128, 129, 200, 256, 2048, 2049, 2100):
        x = rng.normal(size=(1, S, jcfg.d_model)).astype(np.float32)
        # traced, not run: the route is picked while tracing
        jax.eval_shape(functools.partial(jL.attention_fwd, cfg=jcfg,
                                         window=window, blocked=blocked),
                       p, jnp.asarray(x))
        L.attention_fwd(tp, torch.from_numpy(x), cfg=tcfg, window=window,
                        blocked=blocked)
        assert ttaken[-1] == jtaken[-1] == L.attention_route(S, window,
                                                             blocked), S
    assert len(jtaken) == len(ttaken) == 7
