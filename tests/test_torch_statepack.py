"""The port's packed trainer state against the JAX package's, on the same
numpy-seeded inputs; the stochastic rounding takes the reference's own
uniforms (``jax.random.uniform`` of the key it folds per leaf), handed to
the port as an input.

The counterparts of tests/test_statepack.py at its sizes: the quant core
is the wire codec's grid, the f32 pack is a literal identity (the packed
optimizers under it are the textbook formulas, sgd invariant under every
pack), SR keeps the packed EMA unbiased where RNE stalls, the packed state
is updated in place and resumes bitwise, the state-bytes breakdown on
``meta`` tensors shows the ≥ 2x Adam reduction and equals
benchmarks/BENCH_state.json's section 1, and the launcher's
``--state-pack`` runs. The reference's launch/env.py tests have their
counterparts in tests/test_torch_env.py. A sync plan's ``ready_ms`` is None, and the
theory takes its sync path (the async schedule's tests are in
tests/test_torch_async.py).

Bitwise against the reference run op by op (``jax.disable_jit()``); the
jitted reference computes the scale ``amax / 127`` as ``amax * (1/127)``,
so against it the packs agree within rel 1e-5 of each row.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import statepack as jpack
from repro.train import simulator as jsim
from repro_torch import tree as tree_lib
from repro_torch.core import plan as tplan
from repro_torch.core import quant as tquant
from repro_torch.core import theory as ttheory
from repro_torch.core import wire as twire
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import statepack as tpack
from repro_torch.optim.statepack import (I8_LEVELS, canon_pack, is_packed_i8,
                                         make_state_pack, pack_tree,
                                         state_bytes_breakdown, tree_bytes,
                                         unpack_tree)
from repro_torch.telemetry import taps
from repro_torch.train import simulator as tsim
from repro_torch.launch.env import host_env

KEY = jax.random.PRNGKey(21)
ROOT = os.path.join(os.path.dirname(__file__), "..")
JIT_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _uniforms_fn(key):
    """The reference's per-leaf uniforms: uniform(fold_in(key, i))."""
    return lambda i, shape: _t(jax.random.uniform(
        jax.random.fold_in(key, i), shape))


def _lin_task(n=8, seed=0):
    """tests/test_statepack.py's linear task, in both packages."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, 16, 6)).astype(np.float32)
    w_true = rng.normal(size=(6, 4)).astype(np.float32)
    ys = xs @ w_true

    def jinit(key):
        return {"w": jax.random.normal(key, (6, 4)) * 0.1}

    def jloss(p, b):
        x, y = b
        return jnp.mean((x @ p["w"] - y) ** 2)

    def tloss(p, b):
        x, y = b
        return torch.mean((x @ p["w"] - y) ** 2)

    def tinit(gen):
        return {"w": torch.randn((6, 4), generator=gen) * 0.1}

    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    return (jloss, jinit, lambda t: (jx, jy)), \
        (tloss, tinit, lambda t: (tx, ty))


# ---- the shared quant core is the wire codec's grid -----------------------

def test_quant_core_matches_wire_codec_bitwise():
    """quant.quantize at the codec's level count is WireCodec.encode bit
    for bit, RNE and SR alike, and both equal the reference's."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(5, 64)) * 3.0).astype(np.float32)
    c = twire.make_codec("int8")
    u = _t(jax.random.uniform(KEY, x.shape))
    for uni, key in ((None, None), (u, KEY)):
        qw, dw = c.encode(_t(x), uniforms=uni)
        qq, dq = tquant.quantize(_t(x), I8_LEVELS, torch.int8,
                                 uniforms=uni, lead=0)
        assert torch.equal(qw, qq) and torch.equal(dw, dq)
        assert torch.equal(c.fake_quant(_t(x), uniforms=uni),
                           tquant.fake_quant(_t(x), I8_LEVELS, torch.int8,
                                             uniforms=uni, lead=0))
        with jax.disable_jit():
            jq, jd = jpack.quant_lib.quantize(jnp.asarray(x), I8_LEVELS,
                                              jnp.int8, key=key, lead=0)
        np.testing.assert_array_equal(qq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(dq.numpy(), np.asarray(jd))
    assert torch.equal(c.decode(qw, dw), tquant.dequantize(qw, dw))
    # consume=True: the same payload and scales, x overwritten
    y = _t(x).clone()
    qc, dc = tquant.quantize(y, I8_LEVELS, torch.int8, uniforms=u,
                             consume=True)
    assert torch.equal(qc, qq) and torch.equal(dc, dq)
    assert not torch.equal(y, _t(x))


def test_row_lead_and_block_delta_shapes():
    assert tquant.row_lead(1) == -1
    assert tquant.row_lead(2) == 0
    assert tquant.row_lead(3) == 1
    d3 = tquant.block_delta(torch.ones((4, 6, 8)), I8_LEVELS,
                            lead=tquant.row_lead(3))
    assert tuple(d3.shape) == (4, 6, 1)
    d1 = tquant.block_delta(torch.ones((8,)), I8_LEVELS,
                            lead=tquant.row_lead(1))
    assert tuple(d1.shape) == (1,)
    # zero blocks get a guard delta, and quantize maps them to exact zero
    q, d = tquant.quantize(torch.zeros((2, 8)), I8_LEVELS, torch.int8)
    assert not q.any() and bool((d > 0).all())


# ---- StatePack registry and round-trips -----------------------------------

def test_state_pack_registry_and_aliases():
    assert canon_pack(None) == "f32" == canon_pack("none") \
        == canon_pack("float32") == canon_pack("F32")
    assert canon_pack("int8") == "i8" and canon_pack("bfloat16") == "bf16"
    pk = make_state_pack("i8")
    assert (pk.m_format, pk.v_format, pk.ef_format) == ("bf16", "i8", "i8")
    assert not pk.is_identity and make_state_pack().is_identity
    for name in tpack.PACKS:
        assert make_state_pack(name).describe() == \
            jpack.make_state_pack(name).describe()
    assert tpack.PACKS == jpack.PACKS
    with pytest.raises(ValueError, match="unknown state pack"):
        canon_pack("fp4")


def test_pack_tree_f32_is_a_literal_identity():
    t = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones((4,))}
    assert pack_tree(t, "f32") is t
    assert unpack_tree(t, "f32") is t


def test_pack_tree_bf16_and_i8_roundtrip():
    """The reference's roundtrip test, and the port's packs equal the
    reference's bit for bit with its per-leaf uniforms."""
    rng = np.random.default_rng(7)
    t = {"a": (rng.normal(size=(4, 32)) * 2.0).astype(np.float32),
         "b": rng.normal(size=(3, 5, 16)).astype(np.float32)}
    tt = tree_lib.map(torch.from_numpy, t)
    jt = jax.tree.map(jnp.asarray, t)
    pb = pack_tree(tt, "bf16")
    assert all(x.dtype == torch.bfloat16 for x in tree_lib.leaves(pb))
    ub = unpack_tree(pb, "bf16")
    for a, b in zip(tree_lib.leaves(tt), tree_lib.leaves(ub)):
        assert torch.equal(a.to(torch.bfloat16).float(), b)
    pi = pack_tree(tt, "i8", noise=_uniforms_fn(KEY))
    assert is_packed_i8(pi) and not is_packed_i8(tt)
    assert pi["q"]["a"].dtype == torch.int8
    assert tuple(pi["scale"]["a"].shape) == (4, 1)   # per-row, keepdims
    assert tuple(pi["scale"]["b"].shape) == (3, 5, 1)
    with jax.disable_jit():
        jpi = jpack.pack_tree(jt, "i8", key=KEY)
    for a, b in zip(tree_lib.leaves(pi), jax.tree.leaves(jpi)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ui = unpack_tree(pi, "i8")
    for name in t:
        err = np.abs(ui[name].numpy() - t[name])
        step = np.broadcast_to(pi["scale"][name].numpy(), t[name].shape)
        assert np.all(err <= step + 1e-7)
    # the jitted reference: the same payload, scales within rel 1e-5
    jji = jax.jit(lambda x: jpack.pack_tree(x, "i8", key=KEY))(jt)
    np.testing.assert_array_equal(pi["q"]["b"].numpy(),
                                  np.asarray(jji["q"]["b"]))
    np.testing.assert_allclose(pi["scale"]["b"].numpy(),
                               np.asarray(jji["scale"]["b"]),
                               rtol=JIT_RTOL, atol=0)
    # zeros pack exactly: the packed EF start is still the zero residual
    z = {"a": torch.zeros((4, 32)), "b": torch.zeros((3, 5, 16))}
    uz = unpack_tree(pack_tree(z, "i8", noise=_uniforms_fn(KEY)), "i8")
    assert all(not x.any() for x in tree_lib.leaves(uz))


@pytest.mark.parametrize("fmt", ["bf16", "i8"])
@pytest.mark.parametrize("shape", [(7,), (3, 40), (2, 3, 9), (4, 2, 3, 5)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_pack_leaf_equals_reference(fmt, shape, stochastic):
    """pack_leaf / unpack_leaf against the reference's on one leaf, with
    a zero row and a row of one repeated value, RNE and SR."""
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32) * 3.0
    x.reshape(-1, shape[-1])[0] = 0.0
    if x.ndim > 1:
        x.reshape(-1, shape[-1])[-1] = 0.25
    key = jax.random.PRNGKey(len(shape) + 3) if stochastic else None
    u = _t(jax.random.uniform(key, shape)) if stochastic else None
    with jax.disable_jit():
        jrep = jpack.pack_leaf(jnp.asarray(x), fmt, key=key)
        jback = jpack.unpack_leaf(jrep, fmt)
    rep = tpack.pack_leaf(_t(x), fmt, uniforms=u)
    assert len(rep) == len(jrep)
    for a, b in zip(rep, jrep):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    np.testing.assert_array_equal(tpack.unpack_leaf(rep, fmt).numpy(),
                                  np.asarray(jback))


# ---- the packed optimizers ------------------------------------------------

def test_packed_optimizers_f32_bit_identical_to_formulas():
    """Under the f32 identity pack the optimizers are the textbook update
    bit for bit, noise given or not."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.normal(size=(6, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(4,)).astype(
            np.float32))}
    grads = {"w": torch.from_numpy(rng.normal(size=(6, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(4,)).astype(
            np.float32))}
    lr = 0.07
    gen = torch.Generator().manual_seed(0)

    opt = tmake_optimizer("momentum", state_pack="f32")
    p = tree_lib.map(torch.clone, params)
    st = opt.init(p)
    p, st = opt.update(grads, st, p, lr, noise=gen)
    p, st = opt.update(grads, st, p, lr)
    m_ref = tree_lib.map(torch.zeros_like, params)
    p_ref = params
    for _ in range(2):
        m_ref = tree_lib.map(lambda m, g: 0.9 * m + g, m_ref, grads)
        p_ref = tree_lib.map(lambda q, m: q - lr * m, p_ref, m_ref)
    for a, b in zip(tree_lib.leaves((p, st)), tree_lib.leaves((p_ref,
                                                                m_ref))):
        assert torch.equal(a, b)

    b1, b2, eps = 0.9, 0.999, 1e-8
    opt = tmake_optimizer("adam", state_pack="f32")
    p = tree_lib.map(torch.clone, params)
    st = opt.init(p)
    m_ref = tree_lib.map(torch.zeros_like, params)
    v_ref = tree_lib.map(torch.zeros_like, params)
    p_ref = params
    for t in (1, 2, 3):
        p, st = opt.update(grads, st, p, lr, noise=gen)
        m_ref = tree_lib.map(lambda m, g: b1 * m + (1 - b1) * g, m_ref,
                             grads)
        v_ref = tree_lib.map(lambda v, g: b2 * v + (1 - b2) * (g * g),
                             v_ref, grads)
        bc1 = 1 - torch.tensor(b1) ** torch.tensor(float(t))
        bc2 = 1 - torch.tensor(b2) ** torch.tensor(float(t))
        p_ref = tree_lib.map(
            lambda q, m, v: q - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
            p_ref, m_ref, v_ref)
    for a, b in zip(tree_lib.leaves((p, st["m"])),
                    tree_lib.leaves((p_ref, m_ref))):
        assert torch.equal(a, b)
    assert int(st["t"]) == 3


def test_adam_init_distinct_buffers_under_identity_pack():
    """m and v come from two distinct zero trees: the in-place update
    must not write one moment into the other."""
    st = tmake_optimizer("adam").init({"w": torch.ones((3, 4))})
    assert st["m"]["w"] is not st["v"]["w"]
    assert st["m"]["w"].data_ptr() != st["v"]["w"].data_ptr()


def _opt_noise(key):
    """The reference's optimizer uniforms: m from fold_in(key, 0x6d), v
    from fold_in(key, 0x76), each per leaf fold_in(·, i)."""
    tags = {"m": 0x6d, "v": 0x76}

    def noise(which, i, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, tags[which]), i)
        return _t(jax.random.uniform(k, shape))

    return noise


@pytest.mark.parametrize("name", ["momentum", "adam"])
@pytest.mark.parametrize("pack", ["bf16", "i8"])
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_packed_optimizers_equal_reference(name, pack, jit):
    """Three packed updates of stacked (n = 4) leaves with a zero row:
    bit for bit against the reference run op by op on its uniforms, and
    within rel 1e-5 of each row against the jitted reference (its scale
    is a product by 1/127). The i8 Adam floors the denominator at one grid
    step; its scales have the reference's shapes."""
    rng = np.random.default_rng(11)
    params = {"w": rng.normal(size=(4, 6, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(4, 5)).astype(np.float32)},
              "s": rng.normal(size=(4,)).astype(np.float32)}
    jo = jmake_optimizer(name, state_pack=pack)
    to = tmake_optimizer(name, state_pack=pack)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_lib.map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jo.init(jp), to.init(tp)
    upd = jax.jit(jo.update) if jit else jo.update
    for step in range(3):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        g["w"][1] = 0.0
        g["w"][2, 3] = 1e-6          # far below its row's max
        key = jax.random.fold_in(KEY, step)
        with jax.disable_jit(not jit):
            jp, js = upd(jax.tree.map(jnp.asarray, g), js, jp,
                         jnp.float32(0.05), key=key)
        tp, ts = to.update(tree_lib.map(torch.from_numpy, g), ts, tp, 0.05,
                           noise=_opt_noise(key))
        for a, b in zip(tree_lib.leaves((tp, ts)), jax.tree.leaves((jp, js))):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape
            a = a.float().numpy()
            b = b.astype(np.float32)
            if not jit:
                np.testing.assert_array_equal(a, b)
            else:
                scale = np.maximum(np.abs(b).max(axis=-1, keepdims=True),
                                   1e-30) if b.ndim else abs(b)
                assert np.all(np.abs(a - b) <= JIT_RTOL * scale + 1e-12)
    if pack == "i8" and name == "adam":
        assert tuple(ts["v"]["scale"]["w"].shape) == (4, 6, 1)
        assert tuple(ts["v"]["scale"]["s"].shape) == (1,)


def test_packed_update_is_in_place():
    """The packed state is updated in its own storage (the port's form of
    the reference's donation): after two steps every packed buffer and
    every parameter lives where it started."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 6, 4)).astype(
        np.float32))}
    for name in ("momentum", "adam"):
        opt = tmake_optimizer(name, state_pack="i8")
        st = opt.init(params)
        before = [x.data_ptr() for x in tree_lib.leaves((params, st))
                  if x.dim()]
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            g = {"w": torch.randn((4, 6, 4), generator=gen)}
            params, st = opt.update(g, st, params, 0.1, noise=gen)
        after = [x.data_ptr() for x in tree_lib.leaves((params, st))
                 if x.dim()]
        assert before == after


def test_sgd_invariant_under_every_pack():
    """sgd carries no state: no pack moves a bit of the trajectory."""
    _, (loss_fn, init_fn, batch_fn) = _lin_task()
    base = dict(n_workers=8, drop_rate=0.2, steps=8, lr=0.2, warmup=2,
                aggregator="rps_model", wire="int8", recovery="renorm",
                eval_every=4)
    runs = {pk: tsim.run_simulation(
        loss_fn, init_fn, batch_fn,
        tsim.SimulatorConfig(**base, state_pack=pk), device="cpu")
        for pk in ("f32", "bf16", "i8")}
    for pk in ("bf16", "i8"):
        assert torch.equal(runs["f32"]["params"]["w"], runs[pk]["params"]["w"])


def test_simulator_f32_pack_alias_parity_matrix():
    """Every f32 spelling is the same run, bit for bit, across stateful
    optimizer x EF configurations."""
    _, (loss_fn, init_fn, batch_fn) = _lin_task(n=4, seed=1)
    for opt_name, wire in (("momentum", "f32"), ("adam", "int8")):
        base = dict(n_workers=4, drop_rate=0.25, steps=6, lr=0.1,
                    warmup=2, aggregator="rps_model", optimizer=opt_name,
                    wire=wire, recovery="ef", n_buckets=2, eval_every=3)
        ref = tsim.run_simulation(loss_fn, init_fn, batch_fn,
                                  tsim.SimulatorConfig(**base), device="cpu")
        for spell in ("f32", "none", "float32"):
            h = tsim.run_simulation(
                loss_fn, init_fn, batch_fn,
                tsim.SimulatorConfig(**base, state_pack=spell), device="cpu")
            for a, b in zip(tree_lib.leaves(ref["state"]),
                            tree_lib.leaves(h["state"])):
                assert torch.equal(a, b) if torch.is_tensor(a) else a == b


# ---- SR keeps the packed EMA unbiased where RNE stalls --------------------

def test_sr_packed_ema_unbiased_where_rne_stalls():
    step = 2.0 / I8_LEVELS
    m = torch.cat([torch.full((1, 1), 2.0), torch.full((1, 7), 64 * step)],
                  dim=1)
    assert torch.equal(unpack_tree(pack_tree(m, "i8"), "i8"), m)
    inc = 1e-3                                    # << step/2 ~ 7.9e-3
    bump = torch.cat([torch.zeros((1, 1)), torch.full((1, 7), inc)], dim=1)
    target = m + bump
    # RNE: the sub-half-step write is absorbed: the packed EMA stalls
    assert torch.equal(unpack_tree(pack_tree(target, "i8"), "i8"), m)
    gen = torch.Generator().manual_seed(11)
    draws = torch.stack([unpack_tree(pack_tree(target, "i8", noise=gen),
                                     "i8") for _ in range(4096)])
    mean = draws.mean(0)
    torch.testing.assert_close(mean, target, atol=3e-4, rtol=0)
    assert (mean - m).abs()[0, 1:].min() > 5e-4, \
        "SR mean must move off the stalled RNE value"


# ---- bytes accounting -----------------------------------------------------

def _meta(shapes):
    return {k: torch.empty(v, dtype=torch.float32, device="meta")
            for k, v in shapes.items()}


def test_state_bytes_breakdown_adam_i8_at_least_2x():
    """On meta tensors (nothing allocated): packed Adam state (m bf16, v
    int8 + f32 row scales) is >= 2x smaller than f32 m/v, and every
    component equals the reference's eval_shape accounting."""
    shapes = {"emb": (512, 256), "mlp": (4, 256, 512)}
    params = _meta(shapes)
    jparams = {k: jax.ShapeDtypeStruct(v, jnp.float32)
               for k, v in shapes.items()}
    out = {}
    for pk in ("f32", "bf16", "i8"):
        st = tmake_optimizer("adam", state_pack=pk).init(params)
        assert all(x.device.type in ("meta", "cpu")
                   for x in tree_lib.leaves(st))
        out[pk] = state_bytes_breakdown(params=params, opt_state=st)
        jst = jax.eval_shape(jmake_optimizer("adam", state_pack=pk).init,
                             jparams)
        assert out[pk] == jpack.state_bytes_breakdown(params=jparams,
                                                      opt_state=jst)
    f32, i8 = out["f32"], out["i8"]
    pbytes = tree_bytes(params)
    assert f32["params"] == i8["params"] == pbytes
    opt_f32 = f32["opt_m"] + f32["opt_v"] + f32["opt_t"]
    opt_i8 = i8["opt_m"] + i8["opt_v"] + i8["opt_v_scales"] + i8["opt_t"]
    assert opt_f32 == 2 * pbytes + 4
    assert opt_f32 >= 2 * opt_i8, (opt_f32, opt_i8)
    assert i8["opt_m"] == pbytes // 2
    assert i8["opt_v"] == pbytes // 4
    assert 0 < i8["opt_v_scales"] < i8["opt_v"]
    assert i8["total"] == sum(v for k, v in i8.items() if k != "total")


def test_state_bytes_breakdown_ef_and_plain_trees():
    ef = {"w": torch.zeros((8, 16))}
    out = state_bytes_breakdown(ef_state=pack_tree(ef, "i8"))
    assert out["ef"] == 8 * 16 and out["ef_scales"] == 8 * 4
    assert state_bytes_breakdown(ef_state=ef)["ef"] == 8 * 16 * 4
    st = tmake_optimizer("momentum", state_pack="i8").init(ef)
    assert state_bytes_breakdown(opt_state=st)["opt_m"] == 8 * 16 * 2


def test_state_bytes_equal_bench_state_section_1():
    """benchmarks/BENCH_state.json section 1 (the reference's committed
    ~107M-parameter Adam accounting), recomputed on meta tensors: every
    component of every pack, the EF residual's too, exactly."""
    with open(os.path.join(ROOT, "benchmarks", "BENCH_state.json")) as f:
        bench = json.load(f)["state_bytes"]
    d, layers, vocab = 768, 12, 32768          # state_bench._bench_model
    shapes = {"emb": (vocab, d), "head": (d, vocab)}
    for i in range(layers):
        shapes[f"w1_{i}"] = (d, 4 * d)
        shapes[f"w2_{i}"] = (4 * d, d)
    params = _meta(shapes)
    assert sum(x.numel() for x in params.values()) == bench["n_params"] \
        == 106_954_752
    assert tree_bytes(params) == bench["param_bytes"]
    for pk in ("f32", "bf16", "i8"):
        st = tmake_optimizer("adam", state_pack=pk).init(params)
        bd = state_bytes_breakdown(opt_state=st)
        ef = pack_tree(tree_lib.map(torch.zeros_like, params),
                       make_state_pack(pk).ef_format)
        bd.update({f"ef_{k}": v for k, v in
                   state_bytes_breakdown(ef_state=ef).items()
                   if k != "total"})
        assert bd == bench[pk], pk
    assert bench["i8"]["total"] == 321_182_724


def test_simulator_history_reports_state_bytes():
    _, (loss_fn, init_fn, batch_fn) = _lin_task(n=4)
    h = tsim.run_simulation(loss_fn, init_fn, batch_fn, tsim.SimulatorConfig(
        n_workers=4, drop_rate=0.2, steps=3, lr=0.1,
        aggregator="rps_model", optimizer="adam", state_pack="i8",
        wire="int8", recovery="ef", n_buckets=2), device="cpu")
    sb = h["state_bytes"]
    assert sb["opt_m"] > 0 and sb["opt_v_scales"] > 0 and sb["ef"] > 0
    assert sb["total"] == sum(v for k, v in sb.items() if k != "total")
    assert h["state"]["opt_state"]["m"]["w"].dtype == torch.bfloat16
    assert h["state"]["opt_state"]["v"]["q"]["w"].dtype == torch.int8
    assert h["ef_state"]["q"]["w"].dtype == torch.int8


def test_plan_ready_ms_is_none_and_theory_takes_the_sync_path():
    """The port's plans carry the reference's ``ready_ms`` field, None
    (sync), so theory.async_bucket_drop_rates keeps every bucket at the
    channel's stationary marginal, as the reference's sync plan does."""
    from repro.core import plan as jplan
    from repro.core import theory as jtheory
    from repro_torch.channels import make_channel as tmake_channel
    from repro import channels as jchannels
    tree = {"a": torch.zeros((24,)), "b": torch.zeros((8, 2))}
    tp = tplan.make_plan(tree, 4, n_buckets=2)
    jp = jplan.make_plan({"a": jnp.zeros((24,)), "b": jnp.zeros((8, 2))}, 4,
                         n_buckets=2)
    assert tp.ready_ms is None is jp.ready_ms
    spec = "deadline:deadline_ms=10,base_ms=1,jitter_ms=3"
    np.testing.assert_array_equal(
        ttheory.async_bucket_drop_rates(tp, tmake_channel(spec, 4)),
        jtheory.async_bucket_drop_rates(jp, jchannels.make_channel(spec, 4)))


# ---- resume and the reference's simulator ---------------------------------

def test_packed_state_resume_is_bitwise(tmp_path):
    """Mid-run, the packed bundle (bf16 m, int8 payloads, f32 scales)
    round-trips through torch.save / torch.load bit for bit, and the run
    resumed from it ends with the uninterrupted run's params, optimizer
    state and residual (masks injected; the packs' noise from a hook of
    the step)."""
    _, (loss_fn, init_fn, batch_fn) = _lin_task(seed=3)
    gen = torch.Generator().manual_seed(7)
    # one leaf: the two-bucket plan has one bucket, its own mask draw
    masks = [(torch.rand((1, 8, 8), generator=gen) > 0.25,
              torch.rand((1, 8, 8), generator=gen) > 0.25) for _ in range(9)]

    def noise(t, which, i, shape):
        g = torch.Generator().manual_seed(1000 * t + 10 * i + len(which))
        return torch.rand(shape, generator=g)

    def wire(t, g_idx, shape):
        return noise(t, "wire", g_idx, shape)

    def cfg(steps):
        return tsim.SimulatorConfig(
            n_workers=8, drop_rate=0.25, aggregator="rps_model", steps=steps,
            lr=0.2, wire="int8", recovery="ef", n_buckets=2,
            optimizer="adam", state_pack="i8")

    kw = dict(device="cpu", init_params=init_fn(gen),
              masks_fn=lambda t: masks[t], wire_noise_fn=wire,
              pack_noise_fn=noise)
    full = tsim.run_simulation(loss_fn, None, batch_fn, cfg(9), **kw)
    half = tsim.run_simulation(loss_fn, None, batch_fn, cfg(5), **kw)
    assert half["state"]["opt_state"]["m"]["w"].dtype == torch.bfloat16
    path = tmp_path / "mid.pt"
    torch.save(half["state"], path)
    restored = torch.load(path)
    for a, b in zip(tree_lib.leaves(half["state"]),
                    tree_lib.leaves(restored)):
        assert a is b is None or (a.dtype == b.dtype and torch.equal(a, b))
    resumed = tsim.run_simulation(loss_fn, None, batch_fn, cfg(9),
                                  state=restored, start_step=5, **kw)
    for a, b in zip(tree_lib.leaves((full["params"], full["state"])),
                    tree_lib.leaves((resumed["params"], resumed["state"]))):
        assert a is b is None or torch.equal(a, b)


def _reference_inputs(jinit, scfg):
    """The reference simulator's initial parameters, per-step masks and
    uniforms (simulator.py: key = split(PRNGKey(seed))[1], kt =
    fold_in(key, t); the wire's fold_in(fold_in(kt, 'wire'), g); the
    packs' opt_key = fold_in(kt, 'pak') then fold_in(·, 0x6d / 0x76) and
    the leaf; the residual's fold_in(fold_in(kt, 'ef'), leaf))."""
    from repro import channels as jchannels
    key = jax.random.PRNGKey(scfg.seed)
    k_init, key = jax.random.split(key)
    p1 = jinit(k_init)
    channel = jchannels.make_channel(scfg.channel, scfg.n_workers,
                                     scfg.drop_rate, s=scfg.n_servers)
    ch_state = channel.init_state(jax.random.fold_in(key, 0x636831))
    plan = jsim.make_exchange_plan(p1, scfg, channel)
    masks = []
    for t in range(scfg.steps):
        kt = jax.random.fold_in(key, t)
        if plan.per_bucket_masks:
            rs, ag, ch_state = channel.sample_packets(kt, ch_state,
                                                      plan.n_buckets)
        else:
            rs, ag, ch_state = channel.sample(kt, ch_state)
        masks.append((_t(rs), _t(ag)))

    def wire(t, g_idx, shape):
        kt = jax.random.fold_in(key, t)
        k = jax.random.fold_in(jax.random.fold_in(kt, 0x77697265), g_idx)
        return _t(jax.random.uniform(k, shape))

    def pack(t, which, i, shape):
        kt = jax.random.fold_in(key, t)
        if which == "ef":
            k = jax.random.fold_in(kt, 0x6566)
        else:
            k = jax.random.fold_in(jax.random.fold_in(kt, 0x70616b),
                                   {"m": 0x6d, "v": 0x76}[which])
        return _t(jax.random.uniform(jax.random.fold_in(k, i), shape))

    return p1, masks, wire, pack


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam", state_pack="i8", wire="int8", recovery="ef",
         n_buckets=2, channel="ge:p_bad=0.6,burst=3,p=0.25"),
    dict(optimizer="momentum", state_pack="i8", wire="int8", recovery="ef"),
    dict(optimizer="adam", state_pack="bf16", wire="bf16", recovery="ef",
         engine="ring"),
    dict(optimizer="adam", state_pack="i8", aggregator="rps_grad",
         engine="ring", n_buckets=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simulator_packed_state_matches_reference(kw):
    """The simulator with packed state on the reference's initial
    parameters, masks (its channel's draws), wire noise and pack noise,
    against the reference run op by op: the per-step loss and consensus
    within 1e-6 over 6 steps, and the final params, optimizer state and
    EF residual (at rest, in the pack's format) within 1e-6."""
    (jloss, jinit, jbatch), (tloss, _, tbatch) = _lin_task(n=8, seed=2)
    base = dict(n_workers=8, drop_rate=0.25, steps=6, eval_every=1, lr=0.1,
                warmup=2, seed=0, aggregator="rps_model")
    base.update(kw)
    jscfg = jsim.SimulatorConfig(**base)
    with jax.disable_jit():
        jh = jsim.run_simulation(jloss, jinit, jbatch, jscfg)
    p1, masks, wire, pack = _reference_inputs(jinit, jscfg)
    th = tsim.run_simulation(
        tloss, None, tbatch, tsim.SimulatorConfig(**base), device="cpu",
        init_params=tree_lib.map(_t, p1), masks_fn=lambda t: masks[t],
        wire_noise_fn=wire, pack_noise_fn=pack)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(th["consensus"], jh["consensus"], rtol=1e-6,
                               atol=1e-12)
    for a, b in zip(tree_lib.leaves((th["params"], th["state"]["opt_state"],
                                     th["ef_state"])),
                    jax.tree.leaves((jh["params"], jh["state"]["opt_state"],
                                     jh["ef_state"]))):
        b = np.asarray(b).astype(np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-6,
                                   atol=1e-6)
    assert th["state_bytes"] == jh["state_bytes"]


def test_quant_error_norm_equals_reference():
    """The quantisation-error norm the reference's telemetry reports
    (quant_err_<tap>), and pack_tree's tap of it under a collector
    (nothing tapped without one)."""
    rng = np.random.default_rng(5)
    t = {"a": rng.normal(size=(4, 32)).astype(np.float32),
         "b": rng.normal(size=(3, 5, 16)).astype(np.float32)}
    with jax.disable_jit():
        jp = jpack.pack_tree(jax.tree.map(jnp.asarray, t), "i8", key=KEY)
        want = float(jpack.quant_error_norm(jax.tree.map(jnp.asarray, t),
                                            jp, "i8"))
    tp = pack_tree(tree_lib.map(torch.from_numpy, t), "i8",
                   noise=_uniforms_fn(KEY), tap="ef")
    got = float(tpack.quant_error_norm(tree_lib.map(torch.from_numpy, t),
                                       tp, "i8"))
    assert got == pytest.approx(want, rel=1e-6)
    with taps.tap_collector() as col:
        pack_tree(tree_lib.map(torch.from_numpy, t), "i8",
                  noise=_uniforms_fn(KEY), tap="ef")
    assert set(col.tree()) == {"quant_err_ef"}
    assert float(col.tree()["quant_err_ef"]) == got


# ---- launch CLI -----------------------------------------------------------

def test_launch_train_cli_state_pack_flag():
    """--state-pack / --optimizer reach the simulator; the state-bytes
    line shows up for packed runs (one intra-op thread: the suite runs
    it beside other workers)."""
    env = dict(os.environ, **host_env(threads=1))
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rps-paper-mlp", "--reduced", "--workers", "4", "--steps", "3",
         "--batch-size", "4", "--seq-len", "16", "--drop-rate", "0.2",
         "--buckets", "2", "--wire", "int8", "--recovery", "ef",
         "--optimizer", "adam", "--state-pack", "int8", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "state bytes [int8]" in r.stdout, r.stdout
    assert "opt_v_scales=" in r.stdout, r.stdout
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("n=4 s=4 p=0.2 agg=rps_model final_loss=")
