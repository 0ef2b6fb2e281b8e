"""The port's training slice against the JAX package's, on the same
numpy-seeded inputs: the optimizers, the synthetic data, the dense train
mode, the exchange on a real model tree, and the n-worker simulator with
the reference's initial parameters and per-step drop masks injected
(``init_params=``, ``masks_fn=``), drawn the way simulator.py draws them.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.data import synthetic as jdata
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import simulator as jsim
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import stacked_params_from_jax
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.data import synthetic as tdata
from repro_torch.models import build_model as tbuild_model
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.train import simulator as tsim
from _torch_sim import mlp_init, mlp_loss_j, mlp_loss_t, run_both

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _torch(np_tree):
    return stacked_params_from_jax(np_tree, "cpu")


# ---- optimizers -------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_updates_equal_reference(name):
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
    jopt, topt = jmake_optimizer(name), tmake_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = {"w": rng.normal(size=(5, 3)).astype(np.float32),
             "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
        lr = 0.1 * (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(lr))
        tp, ts = topt.update(_torch(g), ts, tp, lr)
        for a, b in zip(jax.tree.leaves(jp), tree_lib.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


def test_sgd_keeps_bf16_params_bf16():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    jp = {"w": jnp.ones(4, jnp.bfloat16)}
    want, _ = jmake_optimizer("sgd").update(
        {"w": jnp.full((4,), 0.5, jnp.bfloat16)}, (), jp, jnp.float32(0.3))
    got, _ = tmake_optimizer("sgd").update(g, (), p, 0.3)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"], np.float32))


def test_optimizer_not_ported_state_pack_raises():
    # the packs are ported (tests/test_torch_statepack.py); a pack the
    # reference does not know raises as it does there
    for pack in ("f32", "bf16", "i8"):
        tmake_optimizer("adam", state_pack=pack)
    with pytest.raises(ValueError, match="unknown state pack"):
        tmake_optimizer("adam", state_pack="fp4")


# ---- data -------------------------------------------------------------------

@pytest.mark.parametrize("seed,hetero", [(0, 0.3), (3, 0.1)])
def test_teacher_batches_bitwise(seed, hetero):
    jt = jdata.TeacherTask(d_in=24, n_classes=8, hetero=hetero, seed=seed)
    tt = tdata.TeacherTask(d_in=24, n_classes=8, hetero=hetero, seed=seed,
                           device="cpu")
    jb, tb = jdata.make_worker_streams(jt, 4, 32), \
        tdata.make_worker_streams(tt, 4, 32)
    for step in (0, 1, 17):
        (jx, jy), (tx, ty) = jb(step), tb(step)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert ty.dtype == torch.int32
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("vocab,seq", [(64, 16), (256, 33), (2048, 9)])
def test_char_lm_batches_bitwise(vocab, seq):
    jt = jdata.CharLMTask(vocab=vocab, seq_len=seq, seed=2)
    tt = tdata.CharLMTask(vocab=vocab, seq_len=seq, seed=2, device="cpu")
    jb, tb = jdata.make_worker_streams(jt, 3, 5), \
        tdata.make_worker_streams(tt, 3, 5)
    for step in (0, 4):
        a, b = jb(step), tb(step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].shape == (3, 5, seq)
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    assert tt.entropy_floor() == jt.entropy_floor()
    first = next(tdata.char_lm_stream(tt, 1, 5))
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  np.asarray(jt.batch(1, 0, 5)["tokens"]))


# ---- the dense train mode -----------------------------------------------------

def _dense_pair(arch, dtype=None):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jm, tm = jbuild_model(jcfg, grouped=False), tbuild_model(tcfg,
                                                              device="cpu")
    return jcfg, jm, tm


@pytest.mark.parametrize("arch", ["rps-paper-mlp", "gemma3-1b"])
def test_dense_loss_and_grads_equal_reference(arch):
    jcfg, jm, tm = _dense_pair(arch)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves, treedef = tree_lib.flatten(_torch(_np(jp)))
    for x in leaves:
        x.requires_grad_(True)
    tl, aux = tm.loss(tree_lib.unflatten(treedef, leaves),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(aux["aux_loss"]) == 0.0
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g.numpy() - w).max() / scale < 1e-5


def test_init_stacked_layout_matches_reference():
    jcfg, jm, tm = _dense_pair("rps-paper-mlp")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tm.init_stacked(gen)
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jl, _ = jax.tree.flatten(jshapes)
    tl = tree_lib.leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert [str(x.dtype).removeprefix("torch.") for x in tl] == \
        [x.dtype.name for x in jl]
    # the same init scale: the token embedding is N(0, 1), the head
    # N(0, 1/d)
    assert abs(tp["embed"]["tok"].std().item() - 1.0) < 0.05
    d = jcfg.d_model
    assert abs(tp["embed"]["head"].std().item() * d ** 0.5 - 1.0) < 0.05


def test_non_dense_train_mode_raises():
    tm = tbuild_model(tget_config("rwkv6-1.6b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="train mode"):
        tm.loss({}, {})


# ---- the exchange on a real model tree ---------------------------------------

@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("bucket_mb", [None, 0.1])
def test_model_tree_exchange_equals_reference(engine, bucket_mb):
    """rps-paper-mlp.reduced parameters stacked for n = 4, integer-valued,
    carried across in the stacked layout: one model-mode exchange equals
    the reference's bitwise (per-leaf plan; a bucket_mb plan with
    per-bucket masks). Pins the leaf order and the layout."""
    n = 4
    jcfg, jm, _ = _dense_pair("rps-paper-mlp")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    x = jax.tree.map(lambda s: rng.integers(-5, 6, (n,) + s.shape)
                     .astype(np.float32), shapes)
    jp = jplan.plan_from_config(shapes, n, bucket_mb=bucket_mb)
    tp = tplan.plan_from_config(
        tree_lib.map(lambda a: torch.empty(a.shape[1:], device="meta"),
                     _torch(x)), n, bucket_mb=bucket_mb)
    assert tp.describe() == jp.describe()
    nb = jp.n_buckets if jp.per_bucket_masks else None
    rs, ag = jrps.sample_masks(jax.random.PRNGKey(5), n, 0.3, n_buckets=nb)
    want = jrps.rps_exchange_global(jax.tree.map(jnp.asarray, x),
                                    jax.random.PRNGKey(0), 0.3, n,
                                    masks=(rs, ag), plan=jp, engine=engine)
    got = trps.rps_exchange_global(
        _torch(x), None, 0.3, n, masks=(torch.from_numpy(np.array(rs)),
                                        torch.from_numpy(np.array(ag))),
        plan=tp, engine=engine)
    for g, w in zip(tree_lib.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the simulator ------------------------------------------------------------

_mlp_init, _mlp_loss_j, _mlp_loss_t = mlp_init, mlp_loss_j, mlp_loss_t
_run_both = run_both


@pytest.mark.parametrize("kw", [
    dict(aggregator="rps_model", drop_rate=0.3, engine="xla"),
    dict(aggregator="rps_model", drop_rate=0.3, engine="ring"),
    dict(aggregator="rps_grad", drop_rate=0.3, engine="xla"),
    dict(aggregator="rps_grad", drop_rate=0.3, engine="ring"),
    dict(aggregator="allreduce_model"),
    dict(aggregator="allreduce_grad"),
    dict(aggregator="local"),
    dict(aggregator="rps_model", drop_rate=0.3, engine="ring",
         exchange_every=2),
    dict(aggregator="rps_model", drop_rate=0.3, engine="ring", n_buckets=2),
    dict(aggregator="rps_model", drop_rate=0.3, engine="ring",
         recovery="scale", optimizer="momentum"),
    dict(aggregator="rps_model", drop_rate=0.3, engine="ring",
         n_servers=8),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simulator_matches_reference_mlp(kw):
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    th, jh = _run_both(kw, _mlp_loss_j, _mlp_init,
                       jdata.make_worker_streams(jtask, 4, 16), _mlp_loss_t,
                       tdata.make_worker_streams(ttask, 4, 16))
    if kw["aggregator"] in ("rps_model", "rps_grad", "local"):
        assert th["consensus"][-1] > 0


@pytest.mark.parametrize("kw", [
    dict(wire="int8", engine="xla"),
    dict(wire="int8", engine="ring"),
    dict(wire="int8", engine="ring", aggregator="rps_grad"),
    dict(wire="int8", engine="ring", n_buckets=2),
    dict(recovery="ef", engine="ring"),
    dict(recovery="ef", wire="bf16", engine="xla"),
    dict(recovery="ef", wire="bf16", engine="ring", eager=True),
    dict(recovery="ef", wire="int8", engine="xla"),
    dict(recovery="ef", wire="int8", engine="ring"),
    dict(recovery="ef", wire="int8", engine="ring", exchange_every=3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simulator_int8_and_ef_match_reference_mlp(kw):
    """The int8 wire (the reference's uniforms injected) and the ef
    recovery on the f32, bf16 and int8 wires: per-step loss and consensus
    within 1e-4 over 10 steps. The bf16 wire's ring engine against the
    reference run op by op: jitted, XLA:CPU keeps the ring's bf16 adds in
    f32 (tests/test_torch_ring.py), and the ef feedback carries that
    difference forward (measured 1.9e-4 on the loss by step 10)."""
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    kw = dict(kw)
    eager = kw.pop("eager", False)
    base = dict(aggregator="rps_model", drop_rate=0.3)
    base.update(kw)
    th, jh = _run_both(base, _mlp_loss_j, _mlp_init,
                       jdata.make_worker_streams(jtask, 4, 16), _mlp_loss_t,
                       tdata.make_worker_streams(ttask, 4, 16), steps=10,
                       eager=eager)
    assert th["consensus"][-1] > 0
    if kw.get("recovery") == "ef":
        for a, b, x in zip(tree_lib.leaves(th["ef_state"]),
                           jax.tree.leaves(jh["ef_state"]),
                           tree_lib.leaves(th["params"])):
            # at the bf16 wire a parameter one f32 ulp apart (XLA fuses
            # the jitted update) can round to the other side of a bf16
            # tie: one bf16 step of the parameter
            atol = 2.0 ** -8 * float(x.abs().max()) \
                if kw.get("wire") == "bf16" else 1e-6
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=atol)
    else:
        assert th["ef_state"] is None


def test_simulator_matches_reference_dense_model():
    """The launcher's model (rps-paper-mlp, reduced) on the char-LM task,
    rps_model on the ring engine: per-step loss and consensus."""
    jcfg, jm, tm = _dense_pair("rps-paper-mlp")
    jtask = jdata.CharLMTask(vocab=jcfg.vocab_size, seq_len=16, seed=0)
    ttask = tdata.CharLMTask(vocab=jcfg.vocab_size, seq_len=16, seed=0,
                             device="cpu")
    _run_both(dict(aggregator="rps_model", drop_rate=0.3, engine="ring",
                   lr=0.05),
              lambda p, b: jm.loss(p, b)[0], jm.init,
              jdata.make_worker_streams(jtask, 4, 2),
              lambda p, b: tm.loss(p, b)[0],
              tdata.make_worker_streams(ttask, 4, 2), steps=3)


def test_simulator_own_draws_and_history():
    """Without hooks the port draws its own init and masks from seeded
    generators: runs are repeatable, and the history has the reference's
    keys."""
    task = tdata.TeacherTask(d_in=24, n_classes=8, seed=0, device="cpu")

    def init_fn(gen):
        return {"w1": torch.randn((24, 48), generator=gen) * 0.1,
                "w2": torch.randn((48, 8), generator=gen) * 0.1}

    scfg = tsim.SimulatorConfig(n_workers=4, drop_rate=0.2, steps=4,
                                eval_every=2, engine="ring")
    runs = [tsim.run_simulation(_mlp_loss_t, init_fn,
                                tdata.make_worker_streams(task, 4, 8), scfg,
                                device="cpu") for _ in range(2)]
    for key in ("step", "loss", "consensus", "eval", "final_loss",
                "params", "channel", "channel_effective_p",
                "exchange_plan"):
        assert key in runs[0]
    assert runs[0]["step"] == [0, 2, 3]
    assert runs[0]["loss"] == runs[1]["loss"]
    assert runs[0]["params"]["w1"].shape == (4, 24, 48)


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="async"), None),
    (dict(telemetry=True), None),
    (dict(corruption="signflip:frac=0.1"), None),
    (dict(byzantine_frac=0.25), None),
    (dict(recovery="median"), None),
    (dict(recovery="trimmed"), None),
    (dict(recovery="clip"), None),
    (dict(donate=False), "donate"),
])
def test_simulator_not_ported_fields_raise(kw, match):
    """donate=False still raises (the port updates in place by design).
    The async schedule, telemetry, the corruption processes and the
    robust recoveries are ported: each runs rps_model at p = 0.3 on the
    teacher MLP against the reference, with its draws injected (per-step
    loss and consensus to 1e-4, staleness and corrupt_frac equal; under
    telemetry a record per step with the reference's keys,
    tests/test_torch_telemetry.py holds their values)."""
    if match is not None:
        scfg = tsim.SimulatorConfig(n_workers=2, steps=1, **kw)
        with pytest.raises(NotImplementedError, match=match):
            tsim.run_simulation(_mlp_loss_t, None, None, scfg,
                                device="cpu")
        return
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    th, jh = _run_both(dict(aggregator="rps_model", drop_rate=0.3, **kw),
                       _mlp_loss_j, _mlp_init,
                       jdata.make_worker_streams(jtask, 4, 16), _mlp_loss_t,
                       tdata.make_worker_streams(ttask, 4, 16))
    if "schedule" in kw:
        assert th["staleness"] == [0.0] * 5     # no latency model
    if "corruption" in kw or "byzantine_frac" in kw:
        assert len(th["corrupt_frac"]) == 5
    if "telemetry" in kw:
        assert len(th.records) == len(jh.records) == 5
        assert [set(r) for r in th.records] == [set(r) for r in jh.records]


# ---- the launcher ------------------------------------------------------------

def test_train_launcher_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rps-paper-mlp", "--reduced", "--steps", "3", "--workers", "4",
         "--device", "cpu", "--engine", "ring"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("n=4 s=4 p=0.1 agg=rps_model final_loss=")
    assert "entropy floor" in last and "consensus=" in last


def test_train_launcher_runs_int8_ef_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rps-paper-mlp", "--reduced", "--steps", "3", "--workers", "4",
         "--device", "cpu", "--engine", "ring", "--wire", "int8",
         "--recovery", "ef"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "wire=int8/ef (rs_bytes_ratio=0.25)" in r.stdout
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("n=4 s=4 p=0.1 agg=rps_model final_loss=")


def _teacher_setup():
    task = tdata.TeacherTask(d_in=24, n_classes=8, seed=0, device="cpu")

    def init_fn(gen):
        return {"w1": torch.randn((24, 48), generator=gen) * 0.1,
                "w2": torch.randn((48, 8), generator=gen) * 0.1}

    return init_fn, tdata.make_worker_streams(task, 4, 8)


def test_simulator_resume_from_state_is_exact():
    """state= / start_step= continue a run exactly (the masks injected,
    as the port's own generators restart with the run)."""
    init_fn, batch_fn = _teacher_setup()
    gen = torch.Generator()
    gen.manual_seed(5)
    masks = [trps.sample_masks(gen, 4, 0.3) for _ in range(4)]
    p1 = init_fn(gen)
    scfg = tsim.SimulatorConfig(n_workers=4, steps=4, eval_every=1,
                                optimizer="momentum", engine="ring")
    kw = dict(device="cpu", init_params=p1, masks_fn=lambda t: masks[t])
    full = tsim.run_simulation(_mlp_loss_t, None, batch_fn, scfg, **kw)
    half = tsim.run_simulation(
        _mlp_loss_t, None, batch_fn,
        tsim.SimulatorConfig(n_workers=4, steps=2, eval_every=1,
                             optimizer="momentum", engine="ring"), **kw)
    rest = tsim.run_simulation(_mlp_loss_t, None, batch_fn, scfg,
                               state=half["state"], start_step=2, **kw)
    assert half["loss"] + rest["loss"] == full["loss"]
    for a, b in zip(tree_lib.leaves(rest["params"]),
                    tree_lib.leaves(full["params"])):
        assert torch.equal(a, b)


def test_simulator_ef_resume_is_exact_and_skipped_rounds_keep_residual():
    """The EF residual rides in ``state``: a run resumed from step 2
    ends with the full run's params and residual, bit for bit (int8 wire,
    deterministic under ef; the masks injected). With exchange_every = 2
    the residual after the skipped step 1 is step 0's, bit for bit."""
    init_fn, batch_fn = _teacher_setup()
    gen = torch.Generator()
    gen.manual_seed(6)
    masks = [trps.sample_masks(gen, 4, 0.3) for _ in range(4)]
    p1 = init_fn(gen)
    kw = dict(device="cpu", init_params=p1, masks_fn=lambda t: masks[t])

    def cfg(steps, every=1):
        return tsim.SimulatorConfig(n_workers=4, steps=steps, eval_every=1,
                                    engine="ring", wire="int8",
                                    recovery="ef", exchange_every=every)

    full = tsim.run_simulation(_mlp_loss_t, None, batch_fn, cfg(4), **kw)
    half = tsim.run_simulation(_mlp_loss_t, None, batch_fn, cfg(2), **kw)
    assert set(half["state"]) >= {"params", "opt_state", "ch_state",
                                  "ef_state"}
    rest = tsim.run_simulation(_mlp_loss_t, None, batch_fn, cfg(4),
                               state=half["state"], start_step=2, **kw)
    assert half["loss"] + rest["loss"] == full["loss"]
    for a, b in zip(tree_lib.leaves((rest["params"], rest["ef_state"])),
                    tree_lib.leaves((full["params"], full["ef_state"]))):
        assert torch.equal(a, b)
    assert any(x.abs().max() > 0 for x in tree_lib.leaves(full["ef_state"]))
    one = tsim.run_simulation(_mlp_loss_t, None, batch_fn, cfg(1, 2), **kw)
    two = tsim.run_simulation(_mlp_loss_t, None, batch_fn, cfg(2, 2), **kw)
    for a, b in zip(tree_lib.leaves(one["ef_state"]),
                    tree_lib.leaves(two["ef_state"])):
        assert torch.equal(a, b)
    assert not torch.equal(one["params"]["w1"], two["params"]["w1"])


def test_simulator_int8_noise_has_its_own_generator():
    """Without hooks an int8 run draws its rounding noise from its own
    generator: it sees the f32 run's masks (the same channel state at the
    end), and repeats itself."""
    init_fn, batch_fn = _teacher_setup()
    runs = {}
    for wire in ("f32", "int8", "int8"):
        scfg = tsim.SimulatorConfig(n_workers=4, drop_rate=0.3, steps=3,
                                    eval_every=1, engine="ring", wire=wire)
        seen = []
        real = tsim.rps_lib.rps_exchange_global

        def spy(*a, **k):
            seen.append(k["masks"])
            return real(*a, **k)

        tsim.rps_lib.rps_exchange_global = spy
        try:
            h = tsim.run_simulation(_mlp_loss_t, init_fn, batch_fn, scfg,
                                    device="cpu")
        finally:
            tsim.rps_lib.rps_exchange_global = real
        runs.setdefault(wire, []).append((h["loss"], seen))
    (f32_loss, f32_masks), = runs["f32"]
    (a_loss, a_masks), (b_loss, _) = runs["int8"]
    assert a_loss == b_loss and a_loss != f32_loss
    for (r1, g1), (r2, g2) in zip(f32_masks, a_masks):
        assert torch.equal(r1, r2) and torch.equal(g1, g2)


def test_simulator_frees_each_steps_replicas_without_the_collector():
    """The replicas a step replaces are freed by reference counting, not
    left in a reference cycle for the garbage collector (at rps-100m's
    n = 16 each stale copy is 8.3 GB of device memory)."""
    import gc
    import weakref

    init_fn, batch_fn = _teacher_setup()
    seen = []
    loss_and_grads = tsim._loss_and_grads

    def spy(loss_fn, params, batch, n):
        seen.append(weakref.ref(tree_lib.leaves(params)[0]))
        return loss_and_grads(loss_fn, params, batch, n)

    scfg = tsim.SimulatorConfig(n_workers=4, drop_rate=0.2, steps=4,
                                engine="ring")
    enabled = gc.isenabled()
    gc.disable()
    try:
        tsim._loss_and_grads = spy
        h = tsim.run_simulation(_mlp_loss_t, init_fn, batch_fn, scfg,
                                device="cpu")
        alive = [r() is not None for r in seen]
    finally:
        tsim._loss_and_grads = loss_and_grads
        if enabled:
            gc.enable()
    # every step's input replicas were replaced by the exchange's output
    assert alive == [False, False, False, False]
    assert h["params"]["w1"].shape == (4, 24, 48)
