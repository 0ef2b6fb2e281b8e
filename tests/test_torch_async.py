"""The async schedule of the port against the JAX package's, on the same
numpy-seeded inputs: the plan's fields, readiness times, ship order,
slacks and validation; the simulator on a deadline channel under async
with the reference's ``(rs, ag, late)`` masks injected (per-step loss and
consensus within 1e-4, staleness within one f32 ulp); async on a channel
without a latency model equal to sync bit for bit; the measured readiness
profile
(``compute_ms="auto"``); and the launcher's ``--async`` /
``--compute-ms`` / ``--corruption`` / ``--byzantine-frac`` flags on the
CPU.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.data import synthetic as jdata
from repro.train import simulator as jsim
from repro_torch import tree as tree_lib
from repro_torch.core import plan as tplan
from repro_torch.data import synthetic as tdata
from repro_torch.train import simulator as tsim
from _torch_sim import mlp_init, mlp_loss_j, mlp_loss_t, run_both

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEADLINE = "deadline:deadline_ms=10,base_ms=1,jitter_ms=3"

_SHAPES = {"emb": (40, 8), "l0": {"w": (8, 8), "b": (8,)},
           "l1": {"w": (8, 16), "b": (16,)}, "out": (16, 3)}


def _trees(shapes=_SHAPES):
    def build(fn, sh):
        return {k: build(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in sh.items()}
    return (build(lambda v: jax.ShapeDtypeStruct(v, jnp.float32), shapes),
            build(lambda v: torch.empty(v, device="meta"), shapes))


@pytest.mark.parametrize("knob", [None, ("n_buckets", 1), ("n_buckets", 3),
                                  ("n_buckets", 6), ("bucket_bytes", 300)])
@pytest.mark.parametrize("compute_ms", [8.0, 0.5, 123.25])
def test_async_plan_equals_reference(knob, compute_ms):
    """Readiness times (bucket_ready_ms), ship order, describe() and the
    slacks at several deadlines, per-leaf and bucketed plans."""
    jt, tt = _trees()
    if knob is None:
        jp = jplan.per_leaf_plan(jt, 4, schedule="async",
                                 compute_ms=compute_ms)
        tp = tplan.per_leaf_plan(tt, 4, schedule="async",
                                 compute_ms=compute_ms)
    else:
        kw = {knob[0]: knob[1]}
        jp = jplan.make_plan(jt, 4, schedule="async", compute_ms=compute_ms,
                             **kw)
        tp = tplan.make_plan(tt, 4, schedule="async", compute_ms=compute_ms,
                             **kw)
    assert tp.ready_ms == jp.ready_ms
    assert tp.ready_ms[0] == compute_ms
    assert list(tp.ready_ms) == sorted(tp.ready_ms, reverse=True)
    assert tp.ship_order == jp.ship_order
    assert tp.describe() == jp.describe()
    assert tp.schedule == "async"
    for deadline in (0.0, 3.0, 10.0, 200.0):
        np.testing.assert_array_equal(tp.slack_ms(deadline),
                                      jp.slack_ms(deadline))
    assert tplan.bucket_ready_ms(tp.buckets, compute_ms) == \
        jplan.bucket_ready_ms(jp.buckets, compute_ms)
    again = tp.with_ready_ms([r / 2 for r in tp.ready_ms])
    assert again.ready_ms == jp.with_ready_ms(
        [r / 2 for r in jp.ready_ms]).ready_ms
    sync = tplan.make_plan(tt, 4, n_buckets=3)
    assert sync.schedule == "sync" and sync.ship_order == (0, 1, 2)


def test_plan_from_config_threads_the_schedule():
    jt, tt = _trees()
    for kw in (dict(n_buckets=3), dict(bucket_mb=0.0002), {}):
        jp = jplan.plan_from_config(jt, 4, schedule="async", compute_ms=6.0,
                                    **kw)
        tp = tplan.plan_from_config(tt, 4, schedule="async", compute_ms=6.0,
                                    **kw)
        assert tp.describe() == jp.describe()


@pytest.mark.parametrize("case", [
    dict(schedule="async"), dict(schedule="sync", compute_ms=4.0),
    dict(schedule="later", compute_ms=4.0),
    dict(schedule="async", compute_ms=0.0),
    dict(schedule="async", compute_ms=-1.0)])
def test_async_plan_validation_equals_reference(case):
    jt, tt = _trees()
    for kind in ("make", "per_leaf"):
        jfn = jplan.make_plan if kind == "make" else jplan.per_leaf_plan
        tfn = tplan.make_plan if kind == "make" else tplan.per_leaf_plan
        with pytest.raises(ValueError) as want:
            jfn(jt, 4, **case)
        with pytest.raises(ValueError) as got:
            tfn(tt, 4, **case)
        if kind == "make":
            assert str(got.value) == str(want.value)


def test_with_ready_ms_and_slack_errors_equal_reference():
    jt, tt = _trees()
    jp = jplan.make_plan(jt, 4, n_buckets=3, schedule="async", compute_ms=5.0)
    tp = tplan.make_plan(tt, 4, n_buckets=3, schedule="async", compute_ms=5.0)
    js, ts = jplan.make_plan(jt, 4, n_buckets=3), tplan.make_plan(
        tt, 4, n_buckets=3)
    for jcall, tcall in (
            (lambda: jp.with_ready_ms([1.0, 2.0]),
             lambda: tp.with_ready_ms([1.0, 2.0])),
            (lambda: jp.with_ready_ms([1.0, -2.0, 0.0]),
             lambda: tp.with_ready_ms([1.0, -2.0, 0.0])),
            (lambda: js.with_ready_ms([1.0, 2.0, 3.0]),
             lambda: ts.with_ready_ms([1.0, 2.0, 3.0])),
            (lambda: js.slack_ms(10.0), lambda: ts.slack_ms(10.0))):
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            tcall()
        assert str(got.value) == str(want.value)


def test_resolve_compute_ms_equals_reference():
    from repro import channels as jchannels
    from repro_torch import channels as tchannels
    for kw in (dict(), dict(schedule="async"),
               dict(schedule="async", compute_ms=3.5),
               dict(schedule="async", compute_ms="auto"),
               dict(schedule="async", compute_ms="AUTO")):
        jc, tc = jsim.SimulatorConfig(**kw), tsim.SimulatorConfig(**kw)
        assert tsim.wants_measured_ready(tc) == jsim.wants_measured_ready(jc)
        for spec in (None, DEADLINE, "ge:p_bad=0.5,burst=4"):
            jch = jchannels.make_channel(spec, 4, 0.1)
            tch = tchannels.make_channel(spec, 4, 0.1)
            assert tsim.resolve_compute_ms(tc, tch) == \
                jsim.resolve_compute_ms(jc, jch)


# ---- the simulator ------------------------------------------------------------

def _teacher_streams(n=4):
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    return (jdata.make_worker_streams(jtask, n, 16),
            tdata.make_worker_streams(ttask, n, 16))


@pytest.mark.parametrize("kw", [
    dict(engine="xla", compute_ms=8.0,
         channel=DEADLINE + ",straggler_frac=0.3,straggler_mult=4"),
    dict(engine="ring", compute_ms=8.0,
         channel=DEADLINE + ",straggler_frac=0.3,straggler_mult=4"),
    dict(engine="ring", compute_ms=None, n_buckets=2,
         channel=DEADLINE + ",straggler_frac=0.2"),
    dict(engine="xla", compute_ms=12.0, n_buckets=2, channel=DEADLINE),
    dict(engine="xla", compute_ms=8.0, channel=DEADLINE,
         aggregator="rps_grad"),
    dict(engine="ring", compute_ms=8.0, channel=DEADLINE,
         exchange_every=2),
    dict(engine="xla", compute_ms=8.0, channel=DEADLINE,
         recovery="median", byzantine_frac=0.25),
], ids=["xla", "ring", "ring-default-ms-2b", "xla-late-bucket",
        "grad", "every2", "median-byz"])
def test_async_simulator_equals_reference(kw):
    """rps on the deadline channel under async, the reference's (rs, ag,
    late) masks injected: per-step loss and consensus within 1e-4, the
    staleness history equal value for value (and > 0 on exchanging
    steps)."""
    kw = dict(kw)
    kw.setdefault("aggregator", "rps_model")
    jb, tb = _teacher_streams()
    th, jh = run_both(dict(schedule="async", **kw), mlp_loss_j, mlp_init,
                      jb, mlp_loss_t, tb, steps=6)
    assert len(th["staleness"]) == 6
    every = kw.get("exchange_every", 1)
    assert all(v > 0 for t, v in enumerate(th["staleness"])
               if t % every == 0)
    assert all(v == 0 for t, v in enumerate(th["staleness"])
               if t % every != 0)


def _own_run(schedule, channel, steps=5, **kw):
    jb, tb = _teacher_streams()
    del jb
    scfg = tsim.SimulatorConfig(
        n_workers=4, steps=steps, eval_every=1, lr=0.2, drop_rate=0.3,
        n_buckets=2, channel=channel, schedule=schedule,
        compute_ms=4.0 if schedule == "async" else None, **kw)
    init = {"w1": torch.full((24, 48), 0.01), "w2": torch.full((48, 8),
                                                               -0.02)}
    return tsim.run_simulation(mlp_loss_t, None, tb, scfg, device="cpu",
                               init_params=init)


@pytest.mark.parametrize("channel", [None, "ge:p_bad=1.0,burst=4,p=0.2",
                                     "hetero:n_pods=2,p_cross=0.3"])
def test_async_without_latency_model_equals_sync(channel):
    """A channel without a latency model draws the sync per-bucket masks
    under async and reports nothing late: the run equals the sync run bit
    for bit (the port's own draws)."""
    a = _own_run("async", channel)
    s = _own_run("sync", channel)
    assert a["loss"] == s["loss"] and a["consensus"] == s["consensus"]
    assert a["staleness"] == [0.0] * 5 and s["staleness"] == []
    for x, y in zip(tree_lib.leaves(a["params"]),
                    tree_lib.leaves(s["params"])):
        assert torch.equal(x, y)


def test_async_own_draws_are_late_on_a_deadline_channel():
    """The port's own draws under async on the deadline channel: the
    buckets' slacks are 10 − ready_ms, lateness appears, and two runs of
    one seed are identical."""
    spec = DEADLINE + ",straggler_frac=0.3,straggler_mult=4"
    runs = [_own_run("async", spec) for _ in range(2)]
    assert runs[0]["loss"] == runs[1]["loss"]
    # w1 (1,152 elements) then w2 (384): ready at 4 ms and 4 × 384 / 1,536
    assert runs[0]["exchange_plan"]["ready_ms"] == [4.0, 1.0]
    assert 0 < np.mean(runs[0]["staleness"]) < 1


def test_measure_bucket_ready_ms_is_monotone_and_auto_runs():
    """The suffix-backward timing is positive and non-increasing in plan
    order, one time per bucket; compute_ms="auto" puts it in the plan."""
    jb, tb = _teacher_streams()
    del jb
    init = {"w1": torch.full((24, 48), 0.01), "w2": torch.full((48, 8),
                                                               -0.02)}
    params = tree_lib.map(lambda x: x[None].expand((4,) + tuple(x.shape))
                          .clone(), init)
    plan = tplan.make_plan(
        tree_lib.map(lambda x: torch.empty(x.shape, device="meta"), init),
        4, n_buckets=2, schedule="async", compute_ms=1.0)
    ready = tsim.measure_bucket_ready_ms(mlp_loss_t, params, tb(0), plan,
                                         reps=2)
    assert len(ready) == 2 and all(r > 0 for r in ready)
    assert ready[0] >= ready[1]
    h = tsim.run_simulation(
        mlp_loss_t, None, tb, tsim.SimulatorConfig(
            n_workers=4, steps=2, eval_every=1, n_buckets=2,
            schedule="async", compute_ms="auto", channel=DEADLINE),
        device="cpu", init_params=init)
    got = h["exchange_plan"]["ready_ms"]
    assert len(got) == 2 and got[0] >= got[1] > 0
    assert len(h["staleness"]) == 2


# ---- the launcher -------------------------------------------------------------

def _launch(*flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rps-paper-mlp", "--reduced", "--steps", "3", "--workers", "4",
         "--device", "cpu", "--buckets", "2", *flags],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_launcher_async_flags_on_cpu():
    out = _launch("--async", "--compute-ms", "8", "--engine", "ring",
                  "--channel", DEADLINE + ",straggler_frac=0.3")
    assert "async staleness: mean late_frac=" in out
    assert "n=4 s=4 p=0.1 agg=rps_model final_loss=" in out
    out = _launch("--async", "--compute-ms", "auto", "--channel", DEADLINE)
    assert "async staleness: mean late_frac=" in out


def test_launcher_corruption_flags_on_cpu():
    out = _launch("--corruption", "collude:gamma=10", "--byzantine-frac",
                  "0.25", "--recovery", "trimmed:beta=0.3")
    assert "CorruptionChannel(BernoulliChannel(n=4, p=0.1), " \
        "'collude:byzantine_frac=0.25')" in out
    assert "wire=f32/trimmed:beta=0.3" in out
    assert "corruption: mean corrupt_frac=" in out
