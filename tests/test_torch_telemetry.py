"""The port's exchange telemetry against the JAX package's, on the same
numpy inputs and with the reference's draws injected: the tap semantics,
every counter, the per-link estimator and drift monitor, the Chrome-trace
validator, the registry's binding, the simulator's per-step records
(bit-identical runs with telemetry on and off), the serving trace, the
launchers' ``--telemetry-dir`` and Fig 4a's sweep with its timer."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.channels import make_channel as jmake_channel
from repro.core import rps as jrps
from repro.data import synthetic as jdata
from repro.telemetry import counters as jcounters
from repro.telemetry import taps as jtaps
from repro.telemetry.estimator import LinkRateEstimator as JEstimator
from repro.telemetry.sinks import ConsoleSink as JConsoleSink
from repro.telemetry.trace import validate_chrome_trace as jvalidate
from repro.train import simulator as jsim
from repro_torch import telemetry as ttel
from repro_torch import tree as tree_lib
from repro_torch.channels import make_channel as tmake_channel
from repro_torch.core import rps as trps
from repro_torch.data import synthetic as tdata
from repro_torch.telemetry import counters as tcounters
from repro_torch.telemetry import taps as ttaps
from repro_torch.telemetry.estimator import LinkRateEstimator as TEstimator
from repro_torch.telemetry.sinks import ConsoleSink as TConsoleSink
from repro_torch.telemetry.sinks import JsonlSink, MemorySink, close_all
from repro_torch.telemetry.timing import time_fn, wallclock
from repro_torch.telemetry.trace import TraceBuffer, validate_chrome_trace
from repro_torch.train import simulator as tsim
from repro_torch.launch.env import host_env
from _torch_sim import (mlp_init, mlp_loss_j, mlp_loss_t, np_tree,
                        reference_bits, reference_draws, reference_noise,
                        reference_pack_noise, to_torch)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
DEADLINE = ("deadline:deadline_ms=10,base_ms=1,jitter_ms=3,"
            "straggler_frac=0.3,straggler_mult=4")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _masks(seed: int, shape: tuple, n: int, s: int, p: float = 0.35):
    """Bernoulli(1 - p) boolean masks with the owner entries forced on."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) >= p
    own = np.zeros((n, s), bool)
    own[np.arange(s) % n, np.arange(s)] = True
    return m | own


# ---- taps --------------------------------------------------------------------

def _tap_script(taps, ones, zeros):
    """One sequence of tap calls, run against either package's module."""
    out = {"before": taps.active() is None}
    taps.emit("x", ones)                      # no collector: dropped
    with taps.tap_collector() as outer:
        taps.emit("x", ones)
        with taps.tap_collector() as inner:
            out["inner_active"] = taps.active() is inner
            taps.emit("y", zeros)
            taps.annotate("meta", {"k": 1})
        out["outer_back"] = taps.active() is outer
        taps.emit("x", zeros)                 # repeat: a list
        taps.emit("x", ones)
    out["after"] = taps.active() is None
    shape = lambda tree: {k: (len(v) if isinstance(v, list) else 0)  # noqa
                          for k, v in tree.items()}
    out["outer"] = shape(outer.tree())
    out["inner"] = shape(inner.tree())
    out["outer_meta"], out["inner_meta"] = outer.meta, inner.meta
    return out


def test_tap_semantics_equal_reference():
    """No-op without a collector, nesting (emissions go to the innermost),
    repeated names become lists, annotations are per collector."""
    got = _tap_script(ttaps, torch.ones(3), torch.zeros(3))
    want = _tap_script(jtaps, jnp.ones(3), jnp.zeros(3))
    assert got == want
    assert got["outer"] == {"x": 3} and got["inner"] == {"y": 0}


def test_tap_values_are_kept_as_emitted():
    with ttaps.tap_collector() as t:
        a, b = torch.tensor(1.0), torch.tensor(2.0)
        ttaps.emit("v", a)
        ttaps.emit("v", b)
    assert t.tree()["v"][0] is a and t.tree()["v"][1] is b


# ---- counters -----------------------------------------------------------------

COUNTER_CASES = [
    (4, 4, None), (4, 8, None), (6, 3, None), (4, 4, 3), (5, 10, 2)]


@pytest.mark.parametrize("n,s,nb", COUNTER_CASES)
def test_counters_equal_reference(n, s, nb):
    """Delivered, offered, late and corrupt counts and the step bundles
    bit for bit on the same masks (shared and per-bucket, s != n)."""
    shape = (n, s) if nb is None else (nb, n, s)
    rs, ag = _masks(1, shape, n, s), _masks(2, shape, n, s)
    late_rs = _masks(3, shape, n, s, p=0.8) & ~rs
    late_ag = _masks(4, shape, n, s, p=0.8) & ~ag
    cm = np.random.default_rng(5).random(shape) < 0.3
    pairs = [
        (tcounters.link_delivered(_t(rs)),
         jcounters.link_delivered(jnp.asarray(rs))),
        (tcounters.link_offered(n, s, nb), jcounters.link_offered(n, s, nb)),
        (tcounters.link_corrupt(_t(cm), _t(rs)),
         jcounters.link_corrupt(jnp.asarray(cm), jnp.asarray(rs))),
    ]
    bundles = [
        (tcounters.mask_step_stats(_t(rs), _t(ag)),
         jcounters.mask_step_stats(jnp.asarray(rs), jnp.asarray(ag))),
        (tcounters.staleness_stats(_t(late_rs), _t(late_ag)),
         jcounters.staleness_stats(jnp.asarray(late_rs),
                                   jnp.asarray(late_ag))),
        (tcounters.corruption_stats(_t(cm), _t(rs)),
         jcounters.corruption_stats(jnp.asarray(cm), jnp.asarray(rs))),
    ]
    for got, want in bundles:
        assert set(got) == set(want)
        pairs += [(got[k], want[k]) for k in sorted(want)]
    for got, want in pairs:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        if want.dtype.kind == "f":
            # the reference divides by a constant as a product by its
            # reciprocal: one f32 ulp
            np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 7), (6,)])
def test_divisor_stats_equal_reference(shape):
    div = np.random.default_rng(0).integers(1, 9, shape).astype(np.float32)
    got = tcounters.divisor_stats(_t(div))
    want = jcounters.divisor_stats(jnp.asarray(div))
    for k in ("min", "mean", "max"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "bfloat16")])
def test_global_norm_equals_reference(dtypes):
    """f32 accumulation over every leaf, bf16 leaves included, within
    1e-6 relative."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 33)).astype(np.float32),
            "b": [rng.normal(size=(4, 7, 5)).astype(np.float32) * 30.0,
                  rng.normal(size=(4,)).astype(np.float32)]}
    jt = {"a": jnp.asarray(tree["a"], dtypes[0]),
          "b": [jnp.asarray(x, dtypes[1]) for x in tree["b"]]}
    tt = {"a": _t(np.asarray(jt["a"].astype(jnp.float32))).to(
              getattr(torch, dtypes[0])),
          "b": [_t(np.asarray(x.astype(jnp.float32))).to(
              getattr(torch, dtypes[1])) for x in jt["b"]]}
    np.testing.assert_allclose(float(tcounters.global_norm(tt)),
                               float(jcounters.global_norm(jt)), rtol=1e-6)
    assert float(tcounters.global_norm({})) == 0.0


def test_consensus_distance_equals_reference():
    x = np.random.default_rng(2).normal(size=(5, 6, 7)).astype(np.float32)
    np.testing.assert_allclose(
        float(tcounters.consensus_distance(_t(x))),
        float(jcounters.consensus_distance(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("engine,nb,recovery", [
    ("xla", None, "renorm"), ("ring", 2, "renorm"), ("xla", 2, "scale"),
    ("ring", None, "ef"), ("xla", 2, "median")])
def test_exchange_taps_equal_reference(engine, nb, recovery):
    """One exchange under a collector in each package, the same masks:
    the same tap names, the integer counters bit for bit, the divisor
    table per group and the EF residual's squared norm within 1e-6, the
    same plan and exchange annotations."""
    n = 4
    rng = np.random.default_rng(3)
    tree = {"w": (rng.integers(-4, 5, (n, 8, 8))).astype(np.float32),
            "b": (rng.integers(-4, 5, (n, 24))).astype(np.float32)}
    from repro.core import plan as jplan
    from repro_torch.core import plan as tplan
    jp = jplan.make_plan({k: jnp.zeros(v.shape[1:]) for k, v in tree.items()},
                         n, n_buckets=nb, engine=engine, recovery=recovery)
    tp = tplan.make_plan({k: torch.zeros(v.shape[1:]) for k, v in
                          tree.items()}, n, n_buckets=nb, engine=engine,
                         recovery=recovery)
    shape = (jp.n_buckets, n, n) if jp.per_bucket_masks else (n, n)
    rs, ag = _masks(6, shape, n, n), _masks(7, shape, n, n)
    ef = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in tree.items()}
    kw = dict(mode="model", engine=engine, recovery=recovery)
    with jtaps.tap_collector() as jt:
        jrps.rps_exchange_global(
            {k: jnp.asarray(v) for k, v in tree.items()},
            jax.random.PRNGKey(0), 0.35, n, plan=jp,
            masks=(jnp.asarray(rs), jnp.asarray(ag)),
            ef_state={k: jnp.asarray(v) for k, v in ef.items()}
            if recovery == "ef" else None, **kw)
    with ttaps.tap_collector() as tt:
        trps.rps_exchange_global(
            {k: _t(v) for k, v in tree.items()}, None, 0.35, n, plan=tp,
            masks=(_t(rs), _t(ag)),
            ef_state={k: _t(v) for k, v in ef.items()}
            if recovery == "ef" else None, **kw)
    got, want = tt.tree(), jt.tree()
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        gl = g if isinstance(g, list) else [g]
        wl = w if isinstance(w, list) else [w]
        assert len(gl) == len(wl), k
        for a, b in zip(gl, wl):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            b = np.asarray(b)
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(a, b)
    assert tt.meta == jt.meta


def test_exchange_without_collector_taps_nothing():
    n = 4
    tree = {"w": torch.ones((n, 8, 8))}
    gen = torch.Generator().manual_seed(0)
    assert ttaps.active() is None
    trps.rps_exchange_global(tree, gen, 0.3, n)
    with ttaps.tap_collector() as t:
        trps.rps_exchange_global(tree, gen, 0.3, n)
    assert {"rs_link_delivered", "divisor"} <= set(t.tree())
    assert t.meta["exchange"]["n"] == n


# ---- estimator ------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [None, 0.3])
def test_estimator_and_drift_equal_reference(alpha):
    n = 5
    rng = np.random.default_rng(4)
    te, je = TEstimator(n, alpha), JEstimator(n, alpha)
    offered = np.full(n, 6)
    for step in range(40):
        d = rng.binomial(6, 0.8, size=n)
        if step == 7:
            d[2], offered[2] = 0, 0            # a silent link this step
        te.update(d, offered)
        je.update(d, offered)
        offered[2] = 6
    np.testing.assert_array_equal(te.est, je.est)
    np.testing.assert_array_equal(te.ess(), je.ess())
    np.testing.assert_array_equal(te.stderr(), je.stderr())
    for exp in (0.2, np.linspace(0.1, 0.3, n)):
        assert te.drift(exp) == je.drift(exp)
        assert te.drift(exp, z=1.0, slack=0.0) == \
            je.drift(exp, z=1.0, slack=0.0)
    with pytest.raises(ValueError):
        TEstimator(2, alpha=1.5)
    with pytest.raises(ValueError):
        te.update([1, 2], [3, 3])


# ---- chrome trace -----------------------------------------------------------------

TRACES = [
    {"traceEvents": []},
    {"no_events": []},
    [],
    "text",
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": "soon"}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 1.0, "dur": -1}]},
    {"traceEvents": [{"name": "a", "ph": "Q", "ts": 1.0}]},
    {"traceEvents": [{"ph": "M", "ts": 0, "args": {"name": "p"}}]},
    {"traceEvents": [7, {"name": "b", "ph": "C", "ts": 2,
                         "args": {"v": {1, 2}}}]},
    [{"name": "a", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 1, "tid": 1}],
]


@pytest.mark.parametrize("idx", range(len(TRACES)))
def test_validator_equals_reference(idx):
    assert validate_chrome_trace(TRACES[idx]) == jvalidate(TRACES[idx])


def test_trace_buffer_accepted_by_both_validators(tmp_path):
    tb = TraceBuffer()
    with tb.span("phase.outer", detail="x"):
        with tb.span("phase.inner"):
            pass
    tb.instant("marker", k=1)
    tb.counter("packets", {"value": 7})
    tb.complete("req", tb.now_us(), 3.0, rid=2)
    obj = tb.to_chrome()
    assert validate_chrome_trace(obj) == [] == jvalidate(obj)
    path = tmp_path / "trace.json"
    tb.write(str(path))
    with open(path) as f:
        assert jvalidate(json.load(f)) == []
    names = [e["name"] for e in obj["traceEvents"]]
    assert names == ["phase.inner", "phase.outer", "marker", "packets",
                     "req"]


def test_trace_validate_cli(tmp_path, capsys):
    """``--validate`` exits 0 on a good trace and 1 on a malformed or
    missing file (the last through ``python -m``, as a user runs it)."""
    from repro_torch.telemetry import trace as trace_cli
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    tb = TraceBuffer()
    with tb.span("s"):
        pass
    tb.write(str(good))
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert trace_cli.main(["--validate", str(good)]) == 0
    assert capsys.readouterr().out.startswith("OK ")
    assert trace_cli.main(["--validate", str(bad)]) == 1
    assert "missing string 'name'" in capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=SRC)
    for path, rc in ((good, 0), (tmp_path / "none.json", 1)):
        r = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.trace",
                            "--validate", str(path)], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == rc, r.stdout + r.stderr


# ---- records, sinks, timer ------------------------------------------------------

def test_to_jsonable_equals_reference():
    """Tensors of every dtype (bf16 included) become the reference's
    plain Python values for the same numpy data."""
    rng = np.random.default_rng(6)
    f = rng.normal(size=(2, 3)).astype(np.float32)
    f[0, 1] = np.nan
    cases = [f, np.float32(2.5), np.array(np.inf, np.float32),
             np.arange(4, dtype=np.int32), np.array([True, False]),
             np.array(7, np.int64), (np.ones(2, np.float32), {"k": 1}),
             None, "s", 3]
    for x in cases:
        tx = x
        if isinstance(x, (np.ndarray, np.generic)):
            tx = torch.from_numpy(np.array(x))
        elif isinstance(x, tuple):
            tx = (torch.from_numpy(x[0]), x[1])
        assert ttel.to_jsonable(tx) == jtel.to_jsonable(x)
    bf = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    assert ttel.to_jsonable(bf) == \
        jtel.to_jsonable(jnp.asarray([1.5, -2.25], jnp.bfloat16))
    rec = ttel.make_step_record(3, {"a": torch.tensor(2)}, loss=1.0)
    assert rec == jtel.make_step_record(3, {"a": np.int32(2)}, loss=1.0)


def test_sinks(tmp_path, capsys):
    recs = [{"step": i, "loss": 1.0 / (i + 1), "rs_drop_rate": 0.1,
             "grad_norm": 2.0} for i in range(5)]
    js = JsonlSink(str(tmp_path / "r.jsonl"))
    mem = MemorySink(capacity=3)
    for r in recs:
        js.write(r)
        mem.write(r)
    close_all([js, mem])
    close_all([js])                            # idempotent
    with open(tmp_path / "r.jsonl") as f:
        assert [json.loads(line) for line in f] == recs
    assert mem.tail(2) == recs[-2:] and len(mem.records) == 3
    for sink in (TConsoleSink(every=2), JConsoleSink(every=2)):
        for r in recs:
            sink.write(r)
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:] and len(out) == 8


def test_time_fn_and_wallclock():
    sec = time_fn(lambda x: x * 2.0, torch.ones(16), reps=2, iters=2)
    assert 0 < sec < 1.0
    with wallclock("test.block") as w:
        np.ones(10).sum()
    assert w.s >= 0 and w.us == pytest.approx(w.s * 1e6)
    reg = ttel.Telemetry()
    with ttel.enabled(reg):
        assert ttel.get_current() is reg
        with wallclock("test.labelled"):
            pass
        time_fn(lambda: torch.zeros(2), reps=1, label="test.fn")
    assert ttel.get_current() is None
    assert set(reg.timings) == {"test.labelled", "test.fn"}
    summ = reg.summary()["timings_s"]["test.fn"]
    assert summ["n"] == 1 and summ["best"] == summ["mean"]


# ---- the registry's binding -----------------------------------------------------

BIND_CASES = [
    dict(channel="bernoulli:p=0.2", n_buckets=None),
    dict(channel="hetero:n_pods=2,p_cross=0.4", n_buckets=2),
    dict(channel=DEADLINE, n_buckets=4, schedule="async"),
    dict(channel="ge:p_bad=0.6,burst=8", n_buckets=2, wire="int8",
         recovery="ef"),
]


@pytest.mark.parametrize("kw", BIND_CASES, ids=lambda kw: kw["channel"]
                         .split(":")[0] + "-" + kw.get("schedule", "sync"))
def test_bind_meta_equals_reference(kw):
    """``bind``'s meta (plan, α bounds, expected p, the async marginal)
    and the expected per-link p of both legs equal the reference's."""
    n = 8
    base = dict(n_workers=n, drop_rate=0.1, aggregator="rps_model")
    base.update(kw)
    jscfg, tscfg = jsim.SimulatorConfig(**base), tsim.SimulatorConfig(**base)
    jch = jmake_channel(kw["channel"], n, 0.1)
    tch = tmake_channel(kw["channel"], n, 0.1)
    p1j = {"w1": jnp.zeros((24, 48)), "w2": jnp.zeros((48, 8))}
    p1t = {"w1": torch.zeros((24, 48)), "w2": torch.zeros((48, 8))}
    jreg = jtel.Telemetry().bind(plan=jsim.make_exchange_plan(p1j, jscfg, jch),
                                 n=n, p=jch.effective_p(), channel=jch,
                                 aggregator="rps_model")
    treg = ttel.Telemetry().bind(plan=tsim.make_exchange_plan(p1t, tscfg, tch),
                                 n=n, p=tch.effective_p(), channel=tch,
                                 aggregator="rps_model")
    assert treg.meta == jreg.meta
    np.testing.assert_array_equal(treg._expected_p, jreg._expected_p)
    np.testing.assert_array_equal(treg._expected_p_ag, jreg._expected_p_ag)
    if kw.get("schedule") == "async":
        assert treg.meta["p"] > treg.meta["p_sync"] + 0.1


# ---- the simulator ----------------------------------------------------------------

def _teacher(n):
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    return (jdata.make_worker_streams(jtask, n, 16),
            tdata.make_worker_streams(ttask, n, 16))


def _teacher_init(gen):
    return {"w1": torch.randn((24, 48), generator=gen) * 0.1,
            "w2": torch.randn((48, 8), generator=gen) * 0.1}


@pytest.mark.parametrize("engine", ["xla", "ring"])
def test_simulator_telemetry_bit_identical(engine):
    """n 4, 12 steps, 2 buckets: losses, consensus and every parameter
    bit for bit with telemetry off and on; a record per step."""
    _, tbatch = _teacher(4)
    base = dict(n_workers=4, drop_rate=0.2, aggregator="rps_model", lr=0.2,
                warmup=2, steps=12, n_buckets=2, engine=engine,
                eval_every=1)
    h0 = tsim.run_simulation(mlp_loss_t, _teacher_init, tbatch,
                             tsim.SimulatorConfig(**base), device="cpu")
    h1 = tsim.run_simulation(mlp_loss_t, _teacher_init, tbatch,
                             tsim.SimulatorConfig(telemetry=True, **base),
                             device="cpu")
    assert h0["loss"] == h1["loss"] and h0["consensus"] == h1["consensus"]
    for a, b in zip(tree_lib.leaves(h0["params"]),
                    tree_lib.leaves(h1["params"])):
        assert torch.equal(a, b), "telemetry changed the trained parameters"
    assert h0.records == [] and len(h1.records) == base["steps"]
    assert {"rs_link_delivered", "ag_link_delivered", "link_offered",
            "rs_bucket_link_delivered", "divisor", "loss", "grad_norm",
            "param_norm", "consensus", "lr"} <= set(h1.records[0])
    assert h1.records[0]["link_offered"] == [6, 6, 6, 6]    # 3 x 2 buckets
    assert h1.summary["steps"] == 12 and "link_p" in h1.summary


# the per-step records against the reference's on its draws: integer
# counters equal, norms and the residual within 1e-5 relative, loss and
# consensus within 1e-4. The packed-state case against the reference run
# op by op: jitted, XLA fuses the Adam update, and a last-bit change of
# m moves its bf16 encode error by a whole bf16 step.
RECORD_CASES = {
    "xla-buckets": dict(engine="xla", n_buckets=2),
    "ring": dict(engine="ring"),
    "grad": dict(aggregator="rps_grad", engine="ring"),
    "async": dict(n_buckets=2, schedule="async", channel=DEADLINE),
    "collude-median": dict(n_buckets=2, byzantine_frac=0.25,
                           recovery="median"),
    "int8-ef-ring": dict(wire="int8", recovery="ef", engine="ring"),
    "adam-i8-ef": dict(optimizer="adam", state_pack="i8", recovery="ef",
                       n_buckets=2, eager=True),
    "momentum-bf16": dict(optimizer="momentum", state_pack="bf16",
                          engine="ring"),
    "allreduce": dict(aggregator="allreduce_model"),
}
_INT_KEYS = ("rs_link_delivered", "ag_link_delivered", "link_offered",
             "rs_bucket_link_delivered", "rs_link_late", "ag_link_late",
             "rs_link_corrupt", "step")
_LOOSE = ("loss", "consensus")
# ratios of integer counts: the jitted reference divides by the constant
# offered count as a product by its reciprocal, one f32 ulp (of 1.0 in
# 1 - delivered / offered) from the quotient
_RATES = ("rs_drop_rate", "ag_drop_rate", "late_frac", "staleness",
          "corrupt_frac")
# an encode error x - Q(x) carries x's last-bit differences magnified by
# |x| / |x - Q(x)| (~2^8 at bf16, ~127 at int8), and the EF residual is
# itself the int8 wire's encode error: with the loss equal to the last
# bit, the port's errors sit up to 8.5e-4 from the reference's at step 0
# and up to 4.3e-3 by step 3 (measured, CPU), so within 1e-2
_QUANT = ("quant_err_opt_m", "quant_err_opt_v", "quant_err_ef")


@pytest.fixture(scope="module", params=sorted(RECORD_CASES))
def record_runs(request):
    """The reference simulator with telemetry and the port's on the
    reference's draws (one run each, shared by the tests below)."""
    n = 4
    jbatch, tbatch = _teacher(n)
    base = dict(n_workers=n, steps=6, eval_every=1, lr=0.2, warmup=2,
                seed=0, aggregator="rps_model", drop_rate=0.3,
                telemetry=True)
    kw = dict(RECORD_CASES[request.param])
    eager = kw.pop("eager", False)
    base.update(kw)
    jscfg = jsim.SimulatorConfig(**base)
    with jax.disable_jit(eager):
        jh = jsim.run_simulation(mlp_loss_j, mlp_init, jbatch, jscfg)
    p1, masks, cmasks = reference_draws(mlp_init, jscfg)
    treg = ttel.Telemetry()
    th = tsim.run_simulation(
        mlp_loss_t, None, tbatch,
        tsim.SimulatorConfig(**dict(base, telemetry=False)), telemetry=treg,
        device="cpu", init_params=to_torch(np_tree(p1)),
        masks_fn=None if masks is None else (lambda t: masks[t]),
        wire_noise_fn=reference_noise(jscfg),
        pack_noise_fn=reference_pack_noise(jscfg),
        corrupt_masks_fn=None if cmasks is None else (lambda t: cmasks[t]),
        corrupt_bits_fn=reference_bits(jscfg))
    return request.param, th, jh, treg


def _assert_close_tree(got, want, key):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), key
        for g, w in zip(got, want):
            _assert_close_tree(g, w, key)
        return
    if key in _INT_KEYS:
        assert got == want, key
    elif key in _QUANT:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-12,
                                   err_msg=key)
    elif key in _LOOSE:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9,
                                   err_msg=key)
    elif key in _RATES:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23,
                                   atol=2.0 ** -23, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12,
                                   err_msg=key)


def test_simulator_records_equal_reference(record_runs):
    name, th, jh, _ = record_runs
    assert len(th.records) == len(jh.records) == 6
    for got, want in zip(th.records, jh.records):
        assert set(got) == set(want), name
        for k in want:
            _assert_close_tree(got[k], want[k], k)
    if name == "async":
        assert "late_frac" in th.records[0] and "staleness" in th.records[0]
    if name == "collude-median":
        assert th.records[0]["rs_link_corrupt"][1:] == [0, 0, 0]
    if name == "adam-i8-ef":
        assert {"quant_err_opt_m", "quant_err_opt_v",
                "quant_err_ef"} <= set(th.records[0])


def test_simulator_summary_equals_reference(record_runs):
    """The summary's meta and step count equal the reference's, its
    drift report's counts too (the estimates within 1e-12)."""
    name, th, jh, _ = record_runs
    assert th.summary["meta"] == jh.summary["meta"]
    assert th.summary["steps"] == jh.summary["steps"]
    assert set(th.summary) == set(jh.summary)
    for leg in th.summary.get("link_p", {}):
        got, want = th.summary["link_p"][leg], jh.summary["link_p"][leg]
        assert got["packets"] == want["packets"]
        assert got["drifted"] == want["drifted"]
        np.testing.assert_allclose(got["observed_p"], want["observed_p"],
                                   rtol=0, atol=1e-12)


def test_simulator_trace_spans_and_tracks(record_runs):
    """The run's trace validates in both packages and carries the plan
    build and drain spans, and the lateness / corruption tracks of the
    async / attacked runs (one per step)."""
    name, _, _, treg = record_runs
    obj = treg.trace.to_chrome()
    assert validate_chrome_trace(obj) == [] == jvalidate(obj)
    names = [e["name"] for e in obj["traceEvents"]]
    assert "record_drain" in names and "plan_build" in names
    assert names.count("lateness") == (6 if name == "async" else 0)
    assert names.count("corruption") == (6 if name == "collude-median"
                                         else 0)


@pytest.mark.parametrize("pack", ["bf16", "i8"])
def test_quant_err_counters_equal_reference(pack):
    """The packed Adam's and the EF residual's quantisation errors under
    the bf16 and i8 packs (the reference's uniforms injected, the int8
    wire under ef so the residual is not zero) against the reference run
    op by op, as _QUANT says."""
    n = 4
    jbatch, tbatch = _teacher(n)
    base = dict(n_workers=n, steps=4, eval_every=1, lr=0.1, warmup=2,
                seed=0, aggregator="rps_model", drop_rate=0.3,
                optimizer="adam", state_pack=pack, wire="int8",
                recovery="ef", telemetry=True)
    jscfg = jsim.SimulatorConfig(**base)
    with jax.disable_jit():
        jh = jsim.run_simulation(mlp_loss_j, mlp_init, jbatch, jscfg)
    p1, masks, _ = reference_draws(mlp_init, jscfg)
    th = tsim.run_simulation(
        mlp_loss_t, None, tbatch, tsim.SimulatorConfig(**base),
        device="cpu", init_params=to_torch(np_tree(p1)),
        masks_fn=lambda t: masks[t],
        wire_noise_fn=reference_noise(jscfg),
        pack_noise_fn=reference_pack_noise(jscfg))
    for got, want in zip(th.records, jh.records):
        assert set(_QUANT) <= set(got) and set(_QUANT) <= set(want)
        assert want["quant_err_ef"] > 0
        for k in _QUANT:
            _assert_close_tree(got[k], want[k], k)


def test_simulator_without_telemetry_has_no_collector(monkeypatch):
    """A telemetry-off step runs with no collector installed, so no
    instrumented site computes anything."""
    seen = []
    real = trps.rps_exchange_global

    def spy(*a, **k):
        seen.append(ttaps.active())
        return real(*a, **k)

    monkeypatch.setattr(trps, "rps_exchange_global", spy)
    _, tbatch = _teacher(4)
    tsim.run_simulation(mlp_loss_t, _teacher_init, tbatch,
                        tsim.SimulatorConfig(n_workers=4, drop_rate=0.2,
                                             steps=2), device="cpu")
    assert seen == [None, None]


def test_async_drift_monitor_uses_async_marginal():
    """Under async on the deadline channel the drift monitor compares
    against the mean per-bucket async marginal and stays quiet."""
    n = 8
    _, tbatch = _teacher(n)
    channel = tmake_channel(DEADLINE, n, 0.1)
    reg = ttel.Telemetry()
    tsim.run_simulation(mlp_loss_t, _teacher_init, tbatch,
                        tsim.SimulatorConfig(n_workers=n, lr=0.2, warmup=2,
                                             steps=200, n_buckets=4,
                                             schedule="async",
                                             channel=channel),
                        telemetry=reg, device="cpu")
    rep = reg.drift_report(slack=0.06)
    assert not rep["rs"]["any_drift"], rep["rs"]
    assert not rep["ag"]["any_drift"], rep["ag"]
    assert reg.meta["p_sync"] == pytest.approx(channel.effective_p())
    assert reg.meta["p"] > reg.meta["p_sync"] + 0.1


# ---- serving ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gemma3-1b").reduced()
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _requests(vocab, seed):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(S)),
                    max_new=int(m))
            for i, (S, m) in enumerate(zip((6, 10, 14), (3, 5, 9)))]


@pytest.mark.parametrize("tp", [False, True])
def test_serving_trace_schema_and_tokens(served, tp):
    """The reference's serving trace schema (tests/test_serve_continuous
    .py): every request's span, the prefill spans and the queue counter
    with its four fields; the tokens those of a run without telemetry."""
    from repro_torch.serve import ContinuousEngine, TPDecodeConfig
    model, params = served
    kw = dict(page=4, n_blocks=17, max_batch=2, chunk=4, max_len=32,
              tp=TPDecodeConfig(n_shards=4, p=0.3) if tp else None)
    vocab = model.cfg.vocab_size
    plain = ContinuousEngine(model, params, **kw).run(_requests(vocab, 4),
                                                      drain=True)
    reg = ttel.Telemetry()
    reqs = _requests(vocab, 4)
    rep = ContinuousEngine(model, params, telemetry=reg, **kw).run(
        reqs, drain=True)
    assert rep.outputs() == plain.outputs()
    obj = reg.trace.to_chrome()
    assert validate_chrome_trace(obj) == [] == jvalidate(obj)
    names = {e["name"] for e in obj["traceEvents"]}
    assert {"serve.request", "serve.prefill", "serve.queue"} <= names
    spans = [e for e in obj["traceEvents"] if e["name"] == "serve.request"]
    assert {s["args"]["rid"] for s in spans} == {r.rid for r in reqs}
    q = [e for e in obj["traceEvents"] if e["name"] == "serve.queue"]
    assert {"waiting", "running", "kv_blocks_used", "kv_blocks_free"} \
        == set(q[0]["args"])


# ---- the launchers -----------------------------------------------------------------

def _run(args, timeout=300):
    # one intra-op thread: the suite runs these beside other workers
    env = dict(os.environ, PYTHONPATH=SRC, **host_env(threads=1))
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_train_launcher_telemetry_dir_and_checkpoint(tmp_path, capsys):
    """``--telemetry-dir`` on the CPU writes the three files, its trace
    validates, tools/render_experiments.py renders them, and
    ``--checkpoint`` loads back into the reference's ``load_pytree``."""
    from repro_torch.launch import train as train_launcher
    d, ck = tmp_path / "tel", tmp_path / "mean.npz"
    hist = train_launcher.main(
        ["--reduced", "--steps", "3", "--workers", "4", "--device", "cpu",
         "--buckets", "2", "--telemetry-dir", str(d), "--checkpoint",
         str(ck)])
    out = capsys.readouterr().out
    assert "telemetry: 3 steps recorded" in out
    assert "theory bounds: alpha1=" in out
    assert len(hist.records) == 3
    assert sorted(os.listdir(d)) == ["summary.json", "telemetry.jsonl",
                                     "trace.json"]
    from repro_torch.telemetry import trace as trace_cli
    assert trace_cli.main(["--validate", str(d / "trace.json")]) == 0
    html_out = tmp_path / "r.html"
    _run([os.path.join(ROOT, "tools", "render_experiments.py"),
          "--telemetry", str(d), "--html", str(html_out)])
    assert "Per-link delivery" in html_out.read_text()
    with open(d / "summary.json") as f:
        assert json.load(f)["steps"] == 3
    from repro.checkpoint import load_pytree
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    like = jbuild_model(jget_config("rps-paper-mlp").reduced(),
                        grouped=False).init(jax.random.PRNGKey(0))
    back = load_pytree(str(ck), like)
    mean = tree_lib.map(lambda x: x.mean(0), hist["params"])
    for a, b in zip(tree_lib.leaves(mean), jax.tree.leaves(back)):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b).astype(np.float32))


def test_train_launcher_telemetry_flag_prints_summary(capsys):
    from repro_torch.launch import train as train_launcher
    train_launcher.main(["--reduced", "--steps", "2", "--workers", "4",
                         "--device", "cpu", "--telemetry"])
    out = capsys.readouterr().out
    assert "telemetry: 2 steps recorded" in out
    assert "observed per-link p" in out


def test_serve_launcher_telemetry_dir(tmp_path):
    from repro_torch.launch import serve as serve_launcher
    d = tmp_path / "serve"
    argv = ["--serve", "continuous", "--tp-shards", "4", "-p", "0.1",
            "--drain", "--device", "cpu", "--requests", "4"]
    rep = serve_launcher.main(argv + ["--telemetry-dir", str(d)])
    assert rep.outputs() == serve_launcher.main(argv).outputs()
    with open(d / "serve_trace.json") as f:
        obj = json.load(f)
    assert jvalidate(obj) == []
    spans = [e for e in obj["traceEvents"] if e["name"] == "serve.request"]
    assert sorted(e["args"]["rid"] for e in spans) == [0, 1, 2, 3]


# ---- Fig 4a on the port -------------------------------------------------------------

def test_fig4a_sweep_holds_on_the_port():
    """benchmarks/convergence.py's Fig 4a recipe (the 24-48-8 tanh MLP,
    n 16, batch 32, lr 0.2, warm-up 10, 150 steps, p in {0, 0.01, 0.05,
    0.1, 0.2}) with its assertion, each run inside the port's
    ``wallclock`` under a registry."""
    task = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                             device="cpu")
    batch_fn = tdata.make_worker_streams(task, 16, 32)
    reg = ttel.Telemetry()
    base = None
    with ttel.enabled(reg):
        for p in (0.0, 0.01, 0.05, 0.1, 0.2):
            agg = "allreduce_model" if p == 0.0 else "rps_model"
            with wallclock(f"convergence.p{p}"):
                h = tsim.run_simulation(
                    mlp_loss_t, _teacher_init, batch_fn,
                    tsim.SimulatorConfig(n_workers=16, drop_rate=p,
                                         aggregator=agg, lr=0.2, warmup=10,
                                         steps=150, eval_every=149),
                    device="cpu")
            if p == 0.0:
                base = h["final_loss"]
            assert h["final_loss"] < base * 1.2 + 0.05, p
    assert sorted(reg.summary()["timings_s"]) == [
        f"convergence.p{p}" for p in (0.0, 0.01, 0.05, 0.1, 0.2)]
