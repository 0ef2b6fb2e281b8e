"""The port's channel families against the JAX package's.

Torch cannot reproduce JAX's threefry stream, so each channel's sampling
is split in two, and the tests feed the pure half
(``Channel.from_draws``, ``DeadlineChannel.async_from_draws``,
``GilbertElliottChannel.init_from_draws``) the variates the reference
drew from its own key splits:

- Gilbert–Elliott: ``k_tr, k_rs, k_ag = split(key, 3)``; the transition's
  uniforms from ``k_tr`` and ``fold_in(k_tr, 1)``; the initial state from
  ``fold_in(key, 0x6E11)``;
- heterogeneous and trace: ``k_rs, k_ag = split(key)``;
- deadline: ``k_s, k_rs, k_ag = split(key, 3)``, the jitter as the
  reference's own exponentials (``-log1p(-u)``), not uniforms.

Over 60 keys, at s = n and s != n, ``sample`` and ``sample_packets`` (GE
chained over 20 steps), the masks and the state equal the reference's bit
for bit. The closed forms, the netsim module, the registry and the
generator path's marginals follow, and the simulator on the reference's
GE masks matches the reference within 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as J
from repro.netsim import sim as jnetsim
from repro.train import simulator as jsim
from repro_torch import channels as T
from repro_torch import tree as tree_lib
from repro_torch.netsim import sim as tnetsim
from repro_torch.train import simulator as tsim

N_KEYS = 60


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _eq(a, b):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _trace(T_=7, srv=5, seed=0):
    rng = np.random.default_rng(seed)
    up = rng.uniform(0, 0.4, (T_, srv)).astype(np.float32)
    down = rng.uniform(0, 0.3, (T_, srv)).astype(np.float32)
    up[0, 0] = 1.0
    down[1] = 0.0
    return {"up": up, "down": down}


def _pair(family, n, s):
    """The same channel in both packages."""
    if family == "ge":
        kw = dict(p_bad=0.8, burst=4.0, p=0.2, s=s)
        return J.GilbertElliottChannel(n, **kw), T.GilbertElliottChannel(
            n, **kw)
    if family == "hetero":
        rng = np.random.default_rng(n)
        pm = rng.uniform(0.0, 0.6, (n, n)).astype(np.float32)
        pm[0] = 0.0
        return J.HeterogeneousChannel(n, pm, s=s), T.HeterogeneousChannel(
            n, pm, s=s)
    if family == "pods":
        pods = min(n, 2)
        return J.HeterogeneousChannel.pods(n, pods, 0.05, 0.4, s=s), \
            T.HeterogeneousChannel.pods(n, pods, 0.05, 0.4, s=s)
    if family == "deadline":
        kw = dict(deadline_ms=6.0, base_ms=1.5, jitter_ms=2.0,
                  straggler_frac=0.3, straggler_mult=3.0, s=s)
        return J.DeadlineChannel(n, **kw), T.DeadlineChannel(n, **kw)
    if family == "trace":
        tr = _trace()
        return J.TraceChannel(n, tr, s=s), T.TraceChannel(n, tr, s=s)
    raise ValueError(family)


def _ref_draws(family, jc, key, lead=()):
    """The variates the reference channel's ``sample`` / ``sample_packets``
    draws from ``key``."""
    n = jc.n
    nn = (n, n)
    if family == "ge":
        k_tr, k_rs, k_ag = jax.random.split(key, 3)
        return {"stay": _u(k_tr, nn),
                "enter": _u(jax.random.fold_in(k_tr, 1), nn),
                "rs": _u(k_rs, lead + nn), "ag": _u(k_ag, lead + nn)}
    if family in ("hetero", "pods", "trace"):
        k_rs, k_ag = jax.random.split(key)
        lead = () if family == "trace" else lead
        return {"rs": _u(k_rs, lead + nn), "ag": _u(k_ag, lead + nn)}
    k_s, k_rs, k_ag = jax.random.split(key, 3)
    return {"straggle": _u(k_s, (n,)),
            "rs": _t(jax.random.exponential(k_rs, lead + nn)),
            "ag": _t(jax.random.exponential(k_ag, lead + nn))}


def _init(family, jc, tc, key):
    if family == "ge":
        js = jc.init_state(key)
        ts = tc.init_from_draws(_u(jax.random.fold_in(key, 0x6E11),
                                   (jc.n, jc.n)))
        _eq(ts["bad"], js["bad"])
        return js, ts
    js, ts = jc.init_state(key), tc.init_state()
    assert (js is None) == (ts is None)
    return js, ts


def _check_state(family, ts, js):
    if family == "ge":
        _eq(ts["bad"], js["bad"])
    elif family == "trace":
        assert ts["t"] == int(js["t"])
    else:
        assert ts is js is None


FAMILIES = ("ge", "hetero", "pods", "deadline", "trace")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,s", [(8, 8), (4, 8), (8, 4), (16, 16),
                                 (16, 6)])
def test_masks_and_state_equal_reference(family, n, s):
    """Over 60 keys, a chain of steps alternating ``sample`` and
    ``sample_packets`` (3 buckets): the port's masks (shape, dtype and
    every bit) and state equal the reference channel's; GE and trace
    carry their state through the chain (GE 20 steps a chain, 3
    chains)."""
    jc, tc = _pair(family, n, s)
    k0 = jax.random.PRNGKey(n * 31 + s)
    steps = 20
    for chain in range(N_KEYS // steps):
        key = jax.random.fold_in(k0, chain)
        js, ts = _init(family, jc, tc, key)
        for step in range(steps):
            kt = jax.random.fold_in(key, step)
            if step % 2:
                jrs, jag, js = jc.sample_packets(kt, js, 3)
                if family in ("deadline", "trace"):   # one draw, broadcast
                    trs, tag, ts = tc.from_draws(_ref_draws(family, jc, kt),
                                                 ts)
                    trs, tag = trs.expand((3,) + trs.shape), \
                        tag.expand((3,) + tag.shape)
                else:
                    trs, tag, ts = tc.from_draws(
                        _ref_draws(family, jc, kt, (3,)), ts)
            else:
                jrs, jag, js = jc.sample(kt, js)
                trs, tag, ts = tc.from_draws(_ref_draws(family, jc, kt), ts)
            assert trs.dtype == tag.dtype == torch.bool
            assert tuple(trs.shape) == tuple(jrs.shape)
            _eq(trs, jrs)
            _eq(tag, jag)
            _check_state(family, ts, js)


@pytest.mark.parametrize("n,s", [(8, 8), (4, 8), (16, 6)])
def test_deadline_sample_async_equals_reference(n, s):
    """The deadline channel's half of the async schedule: per-bucket
    masks and the lateness axis at the reference's slacks, bit for bit
    over 60 keys; the base class's fallback is the sync masks with no
    packet late."""
    jc, tc = _pair("deadline", n, s)
    slack = np.array([6.0, 4.5, 2.0, -1.0])
    for k in range(N_KEYS):
        key = jax.random.PRNGKey(1000 + k)
        jrs, jag, jlate, _ = jc.sample_async(key, None, slack)
        trs, tag, tlate, st = tc.async_from_draws(
            _ref_draws("deadline", jc, key, (4,)), None, slack)
        assert st is None
        for a, b in ((trs, jrs), (tag, jag), (tlate["rs"], jlate["rs"]),
                     (tlate["ag"], jlate["ag"])):
            _eq(a, b)
    gen = torch.Generator().manual_seed(0)
    for family in ("ge", "pods", "trace"):
        _, tc = _pair(family, n, s)
        st0 = tc.init_state(torch.Generator().manual_seed(1))
        rs, ag, late, _ = tc.sample_async(gen, st0, slack)
        assert tuple(rs.shape) == (4, n, s)
        assert not late["rs"].any() and not late["ag"].any()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,s", [(8, 8), (4, 8), (16, 6), (1, 1)])
def test_closed_forms_equal_reference(family, n, s):
    jc, tc = _pair(family, n, s)
    assert tc.effective_p() == jc.effective_p()
    np.testing.assert_array_equal(tc.expected_link_p(),
                                  jc.expected_link_p())
    np.testing.assert_array_equal(tc.expected_link_p_ag(),
                                  jc.expected_link_p_ag())
    assert repr(tc).replace("Channel", "") == repr(jc).replace("Channel", "")
    if family == "ge":
        assert tc.pi_bad == jc.pi_bad and tc.p_gb == jc.p_gb
    if family == "deadline":
        grid = np.concatenate([np.linspace(-2.0, 20.0, 111),
                               [1.5, 4.5, 1e-9]])
        np.testing.assert_array_equal(tc.effective_p_at(grid),
                                      jc.effective_p_at(grid))
        assert tc.effective_p_at(3.0) == jc.effective_p_at(3.0)


@pytest.mark.parametrize("kw", [dict(p_bad=1.0, burst=16.0, p=0.1),
                                dict(p_bad=0.3, burst=8.0),
                                dict(p_bad=0.5, burst=2.0, p_gb=0.2,
                                     p_good=0.1)])
def test_ge_closed_forms_for_its_parameterisations(kw):
    jc, tc = J.GilbertElliottChannel(16, **kw), T.GilbertElliottChannel(
        16, **kw)
    assert (tc.pi_bad, tc.p_gb, tc.p_bg, tc.effective_p()) == \
        (jc.pi_bad, jc.p_gb, jc.p_bg, jc.effective_p())


# ---- the netsim module ----------------------------------------------------

@pytest.mark.parametrize("lam,prio", [(2000.0, 0.0), (8000.0, 0.3),
                                      (5000.0, 1.0), (12000.0, 0.8)])
def test_netsim_simulate_and_export_equal_reference(lam, prio):
    for cfg_kw in (dict(sim_s=0.3), dict(sim_s=0.2, n_servers=6,
                                          burst_period_ms=30.0, seed=3)):
        tc, jc = tnetsim.NetConfig(**cfg_kw), jnetsim.NetConfig(**cfg_kw)
        assert tnetsim.simulate(lam, prio, tc) == \
            jnetsim.simulate(lam, prio, jc)
        a, b = tnetsim.export_trace(lam, prio, tc), \
            jnetsim.export_trace(lam, prio, jc)
        assert set(a) == set(b) == {"up", "down"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert dataclasses_fields(tnetsim.NetConfig) == \
        dataclasses_fields(jnetsim.NetConfig)


def dataclasses_fields(cls):
    import dataclasses
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_netsim_curves_equal_reference():
    cfg = dict(sim_s=0.1)
    assert tnetsim.speedup_curve(3000.0, cfg=tnetsim.NetConfig(**cfg)) == \
        jnetsim.speedup_curve(3000.0, cfg=jnetsim.NetConfig(**cfg))
    cfg = dict(sim_s=0.05)
    kw = dict(prios=(0.0, 0.5, 1.0))
    assert tnetsim.cost_reduction_curve(
        20.0, cfg=tnetsim.NetConfig(**cfg), **kw) == \
        jnetsim.cost_reduction_curve(20.0, cfg=jnetsim.NetConfig(**cfg), **kw)


def test_trace_channel_from_netsim_and_npz(tmp_path):
    """from_netsim, save / load and from_npz give the reference's p_trace
    (the same f32 numbers), the same period count and marginal."""
    cfg_t, cfg_j = tnetsim.NetConfig(sim_s=0.3), jnetsim.NetConfig(sim_s=0.3)
    tc = T.TraceChannel.from_netsim(16, 8000.0, 0.6, cfg_t)
    jc = J.TraceChannel.from_netsim(16, 8000.0, 0.6, cfg_j)
    assert tc.n_periods == jc.n_periods
    assert tc.p_trace.dtype == torch.float32
    _eq(tc.p_trace, jc.p_trace)
    path = os.path.join(tmp_path, "tr.npz")
    T.save_trace(path, tnetsim.export_trace(8000.0, 0.6, cfg_t))
    back = T.load_trace(path)
    np.testing.assert_array_equal(back["up"], jnetsim.export_trace(
        8000.0, 0.6, cfg_j)["up"])
    tn = T.TraceChannel.from_npz(16, path, s=8)
    jn = J.TraceChannel.from_npz(16, path, s=8)
    assert tn.effective_p() == jn.effective_p()
    spec = f"trace:path={path}"
    assert T.make_channel(spec, 16).effective_p() == \
        J.make_channel(spec, 16).effective_p()
    assert T.make_channel("netsim:lam=3000,prio=0.9", 4).effective_p() == \
        J.make_channel("netsim:lam=3000,prio=0.9", 4).effective_p()


@pytest.mark.parametrize("bad", [
    {"up": np.zeros((3,)), "down": np.zeros((3,))},
    {"up": np.zeros((2, 3)), "down": np.zeros((3, 3))},
    {"up": np.full((2, 3), 1.5), "down": np.zeros((2, 3))}])
def test_trace_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        J.TraceChannel(4, bad)
    with pytest.raises(ValueError) as got:
        T.TraceChannel(4, bad)
    assert str(got.value) == str(want.value)


# ---- the registry ---------------------------------------------------------

SPECS = ("bernoulli:p=0.2", "iid", "bern:p=0.05,s=8",
         "ge:p_bad=0.3,burst=8", "gilbert:p_bad=1.0,burst=8,p=0.1",
         "gilbert-elliott:p_bad=0.5,burst=2,p_gb=0.2",
         "gilbert_elliott:p_bad=0.9,burst=4.5,p=0.2,p_good=0.01",
         "hetero:n_pods=4,p_intra=0.0,p_cross=0.3", "pods",
         "heterogeneous:n_pods=2,p_cross=0.1", "deadline",
         "deadline:deadline_ms=8,straggler_frac=0.2",
         "straggler:deadline_ms=5,base_ms=0,jitter_ms=1",
         " GE:p_bad = 0.4 , burst = 3 ,")


@pytest.mark.parametrize("spec", SPECS)
def test_registry_builds_what_the_reference_builds(spec):
    for n, s in ((4, None), (8, 4), (4, 8)):
        if "s=8" in spec and s not in (None, 8):
            continue
        tc = T.make_channel(spec, n, default_p=0.15, s=s)
        jc = J.make_channel(spec, n, default_p=0.15, s=s)
        assert type(tc).__name__ == type(jc).__name__
        assert (tc.n, tc.s) == (jc.n, jc.s)
        assert tc.effective_p() == jc.effective_p()
        assert repr(tc).replace("Channel", "") == \
            repr(jc).replace("Channel", "")
    assert T.parse_spec(spec) == J.parse_spec(spec)
    assert T.channel_names() == J.channel_names()


@pytest.mark.parametrize("spec", [
    "nonsense", "ge:p_bad", "ge:p_bad=0.2,p_good=0.5", "ge:burst=0.5",
    "ge:p_bad=0.5,p=0.6", "ge:p=0.1,p_gb=0.1", "ge:bogus=1",
    "pods:n_pods=3", "hetero:p_cross=2.0", "deadline:deadline_ms=0",
    "deadline:straggler_mult=0.5", "deadline:base_ms=-1",
    "deadline:straggler_frac=1.5", "bernoulli:p=1.5",
    "bernoulli:p=0.1,s=3", "trace:lam=100,prio=0.1,typo=1",
    " GE : p_bad = 0.4"])
def test_registry_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        J.make_channel(spec, 4, s=4)
    with pytest.raises(ValueError) as got:
        T.make_channel(spec, 4, s=4)
    assert str(got.value) == str(want.value)


def test_registry_instances_register_and_corruption():
    ch = T.GilbertElliottChannel(4, p_bad=0.5, burst=2.0)
    assert T.make_channel(ch, 4) is ch
    with pytest.raises(ValueError, match="need n=8"):
        T.make_channel(ch, 8)
    with pytest.raises(ValueError, match="need s=2"):
        T.make_channel(ch, 4, s=2)
    got = T.make_channel("ge", 4, corruption="signflip:byzantine_frac=0.25")
    want = J.make_channel("ge", 4, corruption="signflip:byzantine_frac=0.25")
    assert isinstance(got, T.CorruptionChannel)
    assert repr(got.corruption) == repr(want.corruption)
    assert got.effective_p() == want.effective_p()
    assert T.make_channel(None, 4, 0.3, corruption=None).p == 0.3
    T.register("ge2", T.GilbertElliottChannel, aliases=("ge_two",))
    try:
        assert isinstance(T.make_channel("ge_two:p_bad=0.2", 4),
                          T.GilbertElliottChannel)
    finally:
        from repro_torch.channels import registry
        registry._REGISTRY.pop("ge2")
        registry._ALIASES.pop("ge_two")


# ---- the port's own draws -------------------------------------------------

@pytest.mark.parametrize("spec", [
    "ge:p_bad=1.0,burst=4,p=0.1", "pods:n_pods=4,p_cross=0.125",
    "deadline:deadline_ms=9,straggler_frac=0.2", "trace:lam=8000,prio=0.5"])
def test_generator_marginal_in_binomial_band(spec):
    """Off-owner drop fraction over many steps drawn from the port's
    generator (s != n, per-bucket draws where the family has them) within
    5 sigma of the closed-form marginal (the trace's: the mean of p_trace
    over the periods replayed); owner entries always delivered."""
    n, s, steps, nb = 8, 12, 400, 2
    ch = T.make_channel(spec, n, s=s)
    gen = torch.Generator().manual_seed(5)
    st = ch.init_state(gen)
    own = T.force_diag(torch.zeros((n, s), dtype=torch.bool),
                       torch.zeros((n, s), dtype=torch.bool))[0]
    drops, total = 0, 0
    for _ in range(steps):
        rs, ag, st = ch.sample_packets(gen, st, nb)
        assert bool(rs[:, own].all()) and bool(ag[:, own].all())
        drops += int((~rs[:, ~own]).sum()) + int((~ag[:, ~own]).sum())
        total += 2 * rs[:, ~own].numel()
    frac = drops / total
    if isinstance(ch, T.TraceChannel):
        idx = np.arange(steps) % ch.n_periods
        off = ~np.eye(n, dtype=bool)
        want = float(ch.p_trace.numpy()[idx][:, off].mean())
        assert st["t"] == steps
    else:
        want = ch.effective_p()
    # the per-step, per-row correlation of GE and deadline widens the
    # band: 5 sigma of the i.i.d. band times sqrt(n) covers it
    sigma = np.sqrt(want * (1 - want) / total) * np.sqrt(n)
    assert abs(frac - want) < 5 * sigma + 1e-3, (frac, want)


def test_ge_mean_burst_length_from_the_generator():
    """With p_bad = 1 a link's consecutive-drop runs (per bucket of one)
    have mean length ``burst`` within 10 %, and the stationary bad
    fraction is pi_bad."""
    n, burst, steps = 16, 8.0, 3000
    ch = T.GilbertElliottChannel(n, p_bad=1.0, burst=burst, p=0.2)
    gen = torch.Generator().manual_seed(9)
    st = ch.init_state(gen)
    bad = []
    for _ in range(steps):
        _, _, st = ch.sample(gen, st)
        bad.append(st["bad"].clone())
    bad = torch.stack(bad).numpy()                     # (steps, n, n)
    off = ~np.eye(n, dtype=bool)
    runs = []
    for i, j in zip(*np.nonzero(off)):
        x = bad[:, i, j].astype(np.int8)
        edges = np.diff(np.concatenate([[0], x, [0]]))
        starts, ends = np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]
        runs.extend((ends - starts)[(starts > 0) & (ends < steps)])
    assert abs(np.mean(runs) / burst - 1) < 0.1, np.mean(runs)
    assert abs(bad[:, off].mean() - ch.pi_bad) < 0.02


# ---- the simulator on the reference's channel masks -----------------------

def _mlp_init(key):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (24, 48)) * 0.1,
            "w2": jax.random.normal(k2, (48, 8)) * 0.1}


def _mlp_loss_j(p, batch):
    x, y = batch
    logits = jnp.tanh(x @ p["w1"]) @ p["w2"]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
    return jnp.mean(logz - gold)


def _mlp_loss_t(p, batch):
    x, y = batch
    logits = torch.tanh(x @ p["w1"]) @ p["w2"]
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


@pytest.mark.parametrize("kw", [
    dict(channel="ge:p_bad=1.0,burst=4,p=0.2", engine="ring"),
    dict(channel="ge:p_bad=0.7,burst=3,p=0.3", engine="xla", n_buckets=2),
    dict(channel="ge:p_bad=1.0,burst=8,p=0.2", engine="ring",
         aggregator="rps_grad", n_servers=8),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simulator_on_reference_ge_masks(kw):
    """The simulator fed the reference simulator's own GE masks (drawn
    from kt = fold_in(key, t) through its channel, its state chained from
    fold_in(key, 0x636831)) and initial parameters: the per-step loss and
    consensus within 1e-6 of the reference run op by op, over 6 steps; the
    channel's repr and effective_p are the reference's."""
    from repro.data import synthetic as jdata
    from repro_torch.data import synthetic as tdata
    n, steps = 4, 6
    base = dict(n_workers=n, steps=steps, eval_every=1, lr=0.2, warmup=2,
                seed=0, aggregator="rps_model")
    base.update(kw)
    jscfg = jsim.SimulatorConfig(**base)
    jtask = jdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    ttask = tdata.TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0,
                              device="cpu")
    with jax.disable_jit():
        jh = jsim.run_simulation(_mlp_loss_j, _mlp_init,
                                 jdata.make_worker_streams(jtask, n, 16),
                                 jscfg)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    p1 = _mlp_init(jax.random.split(jax.random.PRNGKey(0))[0])
    channel = J.make_channel(jscfg.channel, n, s=jscfg.n_servers)
    ch = channel.init_state(jax.random.fold_in(key, 0x636831))
    plan = jsim.make_exchange_plan(p1, jscfg, channel)
    masks = []
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        if plan.per_bucket_masks:
            rs, ag, ch = channel.sample_packets(kt, ch, plan.n_buckets)
        else:
            rs, ag, ch = channel.sample(kt, ch)
        masks.append((_t(rs), _t(ag)))
    th = tsim.run_simulation(
        _mlp_loss_t, None, tdata.make_worker_streams(ttask, n, 16),
        tsim.SimulatorConfig(**base), device="cpu",
        init_params=tree_lib.map(_t, p1), masks_fn=lambda t: masks[t])
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(th["consensus"], jh["consensus"], rtol=1e-6,
                               atol=1e-12)
    assert th["channel"].replace("Channel", "") == \
        jh["channel"].replace("Channel", "")
    assert th["channel_effective_p"] == jh["channel_effective_p"]


def test_simulator_channel_state_advances_every_step():
    """Without masks_fn the simulator draws from the channel, whose state
    advances once per step, exchange or not (trace: t == steps)."""
    from repro_torch.data import synthetic as tdata
    task = tdata.TeacherTask(d_in=24, n_classes=8, seed=0, device="cpu")

    def init_fn(gen):
        return {"w1": torch.randn((24, 48), generator=gen) * 0.1,
                "w2": torch.randn((48, 8), generator=gen) * 0.1}

    tr = _trace()
    ch = T.TraceChannel(4, tr)
    h = tsim.run_simulation(
        _mlp_loss_t, init_fn, tdata.make_worker_streams(task, 4, 8),
        tsim.SimulatorConfig(n_workers=4, steps=5, exchange_every=2,
                             channel=ch, engine="ring"), device="cpu")
    assert h["channel_state"] == {"t": 5}
    for spec in ("ge:p_bad=1.0,burst=4,p=0.2", "pods:n_pods=2",
                 "deadline"):
        h = tsim.run_simulation(
            _mlp_loss_t, init_fn, tdata.make_worker_streams(task, 4, 8),
            tsim.SimulatorConfig(n_workers=4, steps=3, channel=spec,
                                 n_buckets=2), device="cpu")
        assert np.isfinite(h["final_loss"])
