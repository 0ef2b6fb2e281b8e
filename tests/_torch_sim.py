"""Shared helpers of the simulator parity tests: the reference simulator's
initial parameters and per-step draws (drop masks, async lateness,
corruption masks, int8 rounding noise, bitflip positions), made as
``repro.train.simulator.run_simulation`` makes them, for injection into
the port's ``run_simulation`` (``init_params=``, ``masks_fn=``,
``wire_noise_fn=``, ``pack_noise_fn=``, ``corrupt_masks_fn=``,
``corrupt_bits_fn=``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import channels as jchannels
from repro.train import simulator as jsim
from repro_torch.convert import stacked_params_from_jax
from repro_torch.train import simulator as tsim

# the reference's key-domain tags (core/rps.py, simulator.py)
WIRE_TAG = 0x77697265
CORRUPT_TAG = 0x636F7272


@pytest.fixture(scope="module")
def one_thread():
    """One torch intra-op thread for a module's tests (the suite runs
    them beside five other workers on the host's cores, where torch's
    default of one thread per core oversubscribes them), restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def to_torch(np_tree_):
    return stacked_params_from_jax(np_tree_, "cpu")


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def mlp_init(key):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (24, 48)) * 0.1,
            "w2": jax.random.normal(k2, (48, 8)) * 0.1}


def mlp_loss_j(p, batch):
    x, y = batch
    logits = jnp.tanh(x @ p["w1"]) @ p["w2"]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
    return jnp.mean(logz - gold)


def mlp_loss_t(p, batch):
    x, y = batch
    logits = torch.tanh(x @ p["w1"]) @ p["w2"]
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def _step_key(scfg, t):
    key = jax.random.split(jax.random.PRNGKey(scfg.seed))[1]
    return jax.random.fold_in(key, t)


def reference_noise(scfg):
    """The reference simulator's int8-wire uniforms for step t and
    exchange group g (simulator.py:459-460, 531; rps.py:1045):
    uniform(fold_in(fold_in(kt, 'wire'), g)) over the group's stack,
    kt = fold_in(split(PRNGKey(seed))[1], t)."""
    def noise(t, g_idx, shape):
        k = jax.random.fold_in(
            jax.random.fold_in(_step_key(scfg, t), WIRE_TAG), g_idx)
        return t_(jax.random.uniform(k, shape))

    return noise


def reference_pack_noise(scfg):
    """The reference's packed-state uniforms for step t, component
    ``which`` and leaf i (simulator.py:365-366, optimizers.py, statepack
    .py): uniform(fold_in(k, i)) with k = fold_in(fold_in(kt, 'pak'),
    0x6d / 0x76) for the moments, fold_in(kt, 'ef') for the residual."""
    def noise(t, which, i, shape):
        kt = _step_key(scfg, t)
        if which == "ef":
            k = jax.random.fold_in(kt, 0x6566)
        else:
            k = jax.random.fold_in(jax.random.fold_in(kt, 0x70616b),
                                   {"m": 0x6d, "v": 0x76}[which])
        return t_(jax.random.uniform(jax.random.fold_in(k, i), shape))

    return noise


def reference_bits(scfg):
    """The reference's bitflip positions for step t and exchange group g
    (rps.py:1025-1028, corruption.py:129):
    randint(fold_in(fold_in(kt, 'corr'), g), shape, 0, 32) as uint32."""
    def bits(t, g_idx, shape):
        k = jax.random.fold_in(
            jax.random.fold_in(_step_key(scfg, t), CORRUPT_TAG), g_idx)
        b = jax.random.randint(k, shape, 0, 32, jnp.uint32)
        return t_(np.array(b).astype(np.int32))

    return bits


def reference_channel(scfg):
    return jchannels.make_channel(
        scfg.channel, scfg.n_workers, scfg.drop_rate, s=scfg.n_servers,
        corruption=jchannels.make_corruption(
            scfg.corruption, scfg.byzantine_frac or None))


def reference_draws(init_fn, scfg):
    """The reference simulator's initial parameters, per-step masks —
    ``(rs, ag)``, or ``(rs, ag, late)`` under async — and corruption
    masks (None without corruption), drawn as simulator.py:459-531 and
    315-347 draw them."""
    key = jax.random.PRNGKey(scfg.seed)
    k_init, key = jax.random.split(key)
    p1 = init_fn(k_init)
    if not scfg.aggregator.startswith("rps"):
        return p1, None, None
    channel = reference_channel(scfg)
    corrupting = getattr(channel, "corruption", None) is not None
    ch_state = channel.init_state(jax.random.fold_in(key, 0x636831))
    plan = jsim.make_exchange_plan(p1, scfg, channel)
    slack = None
    if scfg.schedule == "async":
        deadline = getattr(channel, "deadline_ms", None)
        slack = plan.slack_ms(float(deadline)) if deadline is not None \
            else np.zeros(plan.n_buckets, np.float64)
    masks, cmasks = [], []
    for t in range(scfg.steps):
        kt = jax.random.fold_in(key, t)
        late = None
        if slack is not None:
            rs, ag, late, ch_state = channel.sample_async(kt, ch_state,
                                                          slack)
        elif plan.per_bucket_masks:
            rs, ag, ch_state = channel.sample_packets(kt, ch_state,
                                                      plan.n_buckets)
        else:
            rs, ag, ch_state = channel.sample(kt, ch_state)
        pair = (t_(rs), t_(ag))
        if late is not None:
            pair += ({k: t_(v) for k, v in late.items()},)
        masks.append(pair)
        if corrupting:
            nb = rs.shape[0] if rs.ndim == 3 else None
            cmasks.append(t_(channel.sample_corruption(kt, n_buckets=nb)))
    return p1, masks, (cmasks if corrupting else None)


def run_both(kw, jloss, jinit, jbatch, tloss, tbatch, n=4, steps=5,
             eager=False, chaotic_from=None):
    """The reference simulator (jitted, or op by op with ``eager``) and
    the port's on its initial parameters, masks, int8 and packed-state
    uniforms and corruption draws; the per-step loss within 1e-4, the consensus within
    1e-4 — from step ``chaotic_from`` on, where a run on the int8 grid
    has turned chaotic, within 1e-2."""
    base = dict(n_workers=n, steps=steps, eval_every=1, lr=0.2, warmup=2,
                seed=0)
    base.update(kw)
    jscfg = jsim.SimulatorConfig(**base)
    if eager:
        with jax.disable_jit():
            jh = jsim.run_simulation(jloss, jinit, jbatch, jscfg)
    else:
        jh = jsim.run_simulation(jloss, jinit, jbatch, jscfg)
    p1, masks, cmasks = reference_draws(jinit, jscfg)
    th = tsim.run_simulation(
        tloss, None, tbatch, tsim.SimulatorConfig(**base), device="cpu",
        init_params=to_torch(np_tree(p1)),
        masks_fn=None if masks is None else (lambda t: masks[t]),
        wire_noise_fn=reference_noise(jscfg),
        pack_noise_fn=reference_pack_noise(jscfg),
        corrupt_masks_fn=None if cmasks is None else (lambda t: cmasks[t]),
        corrupt_bits_fn=reference_bits(jscfg))
    assert th["step"] == jh["step"] == list(range(steps))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    k = steps if chaotic_from is None else chaotic_from
    np.testing.assert_allclose(th["consensus"][:k], jh["consensus"][:k],
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(th["consensus"][k:], jh["consensus"][k:],
                               rtol=1e-2, atol=1e-9)
    assert th["exchange_plan"] == jh["exchange_plan"]
    assert th["channel_effective_p"] == jh["channel_effective_p"]
    # the jitted reference divides the late count by the (constant)
    # offered count as a product by its reciprocal: one f32 ulp from the
    # correctly rounded quotient the port (and the reference op by op)
    # computes
    assert len(th["staleness"]) == len(jh["staleness"])
    np.testing.assert_allclose(th["staleness"], jh["staleness"],
                               rtol=2.0 ** -23, atol=0)
    np.testing.assert_allclose(th["corrupt_frac"], jh["corrupt_frac"],
                               rtol=1e-6)
    return th, jh
