"""The port's mesh trainer (``repro_torch.train.trainer``, one process per
RPS worker, gloo on the CPU) against the reference's ``make_train_setup``
under ``shard_map`` on forced host devices.

rps-paper-mlp (reduced, f32, the reference's ungrouped model) on a (4,)
data mesh — the reference on ``jax.make_mesh((4, 1), ("data",
"model"))`` — from the same initial replica (the reference's
``model.init``, carried over with ``convert.stacked_params_from_jax``),
the same ``make_batch`` rows, the same masks (the reference's in-step
``sample_masks`` draw, or its channel's, handed to the port as
``masks=``) and SGD, 3 steps each:

- ``rps_model`` on the xla engine on a Gilbert-Elliott channel, and on
  the ring engine with ``recovery="ef"`` on the int8 wire;
- ``rps_grad`` on 2 pods x 2 (``("pod", "data")``): the pod's ranks
  average their gradients reliably, the pods exchange them;
- the ``allreduce_model`` baseline.

Every step's loss and every final parameter within 1e-5 (the jitted
reference differs from the port's eager arithmetic by f32 roundings); on
the int8 wire, where the jitted encode multiplies by the reciprocal of
127, at most a 1e-3 share of the parameters within one grid step
instead. The reference runs in four subprocesses (a config each) while
the port's world runs.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro import channels as jchannels
from repro.configs import get_config as jget_config
from repro.core import rps as jrps
from repro.models import build_model as jbuild_model
from repro.models.inputs import make_batch

import _torch_dist as td

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
TOL = 1e-5
PARTS = 4              # reference subprocesses, a config each
GE = "ge:p_bad=1.0,burst=4,p=0.3"

CONFIGS = {
    "rps_model-xla-channel": dict(aggregator="rps_model", engine="xla",
                                  channel=GE),
    "rps_model-ring-ef-int8": dict(aggregator="rps_model", engine="ring",
                                   wire="int8", recovery="ef"),
    "rps_grad-pods": dict(aggregator="rps_grad", engine="xla"),
    "allreduce_model": dict(aggregator="allreduce_model"),
}
# the trainer's other knobs, on the port alone in the same world: the
# microbatched step against the whole-batch one (the same masks), and
# runs that draw their own masks from the step's generator
OPTIONS = {
    "base": dict(aggregator="rps_model", engine="xla"),
    "microbatch2": dict(aggregator="rps_model", engine="xla", microbatch=2),
    "exchange_every2-telemetry": dict(aggregator="rps_model", engine="ring",
                                      exchange_every=2, telemetry=True),
    "async-deadline": dict(aggregator="rps_model", engine="ring",
                           n_buckets=2, schedule="async", compute_ms=8.0,
                           channel="deadline:deadline_ms=10,base_ms=1,"
                                   "jitter_ms=3"),
    "corruption-trimmed": dict(aggregator="rps_model", engine="xla",
                               corruption="signflip:frac=0.2",
                               recovery="trimmed:beta=0.25"),
    "momentum-bf16-pack": dict(aggregator="rps_model", engine="ring",
                               optimizer="momentum", state_pack="bf16",
                               n_buckets=2),
}
DRAWN = ("exchange_every2-telemetry", "async-deadline",
         "corruption-trimmed", "momentum-bf16-pack")
# the int8 wire: the jitted reference's encode multiplies by the
# reciprocal of 127 where the port divides, which moves a few elements'
# rounding by one grid step of their row (max|x| / 127)
INT8_STEP, INT8_SHARE = 4e-3, 1e-3


def _inputs():
    """The reference's initial replica, the worker-stacked batch and every
    config's per-step masks, made in process."""
    cfg = jget_config("rps-paper-mlp").reduced()
    p1 = jax.tree.map(np.asarray,
                      jbuild_model(cfg, grouped=False).init(
                          jax.random.PRNGKey(0)))
    batch = jax.tree.map(np.asarray, make_batch(cfg, 8, 32))
    specs = {}
    for name, kw in CONFIGS.items():
        pods = name == "rps_grad-pods"
        n = 2 if pods else 4
        tcfg = dict(optimizer="sgd", lr=0.1, drop_rate=0.3, **kw)
        masks = []
        ch = None
        if kw.get("channel"):
            ch = jchannels.make_channel(kw["channel"], n, 0.3)
            state = ch.init_state(jax.random.PRNGKey(100))
        for t in range(STEPS):
            key = jax.random.PRNGKey(100 + t)
            if kw["aggregator"].startswith("allreduce"):
                masks.append(None)
            elif ch is not None:
                rs, ag, state = ch.sample(key, state)
                masks.append((np.asarray(rs), np.asarray(ag)))
            else:
                rs, ag = jrps.sample_masks(key, n, 0.3, n)
                masks.append((np.asarray(rs), np.asarray(ag)))
        specs[name] = dict(
            fn="_torch_dist.trainer_case", tcfg=tcfg, p1=p1, steps=STEPS,
            batch=jax.tree.map(lambda x: x.reshape((n, -1) + x.shape[1:]),
                               batch),
            masks=masks,
            mesh=(2, 2) if pods else (4,),
            axes=("pod", "data") if pods else ("data",),
            rps_axes=("pod",) if pods else ("data",))
    base = specs["rps_model-xla-channel"]
    for name, kw in OPTIONS.items():
        tcfg = dict(optimizer="sgd", lr=0.1, drop_rate=0.3)
        tcfg.update(kw)
        specs["opt-" + name] = dict(
            base, tcfg=tcfg,
            masks=[None] * STEPS if name in DRAWN else base["masks"])
    return specs


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.train.trainer import TrainConfig, make_train_setup

    specs = pickle.load(open(sys.argv[1], "rb"))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    specs = {k: specs[k] for k in sorted(k for k in specs
                                          if not k.startswith("opt-"))
             [part::parts]}
    cfg = get_config("rps-paper-mlp").reduced()
    model = build_model(cfg, grouped=False)
    auto = (jax.sharding.AxisType.Auto,)
    out = {}
    for name, c in specs.items():
        pods = c["mesh"] == (2, 2)
        mesh = jax.make_mesh((2, 2, 1) if pods else (4, 1),
                             ("pod", "data", "model") if pods
                             else ("data", "model"),
                             axis_types=auto * (3 if pods else 2))
        tcfg = TrainConfig(**c["tcfg"])
        init_state, train_step, state_shardings = make_train_setup(
            model, cfg, tcfg, mesh, rps_axes=tuple(c["rps_axes"]))
        # every replica the initial one (init_state's, made once in the
        # parent), laid out as the step returns it, so that the step
        # compiles once; SGD keeps no state
        n = 2 if pods else 4
        params = jax.tree.map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + x.shape),
            c["p1"])
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        if tcfg.aggregator.startswith("allreduce"):
            params = jax.device_put(params, rep)
        else:            # the step returns the leaves split on dim 0 only
            p_sh, _ = state_shardings(jax.eval_shape(lambda t: t, params))
            params = jax.device_put(params, jax.tree.map(
                lambda sh: jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(sh.spec[0])), p_sh))
        opt_state = ()
        batch = jax.tree.map(jnp.asarray, c["batch"])
        extra = []
        if tcfg.channel:
            extra.append(jax.device_put(train_step.init_channel_state(
                jax.random.PRNGKey(100)), rep))
        if tcfg.recovery == "ef":
            if not tcfg.channel:
                extra.append(None)
            extra.append(train_step.init_ef_state(params))
        losses = []
        with jax.set_mesh(mesh):
            step = jax.jit(train_step)
            for t in range(%d):
                res = step(params, opt_state, batch, jnp.int32(t),
                           jax.random.PRNGKey(100 + t), *extra)
                params, opt_state, met = res[:3]
                if tcfg.channel:
                    extra[0] = res[3]
                if tcfg.recovery == "ef":
                    extra[-1] = res[-1]
                losses.append(float(met["loss"]))
        out[name] = {"loss": np.array(losses),
                     "params": jax.tree.map(np.asarray, params)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % (SRC, STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    specs = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(specs, f)
    env = dict(os.environ)
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_backend_optimization_level=0 "
                             "--xla_llvm_disable_expensive_passes=true"})
    procs = [subprocess.Popen([sys.executable, "-c", _REF,
                               str(tmp / "in.pkl"), str(tmp / f"out{j}.pkl"),
                               str(j), str(PARTS)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for j in range(PARTS)]
    try:
        port = td.run_cases(specs)
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    ref = {}
    for j, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, out + err
        with open(tmp / f"out{j}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return specs, port, ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_equals_reference(runs, name):
    specs, port, ref = runs
    ranks = port[name]
    want = ref[name]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r} losses")
    pods = specs[name]["mesh"] == (2, 2)
    for r, got in enumerate(ranks):
        w = r // 2 if pods else r        # the rank's replica
        flat_got = jax.tree.leaves(got["params"])
        flat_want = jax.tree.leaves(jax.tree.map(lambda x: x[w],
                                                 want["params"]))
        assert len(flat_got) == len(flat_want)
        int8 = specs[name]["tcfg"].get("wire") == "int8"
        off = total = 0
        for a, b in zip(flat_got, flat_want):
            b = np.asarray(b, np.float32)
            if int8:
                off += int(np.sum(np.abs(a - b) > TOL))
                total += a.size
                np.testing.assert_allclose(a, b, rtol=0, atol=INT8_STEP)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                           err_msg=f"rank {r} params")
        assert off <= INT8_SHARE * max(total, 1), (r, off, total)
    if pods:       # the ranks of a pod hold one replica
        for a, b in zip(jax.tree.leaves(ranks[0]["params"]),
                        jax.tree.leaves(ranks[1]["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_trainer_options_run(runs, name):
    """The knobs the reference comparison leaves out, on the port: a
    microbatched step equals the whole-batch one (the mean of the halves'
    gradients) within 1e-5; every run's losses are finite and its
    replicas' pod / rank structure holds; telemetry adds the step's
    counters (the reference's keys)."""
    _, port, _ = runs
    ranks = port["opt-" + name]
    for got in ranks:
        assert np.all(np.isfinite(got["loss"]))
    if name == "microbatch2":
        base = port["opt-base"]
        for got, want in zip(ranks, base):
            np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL,
                                       rtol=0)
            for a, b in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(want["params"])):
                np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    if "telemetry" in name:
        for got in ranks:
            assert len(got["tel"]) == STEPS
            assert {"grad_norm", "rs_link_delivered",
                    "link_offered"} <= set(got["tel"][0])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-large-v3",
                                  "llava-next-mistral-7b", "fsdp"])
def test_trainer_refuses_tp_and_fsdp(arch):
    """A "model" axis > 1 runs every family: each arch reduced builds its
    train setup on (2, 2) ("data", "model"), and its loss under the
    setup's TP context runs on a shape-only mesh's rank (meta tensors),
    the model group's collectives recorded: mixtral-8x22b's MoE width
    branch joins its hidden and output (``tests/test_torch_trainer_moe_tp.py``),
    rwkv6's time-mix and channel-mix join their inputs and outputs (4 a
    layer) and recurrentgemma's rec layers 3 a layer; whisper's and
    llava-next's 4 heads stay whole (the rule splits 16), so their
    joins are none (``tests/test_torch_trainer_families_tp.py``). Refused
    with a ValueError naming it is what the rule cannot lay out: RWKV-6's
    4 heads over a "model" axis of 8. FSDP runs
    (``tests/test_torch_trainer_fsdp.py``), but not over the axis that
    holds the replicas: FSDP over "data" with ``rps_axes=("data",)`` is
    refused with a ValueError that names FSDP."""
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models import parallel as P
    from repro_torch.models.inputs import train_specs
    from repro_torch.roofline.count import MetaGenerator
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    if arch == "fsdp":
        cfg = get_config("rps-paper-mlp").reduced()
        model = build_model(cfg, device="cpu")
        with pytest.raises(ValueError, match="FSDP"):
            make_train_setup(model, cfg, TrainConfig(), Mesh((4,),
                                                             ("data",)),
                             rps_axes=("data",), fsdp_axis="data")
        return
    cfg = get_config(arch).reduced()
    mesh = Mesh((2, 2), ("data", "model"))
    model = build_model(cfg, device="meta")
    init_state, step, _ = make_train_setup(
        model, cfg, TrainConfig(), mesh.as_rank(1), rps_axes=("data",))
    params, _ = init_state(MetaGenerator())
    with comm.recording() as rec:
        loss, _ = model.loss(params, train_specs(cfg, 2, 24), step.tp)
    assert loss.shape == () and loss.device.type == "meta"
    joins = sum(op == "all_gather" and n == 2 for op, _, n in rec)
    if cfg.is_moe:
        assert step.tp.sharded("moe/wi") and step.tp.sharded("moe/wo")
        layer, = params["layers"].values()
        assert layer["moe"]["wi"].shape[-1] * 2 == cfg.d_ff
        # the width branch's hidden and output joined a layer (E 4)
        assert joins == 2 * cfg.n_layers
        return
    assert step.tp.sharded("mlp/wi" if cfg.family != "ssm" else "rwkv/ck")
    per_layer = {"ssm": 4, "hybrid": 3}.get(cfg.family, 0)
    assert joins == per_layer * sum(k in ("rwkv", "rec")
                                    for k in model.kinds)
    if cfg.family == "ssm":
        wide = Mesh((1, 8), ("data", "model"))
        with pytest.raises(ValueError, match="split a head across ranks"):
            make_train_setup(build_model(cfg, device="cpu"), cfg,
                             TrainConfig(), wide, rps_axes=("data",))
        with pytest.raises(ValueError, match="split a head across ranks"):
            model.loss(params, train_specs(cfg, 2, 24),
                       P.TP(wide.as_rank(0).group(("model",)), {}))
