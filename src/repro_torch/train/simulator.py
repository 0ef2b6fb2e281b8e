"""Single-device n-worker training simulator (port of
:mod:`repro.train.simulator`).

The paper's §6 experiments at its scale (n = 16 workers) on one card:
the worker replicas live on a stacked leading dim of every parameter
leaf, and the aggregation is the global-view exchange
(:func:`repro_torch.core.rps.rps_exchange_global`), the same arithmetic
as the collective path. Each step:

1. every worker's loss and gradient on its own replica — a loop over the
   workers with one backward each, so only one worker's activations live
   at a time; the gradients are those of the sum of the workers' losses;
2. the optimizer updates every replica (in place);
3. the channel draws ``(rs, ag)`` with owner entries forced on;
4. the exchange runs the model-mode round (``rps_model``), or the
   grad-mode round before step 2 (``rps_grad``); the consensus distance
   Σ_i ‖x_i − x̄‖² is recorded.

Aggregators: ``rps_model`` (Algorithm 1), ``rps_grad`` (naive gradient
averaging under drops), ``allreduce_model`` / ``allreduce_grad``
(reliable baselines), ``local`` (no communication). With
``engine="ring"`` every exchange group runs on the hand-written ring-round
kernel; ``"xla"``/``"auto"`` take the masked-average kernel for renorm.

The wire codecs (``f32``, ``bf16``, ``int8``) and the recoveries
(``renorm``, ``scale``, ``ef``) are the reference's; under ``ef`` the
per-worker residual rides in the step state, untouched on rounds that do
not exchange. Every channel family of the reference draws the masks
(``channel=``), its state advancing once per step, exchange or not.
``state_pack`` ("f32", "bf16", "i8") stores the optimizer state and the
EF residual packed at rest (:mod:`repro_torch.optim.statepack`); the
history reports their bytes (``state_bytes``).

Torch cannot reproduce JAX's random streams: without hooks the port draws
initial parameters, masks, the int8 wire's rounding noise and the packed
state's rounding noise from ``torch.Generator``s seeded from
``scfg.seed`` (one each, so an int8 run and an f32 run of one seed see
the same masks); ``init_params=``, ``masks_fn=``, ``wire_noise_fn=`` and
``pack_noise_fn=`` inject the reference's. Not ported yet (raise when
set off their defaults): the async schedule, telemetry, corruption, the
robust recoveries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.channels import make_channel
from repro_torch.core import plan as plan_lib
from repro_torch.core import rps as rps_lib
from repro_torch.core import wire as wire_lib
from repro_torch.optim import make_optimizer
from repro_torch.optim import statepack as statepack_lib


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """The reference's fields and defaults (see its docstrings)."""
    n_workers: int = 16
    drop_rate: float = 0.0
    aggregator: str = "rps_model"
    optimizer: str = "sgd"          # paper: plain SGD, no momentum/decay
    lr: float = 0.05
    steps: int = 200
    batch_size: int = 32            # paper: 32/worker
    seed: int = 0
    warmup: int = 0                 # gradual-warmup steps (paper recipe)
    eval_every: int = 10
    exchange_every: int = 1         # >1: local-SGD variant (beyond-paper)
    channel: Any = None             # channel spec; None = Bernoulli
    corruption: Any = None          # not ported yet
    byzantine_frac: float = 0.0     # not ported yet
    n_servers: Optional[int] = None  # server blocks s; None = n_workers
    bucket_mb: Optional[float] = None
    n_buckets: Optional[int] = None
    engine: str = "auto"            # "xla"/"auto" or "ring"
    exchange_dtype: str = "float32"
    wire: str = "f32"
    recovery: str = "renorm"
    schedule: str = "sync"          # "async" not ported yet
    compute_ms: Any = None          # async cost model (async only)
    state_pack: str = "f32"         # at-rest state: "f32", "bf16", "i8"
    donate: bool = True             # the port always updates in place
    telemetry: bool = False         # not ported yet

    AGGREGATORS = ("rps_model", "rps_grad", "allreduce_model",
                   "allreduce_grad", "local")


def _check_ported(scfg: SimulatorConfig) -> None:
    """Raise on a field whose feature is not ported, set off its default."""
    off = []
    if scfg.schedule != "sync":
        off.append(f"schedule={scfg.schedule!r}")
    if scfg.telemetry:
        off.append("telemetry=True")
    if scfg.corruption is not None or scfg.byzantine_frac:
        off.append("corruption / byzantine_frac")
    if scfg.recovery in wire_lib.ROBUST_RECOVERIES:
        off.append(f"recovery={scfg.recovery!r}")
    if not scfg.donate:
        off.append("donate=False (the port updates in place)")
    if off:
        raise NotImplementedError("not ported yet: " + ", ".join(off))
    if scfg.aggregator not in SimulatorConfig.AGGREGATORS:
        raise ValueError(f"aggregator={scfg.aggregator!r}, want one of "
                         f"{SimulatorConfig.AGGREGATORS}")


def _exchange(tree, scfg: SimulatorConfig, *, is_grad: bool, masks=None,
              plan=None, recovery=None, ef_state=None, wire_noise=None):
    """The aggregator's exchange of a stacked tree (leading dim n);
    ``(tree, ef_state)`` when an EF residual is given (rps aggregators
    only)."""
    n = scfg.n_workers
    agg = scfg.aggregator
    if agg == "local":
        return tree
    if agg.startswith("allreduce"):
        with torch.no_grad():
            for x in tree_lib.leaves(tree):
                x.copy_(torch.mean(x, 0, keepdim=True))
        return tree
    return rps_lib.rps_exchange_global(
        tree, None, scfg.drop_rate, n, mode="grad" if is_grad else "model",
        masks=masks, s=scfg.n_servers, plan=plan, engine=scfg.engine,
        rs_dtype=getattr(torch, scfg.exchange_dtype), recovery=recovery,
        ef_state=ef_state, wire_noise=wire_noise)


def make_exchange_plan(params: Any, scfg: SimulatorConfig, channel=None):
    """The plan the config prescribes over a per-worker tree (no stacked
    dim): per-leaf when the bucket knobs are unset, fixed-byte /
    count-balanced buckets otherwise. None for the non-rps
    aggregators."""
    if not scfg.aggregator.startswith("rps"):
        return None
    return plan_lib.plan_from_config(params, scfg.n_workers, scfg.n_servers,
                                     bucket_mb=scfg.bucket_mb,
                                     n_buckets=scfg.n_buckets,
                                     engine=scfg.engine,
                                     wire=wire_lib.config_wire(
                                         scfg.wire, scfg.exchange_dtype),
                                     recovery=scfg.recovery,
                                     schedule=scfg.schedule)


def _loss_and_grads(loss_fn: Callable, params, batch, n: int):
    """Σ_i loss_fn(params_i, batch_i) and its gradient, worker by worker:
    each worker's leaves are views into the stacked leaves, and its
    gradients land in row i of a stacked gradient tree."""
    p_leaves, treedef = tree_lib.flatten(params)
    b_leaves, b_def = tree_lib.flatten(batch)
    grads = [torch.empty_like(p) for p in p_leaves]
    losses = []
    for i in range(n):
        mine = [p[i].detach().requires_grad_(True) for p in p_leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_lib.unflatten(treedef, mine),
                           tree_lib.unflatten(b_def,
                                              [b[i] for b in b_leaves]))
            got = torch.autograd.grad(loss, mine, allow_unused=True)
        for g, gi in zip(grads, got):
            if gi is None:
                g[i].zero_()
            else:
                g[i].copy_(gi)
        losses.append(loss.detach().to(torch.float32))
    return torch.stack(losses).sum(), tree_lib.unflatten(treedef, grads)


def consensus_distance(params) -> torch.Tensor:
    """Σ over leaves of Σ_i ‖x_i − x̄‖², in f32 (the Lemma-3 quantity)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_lib.leaves(params)[0].device)
    for x in tree_lib.leaves(params):
        dev = (x - torch.mean(x, 0, keepdim=True)).to(torch.float32)
        total = total + torch.sum(dev * dev)
    return total


def make_sim_step(loss_fn: Callable, scfg: SimulatorConfig, plan, opt,
                  recovery=None):
    """One simulator step:
    ``step(params, opt_state, batch, masks, lr, exchange=True,
    ef_state=None, wire_noise=None, pack_noise=None) -> (params,
    opt_state, mean loss, consensus)``, plus the new ``ef_state`` last
    under the ef recovery; the loss and consensus are 0-dim f32 tensors
    on the params' device. ``masks`` is the step's (rs, ag) pair (None
    for the non-rps aggregators), ``wire_noise`` the int8 wire's rounding
    noise (a generator or a ``(g_idx, shape) -> uniforms`` hook),
    ``pack_noise`` the packed state's (a generator or a ``(which,
    leaf_idx, shape) -> uniforms`` hook, ``which`` "m", "v" or "ef").
    Grad mode exchanges the gradients before the update, model mode the
    parameters after it; the parameters and the optimizer state are
    updated in place. The EF residual is carried in the state pack's EF
    format: decoded for the exchange and re-encoded after it, only on
    rounds that exchange (a skipped round passes it through untouched)."""
    n = scfg.n_workers
    is_grad_mode = scfg.aggregator.endswith("_grad")
    use_ef = scfg.aggregator.startswith("rps") and scfg.recovery == "ef"
    ef_fmt = statepack_lib.make_state_pack(scfg.state_pack).ef_format

    def step(params, opt_state, batch, masks, lr, exchange=True,
             ef_state=None, wire_noise=None, pack_noise=None):
        if use_ef and ef_state is None:
            raise ValueError("recovery='ef' needs the step's ef_state")

        def swap(tree, is_grad):
            nonlocal ef_state
            if not use_ef:
                return _exchange(tree, scfg, is_grad=is_grad, masks=masks,
                                 plan=plan, recovery=recovery,
                                 wire_noise=wire_noise)
            out, ef_new = _exchange(
                tree, scfg, is_grad=is_grad, masks=masks, plan=plan,
                recovery=recovery, wire_noise=wire_noise,
                ef_state=statepack_lib.unpack_tree(ef_state, ef_fmt))
            ef_state = statepack_lib.pack_tree(
                ef_new, ef_fmt,
                noise=statepack_lib.component_noise(pack_noise, "ef"))
            return out

        loss, grads = _loss_and_grads(loss_fn, params, batch, n)
        if is_grad_mode and exchange:
            grads = swap(grads, True)
        params, opt_state = opt.update(grads, opt_state, params, lr,
                                       noise=pack_noise)
        del grads
        if not is_grad_mode and exchange:
            params = swap(params, False)
        with torch.no_grad():
            consensus = consensus_distance(params)
        base = (params, opt_state, loss / n, consensus)
        return base + (ef_state,) if use_ef else base

    return step


def run_simulation(loss_fn: Callable, init_fn: Callable,
                   batch_fn: Callable, scfg: SimulatorConfig,
                   eval_fn: Optional[Callable] = None,
                   state: Optional[Dict[str, Any]] = None,
                   start_step: int = 0, telemetry=None, *,
                   device="cuda", init_params=None,
                   masks_fn: Optional[Callable] = None,
                   wire_noise_fn: Optional[Callable] = None,
                   pack_noise_fn: Optional[Callable] = None
                   ) -> Dict[str, Any]:
    """loss_fn(params, batch) -> scalar; init_fn(gen) -> one worker's
    params; batch_fn(step) -> stacked batch with leading dim n_workers.

    Returns the history: per-eval ``step``, ``loss`` (mean over workers)
    and ``consensus``; ``eval`` (``eval_fn`` of the mean parameters at
    eval steps); ``final_loss``; ``params`` (the stacked replicas);
    ``channel`` and ``channel_effective_p``; ``exchange_plan`` (the
    plan's ``describe()``); ``step_s`` (every step's wall seconds, the
    device synchronised at each step's end); ``ef_state`` (the EF
    residual in the pack's EF format, None without ef);
    ``channel_state`` (the channel's state after the last step);
    ``state_bytes`` (the at-rest bytes of the params, the optimizer state
    and the EF residual, :func:`statepack.state_bytes_breakdown`); and
    ``state`` to resume from with ``state=`` / ``start_step=`` (params,
    optimizer, channel and EF state).

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``init_params`` (one worker's params, broadcast to n), ``masks_fn``
    (step -> (rs, ag)), ``wire_noise_fn`` ((step, g_idx, shape) -> the
    int8 wire's uniforms for exchange group g_idx) and ``pack_noise_fn``
    ((step, which, leaf_idx, shape) -> the packed state's uniforms for
    component ``which`` — "m", "v" or "ef" — of leaf leaf_idx) inject the
    initial parameters, the per-step masks and the rounding noise;
    without them each is drawn from its own generator seeded from
    ``scfg.seed``.
    """
    _check_ported(scfg)
    if telemetry is not None:
        raise NotImplementedError("telemetry is not ported yet")
    dev = resolve_device(device)
    n = scfg.n_workers
    if init_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(scfg.seed)
        init_params = init_fn(gen)
    p1 = tree_lib.map(lambda x: x.to(dev), init_params)
    params = tree_lib.map(
        lambda x: x[None].expand((n,) + tuple(x.shape)).clone(), p1)
    opt = make_optimizer(scfg.optimizer, state_pack=scfg.state_pack)
    opt_state = opt.init(params)
    rps_agg = scfg.aggregator.startswith("rps")
    channel = make_channel(scfg.channel, n, scfg.drop_rate, s=scfg.n_servers)
    mask_gen = torch.Generator(device=dev)
    mask_gen.manual_seed(scfg.seed + 1)
    # the int8 wire's rounding noise, apart from the masks' stream
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(scfg.seed + 2)
    # the packed state's rounding noise, a stream of its own
    pack_gen = torch.Generator(device=dev)
    pack_gen.manual_seed(scfg.seed + 3)
    ch_state = channel.init_state(mask_gen) if rps_agg else None
    use_ef = rps_agg and scfg.recovery == "ef"
    # the zero residual, at rest in the pack's EF format (zeros encode
    # exactly)
    ef_state = statepack_lib.pack_tree(
        wire_lib.init_ef_state(params),
        statepack_lib.make_state_pack(scfg.state_pack).ef_format) \
        if use_ef else None
    if state is not None:
        params, opt_state = state["params"], state["opt_state"]
        ch_state = state.get("ch_state", ch_state)
        ef_state = state.get("ef_state", ef_state)
    plan = make_exchange_plan(
        tree_lib.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), p1),
        scfg, channel)
    # the scale divisor takes the channel's stationary drop rate
    recovery = wire_lib.make_recovery(scfg.recovery,
                                      p=channel.effective_p()) \
        if rps_agg else None
    step_fn = make_sim_step(loss_fn, scfg, plan, opt, recovery)

    history: Dict[str, Any] = {
        "step": [], "loss": [], "consensus": [], "eval": [], "step_s": [],
        "channel": repr(channel),
        "channel_effective_p": channel.effective_p() if rps_agg else 0.0,
        "exchange_plan": plan.describe() if plan is not None else None}
    for t in range(start_step, scfg.steps):
        t0 = time.perf_counter()
        lr = scfg.lr * min(1.0, (t + 1) / max(scfg.warmup, 1))
        batch = batch_fn(t)
        exchange = t % scfg.exchange_every == 0
        masks = None
        if rps_agg:     # channel time advances every step, exchange or not
            if masks_fn is not None:
                masks = tuple(m.to(dev) for m in masks_fn(t))
            elif plan.per_bucket_masks:
                rs, ag, ch_state = channel.sample_packets(
                    mask_gen, ch_state, plan.n_buckets)
                masks = (rs, ag)
            else:
                rs, ag, ch_state = channel.sample(mask_gen, ch_state)
                masks = (rs, ag)
        wire_noise = noise_gen if wire_noise_fn is None else (
            lambda g, shape, t=t: wire_noise_fn(t, g, shape).to(dev))
        pack_noise = pack_gen if pack_noise_fn is None else (
            lambda which, i, shape, t=t:
            pack_noise_fn(t, which, i, shape).to(dev))
        outs = step_fn(params, opt_state, batch, masks, lr,
                       exchange=exchange, ef_state=ef_state,
                       wire_noise=wire_noise, pack_noise=pack_noise)
        if use_ef:
            params, opt_state, loss, consensus, ef_state = outs
        else:
            params, opt_state, loss, consensus = outs
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history["step_s"].append(time.perf_counter() - t0)
        if t % scfg.eval_every == 0 or t == scfg.steps - 1:
            history["step"].append(t)
            history["loss"].append(float(loss))
            history["consensus"].append(float(consensus))
            if eval_fn is not None:
                mean_params = tree_lib.map(lambda x: torch.mean(x, 0),
                                           params)
                history["eval"].append(float(eval_fn(mean_params)))
    history["final_loss"] = history["loss"][-1]
    history["params"] = params
    history["channel_state"] = ch_state
    history["ef_state"] = ef_state
    history["state"] = {"params": params, "opt_state": opt_state,
                        "ch_state": ch_state, "ef_state": ef_state}
    history["state_bytes"] = statepack_lib.state_bytes_breakdown(
        params=params, opt_state=opt_state, ef_state=ef_state)
    return history
