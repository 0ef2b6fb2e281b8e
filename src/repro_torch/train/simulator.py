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

Torch cannot reproduce JAX's random streams: without hooks the port draws
initial parameters and masks from ``torch.Generator``s seeded from
``scfg.seed``; ``init_params=`` and ``masks_fn=`` inject the reference's.
Not ported yet (raise when set off their defaults): the async schedule,
telemetry, corruption, the ef recovery, the int8 wire, packed optimizer
state, the non-Bernoulli channels.
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
    state_pack: str = "f32"         # packed formats not ported yet
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
    if scfg.recovery == "ef":
        off.append("recovery='ef'")
    if wire_lib.config_wire(scfg.wire, scfg.exchange_dtype) == "int8":
        off.append("wire='int8'")
    if scfg.state_pack not in (None, "f32"):
        off.append(f"state_pack={scfg.state_pack!r}")
    if not scfg.donate:
        off.append("donate=False (the port updates in place)")
    if off:
        raise NotImplementedError("not ported yet: " + ", ".join(off))
    if scfg.aggregator not in SimulatorConfig.AGGREGATORS:
        raise ValueError(f"aggregator={scfg.aggregator!r}, want one of "
                         f"{SimulatorConfig.AGGREGATORS}")


def _exchange(tree, scfg: SimulatorConfig, *, is_grad: bool, masks=None,
              plan=None, recovery=None):
    """The aggregator's exchange of a stacked tree (leading dim n)."""
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
        rs_dtype=getattr(torch, scfg.exchange_dtype), recovery=recovery)


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
    ``step(params, opt_state, batch, masks, lr, exchange=True) ->
    (params, opt_state, mean loss, consensus)``, the loss and consensus
    as 0-dim f32 tensors on the params' device. ``masks`` is the step's
    (rs, ag) pair (None for the non-rps aggregators). Grad mode exchanges
    the gradients before the update, model mode the parameters after it;
    the parameters and the optimizer state are updated in place."""
    n = scfg.n_workers
    is_grad_mode = scfg.aggregator.endswith("_grad")

    def step(params, opt_state, batch, masks, lr, exchange=True):
        loss, grads = _loss_and_grads(loss_fn, params, batch, n)
        if is_grad_mode and exchange:
            grads = _exchange(grads, scfg, is_grad=True, masks=masks,
                              plan=plan, recovery=recovery)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        if not is_grad_mode and exchange:
            params = _exchange(params, scfg, is_grad=False, masks=masks,
                               plan=plan, recovery=recovery)
        with torch.no_grad():
            consensus = consensus_distance(params)
        return params, opt_state, loss / n, consensus

    return step


def run_simulation(loss_fn: Callable, init_fn: Callable,
                   batch_fn: Callable, scfg: SimulatorConfig,
                   eval_fn: Optional[Callable] = None,
                   state: Optional[Dict[str, Any]] = None,
                   start_step: int = 0, telemetry=None, *,
                   device="cuda", init_params=None,
                   masks_fn: Optional[Callable] = None) -> Dict[str, Any]:
    """loss_fn(params, batch) -> scalar; init_fn(gen) -> one worker's
    params; batch_fn(step) -> stacked batch with leading dim n_workers.

    Returns the history: per-eval ``step``, ``loss`` (mean over workers)
    and ``consensus``; ``eval`` (``eval_fn`` of the mean parameters at
    eval steps); ``final_loss``; ``params`` (the stacked replicas);
    ``channel`` and ``channel_effective_p``; ``exchange_plan`` (the
    plan's ``describe()``); ``step_s`` (every step's wall seconds, the
    device synchronised at each step's end); and ``state`` to resume
    from with ``state=`` / ``start_step=``.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``init_params`` (one worker's params, broadcast to n) and
    ``masks_fn`` (step -> (rs, ag)) inject the initial parameters and the
    per-step masks; without them both are drawn from generators seeded
    from ``scfg.seed``.
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
    ch_state = channel.init_state(mask_gen) if rps_agg else None
    if state is not None:
        params, opt_state = state["params"], state["opt_state"]
        ch_state = state.get("ch_state", ch_state)
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
        params, opt_state, loss, consensus = step_fn(
            params, opt_state, batch, masks, lr, exchange=exchange)
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
    history["state"] = {"params": params, "opt_state": opt_state,
                        "ch_state": ch_state}
    return history
