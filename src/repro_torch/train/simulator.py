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

``schedule="async"`` ships the buckets as the backward pass readies them
(:mod:`repro_torch.core.plan`): the channel draws per-bucket masks at each
bucket's slack (``sample_async``), and the history's ``staleness`` is the
fraction of offered packets written off as late. ``corruption`` /
``byzantine_frac`` wrap the channel in a corruption process whose senders
corrupt their offers, and ``recovery`` may be one of the robust
aggregators (``median``, ``trimmed[:beta=…]``, ``clip[:clip_mult=…]``); the
history's ``corrupt_frac`` is the fraction of delivered packets that
arrived wrong.

Torch cannot reproduce JAX's random streams: without hooks the port draws
initial parameters, masks, the int8 wire's rounding noise, the packed
state's rounding noise and the corruption masks and bits from
``torch.Generator``s seeded from ``scfg.seed`` (one each, so an int8 run
and an f32 run of one seed see the same masks); ``init_params=``,
``masks_fn=``, ``wire_noise_fn=``, ``pack_noise_fn=``,
``corrupt_masks_fn=`` and ``corrupt_bits_fn=`` inject the reference's.
``donate=False`` raises: the port updates in place by design.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import telemetry as telemetry_lib
from repro_torch import tree as tree_lib
from repro_torch.channels import make_channel, make_corruption
from repro_torch.core import plan as plan_lib
from repro_torch.core import rps as rps_lib
from repro_torch.core import wire as wire_lib
from repro_torch.optim import make_optimizer
from repro_torch.optim import statepack as statepack_lib
from repro_torch.telemetry import counters as counters_lib
from repro_torch.telemetry import taps as taps_lib


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
    corruption: Any = None          # corruption spec; None = none
    byzantine_frac: float = 0.0     # colluders (alone: "collude")
    n_servers: Optional[int] = None  # server blocks s; None = n_workers
    bucket_mb: Optional[float] = None
    n_buckets: Optional[int] = None
    engine: str = "auto"            # "xla"/"auto" or "ring"
    exchange_dtype: str = "float32"
    wire: str = "f32"
    recovery: str = "renorm"
    schedule: str = "sync"          # "sync" or "async"
    compute_ms: Any = None          # async cost model: ms, or "auto"
    state_pack: str = "f32"         # at-rest state: "f32", "bf16", "i8"
    donate: bool = True             # the port always updates in place
    telemetry: bool = False         # per-step counters and records

    AGGREGATORS = ("rps_model", "rps_grad", "allreduce_model",
                   "allreduce_grad", "local")


def _check_ported(scfg: SimulatorConfig) -> None:
    """Raise on ``donate=False`` (a departure by design: the port updates
    in place) and on an unknown aggregator."""
    if not scfg.donate:
        raise NotImplementedError(
            "not ported: donate=False (the port updates in place)")
    if scfg.aggregator not in SimulatorConfig.AGGREGATORS:
        raise ValueError(f"aggregator={scfg.aggregator!r}, want one of "
                         f"{SimulatorConfig.AGGREGATORS}")


def _exchange(tree, scfg: SimulatorConfig, *, is_grad: bool, masks=None,
              plan=None, recovery=None, ef_state=None, wire_noise=None,
              late=None, corruption=None, corrupt_masks=None,
              corrupt_bits=None):
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
        ef_state=ef_state, wire_noise=wire_noise, late=late,
        corruption=corruption, corrupt_masks=corrupt_masks,
        corrupt_bits=corrupt_bits)


def wants_measured_ready(scfg) -> bool:
    """True when ``compute_ms="auto"``: the plan's readiness times come
    from timing the real backward (:func:`measure_bucket_ready_ms`)."""
    return (getattr(scfg, "schedule", "sync") == "async"
            and isinstance(scfg.compute_ms, str)
            and scfg.compute_ms.lower() == "auto")


def resolve_compute_ms(scfg, channel=None) -> Optional[float]:
    """The async cost model's backward duration: the explicit
    ``compute_ms``, or (unset, or "auto" before the measurement replaces
    it) 0.8 × the channel's deadline when it has one, else 1.0. None for
    sync configs."""
    if getattr(scfg, "schedule", "sync") != "async":
        return None
    if scfg.compute_ms is not None and not wants_measured_ready(scfg):
        return float(scfg.compute_ms)
    deadline = getattr(channel, "deadline_ms", None)
    return 0.8 * float(deadline) if deadline is not None else 1.0


def _suffix_backward(loss_fn: Callable, leaves: list, treedef, batch,
                     n: int, sfx: list) -> None:
    """The gradient of Σ_i loss_fn(params_i, batch_i) with respect to the
    leaves ``sfx`` only (the others held constant), worker by worker as
    the step computes it."""
    b_leaves, b_def = tree_lib.flatten(batch)
    sfx_set = set(sfx)
    for i in range(n):
        mine = [x[i].detach().requires_grad_(j in sfx_set)
                for j, x in enumerate(leaves)]
        with torch.enable_grad():
            loss = loss_fn(tree_lib.unflatten(treedef, mine),
                           tree_lib.unflatten(b_def,
                                              [b[i] for b in b_leaves]))
            torch.autograd.grad(loss, [mine[j] for j in sfx],
                                allow_unused=True)


def measure_bucket_ready_ms(loss_fn: Callable, params: Any, batch: Any,
                            plan, reps: int = 2, iters: int = 1) -> list:
    """Measured per-bucket gradient readiness times (``compute_ms=
    "auto"``), plan order, in ms: bucket b's time is that of the suffix
    backward — the gradient of the stacked loss with respect to buckets
    b..B−1 only. One call, max(1, iters // 2) more, then the best of
    ``reps`` batches of ``iters`` calls, timed between CUDA events on the
    card and by ``time.perf_counter`` on the CPU; the times are then
    projected onto the non-increasing profile the cost model has by
    construction (a suffix contains every later suffix)."""
    leaves, treedef = tree_lib.flatten(params)
    n = leaves[0].shape[0]
    cuda = leaves[0].device.type == "cuda"
    times = []
    for b in range(plan.n_buckets):
        sfx = sorted(i for bk in plan.buckets[b:] for i in bk.leaf_ids)

        def call(sfx=sfx):
            _suffix_backward(loss_fn, leaves, treedef, batch, n, sfx)

        for _ in range(1 + max(1, iters // 2)):
            call()
        best = float("inf")
        for _ in range(max(1, reps)):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(max(1, iters)):
                    call()
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1)
            else:
                c0 = time.perf_counter()
                for _ in range(max(1, iters)):
                    call()
                ms = (time.perf_counter() - c0) * 1e3
            best = min(best, ms / max(1, iters))
        times.append(best)
    ready = np.maximum.accumulate(np.asarray(times)[::-1])[::-1]
    return [float(r) for r in ready]


def make_exchange_plan(params: Any, scfg: SimulatorConfig, channel=None):
    """The plan the config prescribes over a per-worker tree (no stacked
    dim): per-leaf when the bucket knobs are unset, fixed-byte /
    count-balanced buckets otherwise; ``channel`` sizes the async cost
    model's default ``compute_ms``. None for the non-rps aggregators."""
    if not scfg.aggregator.startswith("rps"):
        return None
    return plan_lib.plan_from_config(params, scfg.n_workers, scfg.n_servers,
                                     bucket_mb=scfg.bucket_mb,
                                     n_buckets=scfg.n_buckets,
                                     engine=scfg.engine,
                                     wire=wire_lib.config_wire(
                                         scfg.wire, scfg.exchange_dtype),
                                     recovery=scfg.recovery,
                                     schedule=scfg.schedule,
                                     compute_ms=resolve_compute_ms(
                                         scfg, channel))


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
                  recovery=None, corruption=None,
                  telemetry: Optional[bool] = None):
    """One simulator step:
    ``step(params, opt_state, batch, masks, lr, exchange=True,
    ef_state=None, wire_noise=None, pack_noise=None, late=None,
    corrupt_masks=None, corrupt_bits=None) -> (params, opt_state, mean
    loss, consensus)``, plus the new ``ef_state`` under the ef recovery,
    plus the tap dict last with ``telemetry`` (default
    ``scfg.telemetry``); the loss and consensus are 0-dim f32 tensors on
    the params' device. The taps are the exchange's counters and the
    quantisation errors, ``grad_norm`` (after the backward, before the
    update consumes the gradients) and ``param_norm`` (after the
    exchange); each is a reduction, none a view of a buffer the step
    updates. ``masks`` is the step's (rs, ag) pair (None for the non-rps
    aggregators), ``wire_noise`` the int8 wire's rounding noise (a
    generator or a ``(g_idx, shape) -> uniforms`` hook), ``pack_noise``
    the packed state's (a generator or a ``(which, leaf_idx, shape) ->
    uniforms`` hook, ``which`` "m", "v" or "ef"); ``late`` the async
    lateness masks, ``corrupt_masks`` and ``corrupt_bits`` (a generator
    or a ``(g_idx, shape) -> bits`` hook) the ``corruption`` process's
    draws.
    Grad mode exchanges the gradients before the update, model mode the
    parameters after it; the parameters and the optimizer state are
    updated in place. The EF residual is carried in the state pack's EF
    format: decoded for the exchange and re-encoded after it, only on
    rounds that exchange (a skipped round passes it through untouched)."""
    n = scfg.n_workers
    is_grad_mode = scfg.aggregator.endswith("_grad")
    use_ef = scfg.aggregator.startswith("rps") and scfg.recovery == "ef"
    if use_ef and corruption is not None:
        raise ValueError(
            "corruption with recovery='ef' is unsupported: the EF residual "
            "telescopes an *honest* sender's codec error; use a robust "
            "recovery (median/trimmed/clip) instead")
    ef_fmt = statepack_lib.make_state_pack(scfg.state_pack).ef_format
    telemetry = scfg.telemetry if telemetry is None else telemetry

    def body(params, opt_state, batch, masks, lr, exchange=True,
             ef_state=None, wire_noise=None, pack_noise=None, late=None,
             corrupt_masks=None, corrupt_bits=None):
        if use_ef and ef_state is None:
            raise ValueError("recovery='ef' needs the step's ef_state")
        axis = dict(late=late, corruption=corruption,
                    corrupt_masks=corrupt_masks, corrupt_bits=corrupt_bits)

        def swap(tree, is_grad):
            nonlocal ef_state
            if not use_ef:
                return _exchange(tree, scfg, is_grad=is_grad, masks=masks,
                                 plan=plan, recovery=recovery,
                                 wire_noise=wire_noise, **axis)
            out, ef_new = _exchange(
                tree, scfg, is_grad=is_grad, masks=masks, plan=plan,
                recovery=recovery, wire_noise=wire_noise, **axis,
                ef_state=statepack_lib.unpack_tree(ef_state, ef_fmt))
            ef_state = statepack_lib.pack_tree(
                ef_new, ef_fmt,
                noise=statepack_lib.component_noise(pack_noise, "ef"),
                tap="ef")
            return out

        loss, grads = _loss_and_grads(loss_fn, params, batch, n)
        if taps_lib.active() is not None:
            taps_lib.emit("grad_norm", counters_lib.global_norm(grads))
        if is_grad_mode and exchange:
            grads = swap(grads, True)
        params, opt_state = opt.update(grads, opt_state, params, lr,
                                       noise=pack_noise)
        del grads
        if not is_grad_mode and exchange:
            params = swap(params, False)
        with torch.no_grad():
            consensus = consensus_distance(params)
            if taps_lib.active() is not None:
                taps_lib.emit("param_norm", counters_lib.global_norm(params))
        base = (params, opt_state, loss / n, consensus)
        return base + (ef_state,) if use_ef else base

    if not telemetry:
        return body

    def step(*args, **kwargs):
        with taps_lib.tap_collector() as tap:
            outs = body(*args, **kwargs)
        return outs + (tap.tree(),)

    return step


def _drain(reg, pending: list) -> None:
    """Materialise the run's taps into the registry's records (the one
    host copy of them), with the lateness and corruption counter tracks
    in its trace."""
    with reg.span("record_drain", steps=len(pending)):
        for (t, lr, loss, consensus, staleness, corrupt_frac,
             stats) in pending:
            extra = {}
            if staleness is not None:
                extra["staleness"] = float(staleness)
            if corrupt_frac is not None:
                extra["corrupt_frac"] = float(corrupt_frac)
            reg.record_step(t, stats, loss=loss, consensus=consensus, lr=lr,
                            **extra)
            if staleness is not None:
                reg.trace.counter("lateness",
                                  {"late_frac": float(staleness)})
            if corrupt_frac is not None:
                reg.trace.counter("corruption",
                                  {"corrupt_frac": float(corrupt_frac)})


def run_simulation(loss_fn: Callable, init_fn: Callable,
                   batch_fn: Callable, scfg: SimulatorConfig,
                   eval_fn: Optional[Callable] = None,
                   state: Optional[Dict[str, Any]] = None,
                   start_step: int = 0, telemetry=None, *,
                   device="cuda", init_params=None,
                   masks_fn: Optional[Callable] = None,
                   wire_noise_fn: Optional[Callable] = None,
                   pack_noise_fn: Optional[Callable] = None,
                   corrupt_masks_fn: Optional[Callable] = None,
                   corrupt_bits_fn: Optional[Callable] = None
                   ) -> telemetry_lib.RunHistory:
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
    and the EF residual, :func:`statepack.state_bytes_breakdown`);
    ``staleness`` (per eval step, the late fraction of the offered
    packets; empty under sync) and ``corrupt_frac`` (per eval step, the
    corrupt fraction of the delivered packets; empty without corruption);
    and ``state`` to resume from with ``state=`` / ``start_step=``
    (params, optimizer, channel and EF state).

    Telemetry: ``telemetry`` takes a
    :class:`repro_torch.telemetry.Telemetry` to report into (the
    launchers pass theirs); ``scfg.telemetry`` alone builds a private
    in-memory one. The history is a :class:`repro_torch.telemetry.
    RunHistory` either way: the mapping above, plus ``.records`` (one
    record per step, drained after the loop; empty without telemetry) and
    ``.summary`` (the per-link observed against expected drop rates, with
    the α bounds). The plan's build and the drain are spans of the
    registry's trace; under async and corruption each record's
    ``staleness`` / ``corrupt_frac`` is also a counter track of it.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``init_params`` (one worker's params, broadcast to n), ``masks_fn``
    (step -> (rs, ag), or (rs, ag, late) under async, late the
    ``{"rs", "ag"}`` lateness masks), ``wire_noise_fn`` ((step, g_idx,
    shape) -> the int8 wire's uniforms for exchange group g_idx),
    ``pack_noise_fn`` ((step, which, leaf_idx, shape) -> the packed
    state's uniforms for component ``which`` — "m", "v" or "ef" — of leaf
    leaf_idx), ``corrupt_masks_fn`` (step -> the corruption mask) and
    ``corrupt_bits_fn`` ((step, g_idx, shape) -> the bitflip positions)
    inject the initial parameters, the per-step masks, the rounding noise
    and the corruption draws; without them each is drawn from its own
    generator seeded from ``scfg.seed``. ``compute_ms="auto"`` times the
    backward per bucket (:func:`measure_bucket_ready_ms`) on the first
    step's batch before the run.
    """
    _check_ported(scfg)
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
    channel = make_channel(scfg.channel, n, scfg.drop_rate, s=scfg.n_servers,
                           corruption=make_corruption(
                               scfg.corruption, scfg.byzantine_frac or None))
    corruption = getattr(channel, "corruption", None) if rps_agg else None
    async_mode = rps_agg and scfg.schedule == "async"
    mask_gen = torch.Generator(device=dev)
    mask_gen.manual_seed(scfg.seed + 1)
    # the int8 wire's rounding noise, apart from the masks' stream
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(scfg.seed + 2)
    # the packed state's rounding noise, a stream of its own
    pack_gen = torch.Generator(device=dev)
    pack_gen.manual_seed(scfg.seed + 3)
    # the corruption masks and bits, apart from the drop masks' stream
    corrupt_gen = torch.Generator(device=dev)
    corrupt_gen.manual_seed(scfg.seed + 4)
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
    reg = telemetry
    use_tel = scfg.telemetry or reg is not None
    if use_tel and reg is None:
        reg = telemetry_lib.Telemetry()
    meta_p1 = tree_lib.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                 device="meta"), p1)
    if use_tel:
        with reg.span("plan_build"):
            plan = make_exchange_plan(meta_p1, scfg, channel)
        reg.bind(plan=plan, n=n,
                 p=channel.effective_p() if rps_agg else None,
                 channel=channel if rps_agg else None,
                 aggregator=scfg.aggregator)
    else:
        plan = make_exchange_plan(meta_p1, scfg, channel)
    if plan is not None and wants_measured_ready(scfg):
        plan = plan.with_ready_ms(measure_bucket_ready_ms(
            loss_fn, params, batch_fn(start_step), plan))
    slack = None
    if async_mode:
        # per-bucket deadline budgets; a channel without a latency model
        # ignores them (its sample_async is the sync draw, nothing late)
        deadline = getattr(channel, "deadline_ms", None)
        slack = plan.slack_ms(float(deadline)) if deadline is not None \
            else np.zeros(plan.n_buckets, np.float64)
    # the scale divisor takes the channel's stationary drop rate
    recovery = wire_lib.make_recovery(scfg.recovery,
                                      p=channel.effective_p()) \
        if rps_agg else None
    step_fn = make_sim_step(loss_fn, scfg, plan, opt, recovery, corruption,
                            telemetry=use_tel)

    history = telemetry_lib.RunHistory({
        "step": [], "loss": [], "consensus": [], "eval": [], "step_s": [],
        "staleness": [], "corrupt_frac": [],
        "channel": repr(channel),
        "channel_effective_p": channel.effective_p() if rps_agg else 0.0,
        "exchange_plan": plan.describe() if plan is not None else None})
    # (t, lr, loss, consensus, staleness, corrupt_frac, taps) per step,
    # on the device until the drain after the loop
    pending = []
    for t in range(start_step, scfg.steps):
        t0 = time.perf_counter()
        lr = scfg.lr * min(1.0, (t + 1) / max(scfg.warmup, 1))
        batch = batch_fn(t)
        exchange = t % scfg.exchange_every == 0
        masks = late = cmask = None
        if rps_agg:     # channel time advances every step, exchange or not
            if masks_fn is not None:
                masks = tuple(masks_fn(t))
                if len(masks) == 3:
                    late = {k: v.to(dev) for k, v in masks[2].items()}
                masks = tuple(m.to(dev) for m in masks[:2])
            elif async_mode:
                rs, ag, late, ch_state = channel.sample_async(
                    mask_gen, ch_state, slack)
                masks = (rs, ag)
            elif plan.per_bucket_masks:
                rs, ag, ch_state = channel.sample_packets(
                    mask_gen, ch_state, plan.n_buckets)
                masks = (rs, ag)
            else:
                rs, ag, ch_state = channel.sample(mask_gen, ch_state)
                masks = (rs, ag)
            if corruption is not None:
                nb = masks[0].shape[0] if masks[0].dim() == 3 else None
                cmask = corrupt_masks_fn(t).to(dev) \
                    if corrupt_masks_fn is not None \
                    else channel.sample_corruption(corrupt_gen, nb)
        # the step's staleness and contamination (0 on a step that does
        # not exchange: no exchange consumes the draw)
        late_frac = corrupt_frac = 0.0
        if exchange and async_mode:
            late_frac = counters_lib.staleness_stats(
                late["rs"], late["ag"])["late_frac"]
        if exchange and corruption is not None:
            corrupt_frac = counters_lib.corruption_stats(
                cmask, masks[0])["corrupt_frac"]
        wire_noise = noise_gen if wire_noise_fn is None else (
            lambda g, shape, t=t: wire_noise_fn(t, g, shape).to(dev))
        corrupt_bits = corrupt_gen if corrupt_bits_fn is None else (
            lambda g, shape, t=t: corrupt_bits_fn(t, g, shape).to(dev))
        pack_noise = pack_gen if pack_noise_fn is None else (
            lambda which, i, shape, t=t:
            pack_noise_fn(t, which, i, shape).to(dev))
        outs = step_fn(params, opt_state, batch, masks, lr,
                       exchange=exchange, ef_state=ef_state,
                       wire_noise=wire_noise, pack_noise=pack_noise,
                       late=late if exchange else None,
                       corrupt_masks=cmask, corrupt_bits=corrupt_bits)
        if use_tel:
            stats, outs = outs[-1], outs[:-1]
        if use_ef:
            params, opt_state, loss, consensus, ef_state = outs
        else:
            params, opt_state, loss, consensus = outs
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history["step_s"].append(time.perf_counter() - t0)
        if use_tel:
            pending.append((t, lr, loss, consensus,
                            late_frac if async_mode else None,
                            corrupt_frac if corruption is not None else None,
                            stats))
        if t % scfg.eval_every == 0 or t == scfg.steps - 1:
            history["step"].append(t)
            history["loss"].append(float(loss))
            history["consensus"].append(float(consensus))
            if async_mode:
                history["staleness"].append(float(late_frac))
            if corruption is not None:
                history["corrupt_frac"].append(float(corrupt_frac))
            if eval_fn is not None:
                mean_params = tree_lib.map(lambda x: torch.mean(x, 0),
                                           params)
                history["eval"].append(float(eval_fn(mean_params)))
    if use_tel:
        _drain(reg, pending)
        history.records = list(reg.memory.records)
        history.summary = reg.summary()
    history["final_loss"] = history["loss"][-1]
    history["params"] = params
    history["channel_state"] = ch_state
    history["ef_state"] = ef_state
    history["state"] = {"params": params, "opt_state": opt_state,
                        "ch_state": ch_state, "ef_state": ef_state}
    history["state_bytes"] = statepack_lib.state_bytes_breakdown(
        params=params, opt_state=opt_state, ef_state=ef_state)
    return history
