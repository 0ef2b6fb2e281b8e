#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving paths, on one GPU.

``--slice gemma3`` (the default) serves chip_smoke.py's phase-4 load with its engine (``smoke_requests``,
``smoke_engine``: gemma3-1b at full width, random bf16 weights,
continuous batching, 4-shard lossy TP decode at p = 0.1, 8 requests)
three times with one engine, on the same seeds, so each session does the
same work: the first warms up (it builds the kernel),
the second is timed on the host clock (session wall, host time spent in
each decode step and prefill call), the third runs under
``torch.profiler`` (device time per kernel). Prints one JSON object:
walls, tokens/s, host ms per decode step and per prefill, kernel
launches and device busy ms per decode step (prefills included), device
busy time and idle share (busy time over the timed session's wall; the
profiled session's wall is inflated by the profiler), the TP-combine and
masked-average kernels' launches and device time, and the kernels with
the most device time.

``--slice rwkv6`` runs chip_smoke.py's phase-7 load (rwkv6-1.6b at full
width, random bf16 weights, the static-batch engine: 8 prompts of 512
tokens, 32 new tokens, greedy) the same way: a warm-up, a timed
``generate`` (host time of the prefill and of each decode step), then
one prefill and one whole ``generate`` under the profiler, so the
device time splits into prefill and decode. ``--slice recurrentgemma``
does the same with chip_smoke.py's phase-11 load (recurrentgemma-9b at
full width and depth, 8 prompts of 2048 tokens, 32 new tokens).

``--slice train`` profiles chip_smoke.py's phase-17 load, the training
simulator on rps-100m (n = 16 workers, batch 32, seq 128, rps_model at
p = 0.1 on the ring-round kernel): a one-step warm-up run, a timed run
of two steps (host wall of each step, the device synchronised at its
end), then the same run under ``torch.profiler``. Prints the step times,
training tokens/s, device busy time and idle share per step, the top
kernels, and the ring kernels' launches, device time and share of busy
time. ``--wire int8`` and ``--recovery ef`` profile the int8 wire's load
(chip_smoke.py phase 21), whose groups run the ring round's encoded
variant; the int8 encode and the EF residual are the elementwise kernels
around it.

``--slice launcher`` profiles chip_smoke.py's phase-16 load, the training
launcher at its defaults (``launch/train.py``'s ``main``: rps-paper-mlp,
bf16, the char-LM task, n = 16, batch 32, seq 64) on the ring engine,
for ``LAUNCHER_STEPS`` steps: a short warm-up run, a timed run (its history's
step times), the same run under ``cProfile`` (the host's functions with
the most time of their own, and the port's with the most time including
their callees; the launcher's set-up is in both, spread over the steps)
and under ``torch.profiler`` (device busy
time and idle share a step, launches a step, the host ops and the
kernels with the most time).

    python3 tools/profile_torch_serve.py [--slice gemma3|rwkv6|recurrentgemma|train|launcher]
        [--wire f32|bf16|int8] [--recovery renorm|scale|ef]

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa

from chip_smoke import (RG_LOAD, RPS_100M, RPS_100M_LOAD,  # noqa: E402
                        RWKV_LOAD, card_line, smoke_engine, smoke_requests)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import CharLMTask, make_worker_streams  # noqa: E402
from repro_torch.kernels import masked_avg as K  # noqa: E402
from repro_torch.kernels import ring as RG  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import SimulatorConfig, run_simulation  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


LABELS = ("serve.prefill", "serve.decode_step")
LAUNCHER_STEPS = 20    # --slice launcher: the steps of each profiled run


def _labelled(fn, label):
    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _timed(fn, acc: list):
    """Host time of each call (no synchronisation: the device trails)."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        acc.append(time.perf_counter() - t0)
        return out
    return wrapped


def _device_kernels(prof) -> list:
    """(device µs, count, name) of every kernel, most time first; the GPU
    ranges of the labels are not kernels."""
    kernels = [(a.self_device_time_total, a.count, a.key)
               for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and a.key not in LABELS]
    return sorted(kernels, reverse=True)


def _top(kernels: list, busy_s: float, n: int = 10) -> list:
    return [{"name": k[2][:90], "device_ms": k[0] / 1e3, "count": k[1],
             "share_of_busy": k[0] / 1e6 / busy_s} for k in kernels[:n]]


# the static-batch slices: (chip_smoke load, the kernel's CUDA name)
STATIC = {"rwkv6": (RWKV_LOAD, "rwkv6_chunk_kernel"),
          "recurrentgemma": (RG_LOAD, "rglru_fwd_kernel")}


def profile_static(card: str, name: str) -> dict:
    """A static-batch slice (chip_smoke.py phase 7 or 11)."""
    load, kname = STATIC[name]
    cfg = get_config(load.arch)
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    eng = ServeEngine(model, params, max_len=load.prompt + load.new)
    prompts = torch.randint(0, cfg.vocab_size, (load.batch, load.prompt),
                            generator=gen, device="cuda")
    eng.generate(prompts, load.new)                   # warm-up
    prefill, decode = model.prefill, model.decode_step
    host = {"serve.prefill": [], "serve.decode_step": []}
    model.prefill = _timed(prefill, host["serve.prefill"])
    model.decode_step = _timed(decode, host["serve.decode_step"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, load.new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    model.prefill, model.decode_step = prefill, decode

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_p:
        model.prefill(params, {"tokens": prompts}, max_len=eng.max_len)
        torch.cuda.synchronize()
    load.kernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_g:
        eng.generate(prompts, load.new)
        torch.cuda.synchronize()
    launches = load.kernel.launches
    pre, gen_k = _device_kernels(prof_p), _device_kernels(prof_g)
    pre_busy_s = sum(k[0] for k in pre) / 1e6
    busy_s = sum(k[0] for k in gen_k) / 1e6
    kern = [k for k in gen_k if kname in k[2]]
    n_pre = sum(k[1] for k in pre)
    n_all = sum(k[1] for k in gen_k)
    return {
        "card": card, "slice": name, "arch": load.arch,
        "batch": load.batch, "prompt_len": load.prompt,
        "new_tokens": load.new, "wall_s": wall_s,
        "tokens_per_s": load.batch * load.new / wall_s,
        "host_ms_prefill": 1e3 * host["serve.prefill"][0],
        "host_ms_per_decode_step":
            1e3 * sum(host["serve.decode_step"]) / load.new,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "prefill_device_ms": pre_busy_s * 1e3,
        "decode_device_ms_per_step": (busy_s - pre_busy_s) * 1e3 / load.new,
        "kernel_launches_prefill": n_pre,
        "kernel_launches_per_decode_step": (n_all - n_pre) / load.new,
        "kernel": kname, "kernel_launches": launches,
        "kernel_device_ms": kern[0][0] / 1e3 if kern else None,
        "kernel_share_of_prefill_busy":
            kern[0][0] / 1e6 / pre_busy_s if kern else None,
        "top_kernels_prefill": _top(pre, pre_busy_s),
        "top_kernels_generate": _top(gen_k, busy_s)}


def profile_train(card: str, steps: int = 2, wire: str = "f32",
                  recovery: str = "renorm") -> dict:
    """The training slice (chip_smoke.py phase 17's load; phase 21's with
    ``wire="int8"``)."""
    load = RPS_100M_LOAD
    n = load["n"]
    model = build_model(RPS_100M, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p1 = model.init_stacked(gen)
    task = CharLMTask(vocab=RPS_100M.vocab_size, seq_len=load["seq"],
                      seed=0, device="cuda")
    stream = make_worker_streams(task, n, load["batch"])
    batches = [stream(t) for t in range(steps)]

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    def run(k: int) -> list:
        scfg = SimulatorConfig(n_workers=n, drop_rate=load["p"],
                               aggregator="rps_model", lr=load["lr"],
                               warmup=load["warmup"], steps=k,
                               eval_every=1, engine="ring", wire=wire,
                               recovery=recovery)
        h = run_simulation(loss_fn, None, lambda t: batches[t], scfg,
                           device="cuda", init_params=p1)
        return h["step_s"]

    run(1)                                            # warm-up
    step_s = run(steps)
    RG.ring_round.launches = 0
    RG.ring_round_enc.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    launches = RG.ring_round.launches + RG.ring_round_enc.launches
    kernels = _device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    ring = [k for k in kernels
            if any(name in k[2] for name in ("ring_round_kernel",
                                             "ring_requant_kernel",
                                             "ring_requant_cluster_kernel"))]
    ring_s = sum(k[0] for k in ring) / 1e6
    tokens = n * load["batch"] * load["seq"]
    return {
        "card": card, "slice": "train", "arch": RPS_100M.name, **load,
        "wire": wire, "recovery": recovery,
        "steps_profiled": steps, "step_ms": [t * 1e3 for t in step_s],
        "tokens_per_s": tokens * steps / sum(step_s),
        "profiled_wall_s": prof_wall_s,
        "device_busy_ms_per_step": busy_s * 1e3 / steps,
        "device_idle_share": 1.0 - busy_s / sum(step_s),
        "kernel_launches_per_step": sum(k[1] for k in kernels) / steps,
        "ring_launches": launches,
        "ring_device_ms_per_step": ring_s * 1e3 / steps,
        "ring_share_of_busy": ring_s / busy_s,
        "top_kernels": _top(kernels, busy_s, n=12)}


def profile_launcher(card: str) -> dict:
    """The training launcher's defaults (chip_smoke.py phase 16's load) on
    the ring engine, ``LAUNCHER_STEPS`` steps: where a step's host time
    goes."""
    from repro_torch.launch import train as train_launcher
    steps = LAUNCHER_STEPS
    args = ["--engine", "ring", "--steps", str(steps)]
    train_launcher.main(["--engine", "ring", "--steps", "3"])   # warm-up
    step_s = train_launcher.main(args)["step_s"][1:]
    prof_py = cProfile.Profile()
    t0 = time.perf_counter()
    prof_py.enable()
    train_launcher.main(args)
    prof_py.disable()
    cprofile_wall_s = time.perf_counter() - t0
    st = pstats.Stats(prof_py)
    own = sorted(((v[2], v[1], f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                  for k, v in st.stats.items()), reverse=True)
    # the port's own functions by time including their callees
    cum = sorted(((v[3], v[1], f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                  for k, v in st.stats.items()
                  if "repro_torch" in k[0]), reverse=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_launcher.main(args)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    host_ops = sorted(((a.self_cpu_time_total, a.count, a.key)
                       for a in prof.key_averages()
                       if a.device_type == DeviceType.CPU), reverse=True)
    mean_s = sum(step_s) / len(step_s)
    return {
        "card": card, "slice": "launcher", "steps": steps,
        "step_ms": [t * 1e3 for t in step_s], "step_ms_mean": mean_s * 1e3,
        "cprofile_wall_s": cprofile_wall_s,
        "cprofile_top_own_s_per_step": [
            {"fn": name, "own_ms_per_step": t * 1e3 / steps,
             "calls_per_step": c / steps} for t, c, name in own[:15]],
        "cprofile_top_port_cum_ms_per_step": [
            {"fn": name, "cum_ms_per_step": t * 1e3 / steps,
             "calls_per_step": c / steps} for t, c, name in cum[:15]],
        "profiled_wall_s": prof_wall_s,
        "device_busy_ms_per_step": busy_s * 1e3 / steps,
        "device_idle_share": 1.0 - busy_s / (mean_s * steps),
        "kernel_launches_per_step": sum(k[1] for k in kernels) / steps,
        "top_host_ops": [{"op": k[2][:90], "self_cpu_ms_per_step":
                          k[0] / 1e3 / steps, "calls_per_step": k[1] / steps}
                         for k in host_ops[:12]],
        "top_kernels": _top(kernels, busy_s)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slice", choices=("gemma3",) + tuple(STATIC)
                    + ("train", "launcher"), default="gemma3")
    ap.add_argument("--wire", choices=("f32", "bf16", "int8"),
                    default="f32", help="--slice train: the RS-leg codec")
    ap.add_argument("--recovery", choices=("renorm", "scale", "ef"),
                    default="renorm", help="--slice train: the recovery")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    if args.slice == "launcher":
        print(json.dumps(profile_launcher(card), indent=1))
        return 0
    if args.slice == "train":
        print(json.dumps(profile_train(card, wire=args.wire,
                                       recovery=args.recovery), indent=1))
        return 0
    if args.slice in STATIC:
        print(json.dumps(profile_static(card, args.slice), indent=1))
        return 0
    cfg = get_config("gemma3-1b")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    eng = smoke_engine(model, params, smoke_requests(cfg))
    warm = eng.run(smoke_requests(cfg), drain=True)
    prefill, decode = model.prefill, model.decode_paged

    host = {"serve.prefill": [], "serve.decode_step": []}
    model.prefill = _timed(prefill, host["serve.prefill"])
    model.decode_paged = _timed(decode, host["serve.decode_step"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = eng.run(smoke_requests(cfg), drain=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    model.prefill = _labelled(prefill, "serve.prefill")
    model.decode_paged = _labelled(decode, "serve.decode_step")
    K.masked_avg_grid.launches = 0
    K.tp_combine.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(smoke_requests(cfg), drain=True)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    launches = K.masked_avg_grid.launches
    steps = eng.chunk * rep.rounds
    kernels = _device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    n_kernels = sum(k[1] for k in kernels)
    mavg = [k for k in kernels if "masked_avg_grid" in k[2]]
    combine = [k for k in kernels if "tp_combine_kernel" in k[2]]
    combine_s = sum(k[0] for k in combine) / 1e6
    print(json.dumps({
        "card": card, "warmup_wall_s": warm.wall_s,
        "wall_s": wall_s, "tokens": timed.tokens,
        "tokens_per_s": timed.tokens / wall_s,
        "decode_steps": steps, "prefills": rep.prefills,
        "host_ms_per_decode_step":
            1e3 * sum(host["serve.decode_step"])
            / len(host["serve.decode_step"]),
        "host_ms_per_prefill":
            1e3 * sum(host["serve.prefill"]) / len(host["serve.prefill"]),
        "host_s_decode_total": sum(host["serve.decode_step"]),
        "host_s_prefill_total": sum(host["serve.prefill"]),
        "profiled_wall_s": prof_wall_s,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "kernel_launches": n_kernels,
        "kernels_per_decode_step_incl_prefills": n_kernels / steps,
        "device_busy_ms_per_decode_step_incl_prefills":
            busy_s * 1e3 / steps,
        "tp_combine_launches": K.tp_combine.launches,
        "tp_combine_device_ms": combine_s * 1e3,
        "tp_combine_share_of_busy": combine_s / busy_s,
        "masked_avg_grid_launches": launches,
        "masked_avg_grid_device_ms": mavg[0][0] / 1e3 if mavg else None,
        "masked_avg_grid_share_of_busy":
            mavg[0][0] / 1e6 / busy_s if mavg else None,
        "top_kernels": _top(kernels, busy_s)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
