#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

Serves chip_smoke.py's phase-4 load with its engine (``smoke_requests``,
``smoke_engine``: gemma3-1b at full width, random bf16 weights,
continuous batching, 4-shard lossy TP decode at p = 0.1, 8 requests)
three times with one engine, on the same seeds, so each session does the
same work: the first warms up (it builds the kernel),
the second is timed on the host clock (session wall, host time spent in
each decode step and prefill call), the third runs under
``torch.profiler`` (device time per kernel). Prints one JSON object:
walls, tokens/s, host ms per decode step and per prefill, kernel
launches per decode step, device busy time and idle share (busy time
over the timed session's wall; the profiled session's wall is inflated
by the profiler), and the kernels with the most device time.

    python3 tools/profile_torch_serve.py

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa

from chip_smoke import card_line, smoke_engine, smoke_requests  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import masked_avg as K  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


LABELS = ("serve.prefill", "serve.decode_step")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(smoke_requests(cfg), drain=True)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    launches = K.masked_avg_grid.launches
    steps = eng.chunk * rep.rounds
    # device-side events: kernels, plus the GPU ranges of the labels
    kernels = [(a.self_device_time_total, a.count, a.key)
               for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and a.key not in LABELS]
    busy_s = sum(k[0] for k in kernels) / 1e6
    n_kernels = sum(k[1] for k in kernels)
    kernels.sort(reverse=True)
    mavg = [k for k in kernels if "masked_avg_grid" in k[2]]
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
        "masked_avg_grid_launches": launches,
        "masked_avg_grid_device_ms": mavg[0][0] / 1e3 if mavg else None,
        "masked_avg_grid_share_of_busy":
            mavg[0][0] / 1e6 / busy_s if mavg else None,
        "top_kernels": [{"name": k[2][:90], "device_ms": k[0] / 1e3,
                         "count": k[1], "share_of_busy": k[0] / 1e6 / busy_s}
                        for k in kernels[:10]]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
