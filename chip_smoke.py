#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. Phases (each
raises on failure; nothing is caught):

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel of the serving path, from the sources in
   src/repro_torch/kernels/csrc (timed);
3. kernel against its plain version on the card: the masked-average
   kernel over a sweep of shapes, dtypes and mask types, within the JAX
   package's kernel-test tolerances (1e-6 f32, 2e-2 bf16); then its time
   at the serving shape beside its plain version, a one-call PyTorch
   yardstick and the card's bound;
4. slice: gemma3-1b at full width (random bf16 weights) served by the
   continuous-batching engine with lossy tensor-parallel decode (4 shards,
   Bernoulli p = 0.1), 8 requests, every decode output projection through
   the kernel; checks tokens, finite logits and the kernel's launch count;
5. dense equivalence: tensor-parallel decode with every packet delivered
   against the dense decode, same tokens, 4 steps, logits within a bf16
   tolerance.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import masked_avg as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.netsim import request_trace  # noqa: E402
from repro_torch.serve import (ContinuousEngine, PagedCache,  # noqa: E402
                               TPDecodeConfig, make_requests,
                               make_tp_context)

# Full-precision f32 matmuls and convolutions on the card (no TF32), set
# explicitly: the kernel comparison and the dense-equivalence check state
# their tolerances for IEEE f32 arithmetic.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# NVIDIA H100 SXM data-sheet peaks at its 700 W limit (dense rates)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores

SERVE_SHAPE = (4, 4, 2304)     # (B, n, d) of one TP combine at gemma3-1b
SITES_PER_STEP = 52            # 2 collective sites × 26 layers


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, calls: int = 100, reps: int = 20) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events. The host's
    per-call overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * reps)


def eager_ms(fn, calls: int = 1000) -> float:
    """Wall time of one eager ``fn()`` call, host overhead included."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def check_kernel(gen: torch.Generator) -> float:
    """Phase 3a: kernel vs its plain version over the sweep. Returns the
    largest f32 error at the serving shape with a bool mask (what the
    serving path feeds it)."""
    shapes = [SERVE_SHAPE] + [(B, n, d) for B in (1, 3, 16)
                              for n in (2, 8, 16, 32)
                              for d in (7, 512, 1000, 2304)]
    serve_err = None
    n_cases = 0
    for shape in shapes:
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            for mdt in (torch.bool, torch.float32):
                B, n, d = shape
                x = torch.randn(shape, generator=gen, device="cuda").to(dt)
                m = torch.rand((B, n), generator=gen, device="cuda") < 0.7
                m[:, 0] = True
                m = m.to(mdt)
                got = ops.masked_avg_grid(x, m)
                want = ops.masked_avg_grid(x, m, backend="ref")
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), atol=tol,
                                      rtol=tol):
                    raise AssertionError(
                        f"masked_avg_grid {shape} {dt} mask {mdt}: max "
                        f"abs err {err} > tol {tol}")
                if shape == SERVE_SHAPE and dt == torch.float32 \
                        and mdt == torch.bool:
                    serve_err = err
                n_cases += 1
    # every packet but the owner's dropped: the owner's row comes back
    x = torch.randn((4, 64), generator=gen, device="cuda")
    m = torch.zeros(4, device="cuda").index_fill_(0, torch.tensor(
        [2], device="cuda"), 1.0)
    got = ops.masked_avg(x, m)
    if not torch.allclose(got, x[2], rtol=1e-6, atol=0.0):
        raise AssertionError("all-dropped-but-owner case differs")
    print(f"kernel sweep: {n_cases + 1} cases agree with the plain "
          f"version", flush=True)
    return serve_err


def time_kernel(gen: torch.Generator) -> dict:
    """Phase 3b: times at the serving shape (f32 blocks, bool mask)."""
    B, n, d = SERVE_SHAPE
    x = torch.randn(SERVE_SHAPE, generator=gen, device="cuda")
    m = torch.rand((B, n), generator=gen, device="cuda") < 0.9
    m[:, 0] = True

    def kernel():
        return K.masked_avg_grid(x, m)

    def plain():
        return ops.masked_avg_grid(x, m, backend="ref")

    def library():
        mf = m.to(x.dtype)
        return torch.bmm(mf[:, None, :], x)[:, 0] \
            / mf.sum(-1, keepdim=True).clamp_min(1)

    if not torch.allclose(library(), kernel(), atol=1e-6, rtol=1e-6):
        raise AssertionError("the bmm yardstick computes another function")
    nbytes = (x.numel() * x.element_size() + m.numel() * m.element_size()
              + B * d * x.element_size())
    flops = 2 * B * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library),
            "eager_ms": eager_ms(kernel), "eager_plain_ms": eager_ms(plain),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def smoke_requests(cfg) -> list:
    """Phase 4's load: 8 requests from the Poisson trace (prompts of
    64-256 tokens, 16-32 new tokens), all offered at t = 0 (drain)."""
    trace = request_trace(50.0, n_requests=8,
                          prompt_lens=(64, 128, 192, 256),
                          max_new=(16, 24, 32), seed=0)
    reqs = make_requests(trace, cfg.vocab_size, seed=0)
    for r in reqs:
        r.arrival_ms = 0.0
    return reqs


def smoke_engine(model, params, reqs) -> ContinuousEngine:
    """Phase 4's engine: page 16, 8 lanes, rounds of 8 decode steps, a
    pool that holds every request of ``reqs`` at once, 4-shard lossy TP
    decode at Bernoulli p = 0.1."""
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    n_blocks = 1 + sum(-(-(len(r.prompt) + r.max_new) // 16) for r in reqs)
    return ContinuousEngine(model, params, page=16, n_blocks=n_blocks,
                            max_batch=8, chunk=8, max_len=max_len,
                            tp=TPDecodeConfig(n_shards=4, p=0.1))


def serve_slice(model, params) -> dict:
    """Phase 4: the port's serving path at full width."""
    cfg = model.cfg
    finite = torch.ones((), dtype=torch.bool, device=model.device)
    decode = model.decode_paged

    def decode_checked(*args, **kwargs):
        nonlocal finite
        logits, pool = decode(*args, **kwargs)
        finite = finite & torch.isfinite(logits).all()
        return logits, pool

    model.decode_paged = decode_checked
    reqs = smoke_requests(cfg)
    eng = smoke_engine(model, params, reqs)
    torch.cuda.synchronize()
    K.masked_avg_grid.launches = 0
    rep = eng.run(reqs, drain=True)
    launches = K.masked_avg_grid.launches
    torch.cuda.synchronize()
    model.decode_paged = decode
    for r in rep.requests:
        if len(r.generated) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} "
                                 f"tokens, want {r.max_new}")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    if not bool(finite):
        raise AssertionError("non-finite decode logits")
    want = SITES_PER_STEP * eng.chunk * rep.rounds
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != 52 × chunk "
                             f"{eng.chunk} × rounds {rep.rounds} = {want}")
    return {"requests": len(rep.requests), "tokens": rep.tokens,
            "wall_s": rep.wall_s, "tokens_per_s": rep.tokens_per_s,
            "p50_ms": rep.latency_quantile(0.5),
            "p99_ms": rep.latency_quantile(0.99), "rounds": rep.rounds,
            "prefills": rep.prefills, "decode_steps": eng.chunk * rep.rounds,
            "masked_avg_grid_launches": launches}


def dense_equivalence(model, params, steps: int = 4) -> dict:
    """Phase 5: TP decode with every packet delivered vs dense decode.

    The dense path keeps the residual stream in bf16; the TP combine
    returns f32 (the exchange plan is f32, as in the JAX package), so the
    TP stream is f32 from layer 0's attention onwards. The two differ by
    bf16 rounding only; the tolerance is a relative RMS error of 5e-2 on
    the logits."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(1)
    lens = (64, 100)
    B, page = len(lens), 16
    tp = make_tp_context(TPDecodeConfig(n_shards=4,
                                        channel="bernoulli:p=0"), cfg, B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    caches = [PagedCache(model, page, 24), PagedCache(model, page, 24)]
    max_pages = -(-(max(lens) + steps) // page)
    bt = np.zeros((B, max_pages), np.int64)
    for b, S in enumerate(lens):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                 device=dev)
        _, pcache = model.prefill(params, {"tokens": prompt}, paged=True)
        blocks = caches[0].alloc.alloc(-(-(S + steps) // page))
        caches[1].alloc.alloc(len(blocks))
        for c in caches:
            c.write_prefill(pcache, blocks, S)
        bt[b, :len(blocks)] = blocks
    bt_t = torch.as_tensor(bt, device=dev)
    pos = torch.as_tensor(lens, device=dev)
    worst_rel = worst_abs = 0.0
    for _ in range(steps):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                              device=dev)
        dense, _ = model.decode_paged(params, caches[0].pool,
                                      {"token": tok}, pos, bt_t, page=page)
        masks, _ = tp.sample_site_masks(gen, None)
        if not (bool(masks[0].all()) and bool(masks[1].all())):
            raise AssertionError("p=0 channel dropped a packet")
        lossless, _ = model.decode_paged(params, caches[1].pool,
                                         {"token": tok}, pos, bt_t,
                                         page=page, masks=masks, tp=tp)
        d, t = dense.float(), lossless.float()
        if not (torch.isfinite(d).all() and torch.isfinite(t).all()):
            raise AssertionError("non-finite logits")
        rel = ((t - d).norm() / d.norm()).item()
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, (t - d).abs().max().item())
        pos = pos + 1
    if worst_rel > 5e-2:
        raise AssertionError(f"TP (all delivered) vs dense logits: relative "
                             f"RMS error {worst_rel} > 5e-2")
    return {"steps": steps, "max_rel_rms": worst_rel,
            "max_abs": worst_abs, "tol_rel_rms": 5e-2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.load_kernels()
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = check_kernel(gen)
    timing = time_kernel(gen)
    print(json.dumps({"kernel_timing": timing, "card": card}), flush=True)

    cfg = get_config("gemma3-1b")
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"init_s {time.perf_counter() - t0:.3f}", flush=True)
    slice_ = serve_slice(model, params)
    print(json.dumps({"slice": slice_, "card": card}), flush=True)
    equiv = dense_equivalence(model, params)
    print(json.dumps({"dense_equivalence": equiv}), flush=True)

    kernel = {"name": "masked_avg_grid", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/masked_avg.cu",
              "replaces": "src/repro/kernels/masked_avg.py:58",
              "launches": slice_["masked_avg_grid_launches"],
              "max_abs_err": err,
              "ms": timing["ms"], "plain_ms": timing["plain_ms"],
              "bound_ms": timing["bound_ms"],
              "bound_by": timing["bound_by"],
              "library_ms": timing["library_ms"], "ok": True}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
