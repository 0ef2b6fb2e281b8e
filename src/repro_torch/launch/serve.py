"""Serving launcher (port of :mod:`repro.launch.serve`): legacy static
batching, or continuous batching with the paged KV cache and optional
drop-masked tensor-parallel decode, on the GPU unless ``--device cpu``.

  # rwkv6-1.6b at full width, static batch, greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch rwkv6-1.6b --full --batch 8 --prompt-len 512 --new-tokens 32

  # recurrentgemma-9b at full width, static batch, greedy (a prompt
  # length that is a multiple of the 2048-token window: see below)
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch recurrentgemma-9b --full --batch 8 --prompt-len 2048 \
      --new-tokens 32

  # the same paths at smoke-test size on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch rwkv6-1.6b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch recurrentgemma-9b --device cpu

  # gemma3-1b at full width, lossy TP decode over 4 shards
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --full --tp-shards 4 -p 0.1

  # deepseek-7b (or starcoder2-15b) whole at full width, continuous,
  # lossy TP decode; a prompt over 2048 tokens takes the chunked route
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --arch deepseek-7b --full --tp-shards 4 -p 0.1 --drain \
      --requests 8 --prompt-len 4096 --new-tokens 32 --kv-blocks 2200

  # a config one card cannot hold whole, its depth cut
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --arch mixtral-8x22b --full --layers 4 --tp-shards 4 -p 0.1 --drain

  # MoE at smoke-test size on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --arch kimi-k2-1t-a32b --tp-shards 4 -p 0.1 --drain --device cpu

  # the audio and vlm families, static batch (their only path), on the
  # CPU at smoke-test size, then whole at full width on the card (a
  # llava prompt of 3,520 tokens + 576 patches = the 4,096 window)
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch whisper-large-v3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --serve legacy \
      --arch llava-next-mistral-7b --full --batch 8 --prompt-len 3520 \
      --new-tokens 32

The flags are the JAX launcher's, plus ``--device`` and ``--layers``
(the depth cut, after ``--reduced`` / ``--full``; the decoder stack
only, whisper's encoder stays whole). ``--arch`` takes every config of
the registry; at full width one 80 GB card holds gemma3-1b, rwkv6-1.6b,
recurrentgemma-9b, deepseek-7b, starcoder2-15b, whisper-large-v3 and
llava-next-mistral-7b whole, while llama3-405b, mixtral-8x22b and
kimi-k2-1t-a32b need ``--layers`` (4, 4 and 1 fit). ``--serve legacy``
serves every family (dense with its MoE variant, ssm, hybrid, audio,
vlm) on the contiguous cache: the vlm's patch embeddings
(``n_patches`` × d) and the audio model's frames (``--prompt-len`` //
2 × d) are drawn, after the prompts, from the prompts' numpy generator,
as the reference's launcher draws them, and the vlm decodes from
``--prompt-len`` + ``n_patches`` (ROADMAP C). Its windowed attention
layers keep the reference's ring buffer, which holds the right
positions only when the prefilled length is a multiple of the window;
the port reproduces the reference's output at other lengths too
(ROADMAP C). ``--serve continuous`` serves the dense family, MoE
included (not the vlm and audio families, which have no continuous
path in the reference either); with ``--telemetry-dir D`` it writes the session's
Chrome trace (``serve.prefill`` spans, a ``serve.request`` event per
request, the ``serve.queue`` counter) to ``D/serve_trace.json``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.launch.common import add_model_flags, arch_config
from repro_torch.models import build_model
from repro_torch.models.inputs import float_leaf
from repro_torch.netsim import request_trace
from repro_torch.serve import (ContinuousEngine, ServeEngine, TPDecodeConfig,
                               make_requests)
from repro_torch.telemetry import Telemetry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--serve", choices=("legacy", "continuous"),
                    default="legacy",
                    help="static batching vs continuous batching + paged KV")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    # -- continuous-engine knobs -----------------------------------------
    ap.add_argument("--page", type=int, default=16,
                    help="KV block size in tokens")
    ap.add_argument("--kv-blocks", type=int, default=65,
                    help="pool size in blocks (incl. the null block)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode lanes (max in-flight requests)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per round")
    ap.add_argument("--lam", type=float, default=50.0,
                    help="request arrival rate (req/s, Poisson)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--drain", action="store_true",
                    help="ignore arrival times (throughput mode)")
    # -- lossy TP decode --------------------------------------------------
    ap.add_argument("--tp-shards", type=int, default=0,
                    help="tensor-parallel shards (0 = dense decode)")
    ap.add_argument("-p", "--drop-rate", type=float, default=0.0)
    ap.add_argument("--channel", default=None,
                    help="channel spec, e.g. 'bernoulli:p=0.1'")
    ap.add_argument("--wire", default="f32")
    ap.add_argument("--recovery", default="renorm",
                    choices=("renorm", "scale"))
    ap.add_argument("--engine", default="xla", choices=("xla", "ring"))
    ap.add_argument("--telemetry-dir", default=None,
                    help="write a Chrome trace of the serving session here "
                         "(continuous batching)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a GPU")
    add_model_flags(ap)
    args = ap.parse_args(argv)

    cfg = arch_config(args)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")

    if args.serve == "legacy":
        return _serve_legacy(args, model, params, where)

    tp = None
    if args.tp_shards:
        tp = TPDecodeConfig(n_shards=args.tp_shards, p=args.drop_rate,
                            channel=args.channel, wire=args.wire,
                            recovery=args.recovery, engine=args.engine)
    telemetry = None
    if args.telemetry_dir:
        telemetry = Telemetry(out_dir=args.telemetry_dir)
    eng = ContinuousEngine(
        model=model, params=params, page=args.page,
        n_blocks=args.kv_blocks, max_batch=args.max_batch,
        chunk=args.chunk, max_len=args.prompt_len + args.new_tokens,
        temperature=args.temperature, tp=tp, telemetry=telemetry)
    trace = request_trace(args.lam, n_requests=args.requests,
                          prompt_lens=(args.prompt_len // 2,
                                       args.prompt_len),
                          max_new=(args.new_tokens // 2, args.new_tokens),
                          seed=0)
    reqs = make_requests(trace, cfg.vocab_size)
    rep = eng.run(reqs, drain=args.drain)
    print(f"arch={cfg.name} on {where}: served {len(rep.requests)} "
          f"requests / {rep.tokens} tokens in {rep.wall_s:.2f}s "
          f"({rep.tokens_per_s:.1f} tok/s, {rep.rounds} rounds, "
          f"{rep.prefills} prefills)")
    print(f"latency p50={rep.latency_quantile(0.5):.1f}ms "
          f"p99={rep.latency_quantile(0.99):.1f}ms  "
          f"preempts={sum(r.n_preempt for r in rep.requests)}")
    if telemetry is not None:
        path = os.path.join(args.telemetry_dir, "serve_trace.json")
        telemetry.trace.write(path)
        print(f"trace -> {path}")
    return rep


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_legacy(args, model, params, where: str) -> torch.Tensor:
    """Static-batch generation (the reference's legacy path): a random
    (batch, prompt_len) prompt batch, with the vlm's patch embeddings or
    the audio model's frames drawn after it from the same generator,
    ``new_tokens`` greedy or sampled tokens each. Returns the
    (batch, new_tokens) tokens."""
    cfg = model.cfg
    eng = ServeEngine(model=model, params=params,
                      max_len=(args.prompt_len + model.prefix_len
                               + args.new_tokens),
                      temperature=args.temperature)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        device=model.device)
    extra = None
    if cfg.family == "vlm":
        extra = {"patches": float_leaf(
            rng.normal(size=(args.batch, cfg.n_patches, cfg.d_model)) * 0.02,
            cfg.torch_dtype, model.device)}
    if cfg.family == "audio":
        extra = {"frames": float_leaf(
            rng.normal(size=(args.batch,
                             args.prompt_len // cfg.enc_frames_ratio,
                             cfg.d_model)) * 0.02,
            cfg.torch_dtype, model.device)}
    gen = torch.Generator(device=model.device)
    gen.manual_seed(1)
    _sync(model.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.new_tokens, gen=gen,
                       extra_inputs=extra)
    _sync(model.device)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"arch={cfg.name} on {where}: generated {tuple(out.shape)} in "
          f"{dt:.2f}s ({tps:.1f} tok/s)")
    print(out[:2].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
