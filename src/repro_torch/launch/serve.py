"""Serving launcher (port of :mod:`repro.launch.serve`): continuous
batching with the paged KV cache and optional drop-masked
tensor-parallel decode, on the GPU unless ``--device cpu``.

  # gemma3-1b at full width, lossy TP decode over 4 shards
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --full --tp-shards 4 -p 0.1

  # the same path at smoke-test size on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --serve continuous \
      --reduced --tp-shards 4 -p 0.1 --device cpu

The flags are the JAX launcher's; ``--serve legacy`` and
``--telemetry-dir`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.netsim import request_trace
from repro_torch.serve import ContinuousEngine, TPDecodeConfig, make_requests


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
                    help="(not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a GPU")
    args = ap.parse_args(argv)

    if args.serve == "legacy":
        raise NotImplementedError("--serve legacy (the static-batch "
                                  "ServeEngine) is not ported yet; use "
                                  "--serve continuous")
    if args.telemetry_dir:
        raise NotImplementedError("--telemetry-dir is not ported yet")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)

    tp = None
    if args.tp_shards:
        tp = TPDecodeConfig(n_shards=args.tp_shards, p=args.drop_rate,
                            channel=args.channel, wire=args.wire,
                            recovery=args.recovery, engine=args.engine)
    eng = ContinuousEngine(
        model=model, params=params, page=args.page,
        n_blocks=args.kv_blocks, max_batch=args.max_batch,
        chunk=args.chunk, max_len=args.prompt_len + args.new_tokens,
        temperature=args.temperature, tp=tp)
    trace = request_trace(args.lam, n_requests=args.requests,
                          prompt_lens=(args.prompt_len // 2,
                                       args.prompt_len),
                          max_new=(args.new_tokens // 2, args.new_tokens),
                          seed=0)
    reqs = make_requests(trace, cfg.vocab_size)
    rep = eng.run(reqs, drain=args.drain)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"arch={cfg.name} on {where}: served {len(rep.requests)} "
          f"requests / {rep.tokens} tokens in {rep.wall_s:.2f}s "
          f"({rep.tokens_per_s:.1f} tok/s, {rep.rounds} rounds, "
          f"{rep.prefills} prefills)")
    print(f"latency p50={rep.latency_quantile(0.5):.1f}ms "
          f"p99={rep.latency_quantile(0.99):.1f}ms  "
          f"preempts={sum(r.n_preempt for r in rep.requests)}")
    return rep


if __name__ == "__main__":
    main()
