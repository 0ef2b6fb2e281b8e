"""Training launcher (port of :mod:`repro.launch.train`, the one-device
``--sim`` path): the n-worker simulator on a model of the registry and
the synthetic char-LM task.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rps-paper-mlp \
      --steps 200 --drop-rate 0.1 --aggregator rps_model --engine ring

Runs on the card unless ``--device cpu`` is given. The flags are the
reference's for the ported features: ``--channel`` takes every channel
spec of the reference (``ge:p_bad=1.0,burst=8,p=0.1``,
``hetero:n_pods=4,p_cross=0.3``, ``deadline:deadline_ms=8``,
``trace:lam=8000,prio=0.8``, ...); ``--wire int8 [--recovery ef]
--engine ring`` runs the int8 wire on the ring-round kernel's encoded
variant; ``--optimizer adam --state-pack i8`` keeps the optimizer state
(and the EF residual) packed at rest; ``--corruption collude:gamma=10
--byzantine-frac 0.25 --recovery median`` runs the Byzantine axis (the
robust recoveries on the xla engine); ``--async --compute-ms 8`` (or
``auto``, the backward timed per bucket) ships the buckets as the backward
readies them, against a ``deadline:`` channel.

``--telemetry`` records per-step counters (per-link delivery, drop rates,
norms) and the per-link drop-rate estimate against the theory's bounds,
bit for bit the same run; ``--telemetry-dir D`` (implies it) writes
``D/telemetry.jsonl``, ``D/summary.json`` and ``D/trace.json`` and prints
the summary:

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \
      --workers 4 --device cpu --telemetry-dir runs/tel
  PYTHONPATH=src python -m repro_torch.telemetry.trace \
      --validate runs/tel/trace.json
  python tools/render_experiments.py --telemetry runs/tel

``--checkpoint C`` saves the workers' mean parameters to C in the npz
layout of :mod:`repro_torch.checkpoint` (which the JAX package's
``load_pytree`` reads too).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.data.synthetic import CharLMTask, make_worker_streams
from repro_torch.models import build_model
from repro_torch.telemetry import Telemetry
from repro_torch.train.simulator import SimulatorConfig, run_simulation


def _float_or_auto(v: str):
    """--compute-ms: a float (the modelled backward duration) or 'auto'
    (time the real backward per bucket)."""
    if str(v).lower() == "auto":
        return "auto"
    return float(v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rps-paper-mlp")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced variant")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--servers", type=int, default=None,
                    help="parameter-server blocks s (default: s = n)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--drop-rate", type=float, default=0.1)
    ap.add_argument("--channel", default=None,
                    help="drop-process spec; default i.i.d. "
                         "Bernoulli(--drop-rate)")
    ap.add_argument("--aggregator", default="rps_model",
                    choices=list(SimulatorConfig.AGGREGATORS))
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="fixed-byte buckets of this many MiB (per-bucket "
                         "drop masks); default: the per-leaf plan")
    ap.add_argument("--buckets", type=int, default=None,
                    help="… or exactly this many size-balanced buckets")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "xla", "ring"],
                    help="exchange engine: xla/auto = f32 sums (the "
                         "masked-average kernel for renorm); ring = the "
                         "ring-order sums in the wire dtype on the "
                         "ring-round kernel")
    ap.add_argument("--exchange-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="RS-leg codec; int8: per-row scales, stochastic "
                         "rounding, re-encoded on every ring hop")
    ap.add_argument("--recovery", default="renorm",
                    help="renorm, scale, ef (renorm plus an error-feedback "
                         "residual), or a robust kind for corrupted links: "
                         "median, trimmed (β-trimmed mean, "
                         "'trimmed:beta=0.2'), clip (norm-clip at "
                         "clip_mult x the median norm)")
    ap.add_argument("--corruption", default=None,
                    help="corruption-process spec over bitflip / scale / "
                         "signflip / collude, e.g. 'signflip:frac=0.1' or "
                         "'collude:gamma=10,byzantine_frac=0.2'; default: "
                         "none")
    ap.add_argument("--byzantine-frac", type=float, default=0.0,
                    help="fraction of colluding workers (lowest ids, every "
                         "packet corrupted); overlays the --corruption "
                         "spec's own field and alone selects collude")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="async schedule: buckets ship in reverse-layer "
                         "order as their gradients become ready; against a "
                         "deadline channel each faces its reduced slack and "
                         "late packets are written off (the history's "
                         "staleness)")
    ap.add_argument("--compute-ms", type=_float_or_auto, default=None,
                    help="async cost model's backward duration (default "
                         "0.8 x the channel deadline, else 1.0); 'auto' "
                         "times the real backward per bucket")
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--state-pack", default="f32",
                    choices=["f32", "bf16", "i8", "int8"],
                    help="at-rest trainer-state format: f32 (unpacked), "
                         "bf16, or i8 (momentum bf16, Adam's second "
                         "moments and the EF residual int8 with per-row "
                         "scales and stochastic rounding on write)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="save the workers' mean parameters here (npz)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--telemetry", action="store_true",
                    help="exchange telemetry: per-step records (per-link "
                         "delivery, drop rates, norms), the per-link "
                         "drop-rate estimate against the theory bounds, "
                         "Chrome-trace spans; bit-identical to a run "
                         "without it")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write telemetry.jsonl / summary.json / trace.json "
                         "here (implies --telemetry); render with "
                         "tools/render_experiments.py --telemetry DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    task = CharLMTask(vocab=cfg.vocab_size, seq_len=args.seq_len,
                      seed=args.seed, device=args.device)
    batch_fn = make_worker_streams(task, args.workers, args.batch_size)

    def loss_fn(p, b):
        loss, _ = model.loss(p, b)
        return loss

    scfg = SimulatorConfig(
        n_workers=args.workers, drop_rate=args.drop_rate,
        aggregator=args.aggregator, optimizer=args.optimizer,
        lr=args.lr, steps=args.steps,
        warmup=args.warmup, batch_size=args.batch_size, seed=args.seed,
        channel=args.channel, n_servers=args.servers,
        corruption=args.corruption, byzantine_frac=args.byzantine_frac,
        bucket_mb=args.bucket_mb, n_buckets=args.buckets,
        engine=args.engine, exchange_dtype=args.exchange_dtype,
        wire=args.wire, recovery=args.recovery,
        schedule="async" if args.async_ else "sync",
        compute_ms=args.compute_ms, state_pack=args.state_pack)
    reg = None
    if args.telemetry or args.telemetry_dir:
        reg = Telemetry(out_dir=args.telemetry_dir)
    t0 = time.time()
    hist = run_simulation(loss_fn, model.init_stacked, batch_fn, scfg,
                          telemetry=reg, device=args.device)
    dt = time.time() - t0
    print(f"channel={hist['channel']} "
          f"eff_p={hist['channel_effective_p']:.4f}")
    if hist.get("exchange_plan"):
        ep = hist["exchange_plan"]
        print(f"exchange plan: {ep['n_buckets']} buckets × s={ep['s']} -> "
              f"{ep['collectives_per_round']} collectives/round, "
              f"model_packets={ep['model_packets']}, "
              f"wire={ep['wire']}/{ep['recovery']} "
              f"(rs_bytes_ratio={ep['rs_bytes_ratio']:.2f})")
    if args.state_pack != "f32":
        sb = hist["state_bytes"]
        comps = ", ".join(f"{k}={v}" for k, v in sb.items()
                          if k != "total" and v)
        print(f"state bytes [{args.state_pack}]: total {sb['total']} "
              f"({comps})")
    print(f"n={args.workers} s={args.servers or args.workers} "
          f"p={args.drop_rate} agg={args.aggregator} "
          f"final_loss={hist['final_loss']:.4f} "
          f"(entropy floor {task.entropy_floor():.4f}) "
          f"consensus={hist['consensus'][-1]:.3e} [{dt:.1f}s]")
    if hist["staleness"]:
        print(f"async staleness: mean late_frac="
              f"{float(np.mean(hist['staleness'])):.3f} "
              f"(max {float(np.max(hist['staleness'])):.3f})")
    if hist["corrupt_frac"]:
        print(f"corruption: mean corrupt_frac="
              f"{float(np.mean(hist['corrupt_frac'])):.3f} "
              f"(max {float(np.max(hist['corrupt_frac'])):.3f})")
    if args.checkpoint:
        mean_params = tree_lib.map(lambda x: torch.mean(x, 0),
                                   hist["params"])
        save_pytree(args.checkpoint, mean_params)
        print("checkpoint ->", args.checkpoint)
    if reg is not None:
        reg.finalize(print_summary=True)
        if args.telemetry_dir:
            print("telemetry ->", args.telemetry_dir)
    if args.out:
        keep = {k: v for k, v in hist.items()
                if k not in ("params", "state", "ef_state",
                             "channel_state")}
        with open(args.out, "w") as f:
            json.dump(keep, f, indent=1)
        print("history ->", args.out)
    return hist


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
