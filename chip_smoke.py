#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. Phases (each
raises on failure; nothing is caught):

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel of the port, from the sources in
   src/repro_torch/kernels/csrc (timed);
3. kernel against its plain version on the card: the masked-average
   kernel over a sweep of shapes, dtypes and mask types (the shapes the
   xla runs of phases 15 and 20 give it, from their plans, and a grid
   around them), within the JAX package's kernel-test tolerances (1e-6
   f32, 2e-2 bf16); then its time at the quickstart's largest shape
   beside its plain version, a one-call PyTorch yardstick and the card's
   bound;
3c. the TP-combine kernel (one drop-masked decode site in one launch)
   against its plain version on the card: n in {2, 4, 8, 16} x s in
   {n/2, n, 2n} x (d, B) in {(1152, 8), (24, 3), (1000, 7), (37, 5),
   (2304, 128)} x partials f32 / bf16 x wire f32 / bf16 x receiver 0 and
   n - 1 x sites 0 and 51 of a 52-site bool stack x Bernoulli(0.7) masks
   (also with strided partials, and one draw broadcast over the sites
   with stride 0), all delivered, all dropped but the owner; bit for
   bit on integer partials, within 1e-6 (f32 wire) / 2e-2 (bf16 wire) on
   unit-normal n * partials; bit for bit against the exchange route (the
   unfused chain on the masked-average kernel) at the serving shape, every
   site, both wires; then its time at the serving shape (f32 partials)
   beside the unfused chain's, both in a CUDA graph and eager, its plain
   version and the card's bound;
4. slice: gemma3-1b at full width (random bf16 weights) served by the
   continuous-batching engine with lossy tensor-parallel decode (4 shards,
   Bernoulli p = 0.1), 8 requests, every decode output projection through
   the TP-combine kernel; checks tokens, finite logits and the kernels'
   launch counts (52 TP combines per decode step, no masked average);
5. dense equivalence: tensor-parallel decode with every packet delivered
   against the dense decode, same tokens, 4 steps, logits within a bf16
   tolerance;
6. RWKV-6 kernel against its plain version on the card: a sweep of
   sequence lengths, head widths, dtypes and decays (the kernel tests'
   uniform ones, and every w at 1e-30, 0.999 and 0) within the JAX
   package's kernel-test tolerances (2e-4 f32, 0.1 bf16), the final state
   within 2e-4 (f32); then its time at the slice shape (8, 512, 32, 64)
   bf16 beside its plain version and the card's bound (bytes, against the
   TF32 tensor-core rate, and the f32-core bound beside it);
7. slice: rwkv6-1.6b at full width (random bf16 weights) served by the
   static-batch engine, 8 prompts of 512 tokens, 32 new tokens, greedy;
   checks the tokens, finite logits at every step and one kernel launch
   per layer per prefill;
8. prefill against decode at full width: the last logits of a prefill of
   prompt + 4 tokens against a prefill of the prompt and 4 teacher-forced
   decode steps, with the bf16 weights (a bf16 tolerance) and an f32 copy
   of them (a tight one);
9. RG-LRU kernel against its plain version on the card: sequence lengths
   S in {1, 16, 33, 130, 2048} x widths d in {8, 70, 4096}, x in f32 and
   bf16 with f32 a, plus the slice shape (8, 2048, 4096): h within 1e-5
   in f32 (the JAX kernel tests' tolerance) and within one bf16 ulp of
   the plain version's f32 h rounded to bf16 in bf16, the final carry
   within 1e-5;
10. its time at the slice shape (bf16 x, f32 a) beside its plain version
   and the card's bound;
11. slice: recurrentgemma-9b at full width and depth (random bf16
   weights) served by the static-batch engine, 8 prompts of 2048 tokens
   (= the window, where the reference's ring buffer is right), 32 new
   tokens, greedy; checks the tokens, finite logits at every step and
   26 kernel launches (one per RG-LRU layer) per prefill;
12. prefill against decode as in 8, at a 2048-token prompt: the bf16
   model at full depth, and an f32 copy of its first repeating unit
   (3 layers, full width);
13. ring-round kernel against its plain version (the ring run hop for
   hop) on the card, bit for bit: n in {1, 2, 4, 8, 16} x s in {1, n/2,
   n, 2n} x the three modes x payload f32/bf16 x accumulation f32/bf16 x
   d in {1, 33, 4097} x G in {1, 3} x integer-valued and continuous data;
14. its time at two shapes, the largest exchange group of rps-100m's
   per-leaf plan at n = 16 and one 25 MiB f32 bucket at n = 16, beside
   its plain version, the port's engine="xla" route for the same group
   (einsum, divide, where: three calls, not a library yardstick) and the
   card's bound;
15. the quickstart (the paper's claim): the 24-48-8 tanh MLP on the
   heterogeneous teacher task, n = 16, 150 steps; reliable allreduce at
   p = 0, rps_model and rps_grad at p = 0.1 on the ring kernel; RPS's
   final loss < 1.15 x the baseline's + 0.02, and rps_model on the xla
   engine (the masked-average kernel, once per exchange group and step)
   within 1e-4 of the ring run;
16. the training launcher's defaults (rps-paper-mlp, bf16, char-LM,
   n = 16, batch 32, seq 64, 200 steps) with --engine ring;
17. rps-100m (12 layers, d 768, 12 / 4 KV heads, d_ff 3072, vocab 16384,
   f32) at the example's paper scale: n = 16, batch 32, seq 128, 24
   steps on the ring kernel (launches = exchange groups x steps); step
   ms, training tokens/s, peak memory, the loss (finite at every step;
   the first step's batch scores lower on the trained mean model than on
   the initial one) and the consensus (finite, > 0);
18. the ring round's encoded variant (the int8 wire: int8 contributions
   decoded in the kernel, the partial re-encoded on every hop; without
   the re-encode; the EF send on a linear wire summed in f32 and bf16)
   against its plain version on the card, bit for bit: payload f32 /
   bf16 x the three modes x n in {1, 2, 4, 8, 16} x s in {1, n/2, n, 2n}
   x d in {1, 33, 64, 4096, 4097, 4104}, a block zero in every rank; the
   re-encoding kernel at the widths where its cluster grows to 2, 4, 8
   and 16 blocks, where a block holds more than half an SM's shared
   memory, and at a row wider than the largest cluster holds (the
   cooperative wide path); and every exchange group of the rps-paper-mlp
   and rps-100m plans at the int8 wire;
19. its time at phase 14's two shapes beside the cooperative wide path
   (the first design) at the same shapes, its form without the
   re-encode, its plain version, the xla engine's int8 route and the
   card's bound (phase 14 times the linear kernel at the same shapes);
   and the wide path's time at a row wider than a cluster holds;
20. benchmarks/wire_bench.py section 2 on the port: replicated data,
   n = 8, rps_model, engine "auto", p in {0.2, 0.3}, 3 seeds, 200 steps;
   ef closes at least half of the bf16 and int8 wires' loss gap;
21. rps-100m cut to its first 4 of 12 layers (CUT_LAYERS: phase 17's
   embedding, first layers and batches; width, n, batch, seq, lr and p
   as phase 17's), as phases 24 and 27-29 are: first the cut's own f32
   run, 8 steps (ring launches = groups x steps, finite losses); then
   the int8 wire on the ring engine, renorm and ef, 8 steps each from
   the cut's weights, batches and masks: every group on the encoded
   variant (launches = groups x steps), finite losses within
   INT8_LOSS_GAP of the cut's f32 run at every step; step ms, tokens/s and peak memory; then one exchange of each
   run's final replicas (and residual) at full width, on the card through
   the kernels and on the CPU through the plain versions, with the same
   masks and rounding noise: bit for bit;
22. the channel families (benchmarks/channels_bench.py's recipe, uncut,
   on the ring engine): the quickstart's teacher MLP, n = 16, batch 32,
   150 steps, lr 0.2, warm-up 10, each family at effective_p 0.1 —
   bernoulli, Gilbert-Elliott bursts of 4 and 16, 4 pods, the straggler
   deadline (bisected) and the netsim trace (web priority bisected) —
   and rps_grad on the 16-burst channel; every final loss < the
   bernoulli run's x 1.35 + 0.05, rps_grad's above rps_model's on the
   16-burst channel, each family's realised off-owner drop fraction
   within CHANNEL_DRIFT of its effective_p (the trace's: its mean over
   the periods replayed), ring launches = groups x steps;
23. benchmarks/state_bench.py section 3, uncut: n = 4, Adam, ef, 2
   buckets, 200 steps, seeds {0, 1, 2}, p in {0.1, 0.2, 0.3}, the f32 /
   int8 wire x f32 / i8 pack, engine auto (the masked-average kernel, once
   per group and step); at every p the i8 pack's loss gap <= the int8
   wire's + 0.02, printed beside BENCH_state.json's CPU rows;
24. rps-100m (the cut) at phase 17's load with Adam (lr 3e-4, warm-up
   20) on the Gilbert-Elliott channel (bursts of 8, p 0.1), 4 steps
   under each state pack (f32, bf16, i8), from the cut's weights and
   batches: peak
   memory (the earlier phases' memory freed first, the allocation at the
   run's start beside it), the state's bytes, step ms and losses; the
   optimizer's bytes f32 / i8 >= 2.0 and i8's peak >= 10 % below f32's
   (state_bench.py's own acceptances), every loss finite and the bf16 and
   i8 losses within PACK_LOSS_GAP of the f32 pack's; then one i8-packed
   Adam update of the largest leaf (the LM head's 16 replicas at the cut,
   201 M elements) on the card and on the CPU from the same state, grads and
   uniforms: the params, the int8 payload, its scales and the bf16 m bit
   for bit;
25. the Byzantine axis: (a) one exchange per corruption kind (bitflip,
   scale, signflip, collude; a fifth of the links and the lowest quarter
   of the workers corrupt) x wire (f32, bf16, int8) x engine (xla, ring),
   renorm, then median, trimmed and clip on the xla engine under the
   colluding attack, at the rps-paper-mlp plan (n = 16) and rps-100m's
   (its first layer), on integer-valued replicas: on the card through the
   kernels (the ring engine's corrupted offer on the encoded variant)
   against the plain versions on the CPU with the same masks, corrupt
   masks, uniforms and bits (drawn on the card), the same values (NaN equal to NaN; the
   elements whose bits differ, a sign of zero or a NaN payload, counted;
   clip within 1e-6 of the largest contribution and an ulp of the
   output's rounding; the xla engine under bitflip and on the int8
   wire, whose sends are not integers: the sends alike group by group,
   the exchange's output inside the bound of two summation orders of the
   masked average); then at rps-100m's whole plan (groups up to (3, 16,
   16, 1,769,472)) every kind x wire x engine through the kernels
   against the same exchange with their plain versions on the card, the
   same values (the xla engine under bitflip and on the int8 wire inside
   the summation bound); (b) benchmarks/robust_bench.py sections
   1-4, uncut (n = 8, 200 steps, collude:gamma=10, renorm / median /
   trimmed:beta=0.4 / clip x byzantine_frac {0, 0.25} x p {0, 0.2},
   engine auto): median and trimmed reach loss 1.0 under the attack and
   renorm does not (at p = 0 with the final loss; at p = 0.2, where one
   seed's final loss is a draw, with the median over seeds 0-7 of the
   final loss; the bench's own final-loss verdict printed beside), every
   attacked run's mean corrupt_frac within CORRUPT_FRAC_TOL of
   expected_frac, printed beside BENCH_robust.json's CPU rows;
26. benchmarks/async_bench.py section 2, uncut (n = 8, 300 steps, 4
   buckets, compute_ms 8, the deadline channel's four straggler
   scenarios, sync and async, engine auto; then one scenario on the ring
   engine): async_speedup > 1 in every scenario, staleness 0 under sync
   and inside (0, 1) under async, the ring run's losses within
   ASYNC_RING_TOL of the xla run's, launches = groups x exchange steps,
   printed beside BENCH_async.json's CPU rows;
27. rps-100m (the cut) at phase 17's load, weights, batches and masks
   under the colluding attack (4 of 16 workers, gamma 10), 4 steps
   each: renorm on
   the ring engine (the encoded variant, groups x steps launches),
   median, trimmed:beta=0.4 and clip on the xla engine (the table
   aggregate, no kernel); step ms, the aggregate's device ms a step,
   peak memory, losses; median's and trimmed's within ATTACK_LOSS_GAP of
   the cut's f32 run's, renorm's last non-finite or 1.0 above, the
   robust peaks within ATTACK_PEAK_GB of the cut's f32 run's, one median
   exchange of the final replicas bit for bit card against CPU;
28. rps-100m (the cut) at phase 17's load with 8 buckets on the
   straggler deadline
   channel, compute_ms 8, ring engine, 4 steps, sync and async (finite
   losses, async staleness > 0, launches = groups x steps); then the
   backward's measured readiness profile at that plan
   (measure_bucket_ready_ms, what compute_ms="auto" runs) beside the cost
   model's, positive and non-increasing;
29. rps-100m (the cut) at phase 17's load, weights, batches and masks
   on the ring
   engine, 4 steps with telemetry off and then on (a Telemetry writing
   into a temporary directory), then off and on again: losses,
   consensus and every parameter leaf bit for bit equal, a record per
   step, every record's link_offered the plan's layout, ring launches =
   groups x steps in both runs, the trace accepted by ``python -m
   repro_torch.telemetry.trace --validate``; printed: the mean rs_drop_rate, the drift verdict, step
   ms off against on over both pairs, one norm pass's device time and
   peak memory off against on. Then the int8 wire (renorm) with
   telemetry, 8 steps (the alpha2 check): per step the consensus, the
   parameters' squared norm and their ratio beside the bound's alpha2
   and the wire's extra (a finding, not a gate);
30. benchmarks/convergence.py's run on the port, recipe unchanged, each
   run inside timing.wallclock under a Telemetry: Fig 4a (the 24-48-8
   MLP, n 16, 150 steps, p in {0, 0.01, 0.05, 0.1, 0.2}, engine auto)
   and Fig 4b (rps-paper-mlp on the char-LM task, n 8, 40 steps, p 0
   allreduce against p 0.1 rps_model) with the bench's two assertions,
   masked-average launches = groups x steps of the rps runs; the table
   with each run's time from the registry;
31. the launchers: ``python -m repro_torch.launch.train`` at its
   defaults, 20 steps, with --telemetry-dir and --checkpoint (the three
   files, the trace validates, tools/render_experiments.py renders them,
   the checkpoint loads back bit for bit equal to the mean parameters);
   ``python -m repro_torch.launch.serve`` on gemma3-1b at full width,
   continuous, lossy 4-shard TP decode, with and without --telemetry-dir
   (serve_trace.json validates and holds serve.request for every
   request, serve.prefill and serve.queue; the greedy tokens and the
   TP-combine launches equal);
32. deepseek-7b whole at full width (30 layers, 13.8 GB of random bf16
   weights) on the continuous engine with lossy 4-shard TP decode
   (Bernoulli p = 0.1): 8 prompts of 4,096 tokens (the chunked attention
   route in prefill), 32 new tokens each; checks the tokens, finite
   logits, TP-combine launches = 2 sites x 30 layers x decode steps, no
   other kernel, and layer 0's chunked route against full attention on
   the first prompt (ROUTE_TOL, bf16);
33. starcoder2-15b whole (40 layers, 44.0 GB): 2 prompts of 12,288 tokens
   (3 x its 4,096-token window: the blocked local route), the same
   checks, layer 0's blocked route against full attention head group by
   head group;
34. llama3-405b at full width cut to 4 layers (33.9 GB): 8 prompts of
   512 tokens, the TP combine at d = 16,384;
35. mixtral-8x22b at full width cut to 4 layers (20.8 GB), then kimi-k2
   cut to 1 layer (38.7 GB; 384 experts, top 8), the first freed before
   the second: 8 prompts of 512 tokens, TP-combine launches = the
   attention sites x decode steps (the MoE FFN keeps its dense expert
   path); printed: the prefills' expert-load histogram, the share of
   assignments the capacity dropped, the mean aux loss; then the TP
   combine at d 4,096 / 6,144 / 7,168 / 16,384 ((8, 1, d) f32 partials,
   n 4): bit for bit against its plain version on integer partials and
   against the exchange route on normal ones, and its time in a CUDA
   graph beside its plain version, the unfused chain and its bytes
   bound;
36. training through launch/train.py's main (the char-LM task at a
   256-token vocabulary, ring engine, p = 0.1, seq 512, batch 2, 4
   steps) at full width: rwkv6-1.6b whole at n = 4, recurrentgemma-9b
   cut to one repeat of its block pattern (3 layers) at n = 2,
   mixtral-8x22b cut to 1 layer at n = 2: finite losses and consensus,
   ring launches = groups x steps, no RWKV-6, RG-LRU, TP-combine or
   masked-average launch (the train kinds take the reference's XLA
   routes), one exchange at the first layers' shapes, on integer
   replicas that differ from worker to worker, bit for bit against
   ring.cu's plain version on the card; step ms and peak memory;
37. whisper-large-v3 whole at full width (32 encoder and 32 decoder
   layers, d 1,280, 4.04 GB of random bf16 weights) through
   launch/serve.py's legacy path (its prompts, then its frames from the
   same numpy generator; ServeEngine with extra_inputs): 8 prompts of
   3,000 tokens with 1,500 frames (whisper's 30-second window after its
   stride-2 conv), 32 new tokens; checks the tokens, finite logits, the
   encoder run once per generate, no kernel launch; encoder, decoder
   prefill and decode step times, peak memory; then through the engine
   teacher-forced decode against one prefill of the extended sequence
   (4 steps, the bf16 model and an f32 copy, phase 8's tolerances; the
   engine's decode positions), and layer 0's chunked decoder route
   against full attention;
38. llava-next-mistral-7b whole at full width (32 layers, d 4,096, GQA
   32 / 8, 14.5 GB): 8 prompts of 3,520 tokens after 576 patch
   embeddings (4,096 = the window, where the ring buffer is right), 32
   new tokens, the same checks (the engine decodes from S + 576; the f32
   copy is the first 2 layers), the windowed chunked route;
39. training through run_simulation on the ring engine (rps_model,
   p = 0.1, 4 steps) on a models/inputs.py make_batch stream (seed =
   step x n + worker): whisper-large-v3 whole at n = 4 (decoder seq 448,
   224 frames, batch 2) and llava-next-mistral-7b at full width cut to 2
   layers at n = 4 (576 patches + 512 tokens, batch 2): finite losses
   and consensus, ring launches = groups x steps and no other kernel,
   one exchange at the first layer of every kind (the encoder stack's
   included), on integer replicas that differ from worker to worker,
   bit for bit against ring.cu's plain version; step ms and peak memory;
40. the collective path, four ranks on the one card in one world of
   spawned processes over gloo (core/comm.py stages each CUDA payload
   through pinned host buffers; the transport and staging print):
   ring_rank.cu's hop and landing against their plain versions, bit for
   bit, over (k, W) chunks up to rps-100m's largest bucket chunk at n = 4
   (1 x 7,077,888), f32 / bf16 payloads and accumulation, the int8 wire,
   non-finite rows, rows split over many blocks by the re-encoding hop
   with an inf or a NaN only in their last column; the hop's and the
   landing's times beside their bounds, the hop's plain version and the
   plain chain where(rs, x, 0) + acc; the int8 wire's re-encoding hop at
   every chunk shape of the exchange below, in a CUDA graph on cold
   inputs, beside its plain version and bound, and its sum over one
   exchange's 36 re-encoding hops; then on every rank the
   collective exchange of rps-100m's per-leaf plan at n = 4 against the
   port's global path on the stacked trees: the ring engine bit for bit
   against ring.cu (f32, bf16 wires) and ring_q.cu (int8, the same
   uniforms), the xla engine within COLL_TRAIN_TOL;
41. the mesh trainer (train/trainer.py) at rps-100m whole on the (4,)
   data mesh, batch 32 x seq 128 a rank, lr 0.3, p 0.1, 8 steps, on the
   ring and the xla engines, each against run_simulation (n 4) on the
   same init, batches and masks: every loss within COLL_TRAIN_TOL, every
   final parameter bit for bit on the ring engine and within
   COLL_TRAIN_TOL on the xla engine (bit equality counted),
   ring_rank_hop and ring_rank_land launches = 4 per bucket and step on
   every rank on the ring engine and none on the xla engine; step ms, the
   bytes staged a step and each rank's peak memory;
42. the dry-run (launch/dryrun.py, meta tensors) and the roofline on the
   card's own constants (roofline/analysis.py::HW, the H100 SXM data
   sheet): 42a every architecture x shape on the production meshes
   (layout rows: the exchange plan and state bytes; the counted terms not
   run, the port running neither TP inside a replica nor FSDP) and on one
   H100 (sim1, counted rows), each ok, layout only or skipped with the
   reference's reason, its table printed (t_compute, t_memory,
   t_collective, bottleneck, HBM a device, fits), and on this machine's
   torch the prefill and decode rows' count from two and three periods
   of the layer kinds (dryrun.by_periods) equal to the count of every
   layer on seven reduced configs, a train step's count with ops made
   again from their signatures equal to one running every op; 42b
   predictions against the card for one rps-100m worker's train step
   (32 x 128, f32), gemma3-1b's prefill of phase 4's prompts and its
   decode step at phase 4's 8 lanes: median of 5 steps after 1, the
   roofline share and the model FLOPs over (time x peak), each at most
   105 %, the peak of allocated bytes within 25 % of the prediction; 42c
   phase 41's collectives, record for record, equal to the dry-run's
   count of one rank's step x 8 (so are the link bytes), and the counted
   ring_rank.cu calls x 8 equal to the launches; 42d torch.profiler's
   launches of the hand-written kernels over one step of phase 17's ring
   run (taken right after phase 17) and one of phase 4's decode steps
   equal to their wrappers' counters (launch/launches.py).

The phases' wall seconds are printed on one line before the kernels'
line.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import channels as channels_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import masked_avg as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import rps as rps_lib  # noqa: E402
from repro_torch.data import (CharLMTask, TeacherTask,  # noqa: E402
                              make_worker_streams)
from repro_torch.kernels import rglru as GK  # noqa: E402
from repro_torch.kernels import ring as RG  # noqa: E402
from repro_torch.kernels import rwkv6 as RK  # noqa: E402
from repro_torch.kernels.ref import tp_combine_ref  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import inputs as inputs_lib  # noqa: E402
from repro_torch.models import layers as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.netsim import request_trace  # noqa: E402
from repro_torch.netsim import sim as netsim  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim import statepack  # noqa: E402
from repro_torch.roofline import HW, kernel_bound, kernel_cost  # noqa: E402
from repro_torch.serve import (ContinuousEngine, PagedCache,  # noqa: E402
                               ServeEngine, TPDecodeConfig, make_requests,
                               make_tp_context)
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.train import (SimulatorConfig,  # noqa: E402
                               make_exchange_plan, run_simulation)

# Full-precision f32 matmuls and convolutions on the card (no TF32), set
# explicitly: the kernel comparison and the dense-equivalence check state
# their tolerances for IEEE f32 arithmetic.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# NVIDIA H100 SXM data-sheet peaks at its 700 W limit (dense rates):
# roofline/analysis.py::HW; every kernel's bound from its cost function
# there (kernel_cost, kernel_bound)
H100 = HW()

SITES_PER_STEP = 52            # 2 collective sites × 26 layers
# the TP-combine kernel's sweep (phase 3c): (d, B); (24, 3), (1000, 7) and
# (37, 5) pad the decode plan at most s; (2304, 128) is a wide batch
TP_SHAPES = ((1152, 8), (24, 3), (1000, 7), (37, 5), (2304, 128))
TP_SERVE = (1152, 8, 4)        # gemma3-1b's (d_model, lanes, shards)
TP_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}     # by wire dtype


@dataclasses.dataclass(frozen=True)
class StaticLoad:
    """A static-batch slice's load: ``batch`` random prompts of
    ``prompt`` tokens, ``new`` greedy tokens each, and the kernel
    wrapper that its prefill launches ``per_prefill`` times."""
    arch: str
    batch: int
    prompt: int
    new: int
    kernel: object
    per_prefill: int


RWKV_LOAD = StaticLoad("rwkv6-1.6b", 8, 512, 32, RK.rwkv6, 24)
RWKV_SHAPE = (RWKV_LOAD.batch, RWKV_LOAD.prompt, 32, 64)  # (B, S, h, dk=dv)
RWKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 0.1}
RWKV_STATE_TOL = 2e-4          # the state is f32 whatever the input dtype
# 26 RG-LRU layers; 2048 = the window, where the reference's ring is right
RG_LOAD = StaticLoad("recurrentgemma-9b", 8, 2048, 32, GK.rglru, 26)
RG_SHAPE = (RG_LOAD.batch, RG_LOAD.prompt, 4096)           # (B, S, d_state)
RG_TOL = 1e-5                  # f32 h and the f32 carry
BF16_ULP = 2.0 ** -7           # bf16 h: one ulp of the rounded f32 h
# relative RMS error of the logits, prefill against decode (phases 8, 12)
PREFILL_DECODE_TOL = {"bfloat16": 5e-2, "float32": 1e-3}


# the ring-round phases (13-17)
RING_NS = (1, 2, 4, 8, 16)
# 1, 33, 4097: the scalar template; 64, 4096, 4104: the 16-byte template
# (VEC 4 at f32, 8 at bf16), one partial tile, whole tiles, both
RING_DS = (1, 33, 64, 4096, 4097, 4104)
BUCKET_MB = 25                 # the one-bucket timing shape at n = 16
# examples/train_rps_100m.py's model, built here (not a registry config)
RPS_100M = ArchConfig(
    name="rps-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=3072, vocab_size=16_384, max_seq=1024,
    dtype="float32", citation="examples/train_rps_100m.py")
# the example's --paper-scale load
# the example's --paper-scale load, run 4 steps past its 20-step warm-up
RPS_100M_LOAD = dict(n=16, batch=32, seq=128, lr=0.3, warmup=20, steps=24,
                     p=0.1)
QUICKSTART_TOL = 1e-4          # ring against xla final loss (test_ring.py)
QUICKSTART_SHAPES = {"w1": (24, 48), "w2": (48, 8)}    # the 24-48-8 MLP


def reset_counts() -> None:
    """Zero every kernel's launch count (before a path is driven)."""
    K.masked_avg_grid.launches = 0
    K.tp_combine.launches = 0
    RK.rwkv6.launches = 0
    GK.rglru.launches = 0
    RG.ring_round.launches = 0
    RG.ring_round_enc.launches = 0
    RG.ring_round_enc.requant_launches = 0
    RG.ring_rank_hop.launches = 0
    RG.ring_rank_land.launches = 0


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


def event_ms(fn, calls: int, warm: int = 2) -> float:
    """Device time of one ``fn()`` call from CUDA events around ``calls``
    eager calls, for calls long enough that the host stays ahead of the
    card (phase 19: the encoded ring round's cooperative launch is timed
    outside a CUDA graph)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


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


def xla_grid_shapes() -> dict:
    """The (G·s, n, d) block stacks the masked-average kernel takes on the
    training phases' xla runs, one launch per exchange group and step: the
    quickstart's per-leaf plan at n = 16 (phase 15) and the gap study's
    two-bucket plan at n = 8 (phase 20)."""
    runs = {"quickstart": (QUICKSTART_SHAPES, SimulatorConfig(
                n_workers=16, aggregator="rps_model", engine="xla")),
            "gap_study": (GAP_STUDY_SHAPES, SimulatorConfig(
                n_workers=GAP_STUDY["n"], aggregator="rps_model",
                n_buckets=2))}
    out = {}
    for name, (shapes, scfg) in runs.items():
        tree = {k: torch.empty(shape, device="meta")
                for k, shape in shapes.items()}
        plan = make_exchange_plan(tree, scfg)
        out[name] = sorted(
            (len(idxs) * plan.s, plan.n, blk * m)
            for (blk, m, _dt), idxs in rps_lib._global_groups(plan).items())
    return out


def check_kernel(gen: torch.Generator, path_shapes: dict) -> float:
    """Phase 3a: kernel vs its plain version over the sweep: the xla runs'
    shapes (``path_shapes``) and a grid around them. Returns the largest
    f32 error at the quickstart's largest shape with a bool mask (what the
    exchange feeds it)."""
    big = path_shapes["quickstart"][-1]
    shapes = sorted({s for v in path_shapes.values() for s in v}) + [
        (B, n, d) for B in (1, 3, 16) for n in (2, 8, 16, 32)
        for d in (7, 512, 1000, 2304)]
    path_err = None
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
                if shape == big and dt == torch.float32 \
                        and mdt == torch.bool:
                    path_err = err
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
    return path_err


def time_kernel(gen: torch.Generator, shape: tuple) -> dict:
    """Phase 3b: times at ``shape`` (G·s, n, d), the quickstart's largest
    (f32 blocks, bool mask)."""
    B, n, d = shape
    x = torch.randn(shape, generator=gen, device="cuda")
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
    flops, nbytes = kernel_cost("masked_avg_grid", x, m)
    bound_s, bound_by = kernel_bound("masked_avg_grid", flops, nbytes)
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library),
            "eager_ms": eager_ms(kernel), "eager_plain_ms": eager_ms(plain),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes, "shape": list(shape)}


def tp_masks(gen: torch.Generator, n: int, s: int, kind: str,
             sites: int = SITES_PER_STEP) -> tuple:
    """A (sites, n, s) bool mask pair: Bernoulli(0.7) with the owners
    forced at every site, and at sites 0 and sites - 1 the case ``kind``:
    "bernoulli", "delivered" (every packet) or "owner" (every packet
    dropped but the owner's); "broadcast": one draw expanded over the
    sites (stride 0, as a channel on the base class's sample_packets
    gives it)."""
    if kind == "broadcast":
        rs, ag = rps_lib.sample_masks(gen, n, 0.3, s)
        return rs.expand(sites, n, s), ag.expand(sites, n, s)
    rs, ag = rps_lib.sample_masks(gen, n, 0.3, s, n_buckets=sites)
    own = rps_lib.owner_mask(n, s, device=gen.device)
    for site in (0, sites - 1):
        if kind == "delivered":
            rs[site], ag[site] = True, True
        elif kind == "owner":
            rs[site], ag[site] = own, own
    return rs, ag


def tp_partials(gen: torch.Generator, n: int, B: int, d: int, dtype,
                integer: bool, strided: bool) -> torch.Tensor:
    """(n, B, 1, d) partials in ``dtype``: integers in [-6, 6], or unit
    normals divided by n (so the exchanged n * p are unit normals, the
    kernel tests' inputs); ``strided``: a view whose columns are not
    contiguous."""
    shape = (n, d, B) if strided else (n, B, d)
    if integer:
        x = torch.randint(-6, 7, shape, generator=gen, device="cuda")
        x = x.to(torch.float32)
    else:
        x = torch.randn(shape, generator=gen, device="cuda") / n
    x = x.to(dtype)
    return (x.transpose(1, 2) if strided else x)[:, :, None, :]


def check_tp_combine(gen: torch.Generator) -> dict:
    """Phase 3c: the TP-combine kernel against its plain version over the
    sweep, then bit for bit against the exchange route at the serving
    shape. Returns the case count and the largest error on normal
    partials by wire."""
    n_cases, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n in (2, 4, 8, 16):
        for s in sorted({max(n // 2, 1), n, 2 * n}):
            for kind, strided in (("bernoulli", False), ("bernoulli", True),
                                  ("broadcast", False), ("delivered", False),
                                  ("owner", False)):
                rs, ag = tp_masks(gen, n, s, kind)
                for d, B in TP_SHAPES:
                    blk = -(-d * B // s)
                    geom = K.CombineGeometry(s=s, blk=blk, pad=s * blk - d * B)
                    for pdt in (torch.float32, torch.bfloat16):
                        for integer in (True, False):
                            x = tp_partials(gen, n, B, d, pdt, integer,
                                            strided)
                            for wire in (torch.float32, torch.bfloat16):
                                for r in (0, n - 1):
                                    for site in (0, SITES_PER_STEP - 1):
                                        kw = dict(n=n, receiver=r,
                                                  wire_dtype=wire)
                                        got = K.tp_combine(
                                            x, rs, ag, site,
                                            plan_geometry=geom, **kw)
                                        want = tp_combine_ref(
                                            x, rs, ag, site, s=s, blk=blk,
                                            pad=geom.pad, **kw)
                                        _tp_agree(got, want, integer, wire,
                                                  worst, (n, s, kind,
                                                          strided, d, B,
                                                          pdt, wire, r,
                                                          site))
                                        n_cases += 1
    n_exchange = 0
    d, B, n = TP_SERVE
    for wire in ("f32", "bf16"):
        tp = make_tp_context(TPDecodeConfig(n_shards=n, p=0.1, wire=wire),
                             get_config("gemma3-1b"), B)
        if not tp.fused:
            raise AssertionError(f"TP at the {wire} wire is not fused")
        masks, _ = tp.sample_site_masks(gen, None)
        for pdt in (torch.bfloat16, torch.float32):
            x = torch.randn((n, B, 1, d), generator=gen,
                            device="cuda").to(pdt)
            for site in range(tp.n_sites):
                got = tp._exchange(x, masks, site)
                want = tp._exchange_global(x, masks, site)
                if not torch.equal(_bits(got), _bits(want.contiguous())):
                    raise AssertionError(
                        f"tp_combine differs from the exchange route at "
                        f"the {wire} wire, {pdt} partials, site {site}")
                n_exchange += 1
    print(f"tp_combine sweep: {n_cases} cases agree with the plain version, "
          f"{n_exchange} serving sites bit for bit with the exchange route",
          flush=True)
    return {"cases": n_cases, "exchange_cases": n_exchange,
            "max_abs_err_f32_wire": worst[torch.float32],
            "max_abs_err_bf16_wire": worst[torch.bfloat16]}


def _tp_agree(got, want, integer: bool, wire, worst: dict,
              case: tuple) -> None:
    torch.cuda.synchronize()
    if integer:
        if not torch.equal(_bits(got), _bits(want.contiguous())):
            raise AssertionError(f"tp_combine {case}: integer partials not "
                                 f"bit for bit")
        return
    err = (got - want).abs().max().item()
    worst[wire] = max(worst[wire], err)
    tol = TP_TOL[wire]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"tp_combine {case}: max abs err {err} > tol "
                             f"{tol}")


def time_tp_combine(gen: torch.Generator) -> dict:
    """Phase 3c's times at the serving shape: f32 partials (every site but
    layer 0's attention), the f32 wire, Bernoulli p = 0.1 masks."""
    d, B, n = TP_SERVE
    tp = make_tp_context(TPDecodeConfig(n_shards=n, p=0.1),
                         get_config("gemma3-1b"), B)
    masks, _ = tp.sample_site_masks(gen, None)
    x = torch.randn((n, B, 1, d), generator=gen, device="cuda")
    site = 1
    g = tp.geometry

    def kernel():
        return tp._exchange(x, masks, site)

    def unfused():
        return tp._exchange_global(x, masks, site)

    def plain():
        return tp_combine_ref(x, masks[0], masks[1], site, n=n,
                              receiver=tp.receiver, s=g.s, blk=g.blk,
                              pad=g.pad, wire_dtype=tp.wire_dtype)

    # each input byte read once: the partials, the site's rs rows and the
    # receiver's ag row; the (B, 1, d) f32 output written once
    flops, nbytes = kernel_cost("tp_combine", x, masks[0], masks[1], site,
                                n=n, receiver=tp.receiver, plan_geometry=g)
    bound_s, bound_by = kernel_bound("tp_combine", flops, nbytes)
    return {"ms": device_ms(kernel), "unfused_ms": device_ms(unfused),
            "plain_ms": device_ms(plain),
            "eager_ms": eager_ms(kernel), "eager_unfused_ms": eager_ms(unfused),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
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
    reset_counts()
    rep = eng.run(reqs, drain=True)
    launches = K.tp_combine.launches
    unfused = K.masked_avg_grid.launches
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
        raise AssertionError(f"tp_combine launches {launches} != 52 × chunk "
                             f"{eng.chunk} × rounds {rep.rounds} = {want}")
    if unfused:
        raise AssertionError(f"the serving path launched the masked-average "
                             f"kernel {unfused} times")
    return {"requests": len(rep.requests), "tokens": rep.tokens,
            "wall_s": rep.wall_s, "tokens_per_s": rep.tokens_per_s,
            "p50_ms": rep.latency_quantile(0.5),
            "p99_ms": rep.latency_quantile(0.99), "rounds": rep.rounds,
            "prefills": rep.prefills, "decode_steps": eng.chunk * rep.rounds,
            "tp_combine_launches": launches,
            "masked_avg_grid_launches": unfused}


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


# phase 6's decays beside the kernel tests' uniform (0.05, 0.995): every
# w at 1e-30 (the clip), at 0.999, and at 0 (clipped to 1e-30 in the
# kernel; exactly 0 in the plain version)
RWKV_DECAYS = {"uniform": None, "tiny": 1e-30, "slow": 0.999, "zero": 0.0}


def rwkv_inputs(gen: torch.Generator, B: int, S: int, h: int, dk: int,
                dv: int, dtype: torch.dtype, decay: str = "uniform") -> list:
    """The JAX kernel tests' input distribution on the card: r, k, v
    normal × 0.5, w uniform in (0.05, 0.995) (or every w at one of
    RWKV_DECAYS), u normal × 0.1 (f32)."""
    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    r = normal((B, S, h, dk), 0.5)
    k = normal((B, S, h, dk), 0.5)
    v = normal((B, S, h, dv), 0.5)
    w = 0.05 + 0.945 * torch.rand((B, S, h, dk), generator=gen,
                                  device="cuda")
    if RWKV_DECAYS[decay] is not None:
        w = torch.full_like(w, RWKV_DECAYS[decay])
    u = normal((h, dk), 0.1)
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


def check_rwkv6(gen: torch.Generator) -> dict:
    """Phase 6a: the RWKV-6 kernel against its plain version over the
    sweep, at every decay of RWKV_DECAYS, and at the slice shape. Returns
    the slice shape's errors."""
    cases = [(2, S, 3, dk, dv) for S in (1, 16, 33, 130, 512)
             for dk, dv in ((8, 8), (16, 32), (64, 64))]
    cases.append(RWKV_SHAPE + (64,))
    errs = {}
    n_cases = 0
    # the extreme decays draw from a generator of their own, so the
    # phases after this one see the same draws as without them
    extreme = torch.Generator(device="cuda")
    extreme.manual_seed(6)
    for B, S, h, dk, dv in cases:
        for dt in (torch.float32, torch.bfloat16):
            for decay in RWKV_DECAYS:
                if decay != "uniform" and (B, S, h, dk) == RWKV_SHAPE:
                    continue
                args = rwkv_inputs(gen if decay == "uniform" else extreme,
                                   B, S, h, dk, dv, dt, decay)
                o, state = ops.rwkv6(*args)
                o_ref, s_ref = ops.rwkv6(*args, backend="ref")
                torch.cuda.synchronize()
                err_o = (o.float() - o_ref.float()).abs().max().item()
                err_s = (state - s_ref).abs().max().item()
                tol = RWKV_TOL[dt]
                what = f"rwkv6 {(B, S, h, dk, dv)} {dt} w {decay}"
                if o.dtype != dt or not torch.allclose(
                        o.float(), o_ref.float(), atol=tol, rtol=tol):
                    raise AssertionError(f"{what}: output max abs err "
                                         f"{err_o} > {tol}")
                if not torch.allclose(state, s_ref, atol=RWKV_STATE_TOL,
                                      rtol=RWKV_STATE_TOL):
                    raise AssertionError(f"{what}: state max abs err "
                                         f"{err_s} > {RWKV_STATE_TOL}")
                if (B, S, h, dk) == RWKV_SHAPE:
                    errs[str(dt).replace("torch.", "")] = {"o": err_o,
                                                           "state": err_s}
                n_cases += 1
    print(f"rwkv6 sweep: {n_cases} cases agree with the plain version",
          flush=True)
    return errs


def time_rwkv6(gen: torch.Generator) -> dict:
    """Phase 6b: times at the slice shape, bf16. The plain version is a
    512-step Python loop, so its graph holds few calls. The bound: the
    inputs read and the outputs written once, against the recurrence's
    6 B S h dk dv operations at the TF32 tensor-core rate the kernel's
    products run at; the same operations on the f32 cores beside it."""
    B, S, h, dk = RWKV_SHAPE
    dv = dk
    args = rwkv_inputs(gen, B, S, h, dk, dv, torch.bfloat16)

    def kernel():
        return RK.rwkv6(*args)

    def plain():
        return ops.rwkv6(*args, backend="ref")

    # r, k, w, v, u read; the output and the final state written
    flops, nbytes = kernel_cost("rwkv6", *args)
    bound_s, bound_by = kernel_bound("rwkv6", flops, nbytes)
    ms = device_ms(kernel, calls=20, reps=10)
    out = {"ms": ms, "plain_ms": device_ms(plain, calls=2, reps=3),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "bound_f32_simt_ms": max(nbytes / H100.hbm_bw,
                                    flops / H100.peak_f32) * 1e3,
           "cuda_launches_per_call": 1, "memsets_per_call": 1,
           "bytes": nbytes, "flops": flops}
    print(f"rwkv6 {RWKV_SHAPE} bf16: {ms:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}; f32 cores "
          f"{out['bound_f32_simt_ms']:.4f} ms)", flush=True)
    return out


def serve_static(model, params, gen: torch.Generator,
                 load: StaticLoad) -> dict:
    """Phases 7 and 11: the static-batch engine at full width on
    ``load``. One short warm-up run at the same prompt shape (two new
    tokens), then the checked run: prefill and every decode step timed
    on the host clock between synchronisations."""
    cfg = model.cfg
    prefill, decode = model.prefill, model.decode_step
    finite = torch.ones((), dtype=torch.bool, device=model.device)
    times = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            nonlocal finite
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            finite = finite & torch.isfinite(logits).all()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return logits, cache
        return call

    eng = ServeEngine(model, params, max_len=load.prompt + load.new)
    prompts = torch.randint(0, cfg.vocab_size, (load.batch, load.prompt),
                            generator=gen, device="cuda")
    eng.generate(prompts, 2)          # warm-up at the prompt's shapes
    model.prefill = timed("prefill", prefill)
    model.decode_step = timed("decode", decode)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, load.new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = load.kernel.launches
    model.prefill, model.decode_step = prefill, decode
    if tuple(out.shape) != (load.batch, load.new):
        raise AssertionError(f"generated {tuple(out.shape)}, want "
                             f"{(load.batch, load.new)}")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("token out of range")
    if not bool(finite):
        raise AssertionError("non-finite logits")
    prefills = len(times["prefill"])
    if len(times["decode"]) != load.new:
        raise AssertionError(f"{len(times['decode'])} decode calls, want "
                             f"{load.new}")
    if launches != load.per_prefill * prefills:
        raise AssertionError(f"{load.arch}: kernel launches {launches} != "
                             f"{load.per_prefill} × {prefills} prefills")
    return {"arch": load.arch, "batch": load.batch,
            "prompt_len": load.prompt, "new_tokens": load.new,
            "wall_s": wall, "tokens_per_s": load.batch * load.new / wall,
            "prefill_ms": times["prefill"][0] * 1e3,
            "decode_ms_per_step": sum(times["decode"]) * 1e3 / load.new,
            "prefills": prefills, "kernel_launches": launches}


def _f32(tree):
    """An f32 copy of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def prefill_vs_decode(model, params, gen: torch.Generator, load: StaticLoad,
                      f32_layers=None, steps: int = 4) -> dict:
    """Phases 8 and 12: the last logits of prefill(prompt + steps tokens)
    against prefill(prompt) and ``steps`` teacher-forced decode steps, for
    the slice's bf16 weights and for an f32 copy of them (of the first
    ``f32_layers`` layers, or all). In bf16 the two routes round at
    different places (the prefill's matrix products over all positions
    against the decode's over one, the kernel's output against the plain
    decode step's), so they agree to a relative RMS error on the logits;
    in f32 only the order of the f32 sums differs, and the tolerance is
    tight enough to catch a fault of the recurrence or the cache."""
    cfg = model.cfg
    S = load.prompt
    toks = torch.randint(0, cfg.vocab_size, (2, S + steps),
                         generator=gen, device="cuda")
    n32 = f32_layers or cfg.n_layers
    model32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              n_layers=n32), device="cuda")
    params32 = {"embed": _f32(params["embed"]),
                "layers": [_f32(layer) for layer in params["layers"][:n32]]}
    out = {"steps": steps, "prompt_len": S, "f32_layers": n32}
    for name, m, p in (("bfloat16", model, params),
                       ("float32", model32, params32)):
        want, _ = m.prefill(p, {"tokens": toks})
        got, cache = m.prefill(p, {"tokens": toks[:, :S]},
                               max_len=S + steps)
        for t in range(steps):
            pos = S + t
            got, cache = m.decode_step(p, cache,
                                       {"token": toks[:, pos:pos + 1]}, pos)
        g, w = got.float(), want.float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{name}: non-finite logits")
        rel = ((g - w).norm() / w.norm()).item()
        tol = PREFILL_DECODE_TOL[name]
        if rel > tol:
            raise AssertionError(f"{load.arch} {name} prefill vs decode "
                                 f"logits: relative RMS error {rel} > {tol}")
        out[name] = {"rel_rms": rel, "max_abs": (g - w).abs().max().item(),
                     "argmax_equal": bool((g.argmax(-1)
                                           == w.argmax(-1)).all()),
                     "tol_rel_rms": tol}
    return out


def rglru_inputs(gen: torch.Generator, B: int, S: int, d: int,
                 dtype: torch.dtype, a_dtype=torch.float32) -> tuple:
    """The JAX kernel tests' input distribution on the card: x normal in
    ``dtype``, a uniform in (0.1, 0.999) in ``a_dtype``."""
    x = torch.randn((B, S, d), generator=gen, device="cuda").to(dtype)
    a = 0.1 + 0.899 * torch.rand((B, S, d), generator=gen, device="cuda")
    return x, a.to(a_dtype)


def check_rglru(gen: torch.Generator) -> dict:
    """Phase 9: the RG-LRU kernel against its plain version over the
    sweep, and at the slice shape. f32 h within 1e-5; bf16 h against the
    plain version's f32 h rounded to bf16, within one bf16 ulp; the f32
    carry within 1e-5. Returns the slice shape's errors."""
    cases = [(2, S, d, dt, torch.float32)
             for S in (1, 16, 33, 130, 2048) for d in (8, 70, 4096)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [RG_SHAPE + (dt, torch.float32)
              for dt in (torch.float32, torch.bfloat16)]
    cases.append((2, 130, 70, torch.bfloat16, torch.bfloat16))  # a in x's
    errs = {}
    for B, S, d, dt, adt in cases:
        x, a = rglru_inputs(gen, B, S, d, dt, adt)
        h, h_last = ops.rglru(x, a)
        h_ref, last_ref = ops.rglru(x, a, backend="ref")
        torch.cuda.synchronize()
        err_h = (h.float() - h_ref.float()).abs().max().item()
        err_last = (h_last - last_ref).abs().max().item()
        tol = (dict(atol=RG_TOL, rtol=RG_TOL) if dt == torch.float32
               else dict(atol=1e-6, rtol=BF16_ULP))
        if h.dtype != dt or not torch.allclose(h.float(), h_ref.float(),
                                               **tol):
            raise AssertionError(f"rglru {(B, S, d)} x {dt} a {adt}: h max "
                                 f"abs err {err_h} > {tol}")
        if not torch.allclose(h_last, last_ref, atol=RG_TOL, rtol=RG_TOL):
            raise AssertionError(f"rglru {(B, S, d)} x {dt} a {adt}: "
                                 f"h_last max abs err {err_last} > {RG_TOL}")
        if (B, S, d) == RG_SHAPE:
            errs[str(dt).replace("torch.", "")] = {"h": err_h,
                                                   "h_last": err_last}
    print(f"rglru sweep: {len(cases)} cases agree with the plain version",
          flush=True)
    return errs


def time_rglru(gen: torch.Generator) -> dict:
    """Phase 10: times at the slice shape, bf16 x and f32 a (the model's
    dtypes). The plain version is a 2048-step Python loop, so its graph
    holds few calls."""
    B, S, d = RG_SHAPE
    x, a = rglru_inputs(gen, B, S, d, torch.bfloat16)

    def kernel():
        return GK.rglru(x, a)

    def plain():
        return ops.rglru(x, a, backend="ref")

    # x, a read; h and h_last written
    flops, nbytes = kernel_cost("rglru", x, a)
    bound_s, bound_by = kernel_bound("rglru", flops, nbytes)
    return {"ms": device_ms(kernel, calls=20, reps=10),
            "plain_ms": device_ms(plain, calls=2, reps=3),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops}


def init_model(arch: str, gen: torch.Generator):
    """A full-size model and random weights drawn on the card; prints the
    init time."""
    model = build_model(get_config(arch), device="cuda")
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"init_s {time.perf_counter() - t0:.3f} ({arch})", flush=True)
    return model, params


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def ring_case(gen: torch.Generator, G: int, n: int, s: int, d: int,
              dtype: torch.dtype, integer: bool, mode: str):
    """Random inputs of one ring-round case on the card: the stack
    (integer-valued in [-8, 8] or normal), Bernoulli(0.7) masks with the
    owner entries forced on, and the divisor ``mode`` prescribes."""
    if integer:
        x = torch.randint(-8, 9, (G, n, s, d), generator=gen, device="cuda")
    else:
        x = torch.randn((G, n, s, d), generator=gen, device="cuda")
    own = rps_lib.owner_mask(n, s, device="cuda")
    rs = (torch.rand((G, n, s), generator=gen, device="cuda") < 0.7) | own
    ag = (torch.rand((G, n, s), generator=gen, device="cuda") < 0.7) | own
    div = rps_lib._divisor(rps_lib.wire_lib.make_recovery("renorm"), mode,
                           rs, n)
    return x.to(dtype), rs, ag, div


def check_ring(gen: torch.Generator) -> tuple:
    """Phase 13: the kernel against its plain version, bit for bit, over
    the sweep. Returns (the number of cases, the largest absolute
    difference, 0 when every case is bitwise)."""
    n_cases, worst = 0, 0.0
    for n in RING_NS:
        for s in sorted({1, max(n // 2, 1), n, 2 * n}):
            for d in RING_DS:
                for G in (1, 3):
                    for dt in (torch.float32, torch.bfloat16):
                        for integer in (True, False):
                            for mode in RG.MODES:
                                args = ring_case(gen, G, n, s, d, dt,
                                                 integer, mode)
                                for acc in (torch.float32, torch.bfloat16):
                                    got = ops.ring_round(*args, mode=mode,
                                                         rs_dtype=acc)
                                    want = ops.ring_round(
                                        *args, mode=mode, rs_dtype=acc,
                                        backend="ref")
                                    err = (got.float() - want.float()
                                           ).abs().max().item()
                                    worst = max(worst, err)
                                    if not torch.equal(_bits(got),
                                                       _bits(want)):
                                        raise AssertionError(
                                            f"ring_round G={G} n={n} s={s} "
                                            f"d={d} {dt} acc {acc} {mode} "
                                            f"int={integer}: not bitwise "
                                            f"(max abs err {err})")
                                    n_cases += 1
    print(f"ring sweep: {n_cases} cases agree bit for bit with the plain "
          f"version", flush=True)
    return n_cases, worst


def check_ring_plans(gen: torch.Generator, plans: dict) -> int:
    """Phase 13, continued: the kernel against its plain version, bit for
    bit, at every exchange group of the training phases' plans, in its
    payload dtype, every mode and both accumulation dtypes (normal data).
    Returns the number of cases."""
    n_cases = 0
    for name, plan in plans.items():
        for (blk, m, dt), idxs in rps_lib._global_groups(plan).items():
            for mode in RG.MODES:
                args = ring_case(gen, len(idxs), plan.n, plan.s, blk * m,
                                 getattr(torch, dt), False, mode)
                for acc in (torch.float32, torch.bfloat16):
                    got = ops.ring_round(*args, mode=mode, rs_dtype=acc)
                    want = ops.ring_round(*args, mode=mode, rs_dtype=acc,
                                          backend="ref")
                    if not torch.equal(_bits(got), _bits(want)):
                        raise AssertionError(
                            f"ring_round at {name}'s group {blk}x{m} {dt} "
                            f"(G={len(idxs)}) acc {acc} {mode}: not bitwise")
                    n_cases += 1
                    del got, want
            del args
    torch.cuda.empty_cache()
    print(f"ring plan groups: {n_cases} cases agree bit for bit with the "
          f"plain version", flush=True)
    return n_cases


def largest_group(plan) -> tuple:
    """(G, n, s, d) of the plan's largest exchange group by bytes."""
    best = None
    for (blk, m, _dt), idxs in rps_lib._global_groups(plan).items():
        shape = (len(idxs), plan.n, plan.s, blk * m)
        if best is None or np.prod(shape) > np.prod(best):
            best = shape
    return best


def time_ring(gen: torch.Generator, shape: tuple) -> dict:
    """Phase 14: times of one ring-round call on an f32 (G, n, s, d)
    group in model mode with the f32 wire (the slice's dtypes)."""
    G, n, s, d = shape
    x, rs, ag, div = ring_case(gen, G, n, s, d, torch.float32, False,
                               "model")

    def kernel():
        return RG.ring_round(x, rs, ag, div, mode="model")

    def plain():
        return ops.ring_round(x, rs, ag, div, mode="model", backend="ref")

    def xla_route():
        sums = torch.einsum("gij,gijd->gjd", rs.to(torch.float32), x)
        tilde = sums / div[..., None]
        return torch.where(ag[..., None], tilde[:, None], x)

    got = kernel()
    if not torch.equal(_bits(got), _bits(plain())):
        raise AssertionError(f"ring_round {shape}: not bitwise at the "
                             f"timing shape")
    err_xla = (xla_route() - got).abs().max().item()
    del got
    torch.cuda.empty_cache()
    el = x.element_size()
    # the stack in and out, the masks and the divisor; a gate and an add
    flops, nbytes = kernel_cost("ring_round", x, rs, ag, div)
    bound_s, bound_by = kernel_bound("ring_round", flops, nbytes)
    big = x.numel() * el > 2 ** 30
    return {"shape": list(shape),
            "ms": device_ms(kernel, calls=5 if big else 20, reps=5),
            "plain_ms": device_ms(plain, calls=1, reps=2),
            "xla_route_ms": device_ms(xla_route, calls=2 if big else 5,
                                      reps=3),
            "xla_route_max_abs_diff": err_xla,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes}


def teacher_init(gen: torch.Generator) -> dict:
    """The quickstart's 24-48-8 tanh MLP, N(0, 0.01) weights."""
    return {k: torch.randn(shape, generator=gen, device=gen.device) * 0.1
            for k, shape in QUICKSTART_SHAPES.items()}


def teacher_loss(p, batch):
    x, y = batch
    logits = torch.tanh(x @ p["w1"]) @ p["w2"]
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def quickstart(groups: int, steps: int = 150, n: int = 16) -> dict:
    """Phase 15: examples/quickstart.py on the port. Four runs from one
    seed (so the same initial weights and, for the three p = 0.1 runs,
    the same drop masks); each rps run's kernel launches are counted: the
    ring kernel's, and on the xla run the masked-average kernel's, one per
    exchange group (``groups``, whose shapes phase 3a sweeps) and step."""
    task = TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    init_fn, loss_fn = teacher_init, teacher_loss
    batch_fn = make_worker_streams(task, n, 32)
    out = {}
    for name, agg, p, engine in (("baseline", "allreduce_model", 0.0, "ring"),
                                 ("rps_model", "rps_model", 0.1, "ring"),
                                 ("rps_grad", "rps_grad", 0.1, "ring"),
                                 ("rps_model_xla", "rps_model", 0.1, "xla")):
        scfg = SimulatorConfig(n_workers=n, drop_rate=p, aggregator=agg,
                               lr=0.2, warmup=10, steps=steps,
                               eval_every=steps - 1, engine=engine)
        reset_counts()
        h = run_simulation(loss_fn, init_fn, batch_fn, scfg)
        launches = RG.ring_round.launches
        out[name] = {"final_loss": h["final_loss"],
                     "consensus": h["consensus"][-1],
                     "ring_launches": launches,
                     "masked_avg_launches": K.masked_avg_grid.launches,
                     "wall_s": sum(h["step_s"])}
        if agg.startswith("rps") and engine == "ring" \
                and launches != 2 * steps:      # two leaves, one group each
            raise AssertionError(f"quickstart {name}: {launches} ring "
                                 f"launches, want {2 * steps}")
        if engine == "xla" \
                and out[name]["masked_avg_launches"] != groups * steps:
            raise AssertionError(
                f"quickstart {name}: {out[name]['masked_avg_launches']} "
                f"masked-average launches, want {groups * steps}")
    base, rps = out["baseline"]["final_loss"], out["rps_model"]["final_loss"]
    if not rps < base * 1.15 + 0.02:
        raise AssertionError(f"quickstart claim fails: RPS {rps} >= 1.15 x "
                             f"baseline {base} + 0.02")
    gap = abs(out["rps_model_xla"]["final_loss"] - rps)
    if gap > QUICKSTART_TOL:
        raise AssertionError(f"quickstart ring vs xla final loss: {gap} > "
                             f"{QUICKSTART_TOL}")
    out["ring_vs_xla_abs"] = gap
    return out


def launcher_default() -> dict:
    """Phase 16: ``python -m repro_torch.launch.train`` at its defaults
    (rps-paper-mlp, n = 16, batch 32, seq 64, 200 steps, lr 0.05, warmup
    10, p = 0.1) on the ring engine."""
    reset_counts()
    h = train_launcher.main(["--engine", "ring"])
    launches = RG.ring_round.launches
    floor = CharLMTask(vocab=256, seq_len=64).entropy_floor()
    losses = h["loss"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"launcher: loss did not fall: {losses}")
    if launches == 0:
        raise AssertionError("launcher: the ring kernel never launched")
    return {"final_loss": h["final_loss"], "first_loss": losses[0],
            "entropy_floor": floor, "consensus": h["consensus"][-1],
            "ring_launches": launches, "wall_s": sum(h["step_s"]),
            "step_ms_mean": 1e3 * float(np.mean(h["step_s"][1:]))}


@dataclasses.dataclass
class Rps100mSetup:
    """Phase 17's model, initial weights and batches, shared with phase
    21 so that its int8 runs start from the same point."""
    model: object
    p1: dict
    batches: list
    data_s: float

    def loss_fn(self, p, b):
        return self.model.loss(p, b)[0]


def rps100m_setup(gen: torch.Generator, load=RPS_100M_LOAD) -> Rps100mSetup:
    """rps-100m at full width with random weights from ``gen``, and the
    load's batches (made before the runs: set-up, so the step times are
    the simulator's; one more than the steps, the last held out)."""
    model = build_model(RPS_100M, device="cuda")
    p1 = model.init_stacked(gen)
    task = CharLMTask(vocab=RPS_100M.vocab_size, seq_len=load["seq"],
                      seed=0)
    t0 = time.perf_counter()
    stream = make_worker_streams(task, load["n"], load["batch"])
    batches = [stream(t) for t in range(load["steps"] + 1)]
    return Rps100mSetup(model, p1, batches, time.perf_counter() - t0)


def rps100m_config(load=RPS_100M_LOAD, **kw) -> SimulatorConfig:
    base = dict(n_workers=load["n"], drop_rate=load["p"],
                aggregator="rps_model", lr=load["lr"],
                warmup=load["warmup"], steps=load["steps"], eval_every=1,
                engine="ring")
    base.update(kw)
    return SimulatorConfig(**base)


def rps100m(setup: Rps100mSetup, load=RPS_100M_LOAD) -> dict:
    """Phase 17: rps-100m at the example's paper scale on the ring
    kernel, past the warm-up. Learning is checked twice: the last step's
    training loss is below the first step's, and a held-out batch (the
    step after the run's last, never trained on) scores lower under the
    workers' mean model after the run than under the initial model."""
    n, steps = load["n"], load["steps"]
    p1, batches, loss_fn = setup.p1, setup.batches, setup.loss_fn
    n_params = sum(x.numel() for x in tree_lib.leaves(p1))
    data_s = setup.data_s
    scfg = rps100m_config(load)
    plan = make_exchange_plan(p1, scfg)
    groups = len(rps_lib._global_groups(plan))

    def held_out(p):
        with torch.no_grad():
            return float(torch.stack([
                loss_fn(p, {k: v[i] for k, v in batches[steps].items()})
                for i in range(n)]).mean())

    held_before = held_out(p1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    h = run_simulation(loss_fn, None, lambda t: batches[t], scfg,
                       init_params=p1)
    launches = RG.ring_round.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss, cons = h["loss"], h["consensus"]
    if launches != groups * steps:
        raise AssertionError(f"rps-100m: {launches} ring launches, want "
                             f"{groups} groups x {steps} steps")
    held_after = held_out(tree_lib.map(lambda x: torch.mean(x, 0),
                                       h["params"]))
    if not (all(np.isfinite(loss)) and loss[-1] < loss[0]
            and held_after < held_before):
        raise AssertionError(f"rps-100m: losses {loss}; held-out batch "
                             f"{held_before} -> {held_after}: not finite, "
                             f"or not lower after the run")
    if not (np.isfinite(cons[-1]) and cons[-1] > 0):
        raise AssertionError(f"rps-100m: consensus {cons[-1]}")
    step_s = h["step_s"]
    later = float(np.mean(step_s[1:]))
    tokens = n * load["batch"] * load["seq"]
    return {"params_per_worker": n_params, "groups": groups,
            "ring_launches": launches, "data_s": data_s,
            "first_step_ms": step_s[0] * 1e3,
            "step_ms": [t * 1e3 for t in step_s[1:]],
            "tokens_per_s": tokens / later, "peak_memory_gb": peak,
            "loss": loss, "held_out_loss_before": held_before,
            "held_out_loss_after": held_after,
            "consensus": cons,
            "largest_group": list(largest_group(plan)), **load}


# phases 21, 24 and 27-29 run rps-100m cut to its first 4 of 12 layers
# (phase 17's embedding, first layers and batches; width, n, batch, seq,
# lr, p, engine and step counts as phase 17's): at 12 layers they took
# 241 s of the smoke's 1,200 s limit, and the products and launches a
# step scale with depth
CUT_LAYERS = 4
CUT_BASE_STEPS = 8             # the longest run the cut's baseline stands for


def cut_setup(setup: Rps100mSetup, layers: int = CUT_LAYERS) -> Rps100mSetup:
    """Phase 17's setup cut to its first ``layers`` layers: the same
    embedding, the first layers of its stacked weights (views) and the
    same batches."""
    cfg = dataclasses.replace(RPS_100M, n_layers=layers)
    p1 = {"embed": setup.p1["embed"],
          "layers": tree_lib.map(lambda x: x[:layers], setup.p1["layers"])}
    return Rps100mSetup(build_model(cfg, device="cuda"), p1, setup.batches,
                        setup.data_s)


def cut_baseline(setup: Rps100mSetup, load=RPS_100M_LOAD) -> dict:
    """The cut's own run at phase 17's load (f32 wire, renorm, ring
    engine), CUT_BASE_STEPS steps: the losses phases 21 and 27 hold their
    runs to at every step, and the peak phase 27's robust runs are held
    to, as phase 17's were at 12 layers. Launches = groups x steps, every
    loss finite."""
    scfg = rps100m_config(load, steps=CUT_BASE_STEPS)
    groups = len(rps_lib._global_groups(make_exchange_plan(setup.p1, scfg)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    h = run_simulation(setup.loss_fn, None, lambda t: setup.batches[t], scfg,
                       init_params=setup.p1)
    launches = RG.ring_round.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != groups * CUT_BASE_STEPS:
        raise AssertionError(f"rps-100m cut: {launches} ring launches, want "
                             f"{groups} x {CUT_BASE_STEPS}")
    if not np.isfinite(h["loss"]).all():
        raise AssertionError(f"rps-100m cut: losses {h['loss']}")
    step_s = h["step_s"]
    out = {"layers": setup.model.cfg.n_layers, "groups": groups,
           "ring_launches": launches, "loss": h["loss"],
           "consensus": h["consensus"], "peak_memory_gb": peak,
           "first_step_ms": step_s[0] * 1e3,
           "step_ms": [t * 1e3 for t in step_s[1:]]}
    del h
    torch.cuda.empty_cache()
    return out


INT8 = rps_lib.wire_lib.make_codec("int8")
# the encoded ring round's variants in phase 18: (name, table, levels,
# accumulation dtype); "int8" re-encodes on every hop (the int8 wire's
# ring engine), "int8_enc" only decodes, "send_*" is the EF send on a
# linear wire summed in f32 or bf16
RING_ENC_VARIANTS = (("int8", "int8", INT8.levels, torch.float32),
                     ("int8_enc", "int8", 0, torch.float32),
                     ("send_f32", "send", 0, torch.float32),
                     ("send_bf16", "send", 0, torch.bfloat16))
# phase 21: the largest |loss(int8) - loss(f32)| allowed at any step,
# about ten times the largest gap measured on an H100 80GB HBM3 at 700 W
# (5.2e-4 with ef, 4.9e-4 with renorm; PERF.md)
INT8_LOSS_GAP = 5e-3
# phase 18's widths for the re-encoding kernel's plan (G, n, s, d): one
# block per row, then its cluster grows to 2, 4, 8 and 16 blocks, a block
# holds more than half an SM's shared memory, and a row wider than the
# largest cluster holds takes the cooperative wide path
# (kernels/ring.py::requant_plan)
RING_Q_WIDTHS = ((2, 4, 1, 4096), (2, 4, 1, 16384), (2, 4, 1, 32768),
                 (2, 16, 1, 65536),
                 (1, 16, 4, 131072), (1, 4, 1, 2_000_000),
                 (1, 3, 2, 3_145_729))
# phase 19's wide-path timing shape: rows past the widest cluster
RING_Q_WIDE = (1, 4, 4, 3_200_000)
# phase 20: wire_bench.py section 2 (replicated data, n = 8)
GAP_STUDY = dict(n=8, steps=200, seeds=(0, 1, 2), ps=(0.2, 0.3))
GAP_STUDY_SHAPES = {"w": (6, 4)}        # the 6 -> 4 least-squares model


def ring_enc_case(gen: torch.Generator, G: int, n: int, s: int, d: int,
                  dtype: torch.dtype, table: str, mode: str):
    """Random inputs of one encoded ring-round case on the card: the
    stack (normal, block 0 of group 0 all zero in every rank, so a whole
    row and its partials are zero), the masks and divisor of
    :func:`ring_case`, and the encoded table: the stack's int8 encode
    (stochastic, one scale per row) or a send in the payload dtype."""
    x, rs, ag, div = ring_case(gen, G, n, s, d, dtype, False, mode)
    x[0, :, 0] = 0
    if table == "int8":
        q, sc = INT8.encode(x, lead=2, gen=gen)
        return (x, rs, ag, div), {"enc": q, "scale": sc[..., 0]}
    send = (x.float() + 0.01 * torch.randn(x.shape, generator=gen,
                                           device="cuda")).to(dtype)
    return (x, rs, ag, div), {"enc": send, "scale": None}


def check_ring_enc(gen: torch.Generator, plans: dict) -> tuple:
    """Phase 18: the encoded variant against its plain version, bit for
    bit: the four variants x payload f32 / bf16 x the three modes x
    n in {1, 2, 4, 8, 16} x s in {1, n/2, n, 2n} x d in RING_DS, G = 2;
    the re-encoding kernel at RING_Q_WIDTHS (payload f32 / bf16 x the three
    modes), which must reach every cluster size of its plan, a block of
    more than half an SM's shared memory and the wide path; then every
    exchange group of the rps-paper-mlp and rps-100m plans at the int8
    wire (re-encoding), every mode. Returns (cases, the largest absolute
    difference)."""
    n_cases, worst = 0, 0.0

    def one(args, enc, mode, levels, acc, what):
        nonlocal n_cases, worst
        got = ops.ring_round(*args, mode=mode, rs_dtype=acc, levels=levels,
                             **enc)
        want = ops.ring_round(*args, mode=mode, rs_dtype=acc, levels=levels,
                              backend="ref", **enc)
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(_bits(got), _bits(want)):
            raise AssertionError(f"ring_round_enc {what} {mode}: not "
                                 f"bitwise (max abs err {err})")
        n_cases += 1

    for n in RING_NS:
        for s in sorted({1, max(n // 2, 1), n, 2 * n}):
            for d in RING_DS:
                for dt in (torch.float32, torch.bfloat16):
                    for name, table, levels, acc in RING_ENC_VARIANTS:
                        for mode in RG.MODES:
                            args, enc = ring_enc_case(gen, 2, n, s, d, dt,
                                                      table, mode)
                            one(args, enc, mode, levels, acc,
                                f"{name} n={n} s={s} d={d} {dt}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans_seen = set()
    for G, n, s, d in RING_Q_WIDTHS:
        cluster, chunk = RG.requant_plan(G * s, d, sms)
        plans_seen.add(cluster)
        if chunk > RG.HALF_CHUNK:
            plans_seen.add("one block per SM")
        for dt in (torch.float32, torch.bfloat16):
            for mode in RG.MODES:
                args, enc = ring_enc_case(gen, G, n, s, d, dt, "int8", mode)
                one(args, enc, mode, INT8.levels, torch.float32,
                    f"int8 n={n} s={s} d={d} {dt} (cluster {cluster})")
                del args, enc
    want = {0, 1, 2, 4, 8, 16, "one block per SM"}
    if plans_seen != want:
        raise AssertionError(f"phase 18's widths reach the plans "
                             f"{plans_seen}, want {want}")
    torch.cuda.empty_cache()
    for name, plan in plans.items():
        if name == "quickstart":
            continue
        for (blk, m, dt), idxs in rps_lib._global_groups(plan).items():
            for mode in RG.MODES:
                args, enc = ring_enc_case(gen, len(idxs), plan.n, plan.s,
                                          blk * m, getattr(torch, dt),
                                          "int8", mode)
                one(args, enc, mode, INT8.levels, torch.float32,
                    f"at {name}'s group {blk}x{m} {dt} (G={len(idxs)})")
                del args, enc
    torch.cuda.empty_cache()
    print(f"ring_round_enc: {n_cases} cases agree bit for bit with the "
          f"plain version", flush=True)
    return n_cases, worst


def wide_path(x, q, sc, rs, ag, div, levels: int):
    """The re-encoding kernel's cooperative wide path (its first design)
    at any shape, through the op itself (a yardstick: the wrapper takes it
    only for rows wider than the largest cluster)."""
    G, n, s, d = x.shape
    out = torch.empty_like(x)
    part = torch.empty((G, s, d), dtype=torch.float32, device=x.device)
    amax = torch.zeros((G * s, n), dtype=torch.int32, device=x.device)
    build.load_kernels().ring_round_enc(x, q, sc, rs, ag, div, out, part,
                                        amax, True, False, levels, 0, 0)
    return out


def time_ring_enc(gen: torch.Generator, shape: tuple,
                  full: bool = True) -> dict:
    """Phase 19: times of the int8 wire's ring round (re-encoding) on an
    f32 (G, n, s, d) group in model mode, beside the kernel's cooperative
    wide path at the same shape (its first design), its no-re-encode form,
    its plain version and the xla engine's int8 route (decode, einsum,
    divide, where); ``full=False`` times the kernel alone. The bound: the
    int8 table and scales read once, the output written once, the
    fallback blocks read where ag dropped them."""
    G, n, s, d = shape
    args, enc = ring_enc_case(gen, G, n, s, d, torch.float32, "int8",
                              "model")
    x, rs, ag, div = args
    q, sc = enc["enc"], enc["scale"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster, chunk = RG.requant_plan(G * s, d, sms)

    def kernel():
        return RG.ring_round_enc(x, q, sc, rs, ag, div, mode="model",
                                 levels=INT8.levels)

    def first_design():
        return wide_path(x, q, sc, rs, ag, div, INT8.levels)

    def no_requant():
        return RG.ring_round_enc(x, q, sc, rs, ag, div, mode="model")

    def plain():
        return ops.ring_round(*args, mode="model", levels=INT8.levels,
                              backend="ref", **enc)

    def xla_route():
        send = INT8.decode(q, sc[..., None])
        sums = torch.einsum("gij,gijd->gjd", rs.to(torch.float32), send)
        tilde = sums / div[..., None]
        return torch.where(ag[..., None], tilde[:, None], x)

    got = kernel()
    if not torch.equal(_bits(got), _bits(plain())):
        raise AssertionError(f"ring_round_enc {shape}: not bitwise at the "
                             f"timing shape")
    if cluster and not torch.equal(_bits(got), _bits(first_design())):
        raise AssertionError(f"ring_round_enc {shape}: the cluster and "
                             f"wide paths differ")
    err_xla = (xla_route() - got).abs().max().item() if full else None
    del got
    torch.cuda.empty_cache()
    # the int8 table, the output, the fallback where ag dropped a block,
    # the masks, the divisor; per element a decode, a gate and an add, per
    # partial element and hop after the first a divide, a round, a multiply
    flops, nbytes = kernel_cost("ring_round_enc", x, q, sc, rs, ag, div,
                                levels=INT8.levels)
    bound_s, bound_by = kernel_bound("ring_round_enc", flops, nbytes)
    big = x.numel() * x.element_size() > 2 ** 30
    calls = 20 if big else 100
    out = {"shape": list(shape), "cluster": cluster, "chunk": chunk,
           "ms": event_ms(kernel, calls),
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "bytes": nbytes,
           # what the first design moves besides: the partial's f32 round
           # trip per hop through its scratch row
           "first_design_bytes": nbytes + 8 * (n - 1) * G * s * d}
    if full:
        out.update({"first_design_ms": event_ms(first_design, calls),
                    "no_requant_ms": event_ms(no_requant, calls),
                    "plain_ms": event_ms(plain, 2, warm=1),
                    "xla_route_ms": event_ms(xla_route, 5 if big else 20),
                    "xla_route_max_abs_diff": err_xla,
                    "ms_again": event_ms(kernel, calls)})
    print(f"ring_round_enc {tuple(shape)} (cluster {cluster}): "
          f"{out['ms']:.4f} ms, bound {out['bound_ms']:.4f} ms"
          + (f", first design {out['first_design_ms']:.4f} ms" if full
             else ""), flush=True)
    return out


def ef_gap_closure(study=GAP_STUDY) -> dict:
    """Phase 20: benchmarks/wire_bench.py section 2 on the port and the
    card. Replicated worker data (so with an f32 wire the drops cost
    nothing and the gap to the reliable f32 run is the codec's), n = 8, a
    6 -> 4 least-squares model, rps_model, engine "auto" (the xla engine,
    the masked-average kernel), 2 buckets, lr 0.2, warm-up 5, 200 steps,
    3 seeds; at p in {0.2, 0.3} the ef recovery must close at least half
    of the bf16 and int8 wires' gap: closed = (loss(renorm) - loss(ef)) /
    (loss(renorm) - loss(reliable f32))."""
    n, steps, seeds = study["n"], study["steps"], study["seeds"]
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(16, 6)).astype(np.float32)
    xs = torch.from_numpy(np.broadcast_to(x1, (n,) + x1.shape).copy()
                          ).cuda()
    w_true = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)
                              ).cuda()
    ys = xs @ w_true

    def init_fn(gen):
        return {k: torch.randn(shape, generator=gen, device="cuda") * 0.1
                for k, shape in GAP_STUDY_SHAPES.items()}

    def loss_fn(p, b):
        x, y = b
        return torch.mean((x @ p["w"] - y) ** 2)

    def final(wire, recovery, p):
        out = []
        for seed in seeds:
            h = run_simulation(loss_fn, init_fn, lambda t: (xs, ys),
                               SimulatorConfig(
                                   n_workers=n, drop_rate=p,
                                   aggregator="rps_model", steps=steps,
                                   lr=0.2, warmup=5, n_buckets=2, seed=seed,
                                   wire=wire, recovery=recovery))
            out.append(h["final_loss"])
        return float(np.mean(out))

    t0 = time.perf_counter()
    reset_counts()
    rel = final("f32", "renorm", 0.0)
    res = {"reliable_f32": rel, "closure": {}}
    for p in study["ps"]:
        for wire in ("bf16", "int8"):
            ln, le = final(wire, "renorm", p), final(wire, "ef", p)
            gap = ln - rel
            closed = (ln - le) / gap if gap > 1e-9 else 1.0
            res["closure"][f"{wire}_p{p}"] = {
                "renorm": ln, "ef": le, "gap": gap, "closed_frac": closed}
    res["ef_gap_closure_min"] = min(c["closed_frac"]
                                    for c in res["closure"].values())
    res["masked_avg_launches"] = K.masked_avg_grid.launches
    res["wall_s"] = time.perf_counter() - t0
    if not res["ef_gap_closure_min"] >= 0.5:
        raise AssertionError(f"ef closes less than half the wire gap: "
                             f"{res['closure']}")
    if res["masked_avg_launches"] == 0:
        raise AssertionError("gap study: the masked-average kernel never "
                             "launched")
    return res


def exchange_card_vs_cpu(params, ef_state, scfg, seed: int = 0) -> int:
    """Phase 21's check of the whole exchange around the kernel: one
    rps_exchange_global of rps-100m's embedding and first layer at full
    width (the stacked replicas ``params`` and, under ef, their residual)
    on the card through the kernels and on the CPU through their plain
    versions (which the tests hold against the JAX package), with the
    same masks (drawn on the CPU) and rounding noise (drawn once on the
    card, a generator per group, and copied to the CPU: a CPU generator
    draws serially). Every output, and the new residual, must agree bit
    for bit. Returns the elements compared."""
    def part(tree):
        return {"embed": tree["embed"],
                "layers": tree_lib.map(lambda x: x[:, :1].contiguous(),
                                       tree["layers"])}

    sub = part(params)
    ef = part(ef_state) if ef_state is not None else None
    n = scfg.n_workers
    plan = make_exchange_plan(tree_lib.map(lambda x: x[0], sub), scfg)
    cpu = torch.Generator().manual_seed(seed)
    masks = rps_lib.sample_masks(cpu, n, scfg.drop_rate, plan.s,
                                 n_buckets=plan.n_buckets)

    uniforms = {}

    def exchange(device):
        def noise(g_idx, shape):
            if g_idx not in uniforms:
                g = torch.Generator(device="cuda").manual_seed(
                    seed + 1 + g_idx)
                uniforms[g_idx] = torch.rand(shape, generator=g,
                                             device="cuda")
            return uniforms[g_idx].to(device)

        def on(tree):
            return None if tree is None else \
                tree_lib.map(lambda x: x.to(device), tree)

        out = rps_lib.rps_exchange_global(
            on(sub), None, scfg.drop_rate, n, mode="model",
            masks=tuple(m.to(device) for m in masks), plan=plan,
            engine="ring", wire="int8", recovery=scfg.recovery,
            ef_state=on(ef), wire_noise=noise)
        return tree_lib.leaves(out)

    card = exchange("cuda")
    host = exchange("cpu")
    del uniforms
    for a, b in zip(card, host):
        if not torch.equal(_bits(a.cpu()), _bits(b)):
            raise AssertionError(f"rps-100m int8 {scfg.recovery}: the "
                                 f"exchange on the card differs from the "
                                 f"plain one on the CPU")
    return sum(x.numel() for x in host)


def rps100m_int8(setup: Rps100mSetup, f32_loss: list, steps: int = 8,
                 load=RPS_100M_LOAD) -> dict:
    """Phase 21: rps-100m at phase 17's load with the int8 wire on the
    ring engine, once with renorm and once with ef, from ``setup``'s
    initial weights (the cut's), batches and (one seed, the masks' own
    generator) masks. Every group runs the encoded ring round
    (re-encoding): one launch per group and step and none of the linear
    one; each step's loss is finite and within INT8_LOSS_GAP of the f32
    loss at that step (``f32_loss``: the cut's baseline); the run's last
    replicas exchange alike on the card and the CPU
    (:func:`exchange_card_vs_cpu`)."""
    n = load["n"]
    out = {"layers": setup.model.cfg.n_layers}
    for recovery in ("renorm", "ef"):
        scfg = rps100m_config(load, steps=steps, wire="int8",
                              recovery=recovery)
        groups = len(rps_lib._global_groups(make_exchange_plan(setup.p1,
                                                               scfg)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h = run_simulation(setup.loss_fn, None,
                           lambda t: setup.batches[t], scfg,
                           init_params=setup.p1)
        launches = RG.ring_round_enc.launches
        requant = RG.ring_round_enc.requant_launches
        linear = RG.ring_round.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = h["loss"]
        gaps = [abs(a - b) for a, b in zip(loss, f32_loss)]
        if launches != groups * steps or linear != 0:
            raise AssertionError(f"rps-100m int8 {recovery}: {launches} "
                                 f"encoded and {linear} linear ring "
                                 f"launches, want {groups} x {steps} and 0")
        if requant != launches:
            raise AssertionError(f"rps-100m int8 {recovery}: {requant} of "
                                 f"{launches} encoded launches re-encode")
        if not (all(np.isfinite(loss)) and max(gaps) <= INT8_LOSS_GAP):
            raise AssertionError(f"rps-100m int8 {recovery}: losses {loss} "
                                 f"against f32 {f32_loss[:steps]}")
        compared = exchange_card_vs_cpu(h["params"], h["ef_state"], scfg)
        step_s = h["step_s"]
        later = float(np.mean(step_s[1:]))
        out[recovery] = {
            "ring_enc_launches": launches,
            "ring_requant_launches": requant, "groups": groups,
            "first_step_ms": step_s[0] * 1e3,
            "step_ms": [t * 1e3 for t in step_s[1:]],
            "tokens_per_s": n * load["batch"] * load["seq"] / later,
            "peak_memory_gb": peak, "loss": loss,
            "f32_loss": f32_loss[:steps], "max_loss_gap": max(gaps),
            "consensus": h["consensus"],
            "exchange_bitwise_card_vs_cpu": compared}
        del h
        torch.cuda.empty_cache()
    return out


# phase 22: benchmarks/channels_bench.py's recipe
CHANNEL_P = 0.1                # every family at this effective_p
# the largest |realised off-owner drop fraction - effective_p| allowed:
# ~5 sigma at the 16-burst channel (240 links, mean sojourn 16, 150 steps)
CHANNEL_DRIFT = 0.04
# phase 23: benchmarks/state_bench.py section 3
STATE_STUDY = dict(n=4, steps=200, seeds=(0, 1, 2), ps=(0.1, 0.2, 0.3))
# phase 24: rps-100m under every state pack
PACK_LOAD = dict(optimizer="adam", lr=3e-4, warmup=20, steps=4,
                 channel="ge:p_bad=1.0,burst=8,p=0.1")
PACK_LOSS_GAP = 1e-2           # |loss(bf16 / i8 pack) - loss(f32 pack)|


class CountingChannel(channels_lib.Channel):
    """Phase 22's probe: a channel that hands on another's masks and
    counts, on the device, the off-owner packets they drop."""

    def __init__(self, inner: channels_lib.Channel):
        super().__init__(inner.n, inner.s)
        self.inner, self.name = inner, inner.name
        self.off = ~rps_lib.owner_mask(inner.n, inner.s)
        self.dropped = None
        self.offered = 0
        self.draws = 0

    def init_state(self, gen=None):
        return self.inner.init_state(gen)

    def _count(self, rs, ag):
        off = self.off.to(rs.device)
        d = (~rs & off).sum() + (~ag & off).sum()
        self.dropped = d if self.dropped is None else self.dropped + d
        self.offered += 2 * int(off.sum()) * (rs.numel() // off.numel())
        self.draws += 1
        return rs, ag

    def sample(self, gen, state=None):
        rs, ag, state = self.inner.sample(gen, state)
        return self._count(rs, ag) + (state,)

    def sample_packets(self, gen, state=None, n_buckets=1):
        rs, ag, state = self.inner.sample_packets(gen, state, n_buckets)
        return self._count(rs, ag) + (state,)

    def effective_p(self) -> float:
        return self.inner.effective_p()

    def expected_drop(self) -> float:
        """What the run's draws should drop: effective_p, or for a trace
        the mean of its link drop rates over the periods it replayed."""
        ch = self.inner
        if not isinstance(ch, channels_lib.TraceChannel):
            return ch.effective_p()
        periods = np.arange(self.draws) % ch.n_periods
        off = ~np.eye(ch.n, dtype=bool)
        return float(ch.p_trace.numpy()[periods][:, off].mean())

    def realised_drop(self) -> float:
        return float(self.dropped) / self.offered

    def __repr__(self) -> str:
        return repr(self.inner)


def _bisect(f, lo, hi, target, iters=8):
    """channels_bench.py's bisection: the x with f(x) ~ target, f
    increasing."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if f(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def channel_families(n: int = 16) -> list:
    """channels_bench.py's six families, each at effective_p CHANNEL_P
    (the deadline and the trace by its bisection)."""
    base, jitter, q, mult = 2.0, 2.0, 0.1, 4.0

    def deadline(d):
        return channels_lib.DeadlineChannel(
            n, deadline_ms=d, base_ms=base, jitter_ms=jitter,
            straggler_frac=q, straggler_mult=mult)

    d = _bisect(lambda x: -deadline(x).effective_p(), base * mult, 40.0,
                -CHANNEL_P)
    lam, cfg = 8000.0, netsim.NetConfig(sim_s=1.0)
    prio = _bisect(lambda x: channels_lib.TraceChannel(
        n, netsim.export_trace(lam, x, cfg)).effective_p(), 0.0, 1.0,
        CHANNEL_P, iters=6)
    return [
        ("bernoulli", channels_lib.BernoulliChannel(n, CHANNEL_P)),
        ("ge_burst4", channels_lib.GilbertElliottChannel(
            n, p_bad=1.0, burst=4.0, p=CHANNEL_P)),
        ("ge_burst16", channels_lib.GilbertElliottChannel(
            n, p_bad=1.0, burst=16.0, p=CHANNEL_P)),
        ("hetero_pods", channels_lib.HeterogeneousChannel.pods(
            n, n_pods=4, p_intra=0.0, p_cross=CHANNEL_P * 15.0 / 12.0)),
        ("deadline", deadline(d)),
        ("trace", channels_lib.TraceChannel(
            n, netsim.export_trace(lam, prio, cfg)))]


def channels_bench(steps: int = 150, n: int = 16) -> dict:
    """Phase 22: benchmarks/channels_bench.py on the port's ring engine.
    Each family's run counts its masks' off-owner drops and its ring
    launches (one per exchange group and step)."""
    task = TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    batch_fn = make_worker_streams(task, n, 32)
    t0 = time.perf_counter()
    families = channel_families(n)
    setup_s = time.perf_counter() - t0
    groups = len(rps_lib._global_groups(make_exchange_plan(
        {k: torch.empty(v, device="meta")
         for k, v in QUICKSTART_SHAPES.items()},
        SimulatorConfig(n_workers=n))))
    runs = [(name, ch, "rps_model") for name, ch in families]
    runs.append(("ge_burst16_grad", families[2][1], "rps_grad"))
    out = {"setup_s": setup_s, "groups": groups}
    for name, ch, agg in runs:
        probe = CountingChannel(ch)
        scfg = SimulatorConfig(n_workers=n, aggregator=agg, lr=0.2,
                               warmup=10, steps=steps, eval_every=steps - 1,
                               channel=probe, engine="ring")
        reset_counts()
        h = run_simulation(teacher_loss, teacher_init, batch_fn, scfg)
        launches = RG.ring_round.launches
        realised, expected = probe.realised_drop(), probe.expected_drop()
        out[name] = {"effective_p": ch.effective_p(),
                     "final_loss": h["final_loss"],
                     "consensus": h["consensus"][-1],
                     "realised_drop": realised, "expected_drop": expected,
                     "ring_launches": launches,
                     "wall_s": sum(h["step_s"])}
        if launches != groups * steps:
            raise AssertionError(f"channels {name}: {launches} ring "
                                 f"launches, want {groups} x {steps}")
        if abs(realised - expected) > CHANNEL_DRIFT:
            raise AssertionError(f"channels {name}: realised drop fraction "
                                 f"{realised} against {expected}")
        print(f"channels {name}: eff_p {ch.effective_p():.4f} final loss "
              f"{h['final_loss']:.4f} realised drop {realised:.4f}",
              flush=True)
    base = out["bernoulli"]["final_loss"]
    for name, _, _ in runs[:-1]:
        if not out[name]["final_loss"] < base * 1.35 + 0.05:
            raise AssertionError(f"channels {name} diverged at matched "
                                 f"p={CHANNEL_P}: {out[name]}")
    if not out["ge_burst16_grad"]["final_loss"] \
            > out["ge_burst16"]["final_loss"]:
        raise AssertionError("channels: naive gradient averaging did not "
                             "degrade on the bursty channel")
    return out


def packed_convergence(study=STATE_STUDY) -> dict:
    """Phase 23: benchmarks/state_bench.py section 3 on the port and the
    card: the i8 pack's final-loss gap (against the f32 pack, f32 wire)
    must not exceed the int8 wire's (against the f32 wire, f32 pack) +
    0.02 at any p. Heterogeneous workers (a least-squares task per seed),
    n = 4, Adam, ef, 2 buckets, lr 0.05, warm-up 5, engine auto."""
    n, steps, seeds = study["n"], study["steps"], study["seeds"]

    def task(seed):
        rng = np.random.default_rng(seed)
        xs = torch.from_numpy(rng.normal(size=(n, 16, 6)).astype(
            np.float32)).cuda()
        w_true = torch.from_numpy(rng.normal(size=(6, 4)).astype(
            np.float32)).cuda()
        return xs, xs @ w_true

    def init_fn(gen):
        return {"w": torch.randn((6, 4), generator=gen, device="cuda") * 0.1}

    def loss_fn(p, b):
        x, y = b
        return torch.mean((x @ p["w"] - y) ** 2)

    runs = 0

    def final(wire, pack, p):
        nonlocal runs
        out = []
        for seed in seeds:
            batch = task(seed)
            h = run_simulation(loss_fn, init_fn, lambda t: batch,
                               SimulatorConfig(
                                   n_workers=n, drop_rate=p,
                                   aggregator="rps_model", steps=steps,
                                   lr=0.05, warmup=5, n_buckets=2, seed=seed,
                                   optimizer="adam", state_pack=pack,
                                   wire=wire, recovery="ef"))
            out.append(h["final_loss"])
            runs += 1
        return float(np.mean(out))

    groups = len(rps_lib._global_groups(make_exchange_plan(
        {"w": torch.empty((6, 4), device="meta")},
        SimulatorConfig(n_workers=n, n_buckets=2))))
    with open(Path(__file__).resolve().parent / "benchmarks"
              / "BENCH_state.json") as f:
        cpu_rows = {r["p"]: r for r in json.load(f)["convergence"]["rows"]}
    t0 = time.perf_counter()
    reset_counts()
    rows = []
    for p in study["ps"]:
        base = final("f32", "f32", p)
        wire8 = final("int8", "f32", p)
        pack8 = final("f32", "i8", p)
        both8 = final("int8", "i8", p)
        row = {"p": p, "loss_f32wire_f32pack": base,
               "loss_int8wire_f32pack": wire8,
               "loss_f32wire_i8pack": pack8, "loss_int8wire_i8pack": both8,
               "wire_gap": wire8 - base, "pack_gap": pack8 - base}
        cpu = cpu_rows.get(p, {})
        print(f"state_bench p={p}: card wire_gap {row['wire_gap']:.6e} "
              f"pack_gap {row['pack_gap']:.6e} | the reference's CPU run "
              f"(BENCH_state.json) wire_gap {cpu.get('wire_gap')} pack_gap "
              f"{cpu.get('pack_gap')}", flush=True)
        rows.append({"card": row, "reference_cpu": cpu})
    launches = K.masked_avg_grid.launches
    res = {"rows": rows, "runs": runs, "masked_avg_launches": launches,
           "wall_s": time.perf_counter() - t0}
    if launches != groups * steps * runs:
        raise AssertionError(f"state bench: {launches} masked-average "
                             f"launches, want {groups} x {steps} x {runs}")
    for r in rows:
        row = r["card"]
        if not row["pack_gap"] <= row["wire_gap"] + 0.02:
            raise AssertionError(f"state bench: the i8 pack costs more than "
                                 f"the int8 wire: {row}")
    return res


def _leaf_names(tree, prefix="") -> list:
    """Leaf paths in tree_lib's flatten order."""
    if isinstance(tree, dict):
        return [name for k in sorted(tree)
                for name in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [name for i, v in enumerate(tree)
                for name in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def packed_adam_card_vs_cpu(params, opt_state, lr: float,
                            seed: int = 0) -> dict:
    """Phase 24's check of the packed optimizer: one i8-pack Adam update
    of the largest leaf of rps-100m's stacked replicas (its state as the
    run left it) on the card and on the CPU, with the same gradients and
    rounding uniforms (drawn on the card and copied to the CPU): the new
    params, the int8 payload, its scales and the bf16 m must agree bit
    for bit."""
    leaves = tree_lib.leaves(params)
    i = max(range(len(leaves)), key=lambda j: leaves[j].numel())
    m = statepack.leaf_reps(opt_state["m"], "bf16")[i][0]
    q, sc = statepack.leaf_reps(opt_state["v"], "i8")[i]
    p = leaves[i]
    draw = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(p.shape, generator=draw, device="cuda") * 1e-3
    u = torch.rand(p.shape, generator=draw, device="cuda")

    def update(device):
        opt = make_optimizer("adam", state_pack="i8")
        x = {"x": p.to(device, copy=True)}
        st = {"m": {"x": m.to(device, copy=True)},
              "v": {"q": {"x": q.to(device, copy=True)},
                    "scale": {"x": sc.to(device, copy=True)}},
              "t": opt_state["t"].clone()}
        opt.update({"x": g.to(device)}, st, x, lr,
                   noise=lambda which, j, shape: u.to(device))
        return [x["x"], st["m"]["x"], st["v"]["q"]["x"],
                st["v"]["scale"]["x"]]

    t0 = time.perf_counter()
    card = [y.cpu() for y in update("cuda")]
    g, u = g.cpu(), u.cpu()
    torch.cuda.empty_cache()
    host = update("cpu")
    names = ("params", "m", "q", "scale")
    for name, a, b in zip(names, card, host):
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"packed Adam: the {name} of the update on "
                                 f"the card differs from the CPU's")
    return {"leaf": _leaf_names(params)[i], "shape": list(p.shape),
            "elements": p.numel(), "bitwise": list(names),
            "wall_s": time.perf_counter() - t0}


def rps100m_packs(setup: Rps100mSetup, load=RPS_100M_LOAD) -> dict:
    """Phase 24: rps-100m at phase 17's load with Adam on the
    Gilbert-Elliott channel under each state pack, from ``setup``'s
    weights (the cut's) and batches (the masks the same across packs: one
    seed). Peak memory from a reset after the earlier phases' memory is
    freed; the optimizer's bytes from the history's state_bytes."""
    n, steps = load["n"], PACK_LOAD["steps"]
    out = {"layers": setup.model.cfg.n_layers}
    kept = None
    for pack in ("f32", "bf16", "i8"):
        scfg = rps100m_config(load, state_pack=pack, **PACK_LOAD)
        groups = len(rps_lib._global_groups(make_exchange_plan(setup.p1,
                                                               scfg)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h = run_simulation(setup.loss_fn, None,
                           lambda t: setup.batches[t], scfg,
                           init_params=setup.p1)
        peak = torch.cuda.max_memory_allocated()
        launches = RG.ring_round.launches
        sb = h["state_bytes"]
        opt_bytes = sum(v for k, v in sb.items() if k.startswith("opt_"))
        step_s = h["step_s"]
        out[pack] = {"peak_memory_gb": peak / 1e9,
                     "allocated_at_start_gb": start / 1e9,
                     "state_bytes": sb, "opt_bytes": opt_bytes,
                     "first_step_ms": step_s[0] * 1e3,
                     "step_ms": [t * 1e3 for t in step_s[1:]],
                     "tokens_per_s": n * load["batch"] * load["seq"]
                     / float(np.mean(step_s[1:])),
                     "loss": h["loss"], "consensus": h["consensus"],
                     "ring_launches": launches, "channel": h["channel"]}
        print(f"rps-100m adam {pack}: peak {peak / 1e9:.3f} GB (start "
              f"{start / 1e9:.3f}), optimizer {opt_bytes / 1e9:.3f} GB, "
              f"losses {h['loss']}", flush=True)
        if launches != groups * steps:
            raise AssertionError(f"rps-100m adam {pack}: {launches} ring "
                                 f"launches, want {groups} x {steps}")
        if pack == "i8":
            kept = (h["params"], h["state"]["opt_state"])
        del h
    ratio = out["f32"]["opt_bytes"] / out["i8"]["opt_bytes"]
    cut = 1.0 - out["i8"]["peak_memory_gb"] / out["f32"]["peak_memory_gb"]
    out["opt_bytes_ratio_f32_over_i8"] = ratio
    out["peak_memory_reduction_i8"] = cut
    gaps = {pk: max(abs(a - b) for a, b in zip(out[pk]["loss"],
                                               out["f32"]["loss"]))
            for pk in ("bf16", "i8")}
    out["max_loss_gap"] = gaps
    if not ratio >= 2.0:
        raise AssertionError(f"state packs: optimizer bytes f32 / i8 = "
                             f"{ratio} < 2")
    if not cut >= 0.10:
        raise AssertionError(f"state packs: the i8 pack's peak is only "
                             f"{cut:.3%} below the f32 pack's")
    if not all(np.isfinite(out[pk]["loss"]).all() for pk in
               ("f32", "bf16", "i8")) or max(gaps.values()) > PACK_LOSS_GAP:
        raise AssertionError(f"state packs: losses not finite or apart: "
                             f"{gaps}")
    # the learning rate of the step after the run's last
    lr = PACK_LOAD["lr"] * min(1.0, (steps + 1) / PACK_LOAD["warmup"])
    out["update_card_vs_cpu"] = packed_adam_card_vs_cpu(*kept, lr)
    del kept
    torch.cuda.empty_cache()
    return out


# ---- phases 25-28: the Byzantine axis and the async schedule --------------

# phase 25a: each kind's attack on the exchange (a fifth of the links and
# the lowest quarter of the workers corrupt), card against CPU
BYZ_KINDS = ("bitflip", "scale", "signflip", "collude")
BYZ_ATTACK = "frac=0.2,byzantine_frac=0.25"
BYZ_WIRES = ("f32", "bf16", "int8")
BYZ_P = 0.1
ROBUST_RECOVERIES = ("median", "trimmed:beta=0.4", "clip")
# phase 25b: benchmarks/robust_bench.py sections 1-4, uncut
ROBUST_STUDY = dict(n=8, steps=200, lr=0.2, warmup=5, n_buckets=2, seed=0,
                    attack="collude:gamma=10", byzs=(0.0, 0.25),
                    ps=(0.0, 0.2),
                    recoveries=("renorm", "median", "trimmed:beta=0.4",
                                "clip"),
                    robust=("median", "trimmed:beta=0.4"), target=1.0,
                    draw_p=0.2, draw_seeds=tuple(range(8)))
CORRUPT_FRAC_TOL = 0.03        # |mean corrupt_frac - expected_frac|
# phase 26: benchmarks/async_bench.py section 2, uncut
ASYNC_STUDY = dict(n=8, steps=300, n_buckets=4, compute_ms=8.0,
                   deadline_ms=10.0, lr=0.2, warmup=5, seed=0,
                   family=((0.2, 4.0), (0.3, 4.0), (0.3, 8.0), (0.4, 8.0)))
ASYNC_RING_TOL = 1e-4          # |loss(ring) - loss(xla)| at every step
# phase 27: rps-100m under the colluding attack
ATTACK_LOAD = dict(corruption="collude:gamma=10", byzantine_frac=0.25,
                   steps=4)
ATTACK_LOSS_GAP = 1e-2         # robust loss against phase 17's, each step
ATTACK_PEAK_GB = 12.0          # robust peak above phase 17's, at most
# phase 28: rps-100m async on the straggler deadline channel
ASYNC_LOAD = dict(n_buckets=8, steps=4, compute_ms=8.0,
                  channel="deadline:deadline_ms=10,base_ms=1,jitter_ms=3,"
                          "straggler_frac=0.3,straggler_mult=4")
# the reference's CPU rows (benchmarks/BENCH_robust.json,
# benchmarks/BENCH_async.json), printed beside the card's
BENCH_DIR = Path(__file__).resolve().parent / "benchmarks"


def _bench_json(name: str) -> dict:
    with open(BENCH_DIR / name) as f:
        return json.load(f)


def _same_values(a: torch.Tensor, b: torch.Tensor) -> int:
    """Raises unless ``a`` and ``b`` hold the same values, NaN equal to
    NaN; returns how many elements differ in their bits all the same: a
    sign of zero (the sort may order −0 and +0 either way) or a NaN's
    payload (the card's canonical NaN against the CPU's). Compared on
    ``a``'s device."""
    b = b.to(a.device)
    same = (a == b) | (a.isnan() & b.isnan())
    if not bool(same.all()):
        raise AssertionError(f"{int((~same).sum())} of {a.numel()} values "
                             f"differ")
    return int((_bits(a) != _bits(b)).sum())


def _avg_bound(blocks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The probe that takes the masked average's place in a bound run:
    per block the classical bound of two summation orders of the
    average, 2n·u·Σ_i|m_i·x_i| / c (u = 2⁻²⁴, in f64, 64 Mi elements of
    the stack at a time), plus one ulp of the output's own rounding (f32,
    or the bf16 send's) times |average|; inf where the sum may overflow.
    (B, n, d), (B, n) -> (B, d) in ``blocks.dtype``."""
    B, n, d = blocks.shape
    ulp = 2.0 ** -23 if blocks.dtype == torch.float32 else 2.0 ** -7
    out = torch.empty((B, d), dtype=blocks.dtype, device=blocks.device)
    step = max(1, 2 ** 26 // max(n * d, 1))
    for a in range(0, B, step):
        x, mk = blocks[a:a + step], mask[a:a + step]
        m = (mk != 0)[..., None]
        c = m.sum(1).clamp_min(1).double()
        absum = torch.where(m, x.double().abs(), 0.0).sum(1) / c
        avg = ops.masked_avg_grid(x, mk, backend="ref").double()
        bound = 2 * n * 2.0 ** -24 * absum + ulp * avg.abs()
        out[a:a + step] = torch.where(absum > 3.4e38 / (2 * n),
                                      float("inf"), bound)
    return out


def _within_bound(a: torch.Tensor, b: torch.Tensor,
                  bound: torch.Tensor) -> float:
    """Raises unless ``a`` and ``b`` hold the same values (NaN equal to
    NaN) or, both finite, differ by at most |bound| (widened by 2⁻⁷ for
    the bound's own rounding to the output dtype), bound inf allowing
    anything; returns the largest |a − b| / |bound| where they differ."""
    b, bound = b.to(a.device), bound.to(a.device)
    diff = (a.double() - b.double()).abs()
    lim = bound.double().abs()
    same = (a == b) | (a.isnan() & b.isnan())
    both = torch.isfinite(a) & torch.isfinite(b)
    ok = same | torch.isinf(lim) | (both & (diff <= lim * (1 + 2.0 ** -7)))
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} of {a.numel()} values "
                             f"beyond the summation bound")
    sel = both & ~same & torch.isfinite(lim)
    return float((diff[sel] / lim[sel]).max()) if bool(sel.any()) else 0.0


class _Swapped:
    """Puts ``fn`` in the place of ``module.name`` while inside."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.inner = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        return False


def _depth1(tree: dict) -> dict:
    """rps-100m's first layer (the stacked layers' leading dim cut to 1),
    without the embedding: the plan's exchange groups at 1/12 of their
    width."""
    return {"layers": tree_lib.map(lambda x: x[:1], tree["layers"])}


def _int_stack(tree_meta, n: int, seed: int, device: str = "cpu"):
    """Integer-valued [-8, 8] stacked worker replicas of a per-worker
    meta tree, made on ``device`` (every sum of them is exact)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_lib.map(
        lambda x: torch.randint(-8, 9, (n,) + tuple(x.shape), generator=gen,
                                device=device).to(x.dtype), tree_meta)


def _draw_hook(seed: int, fn):
    """A per-group draw hook ``(g_idx, shape, device) -> tensor`` from
    generators on the card seeded by (seed, g_idx), so two runs see the
    same draws; ``fn(gen, shape)`` draws on the generator's device."""
    def hook(g_idx, shape, device):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + g_idx)
        return fn(g, shape).to(device)
    return hook


def _on(tree, device):
    return tree_lib.map(lambda x: x.to(device), tree)


def _uniforms(g: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def _byz_exchange(x, masks, cm, plan, corruption, engine, recovery, seed,
                  device):
    """One rps_exchange_global of ``x`` on ``device`` with the masks and
    corrupt masks given and the int8 uniforms and bitflip bits drawn by
    group on the card (the CPU's generator would take longer than the
    exchange)."""
    noise = _draw_hook(seed, _uniforms)
    bits = _draw_hook(seed + 1, channels_lib.corruption.random_bits)
    out = rps_lib.rps_exchange_global(
        _on(x, device), None, BYZ_P, plan.n, mode="model",
        masks=tuple(m.to(device) for m in masks), plan=plan, engine=engine,
        recovery=recovery, corruption=corruption,
        corrupt_masks=None if cm is None else cm.to(device),
        wire_noise=lambda g, s: noise(g, s, device),
        corrupt_bits=lambda g, s: bits(g, s, device))
    return tree_lib.leaves(out)


def _xla_sends(x, masks, cm, plan, corruption, seed) -> int:
    """The xla engine's sends where they are not integers (the bitflip
    kind; the int8 wire's decoded rows on an f32 payload), group by group
    on the card and the CPU: the same values (:func:`_same_values`: a
    bf16 payload rounds the ±FLT_MAX clamp to ±inf, and the int8 wire's
    scale of such a row is inf, so NaNs appear). Returns the elements
    whose bits differ."""
    noise = _draw_hook(seed, _uniforms)
    bits = _draw_hook(seed + 1, channels_lib.corruption.random_bits)
    codec = rps_lib.wire_lib.make_codec(plan.wire)
    tables = plan.gather(x, lead=1)
    differ = 0
    n, s = plan.n, plan.s
    for g_idx, ((blk, m, _dt), idxs) in \
            enumerate(rps_lib._global_groups(plan).items()):
        G, d = len(idxs), blk * m
        stack = rps_lib._group_stack(tables, idxs, n, s, d)
        cm_g = torch.stack([cm[j] for j in idxs]) if cm.dim() == 3 \
            else cm.expand(G, n, s)
        shape = tuple(stack.shape)
        sends = {}
        for dev in ("cuda", "cpu"):
            offer = corruption.apply(stack.to(dev), cm_g.to(dev)[..., None],
                                     bits=bits(g_idx, shape, dev))
            if codec.quantized:
                enc, sc = codec.encode(offer, lead=2,
                                       uniforms=noise(g_idx, shape, dev))
                sends[dev] = codec.decode(enc, sc).to(stack.dtype)
            else:
                sends[dev] = codec.to_wire(offer)
        try:
            differ += _same_values(sends["cuda"], sends["cpu"])
        except AssertionError as e:
            raise AssertionError(f"{corruption.kind} {plan.wire}: the send "
                                 f"differs on the card: {e}") from None
        del sends
    return differ


def byzantine_exchanges(trees: dict) -> dict:
    """Phase 25a: every corruption kind x wire x engine, renorm, and the
    robust recoveries on the xla engine, at the rps-paper-mlp plan (n =
    16, whole) and rps-100m's (its first layer), on integer-valued
    replicas: the exchange on the card through the kernels (the ring
    engine's corrupted offer on the encoded variant) against the plain
    versions on the CPU, with the same masks, corrupt masks, int8
    uniforms and bitflip bits. The same values (:func:`_same_values`:
    NaN equal to NaN, and the elements whose bits differ counted), but
    for the xla engine under bitflip or on the int8 wire, whose sends are
    not integers (the sends alike, :func:`_xla_sends`; the exchange's
    output within the bound of two summation orders of the masked
    average, from a bound run on the CPU with :func:`_avg_bound` in the
    average's place), and clip (within 1e-6 of the largest contribution
    and an ulp of the output's rounding; its clip factors are not
    integers). Then every kind x wire x engine at rps-100m's whole plan
    on the card (:func:`byzantine_full`)."""
    n = 16
    out = {"cases": 0, "equal_elems": 0, "bits_differ": 0,
           "xla_worst_bound_ratio": 0.0}
    cases = {"rps-paper-mlp": trees["rps-paper-mlp"],
             "rps-100m-layer0": _depth1(trees["rps-100m"])}
    for c_idx, (name, meta) in enumerate(cases.items()):
        x = _int_stack(meta, n, seed=25 + c_idx)
        t0 = time.perf_counter()
        combos = [(k, w, e, "renorm") for k in BYZ_KINDS for w in BYZ_WIRES
                  for e in ("xla", "ring")]
        combos += [("collude", "f32", "xla", r) for r in ROBUST_RECOVERIES]
        for i, (kind, wire, engine, recovery) in enumerate(combos):
            seed = 1000 * c_idx + i
            plan = make_exchange_plan(meta, SimulatorConfig(
                n_workers=n, wire=wire, engine=engine, recovery=recovery))
            cpu = torch.Generator().manual_seed(seed)
            nb = plan.n_buckets if plan.per_bucket_masks else None
            masks = rps_lib.sample_masks(cpu, n, BYZ_P, plan.s, nb)
            attack = BYZ_ATTACK if recovery == "renorm" else \
                "gamma=10,byzantine_frac=0.25"
            corr = channels_lib.make_corruption(f"{kind}:{attack}")
            cm = corr.sample(cpu, n, plan.s, nb)
            reset_counts()
            card = _byz_exchange(x, masks, cm, plan, corr, engine, recovery,
                                 seed, "cuda")
            launched = (K.masked_avg_grid.launches + RG.ring_round.launches
                        + RG.ring_round_enc.launches)
            groups = len(rps_lib._global_groups(plan))
            want_launches = 0 if recovery != "renorm" else groups
            if launched != want_launches or (
                    engine == "ring" and RG.ring_round.launches):
                raise AssertionError(
                    f"{name} {kind} {wire} {engine} {recovery}: "
                    f"{launched} launches, want {want_launches} (the ring "
                    f"engine on the encoded variant)")
            host = _byz_exchange(x, masks, cm, plan, corr, engine, recovery,
                                 seed, "cpu")
            if engine == "xla" and recovery == "renorm" and (
                    kind == "bitflip" or wire == "int8"):
                out["bits_differ"] += _xla_sends(x, masks, cm, plan, corr,
                                                 seed)
                with _Swapped(K, "masked_avg_grid", _avg_bound):
                    bound = _byz_exchange(x, masks, cm, plan, corr, engine,
                                          recovery, seed, "cpu")
                for a, b, lim in zip(card, host, bound):
                    try:
                        r = _within_bound(a, b, lim)
                    except AssertionError as e:
                        raise AssertionError(
                            f"{name} {kind} {wire} xla: card against CPU: "
                            f"{e}") from None
                    out["xla_worst_bound_ratio"] = max(
                        out["xla_worst_bound_ratio"], r)
                out["cases"] += 1
                del card, host, bound
                continue
            for a, b in zip(card, host):
                a = a.cpu()
                if recovery.startswith("clip"):
                    # 1e-6 of the largest contribution (|gamma x| <= 80),
                    # and one ulp of the output's own rounding on top
                    ulp = 2.0 ** -7 if a.dtype == torch.bfloat16 \
                        else 2.0 ** -23
                    tol = 1e-6 * 80.0 + ulp * b.double().abs()
                    if not bool(((a.double() - b.double()).abs()
                                 <= tol).all()):
                        raise AssertionError(f"{name} clip: card against "
                                             f"CPU beyond 1e-6 x 80 + 1 ulp")
                    continue
                try:
                    out["bits_differ"] += _same_values(a, b)
                except AssertionError as e:
                    raise AssertionError(
                        f"{name} {kind} {wire} {engine} {recovery}: the "
                        f"exchange on the card differs from the CPU's: "
                        f"{e}") from None
                out["equal_elems"] += a.numel()
            out["cases"] += 1
            del card, host
        out[f"{name}_s"] = time.perf_counter() - t0
        print(f"byzantine exchanges at {name}: {len(combos)} cases agree "
              f"({out[f'{name}_s']:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["rps-100m"] = byzantine_full(trees["rps-100m"])
    out["rps-100m_s"] = time.perf_counter() - t0
    print(f"byzantine exchanges at rps-100m (whole plan): "
          f"{out['rps-100m']['cases']} cases agree with the plain versions "
          f"({out['rps-100m_s']:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    return out


def byzantine_full(meta: dict, seed: int = 2500) -> dict:
    """Phase 25a at rps-100m's whole plan (n = 16, exchange groups up to
    (3, 16, 16, 1,769,472)): every corruption kind x wire x engine,
    renorm, on integer-valued replicas made on the card, through the
    kernels — on the ring engine ring.cu's encoded variant takes the f32
    and bf16 wires' corrupted offers and ring_q.cu's re-encode the int8
    wire's, on the xla engine the masked-average kernel, one launch a
    group — against the same exchange with the kernel's plain version on
    the card, the same draws made on the card: the same values
    (:func:`_same_values`), but for the xla engine under bitflip or on
    the int8 wire, inside the bound of two summation orders (a bound run
    with :func:`_avg_bound` in the average's place)."""
    n = 16
    x = _int_stack(meta, n, seed, device="cuda")
    out = {"cases": 0, "equal_elems": 0, "bits_differ": 0,
           "xla_worst_bound_ratio": 0.0, "largest_group": None}
    plain = {"ring": _Swapped(ops, "ring_round",
                              functools.partial(ops.ring_round,
                                                backend="ref")),
             "xla": _Swapped(K, "masked_avg_grid",
                             functools.partial(ops.masked_avg_grid,
                                               backend="ref"))}
    combos = [(k, w, e) for k in BYZ_KINDS for w in BYZ_WIRES
              for e in ("xla", "ring")]
    for i, (kind, wire, engine) in enumerate(combos):
        s_i = seed + i
        what = f"rps-100m {kind} {wire} {engine}"
        plan = make_exchange_plan(meta, SimulatorConfig(
            n_workers=n, wire=wire, engine=engine))
        out["largest_group"] = list(largest_group(plan))
        cpu = torch.Generator().manual_seed(s_i)
        nb = plan.n_buckets if plan.per_bucket_masks else None
        masks = rps_lib.sample_masks(cpu, n, BYZ_P, plan.s, nb)
        corr = channels_lib.make_corruption(f"{kind}:{BYZ_ATTACK}")
        cm = corr.sample(cpu, n, plan.s, nb)
        groups = len(rps_lib._global_groups(plan))

        def exchange():
            return _byz_exchange(x, masks, cm, plan, corr, engine, "renorm",
                                 s_i, "cuda")

        reset_counts()
        got = exchange()
        launches = {"masked_avg": K.masked_avg_grid.launches,
                    "ring": RG.ring_round.launches,
                    "enc": RG.ring_round_enc.launches,
                    "requant": RG.ring_round_enc.requant_launches}
        want = dict.fromkeys(launches, 0)
        if engine == "xla":
            want["masked_avg"] = groups
        else:
            want["enc"] = groups
            want["requant"] = groups if wire == "int8" else 0
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want "
                                 f"{want}")
        with plain[engine]:
            ref = exchange()
        if engine == "xla" and (kind == "bitflip" or wire == "int8"):
            ref = [t.cpu() for t in ref]  # host memory, for the bound run
            with _Swapped(K, "masked_avg_grid", _avg_bound):
                bound = exchange()
            for a, b, lim in zip(got, ref, bound):
                try:
                    r = _within_bound(a, b, lim)
                except AssertionError as e:
                    raise AssertionError(f"{what}: the kernel against the "
                                         f"plain version: {e}") from None
                out["xla_worst_bound_ratio"] = max(
                    out["xla_worst_bound_ratio"], r)
            del bound
        else:
            for a, b in zip(got, ref):
                try:
                    out["bits_differ"] += _same_values(a, b)
                except AssertionError as e:
                    raise AssertionError(f"{what}: the kernels against the "
                                         f"plain version: {e}") from None
                out["equal_elems"] += a.numel()
        out["cases"] += 1
        del got, ref
    del x
    return out


def robust_task(n: int):
    """robust_bench.py's task: per-worker linear regressions (x (n, 16,
    6), w_true (6, 4), numpy seed 0), made on the card."""
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(n, 16, 6)).astype(np.float32))
    w_true = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    xs = xs.cuda()
    ys = xs @ w_true.cuda()

    def init_fn(gen):
        return {"w": torch.randn((6, 4), generator=gen,
                                 device=gen.device) * 0.1}

    def loss_fn(p, b):
        x, y = b
        return torch.mean((x @ p["w"] - y) ** 2)

    return loss_fn, init_fn, (lambda t: (xs, ys))


def robust_bench(study=ROBUST_STUDY) -> dict:
    """Phase 25b: benchmarks/robust_bench.py sections 1-4 on the port and
    the card, uncut: recovery x byzantine_frac x p under the colluding
    attack, engine auto (renorm on the masked-average kernel, once per
    group and step; the robust kinds' table aggregate is plain torch).
    Gates: the bench's claim that under the attack median and trimmed
    reach the target loss and renorm does not — at p = 0 with the final
    loss, as the bench states it; at p = 0.2, where the final loss of one
    seed is a draw, with the median of the final losses over seeds 0-7
    (the bench's own verdict on seed 0's final losses is reported
    beside) — and every attacked run's mean corrupt_frac within
    CORRUPT_FRAC_TOL of expected_frac."""
    from repro_torch.channels import Corruption
    from repro_torch.core import theory
    n, steps = study["n"], study["steps"]
    loss_fn, init_fn, batch_fn = robust_task(n)
    expected = Corruption("collude", byzantine_frac=0.25).expected_frac(n)
    out = {"sweep": {}, "expected_corrupt_frac": expected}
    groups = None

    def run(rec, byz, p, seed):
        nonlocal groups
        scfg = SimulatorConfig(
            n_workers=n, drop_rate=p, aggregator="rps_model", steps=steps,
            lr=study["lr"], warmup=study["warmup"],
            n_buckets=study["n_buckets"], seed=seed, recovery=rec,
            corruption=study["attack"] if byz > 0 else None,
            byzantine_frac=byz)
        if groups is None:
            groups = len(rps_lib._global_groups(make_exchange_plan(
                {"w": torch.empty((6, 4), device="meta")}, scfg)))
        reset_counts()
        h = run_simulation(loss_fn, init_fn, batch_fn, scfg)
        launches = K.masked_avg_grid.launches
        want = groups * steps if rec == "renorm" else 0
        if launches != want:
            raise AssertionError(f"robust {rec} byz {byz} p {p} seed "
                                 f"{seed}: {launches} masked-average "
                                 f"launches, want {want}")
        cf = h["corrupt_frac"]
        if byz > 0 and abs(np.mean(cf) - expected) > CORRUPT_FRAC_TOL:
            raise AssertionError(f"robust {rec} byz {byz} p {p} seed "
                                 f"{seed}: mean corrupt_frac "
                                 f"{np.mean(cf)} against {expected}")
        return h, launches

    for rec in study["recoveries"]:
        for byz in study["byzs"]:
            for p in study["ps"]:
                h, launches = run(rec, byz, p, study["seed"])
                cf = h["corrupt_frac"]
                key = f"{rec}_byz{byz}_p{p}"
                out["sweep"][key] = {
                    "final_loss": h["final_loss"],
                    "min_loss": float(np.nanmin(h["loss"])),
                    "loss": h["loss"],
                    "corrupt_frac_mean": float(np.mean(cf)) if cf else 0.0,
                    "masked_avg_launches": launches,
                    "wall_s": sum(h["step_s"])}
                print(f"robust {key}: final loss {h['final_loss']:.3e}",
                      flush=True)
    # the bench's verdict on the final losses, and the gate: under the
    # attack, median and trimmed reach the target (at p = 0, where every
    # packet arrives, with their final loss; at draw_p with the median
    # over draw_seeds of the final loss: a drawn round whose delivered
    # rows are half colluders kicks the loss up, and it recovers — so the
    # final loss of one seed is a draw, as the reference shows at seed 0
    # on this JAX, 1.31) and renorm never does
    target = study["target"]
    draw_p = study["draw_p"]
    bench_ok, ok = True, True
    for p in study["ps"]:
        ren = out["sweep"][f"renorm_byz0.25_p{p}"]
        bench_ok &= not (np.isfinite(ren["final_loss"])
                         and ren["final_loss"] <= target)
        ok &= not (np.isfinite(ren["final_loss"])
                   and ren["final_loss"] <= target)
        ok &= not ren["min_loss"] <= target
        for rec in study["robust"]:
            la = out["sweep"][f"{rec}_byz0.25_p{p}"]
            fin = bool(np.isfinite(la["final_loss"]))
            bench_ok &= fin and la["final_loss"] <= target
            if p != draw_p:
                ok &= fin and la["final_loss"] <= target
    out["draws"] = {}
    for rec in study["robust"]:
        finals = []
        for seed in study["draw_seeds"]:
            if seed == study["seed"]:
                la = out["sweep"][f"{rec}_byz0.25_p{draw_p}"]
                finals.append(la["final_loss"])
            else:
                finals.append(run(rec, 0.25, draw_p, seed)[0]["final_loss"])
        med = float(np.median(finals))
        out["draws"][rec] = {"seeds": list(study["draw_seeds"]),
                             "final_loss": finals, "median": med}
        print(f"robust {rec}_byz0.25_p{draw_p} over seeds "
              f"{study['draw_seeds']}: final losses {finals}, median "
              f"{med:.4e}", flush=True)
        ok &= med <= target
    out["bench_final_loss_claim"] = bool(bench_ok)
    out["robust_recovery_ok"] = bool(ok)
    out["theory"] = {
        "breakdown_point": {r: theory.robust_breakdown_point(r)
                            for r in study["recoveries"]},
        "byzantine_rate": {f"byz{b}": theory.byzantine_rate(n, steps, b)
                           for b in (0.0, 0.125, 0.25)},
        "robust_rate_median_p0.2": theory.robust_rate(
            n, 0.2, steps, byz_frac=0.25, recovery="median")}
    ref = _bench_json("BENCH_robust.json")
    out["reference_cpu"] = {k: v["final_loss"]
                            for k, v in ref["sweep"].items()}
    for k, v in out["sweep"].items():
        print(f"robust_bench {k}: card {v['final_loss']:.4e} "
              f"(reference CPU {out['reference_cpu'].get(k)})", flush=True)
    if not ok:
        raise AssertionError(f"robust_bench claim fails: {out['sweep']}")
    return out


def _time_to(losses, target: float, step_ms: float) -> float:
    for t, loss in enumerate(losses):
        if loss <= target:
            return (t + 1) * step_ms
    return float("inf")


def async_bench(study=ASYNC_STUDY) -> dict:
    """Phase 26: benchmarks/async_bench.py section 2 on the port and the
    card, uncut: the straggler family, sync against async, engine auto
    (the masked-average kernel, once per group and exchange step), then
    the third scenario again on the ring engine. Gates: async_speedup > 1
    in every scenario; staleness 0 under sync, inside (0, 1) under async;
    the ring run's per-step losses within ASYNC_RING_TOL of the xla
    run's; launches = groups x exchange steps."""
    n, steps = study["n"], study["steps"]
    loss_fn, init_fn, batch_fn = robust_task(n)
    step_sync = study["compute_ms"] + study["deadline_ms"]
    step_async = max(study["compute_ms"], study["deadline_ms"])
    out = {"step_ms_sync": step_sync, "step_ms_async": step_async,
           "scenarios": {}}
    runs = {}

    def run(schedule, chan, engine):
        scfg = SimulatorConfig(
            n_workers=n, aggregator="rps_model", steps=steps,
            lr=study["lr"], warmup=study["warmup"], eval_every=1,
            n_buckets=study["n_buckets"], seed=study["seed"], channel=chan,
            schedule=schedule, engine=engine,
            compute_ms=study["compute_ms"] if schedule == "async" else None)
        groups = len(rps_lib._global_groups(make_exchange_plan(
            {"w": torch.empty((6, 4), device="meta")}, scfg)))
        reset_counts()
        h = run_simulation(loss_fn, init_fn, batch_fn, scfg)
        launches = RG.ring_round.launches if engine == "ring" \
            else K.masked_avg_grid.launches
        if launches != groups * steps:
            raise AssertionError(f"async {schedule} {engine}: {launches} "
                                 f"launches, want {groups} x {steps}")
        stale = h["staleness"]
        mean = float(np.mean(stale)) if stale else 0.0
        if schedule == "sync" and mean != 0.0:
            raise AssertionError(f"sync staleness {mean}")
        if schedule == "async" and not 0.0 < mean < 1.0:
            raise AssertionError(f"async staleness {mean}")
        return h, launches, mean

    launches = {"masked_avg": 0, "ring": 0}
    for frac, mult in study["family"]:
        chan = (f"deadline:deadline_ms={study['deadline_ms']},base_ms=1,"
                f"jitter_ms=3,straggler_frac={frac},straggler_mult={mult}")
        hs, ls, _ = run("sync", chan, "auto")
        ha, la, stale = run("async", chan, "auto")
        launches["masked_avg"] += ls + la
        target = max(min(hs["loss"]), min(ha["loss"])) * 1.02
        ts = _time_to(hs["loss"], target, step_sync)
        ta = _time_to(ha["loss"], target, step_async)
        key = f"frac{frac}_mult{mult}"
        out["scenarios"][key] = {
            "target_loss": target, "sync_ms": ts, "async_ms": ta,
            "async_speedup": ts / ta, "async_staleness_mean": stale,
            "final_loss_sync": hs["final_loss"],
            "final_loss_async": ha["final_loss"],
            "wall_s": sum(hs["step_s"]) + sum(ha["step_s"])}
        runs[key] = ha
        print(f"async {key}: speedup {ts / ta:.3f} staleness {stale:.3f}",
              flush=True)
    frac, mult = study["family"][2]
    key = f"frac{frac}_mult{mult}"
    chan = (f"deadline:deadline_ms={study['deadline_ms']},base_ms=1,"
            f"jitter_ms=3,straggler_frac={frac},straggler_mult={mult}")
    hr, lr_, _ = run("async", chan, "ring")
    launches["ring"] += lr_
    gap = max(abs(a - b) for a, b in zip(hr["loss"], runs[key]["loss"]))
    out["ring_vs_xla_max_abs"] = gap
    out["launches"] = launches
    ref = _bench_json("BENCH_async.json")["time_to_loss"]["scenarios"]
    out["reference_cpu"] = {k: {"async_speedup": v["async_speedup"],
                                "async_staleness_mean":
                                v["async_staleness_mean"]}
                            for k, v in ref.items()}
    speedups = [v["async_speedup"] for v in out["scenarios"].values()]
    out["async_speedup_min"] = min(speedups)
    if not min(speedups) > 1.0:
        raise AssertionError(f"async_bench: speedups {speedups}")
    if gap > ASYNC_RING_TOL:
        raise AssertionError(f"async ring against xla: {gap}")
    return out


class _AggTimer:
    """Phase 27's probe: wraps the robust aggregate and times each call
    between CUDA events (device ms, summed per run)."""

    def __init__(self):
        self.inner = rps_lib.robust_lib.robust_aggregate
        self.events = []

    def __call__(self, *args, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = self.inner(*args, **kw)
        t1.record()
        self.events.append((t0, t1))
        return out

    def __enter__(self):
        rps_lib.robust_lib.robust_aggregate = self
        return self

    def __exit__(self, *exc):
        rps_lib.robust_lib.robust_aggregate = self.inner
        return False

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def robust_card_vs_cpu(params, scfg, seed: int = 0) -> int:
    """Phase 27's check of the robust exchange: one median exchange with
    the colluding attack of rps-100m's embedding and first layer at full
    width (the stacked replicas ``params``), on the card and on the CPU,
    with the same masks and corrupt masks drawn on the CPU: the same
    values (:func:`_same_values`). Returns the elements compared and how
    many of them differ in their bits."""
    sub = {"embed": params["embed"],
           "layers": tree_lib.map(lambda x: x[:, :1].contiguous(),
                                  params["layers"])}
    n = scfg.n_workers
    plan = make_exchange_plan(tree_lib.map(lambda x: x[0], sub), scfg)
    cpu = torch.Generator().manual_seed(seed)
    masks = rps_lib.sample_masks(cpu, n, scfg.drop_rate, plan.s)
    corr = channels_lib.make_corruption(scfg.corruption,
                                        scfg.byzantine_frac)
    cm = corr.sample(cpu, n, plan.s)
    card = _byz_exchange(sub, masks, cm, plan, corr, "xla", scfg.recovery,
                         seed, "cuda")
    host = _byz_exchange(_on(sub, "cpu"), masks, cm, plan, corr, "xla",
                         scfg.recovery, seed, "cpu")
    differ = sum(_same_values(a, b) for a, b in zip(card, host))
    return {"elems": sum(x.numel() for x in host), "bits_differ": differ}


def rps100m_attack(setup: Rps100mSetup, clean: dict,
                   load=RPS_100M_LOAD) -> dict:
    """Phase 27: rps-100m at phase 17's load, ``setup``'s weights (the
    cut's), batches and masks under the colluding attack (4 of 16
    workers), 4 steps each: renorm on the ring engine (the corrupted
    offer on the encoded variant, the honest stack the fallback: launches
    = groups x steps) and median, trimmed and clip on the xla engine (no
    kernel: the table aggregate). Gates, against the clean run ``clean``
    (the cut's baseline): median's and trimmed's losses finite and within
    ATTACK_LOSS_GAP of the clean ones at every step; renorm's last loss
    non-finite or more than 1.0 above the clean one; the robust runs'
    peak within ATTACK_PEAK_GB of the clean run's; one median exchange of
    the final replicas alike on the card and the CPU (checked before the
    next run, so no run holds another's replicas)."""
    steps = ATTACK_LOAD["steps"]
    clean_loss = clean["loss"][:steps]
    out = {"layers": setup.model.cfg.n_layers}
    for rec, engine in (("renorm", "ring"), ("median", "xla"),
                        ("trimmed:beta=0.4", "xla"), ("clip", "xla")):
        scfg = rps100m_config(load, engine=engine, recovery=rec,
                              **ATTACK_LOAD)
        groups = len(rps_lib._global_groups(make_exchange_plan(setup.p1,
                                                               scfg)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _AggTimer() as timer:
            h = run_simulation(setup.loss_fn, None,
                               lambda t: setup.batches[t], scfg,
                               init_params=setup.p1)
            agg_ms = timer.total_ms()
        peak = torch.cuda.max_memory_allocated() / 1e9
        enc, lin = RG.ring_round_enc.launches, RG.ring_round.launches
        requant = RG.ring_round_enc.requant_launches
        loss = h["loss"]
        step_s = h["step_s"]
        out[rec] = {"engine": engine, "loss": loss,
                    "clean_loss": clean_loss, "peak_memory_gb": peak,
                    "first_step_ms": step_s[0] * 1e3,
                    "step_ms": [t * 1e3 for t in step_s[1:]],
                    "aggregate_device_ms_per_step": agg_ms / steps,
                    "ring_enc_launches": enc, "ring_launches": lin,
                    "ring_requant_launches": requant,
                    "masked_avg_launches": K.masked_avg_grid.launches,
                    "corrupt_frac": h["corrupt_frac"], "groups": groups}
        print(f"rps-100m attacked {rec}: losses {loss} (clean "
              f"{clean_loss}), peak {peak:.3f} GB, aggregate "
              f"{agg_ms / steps:.2f} ms a step", flush=True)
        if engine == "ring" and (enc != groups * steps or lin != 0
                                 or requant != 0):
            raise AssertionError(f"rps-100m attacked renorm: {enc} encoded "
                                 f"({requant} re-encoding) and {lin} "
                                 f"linear launches, want {groups} x "
                                 f"{steps} (0) and 0")
        if engine == "xla" and (enc or lin or K.masked_avg_grid.launches):
            raise AssertionError(f"rps-100m attacked {rec}: a kernel "
                                 f"launched on the robust path")
        if rec in ("median", "trimmed:beta=0.4"):
            gaps = [abs(a - b) for a, b in zip(loss, clean_loss)]
            out[rec]["max_loss_gap"] = max(gaps)
            if not (np.isfinite(loss).all() and max(gaps) <= ATTACK_LOSS_GAP):
                raise AssertionError(f"rps-100m attacked {rec}: losses "
                                     f"{loss} against clean {clean_loss}")
        if engine == "xla" and peak > clean["peak_memory_gb"] \
                + ATTACK_PEAK_GB:
            raise AssertionError(f"rps-100m attacked {rec}: peak {peak} GB "
                                 f"against the clean run's "
                                 f"{clean['peak_memory_gb']} + "
                                 f"{ATTACK_PEAK_GB}")
        if rec == "median":
            out["median_exchange_card_vs_cpu"] = robust_card_vs_cpu(
                h["params"], scfg)
        del h
    last = out["renorm"]["loss"][-1]
    if np.isfinite(last) and last <= clean_loss[-1] + 1.0:
        raise AssertionError(f"rps-100m attacked renorm: last loss {last} "
                             f"against clean {clean_loss[-1]}: the attack "
                             f"did not bite")
    torch.cuda.empty_cache()
    return out


def rps100m_async(setup: Rps100mSetup, load=RPS_100M_LOAD) -> dict:
    """Phase 28: rps-100m at phase 17's load (``setup``: the cut) with 8
    buckets on the straggler deadline channel, compute_ms 8, ring engine,
    4 steps, sync and async (finite losses, async staleness > 0, launches
    = groups x steps); then the backward's measured readiness profile at
    this plan (measure_bucket_ready_ms, what compute_ms="auto" runs)
    beside the cost model's: positive and non-increasing."""
    from repro_torch.train import simulator as sim_lib
    steps = ASYNC_LOAD["steps"]
    out = {"layers": setup.model.cfg.n_layers}
    for schedule in ("sync", "async"):
        scfg = rps100m_config(
            load, steps=steps, n_buckets=ASYNC_LOAD["n_buckets"],
            channel=ASYNC_LOAD["channel"], schedule=schedule,
            compute_ms=ASYNC_LOAD["compute_ms"]
            if schedule == "async" else None)
        plan = make_exchange_plan(setup.p1, scfg)
        groups = len(rps_lib._global_groups(plan))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h = run_simulation(setup.loss_fn, None,
                           lambda t: setup.batches[t], scfg,
                           init_params=setup.p1)
        launches = RG.ring_round.launches
        step_s = h["step_s"]
        out[schedule] = {"loss": h["loss"], "staleness": h["staleness"],
                         "ring_launches": launches, "groups": groups,
                         "ready_ms": list(plan.ready_ms or ()),
                         "first_step_ms": step_s[0] * 1e3,
                         "step_ms": [t * 1e3 for t in step_s[1:]],
                         "peak_memory_gb":
                         torch.cuda.max_memory_allocated() / 1e9}
        print(f"rps-100m {schedule}: losses {h['loss']} staleness "
              f"{h['staleness']}", flush=True)
        if launches != groups * steps:
            raise AssertionError(f"rps-100m {schedule}: {launches} ring "
                                 f"launches, want {groups} x {steps}")
        if not np.isfinite(h["loss"]).all():
            raise AssertionError(f"rps-100m {schedule}: losses {h['loss']}")
        if schedule == "async" and not np.mean(h["staleness"]) > 0:
            raise AssertionError("rps-100m async: no packet was late")
        del h
    params = tree_lib.map(
        lambda x: x[None].expand((load["n"],) + tuple(x.shape)).clone(),
        setup.p1)
    batch = setup.batches[0]
    t0 = time.perf_counter()
    measured = sim_lib.measure_bucket_ready_ms(setup.loss_fn, params, batch,
                                               plan, reps=1)
    out["measured_ready_ms"] = measured
    out["measure_s"] = time.perf_counter() - t0
    out["model_ready_ms"] = list(plan.ready_ms)
    del params
    torch.cuda.empty_cache()
    print(f"rps-100m readiness (ms), measured {measured}, cost model "
          f"{list(plan.ready_ms)}", flush=True)
    if not (all(r > 0 for r in measured)
            and all(a >= b for a, b in zip(measured, measured[1:]))):
        raise AssertionError(f"measured readiness {measured}: not positive "
                             f"and non-increasing")
    return out


# ---- phases 29-31: telemetry, the convergence bench, the launchers --------

# phase 29: rps-100m with telemetry off and on, then the int8 wire with it
TEL_STEPS = 4
TEL_INT8_STEPS = 8
# phase 30: benchmarks/convergence.py's run, recipe unchanged
FIG4A = dict(n=16, batch=32, lr=0.2, warmup=10, steps=150,
             drop_rates=(0.0, 0.01, 0.05, 0.1, 0.2))
FIG4B = dict(arch="rps-paper-mlp", n=8, batch=16, seq=32, lr=0.5,
             warmup=5, steps=40)
# phase 31: the launchers as a user runs them
LAUNCH_STEPS = 20
SERVE_ARGS = ["--serve", "continuous", "--full", "--tp-shards", "4", "-p",
              "0.1", "--drain"]
ROOT = Path(__file__).resolve().parent


def _cli(args: list) -> subprocess.CompletedProcess:
    """Run ``python args...`` from the repository root with the port on
    the path; raises with its output unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable] + args, cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {r.returncode}: "
                             f"{r.stdout}{r.stderr}")
    return r


def _validate(path: Path) -> None:
    _cli(["-m", "repro_torch.telemetry.trace", "--validate", str(path)])


def _tel_run(setup: Rps100mSetup, scfg, reg) -> tuple:
    """One phase-29 run from ``setup``'s weights and batches: the history,
    the ring kernels' launches, and the peak memory above the run's start
    allocation."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    h = run_simulation(setup.loss_fn, None, lambda t: setup.batches[t],
                       scfg, init_params=setup.p1, telemetry=reg)
    launches = {"ring": RG.ring_round.launches,
                "ring_enc": RG.ring_round_enc.launches,
                "ring_requant": RG.ring_round_enc.requant_launches}
    peak = (torch.cuda.max_memory_allocated() - start) / 1e9
    return h, launches, peak


def rps100m_telemetry(setup: Rps100mSetup, load=RPS_100M_LOAD) -> dict:
    """Phase 29: rps-100m at phase 17's load, ``setup``'s weights (the
    cut's), batches and masks on the ring engine, TEL_STEPS steps with
    telemetry off and then on.
    Gates: the losses, consensus and every parameter leaf bit for bit
    equal; a record per step; every record's link_offered the plan's
    layout (counters.link_offered); launches = groups x steps in both
    runs; the run's trace.json accepted by the port's --validate.
    Printed: the mean rs_drop_rate, the drift verdict (and the flagged
    links), the cost (step ms of steps 2 on, off against on over both
    pairs; the device time of one norm pass over the stacked replicas;
    peak memory above the start, off against on). Then the
    int8 wire (renorm) with telemetry, TEL_INT8_STEPS steps: per step the
    consensus, the parameters' squared norm and their ratio beside the
    bound's alpha2 and the wire's extra (theory.plan_wire_alpha2_extra):
    a finding, not a gate."""
    from repro_torch import telemetry as telemetry_lib
    from repro_torch.core import theory
    from repro_torch.telemetry import counters
    n = load["n"]
    scfg = rps100m_config(load, steps=TEL_STEPS)
    plan = make_exchange_plan(setup.p1, scfg)
    groups = len(rps_lib._global_groups(plan))
    offered = counters.link_offered(
        n, plan.s, plan.n_buckets if plan.per_bucket_masks else None)
    out = {"layers": setup.model.cfg.n_layers, "groups": groups,
           "steps": TEL_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        h_off, l_off, peak_off = _tel_run(setup, scfg, None)
        reg = telemetry_lib.Telemetry(out_dir=tmp)
        h_on, l_on, peak_on = _tel_run(setup, scfg, reg)
        summary = reg.finalize()
        _validate(Path(tmp) / "trace.json")
        files = sorted(os.listdir(tmp))
    same = h_off["loss"] == h_on["loss"] \
        and h_off["consensus"] == h_on["consensus"] \
        and all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(h_off["params"]), tree_lib.leaves(h_on["params"])))
    # the device time of one of the two norm passes telemetry adds a step
    norm_ms = event_ms(lambda: counters.global_norm(h_on["params"]), 10)
    step_ms = {"off": [t * 1e3 for t in h_off["step_s"][1:]],
               "on": [t * 1e3 for t in h_on["step_s"][1:]]}
    del h_off
    # a second pair in the same call, off then on again, for the spread
    for name, r in (("off2", None), ("on2", telemetry_lib.Telemetry())):
        h, _, _ = _tel_run(setup, scfg, r)
        step_ms[name] = [t * 1e3 for t in h["step_s"][1:]]
        del h
    recs = h_on.records
    rs_drop = [r["rs_drop_rate"] for r in recs]
    link = summary["link_p"]
    flagged = {leg: [{"link": i, "observed_p": d["observed_p"][i],
                      "tolerance": d["tolerance"][i],
                      "packets": d["packets"][i]}
                     for i, f in enumerate(d["drifted"]) if f]
               for leg, d in link.items()}
    off = np.mean(step_ms["off"] + step_ms["off2"])
    on = np.mean(step_ms["on"] + step_ms["on2"])
    out.update({
        "bitwise_off_on": same, "records": len(recs), "files": files,
        "loss": h_on["loss"], "consensus": h_on["consensus"],
        "rs_drop_rate": rs_drop, "rs_drop_rate_mean": float(np.mean(rs_drop)),
        "drift": {leg: d["any_drift"] for leg, d in link.items()},
        "drifted_links": flagged,
        "observed_p_mean": float(np.mean(link["rs"]["observed_p"])),
        "alpha_bounds": summary["meta"]["alpha_bounds"],
        "grad_norm": [r["grad_norm"] for r in recs],
        "param_norm": [r["param_norm"] for r in recs],
        "step_ms": step_ms, "step_ms_mean_off": off, "step_ms_mean_on": on,
        "overhead": on / off - 1.0, "global_norm_device_ms": norm_ms,
        "peak_above_start_gb_off": peak_off,
        "peak_above_start_gb_on": peak_on,
        "launches_off": l_off, "launches_on": l_on,
        "spans_ms": {e["name"]: e["dur"] / 1e3 for e in reg.trace.events
                     if e["ph"] == "X"}})
    print(f"rps-100m telemetry: bitwise {same}, rs_drop_rate mean "
          f"{out['rs_drop_rate_mean']:.4f}, drift {out['drift']} "
          f"{flagged}, step ms {step_ms}, mean off {off:.1f} on {on:.1f} "
          f"({100 * (on / off - 1):+.2f} %), global_norm {norm_ms:.3f} ms "
          f"on the device, peak above start off {peak_off:.3f} on "
          f"{peak_on:.3f} GB", flush=True)
    if not same:
        raise AssertionError("rps-100m: telemetry changed the run's losses, "
                             "consensus or parameters")
    if len(recs) != TEL_STEPS or any(r["link_offered"] != offered.tolist()
                                     for r in recs):
        raise AssertionError(f"rps-100m telemetry: {len(recs)} records, "
                             f"link_offered {recs[0]['link_offered']} "
                             f"against {offered.tolist()}")
    for launches in (l_off, l_on):
        if launches["ring"] != groups * TEL_STEPS:
            raise AssertionError(f"rps-100m telemetry: {launches} ring "
                                 f"launches, want {groups} x {TEL_STEPS}")
    del h_on
    torch.cuda.empty_cache()

    scfg8 = rps100m_config(load, steps=TEL_INT8_STEPS, wire="int8")
    plan8 = make_exchange_plan(setup.p1, scfg8)
    reg8 = telemetry_lib.Telemetry()
    h8, l8, peak8 = _tel_run(setup, scfg8, reg8)
    groups8 = len(rps_lib._global_groups(plan8))
    if l8["ring_enc"] != groups8 * TEL_INT8_STEPS or l8["ring"] != 0:
        raise AssertionError(f"rps-100m int8 telemetry: launches {l8}")
    cons = h8["consensus"]
    pn2 = [r["param_norm"] ** 2 for r in h8.records]
    ratio = [c / q for c, q in zip(cons, pn2)]
    extra = theory.plan_wire_alpha2_extra(plan8, n, load["p"])
    bounds = h8.summary["meta"]["alpha_bounds"]
    under = [r < extra for r in ratio]
    out["int8_alpha2"] = {
        "consensus": cons, "param_norm_sq": pn2, "ratio": ratio,
        "alpha_bounds": bounds, "wire_alpha2_extra": extra,
        "ratio_under_extra": under,
        "under_from_step_2": all(under[1:]),
        "loss": h8["loss"], "launches": l8, "peak_above_start_gb": peak8,
        "step_ms": [t * 1e3 for t in h8["step_s"][1:]]}
    for t, (c, q, r) in enumerate(zip(cons, pn2, ratio)):
        print(f"int8 alpha2 step {t}: consensus {c:.6g} param_norm^2 "
              f"{q:.6g} ratio {r:.6g} (alpha2 {bounds['alpha2']:.6g}, "
              f"wire extra {extra:.6g})", flush=True)
    if not (len(h8.records) == TEL_INT8_STEPS
            and np.isfinite(cons).all() and np.isfinite(pn2).all()):
        raise AssertionError(f"rps-100m int8 telemetry: consensus {cons}, "
                             f"param_norm^2 {pn2}")
    del h8
    torch.cuda.empty_cache()
    return out


def convergence_bench() -> dict:
    """Phase 30: benchmarks/convergence.py's run on the port, recipe
    unchanged, each run inside the port's timing.wallclock under a
    Telemetry registry. Fig 4a: the 24-48-8 tanh MLP, n 16, batch 32, lr
    0.2, warm-up 10, 150 steps, p in {0, 0.01, 0.05, 0.1, 0.2} (allreduce
    at p 0, rps_model otherwise, engine auto: the masked-average kernel
    once per exchange group and step), its assertion final_loss < base x
    1.2 + 0.05. Fig 4b: rps-paper-mlp on the char-LM task (seq 32), n 8,
    batch 16, lr 0.5, warm-up 5, 40 steps, allreduce at p 0 against
    rps_model at p 0.1, its assertion res[0.1] < res[0.0] x 1.25 + 0.05.
    The table as the bench prints it, each run's time from the registry's
    timings_s."""
    from repro_torch import telemetry as telemetry_lib
    from repro_torch.telemetry.timing import wallclock
    reg = telemetry_lib.Telemetry()
    out = {"fig4a": {}, "fig4b": {}}
    expected = 0
    task = TeacherTask(d_in=24, n_classes=8, hetero=0.3, seed=0)
    batch_fn = make_worker_streams(task, FIG4A["n"], FIG4A["batch"])
    cfg = get_config(FIG4B["arch"])
    model = build_model(cfg, device="cuda")
    lm = CharLMTask(vocab=cfg.vocab_size, seq_len=FIG4B["seq"], seed=0)
    lm_batch = make_worker_streams(lm, FIG4B["n"], FIG4B["batch"])

    def lm_loss(p, b):
        return model.loss(p, b)[0]

    reset_counts()
    with telemetry_lib.enabled(reg):
        steps, base = FIG4A["steps"], None
        for p in FIG4A["drop_rates"]:
            agg = "allreduce_model" if p == 0.0 else "rps_model"
            scfg = SimulatorConfig(n_workers=FIG4A["n"], drop_rate=p,
                                   aggregator=agg, lr=FIG4A["lr"],
                                   warmup=FIG4A["warmup"], steps=steps,
                                   eval_every=steps - 1)
            with wallclock(f"convergence.p{p}"):
                h = run_simulation(teacher_loss, teacher_init, batch_fn,
                                   scfg)
            if agg == "rps_model":
                plan = make_exchange_plan(
                    {k: torch.empty(s, device="meta")
                     for k, s in QUICKSTART_SHAPES.items()}, scfg)
                expected += len(rps_lib._global_groups(plan)) * steps
            if p == 0.0:
                base = h["final_loss"]
            out["fig4a"][p] = {"aggregator": agg,
                               "final_loss": h["final_loss"],
                               "consensus": h["consensus"][-1]}
            if not h["final_loss"] < base * 1.2 + 0.05:
                raise AssertionError(f"Fig 4a: p={p} final loss "
                                     f"{h['final_loss']} diverged from the "
                                     f"baseline {base}")
        steps = FIG4B["steps"]
        for p, agg in ((0.0, "allreduce_model"), (0.1, "rps_model")):
            scfg = SimulatorConfig(n_workers=FIG4B["n"], drop_rate=p,
                                   aggregator=agg, lr=FIG4B["lr"],
                                   warmup=FIG4B["warmup"], steps=steps,
                                   eval_every=steps - 1)
            with wallclock(f"convergence.lm_p{p}"):
                h = run_simulation(lm_loss, model.init_stacked, lm_batch,
                                   scfg)
            if agg == "rps_model":
                meta = tree_lib.map(
                    lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), h["params"])
                plan = make_exchange_plan(tree_lib.map(lambda x: x[0], meta),
                                          scfg)
                expected += len(rps_lib._global_groups(plan)) * steps
            out["fig4b"][p] = {"aggregator": agg,
                               "final_loss": h["final_loss"]}
    launches = K.masked_avg_grid.launches
    timings = reg.summary()["timings_s"]
    print("# Fig 4a — drop-rate sweep (teacher-student, n=16, SGD+warmup)")
    print("drop_rate,aggregator,final_loss,consensus,ms")
    for p, r in out["fig4a"].items():
        print(f"{p},{r['aggregator']},{r['final_loss']:.4f},"
              f"{r['consensus']:.3e},"
              f"{timings[f'convergence.p{p}']['best'] * 1e3:.1f}")
    print("# Fig 4b — char-LM transformer spot check (entropy floor "
          f"{lm.entropy_floor():.3f})")
    for p, r in out["fig4b"].items():
        print(f"{p},{r['aggregator']},{r['final_loss']:.4f},"
              f"{timings[f'convergence.lm_p{p}']['best'] * 1e3:.1f}",
              flush=True)
    res = {p: r["final_loss"] for p, r in out["fig4b"].items()}
    if not res[0.1] < res[0.0] * 1.25 + 0.05:
        raise AssertionError(f"Fig 4b: rps {res[0.1]} against allreduce "
                             f"{res[0.0]}")
    if launches != expected:
        raise AssertionError(f"convergence: {launches} masked-average "
                             f"launches, want {expected}")
    out["timings_s"] = timings
    out["masked_avg_launches"] = launches
    out["entropy_floor"] = lm.entropy_floor()
    del model
    torch.cuda.empty_cache()
    return out


def launchers() -> dict:
    """Phase 31: the launchers as a user runs them. ``python -m
    repro_torch.launch.train`` at its defaults with --steps LAUNCH_STEPS
    --telemetry-dir D --checkpoint C: D holds telemetry.jsonl,
    summary.json and trace.json, the port's --validate accepts the trace,
    tools/render_experiments.py --telemetry D exits 0, and C loads back
    through load_pytree bit for bit equal to the run's mean parameters
    (the masked-average kernel launched). ``python -m
    repro_torch.launch.serve`` on gemma3-1b at full width, continuous,
    lossy 4-shard TP decode, with --telemetry-dir: serve_trace.json
    validates and holds serve.request for every request, serve.prefill
    and serve.queue, and the greedy tokens and TP-combine launches equal
    those of a run without telemetry."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.launch import serve as serve_launcher
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tel, ck = Path(tmp) / "train", Path(tmp) / "mean.npz"
        reset_counts()
        t0 = time.perf_counter()
        h = train_launcher.main(["--steps", str(LAUNCH_STEPS),
                                 "--telemetry-dir", str(tel),
                                 "--checkpoint", str(ck)])
        out["train_s"] = time.perf_counter() - t0
        out["train_masked_avg_launches"] = K.masked_avg_grid.launches
        files = sorted(os.listdir(tel))
        if files != ["summary.json", "telemetry.jsonl", "trace.json"]:
            raise AssertionError(f"train launcher: {tel} holds {files}")
        _validate(tel / "trace.json")
        _cli([str(ROOT / "tools" / "render_experiments.py"), "--telemetry",
              str(tel)])
        mean = tree_lib.map(lambda x: torch.mean(x, 0), h["params"])
        back = load_pytree(str(ck), mean)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(back), tree_lib.leaves(mean)))
        if not same or out["train_masked_avg_launches"] == 0:
            raise AssertionError(f"train launcher: checkpoint equal {same}, "
                                 f"{out['train_masked_avg_launches']} "
                                 f"masked-average launches")
        out.update({"train_final_loss": h["final_loss"],
                    "train_records": len(h.records),
                    "checkpoint_bitwise": same})

        srv = Path(tmp) / "serve"
        reset_counts()
        rep = serve_launcher.main(SERVE_ARGS + ["--telemetry-dir", str(srv)])
        tel_launches = K.tp_combine.launches
        reset_counts()
        plain = serve_launcher.main(SERVE_ARGS)
        plain_launches = K.tp_combine.launches
        path = srv / "serve_trace.json"
        _validate(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    rids = {e["args"]["rid"] for e in events if e["name"] == "serve.request"}
    out.update({"serve_tokens": rep.tokens,
                "serve_tokens_per_s_tel": rep.tokens_per_s,
                "serve_tokens_per_s_plain": plain.tokens_per_s,
                "serve_events": len(events),
                "tp_combine_launches": tel_launches + plain_launches})
    if rep.outputs() != plain.outputs():
        raise AssertionError("serve launcher: telemetry changed the tokens")
    if not ({"serve.request", "serve.prefill", "serve.queue"} <= names
            and rids == {r.rid for r in rep.requests}):
        raise AssertionError(f"serve trace: events {names}, requests {rids}")
    if tel_launches == 0 or tel_launches != plain_launches:
        raise AssertionError(f"serve launcher: {tel_launches} and "
                             f"{plain_launches} TP-combine launches")
    torch.cuda.empty_cache()
    return out


class Laps:
    """Wall seconds of the phases, lap by lap since the build; printed on
    one line before the kernels' line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now

    def report(self) -> None:
        print(json.dumps({"phase_s": self.laps,
                          "total_s": sum(self.laps.values())}), flush=True)


# ---- phases 32-36: every decoder family at full width ----------------------


@dataclasses.dataclass(frozen=True)
class FullLoad:
    """A full-width serving phase: ``arch`` cut to ``layers`` layers (None:
    whole), ``requests`` prompts of ``prompt`` tokens, ``new`` greedy
    tokens each, on the continuous engine with lossy 4-shard TP decode at
    Bernoulli p = 0.1; ``route`` is the attention route its prefill takes
    (checked against full attention on layer 0)."""
    arch: str
    layers: Optional[int]
    requests: int
    prompt: int
    new: int
    route: str


# phase 32: the chunked route (prompts over 2048 tokens)
DEEPSEEK_LOAD = FullLoad("deepseek-7b", None, 8, 4096, 32, "chunked")
# phase 33: 3 x the 4096-token window, the blocked route; a multiple of
# the window, where the reference's contiguous ring buffer is right too
STARCODER_LOAD = FullLoad("starcoder2-15b", None, 2, 12_288, 32, "blocked")
# phases 34-35: one card holds these at full width only with depth cut
LLAMA_LOAD = FullLoad("llama3-405b", 4, 8, 512, 32, "full")
MIXTRAL_LOAD = FullLoad("mixtral-8x22b", 4, 8, 512, 32, "full")
KIMI_LOAD = FullLoad("kimi-k2-1t-a32b", 1, 8, 512, 32, "full")
ROUTE_TOL = 2e-2               # a bf16 route against full attention
ROUTE_LOGIT_BYTES = 8e9        # f32 scores of one full-attention slice
# the TP combine at the new configs' widths: deepseek-7b, starcoder2-15b,
# kimi-k2, llama3-405b (gemma3-1b's 1152 is row 1')
TP_WIDTHS = (("deepseek-7b", 4096), ("starcoder2-15b", 6144),
             ("kimi-k2-1t-a32b", 7168), ("llama3-405b", 16384))
# phase 36: the training launcher at full width, its depth and n cut to
# what one card holds (recurrentgemma-9b at n = 4 ran out of memory in
# the consensus distance: the old and the new 22 GB replica stacks and an
# f32 copy of the 4 x 1.05 B token embedding; n = 2 halves each)
TRAIN_ARGS = ["--batch-size", "2", "--seq-len", "512", "--steps", "4",
              "--engine", "ring", "--drop-rate", "0.1", "--task-vocab",
              "256"]
TRAIN_RUNS = (("rwkv6-1.6b", None, 4), ("recurrentgemma-9b", 3, 2),
              ("mixtral-8x22b", 1, 2))


def _full_config(arch: str, layers: Optional[int]) -> ArchConfig:
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                           n_layers=layers)


def _gb(tree) -> float:
    return sum(x.numel() * x.element_size()
               for x in tree_lib.leaves(tree)) / 1e9


class MoeStats:
    """Records the MoE routing of every prefill (S > 1) while installed
    in place of ``layers.moe_route``: the expert-load histogram, the
    assignments the capacity dropped, the aux losses (device sums, one
    host copy at the end)."""

    def __init__(self, n_experts: int):
        self.hist = torch.zeros(n_experts, dtype=torch.int64, device="cuda")
        self.dropped = torch.zeros((), dtype=torch.int64, device="cuda")
        self.aux = torch.zeros((), dtype=torch.float32, device="cuda")
        self.assignments = self.calls = 0
        self._orig = LM.moe_route

    def __enter__(self):
        def route(p, x, cfg):
            rt = self._orig(p, x, cfg)
            if x.shape[1] > 1:
                self.hist += torch.bincount(rt["gate_idx"].reshape(-1),
                                            minlength=self.hist.numel())
                self.dropped += (~rt["keep"]).sum()
                self.aux += rt["aux"]
                self.assignments += rt["keep"].numel()
                self.calls += 1
            return rt
        LM.moe_route = route
        return self

    def __exit__(self, *exc):
        LM.moe_route = self._orig

    def summary(self) -> dict:
        return {"expert_load": self.hist.tolist(),
                "dropped_share": int(self.dropped) / max(self.assignments, 1),
                "prefill_aux_mean": float(self.aux) / max(self.calls, 1),
                "routed_prefill_layers": self.calls}


def route_vs_full(attn: dict, x: torch.Tensor, cfg: ArchConfig,
                  window: Optional[int], route: str) -> float:
    """Layer 0's attention on ``route`` (chunked or blocked) against full
    attention at the same q, k, v, head group by head group (at S =
    12,288 the whole (S x S) f32 scores would be 29 GB); raises above
    ROUTE_TOL. Returns the largest abs error."""
    with torch.no_grad():
        q, k, v = LM.attention_qkv(attn, x, cfg=cfg)
        if LM.attention_route(q.shape[1], window, True) != route:
            raise AssertionError(f"{cfg.name}: S {q.shape[1]} does not take "
                                 f"the {route} route")
        if route == "blocked":
            got = LM.blocked_local_attention(q, k, v, window=window)
        else:
            got = LM.chunked_attention(q, k, v, causal=True, window=window)
        B, S, h, hd = q.shape
        kvh = k.shape[2]
        g = h // kvh
        per = max(1, int(ROUTE_LOGIT_BYTES // (B * g * S * S * 4)))
        err = 0.0
        for j in range(0, kvh, per):
            want = LM.full_attention(q[:, :, j * g:(j + per) * g],
                                     k[:, :, j:j + per], v[:, :, j:j + per],
                                     causal=True, window=window)
            part = got[:, :, j * g:(j + per) * g]
            err = max(err, (part.float() - want.float()).abs().max().item())
            if not torch.allclose(part.float(), want.float(), atol=ROUTE_TOL,
                                  rtol=ROUTE_TOL):
                raise AssertionError(f"{cfg.name}: the {route} route differs "
                                     f"from full attention by {err}")
            del want
    return err


def serve_full(load: FullLoad, gen: torch.Generator) -> dict:
    """Phases 32-35: ``load`` at full width (random bf16 weights) on the
    continuous engine with lossy TP decode. Checks every request's
    tokens, finite decode logits, the TP-combine launches (each attention
    site and each dense MLP site, once per decode step; the MoE FFN keeps
    its dense expert path), no masked-average launch, and layer 0's
    prefill route against full attention. Times the prefills (each
    synchronised) apart from the rest of the wall."""
    cfg = _full_config(load.arch, load.layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=load.prompt),
                    max_new=load.new, arrival_ms=0.0)
            for i in range(load.requests)]
    page = 16
    per = -(-(load.prompt + load.new) // page)
    eng = ContinuousEngine(model, params, page=page,
                           n_blocks=1 + per * load.requests, max_batch=8,
                           chunk=8, max_len=load.prompt + load.new,
                           tp=TPDecodeConfig(n_shards=4, p=0.1))
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    decode = model.decode_paged

    def decode_checked(*args, **kwargs):
        nonlocal finite
        logits, pool = decode(*args, **kwargs)
        finite = finite & torch.isfinite(logits).all()
        return logits, pool

    model.decode_paged = decode_checked
    prefill, prefill_s = model.prefill, 0.0

    def prefill_timed(*args, **kwargs):
        nonlocal prefill_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - t0
        return out

    model.prefill = prefill_timed
    stats = MoeStats(cfg.n_experts) if cfg.is_moe else None
    torch.cuda.synchronize()
    reset_counts()
    if stats is not None:
        with stats:
            rep = eng.run(reqs, drain=True)
    else:
        rep = eng.run(reqs, drain=True)
    torch.cuda.synchronize()
    launches = K.tp_combine.launches
    others = {"masked_avg_grid": K.masked_avg_grid.launches,
              "rwkv6": RK.rwkv6.launches, "rglru": GK.rglru.launches}
    model.decode_paged, model.prefill = decode, prefill
    peak = torch.cuda.max_memory_allocated() / 1e9
    for r in rep.requests:
        if len(r.generated) != r.max_new or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"{cfg.name} request {r.rid}: "
                                 f"{len(r.generated)} tokens {r.generated}")
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    steps = eng.chunk * rep.rounds
    sites = cfg.n_layers if cfg.is_moe else 2 * cfg.n_layers
    if launches != sites * steps or any(others.values()):
        raise AssertionError(f"{cfg.name}: {launches} TP-combine launches, "
                             f"want {sites} sites x {steps} steps; others "
                             f"{others}")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "weights_gb": _gb(params), "init_s": init_s,
           "requests": len(rep.requests), "prompt": load.prompt,
           "tokens": rep.tokens, "wall_s": rep.wall_s,
           "tokens_per_s": rep.tokens_per_s, "rounds": rep.rounds,
           "prefills": rep.prefills, "decode_steps": steps,
           # the prefills' time, each synchronised; the rest of the wall
           # (the decode rounds and the host's scheduling) per step
           "prefill_s": prefill_s,
           "decode_ms_per_step": (rep.wall_s - prefill_s) * 1e3 / steps,
           "tp_combine_launches": launches, "peak_memory_gb": peak}
    if stats is not None:
        out.update(stats.summary())
    # layer 0's route against full attention, on the first prompt
    layer0 = params["layers"][0]
    x = LM.rms_norm(LM.embed(params["embed"], torch.as_tensor(
        reqs[0].prompt[None, :], device="cuda")), layer0["ln1"])
    attn = layer0["attn"]
    window = T.window_of(model.kinds[0])
    del model, params, eng, layer0, decode, prefill
    torch.cuda.empty_cache()
    if load.route != "full":
        out["route_max_abs_err"] = route_vs_full(attn, x, cfg, window,
                                                 load.route)
    out["route"] = load.route
    del attn, x
    torch.cuda.empty_cache()
    return out


def tp_widths(gen: torch.Generator) -> dict:
    """The TP-combine kernel at the new configs' widths, n = 4, (8, 1, d)
    f32 partials, the f32 wire, Bernoulli p = 0.1 masks: bit for bit
    against its plain version on integer partials and against the
    exchange route on normal ones (within 1e-6 of the plain version
    there), then timed as row 1' is (a CUDA graph between events) beside
    its plain version and its bytes bound."""
    out = {}
    for arch, d in TP_WIDTHS:
        cfg = get_config(arch)
        B, n = 8, 4
        tp = make_tp_context(TPDecodeConfig(n_shards=n, p=0.1), cfg, B)
        masks, _ = tp.sample_site_masks(gen, None)
        g = tp.geometry
        site = 1

        def plain(x):
            return tp_combine_ref(x, masks[0], masks[1], site, n=n,
                                  receiver=tp.receiver, s=g.s, blk=g.blk,
                                  pad=g.pad, wire_dtype=tp.wire_dtype)

        xi = tp_partials(gen, n, B, d, torch.float32, True, False)
        if not torch.equal(_bits(tp._exchange(xi, masks, site)),
                           _bits(plain(xi).contiguous())):
            raise AssertionError(f"tp_combine d {d}: integer partials not "
                                 f"bit for bit with the plain version")
        x = torch.randn((n, B, 1, d), generator=gen, device="cuda")
        got = tp._exchange(x, masks, site)
        if not torch.equal(_bits(got),
                           _bits(tp._exchange_global(x, masks,
                                                     site).contiguous())):
            raise AssertionError(f"tp_combine d {d}: not bit for bit with "
                                 f"the exchange route")
        err = (got - plain(x)).abs().max().item()
        if err > TP_TOL[torch.float32]:
            raise AssertionError(f"tp_combine d {d}: {err} from the plain "
                                 f"version")
        flops, nbytes = kernel_cost("tp_combine", x, masks[0], masks[1],
                                    site, n=n, receiver=tp.receiver,
                                    plan_geometry=g)
        bound_s, bound_by = kernel_bound("tp_combine", flops, nbytes)
        out[str(d)] = {
            "arch": arch, "ms": device_ms(lambda: tp._exchange(x, masks,
                                                               site)),
            "plain_ms": device_ms(lambda: plain(x)),
            "unfused_ms": device_ms(lambda: tp._exchange_global(x, masks,
                                                                site)),
            "max_abs_err_vs_plain": err,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": nbytes}
    return out


def _ring_plain_exchange(stacks_meta: dict, scfg) -> int:
    """One model-mode exchange at the shapes and dtypes of the first
    layer of every kind of the run's replicas (``stacks_meta``: the
    stacked layer subtrees on the meta device, ``{"layers": ...}`` and the
    audio model's ``"enc_layers"``) on the ring engine, through ring.cu
    and through its plain version on the card, with the same masks: bit
    for bit. The replicas are integer-valued and differ from worker to
    worker (the trained ones may have reached consensus, where a masked
    average is blind to its masks). Returns the elements compared."""
    n = scfg.n_workers
    gen = torch.Generator(device="cuda").manual_seed(360)
    sub = {name: tree_lib.map(
        lambda x: torch.randint(-8, 9, (n, 1) + tuple(x.shape[2:]),
                                generator=gen, device="cuda",
                                dtype=x.dtype), stack)
           for name, stack in stacks_meta.items()}
    if all(torch.equal(x[0], x[1]) for x in tree_lib.leaves(sub)):
        raise AssertionError("ring exchange: the replicas are equal")
    plan = make_exchange_plan(tree_lib.map(lambda x: x[0], sub), scfg)
    masks = rps_lib.sample_masks(torch.Generator(device="cuda").manual_seed(
        36), n, scfg.drop_rate, plan.s, n_buckets=plan.n_buckets)

    def exchange():
        return tree_lib.leaves(rps_lib.rps_exchange_global(
            sub, None, scfg.drop_rate, n, mode="model", masks=masks,
            plan=plan, engine="ring"))

    card = exchange()
    kernel = rps_lib.ops.ring_round
    rps_lib.ops.ring_round = functools.partial(kernel, backend="ref")
    try:
        plain = exchange()
    finally:
        rps_lib.ops.ring_round = kernel
    for a, b in zip(card, plain):
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError("ring exchange: ring.cu differs from its "
                                 "plain version")
    return sum(x.numel() for x in card)


def train_families() -> dict:
    """Phase 36: ``launch/train.py``'s path (``train_launcher.main``) at
    full width on the char-LM task (its vocabulary 256), ring engine,
    p = 0.1, seq 512, batch 2, 4 steps: rwkv6-1.6b whole at n = 4,
    recurrentgemma-9b cut to one repeat of its block pattern at n = 2,
    mixtral-8x22b cut to one layer at n = 2. Checks finite losses and
    consensus, ring launches = groups x steps, no RWKV-6 or RG-LRU kernel launch (the train kinds
    take the reference's XLA routes), and one exchange at the first
    layers' shapes, on integer replicas that differ from worker to
    worker, bit for bit against ring.cu's plain version."""
    out = {}
    for arch, layers, n in TRAIN_RUNS:
        args = ["--arch", arch, "--workers", str(n)] + TRAIN_ARGS
        if layers is not None:
            args += ["--layers", str(layers)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        h = train_launcher.main(args)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {"ring": RG.ring_round.launches,
                    "rwkv6": RK.rwkv6.launches, "rglru": GK.rglru.launches,
                    "tp_combine": K.tp_combine.launches,
                    "masked_avg_grid": K.masked_avg_grid.launches}
        cfg = _full_config(arch, layers)
        one = tree_lib.map(lambda x: x[0], h["params"])
        scfg = SimulatorConfig(n_workers=n, drop_rate=0.1, engine="ring")
        groups = len(rps_lib._global_groups(make_exchange_plan(one, scfg)))
        steps = len(h["step_s"])
        if not (all(np.isfinite(h["loss"]))
                and all(np.isfinite(h["consensus"]))):
            raise AssertionError(f"{arch}: losses {h['loss']}, consensus "
                                 f"{h['consensus']}")
        if launches["ring"] != groups * steps or any(
                v for k, v in launches.items() if k != "ring"):
            raise AssertionError(f"{arch}: launches {launches}, want "
                                 f"{groups} groups x {steps} steps of the "
                                 f"ring kernel alone")
        per_worker = sum(x.numel() for x in tree_lib.leaves(one))
        layers_meta = tree_lib.map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
            h.pop("params")["layers"])
        del one, h["state"], h["ef_state"]   # the card's memory for the check
        torch.cuda.empty_cache()
        compared = _ring_plain_exchange({"layers": layers_meta}, scfg)
        out[arch] = {"layers": cfg.n_layers, "workers": n,
                     "params_per_worker": per_worker,
                     "loss": h["loss"], "consensus": h["consensus"],
                     "first_step_ms": h["step_s"][0] * 1e3,
                     "step_ms": [t * 1e3 for t in h["step_s"][1:]],
                     "wall_s": wall, "peak_memory_gb": peak,
                     "groups": groups, "launches": launches,
                     "exchange_elements_bitwise": compared}
        del h
        print(json.dumps({"train_family": out[arch], "arch": arch}),
              flush=True)
    return out


def new_phases(gen: torch.Generator, card: str, lap: Laps) -> dict:
    """Phases 32-36, each printing its line; returns the launches they add
    to the kernels' line."""
    tp_launches = 0
    for phase, load in (("32", DEEPSEEK_LOAD), ("33", STARCODER_LOAD),
                        ("34", LLAMA_LOAD), ("35a", MIXTRAL_LOAD),
                        ("35b", KIMI_LOAD)):
        got = serve_full(load, gen)
        tp_launches += got["tp_combine_launches"]
        print(json.dumps({"serve_full": got, "phase": phase, "card": card}),
              flush=True)
        lap(phase)
    widths = tp_widths(gen)
    print(json.dumps({"tp_combine_widths": widths, "card": card}),
          flush=True)
    lap("35c")
    fams = train_families()
    print(json.dumps({"train_families": fams, "card": card}), flush=True)
    lap("36")
    return {"tp_combine_launches": tp_launches,
            "ring_launches": sum(v["launches"]["ring"]
                                 for v in fams.values())}


# ---- phases 37-39: the audio and vlm families ------------------------------


@dataclasses.dataclass(frozen=True)
class LegacyLoad:
    """A full-width static-batch phase through launch/serve.py's legacy
    path: ``batch`` prompts of ``prompt`` tokens (with the family's
    patches or frames, drawn after them from the launcher's generator),
    ``new`` greedy tokens each; the teacher-forced check runs an f32 copy of the first ``f32_layers``
    decoder layers (None: all) beside the bf16 model."""
    arch: str
    batch: int
    prompt: int
    new: int
    f32_layers: Optional[int]


# phase 37: whisper's 30-second window, 1,500 frames after its stride-2
# conv; the launcher draws prompt_len // 2 frames (the reference's
# coupling), so its 3,000-token prompts are a stress shape of the decoder
# (chunked route) beyond its 448-token context. The encoder stays on the
# full route. WHISPER_CONTEXT is the decoder's context: the phase also
# serves the 1,500 frames with prompts of WHISPER_CONTEXT - new tokens,
# whisper's own serving shape, through ServeEngine.
WHISPER_CONTEXT = 448
WHISPER_LOAD = LegacyLoad("whisper-large-v3", 8, 3000, 32, None)
# phase 38: 3,520 tokens + 576 patches = 4,096 = Mistral's window, where
# the contiguous ring buffer is right; the chunked route, windowed
LLAVA_LOAD = LegacyLoad("llava-next-mistral-7b", 8, 3520, 32, 2)
# phase 39: (arch, decoder layers (None: whole), n, batch, S) through
# run_simulation on a make_batch stream: whisper at its 448-token context
# (224 frames), llava at 576 patches + 512 tokens
MM_TRAIN_RUNS = (("whisper-large-v3", None, 4, 2, 448),
                 ("llava-next-mistral-7b", 2, 4, 2, 1088))
MM_TRAIN = dict(aggregator="rps_model", drop_rate=0.1, engine="ring",
                steps=4, eval_every=1)


def _extra(cfg: ArchConfig, B: int, S: int, gen: torch.Generator) -> dict:
    """The family's extra inputs for B prompts of S tokens: the vlm's
    patches, the audio model's S // r frames (normal x 0.02)."""
    if cfg.family == "vlm":
        shape, key = (B, cfg.n_patches, cfg.d_model), "patches"
    else:
        shape, key = (B, S // cfg.enc_frames_ratio, cfg.d_model), "frames"
    x = torch.randn(shape, generator=gen, device="cuda") * 0.02
    return {key: x.to(cfg.torch_dtype)}


def _f32_model(model, params, layers: Optional[int]):
    """An f32 copy of ``model`` cut to its first ``layers`` decoder layers
    (None: all), the encoder stack whole."""
    cfg = model.cfg
    n32 = layers or cfg.n_layers
    model32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              n_layers=n32), device="cuda")
    params32 = {"embed": _f32(params["embed"]),
                "layers": [_f32(layer) for layer in params["layers"][:n32]]}
    if "enc_layers" in params:
        params32["enc_layers"] = [_f32(layer)
                                  for layer in params["enc_layers"]]
    return model32, params32


def engine_teacher_forced(model, params, gen: torch.Generator,
                          load: LegacyLoad, steps: int = 4) -> dict:
    """Phases 37-38's prefill against decode, through ServeEngine: the
    engine prefills 2 prompts of ``load.prompt`` tokens (with their
    patches or frames) and decodes ``steps`` tokens, each decode step's
    token replaced by the next of a random continuation (teacher
    forcing); its last decode logits against those of one prefill of the
    prompt plus the continuation. The engine picks the decode positions,
    so a decode that starts at the wrong position (the reference's at
    the vlm: S where prefill wrote S + n_patches rows) fails here. The
    bf16 model at PREFILL_DECODE_TOL["bfloat16"], an f32 copy (the first
    ``load.f32_layers`` decoder layers) at PREFILL_DECODE_TOL["float32"],
    as phases 8 and 12. Then layer 0's decoder route against full
    attention on the first prompt (:func:`route_vs_full`)."""
    cfg = model.cfg
    S = load.prompt
    P = model.prefix_len
    toks = torch.randint(0, cfg.vocab_size, (2, S + steps), generator=gen,
                         device="cuda")
    extra = _extra(cfg, 2, S, gen)
    model32, params32 = _f32_model(model, params, load.f32_layers)
    out = {"steps": steps, "prompt_len": S, "patches": P,
           "f32_layers": model32.cfg.n_layers}
    for name, m, p in (("bfloat16", model, params),
                       ("float32", model32, params32)):
        want, _ = m.prefill(p, {"tokens": toks, **extra})
        decode, seen, last = m.decode_step, [], []

        def forced(prm, cache, inputs, pos, decode=decode, seen=seen,
                   last=last):
            i = len(seen)
            seen.append(int(pos))
            logits, cache = decode(prm, cache,
                                   {"token": toks[:, S + i:S + i + 1]}, pos)
            last[:] = [logits]
            return logits, cache

        m.decode_step = forced
        try:
            ServeEngine(m, p, max_len=S + P + steps).generate(
                toks[:, :S], steps, extra_inputs=extra)
        finally:
            m.decode_step = decode
        if seen != list(range(S + P, S + P + steps)):
            raise AssertionError(f"{cfg.name}: the engine decoded at "
                                 f"{seen}, want from {S + P}")
        g, w = last[0].float(), want.float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{cfg.name} {name}: non-finite logits")
        rel = ((g - w).norm() / w.norm()).item()
        tol = PREFILL_DECODE_TOL[name]
        if rel > tol:
            raise AssertionError(f"{cfg.name} {name} prefill vs decode "
                                 f"logits: relative RMS error {rel} > {tol}")
        out[name] = {"rel_rms": rel, "max_abs": (g - w).abs().max().item(),
                     "argmax_equal": bool((g.argmax(-1)
                                           == w.argmax(-1)).all()),
                     "tol_rel_rms": tol, "positions": seen}
    del model32, params32
    torch.cuda.empty_cache()
    layer0 = params["layers"][0]
    with torch.no_grad():
        x = LM.rms_norm(model.embed_inputs(params, {
            "tokens": toks[:1, :S], **{k: v[:1] for k, v in extra.items()}}),
            layer0["ln1"])
    window = T.window_of(model.kinds[0])
    out["route"] = LM.attention_route(x.shape[1], window, True)
    out["route_max_abs_err"] = route_vs_full(layer0["attn"], x, cfg, window,
                                             out["route"])
    del x
    torch.cuda.empty_cache()
    return out


def serve_legacy_full(load: LegacyLoad, gen: torch.Generator) -> dict:
    """Phases 37-38: ``load.arch`` whole at full width (random bf16
    weights from ``gen``) through launch/serve.py's legacy path
    (``_serve_legacy``: the launcher's prompts, then its patches or
    frames from the same numpy generator; ServeEngine with
    ``extra_inputs``). Checks the tokens, every prefill and decode logit
    finite, the encoder run once per generate (whisper; decode reads the
    cross K/V from the cache), and no kernel launch (the reference serves
    these families on the static engine without TP). Times the encoder,
    the decoder's prefill (the prefill less the encoder) and the decode
    steps, each between synchronisations. Whisper then serves the same
    1,500 frames at its own context (``context_reading``: prompts of
    WHISPER_CONTEXT - ``load.new`` tokens, timed alike). Last,
    :func:`engine_teacher_forced`."""
    cfg = get_config(load.arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    times = {"encode": [], "prefill": [], "decode_step": []}
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def timed(name, fn):
        def call(*args, **kwargs):
            nonlocal finite
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            if name != "encode":
                finite = finite & torch.isfinite(res[0]).all()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return res
        return call

    def run(fn):
        """``fn()`` with the model's calls timed into ``times`` (emptied
        first); returns its result and wall."""
        for name in times:
            times[name].clear()
            setattr(model, name, timed(name, getattr(model, name)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            for name in times:
                delattr(model, name)

    def split(wall) -> dict:
        enc_s = sum(times["encode"])
        return {"encoder_ms": enc_s * 1e3,
                "encoder_runs": len(times["encode"]),
                "decoder_prefill_ms": (times["prefill"][0] - enc_s) * 1e3,
                "decode_ms_per_step":
                    1e3 * sum(times["decode_step"]) / load.new,
                "wall_s": wall, "tokens_per_s": load.batch * load.new / wall}

    args = argparse.Namespace(batch=load.batch, prompt_len=load.prompt,
                              new_tokens=load.new, temperature=0.0)
    reset_counts()
    tokens, wall = run(lambda: serve_launcher._serve_legacy(
        args, model, params, torch.cuda.get_device_name(0)))
    launches = {"masked_avg_grid": K.masked_avg_grid.launches,
                "tp_combine": K.tp_combine.launches,
                "rwkv6": RK.rwkv6.launches, "rglru": GK.rglru.launches,
                "ring": RG.ring_round.launches,
                "ring_enc": RG.ring_round_enc.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if tuple(tokens.shape) != (load.batch, load.new) or int(tokens.min()) \
            < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(tokens.shape)} in "
                             f"[{int(tokens.min())}, {int(tokens.max())}]")
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    encodes = len(times["encode"])
    if len(times["prefill"]) != 1 or len(times["decode_step"]) != load.new \
            or encodes != (1 if cfg.family == "audio" else 0):
        raise AssertionError(f"{cfg.name}: {len(times['prefill'])} "
                             f"prefills, {encodes} encoder runs, "
                             f"{len(times['decode_step'])} decode steps")
    if any(launches.values()):
        raise AssertionError(f"{cfg.name}: kernel launches {launches}")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "weights_gb": _gb(params),
           "init_s": init_s, "batch": load.batch, "prompt": load.prompt,
           "patches": model.prefix_len,
           "frames": load.prompt // cfg.enc_frames_ratio
           if cfg.family == "audio" else 0,
           "new_tokens": load.new, **split(wall),
           "peak_memory_gb": peak, "launches": launches}
    if cfg.family == "audio":
        S = WHISPER_CONTEXT - load.new
        prompts = torch.randint(0, cfg.vocab_size, (load.batch, S),
                                generator=gen, device="cuda")
        frames = _extra(cfg, load.batch, load.prompt, gen)
        eng = ServeEngine(model, params, max_len=WHISPER_CONTEXT)
        ctx, ctx_wall = run(lambda: eng.generate(prompts, load.new,
                                                 extra_inputs=frames))
        if tuple(ctx.shape) != (load.batch, load.new) or not bool(finite) \
                or len(times["encode"]) != 1:
            raise AssertionError(f"{cfg.name} at its context: tokens "
                                 f"{tuple(ctx.shape)}, finite "
                                 f"{bool(finite)}, {len(times['encode'])} "
                                 f"encoder runs")
        out["context_reading"] = {"prompt": S,
                                  "frames": frames["frames"].shape[1],
                                  **split(ctx_wall)}
        del prompts, frames, eng, ctx
    out["prefill_vs_decode"] = engine_teacher_forced(model, params, gen,
                                                     load)
    del model, params
    torch.cuda.empty_cache()
    return out


def _stacked_batches(cfg: ArchConfig, n: int, B: int, S: int,
                     steps: int) -> list:
    """models/inputs.py's make_batch stream, made before the run: step t's
    worker i draws seed t * n + i."""
    out = []
    for t in range(steps):
        parts = [inputs_lib.make_batch(cfg, B, S, seed=t * n + i,
                                       device="cuda") for i in range(n)]
        out.append({k: torch.stack([b[k] for b in parts]) for k in parts[0]})
    return out


def train_multimodal() -> dict:
    """Phase 39: run_simulation on the ring engine (rps_model, p = 0.1, 4
    steps, SGD at the simulator's default lr) on a make_batch stream:
    whisper-large-v3 whole at n = 4 (decoder seq 448, 224 frames, batch
    2) and llava-next-mistral-7b at full width cut to 2 layers at n = 4
    (576 patches + 512 tokens, batch 2). Checks finite losses and
    consensus, ring launches = groups x steps and no other kernel, and
    one exchange at the first layer of every kind (the encoder stack's
    included), on integer replicas that differ from worker to worker,
    bit for bit against ring.cu's plain version on the card. Step ms and
    peak memory."""
    out = {}
    for arch, layers, n, B, S in MM_TRAIN_RUNS:
        cfg = _full_config(arch, layers)
        model = build_model(cfg, device="cuda")
        scfg = SimulatorConfig(n_workers=n, **MM_TRAIN)
        steps = scfg.steps
        t0 = time.perf_counter()
        batches = _stacked_batches(cfg, n, B, S, steps)
        data_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        h = run_simulation(lambda p, b: model.loss(p, b)[0],
                           model.init_stacked, lambda t: batches[t], scfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {"ring": RG.ring_round.launches,
                    "ring_enc": RG.ring_round_enc.launches,
                    "rwkv6": RK.rwkv6.launches, "rglru": GK.rglru.launches,
                    "tp_combine": K.tp_combine.launches,
                    "masked_avg_grid": K.masked_avg_grid.launches}
        params = h.pop("params")
        one = tree_lib.map(lambda x: x[0], params)
        groups = len(rps_lib._global_groups(make_exchange_plan(one, scfg)))
        per_worker = sum(x.numel() for x in tree_lib.leaves(one))
        if not (all(np.isfinite(h["loss"]))
                and all(np.isfinite(h["consensus"]))):
            raise AssertionError(f"{arch}: losses {h['loss']}, consensus "
                                 f"{h['consensus']}")
        if launches["ring"] != groups * steps or any(
                v for k, v in launches.items() if k != "ring"):
            raise AssertionError(f"{arch}: launches {launches}, want "
                                 f"{groups} groups x {steps} steps of the "
                                 f"ring kernel alone")
        stacks = {k: tree_lib.map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), v)
            for k, v in params.items() if k != "embed"}
        del one, params, h["state"], h["ef_state"], batches
        torch.cuda.empty_cache()
        compared = _ring_plain_exchange(stacks, scfg)
        out[arch] = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
                     "workers": n, "batch": B, "seq": S,
                     "params_per_worker": per_worker, "data_s": data_s,
                     "loss": h["loss"], "consensus": h["consensus"],
                     "first_step_ms": h["step_s"][0] * 1e3,
                     "step_ms": [t * 1e3 for t in h["step_s"][1:]],
                     "wall_s": wall, "peak_memory_gb": peak,
                     "groups": groups, "launches": launches,
                     "exchange_stacks": sorted(stacks),
                     "exchange_elements_bitwise": compared}
        del h, model
        torch.cuda.empty_cache()
        print(json.dumps({"train_multimodal": out[arch], "arch": arch}),
              flush=True)
    return out


def mm_phases(gen: torch.Generator, card: str, lap: Laps) -> dict:
    """Phases 37-39, each printing its line; returns the ring launches
    they add to the kernels' line."""
    for phase, load in (("37", WHISPER_LOAD), ("38", LLAVA_LOAD)):
        got = serve_legacy_full(load, gen)
        print(json.dumps({"serve_legacy_full": got, "phase": phase,
                          "card": card}), flush=True)
        lap(phase)
    mm = train_multimodal()
    print(json.dumps({"train_multimodal": mm, "card": card}), flush=True)
    lap("39")
    return {"ring_launches": sum(v["launches"]["ring"] for v in mm.values())}

# ---- phases 40-41: the collective path, 4 ranks on the card ---------------

COLL_N = 4                     # ranks, all on cuda:0 (gloo, host-staged)
COLL_THREADS = 2               # torch threads a rank (8 cores / 4 ranks)
# the trainer's load: rps-100m whole on a (4,) data mesh
COLL_LOAD = dict(n=COLL_N, batch=32, seq=128, lr=0.3, p=0.1, steps=8)
COLL_SEED = 4000
# the trainer against run_simulation on the same init, batches and masks:
# the losses within COLL_TRAIN_TOL; the final parameters bit for bit on
# the ring engine (f32; the two compute each rank's gradient with the same
# kernels, and the ring's adds are the same in both), within
# COLL_TRAIN_TOL on the xla engine (it sums on the host in gloo's order
# where the simulator's masked-average kernel sums in its own)
COLL_TRAIN_TOL = 1e-4
# ring_rank.cu's sweep: (k, W) chunk shapes, (1, 7,077,888) rps-100m's
# largest bucket chunk at n = 4 (one row of its (12, 768, 3072) MLP leaf).
# At 132 SMs the re-encoding hop splits the rows of the last four over
# many blocks: 16 a row at (2, 65536), 264 at (1, 7,077,888), 16 columns a
# thread; 244 at (1, 1,000,003) (W not a multiple of 16) and 73 at (3,
# 300,001) (k = 3, odd W: misaligned rows), a column a thread
RANK_SHAPES = ((1, 1), (1, 33), (3, 4097), (2, 65536), (1, 1_000_003),
               (3, 300_001), (1, 7_077_888))
# the re-encoding hop's timing: input sets rotated so that a launch finds
# its inputs cold (at least RANK_COLD_BYTES between two uses of a set)
RANK_COLD_BYTES = 100_000_000
RANK_MAX_SETS = 64


def _nan_eq(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of a and b whose bits differ (NaN equal to NaN)."""
    if a.dtype == torch.int8:
        return int((a != b).sum())
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def requant_edges(gen: torch.Generator, k: int, W: int, n: int) -> list:
    """(name, src, src_scale, rs, recv, recv_scale) of the re-encoding
    hop's edge cases at chunk 0 of an (n k, W) int8 table: ``tail_inf``
    and ``tail_nan``, rows scaled so that |q| <= 50 stays finite and 127
    overflows, with one overflowing column, the row's last, in the chunk
    (and, for tail_nan, its opposite in the received partial: inf - inf);
    ``zero``, all-zero chunk rows and partial (D = 1 / levels)."""
    S = n * k
    huge = 3.4e36                      # 100 * huge < FLT_MAX < 127 * huge
    rs = torch.ones(S, dtype=torch.uint8, device="cuda")
    out = []
    for name in ("tail_inf", "tail_nan", "zero"):
        src = torch.randint(-50, 51, (S, W), generator=gen, device="cuda",
                            dtype=torch.int8)
        recv = torch.randint(-50, 51, (k, W), generator=gen, device="cuda",
                             dtype=torch.int8)
        ssc = torch.full((S,), huge, device="cuda")
        rsc = torch.full((k,), huge, device="cuda")
        if name == "zero":
            src[:k] = 0
            recv.zero_()
        else:
            src[:k, -1] = 127
            if name == "tail_nan":
                recv[:, -1] = -127
        out.append((name, src, ssc, rs, recv, rsc))
    return out


def check_ring_rank(gen: torch.Generator) -> dict:
    """Phase 40a: ring_rank.cu's hop and landing against their plain
    versions (kernels/ref.py) on the card, bit for bit (NaN equal to NaN):
    (k, W) in RANK_SHAPES x S = 4k rows x every chunk of 4 x payload f32 /
    bf16 x accumulation f32 / bf16 x the first, a middle and the last hop,
    and the int8 wire (levels 127; middle hops re-encode, the last
    divides) with f32 / bf16 payloads; masks with drops; a row of
    non-finite values in every table (NaN and inf in the linear tables,
    in the int8 scales on the int8 wire) beside normal rows; the
    re-encoding hop's edge cases (requant_edges: an inf or a NaN only in
    the row's last column, all-zero rows; first and middle hop); then the
    landing in both renorm settings."""
    from repro_torch.kernels import ref as R
    cases = bad = 0
    n = 4
    for k, W in RANK_SHAPES:
        S = k * n
        big = W > 100_000
        rs = (torch.rand(S, generator=gen, device="cuda") < 0.7).to(torch.uint8)
        div = torch.randint(1, n + 1, (S,), generator=gen,
                            device="cuda").float()
        variants = [(pt, at, 0) for pt in (torch.float32, torch.bfloat16)
                    for at in (torch.float32, torch.bfloat16)]
        variants += [(pt, torch.float32, 127)
                     for pt in (torch.float32, torch.bfloat16)]
        for pt, at, levels in (variants[:1] + variants[-1:] if big
                               else variants):
            if levels:
                src = torch.randint(-127, 128, (S, W), generator=gen,
                                    device="cuda", dtype=torch.int8)
                ssc = torch.rand(S, generator=gen, device="cuda") * 0.1
                ssc[0] = float("inf")
                recv = torch.randint(-127, 128, (k, W), generator=gen,
                                     device="cuda", dtype=torch.int8)
                rsc = torch.rand(k, generator=gen, device="cuda") * 0.5
                if k > 1:
                    rsc[1] = float("nan")
            else:
                src = torch.randn((S, W), generator=gen,
                                  device="cuda").to(pt)
                src[0, 0] = float("nan")
                src[S - 1, -1] = float("inf")
                ssc = None
                recv = torch.randn((k, W), generator=gen,
                                   device="cuda").to(at)
                rsc = None
            for chunk in ((0, n - 1) if big else range(n)):
                hops = (("first", None, None, False),
                        ("middle", recv, rsc, False),
                        ("last", recv, rsc, True))
                for _, rv, rc, last in hops:
                    kw = dict(chunk=chunk, k=k, acc_dtype=at, out_dtype=pt,
                              levels=levels, last=last)
                    got = RG.ring_rank_hop(src, ssc, rs, rv, rc, div, **kw)
                    want = R.ring_rank_hop_ref(src, ssc, rs, rv, rc, div,
                                               **kw)
                    if isinstance(got, tuple):
                        bad += _nan_eq(got[0], want[0])
                        bad += _nan_eq(got[1], want[1])
                    else:
                        bad += _nan_eq(got, want)
                    cases += 1
        for _, src, ssc, rs_e, recv, rsc in requant_edges(gen, k, W, n):
            for rv, rc in ((None, None), (recv, rsc)):
                kw = dict(chunk=0, k=k, levels=127)
                got = RG.ring_rank_hop(src, ssc, rs_e, rv, rc, div, **kw)
                want = R.ring_rank_hop_ref(src, ssc, rs_e, rv, rc, div, **kw)
                bad += _nan_eq(got[0], want[0]) + _nan_eq(got[1], want[1])
                cases += 1
        cur = torch.randn((k, W), generator=gen, device="cuda")
        blocks = torch.randn((S, W), generator=gen, device="cuda")
        ag = torch.rand(S, generator=gen, device="cuda") < 0.7
        for renorm in (True, False):
            got = torch.full_like(blocks, 7.0)
            want = got.clone()
            for chunk in range(n):
                RG.ring_rank_land(got, cur, ag, blocks, chunk=chunk, k=k,
                                  renorm=renorm)
                R.ring_rank_land_ref(want, cur, ag, blocks, chunk=chunk, k=k,
                                     renorm=renorm)
            bad += _nan_eq(got, want)
            cases += 1
    if bad:
        raise AssertionError(f"ring_rank.cu: {bad} elements differ from its "
                             f"plain version over {cases} cases")
    return {"cases": cases, "differing_elements": bad}


def exchange_chunks(n: int = COLL_N) -> dict:
    """{(k, W): buckets} of the chunks one rank's ring takes in phase
    40c's exchange (rps-100m's per-leaf plan at n ranks)."""
    from repro_torch.core import plan as plan_lib
    model = build_model(RPS_100M, device="cuda")
    meta = tree_lib.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"),
                        model.init_stacked(torch.Generator(device="cuda")))
    plan = plan_lib.per_leaf_plan(meta, n)
    k = rps_lib._scatter_layout(n, plan.s)[0]
    return collections.Counter((k, b.blk * b.m) for b in plan.buckets)


def time_requant(gen: torch.Generator, k: int, W: int,
                 n: int = COLL_N) -> dict:
    """The int8 wire's re-encoding middle hop at chunk (k, W) (int8
    partial and chunk with their row scales in, the int8 partial and its
    scale out) and its plain version, each in a CUDA graph between CUDA
    events, over input sets rotated so that at least RANK_COLD_BYTES
    pass between two uses of one set (at most RANK_MAX_SETS sets): a
    launch at a wide chunk finds its inputs cold. Its bytes bound: the
    received partial and the chunk read once, the new partial written
    once, three row scales. Fails on a time under the bound (L2 served
    the inputs)."""
    from repro_torch.kernels import ref as R
    S = n * k

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    # the int8 partial and chunk with their scales in, the new partial and
    # its scale out
    flops, nbytes = kernel_cost(
        "ring_rank_hop", meta((S, W), torch.int8), meta((S,), torch.float32),
        meta((S,), torch.bool), meta((k, W), torch.int8),
        meta((k,), torch.float32), meta((S,), torch.float32), chunk=1 % n,
        k=k, levels=127)
    sets = min(RANK_MAX_SETS, max(8, -(-RANK_COLD_BYTES // nbytes)))
    rs = torch.ones(S, dtype=torch.bool, device="cuda")
    div = torch.full((S,), float(n), device="cuda")
    ins = [(torch.randint(-127, 128, (S, W), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(S, generator=gen, device="cuda") * 0.1,
            torch.randint(-127, 128, (k, W), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(k, generator=gen, device="cuda") * 0.5)
           for _ in range(sets)]
    kw = dict(chunk=1 % n, k=k, levels=127)

    def rotating(fn):
        it = itertools.cycle(ins)

        def call():
            q, qs, rq, rqs = next(it)
            return fn(q, qs, rs, rq, rqs, div, **kw)
        return call

    ms = device_ms(rotating(RG.ring_rank_hop), calls=sets, reps=5)
    plain_ms = device_ms(rotating(R.ring_rank_hop_ref), calls=sets, reps=2)
    bound_s, bound_by = kernel_bound("ring_rank_hop", flops, nbytes)
    bound_ms = bound_s * 1e3
    if ms < bound_ms:
        raise AssertionError(f"ring_rank.cu re-encoding hop at {(k, W)}: "
                             f"{ms} ms under its {bound_ms} ms bound: the "
                             "inputs came from L2")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, cols = RG.rank_requant_plan(k, W, sms)
    return {"shape": [k, W], "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "blocks": blocks, "cols": cols,
            "launches_per_hop": 1 if blocks == 1 else 2, "sets": sets,
            "cold_bytes": sets * nbytes}


def time_ring_rank(gen: torch.Generator, chunks: dict) -> dict:
    """Phase 40b: one middle hop (f32 received partial, f32 chunk, f32
    out) at the trainer's largest bucket chunk, and a landing, in a CUDA
    graph between CUDA events, beside the plain version, the plain chain
    ``where(rs, x, 0) + acc`` (no single PyTorch call computes a hop) and
    the bytes bounds (the hop: the partial and the chunk read once, the
    new partial written once; the landing with ag all on: the chunk read
    once and written once); then the int8 wire's re-encoding hop
    (time_requant) at every distinct chunk shape of phase 40c's exchange
    (``chunks``: {(k, W): buckets}), and the sum over one exchange's
    re-encoding hops (n - 1 a bucket), the kernel's and the plain
    version's."""
    from repro_torch.kernels import ref as R
    n = COLL_N
    k, W = max(chunks, key=lambda kw: kw[0] * kw[1])
    S = n * k
    src = torch.randn((S, W), generator=gen, device="cuda")
    recv = torch.randn((k, W), generator=gen, device="cuda")
    rs = torch.ones(S, dtype=torch.bool, device="cuda")
    div = torch.full((S,), 4.0, device="cuda")
    kw = dict(chunk=1, k=k, acc_dtype=torch.float32,
              out_dtype=torch.float32)
    hop_ms = device_ms(lambda: RG.ring_rank_hop(src, None, rs, recv, None,
                                                div, **kw))
    plain_ms = device_ms(lambda: R.ring_rank_hop_ref(src, None, rs, recv,
                                                     None, div, **kw))
    x = src[1:2]
    chain_ms = device_ms(lambda: torch.where(rs[1:2, None], x, 0.0) + recv)
    out = torch.empty_like(src)
    ag = torch.ones(S, dtype=torch.bool, device="cuda")
    land_ms = device_ms(lambda: RG.ring_rank_land(out, recv, ag, src,
                                                  chunk=1, k=k, renorm=True))
    # the hop: the partial and the chunk read, the new partial written;
    # the landing with ag all on: the chunk read and written
    flops, nbytes = kernel_cost("ring_rank_hop", src, None, rs, recv, None,
                                div, **kw)
    bound_s, bound_by = kernel_bound("ring_rank_hop", flops, nbytes)
    land_flops, land_bytes = kernel_cost("ring_rank_land", out, recv, ag,
                                         src, chunk=1, k=k, renorm=True)
    land_s, _ = kernel_bound("ring_rank_land", land_flops, land_bytes)
    del src, recv, out
    requant = {f"{kk}x{ww}": time_requant(gen, kk, ww)
               for kk, ww in sorted(chunks)}
    hops = sum(chunks.values()) * (n - 1)
    return {"shape": [k, W], "ms": hop_ms, "plain_ms": plain_ms,
            "plain_chain_ms": chain_ms, "land_ms": land_ms,
            "bytes": nbytes, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None,
            "land_bytes": land_bytes, "land_bound_ms": land_s * 1e3,
            "requant": requant[f"{k}x{W}"],
            "requant_shapes": requant,
            "requant_exchange": {
                "hops": hops,
                "buckets": {f"{kk}x{ww}": c
                            for (kk, ww), c in sorted(chunks.items())},
                "sum_ms": sum(c * (n - 1) * requant[f"{kk}x{ww}"]["ms"]
                              for (kk, ww), c in chunks.items()),
                "plain_sum_ms": sum(
                    c * (n - 1) * requant[f"{kk}x{ww}"]["plain_ms"]
                    for (kk, ww), c in chunks.items())}}


def _coll_tree(meta: dict, seed: int) -> dict:
    """A replica-shaped tree of normal values from ``seed`` on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tree_lib.map(lambda m: torch.randn(m.shape, generator=g,
                                              device="cuda").to(m.dtype),
                        meta)


def _coll_exchanges(mesh, rank: int, meta: dict, masks) -> dict:
    """Phase 40c (on every rank): the collective exchange of rps-100m's
    per-leaf plan at n = 4 (this rank's tree of normal values, ranks
    drawn from seeds of their own) against the port's global path on the
    stacked trees (every rank rebuilds the stack): the ring engine on the
    f32 and bf16 wires against ring.cu's stacked round, and on the int8
    wire against ring_q.cu's (the same uniforms: one (G, n, s, d) draw a
    group, each rank's bucket rows in its hook), bit for bit; the xla
    engine (renorm) against the masked-average kernel within
    COLL_TRAIN_TOL. Returns the differing elements and the launches."""
    from repro_torch.core import comm
    from repro_torch.core import plan as plan_lib
    n = COLL_N
    p = COLL_LOAD["p"]
    plan = plan_lib.per_leaf_plan(meta, n)
    stacked = tree_lib.map(lambda *xs: torch.stack(xs),
                           *[_coll_tree(meta, COLL_SEED + 1 + r)
                             for r in range(n)])
    mine = tree_lib.map(lambda x: x[rank].clone(), stacked)
    g = torch.Generator(device="cuda")
    g.manual_seed(COLL_SEED + 99)
    groups = rps_lib._global_groups(plan)
    uni = {}
    for g_idx, ((blk, m, _), idxs) in enumerate(groups.items()):
        uni[g_idx] = torch.rand((len(idxs), n, plan.s, blk * m),
                                generator=g, device="cuda")
    where = {b: (g_idx, pos) for g_idx, idxs in enumerate(groups.values())
             for pos, b in enumerate(idxs)}

    def rank_noise(b, shape):
        g_idx, pos = where[b]
        return uni[g_idx][pos, rank].reshape(shape)

    out = {}
    for wire in ("f32", "bf16", "int8"):
        kw = dict(masks=masks, engine="ring", wire=wire)
        reset_counts()
        comm.reset_stats()
        got = rps_lib.rps_exchange_plan(
            mine, None, p, "data", plan=plan, mesh=mesh,
            wire_noise=rank_noise if wire == "int8" else None, **kw)
        hops = RG.ring_rank_hop.launches
        staged = comm.STATS["staged_bytes"]
        want = rps_lib.rps_exchange_global(
            stacked, None, p, n, plan=plan,
            wire_noise=(lambda g_idx, shape: uni[g_idx]), **kw)
        diff = sum(_nan_eq(a, b[rank]) for a, b in
                   zip(tree_lib.leaves(got), tree_lib.leaves(want)))
        out[f"ring_{wire}"] = {"differing_elements": diff,
                               "hop_launches": hops,
                               "staged_bytes": staged}
        del got, want
    got = rps_lib.rps_exchange_plan(mine, None, p, "data", plan=plan,
                                    mesh=mesh, masks=masks, engine="xla")
    want = rps_lib.rps_exchange_global(stacked, None, p, n, plan=plan,
                                       masks=masks, engine="xla")
    err = max(float((a - b[rank]).abs().max()) for a, b in
              zip(tree_lib.leaves(got), tree_lib.leaves(want)))
    out["xla_f32"] = {"max_abs_err": err}
    return out


def _coll_train(mesh, rank: int, engine: str, masks: list, sim_params,
                batches: list) -> dict:
    """Phase 41 on one rank: the mesh trainer (rps_model, SGD) over
    COLL_LOAD's steps, its final parameters against the simulator's row
    ``rank`` (``sim_params``: the parent's stacked tree in shared host
    memory; CUDA IPC would leave the parent's blocks referenced when the
    ranks exit, and its exit then fails)."""
    from repro_torch.core import comm
    from repro_torch.train.trainer import TrainConfig, make_train_setup
    load = COLL_LOAD
    model = build_model(RPS_100M, device="cuda")
    tcfg = TrainConfig(lr=load["lr"], drop_rate=load["p"],
                       aggregator="rps_model", engine=engine)
    init_state, step, _ = make_train_setup(model, RPS_100M, tcfg, mesh,
                                           rps_axes=("data",))
    g = torch.Generator(device="cuda")
    g.manual_seed(COLL_SEED)
    params, opt_state = init_state(g)
    batches = [{k: v[rank].cuda() for k, v in b.items()} for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    comm.reset_stats()
    losses, step_ms = [], []
    with comm.recording() as records:
        for t in range(load["steps"]):
            t0 = time.perf_counter()
            params, opt_state, met = step(params, opt_state, batches[t], t,
                                          None, masks=masks[t])
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    err, diff = 0.0, 0
    for a, b in zip(tree_lib.leaves(params), tree_lib.leaves(sim_params)):
        b = b[rank].cuda()
        err = max(err, float((a - b).abs().max()))
        diff += _nan_eq(a, b)
    return {"loss": losses, "step_ms": step_ms,
            "hop_launches": RG.ring_rank_hop.launches,
            "land_launches": RG.ring_rank_land.launches,
            "other_launches": RG.ring_round.launches
            + RG.ring_round_enc.launches + K.masked_avg_grid.launches,
            "staged_bytes_per_step": comm.STATS["staged_bytes"]
            / load["steps"],
            "transfers_per_step": comm.STATS["transfers"] / load["steps"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_max_abs_err": err, "params_differing": diff,
            "device": str(tree_lib.leaves(params)[0].device),
            "n_buckets": step.plan.n_buckets,
            # every collective of the 8 steps, for phase 42c
            "records": records}


def _coll_rank(rank: int, world: int, masks40, masks41: list,
               sim: dict, batches: list) -> dict:
    """One rank of phases 40-41 (cuda:0, gloo)."""
    from repro_torch.launch.mesh import make_sim_mesh
    build.load_kernels()
    mesh = make_sim_mesh(world)
    masks40 = tuple(m.cuda() for m in masks40)
    masks41 = [tuple(m.cuda() for m in pair) for pair in masks41]
    model = build_model(RPS_100M, device="cuda")
    meta = tree_lib.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"),
                        model.init_stacked(torch.Generator(device="cuda")))
    del model
    t0 = time.perf_counter()
    ex = _coll_exchanges(mesh, rank, meta, masks40)
    ex_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    runs = {eng: _coll_train(mesh, rank, eng, masks41, sim[eng], batches)
            for eng in ("ring", "xla")}
    return {"exchanges": ex, "exchanges_s": ex_s, "train": runs,
            "backend": mesh.backend,
            "device": sorted({run["device"] for run in runs.values()})}


def coll_phases(gen: torch.Generator, card: str, lap: Laps,
                batches: Optional[list] = None) -> dict:
    """Phases 40-41: the collective path, four ranks on the one card over
    gloo (host-staged: comm.py copies each CUDA payload through pinned
    host buffers; NCCL refuses two ranks on one card, and asking for it
    raises), in one world of spawned processes.

    40. ring_rank.cu against its plain version (check_ring_rank), its
        time (time_ring_rank); then on every rank rps-100m's per-leaf
        plan exchanged collectively against the port's global path
        (_coll_exchanges: the ring engine bit for bit against ring.cu on
        the f32 and bf16 wires and against ring_q.cu on the int8 wire,
        the xla engine within COLL_TRAIN_TOL);
    41. the mesh trainer (train/trainer.py) at rps-100m whole (12 layers,
        d 768, f32, 129.0 M parameters a rank) on a (4,) data mesh, batch
        32 x seq 128 a rank, lr 0.3, p 0.1, 8 steps, on the ring and the
        xla engines, each against run_simulation (n 4) on the same init,
        batches and masks: every step's loss within COLL_TRAIN_TOL, every
        final parameter bit for bit on the ring engine and within
        COLL_TRAIN_TOL on the xla engine (bit equality counted); the
        batches are ``batches`` (worker-stacked, on the CPU: phase 17's
        first four workers' first 8 steps), else drawn from phase 17's
        char-LM task. Kernel launches: on the ring engine n = 4
        ring_rank_hop and 4 ring_rank_land launches per bucket and step
        on every rank (the plan's buckets x 8 steps x 4 each), on the xla
        engine none; the step ms, the bytes staged a step and the peak
        memory of each rank printed."""
    from repro_torch.launch.mesh import run_world
    load = COLL_LOAD
    n, steps = load["n"], load["steps"]
    rank_err = check_ring_rank(gen)
    rank_timing = time_ring_rank(gen, exchange_chunks(n))
    print(json.dumps({"ring_rank_check": rank_err,
                      "ring_rank_timing": rank_timing, "card": card}),
          flush=True)
    torch.cuda.empty_cache()
    lap("40a")
    # the simulator on the same init, batches and masks, before the world
    mg = torch.Generator(device="cuda")
    mg.manual_seed(COLL_SEED + 7)
    masks40 = tuple(m.cpu() for m in rps_lib.sample_masks(mg, n, load["p"]))
    masks41 = [tuple(m.cpu() for m in rps_lib.sample_masks(mg, n,
                                                           load["p"]))
               for _ in range(steps)]
    model = build_model(RPS_100M, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(COLL_SEED)
    p1 = model.init_stacked(g)
    if batches is None:
        task = CharLMTask(vocab=RPS_100M.vocab_size, seq_len=load["seq"],
                          seed=0)
        stream = make_worker_streams(task, n, load["batch"])
        batches = [{k: v.cpu() for k, v in stream(t).items()}
                   for t in range(steps)]
    sim, sim_out = {}, {}
    for eng in ("ring", "xla"):
        scfg = SimulatorConfig(n_workers=n, drop_rate=load["p"],
                               aggregator="rps_model", lr=load["lr"],
                               steps=steps, eval_every=1, engine=eng)
        h = run_simulation(lambda p, b: model.loss(p, b)[0], None,
                           lambda t: {k: v.cuda()
                                      for k, v in batches[t].items()},
                           scfg, init_params=p1,
                           masks_fn=lambda t: tuple(
                               m.cuda() for m in masks41[t]))
        sim[eng] = tree_lib.map(lambda x: x.cpu().share_memory_(),
                                h["params"])
        sim_out[eng] = {"loss": h["loss"],
                        "step_ms": [s * 1e3 for s in h["step_s"]]}
    del model, p1
    torch.cuda.empty_cache()
    lap("41-sim")
    try:                 # no silent switch of transport
        run_world(_coll_rank, n, backend="nccl", device="cuda:0")
    except ValueError:
        pass
    else:
        raise AssertionError("phase 40: nccl with 4 ranks on one card "
                             "did not raise")
    t0 = time.perf_counter()
    ranks = run_world(_coll_rank, n, masks40, masks41, sim, batches,
                      backend="gloo", device="cuda:0",
                      threads=COLL_THREADS, timeout_s=600)
    world_s = time.perf_counter() - t0
    del sim
    torch.cuda.empty_cache()
    for r, got in enumerate(ranks):
        if got["backend"] != "gloo" or got["device"] != ["cuda:0"]:
            raise AssertionError(f"rank {r}: transport {got['backend']} on "
                                 f"{got['device']}")
        ex = got["exchanges"]
        for wire in ("f32", "bf16", "int8"):
            if ex[f"ring_{wire}"]["differing_elements"]:
                raise AssertionError(f"phase 40 rank {r}: the {wire} ring "
                                     f"differs from the stacked round: "
                                     f"{ex[f'ring_{wire}']}")
        if not ex["xla_f32"]["max_abs_err"] <= COLL_TRAIN_TOL:
            raise AssertionError(f"phase 40 rank {r}: xla engine "
                                 f"{ex['xla_f32']}")
        for eng, run in got["train"].items():
            want = n * run["n_buckets"] * steps if eng == "ring" else 0
            if (run["hop_launches"], run["land_launches"]) != (want, want) \
                    or run["other_launches"]:
                raise AssertionError(f"phase 41 rank {r} {eng}: launches "
                                     f"{run['hop_launches']} / "
                                     f"{run['land_launches']} / "
                                     f"{run['other_launches']}, want {want}")
            lerr = max(abs(a - b) for a, b in zip(run["loss"],
                                                  sim_out[eng]["loss"]))
            run["loss_max_abs_err"] = lerr
            exact = eng == "ring" and run["params_differing"]
            if exact or not (np.all(np.isfinite(run["loss"]))
                             and lerr <= COLL_TRAIN_TOL
                             and run["params_max_abs_err"] <= COLL_TRAIN_TOL):
                raise AssertionError(f"phase 41 rank {r} {eng}: loss err "
                                     f"{lerr}, params err "
                                     f"{run['params_max_abs_err']}, "
                                     f"{run['params_differing']} params "
                                     "differ")
    summary = {
        "transport": "gloo, CUDA payloads staged through pinned host "
                     "buffers (core/comm.py), 4 ranks on cuda:0",
        "world_s": world_s, "simulator": sim_out,
        "exchanges": [got["exchanges"] for got in ranks],
        "exchanges_s": [got["exchanges_s"] for got in ranks],
        "train": {eng: {k: [got["train"][eng][k] for got in ranks]
                        for k in ("step_ms", "staged_bytes_per_step",
                                  "transfers_per_step", "peak_memory_gb",
                                  "params_max_abs_err", "params_differing",
                                  "hop_launches", "land_launches",
                                  "loss_max_abs_err")}
                  for eng in ("ring", "xla")},
        "loss": {eng: ranks[0]["train"][eng]["loss"]
                 for eng in ("ring", "xla")},
        "n_buckets": ranks[0]["train"]["ring"]["n_buckets"], **load}
    print(json.dumps({"collective": summary, "card": card}), flush=True)
    lap("40-41")
    return {"rank_err": rank_err, "rank_timing": rank_timing,
            "launches": sum(got["train"]["ring"]["hop_launches"]
                            + got["train"]["ring"]["land_launches"]
                            for got in ranks),
            "records": {eng: [got["train"][eng]["records"] for got in ranks]
                        for eng in ("ring", "xla")},
            "hop_launches": {eng: [got["train"][eng]["hop_launches"]
                                   for got in ranks]
                             for eng in ("ring", "xla")}}



# ---- phase 42: the dry-run and the roofline on the card's own constants ----

DRYRUN_MESHES = ("16x16", "2x16x16", "sim1")
# the dry-run's rows and 42c's counts run on meta tensors in this many
# spawned processes from the build on, beside phases 3-41 (~8 min of CPU
# time in all, most of it the train rows, which count every layer): three
# cores of the host's eight
DRYRUN_WORKERS = 3
SHARE_MAX = 1.05               # a share over it: the count is wrong
# the predicted peak (the count's resident bytes plus its peak of live
# ones) against torch.cuda.max_memory_allocated, relative
PEAK_BAND = 0.25
DRYRUN_STEPS = 5               # timed steps after DRYRUN_WARM, median
DRYRUN_WARM = 1


def _dryrun_row(row) -> dict:
    """One (arch, shape, mesh) row of the dry-run (a worker process)."""
    from repro_torch.launch import dryrun as D
    arch, shape, mesh = row
    return D.run_one(arch, shape, mesh=mesh, verbose=False)


def _dryrun_coll(args) -> dict:
    """Phase 42c's count of one rank's phase-41 step on the (4,) data
    mesh, meta tensors (a worker process)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.train.trainer import TrainConfig
    engine, rank = args
    load = COLL_LOAD
    tcfg = TrainConfig(lr=load["lr"], drop_rate=load["p"],
                       aggregator="rps_model", engine=engine)
    batch = {k: torch.empty((load["batch"], load["seq"]), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    tot = D.count_train_step(RPS_100M, tcfg, make_sim_mesh(load["n"]), batch,
                             rps_axes=("data",), rank=rank)
    return {"records": tot["records"], "kernels": tot["kernels"],
            "coll_by_op": tot["coll_by_op"]}


# 42a on this machine's torch: the dry-run's count of a deep stack from two
# and three periods of its layer kinds equals the count of every layer
# (reduced configs at six periods: kind, arch, B, S, decoder layers a
# period, encoder layers a period), and a train step counted with the
# ops made again from their signatures equals one that runs every op
DRYRUN_EXACT_CASES = (("prefill", "gemma3-1b-reduced", 2, 128, 6, 0),
                      ("decode", "gemma3-1b-reduced", 2, 128, 6, 0),
                      ("prefill", "deepseek-7b-reduced", 1, 4096, 1, 0),
                      ("prefill", "mixtral-8x22b-reduced", 2, 64, 1, 0),
                      ("prefill", "rwkv6-1.6b-reduced", 2, 384, 1, 0),
                      ("prefill", "recurrentgemma-9b-reduced", 2, 128, 3,
                       0),
                      ("prefill", "whisper-large-v3-reduced", 2, 64, 1, 1),
                      ("train", "mixtral-8x22b-reduced", 2, 64, 1, 0))


def _dryrun_exact(case) -> bool:
    """One of DRYRUN_EXACT_CASES (a worker process)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import count as count_lib
    kind, arch, B, S, layers, enc = case
    cfg = get_config(arch)
    if kind == "train":
        shape = ShapeConfig("t", S, B, kind)
        got = D.build_train_counted(cfg, shape, D.make_mesh("sim1"))[0]
        signature = count_lib._signature
        count_lib._signature = lambda *a: None
        try:
            return got == D.build_train_counted(cfg, shape,
                                                D.make_mesh("sim1"))[0]
        finally:
            count_lib._signature = signature
    cfg = dataclasses.replace(cfg, n_layers=6 * layers, enc_layers=6 * enc)
    whole = D._prefill_whole if kind == "prefill" else D._decode_whole
    return D.by_periods(cfg, lambda c: whole(c, B, S)) == whole(cfg, B, S)


def _dryrun_line(r: dict) -> str:
    head = f"dryrun {r['arch']:22s} {r['shape']:11s} {r['mesh']:8s}"
    if r["status"] == "ok":
        rl = r["roofline"]
        return (f"{head} t_comp {rl['t_compute'] * 1e3:12.3f} ms  t_mem "
                f"{rl['t_memory'] * 1e3:12.3f} ms  t_coll "
                f"{rl['t_collective'] * 1e3:9.3f} ms  {rl['bottleneck']:10s}"
                f" hbm/dev {rl['hbm_per_device'] / 1e9:10.2f} GB  fits "
                f"{'yes' if rl['fits'] else 'NO'}")
    info = r.get("info") or {}
    if "state_bytes" in info:
        ep = info["exchange_plan"] or {}
        state = info["state_bytes"]["total"] / 1e9
        return (f"{head} layout: state {state:.2f} GB over n_rps "
                f"{info['n_rps']}, microbatch "
                f"{info['microbatch']}, plan {ep.get('n_buckets')} buckets "
                f"x s {ep.get('s')}")
    return f"{head} {r['status'][:60]}"


def dryrun_sweep_check(rows: list) -> dict:
    """42a: every (arch x shape) on the production meshes (layout rows: the
    port's trainer runs neither TP inside a replica nor FSDP) and on one
    H100 (sim1, counted rows), each ok, layout only, or skipped with the
    reference's reason; the table printed."""
    bad = []
    for r in rows:
        st = str(r["status"])
        if st.startswith("skipped (full attention"):
            continue
        if r["mesh"] == "sim1" and st == "ok":
            continue
        if r["mesh"] != "sim1" and st.startswith("layout only"):
            continue
        bad.append((r["arch"], r["shape"], r["mesh"], st))
    for r in rows:
        print(_dryrun_line(r), flush=True)
    if bad:
        raise AssertionError(f"phase 42a: rows neither ok, layout nor "
                             f"skipped: {bad}")
    counted = [r for r in rows if r["status"] == "ok"]
    return {"rows": len(rows), "counted": len(counted),
            "layout": sum(str(r["status"]).startswith("layout only")
                          for r in rows),
            "skipped": sum(str(r["status"]).startswith("skipped")
                           for r in rows),
            "fits": sorted(f"{r['arch']}/{r['shape']}" for r in counted
                           if r["roofline"]["fits"]),
            "count_s": sum(r.get("compile_s", 0.0) for r in rows)}


def _time_steps(fn, base: int) -> tuple:
    """(median ms of DRYRUN_STEPS synchronised calls after DRYRUN_WARM,
    the peak of allocated bytes over them less ``base``, what earlier
    phases left allocated before the configuration was built)."""
    for _ in range(DRYRUN_WARM):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DRYRUN_STEPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), torch.cuda.max_memory_allocated() - base


def _vs_card(name: str, totals: dict, ms: float, peak: int, model_flops:
             float, kind: str) -> dict:
    """The dry-run's prediction beside the card's measurement: the
    roofline share (the largest term over the measured time) and the
    model FLOPs over (time x the peak of the model's kind); either over
    SHARE_MAX, or the peak of allocated bytes off the predicted one by
    more than PEAK_BAND, fails."""
    from repro_torch.roofline import analyze
    rep = analyze(name, "", "sim1", 1, totals, model_flops)
    bound_ms = max(rep.t_compute, rep.t_memory, rep.t_collective) * 1e3
    out = {"ms": ms, "t_compute_ms": rep.t_compute * 1e3,
           "t_memory_ms": rep.t_memory * 1e3,
           "t_collective_ms": rep.t_collective * 1e3,
           "bottleneck": rep.bottleneck, "bound_ms": bound_ms,
           "roofline_share": bound_ms / ms,
           "model_flops": model_flops, "model_flops_kind": kind,
           "model_flops_share": model_flops / (ms / 1e3 * H100.peak(kind)),
           "counted_flops": totals["flops"], "counted_bytes": totals["bytes"],
           "peak_predicted_gb": totals["hbm"] / 1e9,
           "peak_measured_gb": peak / 1e9,
           "peak_ratio": peak / totals["hbm"]}
    print(f"42b {name}: {ms:.3f} ms on the card; predicted t_comp "
          f"{out['t_compute_ms']:.3f} ms, t_mem {out['t_memory_ms']:.3f} ms "
          f"({rep.bottleneck}); roofline share "
          f"{out['roofline_share'] * 100:.1f} %, model FLOPs share "
          f"{out['model_flops_share'] * 100:.1f} % of {kind}; peak "
          f"{out['peak_measured_gb']:.3f} GB against "
          f"{out['peak_predicted_gb']:.3f} GB predicted", flush=True)
    if out["roofline_share"] > SHARE_MAX \
            or out["model_flops_share"] > SHARE_MAX:
        raise AssertionError(f"phase 42b {name}: a share over "
                             f"{SHARE_MAX}: {out}")
    if abs(out["peak_ratio"] - 1) > PEAK_BAND:
        raise AssertionError(f"phase 42b {name}: peak {peak / 1e9} GB, "
                             f"predicted {totals['hbm'] / 1e9} GB")
    return out


def _merge_totals(parts: list) -> dict:
    """Totals of calls run one after another: FLOPs and bytes summed, the
    peak the largest."""
    by: dict = {}
    for t in parts:
        for k, v in t["flops_by_kind"].items():
            by[k] = by.get(k, 0.0) + v
    return {"flops": sum(t["flops"] for t in parts),
            "flops_by_kind": by, "bytes": sum(t["bytes"] for t in parts),
            "coll": 0.0, "hbm": max(t["hbm"] for t in parts)}


def dryrun_vs_card(gen: torch.Generator) -> tuple:
    """42b: the dry-run's predictions
    against the card for three configurations it holds whole — one
    rps-100m worker's train step at its paper-scale load (32 x 128, f32,
    SGD, the mesh trainer on one rank), gemma3-1b's prefill of phase 4's
    8 prompts (each alone, bf16), its decode step at phase 4's batch (8
    lanes, a contiguous cache of the longest request's rows). Returns
    the results and the gemma3-1b model and weights (for 42d)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.train.trainer import make_train_setup
    out = {}
    load = RPS_100M_LOAD
    B, S = load["batch"], load["seq"]
    tcfg = D.train_config(RPS_100M, "rps_model", 1, lr=load["lr"],
                          drop_rate=load["p"], engine="ring")
    mesh = make_sim_mesh(1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(RPS_100M, device="cuda")
    init_state, step, _ = make_train_setup(model, RPS_100M, tcfg,
                                           mesh.as_rank(0),
                                           rps_axes=("data",))
    params, opt_state = init_state(gen)
    batch = {k: torch.randint(0, RPS_100M.vocab_size, (B, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    ms, peak = _time_steps(lambda: step(params, opt_state, batch, 0, gen),
                           base)
    del params, opt_state, batch, model
    meta = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    totals = D.count_train_step(RPS_100M, tcfg, mesh, meta,
                                rps_axes=("data",))
    n_active = RPS_100M.param_count(active_only=True)
    out["rps_100m_train"] = _vs_card("rps-100m train 32x128", totals, ms,
                                     peak, 6.0 * n_active * B * S, "f32")
    torch.cuda.empty_cache()

    cfg = get_config("gemma3-1b")
    base = torch.cuda.memory_allocated()
    model, params = init_model("gemma3-1b", gen)
    reqs = smoke_requests(cfg)
    prompts = [torch.as_tensor(r.prompt, dtype=torch.int32,
                               device="cuda")[None] for r in reqs]
    lens = [p.shape[1] for p in prompts]

    def prefill_all():
        with torch.no_grad():
            for p in prompts:
                model.prefill(params, {"tokens": p})

    ms, peak = _time_steps(prefill_all, base)
    totals = _merge_totals([D.count_prefill(cfg, 1, n)
                            for n in lens])
    n_active = cfg.param_count(active_only=True)
    out["gemma3_1b_prefill"] = _vs_card(
        "gemma3-1b prefill of phase 4's prompts", totals, ms, peak,
        2.0 * n_active * sum(lens), "bf16")
    out["gemma3_1b_prefill"]["prompt_lens"] = lens
    lanes = 8
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    cache = model.init_cache(lanes, max_len)
    tok = {"token": torch.randint(0, cfg.vocab_size, (lanes, 1),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)}

    def decode():
        with torch.no_grad():
            model.decode_step(params, cache, tok, max_len - 1)

    ms, peak = _time_steps(decode, base)
    del cache
    out["gemma3_1b_decode"] = _vs_card(
        "gemma3-1b decode step, 8 lanes", D.count_decode(
            cfg, lanes, max_len), ms, peak,
        2.0 * n_active * lanes, "bf16")
    out["gemma3_1b_decode"]["cache_rows"] = max_len
    return out, model, params


def dryrun_collectives(coll: dict, dry: dict) -> dict:
    """42c: phase 41's collectives (every rank, both engines, 8 steps)
    against the dry-run's count of one rank's step on the (4,) data mesh
    (``dry``: (engine, rank) -> its records): the same records step after
    step, so the same link bytes, exactly; and on the ring engine the
    counted ring_rank.cu calls x steps = the launches phase 41 counted."""
    from repro_torch.roofline import collective_bytes
    steps = COLL_LOAD["steps"]
    out = {}
    for eng in ("ring", "xla"):
        per_rank = []
        for r, run in enumerate(coll["records"][eng]):
            d = dry[(eng, r)]
            want = [tuple(x) for x in d["records"]] * steps
            got = [tuple(x) for x in run]
            if got != want:
                raise AssertionError(
                    f"phase 42c {eng} rank {r}: {len(got)} records, the "
                    f"dry-run's {len(d['records'])} x {steps} differ")
            run_bytes = collective_bytes(got)
            if run_bytes != collective_bytes(want):
                raise AssertionError(f"phase 42c {eng} rank {r}: bytes")
            hops = d["kernels"].get("ring_rank_hop", {}).get("calls", 0)
            if hops * steps != coll["hop_launches"][eng][r]:
                raise AssertionError(
                    f"phase 42c {eng} rank {r}: {hops} x {steps} counted "
                    f"hops, {coll['hop_launches'][eng][r]} launched")
            per_rank.append({"records_per_step": len(d["records"]),
                             "bytes_per_step": d["coll_by_op"],
                             "run_bytes": run_bytes})
        out[eng] = per_rank
        print(f"42c {eng}: {len(per_rank)} ranks x {steps} steps, the "
              f"dry-run's {per_rank[0]['records_per_step']} records a step "
              f"equal the run's; link bytes a step "
              f"{per_rank[0]['bytes_per_step']['total']:.0f}", flush=True)
    return out


def _profiled(fn, wrappers: dict) -> dict:
    """``launch_counts(fn)``: each hand-written kernel's profiler launches
    against its wrapper's counter over the same call (``wrappers``: name ->
    the wrapper whose ``.launches`` counts). A machine whose profiler
    traces no device event is reported, not failed."""
    from repro_torch.launch import launches as launches_lib
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        counts = launches_lib.launch_counts(fn)
    except RuntimeError as e:
        if "no device event" not in str(e):
            raise
        return {"profiler": "no device events"}
    got = launches_lib.kernel_launches(counts)
    want = {k: w.launches - before[k] for k, w in wrappers.items()}
    for k in wrappers:
        if got[k] != want[k]:
            raise AssertionError(f"phase 42d: the profiler saw {got[k]} "
                                 f"{k} launches, its wrapper counted "
                                 f"{want[k]}")
    return {"profiler": "device events", "launches": want,
            "kernels": sum(counts.values()),
            "hand_written": {k: v for k, v in got.items() if v}}


def profile_ring_step(setup, load=RPS_100M_LOAD) -> dict:
    """42d, run after phase 17 while its setup lives: one step of phase
    17's ring run (n 16, past no warm-up: the same step) under the
    profiler; ring.cu's launches there against ring_round's counter, and
    no masked average."""
    scfg = rps100m_config(load, steps=1)
    p1, batches = setup.p1, setup.batches
    torch.cuda.synchronize()
    return _profiled(lambda: run_simulation(setup.loss_fn, None,
                                            lambda t: batches[t], scfg,
                                            init_params=p1),
                     {"ring_round": RG.ring_round,
                      "masked_avg_grid": K.masked_avg_grid})


def profile_decode_step(model, params) -> dict:
    """42d: phase 4's serving run again (8 requests, 4-shard lossy TP),
    its third decode step under the profiler: the TP combine's launches
    there (52) against its counter."""
    cfg = model.cfg
    reqs = smoke_requests(cfg)
    eng = smoke_engine(model, params, reqs)
    decode = model.decode_paged
    seen = {"calls": 0, "profile": None}

    def decode_profiled(*args, **kwargs):
        seen["calls"] += 1
        if seen["calls"] != 3:
            return decode(*args, **kwargs)
        res = {}

        def one():
            res["out"] = decode(*args, **kwargs)
        seen["profile"] = _profiled(one, {"tp_combine": K.tp_combine})
        return res["out"] if "out" in res else decode(*args, **kwargs)

    model.decode_paged = decode_profiled
    try:
        eng.run(reqs, drain=True)
    finally:
        model.decode_paged = decode
    prof = seen["profile"]
    if prof is None:
        raise AssertionError("phase 42d: fewer than 3 decode steps")
    if "launches" in prof and prof["launches"]["tp_combine"] \
            != SITES_PER_STEP:
        raise AssertionError(f"phase 42d: {prof['launches']} TP combines "
                             f"in a decode step, want {SITES_PER_STEP}")
    return prof


def start_dryrun() -> tuple:
    """Phase 42a's rows and 42c's counts, submitted to DRYRUN_WORKERS
    spawned processes (meta tensors, no card) right after the build,
    and 42a's exactness checks: ``(pool, rows, counts, exact)``, futures
    that phase 42 collects and the pool that it shuts down."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ARCH_IDS, SHAPES
    pool = ProcessPoolExecutor(DRYRUN_WORKERS,
                               mp_context=mp.get_context("spawn"))
    rows = [pool.submit(_dryrun_row, (a, s, m)) for a in ARCH_IDS
            for s in SHAPES for m in DRYRUN_MESHES]
    counts = {(eng, r): pool.submit(_dryrun_coll, (eng, r))
              for eng in ("ring", "xla") for r in range(COLL_LOAD["n"])}
    exact = {c: pool.submit(_dryrun_exact, c) for c in DRYRUN_EXACT_CASES}
    return pool, rows, counts, exact


def dryrun_phases(gen: torch.Generator, card: str, lap: "Laps", coll: dict,
                  ring_profile: dict, dry_run: tuple) -> dict:
    """Phase 42: the dry-run (launch/dryrun.py) and the roofline
    (roofline/) on the card's own constants. ``dry_run``: the rows and
    counts :func:`start_dryrun` computed beside the earlier phases."""
    pool, rows_f, coll_f, exact_f = dry_run
    card_out, model, params = dryrun_vs_card(gen)
    lap("42b")
    decode_profile = profile_decode_step(model, params)
    del model, params
    torch.cuda.empty_cache()
    lap("42d")
    with pool:
        rows = [f.result() for f in rows_f]
        dry = {a: f.result() for a, f in coll_f.items()}
        exact = {c: f.result() for c, f in exact_f.items()}
    sweep = dryrun_sweep_check(rows)
    wrong = [c for c, ok in exact.items() if not ok]
    if wrong:
        raise AssertionError(f"phase 42a: counts unequal to the count of "
                             f"every layer and op: {wrong}")
    print(f"42a: the counts by periods and by signatures equal the counts "
          f"of every layer and op on {len(exact)} reduced configs",
          flush=True)
    colls = dryrun_collectives(coll, dry)
    lap("42a,42c")
    out = {"sweep": sweep, "vs_card": card_out, "collectives": colls,
           "launches": {"ring_step": ring_profile,
                        "decode_step": decode_profile}}
    print(json.dumps({"dryrun": out, "card": card}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
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
    dry_run = start_dryrun()       # phase 42a's rows, beside phases 3-41
    lap = Laps()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    xla_shapes = xla_grid_shapes()
    err = check_kernel(gen, xla_shapes)
    timing = time_kernel(gen, xla_shapes["quickstart"][-1])
    print(json.dumps({"kernel_timing": timing, "card": card}), flush=True)
    lap("3")
    tp_err = check_tp_combine(gen)
    tp_timing = time_tp_combine(gen)
    print(json.dumps({"tp_combine_errors": tp_err,
                      "tp_combine_timing": tp_timing, "card": card}),
          flush=True)
    lap("3c")

    model, params = init_model("gemma3-1b", gen)
    slice_ = serve_slice(model, params)
    print(json.dumps({"slice": slice_, "card": card}), flush=True)
    equiv = dense_equivalence(model, params)
    print(json.dumps({"dense_equivalence": equiv}), flush=True)
    del model, params
    torch.cuda.empty_cache()
    lap("4-5")

    rwkv_err = check_rwkv6(gen)
    rwkv_timing = time_rwkv6(gen)
    print(json.dumps({"rwkv6_errors": rwkv_err, "rwkv6_timing": rwkv_timing,
                      "card": card}), flush=True)
    model, params = init_model(RWKV_LOAD.arch, gen)
    rwkv_slice = serve_static(model, params, gen, RWKV_LOAD)
    print(json.dumps({"rwkv6_slice": rwkv_slice, "card": card}), flush=True)
    pvd = prefill_vs_decode(model, params, gen, RWKV_LOAD)
    print(json.dumps({"rwkv6_prefill_vs_decode": pvd}), flush=True)
    del model, params
    torch.cuda.empty_cache()
    lap("6-8")

    rg_err = check_rglru(gen)
    rg_timing = time_rglru(gen)
    print(json.dumps({"rglru_errors": rg_err, "rglru_timing": rg_timing,
                      "card": card}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    model, params = init_model(RG_LOAD.arch, gen)
    rg_slice = serve_static(model, params, gen, RG_LOAD)
    print(json.dumps({"recurrentgemma_slice": rg_slice, "card": card}),
          flush=True)
    pvd = prefill_vs_decode(model, params, gen, RG_LOAD, f32_layers=3)
    print(json.dumps({"recurrentgemma_prefill_vs_decode": pvd}), flush=True)
    print(json.dumps({"peak_memory_gb":
                      torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del model, params
    torch.cuda.empty_cache()
    lap("9-12")

    ring_cases, ring_err = check_ring(gen)
    # the training phases' per-leaf plans at n = 16 (shapes only)
    trees = {"quickstart": {k: torch.empty(shape, device="meta")
                            for k, shape in QUICKSTART_SHAPES.items()}}
    for cfg in (get_config("rps-paper-mlp"), RPS_100M):
        trees[cfg.name] = tree_lib.map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
            build_model(cfg, device="cuda").init_stacked(gen))
    plans = {name: make_exchange_plan(tree, SimulatorConfig(n_workers=16))
             for name, tree in trees.items()}
    ring_cases += check_ring_plans(gen, plans)
    group = largest_group(plans["rps-100m"])
    bucket = (1, 16, 16, BUCKET_MB * 2 ** 20 // 4 // 16)
    ring_group = time_ring(gen, group)
    ring_bucket = time_ring(gen, bucket)
    print(json.dumps({"ring_sweep_cases": ring_cases,
                      "ring_sweep_max_abs_err": ring_err,
                      "ring_timing_group": ring_group,
                      "ring_timing_bucket": ring_bucket, "card": card}),
          flush=True)
    torch.cuda.empty_cache()
    lap("13-14")
    qs = quickstart(groups=len(xla_shapes["quickstart"]))
    print(json.dumps({"quickstart": qs, "card": card}), flush=True)
    lap("15")
    la = launcher_default()
    print(json.dumps({"launcher_default": la, "card": card}), flush=True)
    lap("16")
    setup = rps100m_setup(gen)
    big = rps100m(setup)
    print(json.dumps({"rps_100m": big, "card": card}), flush=True)
    torch.cuda.empty_cache()
    lap("17")
    ring_profile = profile_ring_step(setup)       # phase 42d's first part
    print(json.dumps({"ring_step_launches": ring_profile}), flush=True)
    lap("42d-17")

    enc_cases, enc_err = check_ring_enc(gen, plans)
    enc_group = time_ring_enc(gen, group)
    enc_bucket = time_ring_enc(gen, bucket)
    enc_wide = time_ring_enc(gen, RING_Q_WIDE, full=False)
    print(json.dumps({"ring_enc_cases": enc_cases,
                      "ring_enc_max_abs_err": enc_err,
                      "ring_enc_timing_group": enc_group,
                      "ring_enc_timing_bucket": enc_bucket,
                      "ring_enc_timing_wide": enc_wide,
                      "ring_linear_ms": {"group": ring_group["ms"],
                                         "bucket": ring_bucket["ms"]},
                      "card": card}), flush=True)
    torch.cuda.empty_cache()
    lap("18-19")
    gap = ef_gap_closure()
    print(json.dumps({"ef_gap_closure": gap, "card": card}), flush=True)
    lap("20")
    cut = cut_setup(setup)
    base = cut_baseline(cut)
    print(json.dumps({"rps_100m_cut_baseline": base, "card": card}),
          flush=True)
    big_int8 = rps100m_int8(cut, base["loss"])
    print(json.dumps({"rps_100m_int8": big_int8, "card": card}), flush=True)
    lap("21")
    chans = channels_bench()
    print(json.dumps({"channels": chans, "card": card}), flush=True)
    lap("22")
    conv = packed_convergence()
    print(json.dumps({"state_bench_convergence": conv, "card": card}),
          flush=True)
    lap("23")
    packs = rps100m_packs(cut)
    print(json.dumps({"rps_100m_state_packs": packs, "card": card}),
          flush=True)
    lap("24")

    t0 = time.perf_counter()
    byz = byzantine_exchanges(trees)
    byz["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"byzantine_exchanges": byz, "card": card}), flush=True)
    t0 = time.perf_counter()
    rb = robust_bench()
    rb["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"robust_bench": rb, "card": card}), flush=True)
    t0 = time.perf_counter()
    ab = async_bench()
    ab["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"async_bench": ab, "card": card}), flush=True)
    t0 = time.perf_counter()
    attack = rps100m_attack(cut, base)
    attack["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"rps_100m_attack": attack, "card": card}), flush=True)
    t0 = time.perf_counter()
    asy = rps100m_async(cut)
    asy["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"rps_100m_async": asy, "card": card}), flush=True)
    t0 = time.perf_counter()
    tel = rps100m_telemetry(cut)
    tel["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"rps_100m_telemetry": tel, "card": card}), flush=True)
    coll_batches = [{k: v[:COLL_N].cpu() for k, v in b.items()}
                    for b in setup.batches[:COLL_LOAD["steps"]]]
    del setup, cut
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fig4 = convergence_bench()
    fig4["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"convergence_bench": fig4, "card": card}), flush=True)
    t0 = time.perf_counter()
    launch = launchers()
    launch["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"launchers": launch, "card": card}), flush=True)
    lap("25-31")
    new = new_phases(gen, card, lap)
    mm = mm_phases(gen, card, lap)
    coll = coll_phases(gen, card, lap, coll_batches)
    dryrun_phases(gen, card, lap, coll, ring_profile, dry_run)
    lap.report()
    robust_launches = sum(v["masked_avg_launches"]
                          for v in rb["sweep"].values())

    kernel = {"name": "masked_avg_grid", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/masked_avg.cu",
              "replaces": "src/repro/kernels/masked_avg.py:58",
              "launches": qs["rps_model_xla"]["masked_avg_launches"]
              + robust_launches + ab["launches"]["masked_avg"]
              + fig4["masked_avg_launches"]
              + launch["train_masked_avg_launches"],
              "max_abs_err": err,
              "ms": timing["ms"], "plain_ms": timing["plain_ms"],
              "bound_ms": timing["bound_ms"],
              "bound_by": timing["bound_by"],
              "library_ms": timing["library_ms"], "ok": True}
    combine = {"name": "tp_combine", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/masked_avg.cu",
               "replaces": "src/repro/kernels/masked_avg.py:58",
               "launches": slice_["tp_combine_launches"]
               + launch["tp_combine_launches"]
               + new["tp_combine_launches"],
               "max_abs_err": tp_err["max_abs_err_f32_wire"],
               "ms": tp_timing["ms"], "plain_ms": tp_timing["plain_ms"],
               "bound_ms": tp_timing["bound_ms"],
               "bound_by": tp_timing["bound_by"],
               "library_ms": None, "ok": True}
    rwkv = {"name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:71",
            "launches": rwkv_slice["kernel_launches"],
            "max_abs_err": rwkv_err["bfloat16"]["o"],
            "ms": rwkv_timing["ms"], "plain_ms": rwkv_timing["plain_ms"],
            "bound_ms": rwkv_timing["bound_ms"],
            "bound_by": rwkv_timing["bound_by"],
            "library_ms": None, "ok": True}
    rglru = {"name": "rglru", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rglru.cu",
             "replaces": "src/repro/kernels/rglru_scan.py:52",
             "launches": rg_slice["kernel_launches"],
             "max_abs_err": rg_err["bfloat16"]["h"],
             "ms": rg_timing["ms"], "plain_ms": rg_timing["plain_ms"],
             "bound_ms": rg_timing["bound_ms"],
             "bound_by": rg_timing["bound_by"],
             "library_ms": None, "ok": True}
    ring = {"name": "ring_round", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ring.cu",
            "replaces": "src/repro/kernels/rps_ring.py:331",
            # with ring.cu's encoded variant (levels 0), which takes the
            # attacked renorm run's corrupted f32 offers
            "launches": big["ring_launches"] + base["ring_launches"]
            + ab["launches"]["ring"]
            + asy["sync"]["ring_launches"] + asy["async"]["ring_launches"]
            + attack["renorm"]["ring_enc_launches"]
            + tel["launches_off"]["ring"] + tel["launches_on"]["ring"]
            + new["ring_launches"] + mm["ring_launches"],
            "max_abs_err": ring_err,
            "ms": ring_group["ms"], "plain_ms": ring_group["plain_ms"],
            "bound_ms": ring_group["bound_ms"],
            "bound_by": ring_group["bound_by"],
            "library_ms": None, "ok": True}
    ring_enc = {"name": "ring_round_enc", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ring_q.cu",
                "replaces": "src/repro/kernels/rps_ring.py:331",
                "launches": big_int8["renorm"]["ring_requant_launches"]
                + tel["int8_alpha2"]["launches"]["ring_requant"],
                "max_abs_err": enc_err,
                "ms": enc_group["ms"], "plain_ms": enc_group["plain_ms"],
                "bound_ms": enc_group["bound_ms"],
                "bound_by": enc_group["bound_by"],
                "library_ms": None, "ok": True}
    rt = coll["rank_timing"]
    ring_rank = {"name": "ring_rank", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ring_rank.cu",
                 "replaces": "src/repro/kernels/rps_ring.py:331",
                 "launches": coll["launches"],
                 "max_abs_err": 0.0 if not
                 coll["rank_err"]["differing_elements"] else None,
                 "ms": rt["ms"], "plain_ms": rt["plain_ms"],
                 "bound_ms": rt["bound_ms"], "bound_by": rt["bound_by"],
                 "library_ms": None,
                 "requant_ms": rt["requant"]["ms"],
                 "requant_plain_ms": rt["requant"]["plain_ms"],
                 "requant_bound_ms": rt["requant"]["bound_ms"],
                 "ok": True}
    print(json.dumps({"kernels": [kernel, combine, rwkv, rglru, ring,
                                  ring_enc, ring_rank]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
