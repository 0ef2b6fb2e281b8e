"""§7 colocation case study: flow-level network simulation — a numpy
copy of :mod:`repro.netsim.sim`, op for op, so that both packages draw
the same traces from the same seed.

Topology per the paper: 16 servers, each with a 1 Gbps full-duplex link to
one switch. Two workloads share the fabric:

  - learning traffic: the RPS model-update stream. Real RS+AG exchanges are
    *synchronised bursts* at iteration boundaries, so the load is modelled
    as periodic bursts at line rate with duty cycle chosen to match the
    paper's 2.4 Gbps aggregate average; sent unreliably — any learning byte
    that cannot be scheduled in its tick is dropped, never retransmitted.
  - web traffic: 100 KB messages between uniform random (src, dst) pairs,
    Poisson arrivals at aggregate rate λ, sent reliably (backlogged).

Priority knob ``prio`` ∈ [0, 1]: each link reserves ``prio·cap`` for web
first and ``(1−prio)·cap`` for learning; web (the reliable, latency-bound
service) has first claim on leftovers. prio=0 reproduces the status quo
(learning effectively prioritised, zero drops); prio=1 is strict web
priority. Sweeping prio traces the paper's Fig 6/7 x-axis — the induced
learning-loss rate.

This is a fluid/flow approximation of the paper's packet-level simulation —
same topology, message sizes, arrival process, priority mechanism; no
per-MTU packet events (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetConfig:
    n_servers: int = 16
    link_gbps: float = 1.0
    learning_gbps: float = 2.4          # aggregate average across servers
    burst_period_ms: float = 50.0       # RPS iteration period
    web_msg_bytes: int = 100_000
    tick_s: float = 1e-3
    sim_s: float = 2.0
    seed: int = 0


def simulate(lam: float, prio: float, cfg: NetConfig = NetConfig(),
             trace_out: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, float]:
    """One (λ, prio) point -> avg web completion (ms), learning drop frac.

    When ``trace_out`` is a dict it is filled with the per-burst-period,
    per-server learning drop fractions — ``"up"``/``"down"`` arrays of
    shape (n_periods, n_servers) — the export consumed by
    ``channels.TraceChannel`` (one burst period = one RPS iteration)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_servers
    cap = cfg.link_gbps * 1e9 / 8 * cfg.tick_s            # bytes/tick/link
    avg_rate = cfg.learning_gbps * 1e9 / 8 / n * cfg.tick_s
    duty = min(avg_rate / cap, 1.0)                       # burst duty cycle
    period = max(int(cfg.burst_period_ms * 1e-3 / cfg.tick_s), 1)
    burst_ticks = max(int(round(duty * period)), 1)
    burst_rate = avg_rate * period / burst_ticks          # line-rate bursts

    ticks = int(cfg.sim_s / cfg.tick_s)
    arrivals = rng.poisson(lam * cfg.tick_s, size=ticks)

    rem: List[float] = []
    src: List[int] = []
    dst: List[int] = []
    t0: List[int] = []
    completed_ms: List[float] = []
    learn_offered = 0.0
    learn_sent = 0.0
    per_up = np.zeros(n)          # per-period per-server sent bytes
    per_down = np.zeros(n)
    per_off = 0.0                 # offered bytes per link this period
    trace_up: List[np.ndarray] = []
    trace_down: List[np.ndarray] = []

    def fifo_alloc(order, budget_up, budget_down, done):
        for i in order:
            if rem[i] <= 0:
                continue
            s, d = src[i], dst[i]
            room = min(budget_up[s], budget_down[d])
            if room <= 0:
                continue
            x = min(rem[i], room)
            rem[i] -= x
            budget_up[s] -= x
            budget_down[d] -= x
            if rem[i] <= 0:
                completed_ms.append((t - t0[i] + 1) * cfg.tick_s * 1e3)
                done.append(i)

    for t in range(ticks):
        for _ in range(arrivals[t]):
            s = int(rng.integers(0, n))
            d = int(rng.integers(0, n - 1))
            rem.append(float(cfg.web_msg_bytes))
            src.append(s)
            dst.append(d if d < s else d + 1)
            t0.append(t)

        in_burst = (t % period) < burst_ticks
        L = burst_rate if in_burst else 0.0                # per link per tick

        order = sorted(range(len(rem)), key=lambda i: t0[i])
        done: List[int] = []
        # pass 1: web on its reserved share
        b_up = np.full(n, prio * cap)
        b_down = np.full(n, prio * cap)
        fifo_alloc(order, b_up, b_down, done)
        web_up = prio * cap - b_up                        # bytes used
        web_down = prio * cap - b_down
        # learning on the remainder of each link (up and down streams)
        sent_up = np.minimum(L, cap - web_up)
        sent_down = np.minimum(L, cap - web_down)
        learn_offered += 2 * n * L
        learn_sent += float(sent_up.sum() + sent_down.sum())
        if trace_out is not None:
            per_up += sent_up
            per_down += sent_down
            per_off += L
            if (t + 1) % period == 0:        # RPS iteration boundary
                off = max(per_off, 1e-30)
                trace_up.append(np.clip(1.0 - per_up / off, 0.0, 1.0))
                trace_down.append(np.clip(1.0 - per_down / off, 0.0, 1.0))
                per_up = np.zeros(n)
                per_down = np.zeros(n)
                per_off = 0.0
        # pass 2: web takes whatever is still free (work-conserving)
        b_up = cap - web_up - sent_up
        b_down = cap - web_down - sent_down
        fifo_alloc(order, b_up, b_down, done)
        for i in sorted(set(done), reverse=True):
            rem.pop(i); src.pop(i); dst.pop(i); t0.pop(i)

    drop_frac = 1.0 - learn_sent / max(learn_offered, 1.0)
    avg_ms = float(np.mean(completed_ms)) if completed_ms else float("inf")
    if trace_out is not None:
        if per_off > 0:                       # flush a trailing part-period
            trace_up.append(np.clip(1.0 - per_up / per_off, 0.0, 1.0))
            trace_down.append(np.clip(1.0 - per_down / per_off, 0.0, 1.0))
        trace_out["up"] = np.stack(trace_up) if trace_up \
            else np.zeros((1, n))
        trace_out["down"] = np.stack(trace_down) if trace_down \
            else np.zeros((1, n))
    return {"avg_completion_ms": avg_ms,
            "learning_drop_frac": float(drop_frac),
            "web_msgs_per_s": len(completed_ms) / cfg.sim_s}


def export_trace(lam: float, prio: float, cfg: NetConfig = NetConfig()
                 ) -> Dict[str, np.ndarray]:
    """Per-iteration per-server learning drop fractions for one (λ, prio)
    operating point — the bridge from the §7 colocation study into the
    convergence experiments (``channels.TraceChannel`` replays this)."""
    trace: Dict[str, np.ndarray] = {}
    simulate(lam, prio, cfg, trace_out=trace)
    return trace


def speedup_curve(lam: float,
                  prios: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                  cfg: NetConfig = NetConfig()) -> List[Dict[str, float]]:
    """Fig 6: web speedup vs induced learning drop rate at fixed λ.
    Speedup is relative to prio=0 (the reliable-learning status quo)."""
    points = [simulate(lam, p, cfg) for p in prios]
    base = points[0]["avg_completion_ms"]
    for pt, p in zip(points, prios):
        pt["prio"] = p
        pt["speedup"] = base / pt["avg_completion_ms"]
    return points


def cost_reduction_curve(target_ms: float,
                         prios: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
                         lam_lo: float = 200.0, lam_hi: float = 40_000.0,
                         cfg: NetConfig = NetConfig()) -> List[Dict[str, float]]:
    """Fig 7: max sustainable λ at a completion-time target vs the induced
    learning drop rate; cost/message ∝ 1/λ_max."""
    out = []
    for p in prios:
        lo, hi = lam_lo, lam_hi
        for _ in range(10):
            mid = 0.5 * (lo + hi)
            if simulate(mid, p, cfg)["avg_completion_ms"] <= target_ms:
                lo = mid
            else:
                hi = mid
        r = simulate(lo, p, cfg)
        r["prio"] = p
        r["lam_max"] = lo
        out.append(r)
    base = out[0]["lam_max"]
    for r in out:
        r["cost_rel"] = base / max(r["lam_max"], 1e-9)
    return out


def request_trace(lam: float, cfg: NetConfig = NetConfig(), *,
                  n_requests: Optional[int] = None,
                  prompt_lens: Sequence[int] = (8, 16, 32),
                  max_new: Sequence[int] = (4, 8, 16, 32),
                  seed: Optional[int] = None
                  ) -> List[tuple]:
    """Serving load generator: (arrival_ms, prompt_len, max_new) tuples.

    Arrivals follow the same Poisson process as :func:`simulate`'s web
    traffic (rate λ requests/s over ``cfg.sim_s`` of simulated time);
    prompt and generation lengths are drawn uniformly from the given sets —
    the mixed-length workload the serving bench feeds to
    ``serve.ContinuousEngine`` via ``serve.make_requests``."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    ticks = int(cfg.sim_s / cfg.tick_s)
    arrivals = rng.poisson(lam * cfg.tick_s, ticks)
    out: List[tuple] = []
    for t in range(ticks):
        for _ in range(int(arrivals[t])):
            out.append((t * cfg.tick_s * 1e3,
                        int(rng.choice(prompt_lens)),
                        int(rng.choice(max_new))))
            if n_requests is not None and len(out) >= n_requests:
                return out
    return out
