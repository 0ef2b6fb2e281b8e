"""Closed-form α₁/α₂ bounds (Lemmas 7 & 8) and the Corollary-2 rate — a
numpy copy of :mod:`repro.core.theory`, op for op, reading the port's
wire constants (:mod:`repro_torch.core.wire`), with the Byzantine axis's
rates (``robust_breakdown_point``, ``byzantine_rate``, ``robust_rate``).

All formulas are verbatim from the paper's supplement:

  T1 = 2(1 − p^{n+1} − (n+1)(1−p)p^n − (n+1)n(1−p)²p^{n−1}/2 − (1−p)^{n+1})
       / (n(n+1)(1−p)²)
  T2 = (1 − p^n − n(1−p)p^{n−1} − (1−p)^n) / ((n−1)(1−p))
  T3 = n/(n−1)·(1 − p^{n−1} − (1−p)^{n−1}) + (1−p)^{n−1}

  α₁ ≤ (np + (1−p)^n + nT1 + nT2 − 1) / (n−1)
  α₂ ≤ (p(1+2T3) + (1−p)^{n−1})/n + 2p(1−p)^n/n + p^n(1−p)/n² + T1 + T2

Asymptotics the paper highlights: α₁ = O(p), α₂ = O(p(1−p)/n); the drop
rate's influence diminishes as n grows (Fig 2/3, discussion after Cor. 2).

Multi-server generalisation (DESIGN.md §10): the paper identifies workers
with parameter servers (s = n, square masks), but its second headline —
"the influence of the packet drop rate diminishes with the growth of the
number of parameter servers" — needs s decoupled from n. The mechanism is
*packetisation*: a server block is the loss-atomic transfer unit, so with
``model_packets`` wire packets per model (default n, i.e. one packet per
block in the paper's s = n layout) a block spans ``ceil(model_packets/s)``
packets and survives only if all of them do. Every bound below accepts
``s=`` (and ``model_packets=``) and is evaluated at the induced per-block
rate ``block_drop_rate(p, packets) = 1 − (1−p)^packets``; for small p this
is ≈ p·model_packets/s, giving the server-scaling law the benchmark
``benchmarks/server_sweep.py`` measures:

    α₂(n, p, s) ≈ p_block(1−p_block)/n = O(p(1−p)/s)   (model_packets = n)

With s = n (the default) p_block = p and everything reduces to the paper's
square-layout bounds exactly.

Wire pipeline (DESIGN.md §13): the convergence argument only needs an
unbiased, bounded-variance estimate of the average, so codecs and
recovery policies enter the bounds as *variance*, not structure: a codec
contributes its relative quantisation second moment ω (``wire.WIRE_OMEGA``;
ω² under error feedback, which telescopes the time-averaged codec error),
the ``scale`` recovery its divisor variance p/((1−p)n) — both folded into
α₂ by ``alpha_bounds_plan``/``corollary2_rate_plan`` via
``plan_wire_alpha2_extra``. All recovery policies are (conditionally)
unbiased, so α₁ is untouched; the f32/renorm default adds exactly 0.

Non-i.i.d. channels (DESIGN.md §9): the bounds are functions of the
marginal drop probability only, so they extend to any ``repro_torch.channels``
channel through its stationary marginal ``channel.effective_p()`` — that is
the *matched-rate i.i.d. proxy*. Burst structure (Gilbert–Elliott) and
per-link correlation (deadline/straggler) are invisible to the proxy; the
gap between the proxy prediction and the measured curve is exactly what
``benchmarks/channels_bench.py`` quantifies. Use the ``*_channel`` helpers
below (they duck-type: floats are treated as Bernoulli p).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


# ---- multi-server packetisation (DESIGN.md §10) ---------------------------

def packets_per_block(s: int, model_packets: int) -> int:
    """Wire packets per server block when the model's ``model_packets``
    packets are sharded over s blocks (round-robin, so the widest block
    has ceil(model_packets / s); never below one packet)."""
    if s < 1:
        raise ValueError(f"need s >= 1 server blocks, got {s}")
    return max(-(-int(model_packets) // int(s)), 1)


def block_drop_rate(p: float, packets: float) -> float:
    """Drop rate of a loss-atomic block spanning ``packets`` wire packets
    at per-packet drop rate p: 1 − (1−p)^packets. ``packets=1`` is the
    identity — the paper's one-packet-per-block regime."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p={p} outside [0, 1]")
    return float(1.0 - (1.0 - p) ** packets)


def _server_p(n: int, p: float, s: Optional[int],
              model_packets: Optional[int]) -> float:
    """Per-block drop rate for an s-server layout (p itself when s is None
    or the layout is the paper's one-packet-per-block square)."""
    if s is None:
        return p
    m = n if model_packets is None else model_packets
    k = packets_per_block(s, m)
    return p if k == 1 else block_drop_rate(p, k)


def t1(n: int, p: float) -> float:
    if p == 1.0:
        return 0.0
    num = 2.0 * (1.0 - p ** (n + 1) - (n + 1) * (1 - p) * p ** n
                 - (n + 1) * n * (1 - p) ** 2 * p ** (n - 1) / 2.0
                 - (1 - p) ** (n + 1))
    return num / (n * (n + 1) * (1 - p) ** 2)


def t2(n: int, p: float) -> float:
    if p == 1.0:
        return 0.0
    num = 1.0 - p ** n - n * (1 - p) * p ** (n - 1) - (1 - p) ** n
    return num / ((n - 1) * (1 - p))


def t3(n: int, p: float) -> float:
    return (n / (n - 1.0)) * (1.0 - p ** (n - 1) - (1 - p) ** (n - 1)) \
        + (1 - p) ** (n - 1)


def alpha1_bound(n: int, p: float, s: Optional[int] = None,
                 model_packets: Optional[int] = None) -> float:
    """Lemma 7 upper bound on α₁ (clipped into [0, 1]).

    ``s``/``model_packets`` evaluate the bound at the s-server per-block
    drop rate (module doc); ``s=None`` is the paper's square layout."""
    p = _server_p(n, p, s, model_packets)
    a = (n * p + (1 - p) ** n + n * t1(n, p) + n * t2(n, p) - 1.0) / (n - 1.0)
    return float(np.clip(a, 0.0, 1.0))


def alpha2_bound(n: int, p: float, s: Optional[int] = None,
                 model_packets: Optional[int] = None) -> float:
    """Lemma 8 upper bound on α₂ (clipped into [0, 1]).

    With ``s`` given, evaluated at the s-server per-block drop rate — the
    α₂ = O(p(1−p)/s) server-scaling asymptotic of the module doc."""
    p = _server_p(n, p, s, model_packets)
    a = ((p * (1.0 + 2.0 * t3(n, p)) + (1 - p) ** (n - 1)) / n
         + 2.0 * p * (1 - p) ** n / n
         + p ** n * (1 - p) / n ** 2
         + t1(n, p) + t2(n, p))
    return float(np.clip(a, 0.0, 1.0))


def beta(n: int, p: float, s: Optional[int] = None,
         model_packets: Optional[int] = None) -> float:
    """β = α₁ − α₂ (Theorem 1)."""
    return max(alpha1_bound(n, p, s, model_packets)
               - alpha2_bound(n, p, s, model_packets), 0.0)


def corollary2_lr(n: int, p: float, T: int, L: float = 1.0,
                  sigma: float = 1.0, zeta: float = 0.0,
                  s: Optional[int] = None,
                  model_packets: Optional[int] = None) -> float:
    """The learning rate Corollary 2 prescribes."""
    b = beta(n, p, s, model_packets)
    a2 = alpha2_bound(n, p, s, model_packets)
    return (1.0 - np.sqrt(b)) / (
        6.0 * L + 3.0 * (sigma + zeta) * np.sqrt(a2 * T)
        + sigma * np.sqrt(T) / np.sqrt(n))


def corollary2_rate(n: int, p: float, T: int, sigma: float = 1.0,
                    zeta: float = 0.0, s: Optional[int] = None,
                    model_packets: Optional[int] = None,
                    a2_extra: float = 0.0) -> float:
    """Leading terms of the Corollary-2 convergence bound (up to constants):

      (σ+ζ)(1+√(nα₂)) / ((1−√β)√(nT)) + 1/T
      + n(σ²+ζ²)/((1+nα₂)σ²T + nα₂Tζ²)

    ``a2_extra`` adds wire-pipeline variance on top of the Lemma-8 α₂
    (codec ω + recovery-divisor variance, DESIGN.md §13); 0.0 — the
    f32/renorm default — reduces exactly to the paper's rate.
    """
    b = beta(n, p, s, model_packets)
    a2 = min(alpha2_bound(n, p, s, model_packets) + float(a2_extra), 1.0)
    lead = (sigma + zeta) * (1.0 + np.sqrt(n * a2)) / (
        (1.0 - np.sqrt(b)) * np.sqrt(n * T))
    tail = n * (sigma ** 2 + zeta ** 2) / (
        (1.0 + n * a2) * sigma ** 2 * T + n * a2 * T * zeta ** 2 + 1e-12)
    return float(lead + 1.0 / T + tail)


# ---- ExchangePlan extensions (DESIGN.md §11) -------------------------------

def plan_packets(plan) -> "tuple[int, int]":
    """``(s, model_packets)`` of a
    ``repro_torch.core.plan.ExchangePlan`` (duck-typed: anything with
    ``.s`` and ``.model_packets``). This is how the
    bucketed plan drives the packetisation bounds: a fixed-byte plan sends
    each server block as ``plan.n_buckets`` wire packets (one per bucket
    column), so ``packets_per_block(s, model_packets) = n_buckets`` and
    every bound below is evaluated at ``block_drop_rate(p, n_buckets)``.
    The degenerate single-draw plans give ``model_packets = s`` — one
    packet per block, the paper's layout, and the bounds reduce exactly
    to the square formulas.

    The resulting α's are *conservative* for a bucketed exchange: the
    bound treats a server block as loss-atomic (all packets or nothing),
    while the per-bucket masks actually deliver buckets independently —
    the measured gap sits at or below the prediction
    (``benchmarks/exchange_bench.py`` reports both).
    """
    return int(plan.s), int(plan.model_packets)


def plan_wire_alpha2_extra(plan, n: int, p: float) -> float:
    """Wire-pipeline variance the plan's codec/recovery add on top of the
    Lemma-8 α₂ (DESIGN.md §13): the codec's relative quantisation second
    moment ω (``wire.WIRE_OMEGA`` — ω² under EF, which compensates the
    time-averaged codec error to higher order) plus the ``scale``
    recovery's divisor variance p/((1−p)n). Duck-typed on ``plan.wire``
    / ``plan.recovery`` — pre-§13 plan-likes without the fields get the
    exact paper bounds (0.0 extra), as does the f32/renorm default."""
    from repro_torch.core import wire as wire_lib
    w = getattr(plan, "wire", "f32")
    r = getattr(plan, "recovery", "renorm")
    return (wire_lib.effective_omega(w, r)
            + wire_lib.recovery_alpha2_extra(r, n, p))


def alpha_bounds_plan(plan, n: int, p: float):
    """(α₁, α₂) Lemma-7/8 bounds at the plan's packetisation, with the
    plan's wire-codec variance and recovery-divisor variance folded into
    α₂ (:func:`plan_wire_alpha2_extra`). Every recovery policy is
    (conditionally) unbiased, so α₁ carries no extra term. The
    f32/renorm default reduces exactly to the packetisation bounds."""
    s, mp = plan_packets(plan)
    extra = plan_wire_alpha2_extra(plan, n, p)
    return (alpha1_bound(n, p, s=s, model_packets=mp),
            float(min(alpha2_bound(n, p, s=s, model_packets=mp) + extra,
                      1.0)))


def corollary2_rate_plan(plan, n: int, p: float, T: int, **kw) -> float:
    """Corollary-2 rate prediction at the plan's packetisation and wire
    pipeline (codec ω + recovery variance through ``a2_extra``)."""
    s, mp = plan_packets(plan)
    kw.setdefault("a2_extra", plan_wire_alpha2_extra(plan, n, p))
    return corollary2_rate(n, p, T, s=s, model_packets=mp, **kw)


# ---- async staleness term (DESIGN.md §15) ----------------------------------

def async_bucket_drop_rates(plan, channel) -> np.ndarray:
    """Per-bucket effective drop marginals under the async schedule:
    bucket b ships at ``ready_ms[b]`` against the channel's iteration
    deadline, so its packets face the *reduced* slack
    ``plan.slack_ms(deadline)`` — evaluated through the channel's
    closed-form ``effective_p_at``. Channels without a latency model
    (no ``effective_p_at``/``deadline_ms``) see no deadline tightening:
    every bucket keeps the stationary marginal (the async fallback path
    is mask-identical to sync)."""
    eff_at = getattr(channel, "effective_p_at", None)
    deadline = getattr(channel, "deadline_ms", None)
    nb = plan.n_buckets
    if eff_at is None or deadline is None or plan.ready_ms is None:
        return np.full(nb, effective_p(channel))
    return np.asarray(eff_at(plan.slack_ms(float(deadline))), np.float64)


def staleness_alpha2_extra(p_async: float, p_sync: float, n: int) -> float:
    """Variance surcharge of async lateness on top of the Lemma-8 α₂.

    A late packet is *recovered* content: its mass re-enters the average
    through renorm/EF one round later instead of now, so the async round
    behaves like a sync round at the inflated marginal ``p_async`` plus
    an extra consensus-variance term from the lateness mass
    ``q = p_async − p_sync`` — the packets present under sync but
    written off under async. The term mirrors the bounds' O(p(1−p)/n)
    shape: ``q(1−q)/n``, the second moment of the Bernoulli lateness
    indicator averaged over n workers. This is a conservative
    matched-rate proxy (lateness is *correlated* across a straggler's
    row, which the marginal cannot see); the drift monitor measures the
    gap live."""
    q = float(np.clip(p_async - p_sync, 0.0, 1.0))
    return q * (1.0 - q) / max(n, 1)


def async_alpha_bounds(plan, n: int, channel):
    """(α₁, α₂) bounds for an async-scheduled plan over a deadline
    channel: the Lemma-7/8 bounds evaluated at the mean per-bucket
    async marginal (each bucket's reduced slack inflates its drop rate,
    :func:`async_bucket_drop_rates`), with the plan's wire variance and
    the staleness surcharge (:func:`staleness_alpha2_extra`) folded
    into α₂. For a sync plan (or a channel with no latency model) this
    reduces exactly to :func:`alpha_bounds_plan` at the stationary
    marginal."""
    p_sync = effective_p(channel)
    p_async = float(np.mean(async_bucket_drop_rates(plan, channel)))
    a1, a2 = alpha_bounds_plan(plan, n, p_async)
    extra = staleness_alpha2_extra(p_async, p_sync, n)
    return a1, float(min(a2 + extra, 1.0))


# ---- channel extensions (DESIGN.md §9) ------------------------------------

def effective_p(channel_or_p) -> float:
    """Stationary marginal drop probability of a channel (or a plain p)."""
    eff = getattr(channel_or_p, "effective_p", None)
    if callable(eff):
        return float(eff())
    p = float(channel_or_p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p={p} outside [0, 1]")
    return p


def _channel_n(channel, n) -> int:
    n = getattr(channel, "n", None) or n
    if n is None:
        raise ValueError("n is required when passing a scalar drop rate "
                         "instead of a Channel")
    return int(n)


def alpha_bounds_channel(channel, n: int = None):
    """(α₁, α₂) Lemma-7/8 bounds at the channel's effective drop rate."""
    n = _channel_n(channel, n)
    p = effective_p(channel)
    return alpha1_bound(n, p), alpha2_bound(n, p)


def corollary2_lr_channel(channel, T: int, n: int = None, **kw) -> float:
    return corollary2_lr(_channel_n(channel, n), effective_p(channel), T,
                         **kw)


def corollary2_rate_channel(channel, T: int, n: int = None, **kw) -> float:
    """Corollary-2 rate prediction at the channel's matched i.i.d. rate."""
    return corollary2_rate(_channel_n(channel, n), effective_p(channel), T,
                           **kw)


# ---- Byzantine corruption: robust statistical rates -------------------------
#
# With an α fraction of Byzantine workers, coordinate-wise median and the
# β-trimmed mean reach the order-optimal error O(α/√n + 1/√(nT)) (Yin et
# al.). A drop removes a sample, a corruption replaces one: the 2-axis
# prediction adds the corrupted-fraction term to the Corollary-2 rate
# with the robust recovery's clean-data efficiency folded into α₂.

def robust_breakdown_point(recovery) -> float:
    """Largest corrupted worker fraction the recovery's aggregate
    tolerates: median / clip 1/2, trimmed β, the averaging kinds 0."""
    from repro_torch.core import wire as wire_lib
    return wire_lib.make_recovery(recovery).breakdown_point()


def byzantine_rate(n: int, T: int, byz_frac: float,
                   sigma: float = 1.0) -> float:
    """σ(α/√n + 1/√(nT)) + 1/T, up to constants."""
    if not 0.0 <= byz_frac < 1.0:
        raise ValueError(f"byz_frac={byz_frac} not in [0, 1)")
    a = float(byz_frac)
    return float(sigma * (a / np.sqrt(n) + 1.0 / np.sqrt(n * T)) + 1.0 / T)


def robust_rate(n: int, p: float, T: int, byz_frac: float = 0.0,
                recovery="median", sigma: float = 1.0, **kw) -> float:
    """The drop × corruption rate: the Corollary-2 rate at drop rate
    ``p`` with the recovery's efficiency loss in α₂, plus σ·α/√n; ``inf``
    past the recovery's breakdown point."""
    from repro_torch.core import wire as wire_lib
    rec = wire_lib.make_recovery(recovery)
    if byz_frac > rec.breakdown_point():
        return float("inf")
    kw.setdefault("a2_extra", wire_lib.recovery_alpha2_extra(rec, n, p))
    erasure = corollary2_rate(n, p, T, sigma=sigma, **kw)
    return float(erasure + sigma * byz_frac / np.sqrt(n))
