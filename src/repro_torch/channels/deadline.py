"""Deadline-induced loss from a straggler latency model (port of
:mod:`repro.channels.deadline`).

Per iteration each worker straggles with probability ``straggler_frac``;
a straggler's sends take ``straggler_mult × base_ms`` of base latency.
Every packet adds Exp(``jitter_ms``) queueing jitter and drops iff
``base + jitter > deadline_ms``. Drops are therefore row/column
correlated: a straggler's whole RS row (and its AG column) degrades at
once. The marginal has a closed form (the exponential tail):

    P(drop | base) = exp(−(deadline − base)/jitter)   for deadline > base
    effective_p    = q·P(mult·base) + (1 − q)·P(base)

and is uniform across links, so the base class's ``expected_link_p``
broadcast is exact.

Under the async schedule a bucket ready ``r`` ms into the backward pass
has only ``slack = deadline − r`` ms left: :meth:`sample_async` draws
per-bucket masks at those slacks and reports the packets that are
**late** (they would have met the iteration deadline, not the bucket's
slack); :meth:`effective_p_at` is the closed-form marginal at any slack.
The channel takes its exponentials as draws: a ``log1p`` one ulp off the
reference's would flip ``lat <= deadline`` at the edge.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.channels.base import (Channel, exponentials, f32,
                                       force_diag, uniforms)


class DeadlineChannel(Channel):
    name = "deadline"

    def __init__(self, n: int, deadline_ms: float = 10.0,
                 base_ms: float = 2.0, jitter_ms: float = 2.0,
                 straggler_frac: float = 0.1, straggler_mult: float = 4.0,
                 s: Optional[int] = None):
        super().__init__(n, s)
        if deadline_ms <= 0 or jitter_ms <= 0:
            raise ValueError(
                f"deadline_ms={deadline_ms} and jitter_ms={jitter_ms} "
                f"must be > 0")
        if base_ms < 0:
            raise ValueError(f"base_ms={base_ms} must be >= 0 "
                             f"(0 = pure-jitter latency is allowed)")
        if not 0.0 <= straggler_frac <= 1.0:
            raise ValueError(f"straggler_frac={straggler_frac} not in [0,1]")
        if straggler_mult < 1.0:
            raise ValueError(
                f"straggler_mult={straggler_mult} must be >= 1: a "
                f"straggler is slower than the base latency by definition "
                f"(mult < 1 would silently make stragglers faster)")
        self.deadline_ms = float(deadline_ms)
        self.base_ms = float(base_ms)
        self.jitter_ms = float(jitter_ms)
        self.straggler_frac = float(straggler_frac)
        self.straggler_mult = float(straggler_mult)

    def draw(self, gen: torch.Generator, lead: Tuple[int, ...] = ()
             ) -> dict:
        """``straggle``: one uniform per worker; ``rs`` / ``ag``: each
        packet's Exp(1) jitter, ``lead + (n, n)``."""
        nn = (self.n, self.n)
        return {"straggle": uniforms(gen, (self.n,)),
                "rs": exponentials(gen, lead + nn),
                "ag": exponentials(gen, lead + nn)}

    def _base(self, u: torch.Tensor) -> torch.Tensor:
        """Each sender's base latency: a straggler iff u < q."""
        straggle = u < f32(self.straggler_frac, u)
        return torch.where(straggle,
                           f32(self.base_ms * self.straggler_mult, u),
                           f32(self.base_ms, u))

    def from_draws(self, draws: dict, state: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Delivered iff base + jitter·e ≤ deadline. The RS link [i, j]
        is sent by worker i; the AG link [i, j] by worker j (block j's
        owner broadcasting to receiver i)."""
        base = self._base(draws["straggle"])
        jit, dl = f32(self.jitter_ms, base), f32(self.deadline_ms, base)
        lat_rs = base[:, None] + draws["rs"] * jit
        lat_ag = base[None, :] + draws["ag"] * jit
        rs, ag = force_diag(self.link_cols(lat_rs <= dl),
                            self.link_cols(lat_ag <= dl))
        return rs, ag, state

    def effective_p(self) -> float:
        return float(self.effective_p_at(self.deadline_ms))

    def effective_p_at(self, deadline_ms) -> np.ndarray:
        """Closed-form drop marginal at any array of deadlines (the
        async schedule's per-bucket slacks); a non-positive slack drops
        every off-owner packet (marginal 1.0)."""
        d = np.asarray(deadline_ms, np.float64)
        jit = max(self.jitter_ms, 1e-12)

        def tail(base: float) -> np.ndarray:
            return np.where(d > base, np.exp(-np.maximum(d - base, 0.0) / jit),
                            1.0)

        q = self.straggler_frac
        return (q * tail(self.base_ms * self.straggler_mult)
                + (1.0 - q) * tail(self.base_ms))

    def sample_async(self, gen: torch.Generator, state: Any, slack_ms
                     ) -> Tuple[torch.Tensor, torch.Tensor, dict, Any]:
        """Per-bucket deadline arbitration: ``slack_ms`` is the
        ``(n_buckets,)`` vector of per-bucket budgets. One straggle draw
        covers the iteration, the jitter is drawn per bucket and packet
        (:meth:`async_from_draws`)."""
        nb = int(np.asarray(slack_ms).shape[0])
        return self.async_from_draws(self.draw(gen, (nb,)), state, slack_ms)

    def async_from_draws(self, draws: dict, state: Any, slack_ms
                         ) -> Tuple[torch.Tensor, torch.Tensor, dict, Any]:
        """``(rs, ag, late, state)`` from ``(n_buckets, n, n)`` jitter
        draws: a packet is delivered iff its latency fits its bucket's
        slack, and late iff it missed the slack but would have met the
        iteration deadline. Owner entries are delivered and never late."""
        base = self._base(draws["straggle"])
        jit, dl = f32(self.jitter_ms, base), f32(self.deadline_ms, base)
        slack = torch.from_numpy(np.asarray(slack_ms, np.float32)).to(
            base.device)
        lat_rs = base[None, :, None] + draws["rs"] * jit
        lat_ag = base[None, None, :] + draws["ag"] * jit
        sl = slack[:, None, None]
        rs, ag = force_diag(self.link_cols(lat_rs <= sl),
                            self.link_cols(lat_ag <= sl))
        rs_late = self.link_cols((lat_rs > sl) & (lat_rs <= dl))
        ag_late = self.link_cols((lat_ag > sl) & (lat_ag <= dl))
        off = ~force_diag(torch.zeros_like(rs_late),
                          torch.zeros_like(ag_late))[0]
        return rs, ag, {"rs": rs_late & off, "ag": ag_late & off}, state

    def __repr__(self) -> str:
        return (f"DeadlineChannel({self._dims()}, "
                f"deadline={self.deadline_ms}ms,"
                f" eff_p={self.effective_p():.4f})")
