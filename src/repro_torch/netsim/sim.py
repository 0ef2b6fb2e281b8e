"""Serving load generator (port of :func:`repro.netsim.sim.request_trace`;
numpy only, so it draws the same trace as the JAX package's from the same
seed). The colocation network simulator is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """The fields of the JAX package's ``NetConfig`` the load generator
    reads, with the same defaults."""
    tick_s: float = 1e-3
    sim_s: float = 2.0
    seed: int = 0


def request_trace(lam: float, cfg: NetConfig = NetConfig(), *,
                  n_requests: Optional[int] = None,
                  prompt_lens: Sequence[int] = (8, 16, 32),
                  max_new: Sequence[int] = (4, 8, 16, 32),
                  seed: Optional[int] = None) -> List[tuple]:
    """(arrival_ms, prompt_len, max_new) tuples: Poisson arrivals at λ
    requests/s over ``cfg.sim_s`` of simulated time, prompt and
    generation lengths drawn uniformly from the given sets."""
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
