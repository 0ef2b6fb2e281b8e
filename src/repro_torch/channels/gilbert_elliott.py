"""Gilbert–Elliott two-state bursty loss, one Markov chain per directed
link (port of :mod:`repro.channels.gilbert_elliott`).

Each directed link carries a good/bad state. A packet on a bad link drops
with probability ``p_bad`` (``p_good`` on a good link, default 0). Per
iteration the state moves good → bad with probability ``p_gb`` and
bad → good with ``p_bg = 1/burst``, so bad sojourns are geometric with
mean ``burst`` iterations. Stationary bad probability π = p_gb/(p_gb +
p_bg), and effective_p = π·p_bad + (1 − π)·p_good. A target ``p`` solves
for ``p_gb`` (the matched-rate comparison of
``benchmarks/channels_bench.py``).

The RS packet on link i → j and the AG packet on link j → i see the same
per-iteration link state; their drops are independent draws, per bucket
for per-packet masks. The state moves exactly once per iteration.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.channels.base import Channel, f32, force_diag, uniforms


class GilbertElliottChannel(Channel):
    name = "ge"

    def __init__(self, n: int, p_bad: float = 0.5, burst: float = 8.0,
                 p: Optional[float] = None, p_gb: Optional[float] = None,
                 p_good: float = 0.0, s: Optional[int] = None):
        super().__init__(n, s)
        if burst < 1.0:
            raise ValueError(f"burst (mean bad sojourn) must be >= 1, "
                             f"got {burst}")
        if not 0.0 <= p_good < p_bad <= 1.0:
            raise ValueError(f"need 0 <= p_good < p_bad <= 1, "
                             f"got p_good={p_good}, p_bad={p_bad}")
        self.p_bad = float(p_bad)
        self.p_good = float(p_good)
        self.burst = float(burst)
        self.p_bg = 1.0 / self.burst
        if p is not None:
            if p_gb is not None:
                raise ValueError("give a target p or p_gb, not both")
            pi = (p - p_good) / (p_bad - p_good)
            if not 0.0 <= pi < 1.0:
                raise ValueError(
                    f"target p={p} unreachable with p_bad={p_bad}, "
                    f"p_good={p_good} (needs stationary bad prob {pi:.3f})")
            p_gb = pi * self.p_bg / (1.0 - pi) if pi > 0 else 0.0
        self.p_gb = float(p_gb if p_gb is not None else 0.05)
        if not 0.0 <= self.p_gb <= 1.0:
            raise ValueError(f"p_gb={self.p_gb} outside [0, 1] — target p "
                             "too high for the requested burst length")

    @property
    def pi_bad(self) -> float:
        """Stationary probability a link is in the bad state."""
        denom = self.p_gb + self.p_bg
        return self.p_gb / denom if denom > 0 else 0.0

    def init_state(self, gen: Optional[torch.Generator] = None) -> Any:
        """Link states from the stationary law (``gen`` None: a CPU
        generator seeded 0)."""
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        return self.init_from_draws(uniforms(gen, (self.n, self.n)))

    def init_from_draws(self, u: torch.Tensor) -> Any:
        """The initial state from ``(n, n)`` uniforms: bad iff
        u < π (the reference's ``bernoulli(fold_in(key, 0x6E11), π)``)."""
        return {"bad": u < f32(self.pi_bad, u)}

    def draw(self, gen: torch.Generator, lead: Tuple[int, ...] = ()
             ) -> dict:
        """``stay`` / ``enter``: the transition's ``(n, n)`` uniforms;
        ``rs`` / ``ag``: each leg's fate uniforms, ``lead + (n, n)``."""
        nn = (self.n, self.n)
        return {"stay": uniforms(gen, nn), "enter": uniforms(gen, nn),
                "rs": uniforms(gen, lead + nn),
                "ag": uniforms(gen, lead + nn)}

    def from_draws(self, draws: dict, state: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """One Markov transition (stay bad iff u < 1 − p_bg, enter iff
        u < p_gb), then a drop wherever a fate uniform is below the
        link's drop probability. Link-indexed draws become block columns
        through the owner map; the AG leg gathers the transposed draw."""
        bad = state["bad"]
        stay = draws["stay"] < f32(1.0 - self.p_bg, bad)
        enter = draws["enter"] < f32(self.p_gb, bad)
        bad = torch.where(bad, stay, enter)
        p_link = torch.where(bad, f32(self.p_bad, bad),
                             f32(self.p_good, bad))
        rs_drop = draws["rs"] < p_link
        ag_drop = draws["ag"] < p_link
        rs, ag = force_diag(self.link_cols(~rs_drop),
                            self.link_cols(~ag_drop.transpose(-1, -2)))
        return rs, ag, {"bad": bad}

    def sample_packets(self, gen: torch.Generator, state: Any = None,
                       n_buckets: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        # one transition, then conditionally independent per-bucket fates
        if state is None:
            state = self.init_state(gen)
        return self.from_draws(self.draw(gen, (int(n_buckets),)), state)

    def effective_p(self) -> float:
        pi = self.pi_bad
        return pi * self.p_bad + (1.0 - pi) * self.p_good

    def __repr__(self) -> str:
        return (f"GilbertElliottChannel({self._dims()}, p_bad={self.p_bad}, "
                f"burst={self.burst}, p_gb={self.p_gb:.4f}, "
                f"eff_p={self.effective_p():.4f})")
