"""I.i.d. Bernoulli drops — the paper's channel and the default (port of
:mod:`repro.channels.bernoulli`)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.channels.base import Channel
from repro_torch.core import rps as rps_lib


class BernoulliChannel(Channel):
    name = "bernoulli"

    def __init__(self, n: int, p: float = 0.0, s: Optional[int] = None):
        super().__init__(n, s)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"drop probability p={p} outside [0, 1]")
        self.p = float(p)

    def sample(self, gen: torch.Generator, state: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        rs, ag = rps_lib.sample_masks(gen, self.n, self.p, self.s)
        return rs, ag, state

    def sample_packets(self, gen: torch.Generator, state: Any = None,
                       n_buckets: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        # i.i.d. per packet: every bucket column draws independently
        rs, ag = rps_lib.sample_masks(gen, self.n, self.p, self.s,
                                      n_buckets=int(n_buckets))
        return rs, ag, state

    def effective_p(self) -> float:
        return self.p

    def __repr__(self) -> str:
        return f"BernoulliChannel({self._dims()}, p={self.p})"
