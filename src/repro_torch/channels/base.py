"""Channel-model base class (port of :mod:`repro.channels.base`).

A channel draws the per-iteration ``(rs, ag)`` drop-mask pair that drives
the RPS exchange. Masks are boolean ``(n, s)`` tensors (``s`` server
blocks, default ``n``): ``rs[i, j]`` — worker i's block-j packet reaches
the owner ``j % n``; ``ag[i, j]`` — the broadcast of block j reaches
worker i. Owner entries are always delivered (:func:`force_diag`).

Random draws come from an explicit ``torch.Generator``; the masks land on
the generator's device. Torch cannot reproduce JAX's threefry stream, so
parity with the JAX package is held on injected masks, and the port's own
draws are held to the same owner forcing and the same marginal.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import rps as rps_lib

MaskPair = Tuple[torch.Tensor, torch.Tensor]


def force_diag(rs: torch.Tensor, ag: torch.Tensor) -> MaskPair:
    """The owner entry of every block column is always delivered."""
    own = rps_lib.owner_mask(rs.shape[-2], rs.shape[-1], device=rs.device)
    return rs | own, ag | own


class Channel:
    """Base class; subclasses set ``n`` (and optionally ``s``) and
    implement ``sample``."""

    name: str = "channel"

    def __init__(self, n: int, s: Optional[int] = None):
        if n < 1:
            raise ValueError(f"need n >= 1 workers, got {n}")
        self.n = int(n)
        self.s = self.n if s is None else int(s)
        if self.s < 1:
            raise ValueError(f"need s >= 1 server blocks, got {s}")

    def init_state(self, gen: Optional[torch.Generator] = None) -> Any:
        return None

    def sample(self, gen: torch.Generator, state: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        raise NotImplementedError

    def sample_masks(self, gen: torch.Generator) -> MaskPair:
        """Stateless convenience: one (rs, ag) draw from the initial state."""
        rs, ag, _ = self.sample(gen, self.init_state(gen))
        return rs, ag

    def sample_packets(self, gen: torch.Generator, state: Any = None,
                       n_buckets: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Per-bucket packet masks ``(n_buckets, n, s)``. The base draws
        the iteration's link fates once and broadcasts them across
        buckets; per-packet channels override with independent draws."""
        rs, ag, state = self.sample(gen, state)
        shape = (int(n_buckets),) + tuple(rs.shape)
        return rs.expand(shape), ag.expand(shape), state

    def effective_p(self) -> float:
        raise NotImplementedError

    def _dims(self) -> str:
        return f"n={self.n}" + (f", s={self.s}" if self.s != self.n else "")

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._dims()})"
