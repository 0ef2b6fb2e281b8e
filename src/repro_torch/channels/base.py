"""Channel-model base class (port of :mod:`repro.channels.base`).

A channel draws the per-iteration ``(rs, ag)`` drop-mask pair that drives
the RPS exchange. Masks are boolean ``(n, s)`` tensors (``s`` server
blocks, default ``n``): ``rs[i, j]`` — worker i's block-j packet reaches
the owner ``j % n`` (the directed link i → owner(j)); ``ag[i, j]`` — the
broadcast of block j reaches worker i (the link owner(j) → i). Per-link
channels keep their link state square ``(n, n)`` and gather block
columns through the owner map (:meth:`Channel.link_cols`); the AG leg
uses the transposed link matrix. Owner entries are always delivered
(:func:`force_diag`).

Random draws come from an explicit ``torch.Generator``; the masks land on
the generator's device. Torch cannot reproduce JAX's threefry stream, so
a channel's sampling is split in two: :meth:`Channel.draw` takes the raw
variates (uniforms, exponentials) from the generator, and
:meth:`Channel.from_draws` is a pure function of those variates and the
carried state. The parity tests call ``from_draws`` with the variates the
reference drew from its keys, and hold the masks and state to the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rps as rps_lib

MaskPair = Tuple[torch.Tensor, torch.Tensor]


def force_diag(rs: torch.Tensor, ag: torch.Tensor) -> MaskPair:
    """The owner entry of every block column is always delivered."""
    own = rps_lib.owner_mask(rs.shape[-2], rs.shape[-1], device=rs.device)
    return rs | own, ag | own


def uniforms(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """f32 uniforms in [0, 1) from ``gen``, on its device."""
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)


def exponentials(gen: torch.Generator, shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """f32 Exp(1) variates from ``gen`` as JAX forms them, −log1p(−u)."""
    return torch.log1p(uniforms(gen, shape).neg_()).neg_()


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-dim f32 tensor on ``like``'s device: the
    reference compares f32 draws with its thresholds rounded to f32."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


class Channel:
    """Base class; subclasses set ``n`` (and optionally ``s``) and
    implement :meth:`draw` and :meth:`from_draws` (or ``sample``
    itself)."""

    name: str = "channel"

    def __init__(self, n: int, s: Optional[int] = None):
        if n < 1:
            raise ValueError(f"need n >= 1 workers, got {n}")
        self.n = int(n)
        self.s = self.n if s is None else int(s)
        if self.s < 1:
            raise ValueError(f"need s >= 1 server blocks, got {s}")
        self._owners = rps_lib.owners(self.n, self.s)

    def link_cols(self, link_mat: torch.Tensor) -> torch.Tensor:
        """Gather a worker-link-indexed ``(…, n, n)`` matrix into block
        columns ``(…, n, s)`` through the owner map (leading dims, such
        as the bucket dim of per-bucket draws, pass through); the
        identity when s == n."""
        if self.s == self.n:
            return link_mat
        return link_mat[..., self._owners.to(link_mat.device)]

    # -- state ------------------------------------------------------------
    def init_state(self, gen: Optional[torch.Generator] = None) -> Any:
        return None

    # -- sampling ---------------------------------------------------------
    def draw(self, gen: torch.Generator, lead: Tuple[int, ...] = ()
             ) -> dict:
        """The raw variates of one iteration (``lead`` prepends the
        per-bucket dims of the per-packet draws)."""
        raise NotImplementedError

    def from_draws(self, draws: dict, state: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """``(rs, ag, new_state)`` from the variates :meth:`draw` takes;
        pure, so the reference's variates give the reference's masks."""
        raise NotImplementedError

    def sample(self, gen: torch.Generator, state: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        if state is None:
            state = self.init_state(gen)
        return self.from_draws(self.draw(gen), state)

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

    def sample_async(self, gen: torch.Generator, state: Any, slack_ms
                     ) -> Tuple[torch.Tensor, torch.Tensor, dict, Any]:
        """Per-bucket masks under the async schedule plus its lateness
        axis, ``(rs, ag, late, state)`` with ``late = {"rs": …, "ag": …}``
        boolean ``(n_buckets, n, s)``. A channel without a latency model
        has no notion of lateness: the masks and the state advance of
        :meth:`sample_packets`, and no packet late."""
        nb = int(np.asarray(slack_ms).shape[0])
        rs, ag, state = self.sample_packets(gen, state, nb)
        zero = torch.zeros(rs.shape, dtype=torch.bool, device=rs.device)
        return rs, ag, {"rs": zero, "ag": zero}, state

    # -- theory hooks -----------------------------------------------------
    def effective_p(self) -> float:
        raise NotImplementedError

    def expected_link_p(self) -> np.ndarray:
        """Per-sender ``(n,)`` expected drop probability of the RS leg
        over the non-owned packets each worker offers: the broadcast
        ``effective_p()`` for a uniform marginal; per-link channels
        override it with their row marginals."""
        return np.full(self.n, self.effective_p())

    def expected_link_p_ag(self) -> np.ndarray:
        """Per-receiver ``(n,)`` expectation of the AG leg; the RS leg's
        for every symmetric channel."""
        return self.expected_link_p()

    def _row_expectation(self, pm: np.ndarray) -> np.ndarray:
        """Owner-excluded per-row mean of a ``(n, n)`` link drop matrix,
        gathered through the owner map as :meth:`link_cols` gathers."""
        own = np.asarray(self._owners)
        cols = pm[:, own]                                   # (n, s)
        non_own = own[None, :] != np.arange(self.n)[:, None]
        cnt = non_own.sum(axis=1)
        return np.where(cnt > 0,
                        (cols * non_own).sum(axis=1) / np.maximum(cnt, 1),
                        0.0)

    def _dims(self) -> str:
        return f"n={self.n}" + (f", s={self.s}" if self.s != self.n else "")

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._dims()})"
