"""Per-link heterogeneous i.i.d. loss: an (n, n) drop-probability matrix
(port of :mod:`repro.channels.heterogeneous`).

``P[i, j]`` is the drop probability of the directed link i → j. The RS
mask draws against ``P``, the AG mask (block-j broadcast to receiver i,
link j → i) against ``P.T``. Memoryless: only the marginals differ per
link. :meth:`HeterogeneousChannel.pods` is the two-tier fabric: reliable
intra-pod links (``p_intra``), lossy cross-pod links (``p_cross``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.channels.base import Channel, force_diag, uniforms


class HeterogeneousChannel(Channel):
    name = "hetero"

    def __init__(self, n: int, p_matrix, s: Optional[int] = None):
        super().__init__(n, s)
        pm = np.asarray(p_matrix, np.float32)
        if pm.shape != (n, n):
            raise ValueError(f"p_matrix shape {pm.shape} != ({n}, {n})")
        if pm.min() < 0.0 or pm.max() > 1.0:
            raise ValueError("p_matrix entries must lie in [0, 1]")
        self.p_matrix = torch.from_numpy(pm.copy())

    @classmethod
    def pods(cls, n: int, n_pods: int, p_intra: float = 0.0,
             p_cross: float = 0.2,
             s: Optional[int] = None) -> "HeterogeneousChannel":
        """Two-tier fabric: n workers in n_pods equal pods (contiguous
        ranks); intra-pod links drop at p_intra, cross-pod at p_cross."""
        if n % n_pods:
            raise ValueError(f"n={n} not divisible by n_pods={n_pods}")
        pod = np.arange(n) // (n // n_pods)
        same = pod[:, None] == pod[None, :]
        pm = np.where(same, p_intra, p_cross).astype(np.float32)
        return cls(n, pm, s=s)

    def draw(self, gen: torch.Generator, lead: Tuple[int, ...] = ()
             ) -> dict:
        """One fate uniform per link and leg, ``lead + (n, n)``."""
        nn = (self.n, self.n)
        return {"rs": uniforms(gen, lead + nn), "ag": uniforms(gen, lead + nn)}

    def from_draws(self, draws: dict, state: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Delivered iff u ≥ P (the RS leg) and u ≥ Pᵀ (the AG leg, already
        receiver-indexed)."""
        pm = self.p_matrix.to(draws["rs"].device)
        rs = draws["rs"] >= pm
        ag = draws["ag"] >= pm.T
        rs, ag = force_diag(self.link_cols(rs), self.link_cols(ag))
        return rs, ag, state

    def sample_packets(self, gen: torch.Generator, state: Any = None,
                       n_buckets: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        # memoryless per-link marginals: packets draw independently
        return self.from_draws(self.draw(gen, (int(n_buckets),)), state)

    def effective_p(self) -> float:
        pm = self.p_matrix.numpy()
        off = ~np.eye(self.n, dtype=bool)
        return float(pm[off].mean()) if self.n > 1 else 0.0

    def expected_link_p(self) -> np.ndarray:
        """Per-sender RS-leg expectation: the mean of ``P[i, owner(j)]``
        over the non-owned block columns j."""
        return self._row_expectation(self.p_matrix.numpy().astype(np.float64))

    def expected_link_p_ag(self) -> np.ndarray:
        """Per-receiver AG-leg expectation, from ``P.T``; the RS leg's
        iff P is symmetric."""
        return self._row_expectation(
            self.p_matrix.numpy().astype(np.float64).T)

    def __repr__(self) -> str:
        return (f"HeterogeneousChannel({self._dims()}, "
                f"eff_p={self.effective_p():.4f})")
