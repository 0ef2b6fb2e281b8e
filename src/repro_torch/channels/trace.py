"""Trace-driven loss: replay per-iteration drop rates from
:mod:`repro_torch.netsim.sim` (port of :mod:`repro.channels.trace`).

``netsim.sim.export_trace`` records, per RPS burst period and server, the
fraction of learning bytes dropped on the uplink and the downlink; this
channel replays it as per-iteration per-link drop probabilities

    p_rs[i → j](t) = 1 − (1 − up_t[srv(i)]) · (1 − down_t[srv(j)])

(a packet survives iff it clears the sender's uplink and the receiver's
downlink); the AG leg uses the transposed link. The period advances
every iteration and wraps, and worker i maps to server ``i % n_servers``.
The probabilities are computed in numpy f32 exactly as the reference
computes them, so the same uniforms give the same masks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.channels.base import Channel, force_diag, uniforms


def save_trace(path: str, trace: Dict[str, np.ndarray]) -> None:
    np.savez(path, up=trace["up"], down=trace["down"])


def load_trace(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {"up": z["up"], "down": z["down"]}


class TraceChannel(Channel):
    name = "trace"

    def __init__(self, n: int, trace: Dict[str, np.ndarray],
                 s: Optional[int] = None):
        super().__init__(n, s)
        up = np.asarray(trace["up"], np.float32)
        down = np.asarray(trace["down"], np.float32)
        if up.ndim != 2 or up.shape != down.shape or up.shape[0] < 1:
            raise ValueError(f"bad trace shapes up={up.shape}, "
                             f"down={down.shape}")
        if min(up.min(), down.min()) < 0 or max(up.max(), down.max()) > 1:
            raise ValueError("trace drop fractions must lie in [0, 1]")
        srv = np.arange(n) % up.shape[1]            # worker -> server
        up_w, down_w = up[:, srv], down[:, srv]     # (T, n)
        # survive sender-uplink AND receiver-downlink, per directed link
        self.p_trace = torch.from_numpy(
            1.0 - (1.0 - up_w[:, :, None]) * (1.0 - down_w[:, None, :]))
        self.n_periods = up.shape[0]

    @classmethod
    def from_netsim(cls, n: int, lam: float, prio: float,
                    cfg: Optional[object] = None,
                    s: Optional[int] = None) -> "TraceChannel":
        """Run the §7 flow simulation and replay its induced learning
        loss."""
        from repro_torch.netsim import sim as netsim
        cfg = cfg if cfg is not None else netsim.NetConfig()
        return cls(n, netsim.export_trace(lam, prio, cfg), s=s)

    @classmethod
    def from_npz(cls, n: int, path: str,
                 s: Optional[int] = None) -> "TraceChannel":
        return cls(n, load_trace(path), s=s)

    def init_state(self, gen: Optional[torch.Generator] = None) -> Any:
        return {"t": 0}

    def draw(self, gen: torch.Generator, lead: Tuple[int, ...] = ()
             ) -> dict:
        """One fate uniform per link and leg, ``(n, n)``: a replayed
        period applies to the whole round, so the per-bucket masks are
        the base class's broadcast of one draw."""
        nn = (self.n, self.n)
        return {"rs": uniforms(gen, nn), "ag": uniforms(gen, nn)}

    def from_draws(self, draws: dict, state: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Delivered iff u ≥ p of the current period (the AG leg against
        its transpose); the period advances by one."""
        t = state["t"]
        p = self.p_trace[t % self.n_periods].to(draws["rs"].device)
        rs = draws["rs"] >= p
        ag = draws["ag"] >= p.T
        rs, ag = force_diag(self.link_cols(rs), self.link_cols(ag))
        return rs, ag, {"t": t + 1}

    def effective_p(self) -> float:
        pm = self.p_trace.numpy()
        if self.n == 1:
            return 0.0
        off = ~np.eye(self.n, dtype=bool)
        return float(pm[:, off].mean())

    def expected_link_p(self) -> np.ndarray:
        """Per-sender RS-leg drop expectation, time-averaged over the
        trace: each row against its own marginal."""
        return self._row_expectation(
            self.p_trace.numpy().astype(np.float64).mean(axis=0))

    def expected_link_p_ag(self) -> np.ndarray:
        """Per-receiver AG-leg expectation (the transposed time-averaged
        link matrix): distinct from the RS leg wherever up and down loss
        differ."""
        return self._row_expectation(
            self.p_trace.numpy().astype(np.float64).mean(axis=0).T)

    def __repr__(self) -> str:
        return (f"TraceChannel({self._dims()}, periods={self.n_periods}, "
                f"eff_p={self.effective_p():.4f})")
