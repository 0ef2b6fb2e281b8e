"""Online per-link effective-p estimation and theory-drift detection
(a numpy copy of :mod:`repro.telemetry.estimator`).

The paper's Corollary-2 rate (and the α₁/α₂ bounds of ``repro_torch/core/theory.py``)
are functions of the *configured* drop probability; this module closes
the loop by estimating the probability each link actually experienced
from the delivery counters and flagging when the two depart.

Estimator: per-link drop-rate x̂ᵢ over the non-owned packets link i
offered each step. ``alpha=None`` (default) keeps the exact cumulative
mean — the right choice for stationarity checks; an EWMA ``alpha`` tracks
non-stationary channels (deadline stragglers, trace replays) at the cost
of a finite memory. Both share one uncertainty model: the effective
sample size of an EWMA over m-packet batches is ``m·(2−α)/α`` (the
cumulative mean's is the true packet count), giving the standard error
``se = sqrt(p̂(1−p̂)/ess)`` used by the z-test drift monitor.

Bursty channels (Gilbert–Elliott) violate the independence behind that
se — burst autocorrelation inflates the variance of x̂ by roughly the
mean burst length — so :meth:`drift` takes a ``slack`` floor in
probability units on top of the z·se band rather than pretending packet
draws are iid; the channel-validation tests size tolerances per family.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class LinkRateEstimator:
    """Streaming per-link drop-rate estimator over delivery counters.

    feed :meth:`update` with the per-step ``delivered``/``offered``
    counts (``(n,)`` each, owner entries already excluded —
    ``counters.link_delivered`` / ``counters.link_offered``).
    """

    def __init__(self, n: int, alpha: Optional[float] = None):
        if alpha is not None and not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha}: want (0, 1] or None")
        self.n = int(n)
        self.alpha = alpha
        self.est = np.zeros(n)          # per-link drop-rate estimate
        self.packets = np.zeros(n)      # raw offered-packet count
        self.steps = 0

    def update(self, delivered: Any, offered: Any) -> None:
        d = np.asarray(delivered, dtype=np.float64)
        m = np.asarray(offered, dtype=np.float64)
        if d.shape != (self.n,) or m.shape != (self.n,):
            raise ValueError(f"want shape ({self.n},), got "
                             f"{d.shape} / {m.shape}")
        x = np.where(m > 0, 1.0 - d / np.maximum(m, 1.0), self.est)
        if self.alpha is None:
            new_tot = self.packets + m
            w = np.where(new_tot > 0, m / np.maximum(new_tot, 1.0), 0.0)
            self.est = self.est + w * (x - self.est)
        else:
            a = self.alpha if self.steps else 1.0
            self.est = (1.0 - a) * self.est + a * x
        self.packets += m
        self.steps += 1

    # -- uncertainty ------------------------------------------------------
    def ess(self) -> np.ndarray:
        """Effective sample size (packets) behind each link's estimate."""
        if self.alpha is None or self.steps == 0:
            return self.packets
        per_step = self.packets / max(self.steps, 1)
        return per_step * (2.0 - self.alpha) / self.alpha

    def stderr(self) -> np.ndarray:
        ess = np.maximum(self.ess(), 1.0)
        var = self.est * (1.0 - self.est)
        return np.sqrt(np.maximum(var, 1e-12) / ess)

    # -- drift monitor ----------------------------------------------------
    def drift(self, expected: Any, z: float = 4.0,
              slack: float = 0.02) -> Dict[str, Any]:
        """Compare the live estimate against the configured per-link p.

        A link drifts when ``|est − expected| > z·se + slack`` — the z·se
        band covers sampling noise, the ``slack`` floor covers model error
        the se cannot see (burst autocorrelation, EWMA bias). Returns the
        full per-link report the registry serialises into summary.json.
        """
        exp = np.broadcast_to(np.asarray(expected, np.float64),
                              (self.n,)).copy()
        se = self.stderr()
        dev = np.abs(self.est - exp)
        tol = z * se + slack
        flags = (dev > tol) & (self.packets > 0)
        return {
            "observed_p": self.est.tolist(),
            "expected_p": exp.tolist(),
            "stderr": se.tolist(),
            "tolerance": tol.tolist(),
            "packets": self.packets.tolist(),
            "drifted": flags.tolist(),
            "any_drift": bool(flags.any()),
            "max_abs_dev": float(dev.max()) if self.n else 0.0,
        }
