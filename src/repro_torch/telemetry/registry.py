"""The run-scoped telemetry registry every instrumented layer reports to
(port of :mod:`repro.telemetry.registry`).

One :class:`Telemetry` object per run ties the pieces together: the step
records flowing to the sinks, the per-link drop-rate estimators fed from
the delivery counters, the Chrome-trace span buffer, the bench timing
table, and the bound theory context (plan description + α bounds +
expected per-link p) the drift monitor compares against.

Install with :func:`set_current` (or the :func:`enabled` context
manager); ``timing.time_fn`` / ``wallclock`` discover it via
:func:`get_current`; the launchers construct and finalize their own. Nothing in the hot path touches the registry — the
simulator step emits taps (``taps.py``) that stay on the device; the host
loop hands them to :meth:`record_step` after the run, only when telemetry
is on.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import theory
from repro_torch.telemetry.estimator import LinkRateEstimator
from repro_torch.telemetry.record import make_step_record, to_jsonable
from repro_torch.telemetry.sinks import ConsoleSink, JsonlSink, MemorySink, \
    close_all
from repro_torch.telemetry.trace import TraceBuffer

_current: Optional["Telemetry"] = None


def set_current(reg: Optional["Telemetry"]) -> None:
    global _current
    _current = reg


def get_current() -> Optional["Telemetry"]:
    return _current


@contextmanager
def enabled(reg: "Telemetry"):
    prev = get_current()
    set_current(reg)
    try:
        yield reg
    finally:
        set_current(prev)


class Telemetry:
    """Per-run metrics registry; see module docstring.

    ``out_dir=None`` keeps everything in memory (MemorySink) until
    :meth:`finalize`; a directory attaches a streaming JSONL sink
    immediately. ``console_every > 0`` adds a live terminal summary.
    """

    def __init__(self, out_dir: Optional[str] = None,
                 estimator_alpha: Optional[float] = None,
                 console_every: int = 0):
        self.out_dir = out_dir
        self.estimator_alpha = estimator_alpha
        self.trace = TraceBuffer()
        self.memory = MemorySink()
        self.sinks: List[Any] = [self.memory]
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self.sinks.append(JsonlSink(os.path.join(out_dir,
                                                     "telemetry.jsonl")))
        if console_every:
            self.sinks.append(ConsoleSink(every=console_every))
        self.meta: Dict[str, Any] = {}
        self.timings: Dict[str, List[float]] = {}
        self.rs_est: Optional[LinkRateEstimator] = None
        self.ag_est: Optional[LinkRateEstimator] = None
        self._expected_p: Optional[np.ndarray] = None
        self._expected_p_ag: Optional[np.ndarray] = None
        self._finalized = False

    # -- context binding --------------------------------------------------
    def bind(self, plan=None, n: Optional[int] = None,
             p: Optional[float] = None, channel=None,
             **extra: Any) -> "Telemetry":
        """Attach the run's exchange context: the plan's wire-byte
        accounting, the theory α bounds at (plan, n, p), and the per-link
        expected drop rate (``channel.expected_link_p()`` when a channel
        drives the masks, the scalar p otherwise)."""
        if channel is not None:
            n = channel.n if n is None else n
            if p is None:
                p = channel.effective_p()
            self._expected_p = np.asarray(channel.expected_link_p(),
                                          np.float64)
            # asymmetric channels (e.g. trace replay) expect a different
            # marginal on the AG leg; compare each estimator to its own leg
            self._expected_p_ag = np.asarray(channel.expected_link_p_ag(),
                                             np.float64)
            self.meta["channel"] = repr(channel)
        elif p is not None and n is not None:
            self._expected_p = np.full(n, float(p))
            self._expected_p_ag = self._expected_p
        async_plan = plan is not None and \
            getattr(plan, "schedule", "sync") == "async"
        if async_plan and channel is not None and \
                getattr(channel, "deadline_ms", None) is not None:
            # async lateness writes packets off on top of the channel's
            # drops, so the estimators see the *inflated* marginal — the
            # mean per-bucket rate at each bucket's reduced slack, uniform
            # across links (the deadline jitter is per-link i.i.d.).
            # Comparing against the sync stationary p would false-flag
            # drift on every async run.
            self.meta["p_sync"] = float(p)
            p = float(np.mean(theory.async_bucket_drop_rates(plan,
                                                             channel)))
            self._expected_p = np.full(n, p)
            self._expected_p_ag = self._expected_p
        if plan is not None:
            self.meta["plan"] = to_jsonable(plan.describe())
            if n is not None and p is not None:
                if async_plan and channel is not None:
                    a1, a2 = theory.async_alpha_bounds(plan, n, channel)
                else:
                    a1, a2 = theory.alpha_bounds_plan(plan, n, float(p))
                self.meta["alpha_bounds"] = {"alpha1": float(a1),
                                             "alpha2": float(a2)}
        if n is not None:
            self.meta["n"] = int(n)
        if p is not None:
            self.meta["p"] = float(p)
        self.meta.update({k: to_jsonable(v) for k, v in extra.items()})
        return self

    # -- step records -----------------------------------------------------
    def record_step(self, step: int, stats: Optional[Dict[str, Any]] = None,
                    **extra: Any) -> Dict[str, Any]:
        """Materialised per-step stats → estimators + every sink. Returns
        the JSON-ready record."""
        rec = make_step_record(step, stats, **extra)
        rs_d = rec.get("rs_link_delivered")
        ag_d = rec.get("ag_link_delivered")
        offered = rec.get("link_offered")
        if rs_d is not None and offered is not None:
            n = len(rs_d)
            if self.rs_est is None:
                self.rs_est = LinkRateEstimator(n, self.estimator_alpha)
                self.ag_est = LinkRateEstimator(n, self.estimator_alpha)
            self.rs_est.update(rs_d, offered)
            if ag_d is not None:
                self.ag_est.update(ag_d, offered)
        for s in self.sinks:
            s.write(rec)
        return rec

    # -- timings ----------------------------------------------------------
    def note_timing(self, label: str, seconds: float) -> None:
        self.timings.setdefault(label, []).append(float(seconds))
        self.trace.instant(f"timing:{label}", us=seconds * 1e6)

    def span(self, name: str, **args):
        """Host-phase span; lands in the Chrome trace (and in a
        ``torch.profiler`` timeline when one is recording)."""
        return self.trace.span(name, **args)

    # -- reporting --------------------------------------------------------
    def drift_report(self, z: float = 4.0,
                     slack: float = 0.02) -> Optional[Dict[str, Any]]:
        if self.rs_est is None or self._expected_p is None:
            return None
        rep = {"rs": self.rs_est.drift(self._expected_p, z=z, slack=slack)}
        if self.ag_est is not None and self.ag_est.steps:
            exp_ag = self._expected_p_ag if self._expected_p_ag is not None \
                else self._expected_p
            rep["ag"] = self.ag_est.drift(exp_ag, z=z, slack=slack)
        return rep

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"meta": dict(self.meta),
                               "steps": len(self.memory.records)}
        drift = self.drift_report()
        if drift is not None:
            out["link_p"] = drift
        if self.timings:
            out["timings_s"] = {
                k: {"n": len(v), "best": min(v), "mean": sum(v) / len(v)}
                for k, v in self.timings.items()}
        return out

    def finalize(self, print_summary: bool = False) -> Dict[str, Any]:
        """Write summary.json / trace.json (telemetry.jsonl already
        streamed) into ``out_dir``, close the sinks, return the summary."""
        summ = self.summary()
        if self.out_dir is not None and not self._finalized:
            with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
                json.dump(summ, f, indent=2)
            self.trace.write(os.path.join(self.out_dir, "trace.json"))
            if not any(isinstance(s, JsonlSink) for s in self.sinks):
                with open(os.path.join(self.out_dir,
                                       "telemetry.jsonl"), "w") as f:
                    for r in self.memory.records:
                        f.write(json.dumps(r) + "\n")
        close_all(s for s in self.sinks if s is not self.memory)
        self._finalized = True
        if print_summary:
            _print_summary(summ)
        return summ


def _print_summary(summ: Dict[str, Any]) -> None:
    meta = summ.get("meta", {})
    print(f"telemetry: {summ.get('steps', 0)} steps recorded")
    ab = meta.get("alpha_bounds")
    link = summ.get("link_p", {}).get("rs")
    if link:
        obs = link["observed_p"]
        print(f"  observed per-link p: mean={np.mean(obs):.4f} "
              f"min={min(obs):.4f} max={max(obs):.4f} "
              f"(expected {np.mean(link['expected_p']):.4f}, "
              f"drift={'YES' if link['any_drift'] else 'no'})")
    if ab:
        print(f"  theory bounds: alpha1={ab['alpha1']:.4f} "
              f"alpha2={ab['alpha2']:.4f}")
    for k, v in summ.get("timings_s", {}).items():
        print(f"  timing {k}: best={v['best']*1e3:.3f} ms "
              f"(n={v['n']})")
