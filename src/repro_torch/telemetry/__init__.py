"""Exchange telemetry (port of :mod:`repro.telemetry`): counters,
tracing, estimation, reports.

Layers, bottom up:

  ``taps``       step-time collector — counters out of a simulator step
                 as one extra output (reductions only: bit-identity safe)
  ``counters``   mask-derived delivery counts, divisor stats, norms
  ``estimator``  per-link effective-p estimate + theory-drift monitor
  ``trace``      Chrome-trace span buffer + schema validation
  ``sinks``      JSONL / in-memory ring / terminal-table record sinks
  ``record``     JSON-ready step records + the RunHistory container
  ``registry``   the per-run Telemetry object tying it all together
  ``timing``     the bench timer (time_fn / wallclock)
"""
from repro_torch.telemetry.record import (RunHistory, make_step_record,
                                          to_jsonable)
from repro_torch.telemetry.registry import (Telemetry, enabled, get_current,
                                            set_current)
from repro_torch.telemetry.taps import (TapCollector, annotate, emit,
                                        tap_collector)
from repro_torch.telemetry.timing import time_fn, wallclock
from repro_torch.telemetry.trace import TraceBuffer, validate_chrome_trace

__all__ = [
    "RunHistory", "make_step_record", "to_jsonable",
    "Telemetry", "enabled", "get_current", "set_current",
    "TapCollector", "annotate", "emit", "tap_collector",
    "time_fn", "wallclock",
    "TraceBuffer", "validate_chrome_trace",
]
