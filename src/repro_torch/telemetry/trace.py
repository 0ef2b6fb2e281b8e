"""Chrome-trace / Perfetto span buffer and schema validation (port of
:mod:`repro.telemetry.trace`).

Spans cover the host-side phases of a run (plan build, the record drain,
serving prefills, bench sections) as complete ("ph": "X") events in the
Trace Event Format that chrome://tracing and https://ui.perfetto.dev load
directly. A span's time is host time: it adds no device synchronisation,
so on the card it measures the host's dispatch of the phase, not its
device work, unless the phase itself waits for the device. Each span also
enters ``torch.profiler.record_function`` under its name, so a
``torch.profiler`` trace shows the same ranges beside the kernels.

``python -m repro_torch.telemetry.trace --validate FILE`` exits non-zero
on a malformed trace.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch


class TraceBuffer:
    """Accumulates Trace Event Format events (timestamps in µs)."""

    def __init__(self, pid: int = 0):
        self.pid = pid
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        """Buffer-clock timestamp for callers that record a span's start
        and emit it later via :meth:`complete` (e.g. per-request serving
        spans that straddle many decode rounds)."""
        return self._now_us()

    def complete(self, name: str, ts_us: float, dur_us: float,
                 tid: int = 0, **args) -> None:
        """Append a complete ("X") event with explicit start/duration —
        the non-contextmanager form of :meth:`span`, for intervals whose
        endpoints are separate host events (per-request serving latency:
        admit → finish spans interleave across requests, so no ``with``
        block can bracket one)."""
        ev = {"name": name, "ph": "X", "ts": float(ts_us),
              "dur": max(float(dur_us), 0.0), "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, tid: int = 0, **args):
        """Time a host-side phase; also enters
        ``torch.profiler.record_function(name)`` so a profiler session's
        timeline carries the same range."""
        t0 = self._now_us()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            ev = {"name": name, "ph": "X", "ts": t0,
                  "dur": self._now_us() - t0, "pid": self.pid, "tid": tid}
            if args:
                ev["args"] = {k: v for k, v in args.items()}
            self.events.append(ev)

    def instant(self, name: str, tid: int = 0, **args) -> None:
        ev = {"name": name, "ph": "i", "ts": self._now_us(),
              "pid": self.pid, "tid": tid, "s": "g"}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                tid: int = 0) -> None:
        self.events.append({"name": name, "ph": "C", "ts": self._now_us(),
                            "pid": self.pid, "tid": tid,
                            "args": {k: float(v) for k, v in values.items()}})

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# ---------------------------------------------------------------------------
# Schema validation (the CI gate)
# ---------------------------------------------------------------------------

_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural check of a Trace Event Format object; returns a list of
    problems (empty = valid). Covers what chrome://tracing actually
    requires: a traceEvents array of dicts, each with a string name, a
    known phase, numeric ts (and numeric non-negative dur on "X"), and
    JSON-serialisable args."""
    errs: List[str] = []
    if isinstance(obj, list):
        events = obj                       # the bare-array variant is legal
    elif isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object lacks a 'traceEvents' array"]
    else:
        return [f"trace must be an object or array, got {type(obj).__name__}"]
    for k, ev in enumerate(events):
        where = f"event[{k}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) and ev.get("ph") != "M":
            errs.append(f"{where}: missing string 'name'")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: unknown phase {ph!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"{where}: missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: 'X' event needs numeric dur >= 0")
        args = ev.get("args")
        if args is not None:
            try:
                json.dumps(args)
            except (TypeError, ValueError):
                errs.append(f"{where}: args not JSON-serialisable")
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON file")
    ap.add_argument("--validate", metavar="FILE", required=True)
    ns = ap.parse_args(argv)
    try:
        with open(ns.validate) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"INVALID {ns.validate}: {e}")
        return 1
    errs = validate_chrome_trace(obj)
    if errs:
        print(f"INVALID {ns.validate}:")
        for e in errs[:20]:
            print(f"  - {e}")
        return 1
    n = len(obj["traceEvents"]) if isinstance(obj, dict) else len(obj)
    print(f"OK {ns.validate}: {n} events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
