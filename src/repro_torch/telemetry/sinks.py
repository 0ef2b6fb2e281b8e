"""Pluggable step-record sinks: JSONL stream, ring buffer, terminal table
(a copy of :mod:`repro.telemetry.sinks`).

A *sink* consumes the structured per-step records the registry emits.
Protocol (duck-typed, no registration):

    write(record: dict) -> None    # record is already JSON-serialisable
    close() -> None                # flush/teardown; idempotent

The registry fans every record out to all attached sinks, so a run can
stream JSONL to disk, keep the last k steps in memory for the report,
and print a live summary line at once.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional


class JsonlSink:
    """One JSON object per line; append-streamed so a crashed run still
    leaves every completed step on disk."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class MemorySink:
    """Bounded ring buffer of the most recent records (capacity=None keeps
    everything — the report renderer's source)."""

    def __init__(self, capacity: Optional[int] = None):
        self.records: deque = deque(maxlen=capacity)

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass

    def tail(self, k: int) -> List[Dict[str, Any]]:
        return list(self.records)[-k:]


class ConsoleSink:
    """Prints a compact aligned summary line every ``every`` records and a
    closing table of whichever numeric fields the records carried."""

    _COLS = ("step", "loss", "rs_drop_rate", "ag_drop_rate",
             "grad_norm", "div_min")

    def __init__(self, every: int = 50, file=None):
        self.every = max(1, int(every))
        self.file = file
        self._count = 0
        self._header_done = False

    def _print(self, s: str) -> None:
        print(s, file=self.file)

    def write(self, record: Dict[str, Any]) -> None:
        self._count += 1
        if self._count % self.every and self._count != 1:
            return
        cols = [c for c in self._COLS if c in record]
        if not self._header_done and cols:
            self._print("  ".join(f"{c:>14}" for c in cols))
            self._header_done = True
        cells = []
        for c in cols:
            v = record[c]
            cells.append(f"{v:>14}" if isinstance(v, int)
                         else f"{float(v):>14.5g}")
        if cells:
            self._print("  ".join(cells))

    def close(self) -> None:
        pass


def close_all(sinks) -> None:
    for s in sinks:
        s.close()
