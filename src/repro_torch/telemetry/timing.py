"""One bench timer for the port (port of :mod:`repro.telemetry.timing`).

  :func:`time_fn`    one call, warm-up calls, then best-of-``reps``
                     batches of ``iters`` calls with ONE device sync per
                     batch: the steady-state per-call latency (seconds).
  :func:`wallclock`  a context manager for one-shot end-to-end sections
                     (a whole simulation run, a curve sweep).

The sync is ``torch.cuda.synchronize`` on each card an output tensor
lives on (none for CPU outputs). Both report into the current
:class:`repro_torch.telemetry.Telemetry` registry, when one is installed
(``set_current`` / ``enabled``): each labelled measurement becomes a row
of its timing table and an instant in its trace.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.telemetry import registry as registry_lib


def _sync(x: Any) -> None:
    """Wait for every card an output tensor of ``x`` lives on."""
    devices = {leaf.device for leaf in tree_lib.leaves(x)
               if isinstance(leaf, torch.Tensor)
               and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, reps: int = 5, iters: int = 1,
            warmup: Optional[int] = None, label: Optional[str] = None,
            **kwargs) -> float:
    """Steady-state seconds per call of ``fn(*args, **kwargs)``: one
    synced call, ``warmup`` more (default ``max(1, iters // 2)``, synced
    once), then ``reps`` batches of ``iters`` back-to-back calls with one
    sync per batch; returns the best batch's per-call time. ``label``
    reports it into the current registry (no-op without one)."""
    out = fn(*args, **kwargs)
    _sync(out)
    for _ in range(max(1, iters // 2) if warmup is None else warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            out = fn(*args, **kwargs)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / max(1, iters))
    if label is not None:
        _report(label, best)
    return best


class _Clock:
    """Result object of :func:`wallclock`: ``.s`` seconds, ``.us`` /
    ``.ms`` for the benches' CSV conventions."""
    s: float = 0.0

    @property
    def us(self) -> float:
        return self.s * 1e6

    @property
    def ms(self) -> float:
        return self.s * 1e3


@contextmanager
def wallclock(label: Optional[str] = None):
    """``with wallclock("convergence.p0.1") as w: ...; w.us`` — one-shot
    wall clock of a section (the section syncs what it needs), reported
    into the current registry when ``label`` is given."""
    w = _Clock()
    t0 = time.perf_counter()
    try:
        yield w
    finally:
        w.s = time.perf_counter() - t0
        if label is not None:
            _report(label, w.s)


def _report(label: str, seconds: float) -> None:
    reg = registry_lib.get_current()
    if reg is not None:
        reg.note_timing(label, seconds)
