"""Step-time tap context: counters out of a simulator step (port of
:mod:`repro.telemetry.taps`).

The reference collects its counters at trace time and returns them as
extra outputs of the jitted step, so the primary outputs are untouched by
construction. The port runs eagerly and updates parameters and optimizer
state in place, so the same contract is kept by discipline:

  * a step installs a :class:`TapCollector` around its body
    (``with tap_collector() as tap:``);
  * instrumented code calls :func:`emit` with a *reduction* it computed
    for the tap — a new small tensor, never a live buffer or a view of
    one (a view would read later in-place values, and would pin a whole
    stacked replica across steps) — and :func:`annotate` with static
    Python metadata;
  * the step returns ``tap.tree()`` as one extra output; the tensors stay
    on the device until the caller drains them after its loop.

With no collector installed (the default), :func:`emit` is a no-op, and
every instrumented site guards its computation with ``active() is not
None``, so a telemetry-off step launches nothing new. Collectors nest;
emissions go to the innermost one.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_local = threading.local()


def _stack() -> List["TapCollector"]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


class TapCollector:
    """Accumulates tapped tensors and static metadata during one step.

    ``taps`` maps name -> tensor (or a list of them when the same name is
    emitted repeatedly, e.g. once per exchange group); ``meta`` maps name
    -> a static Python value.
    """

    def __init__(self) -> None:
        self.taps: Dict[str, Any] = {}
        self.meta: Dict[str, Any] = {}

    def add(self, name: str, value: Any) -> None:
        if name in self.taps:
            cur = self.taps[name]
            if isinstance(cur, list):
                cur.append(value)
            else:
                self.taps[name] = [cur, value]
        else:
            self.taps[name] = value

    def tree(self) -> Dict[str, Any]:
        """The tap dict a step returns as its extra output."""
        return dict(self.taps)


@contextmanager
def tap_collector():
    """Install a collector for the duration of a step body."""
    col = TapCollector()
    _stack().append(col)
    try:
        yield col
    finally:
        _stack().pop()


def active() -> Optional[TapCollector]:
    st = _stack()
    return st[-1] if st else None


def emit(name: str, value: Any) -> None:
    """Tap ``value`` under ``name``; no-op without a collector. ``value``
    must be a tensor computed for the tap, never fed back into the
    step's computation."""
    col = active()
    if col is not None:
        col.add(name, value)


def annotate(name: str, value: Any) -> None:
    """Record static metadata, e.g. wire bytes from the plan."""
    col = active()
    if col is not None:
        col.meta[name] = value
