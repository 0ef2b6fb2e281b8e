"""Structured per-step records and the run-history container (port of
:mod:`repro.telemetry.record`).

:class:`RunHistory` is the simulator's history mapping (``hist["loss"]``
and the rest, as before) plus ``.records``, the telemetry's list of
JSON-ready per-step dicts, and ``.summary``, the registry's run summary.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on any device and of any dtype as a numpy array (bf16 and
    the other floats numpy lacks widened to f32 first)."""
    x = x.detach().cpu()
    if x.is_floating_point() and x.dtype not in (torch.float32,
                                                 torch.float64,
                                                 torch.float16):
        x = x.to(torch.float32)
    return x.numpy()


def to_jsonable(x: Any) -> Any:
    """Recursively convert a step-stat tree (tensors, numpy arrays,
    scalars, dicts, tuples) into plain JSON types. 0-d arrays become
    numbers, 1-d+ arrays nested lists; floats widen to f64, integers and
    bools to int64, as the reference does."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = _to_numpy(x)
    if isinstance(x, np.ndarray):
        arr = x
        if arr.dtype.kind in "fc":
            arr = arr.astype(np.float64)
        elif arr.dtype.kind in "iub":
            arr = arr.astype(np.int64)
        if arr.ndim == 0:
            v = arr.item()
            # NaN/Inf are not JSON: stringify so the sink never throws
            if isinstance(v, float) and not np.isfinite(v):
                return str(v)
            return v
        return np.where(np.isfinite(arr), arr, 0.0).tolist() \
            if arr.dtype.kind == "f" and not np.isfinite(arr).all() \
            else arr.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return str(x)


def make_step_record(step: int, stats: Optional[Dict[str, Any]] = None,
                     **extra: Any) -> Dict[str, Any]:
    """One JSON-ready step record: the tapped stat bundle flattened
    beside any caller extras (loss, lr, norms…)."""
    rec: Dict[str, Any] = {"step": int(step)}
    for src in (stats or {}), extra:
        for k, v in src.items():
            rec[k] = to_jsonable(v)
    return rec


class RunHistory(dict):
    """The simulator's history mapping plus telemetry attachments:
    ``records`` (the per-step records, empty when telemetry was off) and
    ``summary`` (the registry's run summary)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.records: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}
