"""Delivery counters and norms derived from RPS masks (port of
:mod:`repro.telemetry.counters`): the offered, delivered, late and
corrupt counts, the per-step bundles the exchange taps, the divisor
statistics and the norms the simulator taps.

Masks are the unpadded ``(n, s)`` or per-bucket ``(n_buckets, n, s)``
ones of the channel contract, and the forced owner entries are excluded:
a worker delivering its own block is not a wire event. "Per link" is per
sender row i of the mask.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import rps as rps_lib


def link_delivered(mask: torch.Tensor) -> torch.Tensor:
    """Per-sender delivered packet count, owner entries excluded: ``(n,)``
    int32, summed over the bucket dim of per-bucket masks."""
    n, s = mask.shape[-2], mask.shape[-1]
    non_own = ~rps_lib.owner_mask(n, s, device=mask.device)
    counts = (mask.to(torch.bool) & non_own).sum(-1, dtype=torch.int32)
    if mask.dim() == 3:
        counts = counts.sum(0, dtype=torch.int32)
    return counts


def _np_owner_mask(n: int, s: int) -> np.ndarray:
    own = np.zeros((n, s), bool)
    own[np.arange(s) % n, np.arange(s)] = True
    return own


def link_offered(n: int, s: Optional[int] = None,
                 n_buckets: Optional[int] = None) -> np.ndarray:
    """Per-sender offered (non-owned) packet count per step: ``(n,)``
    int64, a property of the layout."""
    s = n if s is None else int(s)
    offered = s - _np_owner_mask(n, s).sum(axis=1)
    if n_buckets is not None:
        offered = offered * int(n_buckets)
    return offered.astype(np.int64)


def _offered_total(mask: torch.Tensor) -> int:
    n, s = mask.shape[-2], mask.shape[-1]
    nb = mask.shape[0] if mask.dim() == 3 else None
    return int(link_offered(n, s, nb).sum())


def divisor_stats(div: torch.Tensor) -> Dict[str, torch.Tensor]:
    """min / mean / max of the renorm divisor table (any shape), in f32:
    how thin the received averages ran this round."""
    d = div.to(torch.float32)
    return {"min": d.min(), "mean": d.mean(), "max": d.max()}


def global_norm(tree: Any) -> torch.Tensor:
    """l2 norm over every leaf of a tree, accumulated in f32: one
    multi-tensor ``_foreach_norm`` per device and dtype (no f32 copy of a
    leaf), then the root of the summed squares."""
    leaves = [x for x in tree_lib.leaves(tree) if x is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    groups: Dict[tuple, list] = {}
    for x in leaves:
        groups.setdefault((x.device, x.dtype), []).append(x)
    total = None
    for xs in groups.values():
        norms = torch._foreach_norm(xs, 2, dtype=torch.float32)
        sq = torch.stack(norms).square().sum()
        total = sq if total is None else total + sq.to(total.device)
    return total.sqrt()


def consensus_distance(stacked: torch.Tensor) -> torch.Tensor:
    """Mean squared distance to the worker mean of one stacked ``(n,
    …)`` leaf, in f32 (summed over leaves by the caller)."""
    x = stacked.to(torch.float32)
    dev = x - x.mean(0, keepdim=True)
    return (dev * dev).sum(tuple(range(1, x.dim()))).mean()


def mask_step_stats(rs: torch.Tensor,
                    ag: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-step counter bundle of one (rs, ag) draw: per-sender
    delivered counts of both legs, the offered counts and each leg's
    drop rate over the offered packets."""
    rs_d = link_delivered(rs)
    ag_d = link_delivered(ag)
    n, s = rs.shape[-2], rs.shape[-1]
    nb = rs.shape[0] if rs.dim() == 3 else None
    offered = link_offered(n, s, nb)
    tot = max(int(offered.sum()), 1)
    return {"rs_link_delivered": rs_d, "ag_link_delivered": ag_d,
            "link_offered": torch.from_numpy(offered),
            "rs_drop_rate": 1.0 - rs_d.sum().to(torch.float32) / tot,
            "ag_drop_rate": 1.0 - ag_d.sum().to(torch.float32) / tot}


def link_late(late_mask: torch.Tensor) -> torch.Tensor:
    """Per-sender late packet count (an async lateness mask), owner
    entries excluded."""
    return link_delivered(late_mask)


def staleness_stats(late_rs: torch.Tensor,
                    late_ag: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-sender late counts of both legs and ``late_frac``, the
    fraction of the step's offered packets written off as late."""
    rs_l = link_late(late_rs)
    ag_l = link_late(late_ag)
    tot = max(2 * _offered_total(late_rs), 1)
    late = (rs_l.sum() + ag_l.sum()).to(torch.float32)
    return {"rs_link_late": rs_l, "ag_link_late": ag_l,
            "late_frac": late / tot}


def link_corrupt(cmask: torch.Tensor,
                 rs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sender corrupt packet count, owner entries excluded; with
    ``rs`` only the corrupt packets that arrived."""
    m = cmask if rs is None else (cmask & rs.to(torch.bool))
    return link_delivered(m)


def corruption_stats(cmask: torch.Tensor,
                     rs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-sender corrupt-delivered counts and ``corrupt_frac``, the
    fraction of the delivered (non-owner) RS packets that arrived
    wrong."""
    c = link_corrupt(cmask, rs)
    delivered = link_delivered(rs).sum().clamp_min(1).to(torch.float32)
    return {"rs_link_corrupt": c,
            "corrupt_frac": c.sum().to(torch.float32) / delivered}
