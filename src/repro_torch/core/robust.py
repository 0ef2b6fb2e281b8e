"""Masked robust aggregators for Byzantine-tolerant recovery (port of
:mod:`repro.core.robust`).

The renorm / scale recoveries average the delivered contributions, so one
adversarial row moves the mean arbitrarily far. These estimators take the
same masked layout instead:

    x    : (..., n, d)  per-worker contributions along dim -2
    mask : (..., n)     delivery mask (True = the packet arrived)

and aggregate over the delivered rows only, in f32, returning the input
dtype. The algorithm is the reference's: undelivered rows are pushed to
+inf, the worker dim is sorted once, and the order statistics are read at
the delivered count ``c = sum(mask)`` (clamped to ≥ 1):

- median ``0.5·(sorted[(c−1)//2] + sorted[c//2])`` (``torch.median``
  returns the lower middle value for an even count, so it is not used);
- β-trimmed mean over the ranks ``[t, c − t)``, ``t = min(int(β·c),
  (c−1)//2)`` with ``β·c`` in f32 (the reference's weak types round it
  there), masked before it sums (``0·inf`` is NaN);
- norm-clip mean: each delivered row clipped to ``clip_mult ×`` the masked
  median of the delivered row norms, then the masked mean.

:func:`robust_aggregate` runs over column chunks of at most
``max_elems`` table elements, so the sort's values and int64 indices never
span the whole table (the clip's norms accumulate chunk by chunk). The
CPU tests' tables fit one chunk: the same ops as the reference's.
"""
from __future__ import annotations

import torch

#: column-chunk budget of :func:`robust_aggregate`, in table elements:
#: the sort's f32 values and int64 indices take 12 bytes an element
MAX_CHUNK_ELEMS = 64 * 2 ** 20


def _counts(mask: torch.Tensor) -> torch.Tensor:
    """Delivered count per aggregation site, clamped to ≥ 1 (int32)."""
    return mask.to(torch.int32).sum(-1, dtype=torch.int32).clamp_min(1)


def _sorted_masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The worker dim sorted with the undelivered rows pushed to +inf."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    return torch.sort(torch.where(mask[..., None], x.to(torch.float32), inf),
                      dim=-2).values


def _at_rank(xs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Row ``rank`` (…,) of the sorted (…, n, d) stack: (…, d)."""
    idx = rank.to(torch.int64)[..., None, None].expand(
        tuple(xs.shape[:-2]) + (1, xs.shape[-1]))
    return torch.gather(xs, -2, idx)[..., 0, :]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the delivered rows: x (…, n, d), mask
    (…, n) bool -> (…, d) in x's dtype."""
    xs = _sorted_masked(x, mask)
    c = _counts(mask)
    lo = _at_rank(xs, torch.div(c - 1, 2, rounding_mode="floor"))
    hi = _at_rank(xs, torch.div(c, 2, rounding_mode="floor"))
    return (0.5 * (lo + hi)).to(x.dtype)


def _trim_count(c: torch.Tensor, beta: float) -> torch.Tensor:
    beta_c = torch.tensor(float(beta), dtype=torch.float32,
                          device=c.device) * c.to(torch.float32)
    return torch.minimum(beta_c.to(torch.int32),
                         torch.div(c - 1, 2, rounding_mode="floor"))


def _check_beta(beta: float) -> None:
    if not 0.0 <= float(beta) < 0.5:
        raise ValueError(f"beta={beta} must be in [0, 0.5)")


def _check_clip(clip_mult: float) -> None:
    if not float(clip_mult) > 0.0:
        raise ValueError(f"clip_mult={clip_mult} must be > 0")


def masked_trimmed_mean(x: torch.Tensor, mask: torch.Tensor,
                        beta: float = 0.1) -> torch.Tensor:
    """β-trimmed mean over the delivered rows: the ``int(β·c)`` smallest
    and largest order statistics of each coordinate dropped (at most
    ``(c−1)//2``, so one rank survives), the rest averaged."""
    _check_beta(beta)
    xs = _sorted_masked(x, mask)
    c = _counts(mask)
    t = _trim_count(c, beta)
    rank = torch.arange(x.shape[-2], device=x.device)
    keep = (rank >= t[..., None]) & (rank < (c - t)[..., None])
    contrib = torch.where(keep[..., None], xs,
                          torch.zeros((), dtype=torch.float32,
                                      device=x.device))
    denom = (c - 2 * t).to(torch.float32)[..., None]
    return (contrib.sum(-2) / denom).to(x.dtype)


def _clip_factor(norms: torch.Tensor, mask: torch.Tensor,
                 clip_mult: float) -> torch.Tensor:
    """min(1, τ / max(‖x_i‖, 1e-30)), τ = clip_mult × the masked median
    of the delivered norms: (…, n) f32."""
    mult = torch.tensor(float(clip_mult), dtype=torch.float32,
                        device=norms.device)
    tau = mult * masked_median(norms[..., None], mask)[..., 0]
    one = torch.ones((), dtype=torch.float32, device=norms.device)
    return torch.minimum(one, tau[..., None] / norms.clamp_min(1e-30))


def _clip_sum(x: torch.Tensor, mask: torch.Tensor,
              factor: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)[..., None]
    return (x.to(torch.float32) * factor[..., None] * m).sum(-2)


def masked_clip_mean(x: torch.Tensor, mask: torch.Tensor,
                     clip_mult: float = 2.0) -> torch.Tensor:
    """Norm-clip-then-renorm: each delivered row clipped to norm ``τ =
    clip_mult × median(delivered row norms)``, then the masked mean."""
    _check_clip(clip_mult)
    xf = x.to(torch.float32)
    norms = torch.sqrt(torch.sum(xf * xf, dim=-1))
    factor = _clip_factor(norms, mask, clip_mult)
    c = _counts(mask).to(torch.float32)[..., None]
    return (_clip_sum(xf, mask, factor) / c).to(x.dtype)


def _kind(recovery) -> str:
    return getattr(recovery, "kind", recovery)


def robust_aggregate(x: torch.Tensor, mask: torch.Tensor, recovery,
                     max_elems: int = MAX_CHUNK_ELEMS,
                     dtype=None) -> torch.Tensor:
    """The robust aggregate ``recovery.kind`` prescribes (a robust
    :class:`repro_torch.core.wire.Recovery`, or a kind name) of x (…, n, d)
    over mask (…, n): (…, d) in ``dtype`` (default x's), computed in f32
    over column chunks of at most ``max_elems`` elements of x. ``x`` may be
    a strided view (the exchange hands in the transposed send); each chunk
    is copied once."""
    dtype = x.dtype if dtype is None else dtype
    kind = _kind(recovery)
    if kind not in ("median", "trimmed", "clip"):
        raise ValueError(f"not a robust recovery kind: {kind!r}")
    beta = float(getattr(recovery, "beta", 0.1))
    clip_mult = float(getattr(recovery, "clip_mult", 2.0))
    if kind == "trimmed":
        _check_beta(beta)
    if kind == "clip":
        _check_clip(clip_mult)
    d = x.shape[-1]
    per_col = max(x.numel() // max(d, 1), 1)
    step = max(int(max_elems) // per_col, 1)
    spans = [(a, min(a + step, d)) for a in range(0, d, step)] or [(0, 0)]
    if kind == "clip":
        sq = None
        for a, b in spans:
            xc = x[..., a:b].to(torch.float32)
            part = torch.sum(xc * xc, dim=-1)
            sq = part if sq is None else sq.add_(part)
            del xc
        factor = _clip_factor(torch.sqrt(sq), mask, clip_mult)
        c = _counts(mask).to(torch.float32)[..., None]
        out = torch.empty(tuple(x.shape[:-2]) + (d,), dtype=dtype,
                          device=x.device)
        for a, b in spans:
            out[..., a:b] = _clip_sum(x[..., a:b], mask, factor) / c
        return out
    fn = masked_median if kind == "median" else (
        lambda xc, m: masked_trimmed_mean(xc, m, beta))
    out = torch.empty(tuple(x.shape[:-2]) + (d,), dtype=dtype,
                      device=x.device)
    for a, b in spans:
        out[..., a:b] = fn(x[..., a:b].to(torch.float32), mask)
    return out
