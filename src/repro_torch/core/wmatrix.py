"""Global-view reference implementation of RPS (Algorithm 1) — a numpy
copy of :mod:`repro.core.wmatrix`, the port's own exchange oracle.

At step t the j-th block of every worker's next model is a linear
combination of all workers' intermediate blocks: ``X_{t+1}^(j) = V_t^(j) ·
W_t^(j)`` (paper eq. 4). This module samples the drop events exactly as the
paper describes — per-(sender, block) drops in Reduce-Scatter, per-(receiver,
block) drops in All-Gather, owner chosen by a uniform permutation — and
materialises the W matrices. It is the oracle the port's exchange is held
to, and the Monte-Carlo estimator behind the α₁/α₂ validation (Figs 2/3).
Every function is the reference's, op for op, so that both give the same
numbers from the same numpy seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_masks(rng: np.random.Generator, n: int, p: float,
                 permute_owners: bool = True, s: Optional[int] = None):
    """Returns (owners, rs_mask, ag_mask) for s server blocks (default n).

    owners[j]  — worker assigned to average block j. For s == n a uniform
                 permutation (the paper's random owner assignment); for
                 general s the blocks round-robin over a permuted worker
                 order, so multiple blocks share a worker when s > n.
    rs_mask[i, j] — 1 if worker i's block j arrives at owners[j]
                    (owner's own entry always 1: it never leaves the device).
    ag_mask[i, j] — 1 if worker i receives the broadcast of block j
                    (again 1 at i == owners[j]).
    Masks are (n, s); s = None keeps the seed's square draw bit-identically.
    """
    s = n if s is None else int(s)
    order = (rng.permutation(n) if permute_owners
             else np.arange(n)).astype(np.int64)
    owners = order[np.arange(s) % n]
    rs = (rng.random((n, s)) >= p)
    ag = (rng.random((n, s)) >= p)
    rs[owners, np.arange(s)] = True
    ag[owners, np.arange(s)] = True
    return owners, rs, ag


def build_w(n: int, owners, rs_mask, ag_mask) -> np.ndarray:
    """(n_blocks=s, n, n) stack of W^(j); column k = coefficients of worker
    k's next block in terms of all workers' intermediate blocks. The block
    count s is read off the (n, s) masks — s == n is the paper's layout."""
    s = rs_mask.shape[1]
    W = np.zeros((s, n, n))
    for j in range(s):
        m = rs_mask[:, j].astype(np.float64)
        avg_col = m / m.sum()
        for k in range(n):
            if ag_mask[k, j]:
                W[j, :, k] = avg_col
            else:
                W[j, k, k] = 1.0
    return W


def rps_round(V: np.ndarray, rng: np.random.Generator, p: float,
              permute_owners: bool = True,
              return_w: bool = False, s: Optional[int] = None):
    """One RPS averaging round on stacked models V: (n, D) -> (n, D).

    D must be divisible by the block count s (default n; pad upstream).
    Blocks are contiguous D//s slices, block j averaged by ``owners[j]``.
    """
    n, D = V.shape
    s = n if s is None else int(s)
    assert D % s == 0, "pad model to a multiple of s"
    blk = D // s
    owners, rs, ag = sample_masks(rng, n, p, permute_owners, s=s)
    W = build_w(n, owners, rs, ag)
    Xn = np.empty_like(V)
    for j in range(s):
        Vj = V[:, j * blk:(j + 1) * blk]                  # (n, blk)
        Xn[:, j * blk:(j + 1) * blk] = W[j].T @ Vj
    if return_w:
        return Xn, W
    return Xn


def apply_w(V: np.ndarray, W: np.ndarray) -> np.ndarray:
    """Apply a (s, n, n) W-stack to stacked models V (n, s·blk): block j of
    every worker's next model is ``W[j].T @ V^(j)`` (paper eq. 4)."""
    n, D = V.shape
    s = W.shape[0]
    assert D % s == 0, "pad the buffer to a multiple of s"
    blk = D // s
    out = np.empty_like(V)
    for j in range(s):
        out[:, j * blk:(j + 1) * blk] = W[j].T @ V[:, j * blk:(j + 1) * blk]
    return out


def bucketed_round(buffers, rs_masks, ag_masks) -> list:
    """Per-bucket W-matrix oracle for a bucketed ExchangePlan round
    (DESIGN.md §11): bucket b's flat buffer (n, s·blk_b) is transformed by
    the W stack built from *its own* (n, s) mask pair — each bucket column
    is an independent wire packet. Masks may also be a single shared
    (n, s) pair (the legacy one-draw layouts). Returns the transformed
    buffers; this is the reference the plan executors are validated
    against per bucket."""
    rs_masks = np.asarray(rs_masks)
    ag_masks = np.asarray(ag_masks)
    out = []
    for b, V in enumerate(buffers):
        rs = rs_masks[b] if rs_masks.ndim == 3 else rs_masks
        ag = ag_masks[b] if ag_masks.ndim == 3 else ag_masks
        n = V.shape[0]
        W = build_w(n, np.arange(rs.shape[1]) % n, rs, ag)
        out.append(apply_w(np.asarray(V, np.float64), W))
    return out


def monte_carlo_alphas(n: int, p: float, trials: int = 2000,
                       seed: int = 0) -> Tuple[float, float]:
    """Estimate α₁ (from E[WWᵀ]) and α₂ (from E[W Aₙ Wᵀ]).

    The paper shows E[WWᵀ] = α₁I + (1−α₁)Aₙ and E[W Aₙ Wᵀ] = α₂I + (1−α₂)Aₙ;
    we recover α = (n·m̄_diag − 1)/(n − 1) with m̄_diag the mean diagonal of
    the estimated matrix.
    """
    rng = np.random.default_rng(seed)
    A = np.full((n, n), 1.0 / n)
    M1 = np.zeros((n, n))
    M2 = np.zeros((n, n))
    for _ in range(trials):
        owners, rs, ag = sample_masks(rng, n, p)
        W = build_w(n, owners, rs, ag)[0]                  # blocks iid: use j=0
        M1 += W @ W.T
        M2 += W @ A @ W.T
    M1 /= trials
    M2 /= trials
    a1 = (n * np.trace(M1) / n - 1.0) / (n - 1.0)
    a2 = (n * np.trace(M2) / n - 1.0) / (n - 1.0)
    return float(a1), float(a2)


# ---- adversarial extension: corruption masks + robust rounds ---------------
# (DESIGN.md §17). The W-matrix formalism only covers *linear* rounds —
# a robust aggregate (median/trimmed/clip) is not a fixed matrix applied
# to the contributions, so the adversarial oracle materialises the
# per-block contribution tables directly. This is the numpy reference
# the robust exchange paths are held to.

def sample_corrupt_mask(rng: np.random.Generator, n: int, s: int,
                        frac: float = 0.0, byzantine_frac: float = 0.0,
                        owners=None) -> np.ndarray:
    """Bool (n, s) corruption mask matching ``channels.corruption``'s
    structure: i.i.d. Bernoulli(frac) links, plus ⌊byzantine_frac·n⌋
    colluding rows corrupting everything; owner entries never corrupt
    (that copy never crosses the wire)."""
    m = rng.random((n, s)) < frac
    f = int(byzantine_frac * n + 1e-9)
    if f > 0:
        m[:f, :] = True
    if owners is not None:
        m[np.asarray(owners), np.arange(s)] = False
    return m


def np_robust_aggregate(rows: np.ndarray, kind: str, beta: float = 0.1,
                        clip_mult: float = 2.0) -> np.ndarray:
    """Robust aggregate of the delivered contribution rows (c, d) — the
    numpy twin of ``core.robust``'s masked estimators on the delivered
    subset."""
    rows = np.asarray(rows, np.float64)
    c = rows.shape[0]
    if kind == "median":
        return np.median(rows, axis=0)
    if kind == "trimmed":
        srt = np.sort(rows, axis=0)
        t = min(int(beta * c), (c - 1) // 2)
        return srt[t:c - t].mean(axis=0)
    if kind == "clip":
        norms = np.sqrt((rows ** 2).sum(axis=1))
        tau = clip_mult * np.median(norms)
        fac = np.minimum(1.0, tau / np.maximum(norms, 1e-30))
        return (rows * fac[:, None]).sum(axis=0) / c
    raise ValueError(f"not a robust kind: {kind!r}")


def robust_round(V: np.ndarray, owners, rs, ag, cmask,
                 corrupt_fn, kind: str, beta: float = 0.1,
                 clip_mult: float = 2.0) -> np.ndarray:
    """One adversarial RPS round on stacked models V (n, s·blk): each
    corrupted contribution (``cmask[i, j]`` True) is transformed by
    ``corrupt_fn`` before it reaches block j's aggregation site; the
    owner aggregates the *delivered* rows with the robust ``kind``; the
    AG leg broadcasts as usual (a dropped broadcast keeps the receiver's
    own **honest** block — a worker never corrupts its own copy)."""
    V = np.asarray(V, np.float64)
    n, D = V.shape
    s = rs.shape[1]
    assert D % s == 0
    blk = D // s
    out = V.copy()
    for j in range(s):
        Vj = V[:, j * blk:(j + 1) * blk]
        offered = Vj.copy()
        bad = np.asarray(cmask[:, j], bool)
        if bad.any():
            offered[bad] = corrupt_fn(Vj[bad])
        agg = np_robust_aggregate(offered[np.asarray(rs[:, j], bool)],
                                  kind, beta=beta, clip_mult=clip_mult)
        for i in range(n):
            if ag[i, j]:
                out[i, j * blk:(j + 1) * blk] = agg
    return out
