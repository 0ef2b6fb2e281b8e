"""RPS exchange on one device (port of :mod:`repro.core.rps`).

The paper's drop-tolerant reduce-scatter / all-gather round (Algorithm 1)
on *stacked* worker tensors (leading dim n), with boolean ``(n, s)`` drop
masks whose owner entries (block j is owned by worker ``j % n``) are
always delivered:

  - RS-drop: worker i's block-j contribution is left out of the owner's
    sum when ``rs[i, j]`` is False; the owner renormalises by the
    received count (model / grad_renorm modes) or divides by n (the
    fragile "grad" baseline);
  - AG-drop: receiver i keeps its own pre-average block j when
    ``ag[i, j]`` is False (model mode), or applies no update (grad modes).

On a CUDA stack the renormalised average runs on the hand-written masked
average kernel (``kernels/masked_avg.py``), as the JAX package uses its
Pallas kernel on a TPU; there is no fallback to the plain version.
Ported so far: :func:`rps_exchange_global` with ``engine="xla"``, the
linear codecs and the renorm / scale recoveries. The ring engine, the
collective paths, error feedback, corruption and telemetry taps are still
to port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import wire as wire_lib
from repro_torch.kernels import masked_avg as masked_avg_lib


def owners(n: int, s: Optional[int] = None, *,
           device="cpu") -> torch.Tensor:
    """Block → owner-worker map: block j is averaged by worker j % n."""
    s = n if s is None else int(s)
    return torch.arange(s, device=device) % n


def owner_mask(n: int, s: Optional[int] = None, *,
               device="cpu") -> torch.Tensor:
    """Boolean (n, s), True at (owner(j), j) — the entries every drop
    mask forces True (the identity when s == n)."""
    s = n if s is None else int(s)
    m = torch.zeros((n, s), dtype=torch.bool, device=device)
    m[owners(n, s, device=device), torch.arange(s, device=device)] = True
    return m


def sample_masks(gen: torch.Generator, n: int, p: float,
                 s: Optional[int] = None,
                 n_buckets: Optional[int] = None):
    """(rs, ag) boolean (n, s) i.i.d. Bernoulli(1−p) delivery masks with
    owner entries forced True, drawn from ``gen`` on its device;
    ``n_buckets`` gives independent ``(n_buckets, n, s)`` draws."""
    s = n if s is None else int(s)
    shape = (n, s) if n_buckets is None else (int(n_buckets), n, s)
    rs = torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p
    ag = torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p
    own = owner_mask(n, s, device=gen.device)
    return rs | own, ag | own


def _divisor(rec: wire_lib.Recovery, mode: str, rs: torch.Tensor,
             n: int) -> torch.Tensor:
    """The (…, S) f32 per-block divisor the recovery prescribes, from
    (…, n, S) RS masks: the received count (renorm in model /
    grad_renorm modes), n (the naive "grad" mode), or the expected count
    n(1−p) (``scale``, every mode)."""
    shape = tuple(rs.shape[:-2]) + tuple(rs.shape[-1:])
    if rec.kind == "scale":
        return torch.full(shape, rec.expected_count(n), dtype=torch.float32,
                          device=rs.device)
    if mode in ("model", "grad_renorm"):
        return rs.to(torch.float32).sum(-2).clamp_min(1.0)
    if mode == "grad":
        return torch.full(shape, float(n), dtype=torch.float32,
                          device=rs.device)
    raise ValueError(mode)


def rps_exchange_global(tree: torch.Tensor, gen: Optional[torch.Generator],
                        p: float, n: int, *, mode: str = "model",
                        masks=None,
                        s: Optional[int] = None,
                        plan: Optional[plan_lib.ExchangePlan] = None,
                        engine: str = "xla",
                        rs_dtype=torch.float32, wire=None,
                        recovery=None, ef_state=None, late=None,
                        corruption=None,
                        corrupt_masks=None) -> torch.Tensor:
    """Global-view exchange of a stacked tensor ``tree`` (leading dim n).

    ``masks``: a precomputed ``(rs, ag)`` pair, ``(n, s)`` or per-bucket
    ``(n_buckets, n, s)``; otherwise drawn from ``gen`` with drop rate p.
    ``plan``: the layout over the per-worker tensor (leading n stripped);
    ``None`` builds the single-bucket plan. ``wire``/``recovery`` default
    to the plan's fields; a codec narrower than the payload rounds each
    contribution to the wire dtype before the f32-accumulated sum.
    The renorm average runs through the masked-average kernel's wrapper
    (the kernel on a CUDA stack, its plain version on a CPU stack), so
    it comes back in the wire dtype, as the JAX package's Pallas route
    returns it; the other divisors take an f32 einsum.
    ``ef_state``, ``late``, ``corruption`` and ``corrupt_masks`` (error
    feedback, async lateness, Byzantine corruption) are not ported yet
    and raise.
    """
    if any(a is not None for a in (ef_state, late, corruption,
                                   corrupt_masks)):
        raise NotImplementedError("ef_state / late / corruption are not "
                                  "ported yet")
    if plan is None:
        if masks is not None:
            s = masks[0].shape[-1]
        per_worker = torch.empty(tree.shape[1:], dtype=tree.dtype,
                                 device="meta")
        plan = plan_lib.make_plan(per_worker, n, s)
    wire = plan.wire if wire is None else wire
    recovery = plan.recovery if recovery is None else recovery
    codec = wire_lib.resolve_codec(wire, rs_dtype)
    rec = wire_lib.make_recovery(recovery, p=p)
    if mode not in ("model", "grad", "grad_renorm"):
        raise ValueError(mode)
    if engine in (None, "auto"):
        engine = "xla"
    elif engine == "ring":
        raise NotImplementedError("engine='ring' is not ported yet")
    elif engine != "xla":
        raise ValueError(f"engine={engine!r}")
    if masks is None:
        if gen is None:
            raise ValueError("give masks= or a generator to draw them")
        rs, ag = sample_masks(gen, n, p, plan.s)
    else:
        rs, ag = masks
        if rs.dim() == 3:
            if rs.shape[0] != plan.n_buckets:
                raise ValueError(f"per-bucket masks carry {rs.shape[0]} "
                                 f"buckets, plan has {plan.n_buckets}")
            rs, ag = rs[0], ag[0]
    renorm = mode in ("model", "grad_renorm")
    # the masked-average kernel renormalises by the received count
    # internally; the scale divisor takes the einsum path
    use_kernel = renorm and rec.kind != "scale"

    s = plan.s
    (bk,) = plan.buckets
    (table,) = plan.gather(tree, lead=1)             # (n, s, blk, m)
    stack = table.reshape(n, s, bk.blk * bk.m)
    send = stack
    if codec.wire_dtype.itemsize < stack.dtype.itemsize:
        send = stack.to(codec.wire_dtype)            # round to the wire grid
    if use_kernel:
        # (s, n, d) per-block stacks and the raw (s, n) mask: the kernel
        # casts the mask itself, so no float copy of it is made
        tilde = masked_avg_lib.masked_avg_grid(
            send.transpose(0, 1).contiguous(), rs.t().contiguous())
    else:
        sums = torch.einsum("ij,ijd->jd", rs.to(torch.float32),
                            send.to(torch.float32))
        tilde = sums / _divisor(rec, mode, rs, n)[:, None]
    gathered = tilde.to(stack.dtype)[None]           # the AG payload
    ag = ag.to(torch.bool)[..., None]
    if renorm:
        out = torch.where(ag, gathered, stack)       # fallback: own block
    else:
        out = gathered * ag.to(stack.dtype)          # no update on a drop
    return plan.scatter([out.reshape(n, s, bk.blk, bk.m)], lead=1)
