"""The collective path's transfers (the JAX package's transport is
``lax``: ``psum_scatter``, ``all_gather``, ``ppermute``, ``psum``).

The only module of the port that calls :mod:`torch.distributed`. Each
function works over a :class:`Group`, one rank's view of a process group
over some of a mesh's axes (:meth:`repro_torch.launch.mesh.Mesh.group`):

- :func:`reduce_scatter` / :func:`all_gather`: tiled over dim 0, the
  group's ranks in their flattened-index order (``lax.psum_scatter(...,
  tiled=True)`` / ``lax.all_gather(..., tiled=True)`` over the axes);
- :func:`ring_shift`: every rank sends to its right neighbour in an
  explicit ring order and receives from its left (``lax.ppermute`` with
  ``perm = [(j, j + 1 mod n)]``);
- :func:`all_reduce_mean` (``psum / n``, the reliable average and the
  allreduce baselines) and :func:`all_reduce_sum`.

Transport: gloo. It carries CPU tensors, and a CUDA tensor through
pinned host buffers of this module's own, reused from call to call (one
per role, grown to the largest payload); :data:`STATS` counts the bytes
staged and the transfers made. Inside a :func:`recording` scope every
collective is also listed under the op its counterpart in the JAX
package's program would be (the dry-run prices them,
``roofline/analysis.py::collective_bytes``); outside one nothing is
kept. A meta
tensor (the dry-run's count of one rank's step) is recorded and answered
with an empty result of the right shape; nothing is sent. NCCL is
refused (:func:`check_backend`): it takes no two ranks on one card, and
the route of a host with a card a rank is not written.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: what the transfers did since the last :func:`reset_stats`: the bytes
#: copied between the card and the host buffers (both ways), and the
#: collective and point-to-point calls made
STATS: Dict[str, int] = {"staged_bytes": 0, "transfers": 0}

# the lists of the open recording() scopes, innermost last
_SCOPES: List[List[Tuple[str, int, int]]] = []

# the tiled collectives under their current names (older torch has only
# the *_tensor spellings)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

# pinned host buffers by role, grown to the largest payload staged so far
_BUFFERS: Dict[str, torch.Tensor] = {}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, int, int]]]:
    """Yields a list that gets the collectives made inside, one
    ``(op, payload bytes, group size)`` a call (a tensor, for
    :func:`ring_shift`): ``op`` the HLO collective the JAX package's
    program runs there (``tools/check_hlo.py``'s ``COLLECTIVE_OPS``), the
    bytes those of its result: the reduce-scatter's shard, the
    all-gather's gathered tensor, the all-reduce's tensor, the permuted
    tensor. Scopes nest; each gets every call made inside it."""
    records: List[Tuple[str, int, int]] = []
    _SCOPES.append(records)
    try:
        yield records
    finally:
        _SCOPES.pop()


def _record(op: str, shape: Sequence[int], dtype: torch.dtype,
            n: int) -> None:
    if not _SCOPES:
        return
    nbytes = dtype.itemsize
    for d in shape:
        nbytes *= int(d)
    for records in _SCOPES:
        records.append((op, nbytes, n))


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` is gloo, the one transport this module
    carries (CPU tensors, and CUDA tensors through its host staging).
    NCCL refuses two ranks on one card, and the route of a host with a
    card a rank is not written (ROADMAP queue A): asking for it raises
    rather than switching transports quietly."""
    if backend == "nccl":
        raise ValueError(
            "backend='nccl' is not supported: NCCL refuses two ranks on "
            "one card, and the route of a host with one card a rank is "
            "unverified (ROADMAP queue A); use backend='gloo' "
            "(host-staged)")
    if backend != "gloo":
        raise ValueError(f"backend={backend!r}, want 'gloo'")


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of a process group: ``ranks`` the global ranks in
    the group's flattened-index order, ``index`` this rank's place in
    it, ``pg`` the process group (None for a group of one)."""
    pg: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _buffer(role: str, shape: Sequence[int], dtype: torch.dtype
            ) -> torch.Tensor:
    """A pinned host tensor of ``shape`` and ``dtype``, a view of the
    role's byte buffer (grown when it is too small)."""
    n = 1
    for d in shape:
        n *= int(d)
    nbytes = n * dtype.itemsize
    buf = _BUFFERS.get(role)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          pin_memory=True)
        _BUFFERS[role] = buf
    return buf[:nbytes].view(dtype).view(tuple(shape))


def _to_host(x: torch.Tensor, role: str) -> torch.Tensor:
    host = _buffer(role, x.shape, x.dtype)
    host.copy_(x)
    STATS["staged_bytes"] += x.numel() * x.element_size()
    return host


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    out.copy_(host)
    STATS["staged_bytes"] += host.numel() * host.element_size()
    return out


def reduce_scatter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Σ over the group's ranks of ``x`` (S, …), rank j keeping rows
    [j·S/n, (j+1)·S/n): (S/n, …) on ``x``'s device."""
    n = group.size
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} "
                         "ranks")
    if n == 1:
        return x.clone()
    x = x.contiguous()
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    _record("reduce_scatter", shape, x.dtype, n)
    if x.device.type == "meta":
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    STATS["transfers"] += 1
    if x.device.type == "cuda":
        src = _to_host(x, "rs_in")
        dst = _buffer("rs_out", shape, x.dtype)
        _REDUCE_SCATTER(dst, src, group=group.pg)
        return _to_device(dst, x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x, group=group.pg)
    return out


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` (k, …) stacked in the group's order:
    (n·k, …) on ``x``'s device."""
    n = group.size
    if n == 1:
        return x.clone()
    x = x.contiguous()
    shape = (x.shape[0] * n,) + tuple(x.shape[1:])
    _record("all_gather", shape, x.dtype, n)
    if x.device.type == "meta":
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    STATS["transfers"] += 1
    if x.device.type == "cuda":
        src = _to_host(x, "ag_in")
        dst = _buffer("ag_out", shape, x.dtype)
        _ALL_GATHER(dst, src, group=group.pg)
        return _to_device(dst, x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x, group=group.pg)
    return out


def ring_shift(xs: Sequence[torch.Tensor], group: Group,
               order: Sequence[int]) -> List[torch.Tensor]:
    """Send each of ``xs`` to the right neighbour in ``order`` (global
    ranks, the ring's order) and receive the left neighbour's, of the
    same shapes and dtypes, in one batch of point-to-point transfers."""
    order = list(order)
    me = group.ranks[group.index]
    pos = order.index(me)
    n = len(order)
    if n == 1:
        return [x.clone() for x in xs]
    right, left = order[(pos + 1) % n], order[(pos - 1) % n]
    for x in xs:
        _record("collective_permute", x.shape, x.dtype, n)
    if any(x.device.type == "meta" for x in xs):
        return [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                for x in xs]
    sends, recvs, staged = [], [], []
    for j, x in enumerate(xs):
        x = x.contiguous()
        STATS["transfers"] += 1
        staged.append(x.device.type == "cuda")
        if staged[-1]:
            sends.append(_to_host(x, f"send{j}"))
            recvs.append(_buffer(f"recv{j}", x.shape, x.dtype))
        else:
            sends.append(x)
            recvs.append(torch.empty_like(x))
    ops = [dist.P2POp(dist.isend, t, right, group=group.pg) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, left, group=group.pg) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_to_device(r, x.device) if st else r
            for r, x, st in zip(recvs, xs, staged)]


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Σ over the group's ranks of ``x``, on ``x``'s device."""
    if group.size == 1:
        return x.clone()
    x = x.contiguous()
    _record("all_reduce", x.shape, x.dtype, group.size)
    if x.device.type == "meta":
        return torch.empty_like(x)
    STATS["transfers"] += 1
    if x.device.type == "cuda":
        host = _to_host(x, "ar")
        dist.all_reduce(host, group=group.pg)
        return _to_device(host, x.device)
    out = x.clone()
    dist.all_reduce(out, group=group.pg)
    return out


def all_reduce_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The exact mean over the group's ranks of ``x`` (the sum, then a
    division by the group's size, as ``psum`` then ``/ n``)."""
    return all_reduce_sum(x, group) / group.size
