"""Meshes of ranks (port of :mod:`repro.launch.mesh`).

The JAX package lays one program over a device mesh with named axes
(``jax.make_mesh``) and runs the exchange inside ``shard_map``. The port
runs one process per rank: a :class:`Mesh` names the axes of a
``torch.distributed`` world laid out row-major (the last axis fastest),
gives each rank its coordinates, and hands out one process group per set
of axes an exchange runs over (the ranks that share every other
coordinate), as :class:`repro_torch.core.comm.Group`.

Why a mesh of the port's own and not
``torch.distributed.device_mesh.DeviceMesh``: the card's machine has one
GPU, so its ranks share ``cuda:0`` over the gloo backend, with the CUDA
tensors staged through host buffers (:mod:`repro_torch.core.comm`).
``DeviceMesh`` ties a ``"cuda"`` mesh to NCCL and one device a rank; this
mesh builds its groups with ``dist.new_group(ranks, backend=...)`` over
the world's gloo backend.

The JAX package's TPU lowering helpers (``mesh_context``, the explicit
axis types) have no counterpart: there is no compiler mesh to install.

  single pod: (16, 16)    over ("data", "model")        — 256 ranks
  multi pod:  (2, 16, 16) over ("pod", "data", "model") — 512 ranks

RPS runs over ("data",) / ("pod", "data") for rps_model, over ("pod",)
for rps_grad; "model" is the reliable tensor-parallel direction.

:func:`run_world` starts a world of ranks on this host (the tests' and
``chip_smoke.py``'s): spawned processes, a ``file://`` rendezvous in a
temporary directory, ``launch/env.py``'s thread cap in each child, the
backend explicit.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import comm
from repro_torch.launch import env as env_lib

class Mesh:
    """Named axes over a world of ``prod(shape)`` ranks, row-major.

    Built before ``torch.distributed`` is started, or in a world of
    another size, it is a shape only (``rank`` None): it answers sizes
    and coordinates but hands out no groups. :meth:`as_rank` makes such
    a mesh answer as one of its ranks with groups that carry no process
    group: the dry-run's count of one rank's step on meta tensors, which
    ``core/comm.py`` records and never sends."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(d) for d in shape)))
        self.size = 1
        for d in self.shape.values():
            self.size *= d
        self.rank: Optional[int] = None
        self.backend: Optional[str] = None
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() == self.size:
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
        if self.backend is not None:
            comm.check_backend(self.backend)
        self._groups: Dict[Tuple[str, ...], comm.Group] = {}
        self.virtual = False

    def as_rank(self, rank: int = 0) -> "Mesh":
        """This mesh's shape, answering as ``rank`` without a world: its
        groups have ``pg`` None, so only meta tensors may go through
        them."""
        out = Mesh(tuple(self.shape.values()), self.axis_names)
        out.rank, out.backend, out.virtual = int(rank), None, True
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")

    def _names(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in {self.axis_names}")
        return names

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The rank's coordinate on every axis (default: this rank)."""
        rank = self.rank if rank is None else int(rank)
        if rank is None:
            raise ValueError("a shape-only mesh has no rank")
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + int(coords[a])
        return rank

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._names(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """The rank's index over ``axes`` flattened major to minor in the
        order given (the JAX package's ``_my_index``)."""
        c = self.coords(rank)
        idx = 0
        for a in self._names(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_ranks(self, axes, rank: Optional[int] = None) -> List[int]:
        """The ranks that share every coordinate off ``axes`` with
        ``rank``, in the order of their index over ``axes``."""
        names = self._names(axes)
        base = self.coords(rank)
        out = []
        for idx in range(self.axis_size(names)):
            c = dict(base)
            for a in reversed(names):
                c[a] = idx % self.shape[a]
                idx //= self.shape[a]
            out.append(self.rank_of(c))
        return out

    def group(self, axes) -> comm.Group:
        """This rank's process group over ``axes``. The first call for a
        set of axes builds every group of it on every rank (collective:
        every rank must ask for the same axes in the same order)."""
        names = self._names(axes)
        if self.rank is None:
            raise ValueError("a shape-only mesh hands out no groups; start "
                             "torch.distributed with its size first")
        if names in self._groups:
            return self._groups[names]
        mine = self.group_ranks(names)
        if mine != sorted(mine):
            raise ValueError(f"axes {names} must follow the mesh's order "
                             f"{self.axis_names}")
        if len(mine) == 1 or self.virtual:
            pg = None
        elif len(mine) == self.size:
            pg = dist.group.WORLD
        else:
            pg = None
            seen = set()
            for r in range(self.size):      # every rank, the same order
                ranks = tuple(self.group_ranks(names, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                made = dist.new_group(list(ranks), backend=self.backend)
                if self.rank in ranks:
                    pg = made
        grp = comm.Group(pg=pg, ranks=tuple(mine),
                         index=mine.index(self.rank))
        self._groups[names] = grp
        return grp


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production layouts (a shape only, unless the
    world was started with 256 / 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_sim_mesh(n_workers: int, model: int = 1) -> Mesh:
    """A small mesh of ``n_workers`` data ranks (× ``model``)."""
    if model > 1:
        return Mesh((n_workers, model), ("data", "model"))
    return Mesh((n_workers,), ("data",))


def rps_axes_for(rps_mode: str, mesh: Mesh) -> Tuple[str, ...]:
    names = mesh.axis_names
    if rps_mode == "rps_grad":
        return ("pod",) if "pod" in names else ()
    return tuple(a for a in ("pod", "data") if a in names)


# ---- a world of ranks on this host ---------------------------------------

def _rank_main(fn, rank: int, world: int, init: str, backend: str,
               device: torch.device, threads: int, timeout_s: float, inbox,
               results) -> None:
    env_lib.apply(threads=threads)
    try:
        args = inbox.get()
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *args: Any,
              backend: str = "gloo", device="cuda", threads: int = 1,
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``torch.distributed`` world; returns each
    rank's result (picklable), in rank order.

    ``fn`` must be importable by name (a module-level function). Every
    child starts with ``launch/env.py``'s ``threads`` cap on torch's
    thread pools, rendezvous through a file in a fresh temporary
    directory (no port to collide with another run), and uses ``backend``
    on ``device`` (gloo; all ranks on one card share it, host-staged;
    ``nccl`` raises; the card unless the caller asks for the CPU, and
    ``"cuda"`` raises where there is none). A rank that fails ends the
    world: the others are stopped and the failure is raised with its
    traceback. Tensors
    among ``args`` reach the ranks shared, not copied (torch's spawn
    context): pass CPU tensors (shared memory). CUDA tensors would go by
    CUDA IPC, whose blocks stay referenced when the ranks exit, and the
    parent's own exit then fails."""
    import torch.multiprocessing as mp
    comm.check_backend(backend)
    device = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # the arguments go through a queue once every rank runs: in the start
    # message, each rank would hold the parent's write until it had
    # imported what the arguments' pickle names, one rank after another
    inbox = ctx.Queue()
    saved = dict(os.environ)
    os.environ.update(env_lib.host_env(threads=threads, tcmalloc=False))
    procs = []
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_rank_main,
                            args=(fn, rank, world_size, init, backend,
                                  device, threads, timeout_s, inbox,
                                  results),
                            daemon=True)
            p.start()
            procs.append(p)
        os.environ.clear()
        os.environ.update(saved)
        for _ in range(world_size):
            inbox.put(args)
        # a rank that dies unread must not hold the parent at its exit
        inbox.cancel_join_thread()
        outs: List[Any] = [None] * world_size
        deadline = time.monotonic() + timeout_s
        got = 0
        while got < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_world: ranks {dead} exited "
                                       "without a result")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_world: no result within "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            outs[rank] = out
            got += 1
        for p in procs:
            p.join(timeout=60)
        return outs
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
